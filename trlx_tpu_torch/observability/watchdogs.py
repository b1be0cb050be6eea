"""Watchdogs: new-signature detection and device-memory gauges.

Port of ``trlx_tpu/observability/watchdogs.py``. Two failure modes stay
invisible until a long run dies:

- **shape drift in a warm program**: an unpadded batch or a new
  generation setting reaches a program with a ``(shape, dtype)``
  signature it has not seen. In JAX that retraces and recompiles the
  program; in the port a new signature costs caching-allocator growth
  (new block sizes, possibly a ``cudaMalloc`` and fragmentation) and fresh
  cuBLAS/cuDNN heuristics for the new GEMM shapes, and per-step drift
  keeps the allocator growing. :class:`RecompileWatchdog` takes JAX's
  signature-set branch (the port's programs have no compile cache to
  probe): a program that already ran sees a new signature → the
  ``recompile/<program>`` counter and a rate-limited warning;
- **device-memory growth** (a leaked tensor) grows until an OOM kills the
  run. :class:`DeviceMemoryGauge` reads ``torch.cuda.memory_stats()`` and
  ``torch.cuda.mem_get_info()`` on the card, host RSS always, and warns
  once when use crosses a fraction of the card's memory.
"""

from typing import Any, Callable, Dict, Optional

import torch

from trlx_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif hasattr(tree, "_asdict"):
        yield from _leaves(tree._asdict())
    else:
        yield tree


def _signature(args: Any) -> tuple:
    return tuple(
        (tuple(leaf.shape) if hasattr(leaf, "shape") else None,
         str(getattr(leaf, "dtype", type(leaf))))
        for leaf in _leaves(args)
    )


class RecompileWatchdog:
    """Warns when a warm program sees a new argument signature.

    The first signature of a program is expected and silent; every later
    new one, for the same program name and function, is counted
    (``recompile/<name>``) and logged, at most ``max_warnings`` times."""

    def __init__(self, metrics=None, max_warnings: int = 10):
        self.metrics = metrics
        self.max_warnings = max_warnings
        # per (name, id(fn)): two programs may share a name (the eval and
        # the experience generate), and a second program's first signature
        # is not a drift of the first's
        self._signatures: Dict[tuple, set] = {}
        self._compiles: Dict[tuple, int] = {}
        self._warnings = 0

    def observe(self, name: str, fn: Callable, args: Any = None) -> int:
        """Record one call of ``fn`` under program ``name`` with ``args``;
        returns the number of signatures beyond the first seen so far."""
        if args is None:
            return 0
        key = (name, id(fn))
        seen = self._signatures.setdefault(key, set())
        sig = _signature(args)
        new = 0 if sig in seen else 1
        seen.add(sig)
        total = self._compiles.get(key, 0) + new
        if new <= 0:
            return max(total - 1, 0)
        self._compiles[key] = total
        if total > 1:
            if self.metrics is not None:
                self.metrics.inc(f"recompile/{name}", 1)
            if self._warnings < self.max_warnings:
                self._warnings += 1
                logger.warning(
                    "recompile watchdog: program '%s' saw a new argument signature (#%d) — "
                    "a warm program's new shapes usually mean an unpadded input; each costs "
                    "allocator growth and fresh GEMM heuristics", name, total)
        return max(total - 1, 0)

    def excess_compiles(self, name: str) -> int:
        """Signatures beyond each program's first, summed over every
        function observed under ``name``."""
        return sum(max(total - 1, 0) for (prog, _), total in self._compiles.items()
                   if prog == name)


class DeviceMemoryGauge:
    """Per-step memory gauges: ``memory/device_bytes_in_use``,
    ``memory/device_peak_bytes`` and ``memory/device_limit_bytes`` on the
    card (the caching allocator's allocated and peak bytes, the card's
    total memory), and ``memory/host_rss_bytes`` always (the CPU reads host
    RSS only). Mirrored into a registry when one is attached; crossing
    ``warn_frac`` of the limit logs one warning per run."""

    def __init__(self, metrics=None, warn_frac: float = 0.92, device: Any = None):
        self.metrics = metrics
        self.warn_frac = warn_frac
        self.device = device
        self._warned = False

    @staticmethod
    def _host_rss_bytes() -> Optional[float]:
        try:
            import resource
            import sys

            rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
            # ru_maxrss is KiB on Linux, bytes on macOS
            return float(rss) * (1.0 if sys.platform == "darwin" else 1024.0)
        except Exception:  # pragma: no cover - defensive
            return None

    def _cuda_device(self) -> Optional[torch.device]:
        dev = torch.device(self.device) if self.device is not None else None
        if dev is None and torch.cuda.is_available():
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev if dev is not None and dev.type == "cuda" else None

    def collect(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        in_use = limit = None
        dev = self._cuda_device()
        if dev is not None:
            ms = torch.cuda.memory_stats(dev)
            in_use = float(ms.get("allocated_bytes.all.current", 0))
            out["memory/device_bytes_in_use"] = in_use
            out["memory/device_peak_bytes"] = float(ms.get("allocated_bytes.all.peak", 0))
            limit = float(torch.cuda.mem_get_info(dev)[1])
            out["memory/device_limit_bytes"] = limit
        rss = self._host_rss_bytes()
        if rss is not None:
            out["memory/host_rss_bytes"] = rss
        if not self._warned and in_use is not None and limit and in_use / limit > self.warn_frac:
            self._warned = True
            logger.warning(
                "memory watchdog: device memory at %.1f%% of limit (%.2f / %.2f GiB) — the "
                "next allocation spike may OOM", 100.0 * in_use / limit, in_use / 2**30,
                limit / 2**30)
        if self.metrics is not None:
            for k, v in out.items():
                self.metrics.set_gauge(k, v)
        return out
