"""Metrics registry (counters, gauges, histograms), throughput and MFU.

Port of ``trlx_tpu/observability/metrics.py``. Every key follows the
``namespace/name`` convention. The trainer merges
:meth:`MetricsRegistry.snapshot` into each step's stats, so every counter
(the ``resilience/*`` ones among them) reaches the tracker with no backend
of its own; the flight recorder taps every counter and gauge write
(:meth:`MetricsRegistry.add_listener`).

MFU is measured: the FLOP numerator is the train step's own count, taken
once on its first call (:func:`train_step_flops`): the aten ops through
``torch.utils.flop_counter.FlopCounterMode``, plus each hand-written
kernel's formula, tallied by its wrapper (``ops/kernel_utils.py::
note_kernel_flops``), since the kernels are ctypes calls the counter cannot
see. Matmul-class ops count, elementwise ones do not (the counter's rule);
the JAX package's number comes from XLA's ``cost_analysis``, which counts
elementwise ops too. The denominator is the fenced step time and
:func:`device_peak_flops`.

On a device whose peak is unknown (the CPU), a nominal
:data:`DEFAULT_PEAK_FLOPS` (1 TFLOP/s) keeps ``throughput/mfu`` defined as
a run-over-run relative index; ``TRLX_TPU_PEAK_FLOPS`` makes it absolute.
"""

import os
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

# dense bf16 tensor-core peak per card, by ``torch.cuda.get_device_name()``
# (matched lower-case, as a substring). Source: NVIDIA H100 Tensor Core GPU
# datasheet, H100 SXM5: 1,979 TFLOPS bf16 with sparsity, 989.4 dense.
GPU_PEAK_FLOPS = {
    "h100 80gb hbm3": 989.4e12,
}

# nominal per-device peak when the hardware is unknown (the CPU)
DEFAULT_PEAK_FLOPS = 1e12


def device_peak_flops(device: Any = None) -> float:
    """Per-device peak FLOP/s: ``TRLX_TPU_PEAK_FLOPS``, else
    :data:`GPU_PEAK_FLOPS` by the card's name, else
    :data:`DEFAULT_PEAK_FLOPS`. ``device`` (a torch device) names the
    card; None means the current CUDA card when there is one."""
    env = os.environ.get("TRLX_TPU_PEAK_FLOPS")
    if env:
        return float(env)
    dev = torch.device(device) if device is not None else None
    if dev is None and torch.cuda.is_available():
        dev = torch.device("cuda")
    if dev is None or dev.type != "cuda":
        return DEFAULT_PEAK_FLOPS
    name = torch.cuda.get_device_name(dev).lower()
    for key, val in GPU_PEAK_FLOPS.items():
        if key in name:
            return val
    return DEFAULT_PEAK_FLOPS


def mfu(flops_per_device: float, step_time_s: float, peak_flops_per_device: float) -> float:
    """Model FLOP utilization of one device for one fenced step."""
    if step_time_s <= 0 or peak_flops_per_device <= 0:
        return 0.0
    return flops_per_device / step_time_s / peak_flops_per_device


class MetricsRegistry:
    """Thread-safe counters (``inc``: they accumulate), gauges
    (``set_gauge``: the last write wins) and histograms (``observe``: a
    window of observations summarized at snapshot as ``name_mean`` /
    ``name_max`` / ``name_count``, then reset). Pipeline workers write
    while the learn loop takes snapshots, so every access takes the lock."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, float] = {}  # guarded-by: _lock
        self._gauges: Dict[str, float] = {}  # guarded-by: _lock
        self._hists: Dict[str, List[float]] = {}  # guarded-by: _lock
        # the flight recorder's tap: fn(op, name, value) on every write
        self._listeners: List[Callable[[str, str, float], None]] = []  # guarded-by: _lock

    def add_listener(self, fn: Callable[[str, str, float], None]) -> None:
        """Subscribe ``fn(op, name, value)`` to every counter and gauge
        write."""
        with self._lock:
            self._listeners.append(fn)

    def _notify(self, op: str, name: str, value: float) -> None:
        # outside the lock; a listener never breaks metric recording
        with self._lock:
            listeners = list(self._listeners)
        for fn in listeners:
            try:
                fn(op, name, value)
            except Exception:  # pragma: no cover - defensive
                pass

    def inc(self, name: str, value: float = 1.0) -> float:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0.0) + value
            total = self._counters[name]
        self._notify("inc", name, total)
        return total

    def set_gauge(self, name: str, value: float) -> None:
        with self._lock:
            self._gauges[name] = float(value)
        self._notify("gauge", name, float(value))

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            self._hists.setdefault(name, []).append(float(value))

    def counter(self, name: str) -> float:
        with self._lock:
            return self._counters.get(name, 0.0)

    def snapshot(self, reset_histograms: bool = True) -> Dict[str, float]:
        """Flat ``namespace/name`` → value dict for the tracker stream."""
        with self._lock:
            out: Dict[str, float] = dict(self._counters)
            out.update(self._gauges)
            for name, values in self._hists.items():
                if not values:
                    continue
                out[f"{name}_mean"] = sum(values) / len(values)
                out[f"{name}_max"] = max(values)
                out[f"{name}_count"] = float(len(values))
            if reset_histograms:
                self._hists = {}
            return out


class ThroughputMeter:
    """Per-step throughput stats from fenced step times:
    ``throughput/tokens_per_sec``, ``throughput/samples_per_sec`` and, when
    the step's FLOP count is known, ``throughput/mfu`` and
    ``throughput/flops_per_sec_per_device``. Running totals give
    :meth:`summary`'s whole-run averages."""

    def __init__(self, peak_flops_per_device: Optional[float] = None, device: Any = None):
        self._peak = peak_flops_per_device
        self._device = device
        self.total_time = 0.0
        self.total_tokens = 0
        self.total_samples = 0

    @property
    def peak(self) -> float:
        if self._peak is None:
            self._peak = device_peak_flops(self._device)
        return self._peak

    def step_stats(self, step_time_s: float, tokens: int = 0, samples: int = 0,
                   flops_per_device: Optional[float] = None) -> Dict[str, float]:
        stats: Dict[str, float] = {}
        if step_time_s <= 0:
            return stats
        self.total_time += step_time_s
        self.total_tokens += tokens
        self.total_samples += samples
        if tokens:
            stats["throughput/tokens_per_sec"] = tokens / step_time_s
        if samples:
            stats["throughput/samples_per_sec"] = samples / step_time_s
        if flops_per_device is not None and flops_per_device > 0:
            stats["throughput/flops_per_sec_per_device"] = flops_per_device / step_time_s
            stats["throughput/mfu"] = mfu(flops_per_device, step_time_s, self.peak)
        return stats

    def summary(self) -> Dict[str, float]:
        if self.total_time <= 0:
            return {}
        out = {}
        if self.total_tokens:
            out["throughput/tokens_per_sec_avg"] = self.total_tokens / self.total_time
        if self.total_samples:
            out["throughput/samples_per_sec_avg"] = self.total_samples / self.total_time
        return out


def train_step_flops(fn: Callable, *args: Any) -> Tuple[Any, Optional[float]]:
    """Run ``fn(*args)`` once while counting its FLOPs; returns ``(fn's
    result, flops or None)``.

    The count is the aten ops' (``FlopCounterMode``, forward and backward)
    plus every hand-written kernel launch's formula, tallied by the
    wrappers; on CPU tensors a wrapper's plain version runs outside the
    counter, so no launch counts twice. The step itself is the trainer's
    real step (its update lands), so the counter is taken on a step that
    runs anyway. ``None`` (never an exception of its own) when the count
    is 0 or the counter cannot be set up; ``TRLX_TPU_MFU=0`` runs ``fn``
    uncounted. An exception of ``fn`` propagates."""
    if os.environ.get("TRLX_TPU_MFU", "1") == "0":
        return fn(*args), None
    try:
        from torch.utils.flop_counter import FlopCounterMode

        from trlx_tpu_torch.ops.kernel_utils import counting_kernel_flops

        counter = FlopCounterMode(display=False)
        tally = counting_kernel_flops()
    except Exception:  # pragma: no cover - defensive: no counter, no MFU
        return fn(*args), None
    with tally as kernels, counter:
        out = fn(*args)
    flops = float(counter.get_total_flops()) + kernels.total
    return out, (flops if flops > 0 else None)
