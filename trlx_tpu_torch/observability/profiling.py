"""Profiler windows over ``torch.profiler``, with step annotations.

Port of ``trlx_tpu/observability/profiling.py``. A window of train steps
is traced without a code change, from either:

- ``TRLX_TPU_PROFILE=steps:3-5,dir:<directory>``, an environment variable
  (it wins over the config); or
- ``config.train.profile_dir``, which traces steps 1-4 (the step after the
  first, warm-up, step and the three that follow).

The window records the host (CPU activity) and, where CUDA is available,
the card's kernels (CUDA activity, through CUPTI), and writes one Chrome
trace, ``trace_steps<a>-<b>.json``, into the directory when it closes.
While it is open each train step runs inside a ``record_function``
annotation (``train#<step>``), so the trace viewer groups the kernels by
step. Keep windows short: the profiler's own processing of a collection
costs seconds per ten thousand launches.
"""

import os
import tempfile
from contextlib import nullcontext
from typing import Any, Optional, Tuple

from trlx_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

PROFILE_ENV = "TRLX_TPU_PROFILE"


def default_profile_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "trlx_tpu_torch_profile")


def parse_profile_spec(spec: str) -> Tuple[int, int, str]:
    """``"steps:3-5,dir:/x"`` → ``(3, 5, "/x")``; ``steps:N`` means ``N-N``
    and ``dir`` defaults to :func:`default_profile_dir`. Raises
    ``ValueError`` on a malformed spec."""
    start, stop, directory = None, None, default_profile_dir()
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        key, _, value = part.partition(":")
        if key == "steps":
            lo, _, hi = value.partition("-")
            start = int(lo)
            stop = int(hi) if hi else start
        elif key == "dir":
            directory = value
        else:
            raise ValueError(f"unknown {PROFILE_ENV} field '{key}' in '{spec}'")
    if start is None:
        raise ValueError(f"{PROFILE_ENV} needs a steps:<a>-<b> field, got '{spec}'")
    if stop < start:
        raise ValueError(f"{PROFILE_ENV} steps window is inverted: '{spec}'")
    return start, stop, directory


class ProfileWindow:
    """Starts and stops one ``torch.profiler`` trace around a step interval.

    ``on_step_start(step)`` / ``on_step_end(step)`` bracket each train step
    with the trainer's pre-increment step index; the window traces steps
    ``start..stop`` inclusive. ``stop()`` is an idempotent final close for
    early exits. A disabled window (no spec) is all no-ops.
    """

    def __init__(self, start: Optional[int], stop: Optional[int], directory: Optional[str]):
        self.start = start
        self.stop_step = stop
        self.directory = directory
        self.active = False
        self.trace_path: Optional[str] = None
        self._done = False
        self._prof = None

    @classmethod
    def disabled(cls) -> "ProfileWindow":
        return cls(None, None, None)

    @classmethod
    def from_env(cls, config: Any = None) -> "ProfileWindow":
        spec = os.environ.get(PROFILE_ENV)
        if spec:
            try:
                return cls(*parse_profile_spec(spec))
            except ValueError as e:
                logger.warning("ignoring malformed %s: %s", PROFILE_ENV, e)
        profile_dir = getattr(getattr(config, "train", None), "profile_dir", None)
        if profile_dir:
            return cls(1, 4, profile_dir)
        return cls.disabled()

    @property
    def enabled(self) -> bool:
        return self.start is not None

    def on_step_start(self, step: int) -> None:
        if not self.enabled or self.active or self._done:
            return
        if self.start <= step <= self.stop_step:
            import torch

            activities = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            logger.info("profiler: starting trace at step %d (window %d-%d) -> %s",
                        step, self.start, self.stop_step, self.directory)
            self._prof = torch.profiler.profile(activities=activities)
            self._prof.__enter__()
            self.active = True

    def on_step_end(self, step: int) -> None:
        if self.active and step >= self.stop_step:
            self.stop()
            self._done = True

    def stop(self) -> None:
        if not self.active:
            return
        self._prof.__exit__(None, None, None)
        self.active = False
        os.makedirs(self.directory, exist_ok=True)
        self.trace_path = os.path.join(
            self.directory, f"trace_steps{self.start}-{self.stop_step}.json")
        self._prof.export_chrome_trace(self.trace_path)
        self._prof = None
        logger.info("profiler: trace written to %s", self.trace_path)

    def step_annotation(self, name: str, step: int):
        """A ``record_function`` range ``<name>#<step>`` while the window is
        open (a no-op context otherwise)."""
        if not self.active:
            return nullcontext()
        import torch

        return torch.profiler.record_function(f"{name}#{step}")
