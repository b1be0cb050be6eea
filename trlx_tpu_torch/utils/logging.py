"""Library-wide logging of the port: a package-level level taken from the
environment, and records gated to process 0.

Port of ``trlx_tpu/utils/logging.py``: ``TRLX_TPU_VERBOSITY``
(critical | error | warning | info | debug) sets the level of the
``trlx_tpu_torch`` logger, :func:`get_logger` returns a logger whose
records carry the process rank and, by default, are emitted on rank 0
only (``ranks=[-1]`` emits everywhere). The rank comes from the launcher's
environment (``RANK``) or an initialised ``torch.distributed`` group; on
one device it is 0 and the gating passes every record.

The package logger keeps propagating to the root logger, so an
application's handlers (and pytest's log capture) see every record; it
gets a stdout handler of its own only when the root logger has none.
"""

import logging
import os
import sys
import threading
from typing import Optional

_lock = threading.Lock()
_configured = False

CRITICAL = logging.CRITICAL
ERROR = logging.ERROR
WARNING = logging.WARNING
INFO = logging.INFO
DEBUG = logging.DEBUG

_LEVELS = {"critical": CRITICAL, "error": ERROR, "warning": WARNING, "info": INFO,
           "debug": DEBUG}
VERBOSITY_ENV = "TRLX_TPU_VERBOSITY"


def _root_name() -> str:
    return __name__.split(".")[0]  # "trlx_tpu_torch"


def level_from_env(default: int = INFO) -> int:
    """The level ``TRLX_TPU_VERBOSITY`` names, else ``default`` (an unknown
    name warns and keeps the default)."""
    env = os.environ.get(VERBOSITY_ENV)
    if not env:
        return default
    if env.lower() in _LEVELS:
        return _LEVELS[env.lower()]
    logging.getLogger(_root_name()).warning(
        "Unknown %s=%s, must be one of %s", VERBOSITY_ENV, env, list(_LEVELS))
    return default


def _configure_root() -> None:
    global _configured
    with _lock:
        if _configured:
            return
        _configured = True
        root = logging.getLogger(_root_name())
        root.setLevel(level_from_env())
        if not logging.getLogger().handlers:
            handler = logging.StreamHandler(sys.stdout)
            handler.setFormatter(logging.Formatter(
                "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s", datefmt="%H:%M:%S"))
            root.addHandler(handler)


def process_index() -> int:
    """This process's rank: ``RANK`` (or ``TRLX_TPU_PROCESS_ID``) from the
    launcher, else the initialised ``torch.distributed`` group's, else 0."""
    for var in ("TRLX_TPU_PROCESS_ID", "RANK"):
        if var in os.environ:
            try:
                return int(os.environ[var])
            except ValueError:
                pass
    try:
        import torch.distributed as dist

        if dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # pragma: no cover - defensive
        pass
    return 0


class MultiProcessAdapter(logging.LoggerAdapter):
    """Logs only on the selected ranks (``ranks=[0]`` by default, ``[-1]``
    for every rank), prefixing each message with the rank."""

    def log(self, level, msg, *args, **kwargs):
        ranks = kwargs.pop("ranks", [0])
        idx = process_index()
        if (idx in ranks or -1 in ranks) and self.isEnabledFor(level):
            msg, kwargs = self.process(f"[RANK {idx}] {msg}", kwargs)
            self.logger.log(level, msg, *args, **kwargs)


def get_logger(name: Optional[str] = None) -> MultiProcessAdapter:
    """A rank-aware logger under the ``trlx_tpu_torch`` namespace."""
    _configure_root()
    if name is None:
        name = _root_name()
    elif not name.startswith(_root_name()):
        name = f"{_root_name()}.{name}"
    return MultiProcessAdapter(logging.getLogger(name), {})
