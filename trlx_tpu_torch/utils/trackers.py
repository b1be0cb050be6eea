"""Experiment trackers: JSONL (always available), TensorBoard, W&B.

Port of ``trlx_tpu/utils/trackers.py`` with its semantics: the default
(``train.tracker: null``) is a JSONL stats stream in ``train.logging_dir``
or ``<checkpoint_dir>/logs``; TensorBoard and W&B attach where their
packages exist and fall back to JSONL with a warning where they do not.
Only process 0 tracks.

Every tracker of the port also keeps what it logged in :attr:`Tracker.
history`, as ``(step, stats)`` pairs, so a caller reads a run's stats back
without parsing the files.
"""

import json
import os
import subprocess
import time
from typing import Any, Dict, List, Optional, Tuple

from trlx_tpu_torch.utils import filter_non_scalars, flatten_dict, significant
from trlx_tpu_torch.utils.logging import get_logger, process_index


class Tracker:
    """Null tracker: writes nothing and keeps the history. Also the
    context-manager contract every tracker shares."""

    def __init__(self):
        self.history: List[Tuple[int, Dict[str, Any]]] = []

    def log(self, stats: Dict[str, Any], step: int) -> None:
        self.history.append((int(step), dict(stats)))

    def finish(self) -> None:
        pass

    def __enter__(self) -> "Tracker":
        return self

    def __exit__(self, *exc_info) -> None:
        self.finish()


class JSONLTracker(Tracker):
    """Appends one JSON object per log call to ``<dir>/stats.jsonl``:
    ``step``, ``time`` and the scalar stats cut to two significant figures.

    The file is line-buffered, so each record lands as one line even if
    the process dies. ``finish()`` is idempotent and a ``log()`` after it
    reopens the file. A ``config.json`` of the run is written beside it
    when ``config_dict`` is given.
    """

    def __init__(self, logging_dir: str, config_dict: Optional[Dict] = None):
        super().__init__()
        os.makedirs(logging_dir, exist_ok=True)
        self.path = os.path.join(logging_dir, "stats.jsonl")
        if config_dict is not None:
            with open(os.path.join(logging_dir, "config.json"), "w") as f:
                json.dump(config_dict, f, indent=2, default=str)
        self._f = None

    def log(self, stats: Dict[str, Any], step: int) -> None:
        super().log(stats, step)
        record = {"step": step, "time": time.time()}
        record.update({k: significant(v) for k, v in filter_non_scalars(stats).items()})
        if self._f is None or self._f.closed:
            self._f = open(self.path, "a", buffering=1)
        self._f.write(json.dumps(record) + "\n")

    def finish(self) -> None:
        if self._f is not None and not self._f.closed:
            self._f.close()


class TensorBoardTracker(Tracker):
    """Scalars into a TensorBoard event file (``torch.utils.tensorboard``),
    with the flattened config as hyperparameters."""

    def __init__(self, logging_dir: str, config_dict: Optional[Dict] = None):
        from torch.utils.tensorboard import SummaryWriter

        super().__init__()
        self.writer = SummaryWriter(logging_dir)
        if config_dict is not None:
            flat = {k: str(v) for k, v in flatten_dict(config_dict, sep=".").items()}
            self.writer.add_hparams(flat, {}, run_name=".")

    def log(self, stats: Dict[str, Any], step: int) -> None:
        super().log(stats, step)
        for k, v in filter_non_scalars(stats).items():
            self.writer.add_scalar(k, v, step)

    def finish(self) -> None:
        self.writer.close()


class WandbTracker(Tracker):
    def __init__(self, project: str, run_name: str, entity: Optional[str] = None,
                 group: Optional[str] = None, tags=None, config_dict: Optional[Dict] = None,
                 logging_dir: Optional[str] = None):
        import wandb

        super().__init__()
        self.run = wandb.init(project=project, name=run_name, entity=entity, group=group,
                              tags=tags, config=config_dict, dir=logging_dir,
                              mode=os.environ.get("WANDB_MODE", "online"))

    def log(self, stats: Dict[str, Any], step: int) -> None:
        super().log(stats, step)
        self.run.log(filter_non_scalars(stats), step=step)

    def finish(self) -> None:
        self.run.finish()


def _git_branch() -> str:
    try:
        return subprocess.check_output("git rev-parse --abbrev-ref HEAD".split(),
                                       stderr=subprocess.DEVNULL).decode().strip()
    except (subprocess.CalledProcessError, FileNotFoundError):
        return "unknown"


def run_name_for(config) -> str:
    """``<model>/<n>devices:<git branch>``, counting the CUDA devices (1
    without any)."""
    import torch

    model = os.path.basename(config.model.model_path.rstrip("/")).replace(":", "-")
    devices = torch.cuda.device_count() if torch.cuda.is_available() else 1
    return f"{model}/{devices}devices:{_git_branch()}"


def make_tracker(config) -> Tracker:
    """The tracker ``config.train.tracker`` names.

    ``None`` → JSONL into ``logging_dir`` (else ``<checkpoint_dir>/logs``),
    or the null tracker when neither directory is set; ``"wandb"`` and
    ``"tensorboard"`` fall back to JSONL with a warning when their package
    is missing. Processes other than 0 get the null tracker."""
    if process_index() != 0:
        return Tracker()
    name = config.train.tracker
    logging_dir = config.train.logging_dir
    if logging_dir is None and config.train.checkpoint_dir is not None:
        logging_dir = os.path.join(config.train.checkpoint_dir, "logs")
    if logging_dir is None:
        if name is None:
            return Tracker()
        raise ValueError(f"train.tracker {name!r} needs train.logging_dir or "
                         "train.checkpoint_dir")
    config_dict = config.to_dict()
    if name in (None, "jsonl"):
        return JSONLTracker(logging_dir, config_dict)
    if name == "tensorboard":
        try:
            return TensorBoardTracker(logging_dir, config_dict)
        except ImportError:
            pass
    elif name == "wandb":
        try:
            return WandbTracker(
                project=config.train.project_name, run_name=run_name_for(config),
                entity=config.train.entity_name, group=config.train.group_name,
                tags=list(config.train.tags) + ["trlx_tpu"], config_dict=config_dict,
                logging_dir=logging_dir)
        except ImportError:
            # a missing package downgrades to JSONL; wandb's own failures surface
            pass
    else:
        raise ValueError(f"Unknown tracker '{name}' (use jsonl|tensorboard|wandb)")
    get_logger(__name__).warning(
        f"tracker '{name}' unavailable; falling back to JSONL at {logging_dir}")
    return JSONLTracker(logging_dir, config_dict)
