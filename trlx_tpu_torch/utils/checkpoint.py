"""Checkpoint files with an atomic commit.

Port of the commit protocol of ``trlx_tpu/utils/checkpoint.py``
(:func:`is_committed`, :func:`_checkpoint_step_dirs`,
:func:`newest_committed_checkpoint` and the commit step of
:func:`save_state`) for the port's one-file checkpoint: a directory holds
``state.pt`` (one ``torch.save`` of model, optimizer, step and the
trainer's host state) and the ``COMMITTED`` marker.

A save writes the file under a staging name beside its final one
(``state.pt.staging``), syncs it to disk, writes the marker, then renames
the staged file over ``state.pt`` (an atomic replace). A directory counts
as committed only when both the marker and ``state.pt`` are there, so a
crash mid-save leaves either the previous complete checkpoint or a
directory that resume skips — never a half-written ``state.pt`` that it
would load.

:func:`prune_checkpoints` is the retention ring
(``resilience.keep_last_n``), and the commit polls the fault plan's
``crash_save@save:N`` after the staged file is written and before the
marker, as JAX's commit does.
"""

import os
import shutil
from typing import Any, Dict, List, Optional, Tuple

import torch

from trlx_tpu_torch.resilience.faults import InjectedFault, poll_fault

__all__ = [
    "COMMIT_MARKER",
    "STATE_FILE",
    "is_committed",
    "newest_committed_checkpoint",
    "prune_checkpoints",
    "save_state",
    "load_state",
]

COMMIT_MARKER = "COMMITTED"
STATE_FILE = "state.pt"


def is_committed(directory: str) -> bool:
    """Does ``directory`` hold a complete, committed checkpoint?"""
    return (os.path.isfile(os.path.join(directory, STATE_FILE))
            and os.path.exists(os.path.join(directory, COMMIT_MARKER)))


def _checkpoint_step_dirs(root: str) -> List[Tuple[int, str]]:
    """``(step, path)`` of every ``checkpoint_<int>`` directory under
    ``root``, numerically sorted (the zero-padding width follows
    ``total_steps``)."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in sorted(os.listdir(root)):
        if not name.startswith("checkpoint_"):
            continue
        try:
            step = int(name.rsplit("_", 1)[1])
        except ValueError:
            continue
        path = os.path.join(root, name)
        if os.path.isdir(path):
            out.append((step, path))
    return sorted(out)


def newest_committed_checkpoint(root: str) -> Optional[str]:
    """The highest-step committed ``checkpoint_<int>`` directory under
    ``root``, or None."""
    for _step, path in reversed(_checkpoint_step_dirs(root)):
        if is_committed(path):
            return path
    return None


def prune_checkpoints(root: str, keep_last_n: int) -> List[str]:
    """The retention ring: delete the committed ``checkpoint_<int>``
    directories beyond the newest ``keep_last_n``. Uncommitted directories
    and ``best_checkpoint`` are never touched; 0 disables. Returns the
    pruned paths."""
    if keep_last_n <= 0:
        return []
    committed = [p for _s, p in _checkpoint_step_dirs(root) if is_committed(p)]
    pruned = committed[:-keep_last_n]
    for path in pruned:
        shutil.rmtree(path, ignore_errors=True)
    return pruned


def _fsync(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def save_state(directory: str, state: Dict[str, Any]) -> None:
    """``torch.save`` ``state`` into ``directory/state.pt`` with the atomic
    commit: staged file, marker, rename. The previous checkpoint of the
    directory stays loadable until the rename; an injected ``crash_save``
    raises :class:`~trlx_tpu_torch.resilience.faults.InjectedFault` before
    the marker."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, STATE_FILE)
    staging = path + ".staging"
    torch.save(state, staging)
    _fsync(staging)
    if poll_fault("crash_save"):
        raise InjectedFault(f"fault plan: crash before checkpoint commit ({directory})")
    marker = os.path.join(directory, COMMIT_MARKER)
    with open(marker, "w") as f:
        f.write("1\n")
    os.replace(staging, path)
    _fsync(directory)


def load_state(directory: str) -> Dict[str, Any]:
    """The state of a committed checkpoint, on the CPU."""
    if not is_committed(directory):
        raise FileNotFoundError(f"{directory} holds no committed checkpoint")
    return torch.load(os.path.join(directory, STATE_FILE), map_location="cpu",
                      weights_only=True)
