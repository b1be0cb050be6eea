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

Under FSDP2 (a trainer over a mesh of several processes) a save gathers
the full state onto rank 0, on the CPU, in the one-device format
(:func:`gather_full_state`: ``get_model_state_dict`` /
``get_optimizer_state_dict`` with ``full_state_dict=True,
cpu_offload=True``, the optimizer state re-keyed by parameter index), and
only rank 0 writes; a resume loads that full state and reshards it
(:func:`load_full_state`). So a checkpoint of any world size resumes at
any other.

The interoperable export (JAX's :func:`save_pretrained`,
:func:`load_pretrained_params` and :func:`push_to_hub`): the port's own
dump — ``trlx_tpu_torch_model.pt`` (the ``state_dict``, heads included)
and ``trlx_tpu_torch_config.json`` (the config's fields) — with a
``transformers``-loadable ``pytorch_model.bin`` + ``config.json`` beside
it (``models/hf_interop.py::save_pretrained_hf``) for every architecture
with an HF family; :func:`push_to_hub` stages that export and hands it to
an upload step in one call.
"""

import dataclasses
import json
import logging
import os
import shutil
import tempfile
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

import torch

from trlx_tpu_torch.ops.kernel_utils import resolve_device
from trlx_tpu_torch.resilience.faults import InjectedFault, poll_fault

__all__ = [
    "COMMIT_MARKER",
    "STATE_FILE",
    "is_committed",
    "newest_committed_checkpoint",
    "prune_checkpoints",
    "save_state",
    "load_state",
    "gather_full_state",
    "load_full_state",
    "save_pretrained",
    "load_pretrained_params",
    "push_to_hub",
]

COMMIT_MARKER = "COMMITTED"
STATE_FILE = "state.pt"
PRETRAINED_FILE = "trlx_tpu_torch_model.pt"
PRETRAINED_CONFIG = "trlx_tpu_torch_config.json"

logger = logging.getLogger(__name__)


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


def _optimizer_fqns(model: torch.nn.Module, optimizer) -> List[List[str]]:
    """The parameter names of each of the optimizer's groups, in order."""
    names = {id(p): n for n, p in model.named_parameters()}
    return [[names[id(p)] for p in group["params"]] for group in optimizer.param_groups]


def gather_full_state(model: torch.nn.Module, optimizer) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """The full ``(model, optimizer)`` state of an FSDP2-sharded model on
    rank 0, on the CPU, in the format ``state_dict()`` gives on one device
    (the optimizer's state keyed by parameter index); other ranks get
    empty dicts. A collective: every rank calls it."""
    import torch.distributed as dist
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        get_model_state_dict,
        get_optimizer_state_dict,
    )

    opts = StateDictOptions(full_state_dict=True, cpu_offload=True)
    model_sd = get_model_state_dict(model, options=opts)
    optim_sd = get_optimizer_state_dict(model, optimizer, options=opts)
    if dist.get_rank() != 0:
        return {}, {}
    index, groups = 0, []
    state = {}
    for group, fqns in zip(optim_sd["param_groups"], _optimizer_fqns(model, optimizer)):
        ids = []
        for fqn in fqns:
            if fqn in optim_sd["state"]:
                state[index] = optim_sd["state"][fqn]
            ids.append(index)
            index += 1
        groups.append({**{k: v for k, v in group.items() if k != "params"}, "params": ids})
    return dict(model_sd), {"state": state, "param_groups": groups}


def load_full_state(model: torch.nn.Module, optimizer, model_sd: Dict[str, Any],
                    optim_sd: Dict[str, Any]) -> None:
    """Load a full state (the one-device format) into an FSDP2-sharded
    model and its optimizer, each rank keeping its shards."""
    from torch.distributed.checkpoint.state_dict import (
        StateDictOptions,
        set_model_state_dict,
        set_optimizer_state_dict,
    )

    opts = StateDictOptions(full_state_dict=True)
    set_model_state_dict(model, model_sd, options=opts)
    index, state, groups = 0, {}, []
    for group, fqns in zip(optim_sd["param_groups"], _optimizer_fqns(model, optimizer)):
        for fqn in fqns:
            if index in optim_sd["state"]:
                state[fqn] = optim_sd["state"][index]
            index += 1
        groups.append({**{k: v for k, v in group.items() if k != "params"}, "params": fqns})
    set_optimizer_state_dict(model, optimizer, {"state": state, "param_groups": groups},
                             options=opts)


def save_pretrained(directory: str, state_dict: Dict[str, torch.Tensor], config,
                    tokenizer_path: Optional[str] = None) -> None:
    """Export weights and architecture: ``trlx_tpu_torch_model.pt`` (the
    ``state_dict`` on the CPU, dtypes kept), ``trlx_tpu_torch_config.json``
    (the config's fields, ``framework`` and ``tokenizer_path``) and, for an
    architecture with an HF family, ``pytorch_model.bin`` + ``config.json``
    with the heads merged under the reference's prefixes. An architecture
    without one (:class:`~trlx_tpu_torch.models.hf_interop.UnsupportedHFExport`)
    keeps the native dump alone; any other conversion error propagates."""
    from trlx_tpu_torch.models.hf_interop import UnsupportedHFExport, save_pretrained_hf

    os.makedirs(directory, exist_ok=True)
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()},
               os.path.join(directory, PRETRAINED_FILE))
    fields = {k: (str(v) if isinstance(v, torch.dtype) else v)
              for k, v in dataclasses.asdict(config).items()}
    fields["framework"] = "trlx_tpu_torch"
    if tokenizer_path is not None:
        fields["tokenizer_path"] = tokenizer_path
    with open(os.path.join(directory, PRETRAINED_CONFIG), "w") as f:
        json.dump(fields, f, indent=2)
    try:
        save_pretrained_hf(directory, state_dict, config, tokenizer_path)
    except UnsupportedHFExport as e:
        logger.warning("Skipping the HF-format export (%s); %s was written", e, PRETRAINED_FILE)


def load_pretrained_params(directory: str, model: Optional[torch.nn.Module] = None,
                           device: Union[None, str, torch.device] = None
                           ) -> Dict[str, torch.Tensor]:
    """The ``state_dict`` of a :func:`save_pretrained` directory on
    ``device`` (None: the card; the CPU only when named), read memory-mapped
    tensor by tensor, and loaded into ``model`` when one is given."""
    state_dict = torch.load(os.path.join(directory, PRETRAINED_FILE), map_location="cpu",
                            weights_only=True, mmap=True)
    device = resolve_device(device)
    state_dict = {k: state_dict.pop(k).to(device) for k in list(state_dict)}
    if model is not None:
        model.load_state_dict(state_dict)
    return state_dict


def push_to_hub(repo_id: str, state_dict: Dict[str, torch.Tensor], config,
                tokenizer_path: Optional[str] = None, private: bool = True,
                commit_message: str = "Upload trlx_tpu_torch model",
                token: Optional[str] = None, staging_dir: Optional[str] = None,
                uploader: Optional[Callable[[str, str], Any]] = None) -> str:
    """Publish a :func:`save_pretrained` export to the Hugging Face Hub
    (the reference's models inherit ``PushToHubMixin``).

    The payload is staged locally first (``staging_dir``, or a temporary
    directory removed after a successful upload), then uploaded in one
    ``upload_folder`` call. ``uploader`` — a callable ``(repo_id,
    staged_dir) -> url`` — replaces the network step (tests, custom
    transports); without it ``huggingface_hub`` is needed, and its absence
    raises before anything is staged. A failed upload keeps the staged
    export for a manual upload and re-raises. Returns the upload step's
    URL."""
    api = None
    if uploader is None:
        try:
            from huggingface_hub import HfApi
        except ImportError as e:
            raise RuntimeError(
                f"push_to_hub needs the huggingface_hub package for the upload step ({e}); "
                "install it, or pass uploader= to supply your own transport") from e
        api = HfApi(token=token)

    staged = staging_dir or tempfile.mkdtemp(prefix="trlx_tpu_torch_hub_")
    cleanup = staging_dir is None
    try:
        save_pretrained(staged, state_dict, config, tokenizer_path)
        if uploader is not None:
            return str(uploader(repo_id, staged))
        api.create_repo(repo_id, private=private, exist_ok=True)
        info = api.upload_folder(repo_id=repo_id, folder_path=staged,
                                 commit_message=commit_message)
        return str(getattr(info, "commit_url", info))
    except Exception:
        cleanup = False  # keep the files a manual upload needs
        logger.error("push_to_hub failed after staging; the export is kept at %s", staged)
        raise
    finally:
        if cleanup:
            shutil.rmtree(staged, ignore_errors=True)
