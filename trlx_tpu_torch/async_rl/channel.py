"""The weight-sync channel: learner → actors weight dissemination with
versioned publishes and a staleness gate.

Port of ``trlx_tpu/async_rl/channel.py``. The learner publishes its
weights after each optimizer update (``version`` = completed update count;
thinned by ``async_rl.sync_every``) and *announces* ``(collection,
target)``: the version at which collection ``collection`` will be
consumed. Actors gate each chunk on its own collection::

    chunk.collection >  announced collection → wait (its consumption
                                               version is unknown — running
                                               further ahead could exceed
                                               any bound)
    chunk.collection == announced collection → wait until
                                               target − newest_payload_version
                                               ≤ max_staleness
    chunk.collection <  announced collection → free (its consumption point
                                               has already arrived)

which bounds staleness at consumption structurally — no chunk can start
under weights older than the bound allows, production never runs more
than one collection ahead of consumption, and the learner re-publishes +
re-announces at drain start so an over-estimated target (or a dropped
publish) can never deadlock the gate.

A drain that needs more chunks than a collection holds (rows with empty
responses are dropped) *grants* the one index it waits for
(:meth:`WeightChannel.grant`): that chunk starts at once, under the weights
it is consumed with. JAX's drain instead announces the next collection at
the current version, which lowers that collection's target for good, so
its other chunks start under stale weights (staleness of a whole phase at
``max_staleness: 0``); the grant keeps the bound.

The payload is a weights snapshot (:func:`snapshot_params`): a frozen copy
of the policy module (or a copy of a state dict) that later in-place
optimizer steps never touch. An actor never reads the live module: the
optimizer updates it in place while the actor is mid-generation. The copy
runs on the publishing thread's current stream, the stream the actors'
kernels launch on too, so it is ordered before the next update.

The deterministic ``weight_sync_drop@version:N`` fault drops the payload of
publish N (actors keep version N−1's weights until the next publish) — the
reproducible exercise of the staleness/IW-correction path.

Two transports: :class:`WeightChannel` (in-process, thread mode) and
:class:`FileWeightChannel` (atomic ``.npz`` of the state dict by parameter
name + manifest, process mode).
"""

import copy
import json
import os
import threading
import time
import zipfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "WeightChannel",
    "FileWeightChannel",
    "assemble_params",
    "gate_open",
    "snapshot_params",
    "state_items",
]


def _copy_leaf(value: Any) -> Any:
    if isinstance(value, torch.Tensor):
        return value.detach().clone()
    if isinstance(value, np.ndarray):
        return np.array(value, copy=True)
    return copy.deepcopy(value)


@torch.no_grad()
def snapshot_params(params: Any) -> Any:
    """A copy of ``params`` that later in-place optimizer steps never
    touch: a module becomes a frozen deep copy in eval mode (parameters
    only, no gradients), a ``(target, draft)`` tuple a tuple of copies, a
    dict of tensors or arrays a dict of copies."""
    if isinstance(params, torch.nn.Module):
        snap = copy.deepcopy(params)
        snap.requires_grad_(False)
        return snap.eval()
    if isinstance(params, tuple):
        return tuple(snapshot_params(p) for p in params)
    if isinstance(params, dict):
        return {k: _copy_leaf(v) for k, v in params.items()}
    return _copy_leaf(params)


def state_items(params: Any) -> List[Tuple[str, Any]]:
    """``(name, tensor)`` pairs of a module's state dict (or a dict's
    items), in their fixed order: the layout the file and collective
    transports ship."""
    if isinstance(params, torch.nn.Module):
        return list(params.state_dict().items())
    if isinstance(params, dict):
        return list(params.items())
    raise TypeError(f"cannot take the state of a {type(params).__name__}: a module or a "
                    "dict of tensors is published")


def host_array(value: Any) -> np.ndarray:
    """One state entry on the host as numpy; bf16 widens to f32 exactly
    (numpy has no bf16) and is cast back on load."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    return np.asarray(value)


@torch.no_grad()
def assemble_params(arrays: Dict[str, Any], template: Any = None) -> Any:
    """Named arrays (or tensors) → ``template``'s structure and dtypes: a
    frozen copy of a template module with the arrays loaded by name (on
    the template's device), a dict cast to a template dict's dtypes, or
    the arrays as they are without a template."""
    if template is None:
        return dict(arrays)
    if isinstance(template, torch.nn.Module):
        snap = copy.deepcopy(template)
        snap.requires_grad_(False)
        state = snap.state_dict()
        missing = sorted(set(state) - set(arrays))
        if missing:
            raise KeyError(f"weights payload lacks {missing[:4]} of the template's state")
        for name, dst in state.items():
            dst.copy_(torch.as_tensor(arrays[name]).to(dst.dtype))
        return snap.eval()
    out = {}
    for name, t in template.items():
        value = arrays[name]
        if isinstance(t, torch.Tensor):
            out[name] = torch.as_tensor(value).to(device=t.device, dtype=t.dtype)
        elif hasattr(t, "dtype"):
            out[name] = np.asarray(value).astype(t.dtype)
        else:
            out[name] = value
    return out


def gate_open(published: bool, version: int, target: int, announced_col: int, granted: int,
              max_staleness: int, collection: int, index: Optional[int]) -> bool:
    """The staleness gate every transport shares: may chunk ``index`` of
    ``collection`` start under the newest payload (``version``)?"""
    if not published:
        return False
    if index is not None and index <= granted:
        return True  # the learner is draining it now
    if collection > announced_col:
        return False
    if collection < announced_col:
        return True  # its consumption point has already arrived
    return target - version <= max_staleness


class WeightChannel:
    """In-process learner→actor weights channel (thread mode)."""

    def __init__(self, plan: Any = None, metrics: Any = None, sync_every: int = 1):
        self._plan = plan
        self.metrics = metrics
        self.sync_every = max(1, int(sync_every))
        self._cond = threading.Condition()
        self._params: Any = None  # guarded-by: _cond
        self._payload_version = -1  # guarded-by: _cond
        self._target = 0  # guarded-by: _cond
        self._announced_col = 0  # guarded-by: _cond
        self._granted = -1  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond

    def publish(self, params: Any, version: int, force: bool = False) -> None:
        """Publish a snapshot of ``params`` as ``version``. Thinned by
        ``sync_every`` unless ``force`` (the learner forces at phase
        boundaries so actors always see the consumption-time weights). The
        ``weight_sync_drop`` fault drops this publish's payload
        deterministically."""
        if not force and version % self.sync_every != 0:
            return
        with self._cond:
            if version <= self._payload_version:
                return  # already-published version (boundary force republish)
                # — checked BEFORE the snapshot below, a full copy of the
                # weights on the card
        if self._plan is not None and self._plan.poll("weight_sync_drop", version=version):
            if self.metrics is not None:
                self.metrics.inc("async/weight_sync_drops")
            return
        copied = snapshot_params(params)
        with self._cond:
            if version <= self._payload_version:
                return  # lost a publish race while copying
            self._params = copied
            self._payload_version = version
            self._cond.notify_all()
        if self.metrics is not None:
            self.metrics.inc("async/weight_syncs")

    def announce(self, target: int, collection: int) -> None:
        """Record that collection ``collection`` will be consumed at version
        ``target``. The collection index is monotonic; a LATER announcement
        for the SAME collection may lower the target — the drain-start
        announce carries the true consumption version, which heals an
        over-estimated phase-end target (a learn phase that ran fewer
        updates than predicted must not gate actors forever)."""
        with self._cond:
            if int(collection) > self._announced_col:
                self._announced_col = int(collection)
                self._target = int(target)
            elif int(collection) == self._announced_col:
                self._target = min(self._target, int(target))
            self._cond.notify_all()

    def grant(self, index: int) -> None:
        """Free every chunk up to ``index`` whatever its collection: the
        learner is draining it now, under the newest published weights."""
        with self._cond:
            if int(index) > self._granted:
                self._granted = int(index)
                self._cond.notify_all()

    def fetch(self, template: Any = None) -> Tuple[Any, int]:
        """Newest published (weights, version); blocks until the first
        publish lands. ``template`` is accepted for transport symmetry with
        :class:`FileWeightChannel` (in-process payloads need no restore)."""
        with self._cond:
            while self._params is None:
                if self._closed:
                    raise RuntimeError("weight channel closed before first publish")
                self._cond.wait(timeout=0.1)
            return self._params, self._payload_version

    def _gate(self, max_staleness: int, collection: int, index: Optional[int]) -> bool:
        # caller holds _cond
        return gate_open(self._params is not None, self._payload_version, self._target,
                         self._announced_col, self._granted, max_staleness, collection, index)

    def ready(self, max_staleness: int, collection: int = 1,
              index: Optional[int] = None) -> bool:
        """Non-blocking gate check: may chunk ``index`` of ``collection``
        start under the newest payload without violating the staleness
        bound?"""
        with self._cond:
            return self._gate(max_staleness, collection, index)

    def wait_ready(
        self,
        max_staleness: int,
        collection: int = 1,
        stop: Optional[threading.Event] = None,
        index: Optional[int] = None,
    ) -> bool:
        """Block until starting chunk ``index`` of ``collection`` under the
        newest payload satisfies the staleness bound. Returns False when
        closed/stopped."""
        with self._cond:
            while True:
                if self._closed or (stop is not None and stop.is_set()):
                    return False
                if self._gate(max_staleness, collection, index):
                    return True
                self._cond.wait(timeout=0.05)

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()


class FileWeightChannel:
    """Atomic file-backed weights channel (process mode).

    Layout under ``root``: ``weights.npz`` (the state dict by parameter
    name, tmp+rename committed) and ``MANIFEST.json`` (``{"version":
    payload version, "target": phase-end target}``). The manifest is
    written after the weights file; the version stamped inside the npz lets
    a reader detect a racing overwrite and retry. Readers cache the last
    adopted version, so polling is one small JSON read until something
    actually changes.
    """

    MANIFEST = "MANIFEST.json"
    WEIGHTS = "weights.npz"
    VERSION_KEY = "__version__"

    def __init__(
        self,
        root: str,
        plan: Any = None,
        metrics: Any = None,
        sync_every: int = 1,
        poll_interval_s: float = 0.02,
        fetch_timeout_s: float = 60.0,
    ):
        self.root = root
        self._plan = plan
        self.metrics = metrics
        self.sync_every = max(1, int(sync_every))
        self.poll = float(poll_interval_s)
        # fetch retry is DEADLINE-based, never attempt-count-based: the
        # learner's npz write scales with the model, and a healthy slow
        # writer must not read as "writer dead" (floor 30s)
        self.fetch_timeout_s = max(30.0, float(fetch_timeout_s))
        os.makedirs(root, exist_ok=True)
        self._cache: Tuple[Any, int] = (None, -1)
        self._closed = False

    # -- learner side ----------------------------------------------------

    def _read_manifest(self) -> dict:
        try:
            with open(os.path.join(self.root, self.MANIFEST)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return {"version": -1, "target": 0}

    def _write_manifest(self, manifest: dict) -> None:
        path = os.path.join(self.root, self.MANIFEST)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, path)

    def publish(self, params: Any, version: int, force: bool = False) -> None:
        if not force and version % self.sync_every != 0:
            return
        if self._plan is not None and self._plan.poll("weight_sync_drop", version=version):
            if self.metrics is not None:
                self.metrics.inc("async/weight_sync_drops")
            return
        manifest = self._read_manifest()
        if version <= int(manifest.get("version", -1)):
            return
        arrays = {self.VERSION_KEY: np.asarray(version, np.int64)}
        for name, value in state_items(params):
            arrays[name] = host_array(value)
        path = os.path.join(self.root, self.WEIGHTS)
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
        manifest["version"] = version
        self._write_manifest(manifest)
        if self.metrics is not None:
            self.metrics.inc("async/weight_syncs")

    def announce(self, target: int, collection: int) -> None:
        """Same semantics as :meth:`WeightChannel.announce`: monotonic
        collection, same-collection announcements may LOWER the target
        (the drain-start heal)."""
        manifest = self._read_manifest()
        old_target = int(manifest.get("target", 0))
        old_col = int(manifest.get("collection", 0))
        if int(collection) > old_col:
            new_col, new_target = int(collection), int(target)
        elif int(collection) == old_col:
            new_col, new_target = old_col, min(old_target, int(target))
        else:
            return
        if new_target == old_target and new_col == old_col:
            return  # no-op announce (the drain-time heal path) — skip the write
        manifest["target"] = new_target
        manifest["collection"] = new_col
        self._write_manifest(manifest)

    def grant(self, index: int) -> None:
        """Same semantics as :meth:`WeightChannel.grant` (a manifest write
        only when the granted index moves)."""
        manifest = self._read_manifest()
        if int(index) <= int(manifest.get("granted", -1)):
            return
        manifest["granted"] = int(index)
        self._write_manifest(manifest)

    # -- actor side ------------------------------------------------------

    def fetch(self, template: Any = None) -> Tuple[Any, int]:
        """Newest published (weights, version), restored into
        ``template``'s structure and dtypes (the actor's own module: a
        frozen copy of it with the published state loaded). Blocks until
        the first publish lands."""
        manifest = self._read_manifest()
        while int(manifest.get("version", -1)) < 0:
            if self._closed:
                raise RuntimeError("weight channel closed before first publish")
            time.sleep(self.poll)
            manifest = self._read_manifest()
        version = int(manifest["version"])
        if version == self._cache[1]:
            return self._cache

        path = os.path.join(self.root, self.WEIGHTS)
        arrays = None
        deadline = time.monotonic() + self.fetch_timeout_s
        # the retry sleep is floored: with poll_interval_s ≈ 0 a deadline
        # this long would otherwise busy-spin re-deserializing the full
        # npz at 100% CPU until the writer lands
        retry_pause = max(self.poll, 0.005)
        while time.monotonic() < deadline:
            try:
                with np.load(path) as data:
                    stamped = int(data[self.VERSION_KEY])
                    read = {k: data[k] for k in data.files if k != self.VERSION_KEY}
            except (OSError, ValueError, KeyError, zipfile.BadZipFile):
                time.sleep(retry_pause)  # mid-replace read; retry
                continue
            if stamped < version:
                time.sleep(retry_pause)  # manifest ahead of a racing writer
                continue
            # a payload at least as new as the manifest promised: adopt it
            # under ITS stamped version (never mislabel old weights new)
            version = stamped
            arrays = read
            break
        if arrays is None:
            raise RuntimeError(
                f"weight channel: no readable payload >= version {version} "
                f"at {path} after {self.fetch_timeout_s:.0f}s — writer dead "
                "or directory corrupted? (a slow large-model write needs a "
                "larger async_rl.fetch_timeout_s)"
            )
        self._cache = (assemble_params(arrays, template), version)
        return self._cache

    def ready(self, max_staleness: int, collection: int = 1,
              index: Optional[int] = None) -> bool:
        """Non-blocking gate check: may chunk ``index`` of ``collection``
        start under the newest payload without violating the staleness
        bound?"""
        manifest = self._read_manifest()
        version = int(manifest.get("version", -1))
        return gate_open(version >= 0, version, int(manifest.get("target", 0)),
                         int(manifest.get("collection", 0)), int(manifest.get("granted", -1)),
                         max_staleness, collection, index)

    def wait_ready(
        self,
        max_staleness: int,
        collection: int = 1,
        stop: Optional[threading.Event] = None,
        index: Optional[int] = None,
    ) -> bool:
        while True:
            if self._closed or (stop is not None and stop.is_set()):
                return False
            if self.ready(max_staleness, collection, index):
                return True
            time.sleep(self.poll)

    def close(self) -> None:
        self._closed = True
