"""Collective actor-fleet transport: weights-dissemination tree, sharded
experience queue, elastic membership (``async_rl.transport: collective``).

Port of ``trlx_tpu/async_rl/transport.py``. The file transport rewrites the
FULL state dict as an npz per publish and every actor polls
``MANIFEST.json`` — fine for 2 processes, wasteful for a fleet. This
module moves the fleet onto a message fabric with three pieces:

**Weights-dissemination tree.** The learner (the fleet *root*) publishes
versioned **deltas** of its state dict: the leaves are the state entries
in the state dict's fixed order, each is digested (blake2b over
bytes+dtype+shape) and only leaves the update actually changed ship —
frozen layers (``model.num_layers_unfrozen``) never move after the first
snapshot. Deltas fan out over a configurable-``fanout`` tree: the root
sends to its direct children only; every actor relays to the children the
tree layout assigns it, so the learner's egress is O(fanout), not
O(fleet). Joiners bootstrap from a full snapshot in their WELCOME; a
member whose delta base mismatches (it missed a publish — e.g. it joined
mid-publish or its parent died) requests a resync and receives a full
snapshot — the tree self-heals, never deadlocks. The
``publish/announce/fetch/ready`` staleness-gate contract of
:class:`~trlx_tpu_torch.async_rl.channel.WeightChannel` is kept verbatim, so
``max_staleness: 0`` remains bit-identical to the alternating loop.

**Sharded experience queue.** Chunk *headers* (index, version, producer)
travel down the same tree as the params — every member sees global commit
state — while chunk *payloads* move exactly once, point-to-point over the
producing actor's link to the learner. The learner's ordered drain and
requeue-on-actor-death semantics are unchanged: the
:class:`CollectiveExperienceQueue` facade hands the
:class:`~trlx_tpu_torch.async_rl.runtime.AsyncCollector` arrival-ordered chunks
and its reorder buffer enforces strict index order.

**Elastic membership.** Actors join (HELLO → WELCOME with snapshot + tree
position) and leave (LEAVE, or link EOF on death) mid-run; liveness rides
the messages the fleet already exchanges — work requests, chunk commits,
delta acks — so membership adds **zero new sync points**. A departed
member's leased chunk indices requeue onto survivors, which regenerate the
identical specs (the chunk stream is seed-derived), so a fleet that
shrinks mid-run still produces a store bit-identical to serial at
``max_staleness: 0``.

Fabric: host links are stdlib ``multiprocessing.connection`` TCP
(message-framed, authenticated), as in JAX — not a ``torch.distributed``
group, whose world size is fixed at initialization and whose collectives
barrier every participant, which is wrong for a fleet whose membership
changes mid-run. Leaves travel as CPU torch tensors (pickled: every dtype,
bf16 included, round-trips bit-exactly); an actor assembles them into a
frozen copy of its own module on its device.

Bootstrap discovery (process mode) is the single remaining file:
``ENDPOINT.json`` under ``async_rl.root_dir`` names the root's address and
auth key. All params, chunks, and membership move in-fabric.
"""

import hashlib
import json
import os
import pickle
import threading
import time
from multiprocessing.connection import Client, Listener
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from trlx_tpu_torch.async_rl.channel import assemble_params, gate_open, state_items
from trlx_tpu_torch.async_rl.queue import (
    ExperienceChunk,
    QueueClosed,
    _atomic_write_json,
)
from trlx_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

__all__ = [
    "CollectiveExperienceQueue",
    "CollectiveWeightChannel",
    "FleetActorClient",
    "FleetCoordinator",
    "read_endpoint",
    "tree_parent_slot",
    "write_endpoint",
]

ENDPOINT_FILE = "ENDPOINT.json"


# ---------------------------------------------------------------------------
# tree layout + wire helpers
# ---------------------------------------------------------------------------


def tree_parent_slot(slot: int, fanout: int) -> Optional[int]:
    """Parent of actor ``slot`` in the dissemination tree (``None`` = the
    learner root). Slots are assigned in join order and form a ``fanout``-ary
    heap rooted at the learner: actor slot ``s`` is heap node ``s + 1``, so
    its parent node is ``s // fanout`` — node 0 is the root, node ``p >= 1``
    is actor slot ``p - 1``. Vacant slots are never reused; when a member
    dies, the root takes over its orphaned children's tree edges directly
    (their control links — see ``FleetCoordinator._direct_links``)."""
    parent_node = slot // max(1, int(fanout))
    return None if parent_node == 0 else parent_node - 1


def _encode_delta(pairs: List[Tuple[int, Any]]) -> bytes:
    """Serialize ``(leaf_index, tensor or array)`` pairs. Pickle keeps exact
    dtypes (bf16 tensors included), so a delta round-trip is bit-exact; the
    blob length is the measured ``async/publish_bytes``."""
    return pickle.dumps(pairs, protocol=4)


def _decode_delta(blob: bytes) -> List[Tuple[int, Any]]:
    return pickle.loads(blob)


def _leaf_bytes(leaf: Any) -> bytes:
    if isinstance(leaf, torch.Tensor):
        flat = leaf.detach().contiguous().reshape(-1)
        return flat.view(torch.uint8).numpy().tobytes() if flat.numel() else b""
    return np.ascontiguousarray(leaf).tobytes()


def _leaf_digest(leaf: Any) -> bytes:
    h = hashlib.blake2b(digest_size=16)
    h.update(str(leaf.dtype).encode())
    h.update(str(tuple(leaf.shape)).encode())
    h.update(_leaf_bytes(leaf))
    return h.digest()


def _host_leaves(params: Any) -> List[Any]:
    """The state entries in their fixed order, on the host: CPU tensors
    (copies, never views of the live weights) or numpy arrays."""
    out = []
    for _name, value in state_items(params):
        if isinstance(value, torch.Tensor):
            out.append(value.detach().to("cpu", copy=True))
        else:
            out.append(np.array(value, copy=True))
    return out


def _assemble(leaves: List[Any], template: Any) -> Any:
    """Leaves → ``template``'s structure and dtypes by position in its
    state (the :meth:`FileWeightChannel.fetch` restore contract): a frozen
    copy of a template module, or a dict."""
    if template is None:
        return list(leaves)
    names = [name for name, _ in state_items(template)]
    if len(names) != len(leaves):
        raise ValueError(f"fleet payload has {len(leaves)} leaves, the template "
                         f"{len(names)}: not the same model")
    return assemble_params(dict(zip(names, leaves)), template)


def write_endpoint(root_dir: str, address: Tuple[str, int], authkey: bytes) -> str:
    """Atomically publish the root's fabric endpoint for process-mode
    actors — the ONLY file the collective transport touches (discovery;
    everything else moves in-fabric)."""
    os.makedirs(root_dir, exist_ok=True)
    path = os.path.join(root_dir, ENDPOINT_FILE)
    _atomic_write_json(
        path, {"host": address[0], "port": address[1], "authkey": authkey.hex()}
    )
    return path


def read_endpoint(
    root_dir: str, timeout_s: float = 60.0, poll_interval_s: float = 0.05
) -> Tuple[Tuple[str, int], bytes]:
    """Wait for the root's endpoint file (the learner may start second)."""
    path = os.path.join(root_dir, ENDPOINT_FILE)
    deadline = time.monotonic() + timeout_s
    while True:
        try:
            with open(path) as f:
                data = json.load(f)
            return (data["host"], int(data["port"])), bytes.fromhex(data["authkey"])
        except (OSError, ValueError, KeyError):
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"no fleet endpoint at {path} after {timeout_s:.0f}s — "
                    "is the learner running with async_rl.transport: collective?"
                )
            time.sleep(poll_interval_s)


class _Link:
    """One fabric connection with serialized sends (broadcast and reply
    paths write concurrently from different threads)."""

    def __init__(self, conn):
        self.conn = conn
        self._send_lock = threading.Lock()

    def send(self, msg) -> None:
        with self._send_lock:
            self.conn.send(msg)

    def recv(self, should_stop: Optional[Callable[[], bool]] = None):
        """Blocking receive. With ``should_stop``, polls in short slices so
        a locally-initiated shutdown terminates the loop promptly — closing
        a socket fd does NOT wake a peer thread blocked in ``read`` on
        Linux, only remote EOF does, so every receive loop must be able to
        notice its own side shutting down. Returns ``None`` on stop."""
        if should_stop is None:
            return self.conn.recv()
        while True:
            if should_stop():
                return None
            if self.conn.poll(0.1):
                return self.conn.recv()

    def close(self) -> None:
        try:
            self.conn.close()
        except OSError:  # pragma: no cover - already torn down
            pass


def _listener_timeout(listener: Listener, seconds: float) -> None:
    """Give a Listener's accept a timeout so its accept loop can observe a
    shutdown flag: close() does not wake a thread blocked in ``accept``.
    Reaches one level into multiprocessing internals (stable since 2.x);
    degrades to the dummy-wake-free blocking accept if they move."""
    try:
        listener._listener._socket.settimeout(seconds)
    except AttributeError:  # pragma: no cover - stdlib internals moved
        pass


class _Member:
    """Coordinator-side record of one fleet member."""

    def __init__(self, member_id: int, slot: int, link: _Link, info: Dict[str, Any]):
        self.id = member_id
        self.slot = slot
        self.link = link  # control link (work, chunks, acks, beats)
        self.info = info
        self.last_seen = time.perf_counter()


class FleetCoordinator:
    """The learner-side fleet root: membership, the dissemination tree,
    chunk arrival, and work leasing. Facades
    (:class:`CollectiveWeightChannel` / :class:`CollectiveExperienceQueue`)
    adapt it to the channel/queue contracts the
    :class:`~trlx_tpu_torch.async_rl.runtime.AsyncCollector` consumes."""

    def __init__(
        self,
        fanout: int = 2,
        bind_host: str = "127.0.0.1",
        capacity: int = 8,
        plan: Any = None,
        metrics: Any = None,
        sync_every: int = 1,
        actor_timeout_s: float = 300.0,
        authkey: Optional[bytes] = None,
    ):
        self.fanout = max(1, int(fanout))
        self.capacity = max(1, int(capacity))
        self._plan = plan
        self.metrics = metrics
        self.sync_every = max(1, int(sync_every))
        self.actor_timeout_s = float(actor_timeout_s)
        self.authkey = authkey if authkey is not None else os.urandom(16)
        self._listener = Listener((bind_host, 0), authkey=self.authkey)
        self.address: Tuple[str, int] = self._listener.address

        # reentrant: helper methods (tree-edge enumeration, work
        # assignment, the staleness gate) take the lock themselves and are
        # also called from sections that already hold it
        self._cond = threading.Condition(threading.RLock())
        self._members: Dict[int, _Member] = {}  # guarded-by: _cond
        self._slots: Dict[int, Optional[int]] = {}  # guarded-by: _cond
        self._next_member_id = 0  # guarded-by: _cond
        self._closed = False  # guarded-by: _cond
        # weights state (host leaves; one copy, the npz's footprint)
        self._leaves: Optional[List[Any]] = None  # guarded-by: _cond
        self._digests: List[bytes] = []  # guarded-by: _cond
        self._version = -1  # guarded-by: _cond
        self._target = 0  # guarded-by: _cond
        self._announced_col = 0  # guarded-by: _cond
        self._granted = -1  # guarded-by: _cond
        # experience state
        self._arrived: Dict[int, ExperienceChunk] = {}  # guarded-by: _cond
        self._popped: set = set()  # guarded-by: _cond (handed to the drain)
        self._cursor = 0  # guarded-by: _cond (learner finalize floor)
        # work leasing (process-mode actors; thread actors dispatch in-proc)
        self._next_index = 0  # guarded-by: _cond
        self._pending: List[int] = []  # guarded-by: _cond (requeued, sorted)
        self._leases: Dict[int, int] = {}  # guarded-by: _cond (index -> member)
        self._work_waiters: List[int] = []  # guarded-by: _cond (member ids, FIFO)
        # dissemination accounting (ack-based latency on the learner clock)
        self._await_acks: Dict[int, set] = {}  # guarded-by: _cond
        self._publish_t0: Dict[int, float] = {}  # guarded-by: _cond
        self._win_bytes = 0  # guarded-by: _cond
        self._win_latencies: List[float] = []  # guarded-by: _cond
        # stall guard: "no member ever joined" counts as empty from t0
        self._empty_since: Optional[float] = time.perf_counter()  # guarded-by: _cond

        self._threads: List[threading.Thread] = []  # guarded-by: _cond
        _listener_timeout(self._listener, 0.2)
        accept = threading.Thread(
            target=self._accept_loop, name="trlx-fleet-accept", daemon=True
        )
        self._threads.append(accept)
        accept.start()

    def _is_closed(self) -> bool:
        with self._cond:
            return self._closed

    # -- membership ------------------------------------------------------

    def _accept_loop(self) -> None:
        while True:
            if self._is_closed():
                return
            try:
                conn = self._listener.accept()
            except Exception:
                # accept timeout (the shutdown-observation beat), listener
                # closed, or a failed auth handshake; only shutdown ends
                # the loop
                continue
            try:
                if not conn.poll(5):
                    conn.close()
                    continue
                first = conn.recv()
            except (EOFError, OSError, TypeError):
                conn.close()
                continue
            if not isinstance(first, tuple) or not first:
                conn.close()
                continue
            if first[0] == "hello":
                self._register(conn, first[1])
            else:
                conn.close()

    def _register(self, conn, info: Dict[str, Any]) -> None:
        link = _Link(conn)
        with self._cond:
            if self._closed:
                link.send(("done",))
                link.close()
                return
            member_id = self._next_member_id
            self._next_member_id += 1
            slot = len(self._slots)
            self._slots[slot] = member_id
            parent = tree_parent_slot(slot, self.fanout)
            parent_addr = None
            if parent is not None:
                pid = self._slots.get(parent)
                pm = self._members.get(pid) if pid is not None else None
                if pm is not None and pm.info.get("listen"):
                    parent_addr = tuple(pm.info["listen"])
            leaves = self._leaves  # immutable list; swapped whole by publish
            state = {
                "version": self._version,
                "target": self._target,
                "collection": self._announced_col,
                "granted": self._granted,
                "cursor": self._cursor,
            }
        # snapshot pickling happens OUTSIDE the lock (see publish). A
        # publish landing in between leaves the joiner one version behind
        # its first delta's base — the documented gap-detect → resync heal.
        snapshot = None
        if leaves is not None:
            snapshot = _encode_delta(list(enumerate(leaves)))
        welcome = (
            "welcome",
            {
                "member_id": member_id,
                "slot": slot,
                "parent": parent_addr,
                "params": snapshot,
                "capacity": self.capacity,
                **state,
            },
        )
        member = _Member(member_id, slot, link, info)
        if snapshot is not None:
            with self._cond:
                self._win_bytes += len(snapshot)  # join bootstrap egress
        # the welcome must be this link's FIRST message: the member is
        # inserted (and so becomes a broadcast target) only after it ships
        try:
            link.send(welcome)
        except (OSError, ValueError):
            link.close()
            return
        with self._cond:
            self._members[member_id] = member
            self._empty_since = None
            thread = threading.Thread(
                target=self._member_loop,
                args=(member,),
                name=f"trlx-fleet-peer-{member_id}",
                daemon=True,
            )
            self._threads.append(thread)
            self._cond.notify_all()
        thread.start()
        if self.metrics is not None:
            self.metrics.inc("async/fleet_joins")
        logger.info(
            f"fleet: member {member_id} joined (slot {slot}, "
            f"parent {'root' if parent_addr is None else parent_addr})"
        )

    def _member_loop(self, member: _Member) -> None:
        graceful = False
        try:
            while True:
                try:
                    msg = member.link.recv(should_stop=self._is_closed)
                except (EOFError, OSError, TypeError, pickle.UnpicklingError):
                    break
                if msg is None:
                    return  # local shutdown; close() handles the fleet
                member.last_seen = time.perf_counter()
                kind = msg[0]
                if kind == "work":
                    with self._cond:
                        self._work_waiters.append(member.id)
                        sends = self._maybe_assign()
                    self._dispatch(sends)
                elif kind == "chunk":
                    self._on_chunk(member, msg[1], msg[2])
                elif kind == "ack":
                    self._on_ack(member.id, int(msg[1]))
                elif kind == "resync":
                    self._send_snapshot(member)
                elif kind == "beat":
                    pass  # liveness already stamped above
                elif kind == "leave":
                    graceful = True
                    break
        finally:
            self._on_member_dead(member, graceful=graceful)

    def _on_member_dead(self, member: _Member, graceful: bool) -> None:
        with self._cond:
            if self._members.pop(member.id, None) is None:
                return  # already reaped
            self._slots[member.slot] = None
            self._work_waiters = [w for w in self._work_waiters if w != member.id]
            requeued = sorted(
                idx
                for idx, owner in self._leases.items()
                if owner == member.id and idx not in self._arrived
                and idx not in self._popped and idx >= self._cursor
            )
            for idx in requeued:
                del self._leases[idx]
            self._pending = sorted(set(self._pending).union(requeued))
            for acks in self._await_acks.values():
                acks.discard(member.id)
            self._check_acks_locked()
            if not self._members:
                self._empty_since = time.perf_counter()
            closed = self._closed
            sends = self._maybe_assign()
            self._cond.notify_all()
        member.link.close()
        self._dispatch(sends)
        if closed:
            return
        if not graceful and self.metrics is not None:
            self.metrics.inc("async/fleet_shrinks")
        if requeued and self.metrics is not None:
            self.metrics.inc("async/requeued_chunks", len(requeued))
        detail = (
            f"fleet: member {member.id} {'left' if graceful else 'died'}"
            + (f"; requeued chunks {requeued} onto survivors" if requeued else "")
        )
        if graceful:
            logger.info(detail)
        else:
            logger.warning(detail)

    def fleet_size(self) -> int:
        with self._cond:
            return len(self._members)

    def pending_acks(self) -> int:
        """Publishes not yet acked by every live member (bench/test hook:
        drain this to 0 before reading the latency window)."""
        with self._cond:
            return len(self._await_acks)

    def members_snapshot(self) -> List[Dict[str, Any]]:
        """Diagnostic view: (id, slot, mesh descriptor) per live member."""
        with self._cond:
            members = sorted(self._members.values(), key=lambda m: m.id)
            return [
                {"id": m.id, "slot": m.slot, "mesh": m.info.get("mesh")}
                for m in members
            ]

    # -- weights dissemination ------------------------------------------

    def _direct_links(self) -> List[_Link]:
        # the tree's root edges: members whose parent slot is the root or
        # is vacant (the parent died — the orphan's future tree traffic
        # arrives on its control link; its one-time state catch-up is the
        # resync snapshot). _cond is reentrant: most callers already hold
        # it to keep edge choice atomic with the state they are about to
        # send.
        with self._cond:
            out = []
            for member in sorted(self._members.values(), key=lambda m: m.slot):
                parent = tree_parent_slot(member.slot, self.fanout)
                if parent is None:
                    out.append(member.link)
                    continue
                pid = self._slots.get(parent)
                if pid is None or pid not in self._members:
                    out.append(member.link)  # orphaned: root takes over
            return out

    def _dispatch(self, sends: List[Tuple[_Link, tuple]]) -> None:
        for link, msg in sends:
            try:
                link.send(msg)
            except (OSError, ValueError):
                pass  # the member's recv loop will reap it

    def _broadcast(self, msg: tuple) -> None:
        with self._cond:
            links = self._direct_links()
        self._dispatch([(link, msg) for link in links])

    def publish(self, params: Any, version: int, force: bool = False) -> None:
        """Publish ``params`` as ``version`` down the tree as a delta of
        changed leaves (unchanged-leaf skipping). Same thinning/force/drop
        semantics as :meth:`WeightChannel.publish`."""
        if not force and version % self.sync_every != 0:
            return
        with self._cond:
            if version <= self._version:
                return  # checked before the host copy below (real work)
        if self._plan is not None and self._plan.poll("weight_sync_drop", version=version):
            if self.metrics is not None:
                self.metrics.inc("async/weight_sync_drops")
            return
        leaves = _host_leaves(params)
        digests = [_leaf_digest(leaf) for leaf in leaves]
        with self._cond:
            if version <= self._version:
                return  # lost a publish race while hashing
            if self._digests and len(self._digests) == len(digests):
                changed = [
                    i for i, d in enumerate(digests) if d != self._digests[i]
                ]
                full = False
            else:
                changed = list(range(len(leaves)))
                full = True
            base = self._version
            self._leaves = leaves
            self._digests = digests
            self._version = version
        # serialize OUTSIDE the lock: a model-scale pickle takes real time
        # and _cond also guards chunk arrival / work assignment / the
        # learner's drain — holding it here would stall the whole control
        # plane. The version/leaf state above was already swapped
        # atomically; `leaves` is immutable from here on.
        blob = _encode_delta([(i, leaves[i]) for i in changed])
        header = {
            "version": version,
            "base": base,
            "full": full,
            "n_changed": len(changed),
            "n_leaves": len(leaves),
        }
        with self._cond:
            links = self._direct_links()
            live = set(self._members)
            if live:
                self._await_acks[version] = live
                self._publish_t0[version] = time.perf_counter()
            self._win_bytes += len(blob) * len(links)
            self._cond.notify_all()
        self._dispatch([(link, ("params", header, blob)) for link in links])
        if self.metrics is not None:
            self.metrics.inc("async/weight_syncs")
            self.metrics.observe("async/publish_bytes", float(len(blob)))

    def _send_snapshot(self, member: _Member) -> None:
        with self._cond:
            leaves = self._leaves  # immutable; swapped whole by publish
            version = self._version
        if leaves is None:
            return
        blob = _encode_delta(list(enumerate(leaves)))  # outside the lock
        header = {
            "version": version,
            "base": -1,
            "full": True,
            "n_changed": len(leaves),
            "n_leaves": len(leaves),
        }
        with self._cond:
            self._win_bytes += len(blob)
        self._dispatch([(member.link, ("params", header, blob))])

    def _on_ack(self, member_id: int, version: int) -> None:
        with self._cond:
            # an ack at version v covers every outstanding publish <= v
            # (a resync snapshot jumps a member past intermediate deltas)
            for v, acks in self._await_acks.items():
                if v <= version:
                    acks.discard(member_id)
            self._check_acks_locked()

    def _check_acks_locked(self) -> None:
        with self._cond:  # reentrant: ack/death handlers already hold it
            done = [v for v, acks in self._await_acks.items() if not acks]
            for version in done:
                del self._await_acks[version]
                t0 = self._publish_t0.pop(version, None)
                if t0 is not None:
                    self._win_latencies.append(time.perf_counter() - t0)

    def announce(self, target: int, collection: int) -> None:
        """Same monotonic-collection / min-target semantics as
        :meth:`WeightChannel.announce`; no-op announcements (the drain-time
        heal path) skip the broadcast."""
        with self._cond:
            if int(collection) > self._announced_col:
                self._announced_col = int(collection)
                self._target = int(target)
            elif int(collection) == self._announced_col:
                new = min(self._target, int(target))
                if new == self._target:
                    return
                self._target = new
            else:
                return
            target, collection = self._target, self._announced_col
            cursor = self._cursor
        self._broadcast(("announce", target, collection, cursor))

    def grant(self, index: int) -> None:
        """Same semantics as :meth:`WeightChannel.grant`; a broadcast only
        when the granted index moves."""
        with self._cond:
            if int(index) <= self._granted:
                return
            self._granted = int(index)
        self._broadcast(("grant", int(index)))

    # -- experience arrival + leasing -----------------------------------

    def _on_chunk(self, member: _Member, header: Dict[str, Any], blob: bytes) -> None:
        index = int(header["index"])
        payload = pickle.loads(blob)
        with self._cond:
            if (
                index < self._cursor
                or index in self._arrived
                or index in self._popped
            ):
                return  # stale duplicate (requeue race already resolved)
            self._arrived[index] = ExperienceChunk(
                index=index, version=int(header["version"]), payload=payload
            )
            self._leases.pop(index, None)
            cursor = self._cursor
            self._cond.notify_all()
        if self.metrics is not None:
            self.metrics.inc("async/chunks")
        # the header rides the tree: every member sees global commit state
        # (spec-cache pruning + join-time dedup); the payload moved once,
        # point-to-point, on the producer's own link
        self._broadcast(
            ("header", {"index": index, "version": int(header["version"]),
                        "producer": member.id, "cursor": cursor})
        )

    def _maybe_assign(self) -> List[Tuple[_Link, tuple]]:
        # returns the (link, message) sends to dispatch AFTER the caller
        # releases the lock (_cond is reentrant; callers hold it to keep
        # assignment atomic with the membership change that triggered it)
        with self._cond:
            sends: List[Tuple[_Link, tuple]] = []
            while self._work_waiters:
                if self._closed:
                    member = self._members.get(self._work_waiters.pop(0))
                    if member is not None:
                        sends.append((member.link, ("done",)))
                    continue
                if self._pending:
                    index = self._pending[0]
                    fresh = False
                elif self._next_index - self._cursor < self.capacity:
                    index = self._next_index
                    fresh = True
                else:
                    break  # production window full: leave waiters queued
                member = self._members.get(self._work_waiters[0])
                if member is None:
                    self._work_waiters.pop(0)
                    continue
                self._work_waiters.pop(0)
                if fresh:
                    self._next_index += 1
                else:
                    self._pending.pop(0)
                self._leases[index] = member.id
                sends.append((member.link, ("assign", index)))
            return sends

    def note_finalized(self, cursor: int) -> None:
        """The learner's finalize floor advanced: widen the production
        window, drop consumed state, and tell the fleet (cursor rides the
        header/announce traffic — actors prune their spec caches on it)."""
        with self._cond:
            if cursor <= self._cursor:
                return
            self._cursor = cursor
            self._popped = {i for i in self._popped if i >= cursor}
            sends = self._maybe_assign()
            links = self._direct_links()
        self._dispatch(sends)
        self._dispatch([(link, ("cursor", cursor)) for link in links])

    def get(self, timeout: Optional[float] = None) -> ExperienceChunk:
        """Arrival-ordered pop (lowest arrived index first); the
        collector's reorder buffer enforces strict finalize order."""
        deadline = None if timeout is None else time.monotonic() + timeout
        last_heal = time.monotonic()
        while True:
            with self._cond:
                while not self._arrived:
                    if self._closed:
                        raise QueueClosed("fleet transport closed")
                    if (
                        self._empty_since is not None
                        and time.perf_counter() - self._empty_since
                        > self.actor_timeout_s
                    ):
                        raise RuntimeError(
                            f"fleet empty for {self.actor_timeout_s:.0f}s "
                            "with chunks outstanding — every actor died or "
                            "left and no replacement joined"
                        )
                    remaining = (
                        None if deadline is None else deadline - time.monotonic()
                    )
                    if remaining is not None and remaining <= 0:
                        raise TimeoutError("fleet queue get timed out")
                    if time.monotonic() - last_heal > 0.5:
                        break  # heal beat: re-sync outside the lock
                    self._cond.wait(
                        timeout=0.1 if remaining is None else min(remaining, 0.1)
                    )
                else:
                    index = min(self._arrived)
                    self._popped.add(index)
                    self._leases.pop(index, None)
                    return self._arrived.pop(index)
                target, col, cursor, version, granted = (
                    self._target, self._announced_col, self._cursor,
                    self._version, self._granted,
                )
            # the learner is starved: broadcast a sync beat so a member
            # that missed a tree message (joined mid-publish, relay parent
            # died mid-send) detects the gap and resyncs — the collective
            # analogue of the file channel's manifest poll, but only
            # active while the drain is actually waiting
            self._broadcast(("sync", version, target, col, cursor, granted))
            last_heal = time.monotonic()

    @property
    def depth(self) -> int:
        with self._cond:
            return len(self._arrived)

    # -- stats + shutdown ------------------------------------------------

    def window_stats(self) -> Dict[str, float]:
        """Per-collection transport gauges; resets the window."""
        stats: Dict[str, float] = {}
        with self._cond:
            stats["async/fleet_size"] = float(len(self._members))
            stats["async/publish_bytes"] = float(self._win_bytes)
            if self._win_latencies:
                stats["async/dissemination_latency_s"] = float(
                    np.mean(self._win_latencies)
                )
            self._win_bytes = 0
            self._win_latencies = []
        return stats

    def close(self) -> None:
        with self._cond:
            if self._closed:
                already = True
            else:
                already = False
                self._closed = True
            members = list(self._members.values())
            self._cond.notify_all()
        if already:
            return
        for member in members:
            try:
                member.link.send(("done",))
            except (OSError, ValueError):
                pass
        try:
            self._listener.close()
        except OSError:  # pragma: no cover - already torn down
            pass
        for member in members:
            member.link.close()
        with self._cond:
            threads = list(self._threads)
        me = threading.current_thread()
        for thread in threads:
            if thread is not me:
                thread.join(timeout=10)
        leaked = [t.name for t in threads if t is not me and t.is_alive()]
        if leaked:  # pragma: no cover - requires a wedged link
            logger.warning(
                f"fleet: transport thread(s) {leaked} did not join within 10s"
            )


class CollectiveWeightChannel:
    """Learner-side :class:`WeightChannel` facade over the coordinator
    (``publish``/``announce``/``close`` — the learner never fetches)."""

    def __init__(self, coordinator: FleetCoordinator):
        self._coord = coordinator

    def publish(self, params: Any, version: int, force: bool = False) -> None:
        self._coord.publish(params, version, force=force)

    def announce(self, target: int, collection: int) -> None:
        self._coord.announce(target, collection)

    def grant(self, index: int) -> None:
        self._coord.grant(index)

    def close(self) -> None:
        self._coord.close()


class CollectiveExperienceQueue:
    """Learner-side :class:`ExperienceQueue` facade over the coordinator
    (arrival-ordered ``get``; producers commit through their own links)."""

    def __init__(self, coordinator: FleetCoordinator):
        self._coord = coordinator

    def get(self, timeout: Optional[float] = None) -> ExperienceChunk:
        return self._coord.get(timeout=timeout)

    def note_finalized(self, cursor: int) -> None:
        self._coord.note_finalized(cursor)

    @property
    def depth(self) -> int:
        return self._coord.depth

    def close(self) -> None:
        self._coord.close()


# ---------------------------------------------------------------------------
# actor-side fleet member
# ---------------------------------------------------------------------------


class FleetActorClient:
    """One fleet member: joins the tree, receives/relays param deltas,
    gates on staleness, leases work, and commits chunk payloads
    point-to-point. Exposes the actor half of BOTH transport seams — the
    :class:`WeightChannel` contract (``wait_ready``/``ready``/``fetch``)
    and the queue's producer contract (``put``)."""

    def __init__(
        self,
        address: Tuple[str, int],
        authkey: bytes,
        template: Any = None,
        mesh_descriptor: Optional[Dict[str, Any]] = None,
        bind_host: str = "127.0.0.1",
        relay: bool = True,
    ):
        self._template = template
        self._cond = threading.Condition(threading.RLock())
        self._closed = False  # guarded-by: _cond
        self._leaves: Optional[List[Any]] = None  # guarded-by: _cond
        self._version = -1  # guarded-by: _cond
        self._target = 0  # guarded-by: _cond
        self._announced_col = 0  # guarded-by: _cond
        self._granted = -1  # guarded-by: _cond
        self._cursor = 0  # guarded-by: _cond
        self._committed: set = set()  # guarded-by: _cond (header view)
        self._assigned: List[int] = []  # guarded-by: _cond
        self._params_cache: Tuple[int, Any] = (-2, None)  # guarded-by: _cond
        self._children: List[_Link] = []  # guarded-by: _cond
        self._resync_sent = -1  # guarded-by: _cond
        self._threads: List[threading.Thread] = []

        self._listener: Optional[Listener] = None
        listen_addr = None
        if relay:
            self._listener = Listener((bind_host, 0), authkey=authkey)
            _listener_timeout(self._listener, 0.2)
            listen_addr = self._listener.address
        self._conn = _Link(Client(tuple(address), authkey=authkey))
        self._conn.send(
            ("hello", {"listen": listen_addr, "mesh": mesh_descriptor,
                       "pid": os.getpid()})
        )
        if not self._conn.conn.poll(30):
            raise RuntimeError("fleet join timed out waiting for WELCOME")
        welcome = self._conn.recv()
        if not (isinstance(welcome, tuple) and welcome[0] == "welcome"):
            raise RuntimeError(f"fleet join failed: unexpected reply {welcome!r}")
        info = welcome[1]
        self.member_id = int(info["member_id"])
        self.slot = int(info["slot"])
        self.capacity = int(info["capacity"])
        self._target = int(info["target"])
        self._announced_col = int(info["collection"])
        self._granted = int(info["granted"])
        self._cursor = int(info["cursor"])
        if info["params"] is not None:
            self._leaves = [arr for _i, arr in _decode_delta(info["params"])]
            self._version = int(info["version"])

        self._feed: Optional[_Link] = None
        if info["parent"] is not None:
            self._feed = _Link(Client(tuple(info["parent"]), authkey=authkey))
            self._feed.send(("feed", self.member_id))
            feed_thread = threading.Thread(
                target=self._recv_loop,
                args=(self._feed,),
                name=f"trlx-fleet-feed-{self.member_id}",
                daemon=True,
            )
            self._threads.append(feed_thread)
            feed_thread.start()
        ctrl = threading.Thread(
            target=self._recv_loop,
            args=(self._conn,),
            name=f"trlx-fleet-client-{self.member_id}",
            daemon=True,
        )
        self._threads.append(ctrl)
        ctrl.start()
        if self._listener is not None:
            serve = threading.Thread(
                target=self._serve_loop,
                name=f"trlx-fleet-serve-{self.member_id}",
                daemon=True,
            )
            self._threads.append(serve)
            serve.start()

    # -- receive + relay -------------------------------------------------

    def _serve_loop(self) -> None:
        while True:
            if self.closed:
                return
            try:
                conn = self._listener.accept()
            except Exception:
                continue  # accept timeout (shutdown beat) or closed
            try:
                if not conn.poll(5):
                    conn.close()
                    continue
                first = conn.recv()
            except (EOFError, OSError, TypeError):
                conn.close()
                continue
            if isinstance(first, tuple) and first and first[0] == "feed":
                child = _Link(conn)
                with self._cond:
                    if self._closed:
                        conn.close()
                        continue
                    self._children.append(child)
                    state = (
                        "sync", self._version, self._target,
                        self._announced_col, self._cursor, self._granted,
                    )
                # hand the new child this node's current view immediately:
                # a child that attached mid-publish gap-detects against it
                # and resyncs instead of silently running one version behind
                try:
                    child.send(state)
                except (OSError, ValueError):
                    pass
            else:
                conn.close()

    def _recv_loop(self, link: _Link) -> None:
        while True:
            try:
                msg = link.recv(should_stop=lambda: self.closed)
            except (EOFError, OSError, TypeError, pickle.UnpicklingError):
                break
            if msg is None:
                return  # local shutdown
            kind = msg[0]
            if kind == "assign":
                with self._cond:
                    self._assigned.append(int(msg[1]))
                    self._cond.notify_all()
            elif kind == "done":
                self._mark_closed()
                self._relay(msg)
                return
            else:
                self._handle_tree(msg)
        # link lost: a dead parent (feed) falls back to nothing — the
        # control link is authoritative; a dead control link closes us
        if link is self._conn:
            self._mark_closed()
        elif link is self._feed:
            self._request_resync()

    def _handle_tree(self, msg: tuple) -> None:
        kind = msg[0]
        if kind == "params":
            header, blob = msg[1], msg[2]
            version = int(header["version"])
            need_resync = False
            with self._cond:
                if version <= self._version:
                    pass  # duplicate/old (e.g. resync raced a delta): ack
                elif header["full"] or (
                    header["base"] == self._version and self._leaves is not None
                ):
                    pairs = _decode_delta(blob)
                    if header["full"]:
                        self._leaves = [arr for _i, arr in pairs]
                    else:
                        for i, arr in pairs:
                            self._leaves[i] = arr
                    self._version = version
                    self._cond.notify_all()
                else:
                    # gap: this member missed a publish (joined mid-publish
                    # or its relay parent died) — ask the root for a full
                    # snapshot instead of applying a delta onto a stale base
                    need_resync = True
            if need_resync:
                self._request_resync()
            else:
                try:
                    self._conn.send(("ack", version))
                except (OSError, ValueError):
                    pass
        elif kind == "announce":
            with self._cond:
                self._target = int(msg[1])
                self._announced_col = int(msg[2])
                self._cursor = max(self._cursor, int(msg[3]))
                self._cond.notify_all()
        elif kind == "grant":
            with self._cond:
                self._granted = max(self._granted, int(msg[1]))
                self._cond.notify_all()
        elif kind == "cursor":
            with self._cond:
                self._cursor = max(self._cursor, int(msg[1]))
                self._committed = {
                    i for i in self._committed if i >= self._cursor
                }
                self._cond.notify_all()
        elif kind == "header":
            with self._cond:
                self._committed.add(int(msg[1]["index"]))
                self._cursor = max(self._cursor, int(msg[1]["cursor"]))
                self._cond.notify_all()
        elif kind == "sync":
            # learner-starved heal beat: adopt announce/cursor state and
            # detect a missed publish (request a full resync on gap)
            version = int(msg[1])
            with self._cond:
                self._target = int(msg[2])
                self._announced_col = int(msg[3])
                self._cursor = max(self._cursor, int(msg[4]))
                self._granted = max(self._granted, int(msg[5]))
                behind = version > self._version
                self._cond.notify_all()
            if behind:
                self._request_resync()
        self._relay(msg)

    def _relay(self, msg: tuple) -> None:
        with self._cond:
            children = list(self._children)
        for child in children:
            try:
                child.send(msg)
            except (OSError, ValueError):
                with self._cond:
                    if child in self._children:
                        self._children.remove(child)
                child.close()

    def _request_resync(self) -> None:
        with self._cond:
            if self._closed or self._resync_sent >= self._version:
                return
            self._resync_sent = self._version
        try:
            self._conn.send(("resync",))
        except (OSError, ValueError):
            pass

    def _mark_closed(self) -> None:
        with self._cond:
            self._closed = True
            self._cond.notify_all()

    # -- WeightChannel contract (actor half) -----------------------------

    def _gate(self, max_staleness: int, collection: int, index: Optional[int]) -> bool:
        # the WeightChannel gate (_cond is reentrant: the wait loops call
        # this while already holding it)
        with self._cond:
            return gate_open(self._leaves is not None, self._version, self._target,
                             self._announced_col, self._granted, max_staleness, collection,
                             index)

    def ready(self, max_staleness: int, collection: int = 1,
              index: Optional[int] = None) -> bool:
        with self._cond:
            return self._gate(max_staleness, collection, index)

    def wait_ready(
        self,
        max_staleness: int,
        collection: int = 1,
        stop: Optional[threading.Event] = None,
        index: Optional[int] = None,
    ) -> bool:
        with self._cond:
            while True:
                if self._closed or (stop is not None and stop.is_set()):
                    return False
                if self._gate(max_staleness, collection, index):
                    return True
                self._cond.wait(timeout=0.05)

    def fetch(self, template: Any = None) -> Tuple[Any, int]:
        """Newest disseminated (params, version) assembled under the
        member's template; blocks until the first snapshot/delta lands.
        Assembly is memoized per version (the CB path fetches at every
        segment boundary)."""
        template = template if template is not None else self._template
        with self._cond:
            while self._leaves is None:
                if self._closed:
                    raise RuntimeError(
                        "fleet transport closed before first publish"
                    )
                self._cond.wait(timeout=0.1)
            version = self._version
            if self._params_cache[0] == version:
                return self._params_cache[1], version
            leaves = list(self._leaves)
        params = _assemble(leaves, template)
        with self._cond:
            if self._params_cache[0] != version:
                self._params_cache = (version, params)
            return self._params_cache[1], version

    # -- queue producer contract ----------------------------------------

    def put(
        self, chunk: ExperienceChunk, stop: Optional[threading.Event] = None
    ) -> None:
        """Commit one chunk: back-pressure against the learner's finalize
        cursor (rides the tree), then ship header + payload point-to-point
        on this member's own link."""
        with self._cond:
            while chunk.index - self._cursor >= self.capacity:
                if self._closed or (stop is not None and stop.is_set()):
                    raise QueueClosed("fleet transport closed")
                self._cond.wait(timeout=0.05)
            if self._closed:
                raise QueueClosed("fleet transport closed")
        blob = pickle.dumps(chunk.payload, protocol=4)
        header = {"index": chunk.index, "version": chunk.version,
                  "nbytes": len(blob)}
        try:
            self._conn.send(("chunk", header, blob))
        except (OSError, ValueError) as e:
            raise QueueClosed(f"fleet transport lost: {e}") from e

    # -- work leasing + membership view ---------------------------------

    def request_work(self, timeout: Optional[float] = None) -> Optional[int]:
        """Lease the next chunk index (blocks; ``None`` = the run drained
        and the fleet is shutting down)."""
        try:
            self._conn.send(("work",))
        except (OSError, ValueError):
            return None
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cond:
            while not self._assigned:
                if self._closed:
                    return None
                remaining = None if deadline is None else deadline - time.monotonic()
                if remaining is not None and remaining <= 0:
                    return None
                self._cond.wait(
                    timeout=0.1 if remaining is None else min(remaining, 0.1)
                )
            return self._assigned.pop(0)

    def cursor_view(self) -> int:
        with self._cond:
            return self._cursor

    def committed_view(self) -> set:
        with self._cond:
            return set(self._committed)

    @property
    def closed(self) -> bool:
        with self._cond:
            return self._closed

    def close(self, graceful: bool = True) -> None:
        with self._cond:
            self._closed = True
            children = list(self._children)
            self._children = []
            self._cond.notify_all()
        if graceful:
            try:
                self._conn.send(("leave",))
            except (OSError, ValueError):
                pass
        if self._listener is not None:
            try:
                self._listener.close()
            except OSError:  # pragma: no cover - already torn down
                pass
        self._conn.close()
        if self._feed is not None:
            self._feed.close()
        for child in children:
            child.close()
        me = threading.current_thread()
        for thread in self._threads:
            if thread is not me:
                thread.join(timeout=10)


def make_member_factory(
    coordinator: FleetCoordinator,
    template_fn: Callable[[], Any],
) -> Callable[[int], FleetActorClient]:
    """Thread-mode member factory for the
    :class:`~trlx_tpu_torch.async_rl.runtime.AsyncCollector`: each actor
    thread joins the fleet as its own member over loopback, so the
    in-process fleet exercises the identical wire protocol as a fleet of
    processes."""

    def factory(actor_id: int) -> FleetActorClient:
        return FleetActorClient(
            coordinator.address,
            coordinator.authkey,
            template=template_fn(),
        )

    return factory
