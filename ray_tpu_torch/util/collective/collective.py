"""Out-of-band collective communication between actors.

Parity: reference ``python/ray/util/collective/collective.py`` —
``GroupManager`` (:40), ``init_collective_group`` (:120),
``create_collective_group`` (:151), ``allreduce`` (:258), ``barrier``
(:298), ``reduce`` (:311), ``broadcast`` (:373), ``allgather`` (:423),
``reducescatter`` (:472), ``send``/``recv`` (:531/:594).

The port's copy of the JAX package's ``util.collective``, on the port's
runtime.  The reference backs these with NCCL/Gloo rings between GPU
actors; collectives inside one program across cards are
``torch.distributed``'s (``ray_tpu_torch.parallel``).  What remains is
the reference's *out-of-band* role: host-side tensor exchange between
actor gangs (e.g. DD-PPO's decentralized gradient allreduce).  It runs
over the object plane: a named rendezvous actor per group sequences each
op; payloads move through the shared-memory object store, never through
the rendezvous actor itself (it only passes ``ObjectRef`` s).  A torch
tensor, on the card too, crosses to the host in one copy and is written
back in place; the reduction is numpy's, in rank order, so every rank
gets the same bytes.

Ops are matched by call order: the Nth collective on a group must be the
same op on every rank (same contract as NCCL).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.core.exceptions import GetTimeoutError, RayTpuError


class CollectiveError(RayTpuError):
    """A collective op failed group-wide (member death or timeout) —
    the NCCL-communicator-abort equivalent.  The group is broken; every
    subsequent op on it raises too."""


class ReduceOp:
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


_REDUCERS = {
    ReduceOp.SUM: lambda arrs: np.sum(arrs, axis=0),
    ReduceOp.PRODUCT: lambda arrs: np.prod(arrs, axis=0),
    ReduceOp.MIN: lambda arrs: np.min(arrs, axis=0),
    ReduceOp.MAX: lambda arrs: np.max(arrs, axis=0),
}


def _rendezvous_name(group_name: str) -> str:
    return f"_collective_rendezvous::{group_name}"


class _Rendezvous:
    """Mailbox actor: sequences ops and fans ObjectRefs between ranks.

    One per group, named + detached so every member can look it up.  Holds
    only refs and tiny metadata — tensor bytes ride the object plane.

    Failure semantics (parity: a NCCL rank death aborts the communicator
    on every member): members register their actor ids at join; while an
    op is outstanding the rendezvous health-checks them (rate-limited)
    against the GCS actor table, and once any member is DEAD every
    ``collect`` returns a ``__broken__`` marker so the remaining ranks
    raise instead of spinning forever.
    """

    def __init__(self, world_size: int):
        self._world = int(world_size)
        # (kind, seq) -> {rank: payload}
        self._boxes: Dict[Any, Dict[int, Any]] = {}
        # (kind, seq) -> set of ranks that already collected (for cleanup)
        self._taken: Dict[Any, set] = {}
        self._joined: set = set()
        self._members: Dict[int, str] = {}  # rank -> actor id hex
        self._broken: Optional[str] = None
        self._last_health_check = 0.0

    def join(self, rank: int, actor_id_hex: Optional[str] = None) -> int:
        self._joined.add(int(rank))
        if actor_id_hex:
            self._members[int(rank)] = actor_id_hex
        return self._world

    def ready(self) -> bool:
        return len(self._joined) >= self._world

    def world_size(self) -> int:
        return self._world

    def post(self, key, rank: int, payload) -> None:
        self._boxes.setdefault(key, {})[int(rank)] = payload

    def _check_members(self) -> None:
        """Rate-limited member liveness sweep against the GCS actor
        table; a dead member breaks the group permanently."""
        now = time.monotonic()
        if self._broken is not None \
                or now - self._last_health_check < 0.5:
            return
        self._last_health_check = now
        from ray_tpu_torch.core import worker as worker_mod
        from ray_tpu_torch.core.ids import ActorID
        core = worker_mod.global_worker_or_none()
        if core is None:
            return
        for rank, hex_id in self._members.items():
            try:
                info = core.get_actor_info(
                    actor_id=ActorID.from_hex(hex_id))
            except Exception:  # noqa: BLE001 — GCS hiccup: check later
                return
            if info is not None and info.get("state") == "DEAD":
                self._broken = (
                    f"rank {rank} (actor {hex_id[:12]}) died: "
                    f"{info.get('death_cause') or 'unknown cause'}")
                return

    def collect(self, key, expected: int, rank: int):
        """Return the box once `expected` ranks have posted, else None.
        A broken group returns {"__broken__": reason} to every rank."""
        box = self._boxes.get(key)
        if box is None or len(box) < expected:
            self._check_members()
            if self._broken is not None:
                return {"__broken__": self._broken}
            return None
        out = dict(box)
        taken = self._taken.setdefault(key, set())
        taken.add(int(rank))
        if len(taken) >= self._world:
            self._boxes.pop(key, None)
            self._taken.pop(key, None)
        return out

    def take_p2p(self, key, rank: int):
        """Single-consumer mailbox read for send/recv."""
        box = self._boxes.get(key)
        if not box:
            self._check_members()
            if self._broken is not None:
                return ("__broken__", self._broken)
            return None
        src, payload = next(iter(box.items()))
        self._boxes.pop(key, None)
        return (src, payload)


class _GroupHandle:
    def __init__(self, group_name: str, world_size: int, rank: int, backend: str):
        self.group_name = group_name
        self.world_size = world_size
        self.rank = rank
        self.backend = backend
        self.rendezvous = ray_tpu_torch.get_actor(_rendezvous_name(group_name))
        self._seq = 0
        self._p2p_seq: Dict[tuple, int] = {}
        self._lock = threading.Lock()

    def next_seq(self) -> int:
        with self._lock:
            self._seq += 1
            return self._seq

    def next_p2p_seq(self, src: int, dst: int) -> int:
        k = (min(src, dst), max(src, dst))
        with self._lock:
            self._p2p_seq[k] = self._p2p_seq.get(k, 0) + 1
            return self._p2p_seq[k]


class GroupManager:
    """Per-process registry of collective groups (reference :40)."""

    def __init__(self):
        self._groups: Dict[str, _GroupHandle] = {}
        self._lock = threading.Lock()

    def create_group(self, group_name: str, world_size: int, rank: int,
                     backend: str) -> _GroupHandle:
        with self._lock:
            if group_name in self._groups:
                raise RayTpuError(f"collective group {group_name!r} already "
                                  f"initialized in this process")
            g = _GroupHandle(group_name, world_size, rank, backend)
            self._groups[group_name] = g
            return g

    def get_group(self, group_name: str) -> Optional[_GroupHandle]:
        return self._groups.get(group_name)

    def destroy_group(self, group_name: str) -> None:
        with self._lock:
            self._groups.pop(group_name, None)


_group_mgr = GroupManager()


def object_store_available() -> bool:
    """The only backend; analog of reference nccl_available()/gloo_available()."""
    return True


def is_group_initialized(group_name: str = "default") -> bool:
    return _group_mgr.get_group(group_name) is not None


def init_collective_group(world_size: int, rank: int,
                          backend: str = "object_store",
                          group_name: str = "default") -> None:
    """Join this process/actor to a collective group (reference :120).

    Rank 0 creates the rendezvous actor; everyone else looks it up and
    joins.  Blocks until all ``world_size`` members have joined.
    """
    if backend != "object_store":
        raise ValueError(f"unknown backend {backend!r}; the out-of-band "
                         f"backend is 'object_store'")
    if not (0 <= rank < world_size):
        raise ValueError(f"rank {rank} out of range for world {world_size}")
    name = _rendezvous_name(group_name)
    if rank == 0:
        Rendezvous = ray_tpu_torch.remote(_Rendezvous)
        Rendezvous.options(name=name, lifetime="detached").remote(world_size)
    # everyone (incl. rank 0) waits for the actor to be resolvable
    deadline = time.monotonic() + 60.0
    actor = None
    while time.monotonic() < deadline:
        try:
            actor = ray_tpu_torch.get_actor(name)
            break
        except ValueError:
            time.sleep(0.02)
    if actor is None:
        raise RayTpuError(f"collective rendezvous {name!r} did not appear")
    my_actor_id = None
    try:
        my_actor_id = ray_tpu_torch.get_runtime_context().get_actor_id()
    except Exception:  # noqa: BLE001 — driver-side member: no actor id
        pass
    ws = ray_tpu_torch.get(actor.join.remote(rank, my_actor_id))
    if ws != world_size:
        raise RayTpuError(f"world_size mismatch: group has {ws}, got {world_size}")
    g = _group_mgr.create_group(group_name, world_size, rank, backend)
    # barrier so no rank races ahead before the group is fully formed
    while not ray_tpu_torch.get(actor.ready.remote()):
        time.sleep(0.02)
    return None


def create_collective_group(actors: Sequence, world_size: int,
                            ranks: Sequence[int],
                            backend: str = "object_store",
                            group_name: str = "default") -> None:
    """Declaratively form a group across actor handles (reference :151).

    Each actor must expose ``init_collective_group`` via a method or be a
    plain actor — we invoke the module-level init inside each actor via a
    generic ``__ray_call__``-style helper: here we require the actors to
    have been written to call :func:`init_collective_group` themselves via
    an ``init_collective_group(world_size, rank, backend, group_name)``
    method; this helper fans those calls out and waits.
    """
    if len(actors) != len(ranks):
        raise ValueError("actors and ranks length mismatch")
    refs = [a.init_collective_group.remote(world_size, r, backend, group_name)
            for a, r in zip(actors, ranks)]
    ray_tpu_torch.get(refs)


def destroy_collective_group(group_name: str = "default") -> None:
    g = _group_mgr.get_group(group_name)
    if g is None:
        return
    _group_mgr.destroy_group(group_name)
    if g.rank == 0:
        try:
            ray_tpu_torch.kill(g.rendezvous)
        except Exception:
            pass


def get_rank(group_name: str = "default") -> int:
    g = _group_mgr.get_group(group_name)
    return g.rank if g is not None else -1


def get_collective_group_size(group_name: str = "default") -> int:
    g = _group_mgr.get_group(group_name)
    return g.world_size if g is not None else -1


def _check_and_get_group(group_name: str) -> _GroupHandle:
    g = _group_mgr.get_group(group_name)
    if g is None:
        raise RayTpuError(
            f"collective group {group_name!r} is not initialized in this "
            f"process; call init_collective_group() first")
    return g


def _is_tensor(x) -> bool:
    # torch is imported only where a caller already has it
    torch = sys.modules.get("torch")
    return torch is not None and isinstance(x, torch.Tensor)


def _to_numpy(tensor) -> np.ndarray:
    """The value on the host: a torch tensor (on the card too) in one
    copy, anything else through ``np.asarray``."""
    if _is_tensor(tensor):
        return tensor.detach().cpu().numpy()
    return np.asarray(tensor)


def _return_like(tensor, result: np.ndarray):
    """Write in place when possible (reference mutates tensors): into a
    torch tensor of the result's shape (one copy to its device) or a
    writeable ndarray; else return the result."""
    if _is_tensor(tensor) and tuple(tensor.shape) == result.shape:
        import torch

        with torch.no_grad():
            tensor.copy_(torch.from_numpy(np.ascontiguousarray(result)))
        return tensor
    if isinstance(tensor, np.ndarray) and tensor.flags.writeable \
            and tensor.shape == result.shape:
        tensor[...] = result
        return tensor
    return result


#: group-wide op deadline (seconds); aligned with NCCL's communicator
#: watchdog role — a rank that never shows up must fail the op
#: everywhere, not hang it
DEFAULT_COLLECTIVE_TIMEOUT_S = 300.0


def _exchange(g: _GroupHandle, kind: str, payload_ref,
              poll_s: float = 0.002,
              timeout_s: Optional[float] = None) -> Dict[int, Any]:
    """Post this rank's ref and spin until every rank's ref arrived.

    Refs are nested one level deep (in a list) so the runtime passes them
    by reference instead of resolving them to values at the rendezvous
    (top-level ObjectRef args are resolved before execution — reference
    semantics).

    Raises :class:`CollectiveError` when the rendezvous reports the
    group broken (a member died) or the op deadline passes."""
    seq = g.next_seq()
    key = (kind, seq)
    deadline = time.monotonic() + (
        timeout_s if timeout_s is not None else DEFAULT_COLLECTIVE_TIMEOUT_S)
    wrapped = [payload_ref] if payload_ref is not None else []
    ray_tpu_torch.get(g.rendezvous.post.remote(key, g.rank, wrapped))
    while True:
        try:
            box = ray_tpu_torch.get(
                g.rendezvous.collect.remote(key, g.world_size, g.rank),
                timeout=30)
        except GetTimeoutError:
            # slow-but-alive rendezvous (stalled GCS health probe, host
            # overload): NOT a death signal — keep polling until the op
            # deadline; aborting here would desynchronize ranks that
            # already posted from ones that hadn't
            if time.monotonic() > deadline:
                raise CollectiveError(
                    f"{kind} on group {g.group_name!r} timed out after "
                    f"{timeout_s or DEFAULT_COLLECTIVE_TIMEOUT_S:.0f}s "
                    f"(rendezvous unresponsive)")
            continue
        except RayTpuError as e:
            # the rendezvous actor itself died (e.g. its node was lost)
            raise CollectiveError(
                f"{kind} on group {g.group_name!r} failed: rendezvous "
                f"unreachable ({type(e).__name__})") from e
        if box is not None:
            broken = box.get("__broken__")
            if broken:
                raise CollectiveError(
                    f"{kind} on group {g.group_name!r} aborted: {broken}")
            return box
        if time.monotonic() > deadline:
            raise CollectiveError(
                f"{kind} on group {g.group_name!r} timed out after "
                f"{timeout_s or DEFAULT_COLLECTIVE_TIMEOUT_S:.0f}s "
                f"waiting for all {g.world_size} ranks")
        time.sleep(poll_s)


def allreduce(tensor, group_name: str = "default", op: str = ReduceOp.SUM,
              timeout_s: Optional[float] = None):
    """All-gather refs then reduce locally (reference :258).

    Data path: N-1 object-plane fetches per rank; the rendezvous actor
    only moves refs.  Across cards inside one program use
    ``torch.distributed`` instead.
    """
    g = _check_and_get_group(group_name)
    ref = ray_tpu_torch.put(_to_numpy(tensor))
    box = _exchange(g, "allreduce", ref, timeout_s=timeout_s)
    arrs = [ray_tpu_torch.get(box[r][0]) for r in range(g.world_size)]
    return _return_like(tensor, _REDUCERS[op](arrs))


def reduce(tensor, dst_rank: int = 0, group_name: str = "default",
           op: str = ReduceOp.SUM, timeout_s: Optional[float] = None):
    """Reduce to one rank (reference :311). Non-destination ranks return
    their input unchanged."""
    g = _check_and_get_group(group_name)
    ref = ray_tpu_torch.put(_to_numpy(tensor))
    box = _exchange(g, "reduce", ref, timeout_s=timeout_s)
    if g.rank != dst_rank:
        return tensor
    arrs = [ray_tpu_torch.get(box[r][0]) for r in range(g.world_size)]
    return _return_like(tensor, _REDUCERS[op](arrs))


def broadcast(tensor, src_rank: int = 0, group_name: str = "default",
              timeout_s: Optional[float] = None):
    """Broadcast src's tensor to all ranks (reference :373)."""
    g = _check_and_get_group(group_name)
    ref = ray_tpu_torch.put(_to_numpy(tensor)) if g.rank == src_rank else None
    box = _exchange(g, "broadcast", ref, timeout_s=timeout_s)
    src_ref = box[src_rank][0]
    return _return_like(tensor, ray_tpu_torch.get(src_ref))


def allgather(tensor_list: List, tensor, group_name: str = "default",
              timeout_s: Optional[float] = None):
    """Gather every rank's tensor into tensor_list on all ranks (:423)."""
    g = _check_and_get_group(group_name)
    ref = ray_tpu_torch.put(_to_numpy(tensor))
    box = _exchange(g, "allgather", ref, timeout_s=timeout_s)
    out = [ray_tpu_torch.get(box[r][0]) for r in range(g.world_size)]
    if tensor_list is not None:
        del tensor_list[:]
        tensor_list.extend(out)
    return out


def reducescatter(tensor, tensor_list: List, group_name: str = "default",
                  op: str = ReduceOp.SUM,
                  timeout_s: Optional[float] = None):
    """Each rank ends with the reduction of stripe ``rank`` (:472).

    Bandwidth-optimal striping: every rank posts per-stripe chunks as
    separate objects; rank r fetches only chunk r from each peer.
    """
    g = _check_and_get_group(group_name)
    if len(tensor_list) != g.world_size:
        raise ValueError("tensor_list must have world_size input shards")
    chunk_refs = [ray_tpu_torch.put(_to_numpy(t)) for t in tensor_list]
    box = _exchange(g, "reducescatter", chunk_refs, timeout_s=timeout_s)
    mine = [ray_tpu_torch.get(box[r][0][g.rank]) for r in range(g.world_size)]
    return _return_like(tensor, _REDUCERS[op](mine))


def barrier(group_name: str = "default",
            timeout_s: Optional[float] = None) -> None:
    """Block until every rank reaches the barrier (reference :298)."""
    g = _check_and_get_group(group_name)
    _exchange(g, "barrier", None, timeout_s=timeout_s)


def send(tensor, dst_rank: int, group_name: str = "default") -> None:
    """Point-to-point send (reference :531); pairwise FIFO ordering."""
    g = _check_and_get_group(group_name)
    if dst_rank == g.rank:
        raise ValueError("cannot send to self")
    seq = g.next_p2p_seq(g.rank, dst_rank)
    key = ("p2p", g.rank, dst_rank, seq)
    ref = ray_tpu_torch.put(_to_numpy(tensor))
    ray_tpu_torch.get(g.rendezvous.post.remote(key, g.rank, [ref]))


def recv(tensor, src_rank: int, group_name: str = "default",
         timeout_s: Optional[float] = None):
    """Point-to-point receive matching :func:`send` (reference :594)."""
    g = _check_and_get_group(group_name)
    if src_rank == g.rank:
        raise ValueError("cannot recv from self")
    seq = g.next_p2p_seq(src_rank, g.rank)
    key = ("p2p", src_rank, g.rank, seq)
    deadline = time.monotonic() + (
        timeout_s if timeout_s is not None
        else DEFAULT_COLLECTIVE_TIMEOUT_S)
    while True:
        got = ray_tpu_torch.get(g.rendezvous.take_p2p.remote(key, g.rank))
        if got is not None:
            src, wrapped = got
            if src == "__broken__":
                raise CollectiveError(
                    f"recv on group {g.group_name!r} aborted: {wrapped}")
            return _return_like(tensor, ray_tpu_torch.get(wrapped[0]))
        if time.monotonic() > deadline:
            raise CollectiveError(
                f"recv(src={src_rank}) on group {g.group_name!r} "
                f"timed out")
        time.sleep(0.002)
