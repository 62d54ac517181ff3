"""Gang-scheduled sharded replicas: one serve replica = N shard workers.

A deployment with ``num_shards > 1`` no longer maps a replica onto one
actor but onto a **gang**: rank 0 is an ordinary :class:`ServeReplica`
(it fronts the router, owns the continuous batcher and the KV page
table) and ranks 1..N-1 are :class:`ShardGangWorker` actors, each
holding one tensor-parallel shard of the model (the engine's
``shard_step``/``combine`` gang protocol; ``toy_decoder.ToyDecoderShard``
is the reference).  The controller creates every member of the gang
before waiting on any of them, so a gang's bring-up rides ONE batched
registration + one pipelined bring-up wave on the control plane,
and members are placed with SPREAD so shards land on distinct nodes
when the cluster has them.

Decode data path (per step): rank 0 puts the step inputs once and
passes the ref to every shard — the object-transfer plane turns the
1->N fan-out into a broadcast, and concurrent pullers chain off each
other instead of hammering rank 0.  Rank 0 computes its own slice
while the remote slices are in flight, then gathers and combines.

All-or-nothing fault model: any shard death kills the WHOLE gang.
Rank 0 exits the moment a fan-out sees ``ActorDiedError`` (or its
background monitor does, for idle gangs); the router observes a dead
replica, retries in-flight requests against surviving replicas, and
the controller reaps the remaining members and respawns a fresh gang.
KV pages owned by the dead rank 0 are freed by owner-death cleanup —
no leak.

Chaos hook: the ``serve.shard.step_fail`` failpoint sits in
``shard_step`` so a test can SIGKILL exactly one shard mid-request
(``make chaos`` does; zero client requests may fail).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.core import device_telemetry as _dt
from ray_tpu_torch.core import telemetry as _tm
from ray_tpu_torch.core.exceptions import ActorDiedError, WorkerCrashedError
from ray_tpu_torch.util import failpoint as _fp

logger = logging.getLogger(__name__)

__all__ = ["ShardGangWorker", "ShardedEngine", "GangShardDied"]


class GangShardDied(Exception):
    """A gang member died; the whole gang is going down with it."""


def _build_engine(pickled_callable: bytes, init_args: tuple,
                  init_kwargs: dict, rank: int, world: int) -> Any:
    """Instantiate one rank's engine shard.  The sharded-engine
    protocol: the deployment target accepts ``rank``/``world`` kwargs
    and exposes ``shard_step`` (every rank) + ``combine`` (rank 0)."""
    target = cloudpickle.loads(pickled_callable)
    if not isinstance(target, type):
        raise TypeError("num_shards > 1 requires a class deployment "
                        "implementing the sharded-engine protocol")
    return target(*init_args, **{**init_kwargs,
                                 "rank": rank, "world": world})


@ray_tpu_torch.remote
class ShardGangWorker:
    """Rank >= 1 of a gang: holds one model shard, answers
    ``shard_step`` fan-outs from rank 0."""

    def __init__(self, pickled_callable: bytes, init_args: tuple,
                 init_kwargs: dict, rank: int, world: int,
                 deployment: str = ""):
        self._deployment = deployment
        self.rank = rank
        self.world = world
        self._engine = _build_engine(pickled_callable, init_args,
                                     init_kwargs, rank, world)

    def shard_step(self, step_inputs) -> Any:
        """One decode step's slice.  ``step_inputs`` arrives as an
        ObjectRef argument (resolved by the worker — the broadcast
        path), carrying ``(tokens, lengths, active)``."""
        _fp.failpoint("serve.shard.step_fail")
        # straggler injection: arm with action=delay on ONE rank (via
        # this shard's arm_failpoint) to slow exactly that rank's steps
        _fp.failpoint("device.step.slow_rank")
        tokens, lengths, active = step_inputs
        return self._engine.shard_step(tokens, lengths, active)

    @ray_tpu_torch.method(concurrency_group="control")
    def ping(self) -> int:
        return self.rank

    @ray_tpu_torch.method(concurrency_group="control")
    def ready(self) -> bool:
        return True

    @ray_tpu_torch.method(concurrency_group="control")
    def node_id(self) -> Optional[str]:
        try:
            return ray_tpu_torch.get_runtime_context().get_node_id()
        except Exception:  # noqa: BLE001 — placement introspection only
            return None

    @ray_tpu_torch.method(concurrency_group="control")
    def arm_failpoint(self, name: str, action: str = "raise",
                      **options) -> bool:
        """Arm a failpoint in THIS shard only (chaos tooling)."""
        _fp.arm(name, action, **options)
        return True


class ShardedEngine:
    """Rank 0's engine wrapper: presents the ordinary continuous-
    batching engine protocol to the batcher while fanning each step
    out over the gang.

    ``begin_request``/``finish_request``/``prefill``/``kv_page_payload``
    and the token attributes delegate to the local rank-0 shard; only
    ``step`` is distributed.
    """

    #: seconds between background liveness sweeps over the gang (an
    #: idle gang must still honor all-or-nothing: a dead shard kills
    #: rank 0 even with no request in flight)
    _MONITOR_PERIOD_S = 1.0

    def __init__(self, pickled_callable: bytes, init_args: tuple,
                 init_kwargs: dict, num_shards: int, deployment: str = ""):
        self._deployment = deployment
        self.num_shards = int(num_shards)
        self._local = _build_engine(pickled_callable, init_args,
                                    init_kwargs, 0, self.num_shards)
        self._shards: List[Any] = []       # rank-ordered, ranks 1..N-1
        self._attached = threading.Event()
        self._stop = threading.Event()
        self._steps = 0
        # straggler detection: rank 0 records every rank's duration per
        # step (its own slice's compute; each remote rank's submit-to-
        # arrival) — skew + argmax rank ride gang_stats() to the
        # controller, which publishes ray_tpu_gang_rank_skew_seconds
        self._skew = _dt.RankSkewWindow(self.num_shards)
        #: trace-annotation throttle: spans only when the straggling
        #: rank changes or skew first crosses the warn threshold
        self._last_straggler: Optional[int] = None

    # -- delegation to the rank-0 shard ------------------------------------
    @property
    def eos_token(self):
        return getattr(self._local, "eos_token", None)

    @property
    def pad_token(self):
        return getattr(self._local, "pad_token", 0)

    def begin_request(self, payload: Any) -> Dict[str, Any]:
        return self._local.begin_request(payload)

    def finish_request(self, state: Dict[str, Any]) -> Any:
        return self._local.finish_request(state)

    def __getattr__(self, name: str):
        # optional protocol hooks (prefill, kv_page_payload, ...) come
        # from the local shard; missing ones stay missing so hasattr
        # checks in the batcher behave as for a plain engine
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._local, name)

    # -- gang lifecycle ----------------------------------------------------
    def attach(self, shard_handles: List[Any]) -> bool:
        """Controller hands over the rank 1..N-1 actor handles once the
        whole gang reported ready (all-or-nothing bring-up)."""
        if len(shard_handles) != self.num_shards - 1:
            raise ValueError(
                f"gang of {self.num_shards} needs {self.num_shards - 1} "
                f"shard workers, got {len(shard_handles)}")
        self._shards = list(shard_handles)
        self._attached.set()
        if self._shards:
            threading.Thread(target=self._monitor,
                             name="rtpu-gang-monitor", daemon=True).start()
        return True

    def shard_ids(self) -> List[bytes]:
        return [h.actor_id.binary() for h in self._shards]

    def stop(self) -> None:
        self._stop.set()

    def _gang_suicide(self, why: str) -> None:
        """All-or-nothing: take rank 0 (and with it the whole replica)
        down NOW.  The router sees an ActorDiedError and retries the
        in-flight requests elsewhere; the controller reaps the gang and
        respawns it."""
        logger.error("gang member died (%s): killing rank 0 of %s",
                     why, self._deployment or "<deployment>")
        os._exit(1)

    def _monitor(self) -> None:
        """Liveness sweep so an IDLE gang still honors all-or-nothing
        (a busy gang discovers death faster, on the step fan-out)."""
        while not self._stop.wait(self._MONITOR_PERIOD_S):
            try:
                refs = [h.ping.remote() for h in self._shards]
                ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                        timeout=10.0)
                for ref in ready:
                    ray_tpu_torch.get(ref, timeout=5.0)
            except (ActorDiedError, WorkerCrashedError) as e:
                if not self._stop.is_set():
                    self._gang_suicide(f"monitor: {type(e).__name__}")
            except Exception:  # noqa: BLE001 — transient (teardown,
                pass  # slow node): the next sweep or fan-out decides

    #: step inputs at or above this many bytes broadcast as ONE arena
    #: object (each shard pulls the same ref — the object-transfer plane
    #: turns the 1->N fan-out into a broadcast tree); smaller inputs
    #: inline straight into the task specs, skipping the put + resolve
    #: round trip that would dominate a small-batch step
    _BROADCAST_MIN_BYTES = 64 * 1024

    def _step_payload(self, tokens, lengths, active):
        try:
            nbytes = (tokens.nbytes + lengths.nbytes + active.nbytes)
        except AttributeError:
            nbytes = self._BROADCAST_MIN_BYTES
        payload = (tokens, lengths, active)
        if nbytes >= self._BROADCAST_MIN_BYTES:
            return ray_tpu_torch.put(payload)
        return payload

    # -- the distributed step ----------------------------------------------
    def step(self, tokens, lengths, active):
        """One decode step over the gang: broadcast inputs (by ref for
        large batches, inline for small ones), run the local slice
        while remote slices compute, gather, combine."""
        if not self._attached.is_set():
            # bring-up race: the controller routes only after attach,
            # but a direct handle could beat it — wait briefly
            if not self._attached.wait(timeout=30.0):
                raise RuntimeError("gang shards never attached")
        payload = self._step_payload(tokens, lengths, active)
        durations: Dict[int, float] = {}
        try:
            submit = time.time()
            remote = [h.shard_step.remote(payload)
                      for h in self._shards]
            t0 = time.time()
            # rank 0's slice runs under the same LOGICAL site as the
            # remote ranks' shard_step (arming is per-process: a gang
            # member arms exactly one of the two, never both)
            _fp.failpoint("device.step.slow_rank")  # rtpu-check: disable=failpoint-registry
            local = self._local.shard_step(tokens, lengths, active)
            durations[0] = time.time() - t0
            # incremental gather: each remote rank's duration is its
            # submit-to-arrival wall time (compute + queue + transfer —
            # exactly what rank 0 waits on, which is what skew means)
            pending = {ref: rank + 1 for rank, ref in enumerate(remote)}
            parts_by_rank: Dict[int, Any] = {0: local}
            deadline = submit + 60.0
            while pending:
                ready, _ = ray_tpu_torch.wait(
                    list(pending), num_returns=1,
                    timeout=max(0.0, deadline - time.time()))
                if not ready:
                    raise TimeoutError("gang step gather timed out")
                ref = ready[0]
                rank = pending.pop(ref)
                parts_by_rank[rank] = ray_tpu_torch.get(ref, timeout=5.0)
                durations[rank] = time.time() - submit
            parts = [parts_by_rank[r] for r in range(self.num_shards)]
        except (ActorDiedError, WorkerCrashedError) as e:
            self._gang_suicide(f"step: {type(e).__name__}")
            raise  # unreachable (suicide) — keeps control flow explicit
        self._steps += 1
        self._record_skew(durations)
        return self._local.combine(parts, active)

    #: skew above this much of a step's slowest rank is worth a trace
    #: span (the alert threshold lives in metrics_history; this only
    #: gates trace-tree annotation so healthy gangs stay span-free)
    _SKEW_SPAN_MIN_S = 0.05

    def _record_skew(self, durations: Dict[int, float]) -> None:
        self._skew.record(durations)
        snap = self._skew.snapshot()
        straggler = snap["straggler"]
        if (snap["skew_s"] >= self._SKEW_SPAN_MIN_S
                and straggler is not None
                and straggler != self._last_straggler):
            # annotate the trace tree once per straggler change, with a
            # span covering the straggling rank's portion of this step
            now = time.time()
            _tm.record_span(
                "gang", "straggler", now - snap["skew_s"], now,
                deployment=self._deployment, rank=straggler,
                skew_s=round(snap["skew_s"], 6))
        self._last_straggler = straggler

    def gang_stats(self) -> Dict[str, Any]:
        snap = self._skew.snapshot()
        return {"num_shards": self.num_shards,
                "gang_steps": self._steps,
                "attached": self._attached.is_set(),
                "rank_step_s": snap["rank_step_s"],
                "rank_skew_s": snap["skew_s"],
                "straggler_rank": snap["straggler"]}
