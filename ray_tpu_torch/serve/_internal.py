"""Serve control/data plane actors.

Parity: reference ``python/ray/serve/`` —
- ``ServeController`` (controller.py:61): single-writer reconciliation of
  deployment state onto replica actors, rolling updates, autoscaling,
  long-poll config push (``_private/long_poll.py``).
- ``RayServeReplica`` (``_private/replica.py:250``): wraps the user
  callable, tracks queue depth for backpressure/autoscaling.
- ``Router``/``ReplicaSet`` (``_private/router.py:261,:134``): power-of-two
  choices over replica queue depths, skipping those at
  ``max_concurrent_queries``.

Accelerator twist: a deployment keeps its model warm on the device in
the replica process, and a deployment configured with ``batching=...``
runs a **continuous-batching decode loop** (serve/batching.py): requests
join an in-flight autoregressive batch at step boundaries with
padding-bucketed shapes, so the step sees one shape per bucket and the
device never idles between requests.

Autoscaling is SLO-aware: replicas export queue depth / batch occupancy
/ latency percentiles; the controller polls them **in parallel with one
bounded wait** per reconcile tick (a slow replica cannot stall the
loop), feeds the ``ray_tpu_serve_*`` telemetry series, and moves the
target replica count with scale-up/down hysteresis so transient spikes
don't thrash replica churn.
"""

from __future__ import annotations

import json
import logging
import random
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.core import telemetry as _tm
from ray_tpu_torch.core import tracing as _trace
from ray_tpu_torch.core.exceptions import ActorDiedError
from ray_tpu_torch.util import failpoint as _fp

logger = logging.getLogger(__name__)

CONTROLLER_NAME = "SERVE_CONTROLLER"


def _serve_knob(name: str, default):
    try:
        from ray_tpu_torch.core.config import get_config
        return getattr(get_config(), name, default)
    except Exception:  # noqa: BLE001 — config unavailable (unit tests)
        return default


@dataclass
class DeploymentConfig:
    num_replicas: int = 1
    max_concurrent_queries: int = 100
    user_config: Any = None
    ray_actor_options: Dict[str, Any] = field(default_factory=dict)
    autoscaling_config: Optional[Dict[str, Any]] = None
    version: int = 0
    #: grace period for draining in-flight requests before a replaced or
    #: scaled-down replica is killed (reference graceful_shutdown_*)
    graceful_shutdown_timeout_s: float = 10.0
    #: continuous-batching knobs (serve/batching.py BatchingConfig as a
    #: plain dict); None = request-at-a-time dispatch
    batching: Optional[Dict[str, Any]] = None
    #: per-deployment ingress backlog cap (queued + in flight at the
    #: proxy); -1 = the global ``serve_proxy_queue_limit`` knob,
    #: 0 = unbounded (shedding off)
    max_queued_requests: int = -1
    #: shards per replica: > 1 turns each replica into a GANG (rank 0 =
    #: the routed ServeReplica, ranks 1..N-1 = ShardGangWorker actors
    #: running the model via the sharded-engine protocol; see
    #: serve/sharded.py).  Created all-or-nothing in one registration
    #: batch, killed all-or-nothing on any member death.
    num_shards: int = 1
    #: prefill/decode disaggregation: > 0 adds that many PREFILL
    #: replicas (an internal ``<name>--prefill`` deployment); the router
    #: sends each request's prompt pass there first, and the prefill
    #: replica streams finished KV pages to the decode replica as
    #: object refs over the transfer plane.
    prefill_replicas: int = 0
    #: internal role marker ("" = decode/unified, "prefill" = the
    #: prompt-pass tier of a disaggregated deployment)
    role: str = ""
    #: model multiplexing (serve/multiplex.py): map of model id ->
    #: engine init-kwarg overrides; each replica hosts ALL listed
    #: models behind one batcher, swapping weights by arena ref on
    #: demand.  The first model is the default; requests pick theirs
    #: with a ``"model"`` payload field.  None = off.
    multiplexed_models: Optional[Dict[str, Any]] = None
    #: LRU bound on models resident per replica (0 = all resident);
    #: an evicted model's weights stay sealed in the arena and reload
    #: by ref on the next request.
    multiplex_max_resident: int = 0


@ray_tpu_torch.remote
class ServeReplica:
    """One replica actor (parity: RayServeReplica replica.py:250)."""

    def __init__(self, pickled_callable: bytes, init_args: tuple,
                 init_kwargs: dict, user_config: Any = None,
                 deployment_name: str = "",
                 batching: Optional[Dict[str, Any]] = None,
                 num_shards: int = 1,
                 prefill_cfg: Optional[Dict[str, Any]] = None,
                 multiplexed: Optional[Dict[str, Any]] = None,
                 multiplex_max_resident: int = 0):
        if num_shards > 1:
            # rank 0 of a gang: the engine wrapper fans each decode
            # step out over the shard workers the controller attaches
            from ray_tpu_torch.serve.sharded import ShardedEngine
            self._callable = ShardedEngine(
                pickled_callable, init_args, init_kwargs, num_shards,
                deployment_name)
        elif multiplexed:
            # N models behind one batcher, swapped by arena ref
            from ray_tpu_torch.serve.multiplex import MultiplexEngine
            self._callable = MultiplexEngine(
                cloudpickle.loads(pickled_callable), init_args,
                init_kwargs, multiplexed, multiplex_max_resident,
                deployment_name)
        else:
            target = cloudpickle.loads(pickled_callable)
            if isinstance(target, type):
                self._callable = target(*init_args, **init_kwargs)
            else:
                self._callable = target
        self._deployment = deployment_name
        self._inflight = 0
        self._total = 0
        self._shed = 0
        self._lat_ms: List[float] = []
        self._lock = threading.Lock()
        self._batcher = None
        if batching is not None:
            from ray_tpu_torch.serve.batching import (BatchingConfig,
                                                ContinuousBatcher)
            self._batcher = ContinuousBatcher(
                self._callable, BatchingConfig.from_dict(batching),
                deployment_name)
        # prefill tier: no decode loop — the prompt pass runs on the
        # handler thread and finished pages export as refs
        self._prefill_cfg = prefill_cfg
        self._prefill_table = None
        self._prefill_seq = 0
        if user_config is not None:
            self.reconfigure(user_config)

    @ray_tpu_torch.method(concurrency_group="control")
    def reconfigure(self, user_config: Any) -> bool:
        fn = getattr(self._callable, "reconfigure", None)
        if fn is not None:
            fn(user_config)
        return True

    def handle_request(self, method_name: str, args: tuple, kwargs: dict,
                       deadline_s: Optional[float] = None,
                       request_id: Optional[str] = None,
                       stream: bool = False):
        _fp.failpoint("serve.replica.handle_request")
        t0 = time.monotonic()
        # ambient trace context was activated by the executor from the
        # task spec; the batcher parents its queue/decode spans on it
        tctx = _trace.current()
        with self._lock:
            self._inflight += 1
            self._total += 1
        try:
            if self._batcher is not None \
                    and method_name in ("", "__call__", "__decode__"):
                from ray_tpu_torch.serve.batching import ReplicaOverloaded
                payload = args[0] if args else kwargs.get("payload")
                prefilled = None
                if method_name == "__decode__":
                    # disaggregated decode: the payload is a prefill
                    # replica's export (possibly still a ref) — pull
                    # the KV pages over the transfer plane HERE, on
                    # the handler thread, never on the decode loop
                    prefilled = self._resolve_prefilled(payload)
                    payload = None
                try:
                    result = self._batcher(payload, deadline_s=deadline_s,
                                           request_id=request_id,
                                           stream=stream,
                                           prefilled=prefilled)
                except ReplicaOverloaded:
                    with self._lock:
                        self._shed += 1
                    _tm.serve_request_shed(self._deployment, "replica")
                    raise
            elif method_name == "__prefill__":
                result = self._do_prefill(
                    args[0] if args else kwargs.get("payload"),
                    request_id)
            else:
                target = self._callable
                if method_name and method_name != "__call__":
                    target = getattr(self._callable, method_name)
                result = target(*args, **kwargs)
            elapsed = time.monotonic() - t0
            # exemplar: a traced request links its latency bucket to the
            # concrete trace_id (dashboard p99 spike -> ray-tpu trace)
            _tm.serve_request_observed(
                self._deployment, elapsed,
                trace_id=tctx.get("trace_id") if tctx else None)
            # only SERVED requests enter the latency ring: microsecond
            # shed/error exits would drown the p99 exactly when the
            # replica is overloaded and the signal matters most
            with self._lock:
                self._lat_ms.append(elapsed * 1e3)
                if len(self._lat_ms) > 512:
                    del self._lat_ms[:-512]
            return result
        finally:
            with self._lock:
                self._inflight -= 1

    # -- prefill/decode disaggregation ---------------------------------
    def _kv_prefill_table(self):
        if self._prefill_table is None:
            from ray_tpu_torch.serve.kv_cache import KVPageTable
            cfg = self._prefill_cfg or {}
            self._prefill_table = KVPageTable(
                int(cfg.get("kv_page_tokens") or 16),
                int(cfg.get("kv_max_pages") or 0),
                self._deployment,
                kv_payload=getattr(self._callable, "kv_page_payload",
                                   None))
        return self._prefill_table

    def _do_prefill(self, payload: Any,
                    request_id: Optional[str]) -> Dict[str, Any]:
        """The prompt pass on a prefill replica: parse, run the
        engine's prefill, seal finished KV pages into the arena, and
        export the page REFS (plus decode metadata) — the decode gang
        adopts the pages without re-prefilling."""
        engine = self._callable
        state = engine.begin_request(payload)
        state.setdefault("max_new_tokens", 16)
        prefill = getattr(engine, "prefill", None)
        if prefill is not None:
            state = prefill(state) or state
        table = self._kv_prefill_table()
        with self._lock:
            self._prefill_seq += 1
            rid = request_id or f"prefill-{self._prefill_seq}"
            rid = f"{rid}#{self._prefill_seq}"  # retries never collide
        table.begin(rid, list(state.get("tokens") or [0]))
        export = table.handoff(rid)
        export["meta"] = {
            k: state[k] for k in ("prompt_len", "max_new_tokens")
            if k in state}
        return export

    @staticmethod
    def _resolve_prefilled(payload: Any) -> Dict[str, Any]:
        from ray_tpu_torch.core.exceptions import (ActorDiedError,
                                             ObjectLostError,
                                             WorkerCrashedError)
        from ray_tpu_torch.core.object_ref import ObjectRef
        from ray_tpu_torch.serve.batching import RequestPrefillLost
        from ray_tpu_torch.serve.kv_cache import resolve_export

        try:
            if isinstance(payload, ObjectRef):
                payload = ray_tpu_torch.get(payload, timeout=60)
            tokens = resolve_export(payload)
        except (ActorDiedError, WorkerCrashedError,
                ObjectLostError) as e:
            # the PREFILL tier died under us; surface a typed,
            # retryable error so the router re-runs the prompt pass —
            # this decode replica is healthy and must not be marked
            # dead for the prefill tier's failure
            raise RequestPrefillLost(str(e)) from e
        return {"export": payload, "tokens": tokens,
                "meta": payload.get("meta") or {}}

    def warm_up(self, dataset: Any, batch_size: int = 32,
                method: str = "__call__", max_batches: int = 0) -> int:
        """Feed a warmup/eval corpus through this replica via the
        STREAMING data plane: ``iter_batches(streaming=True)`` admits
        reads lazily inside the bounded in-flight window, so a corpus
        larger than the arena never materializes into it.  The deployment may define ``warmup_batch(batch)``
        to control what one batch exercises; otherwise each batch is
        passed to the handler as a payload.  Returns batches consumed."""
        engine = self._callable
        fn = getattr(engine, "warmup_batch", None)
        n = 0
        for batch in dataset.iter_batches(batch_size=batch_size,
                                          streaming=True):
            if fn is not None:
                fn(batch)
            elif method and method != "__call__":
                getattr(engine, method)(batch)
            else:
                engine(batch)
            n += 1
            if max_batches and n >= max_batches:
                break
        return n

    @ray_tpu_torch.method(concurrency_group="control")
    def attach_shards(self, shard_handles: List[Any]) -> bool:
        """Hand the gang's rank 1..N-1 actor handles to the sharded
        engine (controller-side, after all-or-nothing readiness)."""
        return self._callable.attach(shard_handles)

    @ray_tpu_torch.method(concurrency_group="control")
    def cancel_request(self, request_id: str) -> bool:
        """Free the request's batch slot (client disconnected): the
        pending/active request errors with RequestCancelled and its
        handler thread returns."""
        if self._batcher is None or not request_id:
            return False
        return self._batcher.cancel(request_id)

    @ray_tpu_torch.method(concurrency_group="control")
    def metrics(self) -> Dict[str, Any]:
        with self._lock:
            lat = sorted(self._lat_ms)
            out = {
                "inflight": self._inflight,
                "total": self._total,
                "shed_total": self._shed,
                "queue_depth": 0,
                "batch_occupancy": 0.0,
                "p99_ms": lat[min(len(lat) - 1, int(len(lat) * 0.99))]
                if lat else 0.0,
            }
        if self._batcher is not None:
            s = self._batcher.stats()
            out["queue_depth"] = s["queue_depth"]
            out["batch_occupancy"] = s["mean_occupancy"]
            # NOT += s["shed_total"]: every batcher shed already bumped
            # self._shed in handle_request (it would double-count)
            out["batch_steps"] = s["steps"]
            out["step_shapes"] = s["step_shapes"]
            out["step_p50_ms"] = s["step_p50_ms"]
            out["step_p99_ms"] = s["step_p99_ms"]
            # step-boundary slot availability: the router's cross-gang
            # continuous-batching signal (replica_slots in the table)
            out["slots_free"] = s.get("slots_free", 0)
            out["max_batch_size"] = s.get("max_batch_size", 0)
            # paged-KV accounting rides the same poll (controller
            # aggregates into the ray_tpu_serve_kv_* gauges)
            for k, v in s.items():
                if k.startswith("kv_"):
                    out[k] = v
            # device-plane attribution (StepMonitor + compile counts):
            # bench + `ray-tpu top` read these off the replica poll
            for k in ("mfu", "goodput_per_s", "device_frac",
                      "data_wait_frac", "phase_s", "compiles"):
                if k in s:
                    out[k] = s[k]
        mux = getattr(self._callable, "mux_stats", None)
        if mux is not None:
            out.update(mux())
        if self._prefill_table is not None:
            for k, v in self._prefill_table.stats().items():
                out[f"prefill_{k}"] = v
        from ray_tpu_torch.serve.sharded import ShardedEngine
        if isinstance(self._callable, ShardedEngine):
            out.update(self._callable.gang_stats())
        return out

    @ray_tpu_torch.method(concurrency_group="control")
    def arm_failpoint(self, name: str, action: str = "raise",
                      **options) -> bool:
        """Arm a failpoint in THIS replica only (chaos tooling: lets a
        test fault one replica of a set without arming its siblings)."""
        _fp.arm(name, action, **options)
        return True

    @ray_tpu_torch.method(concurrency_group="control")
    def ready(self) -> bool:
        return True

    @ray_tpu_torch.method(concurrency_group="control")
    def node_id(self) -> Optional[str]:
        """Hex node id this replica runs on (locality routing)."""
        try:
            import ray_tpu_torch as _rt
            return _rt.get_runtime_context().get_node_id()
        except Exception:  # noqa: BLE001 — locality is best-effort
            return None


@ray_tpu_torch.remote
class ServeController:
    """Single-writer control loop (parity: controller.py:61)."""

    def __init__(self):
        # name -> {"config", "blob", "init", "replicas": [handles], "version"}
        self._deployments: Dict[str, Dict[str, Any]] = {}
        self._routing_version = 0
        self._routing: Dict[str, List[Any]] = {}  # name -> replica handles
        self._configs: Dict[str, DeploymentConfig] = {}
        self._lock = threading.Lock()
        self._stop = False
        # replicas removed from routing, awaiting drain: (handle, deadline)
        self._draining: List[Tuple[Any, float, float]] = []
        # gang membership: rank0 actor_id -> [ShardGangWorker handles];
        # killed with rank0 (all-or-nothing), respawned as a unit
        self._gangs: Dict[bytes, List[Any]] = {}
        # actor_id -> node hex, for locality-aware routing (reference
        # replica_scheduler's node-locality ranking)
        self._replica_nodes: Dict[bytes, Optional[str]] = {}
        # actor_id -> last metrics dict, refreshed by ONE parallel poll
        # per reconcile tick (never serial per-replica gets)
        self._replica_metrics: Dict[bytes, Dict[str, Any]] = {}
        # name -> autoscaler hysteresis state
        self._scale_state: Dict[str, Dict[str, Any]] = {}
        # last published shaped-capacity request (JSON key, change-gated)
        self._last_capacity_request: Optional[str] = None
        self._thread = threading.Thread(target=self._control_loop, daemon=True)
        self._thread.start()

    # -- API ----------------------------------------------------------
    PREFILL_SUFFIX = "--prefill"

    def deploy(self, name: str, pickled_callable: bytes, init_args: tuple,
               init_kwargs: dict, config: DeploymentConfig) -> int:
        """Returns the assigned version (monotonic per deployment).

        ``prefill_replicas > 0`` also (re)registers the internal
        ``<name>--prefill`` deployment: same engine, no decode loop —
        its replicas run the prompt pass and export KV pages by ref.
        """
        if getattr(config, "multiplexed_models", None):
            if config.num_shards > 1:
                raise ValueError(
                    "multiplexed_models does not combine with gang "
                    "replicas (num_shards > 1) yet")
            if config.prefill_replicas > 0:
                raise ValueError(
                    "multiplexed_models does not combine with "
                    "prefill/decode disaggregation yet")
            if config.batching is None:
                raise ValueError(
                    "multiplexed_models requires a continuous-batching "
                    "deployment (batching=...)")
        if config.prefill_replicas > 0:
            if config.batching is None:
                raise ValueError(
                    "prefill/decode disaggregation requires a "
                    "continuous-batching deployment (batching=...)")
            # disaggregation moves state between replicas, so the KV
            # must be paged; default the page size on if unset
            config.batching = dict(config.batching)
            if not config.batching.get("kv_page_tokens"):
                config.batching["kv_page_tokens"] = 16
        with self._lock:
            prev = self._deployments.get(name)
            config.version = (prev["config"].version + 1) if prev else 0
            self._deployments[name] = {
                "config": config,
                "blob": pickled_callable,
                "init": (init_args, init_kwargs),
                "replicas": prev["replicas"] if prev else [],
                "replica_versions": prev.get("replica_versions", [])
                if prev else [],
            }
        if config.prefill_replicas > 0:
            pconfig = DeploymentConfig(
                num_replicas=config.prefill_replicas,
                max_concurrent_queries=config.max_concurrent_queries,
                ray_actor_options=dict(config.ray_actor_options or {}),
                graceful_shutdown_timeout_s=(
                    config.graceful_shutdown_timeout_s),
                # a model that needs a gang to decode needs one to
                # prefill too: the tier inherits the shard layout
                num_shards=config.num_shards,
                role="prefill")
            self.deploy(name + self.PREFILL_SUFFIX, pickled_callable,
                        init_args, init_kwargs, pconfig)
        elif config.role == "":
            # prefill tier removed on redeploy without disaggregation
            with self._lock:
                had = name + self.PREFILL_SUFFIX in self._deployments
            if had:
                self.delete_deployment(name + self.PREFILL_SUFFIX)
        return config.version

    def _kill_replica(self, replica: Any) -> None:
        """Kill a replica AND its gang members (all-or-nothing)."""
        try:
            ray_tpu_torch.kill(replica)
        except Exception:  # noqa: BLE001
            pass
        members = self._gangs.pop(replica.actor_id.binary(), [])
        for m in members:
            try:
                ray_tpu_torch.kill(m)
            except Exception:  # noqa: BLE001
                pass

    def delete_deployment(self, name: str) -> bool:
        with self._lock:
            dep = self._deployments.pop(name, None)
            self._scale_state.pop(name, None)
            has_prefill = name + self.PREFILL_SUFFIX in self._deployments
        if dep:
            for r in dep["replicas"]:
                self._kill_replica(r)
            self._bump_routing()
        if has_prefill:
            self.delete_deployment(name + self.PREFILL_SUFFIX)
        return True

    def get_routing_table(self, known_version: int = -1,
                          timeout_s: float = 10.0) -> Dict[str, Any]:
        """Long-poll: blocks until the table moves past known_version
        (parity: LongPollHost long_poll.py:185)."""
        deadline = time.monotonic() + timeout_s
        while self._routing_version <= known_version and not self._stop:
            if time.monotonic() > deadline:
                break
            time.sleep(0.02)
        with self._lock:
            table = {}
            for name, replicas in self._routing.items():
                cfg = self._configs.get(name)
                table[name] = {
                    "replicas": list(replicas),
                    "replica_nodes": [
                        self._replica_nodes.get(r.actor_id.binary())
                        for r in replicas],
                    # queue depth + inflight snapshot per replica: the
                    # router's power-of-two-choices signal (staleness
                    # bounded by the reconcile tick, corrected client-
                    # side by the router's own inflight deltas)
                    "replica_depths": [
                        self._depth_of(r.actor_id.binary())
                        for r in replicas],
                    # step-boundary slot availability per replica (None
                    # = not a batched replica / no report yet): the
                    # router steers to gangs with a free slot at the
                    # next boundary — cross-gang continuous batching
                    "replica_slots": [
                        self._slots_of(r.actor_id.binary())
                        for r in replicas],
                    # resident model set per replica (multiplexing):
                    # the router prefers a replica where the request's
                    # model is already swapped in
                    "replica_models": [
                        (self._replica_metrics.get(r.actor_id.binary())
                         or {}).get("mux_resident_models")
                        for r in replicas],
                    "max_concurrent_queries":
                        cfg.max_concurrent_queries if cfg else 100,
                    "max_queued_requests":
                        getattr(cfg, "max_queued_requests", -1)
                        if cfg else -1,
                    "num_shards": getattr(cfg, "num_shards", 1)
                        if cfg else 1,
                    # disaggregation: the router runs the prompt pass
                    # against this deployment first
                    "prefill":
                        (name + self.PREFILL_SUFFIX)
                        if cfg and getattr(cfg, "prefill_replicas", 0) > 0
                        else None,
                }
        return {"version": self._routing_version, "table": table}

    def _depth_of(self, key: bytes) -> int:
        m = self._replica_metrics.get(key)
        if not m:
            return 0
        # max, not sum: on a batched replica every queued request is
        # ALSO a blocked handle_request thread (counted in inflight),
        # so summing would double-count the backlog
        return max(int(m.get("inflight", 0)), int(m.get("queue_depth", 0)))

    def _slots_of(self, key: bytes) -> Optional[int]:
        m = self._replica_metrics.get(key)
        if not m or "slots_free" not in m:
            return None
        return int(m["slots_free"])

    def get_gang_members(self, rank0_actor_id: bytes) -> List[Any]:
        """Shard-worker handles of the gang fronted by ``rank0``
        (introspection/chaos tooling)."""
        return list(self._gangs.get(rank0_actor_id, []))

    def list_deployments(self) -> Dict[str, Dict[str, Any]]:
        def _m(r) -> Dict[str, Any]:
            return self._replica_metrics.get(r.actor_id.binary()) or {}

        with self._lock:
            return {
                name: {"num_replicas": len(dep["replicas"]),
                       "target_replicas": dep["config"].num_replicas,
                       "version": dep["config"].version,
                       "queue_depth": sum(
                           self._depth_of(r.actor_id.binary())
                           for r in dep["replicas"]),
                       # serving-plane health for `ray-tpu status`:
                       # shed rate + worst replica p99 from the same
                       # poll the autoscaler runs on
                       "shed_total": sum(
                           int(_m(r).get("shed_total", 0))
                           for r in dep["replicas"]),
                       "p99_ms": max(
                           [float(_m(r).get("p99_ms", 0.0))
                            for r in dep["replicas"]] or [0.0]),
                       "stale_replicas": sum(
                           1 for v in dep["replica_versions"]
                           if v != dep["config"].version),
                       "num_shards": getattr(dep["config"], "num_shards",
                                             1),
                       "role": getattr(dep["config"], "role", ""),
                       # live KV pages across replicas (decode tables +
                       # a prefill replica's handoff table)
                       "kv_pages_active": sum(
                           int(_m(r).get("kv_pages_active", 0))
                           + int(_m(r).get("prefill_kv_pages_active", 0))
                           for r in dep["replicas"])}
                for name, dep in self._deployments.items()
            }

    def graceful_shutdown(self) -> bool:
        self._stop = True
        with self._lock:
            deps = list(self._deployments.values())
            self._deployments.clear()
        for dep in deps:
            for r in dep["replicas"]:
                self._kill_replica(r)
        # replicas still draining die with the app too (under the lock:
        # the control loop may be appending concurrently)
        with self._lock:
            draining = list(self._draining)
            self._draining = []
        for replica, _, _ in draining:
            self._kill_replica(replica)
        return True

    # -- reconciliation ------------------------------------------------
    def _bump_routing(self) -> None:
        with self._lock:
            self._routing = {name: list(dep["replicas"])
                             for name, dep in self._deployments.items()}
            self._configs = {name: dep["config"]
                             for name, dep in self._deployments.items()}
            # drop node mappings for replicas no longer routed or
            # draining (the map would otherwise grow per redeploy)
            live = {r.actor_id.binary()
                    for replicas in self._routing.values()
                    for r in replicas}
            live |= {entry[0].actor_id.binary()
                     for entry in self._draining}
            self._replica_nodes = {
                k: v for k, v in self._replica_nodes.items()
                if k in live}
            self._replica_metrics = {
                k: v for k, v in self._replica_metrics.items()
                if k in live}
            self._routing_version += 1

    def _control_loop(self) -> None:
        """Reconcile actual replicas toward target state
        (parity: DeploymentStateManager.update deployment_state.py)."""
        while not self._stop:
            try:
                self._poll_replica_metrics()
                changed = self._reconcile_once()
                if changed:
                    self._bump_routing()
                self._reap_drained()
                self._publish_serve_gauges()
            except Exception:  # noqa: BLE001
                logger.exception("serve control loop iteration failed")
            time.sleep(0.1)

    def _poll_replica_metrics(self) -> None:
        """Refresh every routed replica's metrics with ONE parallel
        fan-out and ONE bounded wait: a slow or dead replica costs the
        tick at most ``serve_metrics_timeout_s``, not 5 s each."""
        with self._lock:
            replicas = [r for dep in self._deployments.values()
                        for r in dep["replicas"]]
        if not replicas:
            return
        refs, keys = [], []
        for r in replicas:
            try:
                refs.append(r.metrics.remote())
                keys.append(r.actor_id.binary())
            except Exception:  # noqa: BLE001 — handle gone mid-kill
                continue
        if not refs:
            return
        timeout = float(_serve_knob("serve_metrics_timeout_s", 2.0))
        try:
            ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                    timeout=timeout)
        except Exception:  # noqa: BLE001 — cluster teardown
            return
        ready_set = set(ready)
        for key, ref in zip(keys, refs):
            if ref not in ready_set:
                continue  # slow replica: keep its last snapshot
            try:
                self._replica_metrics[key] = ray_tpu_torch.get(ref, timeout=1.0)
            except Exception:  # noqa: BLE001 — died since the poll
                self._replica_metrics.pop(key, None)

    def _publish_serve_gauges(self) -> None:
        with self._lock:
            items = [(name, list(dep["replicas"]))
                     for name, dep in self._deployments.items()]
        for name, replicas in items:
            _tm.serve_replicas(name, len(replicas))
            _tm.serve_queue_depth(name, sum(
                int((self._replica_metrics.get(r.actor_id.binary()) or {})
                    .get("queue_depth", 0)) for r in replicas))
            metrics = [self._replica_metrics.get(r.actor_id.binary()) or {}
                       for r in replicas]
            # paged-KV accounting (decode tables + prefill tables both
            # count; a prefill replica reports prefill_kv_* keys)
            if any("kv_pages_active" in m or "prefill_kv_pages_active"
                   in m for m in metrics):
                _tm.serve_kv_pages(
                    name,
                    sum(int(m.get("kv_pages_active", 0))
                        + int(m.get("prefill_kv_pages_active", 0))
                        for m in metrics),
                    sum(int(m.get("kv_pages_allocated_total", 0))
                        + int(m.get("prefill_kv_pages_allocated_total",
                                    0)) for m in metrics),
                    sum(int(m.get("kv_pages_freed_total", 0))
                        + int(m.get("prefill_kv_pages_handed_off_total",
                                    0)) for m in metrics))
                _tm.serve_kv_occupancy(name, max(
                    [float(m.get("kv_occupancy", 0.0))
                     for m in metrics] or [0.0]))
            # prefix-cache residency (pages the chain table holds for
            # reuse across requests, summed over replicas)
            if any("kv_prefix_pages_cached" in m for m in metrics):
                _tm.serve_prefix_pages_shared(name, sum(
                    int(m.get("kv_prefix_pages_cached", 0))
                    for m in metrics))
            # gang straggler skew: each gang replica's rank-0 reports
            # per-rank step means; publish the WORST gang's skew with
            # the straggling rank in the tag (the GangStraggler alert
            # groups by it, so the alert names the rank)
            gangs = [m for m in metrics if "rank_skew_s" in m]
            if gangs:
                worst = max(gangs, key=lambda m: float(m["rank_skew_s"]))
                _tm.gang_rank_skew(name, float(worst["rank_skew_s"]),
                                   int(worst.get("straggler_rank", 0)))

    def _reconcile_once(self) -> bool:
        changed = False
        capacity_bundles: List[Dict[str, float]] = []
        with self._lock:
            items = list(self._deployments.items())
        for name, dep in items:
            config: DeploymentConfig = dep["config"]
            target = self._autoscaled_target(name, dep, config)
            capacity_bundles.extend(self._replica_bundles(config, target))
            replicas: List[Any] = dep["replicas"]
            versions: List[int] = dep["replica_versions"]
            # dead replicas leave the set immediately (their requests
            # already failed; the router retries them elsewhere) so the
            # replace path below restores capacity this tick
            dead = [i for i, r in enumerate(replicas)
                    if self._known_dead(r)]
            for i in reversed(dead):
                gone = replicas.pop(i)
                versions.pop(i)
                # a dead rank 0 takes its gang with it (all-or-nothing):
                # reap surviving shard workers before the respawn below
                if gone.actor_id.binary() in self._gangs:
                    _tm.serve_gang_death(name)
                    self._kill_replica(gone)
                changed = True
            # rolling update: replace one stale replica at a time
            stale = [i for i, v in enumerate(versions)
                     if v != config.version]
            if stale and len(replicas) >= target:
                i = stale[0]
                new = self._start_replica(name, dep, config)
                if new is not None:
                    old = replicas[i]
                    replicas[i] = new
                    versions[i] = config.version
                    self._drain(old, config)
                    changed = True
                    continue
            deficit = target - len(replicas)
            if deficit > 0:
                # fleet scale-up: ALL creations issue before any
                # readiness wait, so the burst rides the control
                # plane's batched registration + pipelined bring-up
                # instead of serializing replica-by-replica
                for new in self._start_replicas(name, dep, config,
                                                deficit):
                    replicas.append(new)
                    versions.append(config.version)
                    changed = True
            while len(replicas) > target:
                old = replicas.pop()
                versions.pop()
                self._drain(old, config)
                changed = True
        self._update_capacity_request(capacity_bundles)
        return changed

    @staticmethod
    def _replica_bundles(config: DeploymentConfig,
                         target: int) -> List[Dict[str, float]]:
        """Chip-shaped capacity for one deployment at its current
        target: one bundle PER GANG MEMBER (``target x num_shards``),
        each the per-shard resource shape — the autoscaler must be
        asked for shards-worth of GPUs, not replica counts, or a
        GPU-gang scale-up would be satisfied by GPU-less CPU nodes."""
        opts = config.ray_actor_options or {}
        shape: Dict[str, float] = {
            str(k): float(v)
            for k, v in (opts.get("resources") or {}).items() if v}
        shape["CPU"] = float(opts.get("num_cpus") or 1)
        if opts.get("num_gpus"):
            shape["GPU"] = float(opts["num_gpus"])
        num_shards = max(1, int(getattr(config, "num_shards", 1)))
        return [dict(shape) for _ in range(max(0, target) * num_shards)]

    def _update_capacity_request(self,
                                 bundles: List[Dict[str, float]]) -> None:
        """Publish the standing shaped-capacity request
        (``autoscaler.sdk.request_resources``) when it changed: the
        node autoscaler then scales the fleet so every gang member's
        chips would fit BEFORE replica creation needs them, and holds
        that floor while the deployment exists (cleared when the last
        deployment is deleted).  Writes only on change — the KV put is
        WAL-backed and this runs every reconcile tick."""
        key = json.dumps(sorted(bundles, key=json.dumps), sort_keys=True)
        if key == self._last_capacity_request:
            return
        try:
            from ray_tpu_torch.autoscaler.sdk import request_resources
            request_resources(bundles=bundles)
            self._last_capacity_request = key
        except Exception:  # noqa: BLE001 — capacity hints must never
            logger.exception("capacity request update failed")  # kill
            # the control loop; retried next tick (key not cached)

    def _known_dead(self, replica: Any) -> bool:
        """True when the last metrics poll found the replica's actor
        dead (its cached snapshot was evicted AND a liveness probe
        fails fast)."""
        key = replica.actor_id.binary()
        if key in self._replica_metrics:
            return False
        try:
            ready, _ = ray_tpu_torch.wait([replica.ready.remote()],
                                    num_returns=1, timeout=0.5)
            if not ready:
                return False  # slow, not provably dead
            ray_tpu_torch.get(ready[0], timeout=0.5)
            return False
        except ActorDiedError:
            return True
        except Exception:  # noqa: BLE001 — inconclusive: keep it
            return False

    def _drain(self, replica: Any, config: DeploymentConfig) -> None:
        """Stop routing to the replica (caller bumps routing) and kill it
        only once its in-flight requests finish, or after the grace
        deadline (parity: replica graceful shutdown,
        deployment_state.py)."""
        now = time.monotonic()
        deadline = now \
            + float(getattr(config, "graceful_shutdown_timeout_s", 10.0))
        # minimum drain: requests already dispatched to the replica may
        # still be in its inbox (inflight not yet incremented)
        with self._lock:
            if self._stop:
                # shutdown already swept _draining; kill directly
                self._kill_replica(replica)
                return
            self._draining.append((replica, deadline, now + 0.5))

    def _reap_drained(self) -> None:
        with self._lock:
            draining = list(self._draining)
        if not draining:
            return
        now = time.monotonic()
        # one parallel probe round for every drain candidate past its
        # minimum age (was: serial 5s-timeout gets, one per replica)
        probes: Dict[int, Any] = {}
        for idx, (replica, deadline, not_before) in enumerate(draining):
            if now >= not_before and now <= deadline:
                try:
                    probes[idx] = replica.metrics.remote()
                except Exception:  # noqa: BLE001
                    pass
        probe_vals: Dict[int, Optional[Dict[str, Any]]] = {}
        if probes:
            refs = list(probes.values())
            timeout = float(_serve_knob("serve_metrics_timeout_s", 2.0))
            try:
                ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                        timeout=timeout)
                ready_set = set(ready)
            except Exception:  # noqa: BLE001
                ready_set = set()
            for idx, ref in probes.items():
                if ref not in ready_set:
                    continue
                try:
                    probe_vals[idx] = ray_tpu_torch.get(ref, timeout=1.0)
                except ActorDiedError:
                    probe_vals[idx] = None  # dead: reap below
                except Exception:  # noqa: BLE001
                    pass  # busy/slow: keep draining until the deadline
        still: List[Tuple[Any, float, float]] = []
        for idx, (replica, deadline, not_before) in enumerate(draining):
            now = time.monotonic()
            if now < not_before:
                still.append((replica, deadline, not_before))
                continue
            done = now > deadline
            if not done and idx in probe_vals:
                m = probe_vals[idx]
                done = m is None or (
                    m.get("inflight", 0) == 0
                    and m.get("queue_depth", 0) == 0)
            if done:
                self._kill_replica(replica)
            else:
                still.append((replica, deadline, not_before))
        with self._lock:
            if not self._stop:
                self._draining = still

    def _autoscaled_target(self, name: str, dep: Dict[str, Any],
                           config: DeploymentConfig) -> int:
        ac = config.autoscaling_config
        if not ac:
            return config.num_replicas
        lo = ac.get("min_replicas", 1)
        hi = ac.get("max_replicas", config.num_replicas)
        state = self._scale_state.setdefault(
            name, {"target": max(lo, min(len(dep["replicas"]) or lo, hi)),
                   "proposed": None, "since": 0.0})
        metrics = [self._replica_metrics.get(r.actor_id.binary())
                   for r in dep["replicas"]]
        metrics = [m for m in metrics if m]
        if not metrics:
            # no signal yet (cold deploy / all replicas just died):
            # hold the floor, never scale on silence
            state["target"] = max(lo, min(state["target"], hi))
            return state["target"]
        # SLO signal: ongoing requests per replica. On a batched
        # replica the batcher queue is a subset of inflight (each
        # queued request holds a blocked handler thread), so take the
        # max — queue depth still leads once inflight saturates at
        # max_concurrent_queries, without double-counting below it.
        load = sum(max(int(m.get("inflight", 0)),
                       int(m.get("queue_depth", 0)))
                   for m in metrics)
        target_per = ac.get("target_num_ongoing_requests_per_replica", 1)
        desired = int(load / max(float(target_per), 1e-9) + 0.999)
        desired = min(max(desired, lo), hi)
        cur = state["target"]
        now = time.monotonic()
        if desired == cur:
            state["proposed"] = None
            return cur
        if state["proposed"] != desired:
            # new proposal: start its sustain clock
            state["proposed"] = desired
            state["since"] = now
            return cur
        delay = float(_serve_knob("serve_autoscale_upscale_delay_s", 0.3)
                      if desired > cur else
                      _serve_knob("serve_autoscale_downscale_delay_s", 2.0))
        if now - state["since"] >= delay:
            state["target"] = desired
            state["proposed"] = None
            logger.info("autoscaling %s: %d -> %d replicas (load signal)",
                        name, cur, desired)
            return desired
        return cur

    def _start_replica(self, name: str, dep: Dict[str, Any],
                       config: DeploymentConfig) -> Optional[Any]:
        out = self._start_replicas(name, dep, config, 1)
        return out[0] if out else None

    def _create_replica(self, name: str, dep: Dict[str, Any],
                        config: DeploymentConfig
                        ) -> Optional[Dict[str, Any]]:
        """Issue one replica creation WITHOUT waiting for readiness.

        ``num_shards > 1`` issues the WHOLE gang here — rank 0 plus
        every ShardGangWorker — before any wait, so one gang's creation
        coalesces into one registration batch + one pipelined bring-up
        wave, with SPREAD placing shards across nodes."""
        try:
            opts = dict(config.ray_actor_options or {})
            init_args, init_kwargs = dep["init"]
            num_shards = max(1, int(getattr(config, "num_shards", 1)))
            prefill_cfg = None
            if getattr(config, "role", "") == "prefill" \
                    and name.endswith(self.PREFILL_SUFFIX):
                # page geometry comes from the decode deployment so
                # both tiers seal interchangeable pages
                with self._lock:
                    base = self._deployments.get(
                        name[:-len(self.PREFILL_SUFFIX)])
                b = (base["config"].batching or {}) if base else {}
                prefill_cfg = {
                    "kv_page_tokens": b.get("kv_page_tokens") or 16,
                    "kv_max_pages": b.get("kv_max_pages") or 0}
            members: List[Any] = []
            if num_shards > 1:
                from ray_tpu_torch.serve.sharded import ShardGangWorker
                mopts = {k: v for k, v in opts.items()
                         if k in ("num_cpus", "num_gpus",
                                  "resources", "runtime_env",
                                  "scheduling_strategy")}
                # shards spread across nodes unless the deployment
                # pinned its own placement (SPREAD/NODE_AFFINITY)
                mopts.setdefault("scheduling_strategy", "SPREAD")
                for rank in range(1, num_shards):
                    members.append(ShardGangWorker.options(
                        max_concurrency=4,
                        concurrency_groups={"control": 2},
                        **mopts).remote(
                            dep["blob"], init_args, init_kwargs,
                            rank, num_shards, name))
            # control methods (health/metrics/reconfigure) run in their
            # own concurrency group so a saturated handle_request pool
            # cannot starve them (reference: replicas use a dedicated
            # control concurrency group — actor.py:65-83)
            handle = ServeReplica.options(
                max_concurrency=max(4, config.max_concurrent_queries),
                concurrency_groups={"control": 2},
                **opts).remote(dep["blob"], init_args, init_kwargs,
                               config.user_config,
                               deployment_name=name,
                               batching=getattr(config, "batching", None),
                               num_shards=num_shards,
                               prefill_cfg=prefill_cfg,
                               multiplexed=getattr(
                                   config, "multiplexed_models", None),
                               multiplex_max_resident=getattr(
                                   config, "multiplex_max_resident", 0))
            return {"handle": handle, "members": members,
                    "t0": time.monotonic()}
        except Exception:  # noqa: BLE001
            logger.exception("failed to start replica")
            return None

    def _start_replicas(self, name: str, dep: Dict[str, Any],
                        config: DeploymentConfig, n: int) -> List[Any]:
        """Start ``n`` replicas CONCURRENTLY: every creation (including
        every gang member) is issued up front (one coalesced
        registration batch + one pipelined bring-up wave on the control
        plane), then readiness resolves under a single bounded wait —
        was one blocking 120 s ready-probe per replica, which made an
        N-replica scale-up N serial actor creations end to end.

        Gangs are all-or-nothing: a gang with ANY member failing
        readiness is killed whole (and retried by the next reconcile
        tick); a healthy gang is attached (rank 0 learns its shard
        handles) before it is routed."""
        started: List[Dict[str, Any]] = []
        for _ in range(max(0, n)):
            gang = self._create_replica(name, dep, config)
            if gang is None:
                break
            started.append(gang)
        if not started:
            return []
        num_shards = max(1, int(getattr(config, "num_shards", 1)))
        gang_refs: List[List[Any]] = []
        for gang in started:
            gang_refs.append([gang["handle"].ready.remote()]
                             + [m.ready.remote()
                                for m in gang["members"]])
        all_refs = [r for refs in gang_refs for r in refs]
        timeout = 120.0 if num_shards == 1 else float(
            _serve_knob("serve_gang_ready_timeout_s", 120.0))
        try:
            ready, _ = ray_tpu_torch.wait(all_refs, num_returns=len(all_refs),
                                    timeout=timeout)
            ready_set = set(ready)
        except Exception:  # noqa: BLE001 — fall back to per-replica
            # probes below: a transient owner-side wait error must not
            # read as "none ready" and kill already-healthy replicas
            logger.exception("batched readiness wait failed; probing "
                             "replicas individually")
            ready_set = None
        out: List[Any] = []
        node_probes: List[Any] = []
        for gang, refs in zip(started, gang_refs):
            replica = gang["handle"]
            ok = True
            for ref in refs:
                if ready_set is not None and ref not in ready_set:
                    ok = False
                    break
                try:
                    ray_tpu_torch.get(ref, timeout=30.0 if ready_set is None
                                else 1.0)
                except Exception:  # noqa: BLE001
                    logger.exception("gang member failed to become ready")
                    ok = False
                    break
            if ok and gang["members"]:
                try:
                    ray_tpu_torch.get(replica.attach_shards.remote(
                        gang["members"]), timeout=30.0)
                except Exception:  # noqa: BLE001 — rank 0 died between
                    logger.exception("gang attach failed")  # ready and
                    ok = False  # attach: retry the whole gang
            if not ok:
                # all-or-nothing: one bad member kills the gang
                try:
                    ray_tpu_torch.kill(replica)
                except Exception:  # noqa: BLE001
                    pass
                for m in gang["members"]:
                    try:
                        ray_tpu_torch.kill(m)
                    except Exception:  # noqa: BLE001
                        pass
                continue
            if gang["members"]:
                self._gangs[replica.actor_id.binary()] = \
                    list(gang["members"])
                _tm.serve_gang_bringup(
                    name, time.monotonic() - gang["t0"], num_shards)
            try:
                node_probes.append(
                    (replica.actor_id.binary(),
                     replica.node_id.remote()))
            except Exception:  # noqa: BLE001 — locality is best-effort
                pass
            # seed the metrics cache so a fresh replica isn't treated
            # as dead by _known_dead before its first poll round
            self._replica_metrics.setdefault(
                replica.actor_id.binary(),
                {"inflight": 0, "queue_depth": 0, "total": 0})
            out.append(replica)
        if node_probes:
            # one bounded wait for ALL locality probes (best-effort)
            probe_refs = [ref for _, ref in node_probes]
            try:
                ready, _ = ray_tpu_torch.wait(probe_refs,
                                        num_returns=len(probe_refs),
                                        timeout=10.0)
                ready_set = set(ready)
                for key, ref in node_probes:
                    if ref in ready_set:
                        self._replica_nodes[key] = \
                            ray_tpu_torch.get(ref, timeout=1.0)
            except Exception:  # noqa: BLE001 — locality is best-effort
                pass
        return out


class Router:
    """Client-side replica picker with long-poll refresh (parity:
    router.py Router/ReplicaSet).  Replica choice is power-of-two
    choices over estimated queue depth (controller-reported snapshot +
    this process's own in-flight delta), preferring same-node replicas
    and skipping saturated or known-dead ones."""

    def __init__(self, controller):
        self._controller = controller
        self._table: Dict[str, Any] = {}
        self._version = -1
        self._rr: Dict[str, int] = {}
        self._inflight: Dict[Tuple[str, bytes], int] = {}
        self._dead: Set[bytes] = set()
        self._rng = random.Random(0x5EED)
        self._lock = threading.Lock()
        self._stop = threading.Event()
        # this process's node, for same-node-first replica ranking
        # (reference replica_scheduler prefers node-local replicas)
        try:
            self._local_node: Optional[str] = \
                ray_tpu_torch.get_runtime_context().get_node_id()
        except Exception:  # noqa: BLE001
            self._local_node = None
        self._refresh(block=True)
        self._thread = threading.Thread(target=self._poll_loop, daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Terminate the long-poll thread (parity: reference
        long_poll.py:68 LongPollClient teardown). Idempotent; safe to call
        while a poll RPC is in flight — the flag is re-checked after each
        refresh returns or errors."""
        self._stop.set()

    def _refresh(self, block: bool = False) -> None:
        reply = ray_tpu_torch.get(self._controller.get_routing_table.remote(
            self._version if not block else -1, 10.0), timeout=30)
        with self._lock:
            self._version = reply["version"]
            self._table = reply["table"]
            # a replica the controller no longer routes is gone for
            # good; stop remembering it as dead
            live = {r.actor_id.binary()
                    for entry in self._table.values()
                    for r in entry["replicas"]}
            self._dead &= live

    def _poll_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._refresh()
            except Exception:  # noqa: BLE001
                self._stop.wait(1.0)

    def mark_dead(self, key: Tuple[str, bytes]) -> None:
        """Caller observed the replica's actor die: exclude it from
        assignment until the controller's table stops routing it."""
        with self._lock:
            self._dead.add(key[1])
            self._inflight.pop(key, None)

    def queue_limit(self, deployment: str) -> int:
        """Effective ingress backlog cap for the deployment (0 =
        unbounded)."""
        with self._lock:
            entry = self._table.get(deployment) or {}
        limit = entry.get("max_queued_requests", -1)
        if limit is None or limit < 0:
            limit = int(_serve_knob("serve_proxy_queue_limit", 128))
        return max(0, int(limit))

    def known(self, deployment: str) -> bool:
        with self._lock:
            return deployment in self._table

    def prefill_for(self, deployment: str) -> Optional[str]:
        """Name of the deployment's prefill tier, or None (unified)."""
        with self._lock:
            entry = self._table.get(deployment) or {}
        return entry.get("prefill")

    def replicas_of(self, deployment: str) -> List[Any]:
        """Snapshot of the deployment's routed replica handles (for
        whole-set fan-outs like ``serve.warmup`` — request dispatch
        goes through ``assign`` instead)."""
        with self._lock:
            entry = self._table.get(deployment) or {}
            return list(entry.get("replicas") or [])

    def _try_assign(self, deployment: str,
                    exclude: Tuple[bytes, ...] = (),
                    model: Optional[str] = None):
        """One nonblocking pick; returns (replica, key), None when no
        assignable replica exists right now, or raises KeyError for a
        deployment the table doesn't know.

        Steering order within the eligible set: replicas whose batch
        has a FREE SLOT at the next step boundary first (cross-gang
        continuous batching — the deployment's gangs act as one logical
        batch surface), then replicas where the request's ``model`` is
        already resident (multiplexing — avoid a weight swap), then
        locality, then power-of-two-choices on estimated depth."""
        _fp.failpoint("serve.router.assign")
        steered = False
        with self._lock:
            entry = self._table.get(deployment)
            if entry is None:
                raise KeyError(deployment)
            replicas = entry["replicas"]
            if not replicas:
                return None
            n = len(replicas)
            nodes = entry.get("replica_nodes") or [None] * n
            depths = entry.get("replica_depths") or [0] * n
            slots = entry.get("replica_slots") or [None] * n
            res_models = entry.get("replica_models") or [None] * n
            cap = entry["max_concurrent_queries"]
            skip = set(exclude) | self._dead

            def score(i: int) -> int:
                key = (deployment, replicas[i].actor_id.binary())
                return depths[i] + self._inflight.get(key, 0)

            eligible = [i for i in range(n)
                        if replicas[i].actor_id.binary() not in skip
                        and self._inflight.get(
                            (deployment, replicas[i].actor_id.binary()),
                            0) < cap]
            if not eligible:
                return None
            group = eligible
            # cross-gang slot steering: the controller-reported free
            # slots minus this router's own undispatched in-flight is
            # the best local estimate of next-boundary availability
            open_slots = [
                i for i in group
                if slots[i] is None
                or int(slots[i]) - self._inflight.get(
                    (deployment, replicas[i].actor_id.binary()), 0) > 0]
            if open_slots and len(open_slots) < len(group):
                group = open_slots
                steered = True
            # model-resident steering (multiplexed deployments): prefer
            # a replica that serves the model without a swap
            if model:
                warm = [i for i in group
                        if res_models[i] and model in res_models[i]]
                if warm:
                    group = warm
            # locality next: exhaust same-node replicas before
            # crossing nodes (each group scored independently)
            local = [i for i in group
                     if self._local_node is not None
                     and nodes[i] == self._local_node]
            group = local or group
            if len(group) == 1:
                idx = group[0]
            else:
                # power of two choices: two distinct random candidates,
                # lower estimated depth wins; ties alternate round-robin
                # so equal-depth replicas share load deterministically
                a, b = self._rng.sample(group, 2)
                if score(a) < score(b):
                    idx = a
                elif score(b) < score(a):
                    idx = b
                else:
                    rr = self._rr.get(deployment, 0)
                    self._rr[deployment] = rr + 1
                    idx = group[rr % len(group)]
            r = replicas[idx]
            key = (deployment, r.actor_id.binary())
            self._inflight[key] = self._inflight.get(key, 0) + 1
        if steered:
            # metric export outside the lock (registry has its own)
            _tm.serve_xgang_steered(deployment)
        return (r, key)

    def assign(self, deployment: str, timeout_s: float = 30.0,
               exclude: Tuple[bytes, ...] = (),
               model: Optional[str] = None):
        """Pick a replica (blocking).  Unknown deployments fail fast
        (one short grace for table propagation); known deployments with
        no assignable replica yet wait for one."""
        deadline = time.monotonic() + timeout_s
        grace = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            try:
                picked = self._try_assign(deployment, exclude, model)
            except KeyError:
                if time.monotonic() > grace:
                    raise KeyError(
                        f"no deployment named {deployment!r}") from None
                time.sleep(0.05)
                continue
            if picked is not None:
                return picked
            time.sleep(0.05)
        raise RuntimeError(
            f"no available replica for deployment {deployment!r}")

    async def assign_async(self, deployment: str, timeout_s: float = 30.0,
                           exclude: Tuple[bytes, ...] = (),
                           model: Optional[str] = None):
        """``assign`` for event-loop callers (the ingress proxy): same
        semantics, polling with ``asyncio.sleep`` so the loop keeps
        serving other connections while this one waits for capacity."""
        import asyncio

        deadline = time.monotonic() + timeout_s
        grace = time.monotonic() + 1.0
        while time.monotonic() < deadline:
            try:
                picked = self._try_assign(deployment, exclude, model)
            except KeyError:
                if time.monotonic() > grace:
                    raise KeyError(
                        f"no deployment named {deployment!r}") from None
                await asyncio.sleep(0.05)
                continue
            if picked is not None:
                return picked
            await asyncio.sleep(0.05)
        raise RuntimeError(
            f"no available replica for deployment {deployment!r}")

    def release(self, key) -> None:
        with self._lock:
            n = self._inflight.get(key, 1) - 1
            if n <= 0:
                # drop zeroed keys: with replica churn the map would
                # otherwise grow one dead entry per replica forever
                self._inflight.pop(key, None)
            else:
                self._inflight[key] = n
