"""Global Control Service: the cluster metadata authority.

Parity: reference ``src/ray/gcs/gcs_server/`` — node membership
(GcsNodeManager), actor directory + lifecycle (GcsActorManager /
GcsActorScheduler), placement groups (GcsPlacementGroupManager, two-phase
prepare/commit), job table, internal KV, function table, health checking
(GcsHealthCheckManager), and the pubsub hub.  Table storage is pluggable
(``core/table_storage.py``): in-memory by default (the reference's default
store client), with a durable file-backed store that lets a restarted head
rehydrate nodes/actors/PGs/jobs/KV — exercised by ``tests/test_chaos.py``
(head SIGKILL mid-workload, same driver finishes).

TPU twist (SURVEY.md §7.2): node registration carries topology metadata —
slice name, chip coordinates, ICI neighbor hints — alongside resources, so
gang scheduling can place co-located bundles on one slice.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import flight_recorder as _flight
from ray_tpu_torch.core import profiler as _prof
from ray_tpu_torch.core import rpc
from ray_tpu_torch.core import telemetry as _tm
from ray_tpu_torch.core import tracing as _trace
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, PlacementGroupID
from ray_tpu_torch.autoscaler.fair_queue import (
    NODE_ACTIVE, NODE_DEAD, NODE_DRAINED, NODE_DRAINING, JobQuota,
    validate_transition)
from ray_tpu_torch.util import failpoint as _fp

logger = logging.getLogger(__name__)


@dataclass
class NodeInfo:
    node_id: NodeID
    raylet_address: rpc.Address
    resources_total: Dict[str, float]
    resources_available: Dict[str, float]
    # TPU topology metadata: {"slice": str, "coords": [x,y,z], "worker_index": int}
    topology: Dict[str, Any] = field(default_factory=dict)
    alive: bool = True
    last_heartbeat: float = field(default_factory=time.monotonic)
    # load: number of queued+running lease requests, for hybrid scheduling
    load: int = 0
    # queued resource shapes (autoscaler demand signal)
    pending_demand: List[Dict[str, float]] = field(default_factory=list)
    # per-node reporter payload: cpu/mem + per-worker process stats
    stats: Dict[str, Any] = field(default_factory=dict)
    # worker-process capacity the raylet advertised (-1 = unknown, old
    # raylets); 0 = a dedicated control node that can NEVER host a
    # worker — the actor scheduler must not strand leases there
    max_workers: int = -1
    # lifecycle state (docs/autoscaler.md): ACTIVE | DRAINING | DRAINED
    # | DEAD.  DRAINING/DRAINED nodes keep alive=True (the raylet still
    # serves in-flight work and object pulls) but take no new leases
    state: str = NODE_ACTIVE
    drain_reason: str = ""
    # raylet process id: on a same-host node death the GCS reads the
    # dead raylet's flight ring from the session dir by this pid
    pid: int = 0


#: internal-KV key (default namespace) holding the standing
#: ``autoscaler.sdk.request_resources`` bundles as a JSON list
RESOURCE_REQUEST_KV_KEY = "__autoscaler_resource_request"

#: internal-KV key (default namespace) holding the autoscaler monitor's
#: last decision as JSON ({action, detail, ts}) — surfaced by
#: ``ray-tpu nodes`` so operators see why the fleet last moved
AUTOSCALER_DECISION_KV_KEY = "__autoscaler_last_decision"

#: internal-KV key (namespace ``_internal``) holding the JSON firing
#: alert set — rewritten on every transition so a restarted GCS can
#: re-seed its evaluator (docs/observability.md)
ALERTS_FIRING_KV_KEY = "alerts_firing"

ACTOR_PENDING = "PENDING_CREATION"
ACTOR_ALIVE = "ALIVE"
ACTOR_RESTARTING = "RESTARTING"
ACTOR_DEAD = "DEAD"


@dataclass
class ActorInfo:
    actor_id: ActorID
    state: str = ACTOR_PENDING
    name: Optional[str] = None
    namespace: str = "default"
    detached: bool = False
    address: Optional[rpc.Address] = None  # the actor worker's task server
    node_id: Optional[NodeID] = None
    max_restarts: int = 0
    num_restarts: int = 0
    creation_spec_blob: Optional[bytes] = None  # pickled TaskSpec, for restarts
    resources: Dict[str, float] = field(default_factory=dict)
    owner_job: Optional[JobID] = None
    death_cause: str = ""
    class_name: str = ""
    # gang binding: schedule onto this group's bundle, charged to it
    pg_id: Optional[PlacementGroupID] = None
    bundle_index: int = -1
    # placement strategy (actor.options(scheduling_strategy=...)):
    # DEFAULT least-loaded, SPREAD fans across nodes by live-actor
    # count, NODE_AFFINITY pins to strategy_node (soft = fall back)
    strategy: str = "DEFAULT"
    strategy_node: Optional[str] = None
    strategy_soft: bool = False
    env_hash: Optional[str] = None
    env_spawn: Optional[Dict[str, Any]] = None
    # owner-reported raylet addresses of nodes already holding the
    # creation args' objects: DEFAULT placement prefers them so the
    # creation task's arg fetch is a local read, not a transfer
    locality: Optional[List[Any]] = None


@dataclass
class PlacementGroupInfo:
    pg_id: PlacementGroupID
    bundles: List[Dict[str, float]]
    strategy: str  # PACK | SPREAD | STRICT_PACK | STRICT_SPREAD
    state: str = "PENDING"  # PENDING | CREATED | REMOVED | INFEASIBLE
    # bundle index -> node id
    bundle_nodes: Dict[int, NodeID] = field(default_factory=dict)
    name: Optional[str] = None
    scheduling: bool = False  # reentrancy guard for _schedule_pg
    retry_at: float = 0.0  # monotonic time of next placement attempt
    retry_backoff: float = 0.5  # grows while unplaceable, capped


class GcsServer:
    """All GCS tables + managers in one asyncio service."""

    def __init__(self, config: Config, host: str = "127.0.0.1",
                 port: int = 0, snapshot_path: Optional[str] = None,
                 session_dir: Optional[str] = None):
        self.config = config
        self.server = rpc.Server(self, host=host, port=port)
        self.pool = rpc.ConnectionPool()
        # structured events (parity: src/ray/util/event.h + the
        # dashboard event module): own emissions + pushes from every
        # process land in one ring buffer behind list_events
        from ray_tpu_torch.util import event as event_mod
        self._event_mod = event_mod
        event_mod.init("GCS", session_dir)
        # crash-surviving flight ring for the head process (the
        # co-located raylet's later init is a no-op — first init wins)
        _flight.init("gcs", session_dir, config)
        self._session_dir = session_dir
        # bounded per-severity event retention rings: a flood of one
        # severity (INFO churn) can no longer evict the sparse ERROR
        # evidence an incident window needs.  Evictions are counted
        # (ray_tpu_events_evicted_total + debug_state).
        from collections import deque as _deque
        self._event_rings: Dict[str, "_deque"] = {}
        self._events_evicted = 0
        # incident journal (docs/observability.md "Incidents and
        # postmortems"): auto-opened on deaths / firing alerts,
        # WAL-persisted like alerts so they survive a head SIGKILL
        from collections import OrderedDict as _inc_od
        self._incidents: "_inc_od[str, Dict[str, Any]]" = _inc_od()
        self._incident_collect_handles: Dict[str, Any] = {}
        # versioned resource-view broadcast (ray_syncer equivalent)
        self._sync_version = 0
        self._sync_dirty: set = set()
        self._sync_task: Optional[asyncio.Task] = None
        # tables
        self.nodes: Dict[NodeID, NodeInfo] = {}
        self.actors: Dict[ActorID, ActorInfo] = {}
        self.named_actors: Dict[Tuple[str, str], ActorID] = {}  # (ns, name)
        self.placement_groups: Dict[PlacementGroupID, PlacementGroupInfo] = {}
        # long-poll waiters for placement_group_ready (kept OUT of
        # PlacementGroupInfo: those objects are pickled by persistence)
        self._pg_waiters: Dict[PlacementGroupID, asyncio.Event] = {}
        self.kv: Dict[str, Dict[str, bytes]] = {}  # namespace -> key -> value
        self.functions: Dict[str, bytes] = {}  # function_id -> pickled blob
        self.job_counter = 0
        self.jobs: Dict[JobID, Dict[str, Any]] = {}
        # per-job scheduling quotas (job key -> JobQuota dict), WAL- and
        # snapshot-covered so fair-queue weights survive a head SIGKILL
        self.quotas: Dict[str, Dict[str, Any]] = {}
        # per-node lease tables: node hex -> {job: {resource: in-flight}}
        # — heartbeat-reported ground truth, WAL'd on change so a GCS
        # restart mid-drain restores in-flight quota accounting
        self.lease_tables: Dict[str, Dict[str, Dict[str, float]]] = {}
        # durable drain-state map (node_id binary -> {state, reason}):
        # the node table itself is rebuilt by live re-registration, but
        # a DRAINING/DRAINED verdict must survive a GCS SIGKILL so the
        # re-registering raylet resumes in the right lifecycle state
        self._node_states: Dict[bytes, Dict[str, Any]] = {}
        # node ids with a drain protocol currently executing (in-memory
        # only: a restarted GCS may re-enter a WAL-restored DRAINING)
        self._drains_inflight: set = set()
        # pubsub: channel -> set of connections
        self.subscribers: Dict[str, set] = {}
        # node connections (raylet registration conns) for death detection
        self._node_conns: Dict[NodeID, rpc.Connection] = {}
        self._health_task: Optional[asyncio.Task] = None
        self._pg_retry_task: Optional[asyncio.Task] = None
        self._actor_creation_locks: Dict[ActorID, asyncio.Lock] = {}
        # coalesced-registration accounting (debug_state surface; the
        # batch-size histogram is the metrics-plane view of the same)
        self._reg_batches = 0
        self._reg_batch_actors = 0
        # source -> (seq, replies) ack cache: a retried batch whose ack
        # was lost re-serves the first pass's replies instead of
        # re-running (and re-counting) the whole batch
        self._reg_batch_acks: Dict[str, Any] = {}
        # node -> unresolved lease_worker_for_actor calls (burst spread)
        self._actor_lease_inflight: Dict[NodeID, int] = {}
        # actor_id -> NodeID charged above (held until actor_started /
        # creation_failed so still-initializing actors keep counting)
        self._actor_lease_charges: Dict[ActorID, NodeID] = {}
        self._task_events: List[Dict[str, Any]] = []  # state API ring buffer
        self._tasks_finished_total = 0  # monotonic (metrics counter)
        # per-source replay high-water marks: report_task_events and
        # report_metrics are retried on lost acks (IDEMPOTENT_METHODS),
        # and their folds accumulate — a replayed flush must be dropped,
        # not re-applied (exactly-once at the fold, like the WAL dedup)
        self._task_event_seq: Dict[str, int] = {}
        self._metric_seq: Dict[str, int] = {}
        # ring-buffer overflow accounting (satellite: silent event loss):
        # job hex -> events evicted unread, plus burst-logging state
        self._task_event_drops: Dict[str, int] = {}
        self._task_event_drops_total = 0
        self._drop_burst_started = 0.0  # 0 = not in an overflow burst
        self._drop_burst_count = 0
        # (name, sorted-tags) -> aggregated metric record
        self._metrics: Dict[Any, Dict[str, Any]] = {}
        # transfer / rpc-retry spans for timeline() (clock-aligned by
        # the reporting process; see telemetry.measure_clock_offset)
        from collections import deque as _dq
        self._spans: "_dq" = _dq(maxlen=getattr(
            config, "telemetry_spans_table_size", 20000))
        # continuous-profiling ring (report_profile producer records,
        # served merged by get_profile) + eviction accounting
        self._profile: "_dq" = _dq(maxlen=getattr(
            config, "profiler_table_size", 50000))
        self._profile_evicted = 0
        # distributed-tracing assembly ring: trace_id -> entry, insertion
        # ordered for eviction.  Entries assemble spans until the root
        # arrives, then TAIL SAMPLING decides retention (errors / sheds /
        # deadline misses / SLO violations / retried traces always kept;
        # fast successes kept at trace_sample_keep_fraction).  A
        # sampled-out entry stays as a tombstone (keep=False, spans
        # cleared) so stragglers from slower processes drop instead of
        # resurrecting the trace; the ring cap evicts oldest-first.
        from collections import OrderedDict as _od
        self._traces: "_od[str, Dict[str, Any]]" = _od()
        self._traces_evicted = 0
        self._traces_retained = 0
        self._traces_sampled_out = 0
        # recently-evicted trace ids: stragglers flushing after their
        # trace (or its tombstone) left the ring must DROP, not
        # resurrect a rootless phantom entry that occupies a slot and
        # can never complete
        self._trace_evicted_ids: "_dq[str]" = _dq()
        self._trace_evicted_set: set = set()
        #: spans kept per trace before truncation (a runaway decode
        #: loop must not let one trace eat the ring's memory)
        self._trace_span_cap = 512
        #: live cluster profiling window ({enabled, hz, deadline}) for
        #: raylets that register mid-window
        self._profiler_state: Optional[Dict[str, Any]] = None
        self._metrics_task: Optional[asyncio.Task] = None
        # durable tables behind the pluggable TableStorage interface
        # (reference: GcsTableStorage over Redis/in-memory store clients):
        # kv, functions, jobs, the FULL actor table, and placement groups
        # survive a GCS/head restart; nodes re-register live
        from ray_tpu_torch.core.table_storage import (InMemoryTableStorage,
                                                make_table_storage)
        self.table_storage = make_table_storage(
            getattr(config, "gcs_table_storage", ""), snapshot_path)
        self._persist_handle: Optional[asyncio.TimerHandle] = None
        #: actors restored ALIVE from a snapshot pending a liveness probe
        self._actors_to_revalidate: List[ActorInfo] = []
        #: actors restored mid-scheduling (PENDING/RESTARTING)
        self._actors_to_reschedule: List[ActorInfo] = []
        # write-ahead log in front of the snapshot (docs/ha.md): table-
        # mutating handlers append a typed record and hold the reply
        # until it is durable, so an acked mutation survives a SIGKILL
        # inside the snapshot debounce window.  Ephemeral (memory)
        # clusters run without one.
        self.wal = None
        self._wal_degraded = False
        #: last FAILED snapshot write (cooldown clock: a failing
        #: backend must not retry size-triggered compaction
        #: per-mutation)
        self._persist_failed_ts = 0.0
        if getattr(config, "gcs_wal_enabled", True) \
                and not isinstance(self.table_storage,
                                   InMemoryTableStorage):
            from ray_tpu_torch.core.wal import WriteAheadLog
            wal_path = os.path.join(session_dir, "gcs_wal.log") \
                if session_dir else (snapshot_path or "") + ".wal"
            if wal_path and wal_path != ".wal":
                self.wal = WriteAheadLog(
                    wal_path,
                    sync=getattr(config, "gcs_wal_sync", "fsync"))
        #: restart-recovery / reconvergence accounting (served by
        #: handle_recovery_state; duration finalized after the restored
        #: actors were revalidated)
        self._recovery: Dict[str, Any] = {
            "restored": False, "wal_records_replayed": 0,
            "wal_torn_tail_bytes": 0, "actors_recovered": 0,
            "actors_revalidated": 0, "actors_rescheduled": 0,
            "nodes_expected": 0, "complete": True, "duration_s": 0.0,
        }
        self._recovery_t0 = time.monotonic()
        #: nodes known to the previous incarnation (WAL node records):
        #: the reconvergence denominator — raylets re-register live,
        #: this just tells recovery_state how many to expect
        self._wal_nodes: Dict[bytes, Dict[str, Any]] = {}
        self._restore_snapshot()
        # metrics history + alert evaluator (core/metrics_history.py):
        # constructed AFTER the restore so a firing set persisted by
        # the previous incarnation (internal KV) seeds the evaluator —
        # a firing alert survives a head SIGKILL as re-firing-or-
        # resolved, never silently lost
        from ray_tpu_torch.core.metrics_history import MetricsHistory
        restored_firing = None
        try:
            raw = self.kv.get("_internal", {}).get(ALERTS_FIRING_KV_KEY)
            if raw:
                import json as _json
                restored_firing = _json.loads(raw.decode())
        except Exception:  # noqa: BLE001 — corrupt state: start clean
            logger.exception("restored alert state unreadable; ignored")
        self._history = MetricsHistory(
            interval_s=getattr(config, "metrics_history_interval_s", 2.0),
            window_s=getattr(config, "metrics_history_window_s", 300.0),
            slo_latency_s=getattr(config, "serve_slo_latency_s", 0.0),
            slo_error_budget=getattr(config, "serve_slo_error_budget",
                                     0.01),
            restored_firing=restored_firing)
        self._history_evicted_reported = 0
        self._history_task: Optional[asyncio.Task] = None

    def _restore_snapshot(self) -> None:
        """Recovery: load the snapshot, replay the WAL on top (typed
        set-style records — replaying records the snapshot already
        covers converges, see core/wal.py), then classify the restored
        actors for revalidation/rescheduling."""
        snap = self.table_storage.load()
        if snap is not None:
            self.kv = snap.get("kv", {})
            self.functions = snap.get("functions", {})
            self.jobs = snap.get("jobs", {})
            self.job_counter = snap.get("job_counter", 0)
            self.quotas = snap.get("quotas", {})
            self.lease_tables = snap.get("lease_tables", {})
            self._node_states = snap.get("node_states", {})
            for inc in snap.get("incidents", []):
                self._incidents[inc["id"]] = inc
            # full actor runtime state (not just detached): a
            # reconnecting driver's handles must keep resolving after a
            # head restart
            for info in snap.get("actors",
                                 snap.get("detached_actors", [])):
                self.actors[info.actor_id] = info
            for pg_id, info in snap.get("placement_groups", {}).items():
                self.placement_groups[pg_id] = info
        n_wal = 0
        if self.wal is not None:
            try:
                for _seq, rtype, data in self.wal.recover():
                    try:
                        self._wal_apply(rtype, data)
                        n_wal += 1
                    except Exception:  # noqa: BLE001 — skip a bad record
                        logger.exception("WAL record %r failed to apply",
                                         rtype)
                self._recovery["wal_torn_tail_bytes"] = \
                    self.wal.torn_tail_bytes
            except Exception:  # noqa: BLE001 — recovery must not crash
                logger.exception("WAL recovery failed; snapshot only")
                self._wal_degrade("recovery failed")
            _tm.gcs_wal_replayed(n_wal)
        if snap is None and n_wal == 0:
            return  # cold start
        # classification AFTER replay, so WAL-recovered actors adopt
        # the same restored-ALIVE liveness probes / reschedule paths as
        # snapshot-recovered ones
        self.named_actors = {}
        for info in self.actors.values():
            if info.name and info.state != ACTOR_DEAD:
                self.named_actors[(info.namespace or "default",
                                   info.name)] = info.actor_id
            if info.state == ACTOR_ALIVE:
                # the worker may have died with the head (or survived on
                # a side node) — probed once the server is up
                self._actors_to_revalidate.append(info)
            elif info.state in (ACTOR_PENDING, ACTOR_RESTARTING):
                # scheduling was in flight when the head died; nothing
                # else will resume it (no node-lost event fires for an
                # actor with no node) — reschedule after startup
                self._actors_to_reschedule.append(info)
        # placement groups: bundles stay committed on surviving raylets;
        # restoring the table keeps lookup/removal working after restart
        # (parity: reference GcsTableStorage persists the PG table too)
        for info in self.placement_groups.values():
            info.scheduling = False
            # retry_at is a monotonic timestamp from the previous boot —
            # meaningless now; reset so pending groups reschedule promptly
            info.retry_at = 0.0
            info.retry_backoff = 0.5
        self._recovery.update(
            restored=True, wal_records_replayed=n_wal,
            actors_recovered=len(self.actors),
            actors_revalidated=len(self._actors_to_revalidate),
            actors_rescheduled=len(self._actors_to_reschedule),
            nodes_expected=len(self._wal_nodes),
            complete=not (self._actors_to_revalidate
                          or self._actors_to_reschedule),
            duration_s=round(time.monotonic() - self._recovery_t0, 3))
        logger.info(
            "GCS restored from %s (+%d WAL records): %d kv namespaces, "
            "%d functions, %d jobs, %d actors",
            self.table_storage.describe(), n_wal, len(self.kv),
            len(self.functions), len(self.jobs), len(self.actors))

    # -- write-ahead log (core/wal.py; docs/ha.md) ---------------------
    def _wal_append(self, rtype: str, data: Any) -> None:
        """Enqueue one typed mutation record.  WAL trouble degrades to
        snapshot-only persistence — the mutation itself never fails."""
        if self.wal is None:
            return
        try:
            self.wal.append(rtype, data)
            _tm.gcs_wal_append()
            if _flight.enabled():
                # WAL position in the ring: a postmortem of a dead GCS
                # shows exactly how far durability had advanced
                _flight.record("wal_append",
                               f"{rtype} n={self.wal.appends} "
                               f"bytes={self.wal.size_bytes}")
        except Exception as e:  # noqa: BLE001 — durability degrades,
            self._wal_degrade(e)  # availability stays
        else:
            if self.wal.size_bytes > int(getattr(
                    self.config, "gcs_wal_compact_bytes", 8 << 20)) \
                    and time.monotonic() - self._persist_failed_ts \
                    >= 1.0:
                # the cooldown matters when store() keeps FAILING (the
                # log can't truncate, so the size check stays true):
                # without it every mutation would retry a synchronous
                # full-table snapshot inline in its handler, collapsing
                # control-plane latency exactly while the storage
                # backend is degraded.  Healthy compactions are
                # untouched — success resets the clock.
                self._compact_now()

    async def _wal_flush(self) -> None:
        """Await durability of every record appended so far — called by
        mutating handlers right before their reply, sharing one
        group-commit fsync per event-loop window."""
        if self.wal is None:
            return
        fsyncs = self.wal.fsyncs
        try:
            await self.wal.flush()
        except Exception as e:  # noqa: BLE001
            self._wal_degrade(e)
        else:
            _tm.gcs_wal_fsync(self.wal.fsyncs - fsyncs)

    def _wal_degrade(self, reason: Any) -> None:
        """Disable the WAL after an append/flush failure: persistence
        falls back to the tight snapshot debounce (0.2 s), counted and
        surfaced so operators see the durability downgrade."""
        if self.wal is None:
            return
        logger.error("GCS WAL degraded to snapshot-only persistence: %s",
                     reason)
        _tm.gcs_wal_append_failure()
        self._emit_event("ERROR", "GCS_WAL_DEGRADED",
                         f"WAL disabled, snapshot-only persistence: "
                         f"{reason}")
        try:
            self.wal.close()
        finally:
            self.wal = None
            self._wal_degraded = True

    def _wal_actor(self, info: ActorInfo) -> None:
        """Full-state actor record (idempotent on replay: last write
        wins, the name index is rederived from state)."""
        self._wal_append("actor", info)

    def _wal_pg(self, pg: PlacementGroupInfo) -> None:
        self._wal_append("pg", pg)

    def _wal_apply(self, rtype: str, data: Any) -> None:
        """Re-apply one replayed record to the in-memory tables.  Every
        record is a full-value set (never a delta), so records the
        snapshot already covers replay to the same state."""
        if rtype == "kv_put":
            ns, key, value, overwrite = data
            d = self.kv.setdefault(ns, {})
            if overwrite or key not in d:
                d[key] = value
        elif rtype == "kv_del":
            ns, key = data
            self.kv.get(ns, {}).pop(key, None)
        elif rtype == "function":
            fid, blob = data
            self.functions[fid] = blob
        elif rtype == "job":
            jid, record, counter = data
            self.jobs[JobID(jid)] = record
            self.job_counter = max(self.job_counter, counter)
        elif rtype == "actor":
            self.actors[data.actor_id] = data
        elif rtype == "pg":
            if data.state == "REMOVED":
                self.placement_groups.pop(data.pg_id, None)
            else:
                self.placement_groups[data.pg_id] = data
        elif rtype == "node":
            self._wal_nodes[data["node_id"]] = data
        elif rtype == "node_dead":
            self._wal_nodes.pop(data["node_id"], None)
            self._node_states.pop(data["node_id"], None)
            # a dead node's lease accounting dies with it — without
            # this, replay resurrects quota charges for capacity that
            # no longer exists (mirror of _mark_node_dead)
            self.lease_tables.pop(data["node_id"].hex(), None)
        elif rtype == "node_state":
            nid, state, reason = data
            if state in (NODE_DRAINING, NODE_DRAINED):
                self._node_states[nid] = {"state": state,
                                          "reason": reason}
            else:  # back to ACTIVE (drain aborted) or released
                self._node_states.pop(nid, None)
        elif rtype == "quota":
            job, quota = data
            if quota is None:
                self.quotas.pop(job, None)
            else:
                self.quotas[job] = quota
        elif rtype == "lease_table":
            node_hex, usage = data
            if usage:
                self.lease_tables[node_hex] = usage
            else:
                self.lease_tables.pop(node_hex, None)
        elif rtype == "incident":
            # full-value set: open and collect both re-WAL the whole
            # incident dict, so replay converges on the latest state
            self._incidents[data["id"]] = data
            self._incidents.move_to_end(data["id"])
            cap = max(4, int(getattr(self.config,
                                     "incident_table_size", 200)))
            while len(self._incidents) > cap:
                self._incidents.popitem(last=False)
        else:
            logger.warning("unknown WAL record type %r skipped", rtype)

    def _persistence_health(self) -> Dict[str, Any]:
        """Backend + WAL health for debug_state / ``ray-tpu status``."""
        ts = self.table_storage
        out: Dict[str, Any] = {
            "backend": ts.describe(),
            "persist_failures": ts.persist_failures,
            "last_persist_age_s": round(
                time.time() - ts.last_persist_ts, 3)
            if ts.last_persist_ts else None,
            "wal_degraded": self._wal_degraded,
        }
        if self.wal is not None:
            out["wal"] = {
                "path": self.wal.path,
                "size_bytes": self.wal.size_bytes,
                "appends": self.wal.appends,
                "fsyncs": self.wal.fsyncs,
                "truncations": self.wal.truncations,
                "sync": self.wal.sync,
            }
        return out

    async def handle_recovery_state(self, conn, data):
        """Restart-recovery / reconvergence snapshot: what was restored
        (snapshot + WAL replay), how many restored actors are still
        being revalidated/rescheduled, and how many of the previous
        incarnation's nodes have re-registered."""
        out = dict(self._recovery)
        out["nodes_reregistered"] = sum(
            1 for nid in self._wal_nodes
            if NodeID(nid) in self.nodes and self.nodes[NodeID(nid)].alive)
        out["actors_alive"] = sum(1 for a in self.actors.values()
                                  if a.state == ACTOR_ALIVE)
        return out

    def _schedule_persist(self) -> None:
        """Debounced snapshot write (coalesces mutation bursts).  With
        a healthy WAL the snapshot is only the compaction base, so the
        debounce can stretch (``gcs_snapshot_debounce_s``); without one
        it is the sole durability tier and stays tight."""
        if self._persist_handle is not None:
            return
        delay = float(getattr(self.config,
                              "gcs_snapshot_debounce_s", 2.0)) \
            if self.wal is not None else 0.2
        loop = asyncio.get_running_loop()
        self._persist_handle = loop.call_later(delay, self._persist_now)

    def _compact_now(self) -> None:
        """WAL grew past gcs_wal_compact_bytes: fold it into the
        snapshot immediately instead of waiting out the debounce."""
        if self._persist_handle is not None:
            self._persist_handle.cancel()
            self._persist_handle = None
        self._persist_now()

    def _persist_now(self) -> None:
        self._persist_handle = None
        actors = [a for a in self.actors.values()
                  if a.state != ACTOR_DEAD]
        pgs = {pid: info for pid, info in self.placement_groups.items()
               if info.state != "REMOVED"}
        ok = self.table_storage.store({
            "kv": self.kv, "functions": self.functions,
            "jobs": self.jobs, "job_counter": self.job_counter,
            "actors": actors,
            "placement_groups": pgs,
            "quotas": self.quotas,
            "lease_tables": self.lease_tables,
            "node_states": self._node_states,
            "incidents": list(self._incidents.values())})
        self._persist_failed_ts = 0.0 if ok else time.monotonic()
        # no awaits since the table reads above: the snapshot is a
        # consistent cut covering every WAL record appended so far, so
        # the log truncates (compaction) — but only against a snapshot
        # that actually landed
        if ok and self.wal is not None:
            try:
                self.wal.truncate()
                # the snapshot does NOT carry node membership (raylets
                # re-register live), so re-seed the reconvergence
                # denominator the truncate just erased: one record per
                # live node.  Direct appends — no size re-check, no
                # flush (membership is advisory; the next handler
                # flush covers it).
                for node in self.nodes.values():
                    if node.alive:
                        self.wal.append("node", {
                            "node_id": node.node_id.binary(),
                            "address": list(node.raylet_address),
                            "resources": node.resources_total,
                            "topology": node.topology})
            except Exception as e:  # noqa: BLE001 — truncate/append
                self._wal_degrade(e)  # trouble degrades, never raises

    async def _revalidate_restored_actors(self) -> None:
        """Probe actors restored ALIVE from the snapshot: a worker that
        survived on a side node keeps serving (and will re-announce via
        actor_started when its own GCS reconnect lands); one that died
        with the head goes through the normal restart-or-dead path."""
        pending, self._actors_to_revalidate = \
            self._actors_to_revalidate, []
        for info in pending:
            alive = False
            if info.address:
                try:
                    conn = await rpc.connect(tuple(info.address),
                                             timeout=3.0)
                    try:
                        await conn.call("ping", {}, timeout=3.0)
                        alive = True
                    finally:
                        conn.close()
                except Exception:  # noqa: BLE001 — unreachable = dead
                    alive = False
            if not alive and info.state == ACTOR_ALIVE:
                self._on_actor_worker_lost(
                    info.actor_id, "worker lost in head restart")

    async def start(self) -> rpc.Address:
        address = await self.server.start()
        if self._actors_to_revalidate or self._actors_to_reschedule:
            async def _delayed_revalidate():
                # give surviving side raylets/workers a beat to re-register
                # before probing, so live actors aren't misjudged
                await asyncio.sleep(2.0)
                resched, self._actors_to_reschedule = \
                    self._actors_to_reschedule, []
                for info in resched:
                    if info.state == ACTOR_ALIVE:
                        # the actor's worker survived the restart and
                        # re-announced (actor_started) during the grace:
                        # rescheduling now would mint a SECOND worker
                        continue
                    t = asyncio.get_running_loop().create_task(
                        self._schedule_actor(info))
                    t.add_done_callback(lambda t: t.exception())
                await self._revalidate_restored_actors()
                self._recovery["complete"] = True
                self._recovery["duration_s"] = round(
                    time.monotonic() - self._recovery_t0, 3)
                _tm.gcs_recovery_duration(self._recovery["duration_s"])
            t = asyncio.get_running_loop().create_task(_delayed_revalidate())
            t.add_done_callback(lambda t: t.exception())
        self._health_task = asyncio.get_running_loop().create_task(
            self._health_check_loop()
        )
        self._pg_retry_task = asyncio.get_running_loop().create_task(
            self._pg_retry_loop()
        )
        self._sync_task = asyncio.get_running_loop().create_task(
            self._resource_sync_loop()
        )
        self._metrics_task = asyncio.get_running_loop().create_task(
            self._metrics_flush_loop()
        )
        if getattr(self.config, "metrics_history_enabled", True):
            self._history_task = asyncio.get_running_loop().create_task(
                self._history_loop()
            )
        # always-on profiling mode: the GCS process samples itself too
        _prof.maybe_start_from_config()
        if getattr(self.config, "event_stats", True):
            from ray_tpu_torch.util.event_stats import HandlerStats, LoopMonitor
            self.server.handler_stats = HandlerStats()
            self._loop_monitor = LoopMonitor("gcs",
                                             self.server.handler_stats)
            self._loop_monitor.start()
        logger.info("GCS listening on %s", address)
        return address

    async def handle_debug_state(self, conn, data):
        """Event-loop lag + per-handler timing snapshot (parity: the
        reference's event_stats / debug_state.txt dump), plus telemetry
        plane health (ring-buffer drops, table sizes)."""
        mon = getattr(self, "_loop_monitor", None)
        out = mon.snapshot() if mon is not None else {}
        out["task_event_drops_total"] = self._task_event_drops_total
        out["task_event_drops"] = dict(self._task_event_drops)
        out["metrics_series"] = len(self._metrics)
        out["spans_buffered"] = len(self._spans)
        out["profile_records"] = len(self._profile)
        out["profile_records_evicted"] = self._profile_evicted
        out["traces"] = len(self._traces)
        out["traces_retained"] = self._traces_retained
        out["traces_sampled_out"] = self._traces_sampled_out
        out["traces_evicted"] = self._traces_evicted
        out["registration_batches"] = self._reg_batches
        out["registration_batch_actors"] = self._reg_batch_actors
        out["persistence"] = self._persistence_health()
        out["recovery"] = dict(self._recovery)
        out["history"] = self._history.stats()
        out["events_evicted"] = self._events_evicted
        out["event_rings"] = {sev: len(ring) for sev, ring
                              in self._event_rings.items()}
        out["incidents"] = len(self._incidents)
        out["incidents_open"] = sum(1 for i in self._incidents.values()
                                    if i["state"] == "open")
        fstats = _flight.stats()
        if fstats is not None:
            out["flight_recorder"] = fstats
        return out

    # -- versioned resource broadcast (parity: ray_syncer.h:27-60 —
    # batched, versioned snapshots of per-node resource views instead of
    # every raylet polling the full node table each heartbeat) ---------
    def _mark_sync_dirty(self, node_id: NodeID) -> None:
        self._sync_dirty.add(node_id)

    def _node_view_entry(self, info: "NodeInfo") -> Dict[str, Any]:
        return {
            "node_id": info.node_id.binary(),
            "address": info.raylet_address,
            "alive": info.alive,
            "resources_total": info.resources_total,
            "resources_available": info.resources_available,
            "topology": info.topology,
            "load": info.load,
            "state": info.state,
        }

    async def _metrics_flush_loop(self) -> None:
        """GCS-local producer half: this process's registry deltas and
        spans fold straight into the cluster tables (no RPC hop).  In
        the head process a co-located raylet also flushes the shared
        registry over RPC — each delta still lands exactly once, since
        ``flush_all`` clears what it returns."""
        from ray_tpu_torch.util import metrics as metrics_mod

        period = max(0.25, getattr(self.config,
                                   "metrics_report_period_s", 5.0))
        while True:
            await asyncio.sleep(min(period, 1.0) if _prof.pending()
                                else period)
            # profile records flush even with metrics disabled (the
            # profiler is armed explicitly; same rule as the worker/
            # raylet loops; trace spans likewise flush independently)
            if not _tm.enabled() and not _prof.pending() \
                    and not _trace.pending():
                continue
            try:
                if self._history_task is None:
                    # history plane off: stale-gauge pruning still has
                    # to happen somewhere periodic (it used to live in
                    # the read handler)
                    self._sweep_stale_metrics()
                if _tm.enabled():
                    _tm.set_gauge(
                        "ray_tpu_gcs_subscriber_channels",
                        "live pubsub channels on the GCS hub",
                        len(self.subscribers))
                    if self.wal is not None:
                        _tm.gcs_wal_size(self.wal.size_bytes)
                    fstats = _flight.stats()
                    if fstats is not None:
                        _tm.flight_frames(fstats["frames_recorded"])
                    _tm.incidents_open(
                        sum(1 for i in self._incidents.values()
                            if i["state"] == "open"))
                    _tm.presample()
                    self._ingest_metrics(metrics_mod.flush_all())
                    spans = _tm.drain_spans("gcs")  # offset 0 by defn
                    if spans:
                        self._spans.extend(spans)
                for tspan in _trace.drain("gcs"):
                    self._ingest_trace_span(tspan)
                profile = _prof.drain()
                if profile:
                    for rec in profile:
                        rec["node"] = "gcs"
                        rec["source"] = "gcs"
                    await self.handle_report_profile(
                        None, {"records": profile})
            except Exception:
                logger.exception("GCS-local metrics flush failed")

    async def _resource_sync_loop(self) -> None:
        period = getattr(self.config, "resource_broadcast_period_s", 0.1)
        while True:
            await asyncio.sleep(period)
            if not self._sync_dirty:
                continue
            dirty, self._sync_dirty = self._sync_dirty, set()
            self._sync_version += 1
            entries = [self._node_view_entry(self.nodes[nid])
                       for nid in dirty if nid in self.nodes]
            self.publish("resource_view", {
                "version": self._sync_version,
                "nodes": entries,
            })

    async def stop(self) -> None:
        if getattr(self, "_sync_task", None):
            self._sync_task.cancel()
        if getattr(self, "_metrics_task", None):
            self._metrics_task.cancel()
        if getattr(self, "_history_task", None):
            self._history_task.cancel()
        if getattr(self, "_loop_monitor", None) is not None:
            self._loop_monitor.stop()
        if self._health_task:
            self._health_task.cancel()
        if self._pg_retry_task:
            self._pg_retry_task.cancel()
        for handle in self._incident_collect_handles.values():
            handle.cancel()
        self._incident_collect_handles.clear()
        await self.server.stop()
        self.pool.close_all()
        if self._persist_handle is not None:
            self._persist_handle.cancel()
            self._persist_handle = None
        if self.wal is not None or self.table_storage.last_persist_ts:
            # final snapshot so a graceful stop leaves a compact state
            # (the WAL covers a SIGKILL; this covers tidy shutdowns)
            try:
                self._persist_now()
            except Exception:  # noqa: BLE001 — shutdown best-effort
                logger.exception("final GCS snapshot failed")
        if self.wal is not None:
            self.wal.close()
        # graceful exit unlinks the ring: a surviving ring for a dead
        # pid then unambiguously means crash (see flight_recorder.py)
        _flight.close(unlink=True)

    # ------------------------------------------------------------------
    # pubsub hub
    # ------------------------------------------------------------------
    def publish(self, channel: str, message: Any) -> None:
        delivered = 0
        for conn in list(self.subscribers.get(channel, ())):
            if conn.closed:
                self.subscribers[channel].discard(conn)
            else:
                conn.push(channel, message)
                delivered += 1
        _tm.gcs_published(channel, delivered)

    async def handle_subscribe(self, conn, data):
        channel = data["channel"]
        self.subscribers.setdefault(channel, set()).add(conn)
        return True

    async def handle_unsubscribe(self, conn, data):
        subs = self.subscribers.get(data["channel"])
        if subs is not None:
            subs.discard(conn)
            if not subs:  # don't accrete empty per-actor channel keys
                del self.subscribers[data["channel"]]
        return True

    async def handle_publish(self, conn, data):
        self.publish(data["channel"], data["message"])
        return True

    def on_disconnection(self, conn) -> None:
        for channel in list(self.subscribers):
            subs = self.subscribers[channel]
            subs.discard(conn)
            if not subs:
                # drop emptied keys: auto-subscribed per-actor channels
                # would otherwise accrete one entry per actor per
                # departed driver
                del self.subscribers[channel]
        node_id = conn.context.get("node_id")
        if node_id is not None and node_id in self.nodes:
            self._mark_node_dead(node_id, "raylet connection lost")
        actor_id = conn.context.get("actor_id")
        if actor_id is not None:
            self._on_actor_worker_lost(actor_id, "actor worker connection lost")

    # ------------------------------------------------------------------
    # node membership + health (GcsNodeManager / GcsHealthCheckManager)
    # ------------------------------------------------------------------
    async def handle_register_node(self, conn, data):
        # failpoint: registration rejected/stalled — the raylet's boot
        # (or its reconnect loop) must retry, keyed on its stable node_id
        await _fp.afailpoint("gcs.register_node.fail")
        peer_proto = data.get("protocol_version", rpc.PROTOCOL_VERSION)
        if peer_proto != rpc.PROTOCOL_VERSION:
            raise rpc.RpcError(
                f"wire protocol mismatch: node speaks v{peer_proto}, "
                f"GCS speaks v{rpc.PROTOCOL_VERSION} — upgrade the "
                f"older side")
        node_id = NodeID(data["node_id"])
        info = NodeInfo(
            node_id=node_id,
            raylet_address=tuple(data["raylet_address"]),
            resources_total=dict(data["resources"]),
            resources_available=dict(data["resources"]),
            topology=data.get("topology", {}),
            max_workers=int(data.get("max_workers", -1)),
            pid=int(data.get("pid", 0)),
        )
        # a node re-registering after a GCS restart resumes the
        # lifecycle state the WAL/snapshot recorded for it — a drain
        # verdict is durable, registration must not silently reactivate
        durable = self._node_states.get(node_id.binary())
        if durable:
            info.state = durable.get("state", NODE_ACTIVE)
            info.drain_reason = durable.get("reason", "")
        self.nodes[node_id] = info
        self._node_conns[node_id] = conn
        conn.context["node_id"] = node_id
        # node record: raylets re-register LIVE after a restart (the
        # node table itself is never restored), but the WAL-carried
        # membership gives the recovery protocol its reconvergence
        # denominator (recovery_state.nodes_expected)
        self._wal_append("node", {"node_id": node_id.binary(),
                                  "address": list(info.raylet_address),
                                  "resources": info.resources_total,
                                  "topology": info.topology})
        self.publish("nodes", {"event": "alive", "node_id": node_id.binary(),
                               "address": info.raylet_address})
        self._mark_sync_dirty(node_id)
        logger.info("node %s registered: %s", node_id.hex()[:12], info.resources_total)
        # hand a raylet registering MID-profiling-window the remaining
        # slice so its node doesn't show up as a gap in the profile
        prof = None
        state = self._profiler_state
        if state and state.get("enabled"):
            deadline = state.get("deadline")
            remaining = None if deadline is None \
                else deadline - time.monotonic()
            if remaining is None or remaining > 0:
                prof = {"enabled": True, "hz": state.get("hz"),
                        "duration_s": remaining}
            else:
                self._profiler_state = None
        return {"config": self.config.to_json(), "profiler": prof,
                "state": info.state, "quotas": dict(self.quotas)}

    async def handle_health_report(self, conn, data):
        # failpoint: a stalled/failed heartbeat ack — raylets must ride
        # it out (miss counter + reconnect), never wedge or false-exit
        await _fp.afailpoint("gcs.heartbeat.delay")
        node_id = NodeID(data["node_id"])
        info = self.nodes.get(node_id)
        if info is None or not info.alive:
            return {"acked": False}  # tells a zombie raylet to exit
        info.last_heartbeat = time.monotonic()
        info.resources_available = dict(data["resources_available"])
        info.load = data.get("load", 0)
        info.pending_demand = list(data.get("pending_demand", []))
        if data.get("node_stats"):
            info.stats = data["node_stats"]
        if "lease_usage" in data:
            # per-job in-flight resource ledger (the raylet's fair-queue
            # ground truth).  WAL'd only on change: the heartbeat path
            # is hot, and replaying the last-known table is enough for a
            # restarted GCS to restore quota accounting exactly-once —
            # the next beat re-reports and converges any tail loss.
            usage = {j: u for j, u in
                     (data.get("lease_usage") or {}).items() if u}
            node_hex = node_id.hex()
            if usage != self.lease_tables.get(node_hex, {}):
                if usage:
                    self.lease_tables[node_hex] = usage
                else:
                    self.lease_tables.pop(node_hex, None)
                self._wal_append("lease_table", (node_hex, usage))
                self._schedule_persist()
        self._mark_sync_dirty(node_id)
        # piggyback the quota table + lifecycle verdict on the ack: a
        # raylet that missed the drain RPC (or re-registered against a
        # restarted GCS) self-corrects within one beat
        return {"acked": True, "state": info.state,
                "quotas": dict(self.quotas)}

    async def handle_get_cluster_load(self, conn, data):
        """Aggregate view for the autoscaler (parity: the monitor reading
        resource load + demand from GCS)."""
        pending_pgs = []
        for pg in self.placement_groups.values():
            if pg.state in ("PENDING", "INFEASIBLE"):
                pending_pgs.append({"strategy": pg.strategy,
                                    "bundles": pg.bundles})
        return {
            "nodes": [
                {"node_id": n.node_id.hex(), "alive": n.alive,
                 "state": n.state,
                 "resources_total": n.resources_total,
                 "resources_available": n.resources_available,
                 "load": n.load}
                for n in self.nodes.values()
            ],
            "pending_demand": [d for n in self.nodes.values() if n.alive
                               for d in n.pending_demand],
            "resource_requests": self._requested_resources(),
            "pending_placement_groups": pending_pgs,
        }

    def _requested_resources(self):
        """Standing ``autoscaler.sdk.request_resources`` bundles (stored
        in internal KV by the SDK; reference autoscaler/sdk/sdk.py:206).
        Reported separately from queued-work demand: the autoscaler
        packs these against TOTAL capacity (a min-cluster-size request,
        not a reservation) and they must not pin unrelated idle
        nodes."""
        import json

        raw = self.kv.get("", {}).get(RESOURCE_REQUEST_KV_KEY)
        if not raw:
            return []
        try:
            return [b for b in json.loads(raw) if isinstance(b, dict)]
        except (ValueError, TypeError):
            return []

    async def handle_get_nodes(self, conn, data):
        return [
            {
                "node_id": n.node_id.binary(),
                "address": n.raylet_address,
                "alive": n.alive,
                "state": n.state,
                "drain_reason": n.drain_reason,
                "resources_total": n.resources_total,
                "resources_available": n.resources_available,
                "topology": n.topology,
                "load": n.load,
                "stats": n.stats,
            }
            for n in self.nodes.values()
        ]

    def _set_node_state(self, info: NodeInfo, new_state: str,
                        reason: str = "") -> None:
        """One lifecycle transition: validated against the matrix,
        WAL'd (durable across a GCS SIGKILL), broadcast on both the
        nodes channel and the versioned resource view."""
        validate_transition(info.state, new_state)
        info.state = new_state
        info.drain_reason = reason
        nid = info.node_id.binary()
        if new_state in (NODE_DRAINING, NODE_DRAINED):
            self._node_states[nid] = {"state": new_state,
                                      "reason": reason}
        else:
            self._node_states.pop(nid, None)
        self._wal_append("node_state", (nid, new_state, reason))
        self._schedule_persist()
        self._mark_sync_dirty(info.node_id)
        _tm.node_drain_transition(new_state)
        self._emit_event(
            "INFO", "NODE_STATE",
            f"node {info.node_id.hex()[:12]} -> {new_state}"
            + (f": {reason}" if reason else ""),
            node_id=info.node_id.hex(), state=new_state)
        self.publish("nodes", {"event": "state", "node_id": nid,
                               "state": new_state})

    async def handle_drain_node(self, conn, data):
        """Graceful node drain (docs/autoscaler.md):

        ACTIVE -> DRAINING (durable)  — the raylet stops taking leases
          -> raylet ``drain`` RPC     — sealed primaries + spill blobs
                                        migrate to ACTIVE peers
        -> DRAINED (durable, success) — safe to terminate, or
        -> ACTIVE  (abort on failure) — the node keeps serving.

        ``force=True`` keeps the PR-≤15 semantics (immediate removal,
        used for crash simulation and last-resort eviction)."""
        node_id = NodeID(data["node_id"])
        reason = data.get("reason", "drained")
        info = self.nodes.get(node_id)
        if data.get("force") or info is None or not info.alive \
                or self.config.drain_timeout_s <= 0:
            self._mark_node_dead(node_id, reason)
            return {"drained": True, "forced": True}
        if info.state == NODE_DRAINED:
            return {"drained": True, "migrated": 0}  # idempotent retry
        if node_id in self._drains_inflight:
            return {"drained": False, "error": "drain in progress"}
        if info.state == NODE_ACTIVE:
            self._set_node_state(info, NODE_DRAINING, reason)
            await self._wal_flush()  # verdict durable before migrating
        # else: WAL-restored DRAINING after a GCS restart — re-enter
        self._drains_inflight.add(node_id)
        try:
            peers = [{"node_id": n.node_id.binary(),
                      "address": list(n.raylet_address)}
                     for n in self.nodes.values()
                     if n.alive and n.state == NODE_ACTIVE
                     and n.node_id != node_id]
            reply: Dict[str, Any] = {}
            err = None
            try:
                # failpoint: the migration leg fails — the drain must
                # ABORT and the node must return to ACTIVE, still
                # serving (acceptance: an aborted migration leaves the
                # node in service, never half-drained)
                _fp.failpoint("gcs.node_drain.migrate_fail")
                node_conn = self._node_conns.get(node_id)
                if node_conn is None:
                    raise RuntimeError("no raylet connection")
                reply = await node_conn.call(
                    "drain", {"peers": peers, "reason": reason},
                    timeout=self.config.drain_timeout_s) or {}
                if not reply.get("ok"):
                    raise RuntimeError(
                        reply.get("error", "raylet drain failed"))
            except Exception as e:  # noqa: BLE001 — abort the drain
                err = str(e) or type(e).__name__
            if err is not None:
                if info.alive and info.state == NODE_DRAINING:
                    self._set_node_state(info, NODE_ACTIVE,
                                         f"drain aborted: {err}")
                    await self._wal_flush()
                logger.warning("drain of node %s aborted: %s",
                               node_id.hex()[:12], err)
                return {"drained": False, "error": err}
            if not info.alive:  # died mid-migration
                return {"drained": False, "error": "node died mid-drain"}
            self._set_node_state(info, NODE_DRAINED, reason)
            await self._wal_flush()
            return {"drained": True,
                    "migrated": reply.get("migrated", 0),
                    "spill_handed_off": reply.get("spill_handed_off", 0)}
        finally:
            self._drains_inflight.discard(node_id)

    # ------------------------------------------------------------------
    # per-job quota table (fair-queue weights + in-flight ceilings)
    # ------------------------------------------------------------------
    async def handle_set_job_quota(self, conn, data):
        """Install/update/remove one job's scheduling quota.  The table
        is WAL- and snapshot-covered; raylets learn within one beat via
        the health-report ack (plus an immediate pubsub nudge)."""
        job = data["job"]
        quota = data.get("quota")
        if quota is None:
            self.quotas.pop(job, None)
        else:
            # normalize through JobQuota so malformed payloads fail
            # here, at the API boundary, not inside a raylet
            self.quotas[job] = JobQuota.from_dict(quota).to_dict()
        self._wal_append("quota", (job, self.quotas.get(job)))
        self._schedule_persist()
        await self._wal_flush()
        self.publish("quotas", {"quotas": dict(self.quotas)})
        return True

    async def handle_get_job_quotas(self, conn, data):
        return {"quotas": dict(self.quotas),
                "lease_tables": {n: dict(t)
                                 for n, t in self.lease_tables.items()}}

    def _event_append(self, record: Dict[str, Any]) -> None:
        """Route one event record into its severity's retention ring,
        counting displaced records (the old single shared ring let an
        INFO flood silently evict the ERROR evidence incidents need)."""
        sev = record.get("severity") or "INFO"
        ring = self._event_rings.get(sev)
        if ring is None:
            from collections import deque as _deque
            cap = max(16, int(getattr(self.config,
                                      "event_ring_size", 5000)))
            ring = self._event_rings[sev] = _deque(maxlen=cap)
        if len(ring) == ring.maxlen:
            self._events_evicted += 1
            _tm.events_evicted(1)
        ring.append(record)

    def _emit_event(self, severity: str, label: str, message: str,
                    **fields: Any) -> None:
        self._event_append(
            self._event_mod.emit(severity, label, message, **fields))

    def push_cluster_events(self, conn, record) -> None:
        """Event records pushed by raylets/workers (see util/event.py)."""
        self._event_append(record)

    async def handle_list_events(self, conn, data):
        severity = (data or {}).get("severity")
        limit = (data or {}).get("limit", 1000)
        if severity is not None:
            out = list(self._event_rings.get(severity, ()))
        else:
            out = sorted(
                (e for ring in self._event_rings.values() for e in ring),
                key=lambda e: e.get("timestamp", 0.0))
        return out[-limit:]

    # ------------------------------------------------------------------
    # incident journal (docs/observability.md "Incidents and
    # postmortems"): auto-opened on deaths / firing alerts, linked into
    # the other observability planes, WAL-persisted like alerts
    # ------------------------------------------------------------------
    def _open_or_merge_incident(self, kind: str, title: str,
                                severity: str = "error",
                                node: Optional[str] = None,
                                job: Optional[str] = None,
                                deployment: Optional[str] = None
                                ) -> Dict[str, Any]:
        """One incident per failure episode: a death/alert within
        ``incident_window_s`` of the newest incident's last update
        folds into it (a gang death is one incident, not N), otherwise
        a new incident opens.  Both paths WAL the full incident and
        (re)arm the delayed link collection."""
        now = time.time()
        window_s = float(getattr(self.config, "incident_window_s",
                                 120.0))
        inc: Optional[Dict[str, Any]] = None
        if self._incidents:
            newest = next(reversed(self._incidents.values()))
            if now - newest["last_update"] <= window_s:
                inc = newest
        if inc is None:
            inc = {
                "id": f"inc-{os.urandom(6).hex()}",
                "kind": kind, "title": title, "severity": severity,
                "opened_at": now, "last_update": now,
                "state": "open",
                # the window opens a beat early: the evidence that
                # explains a death precedes it
                "window": [now - 30.0, None],
                "nodes": [], "jobs": [], "deployments": [],
                "deaths": [], "alerts": [], "partial": False,
                "links": {},
            }
            cap = max(4, int(getattr(self.config,
                                     "incident_table_size", 200)))
            while len(self._incidents) >= cap:
                old_id, _ = self._incidents.popitem(last=False)
                self._incident_collect_handles.pop(old_id, None)
            self._incidents[inc["id"]] = inc
            _tm.incident_opened(kind)
            self._emit_event(
                "ERROR" if severity == "error" else "WARNING",
                "INCIDENT_OPEN", f"incident {inc['id']}: {title}",
                incident_id=inc["id"], kind=kind)
            logger.warning("incident %s opened: %s", inc["id"], title)
        else:
            inc["last_update"] = now
            if severity == "error":
                inc["severity"] = "error"
        if node and node not in inc["nodes"]:
            inc["nodes"].append(node)
        if job and job not in inc["jobs"]:
            inc["jobs"].append(job)
        if deployment and deployment not in inc["deployments"]:
            inc["deployments"].append(deployment)
        _flight.record("mark", f"incident {inc['id']}: {title}")
        self._incident_wal(inc)
        self._schedule_incident_collect(inc["id"])
        return inc

    def _incident_wal(self, inc: Dict[str, Any]) -> None:
        self._wal_append("incident", dict(inc))
        self._schedule_persist()

    def _incident_add_death(self, inc: Dict[str, Any], source: str,
                            pid: int, node: Optional[str], reason: str,
                            frames: List[Dict[str, Any]], torn: int,
                            partial: bool) -> None:
        """Attach one dead process's identity + flight tail.  The
        ``gcs.incident.collect_fail`` failpoint models the tail being
        lost mid-death-notification: the death entry still lands (the
        incident opens regardless), only the frames are gone and the
        incident is marked partial — the death path never wedges."""
        if _fp.active() and _fp.failpoint("gcs.incident.collect_fail"):
            frames, torn, partial = [], 0, True
        for d in inc["deaths"]:
            if d["pid"] == pid and d["source"] == source:
                if frames and not d["frames"]:
                    d["frames"], d["torn"] = frames, torn
                    d["partial"] = partial
                return
        inc["deaths"].append({
            "source": source, "pid": pid, "node": node,
            "reason": reason, "frames": frames, "torn": torn,
            "partial": partial, "ts": time.time()})
        if partial:
            inc["partial"] = True
        if frames:
            _tm.flight_tail_shipped(1)

    def _schedule_incident_collect(self, inc_id: str) -> None:
        """(Re)arm the delayed link-collection pass: it runs one flush
        period after the incident last moved, so the traces/metrics the
        episode produced have reached the GCS tables before we snapshot
        the links."""
        settle = float(getattr(self.config, "metrics_report_period_s",
                               5.0)) + 2.0
        old = self._incident_collect_handles.pop(inc_id, None)
        if old is not None:
            old.cancel()
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # unit tests building a GCS outside a loop
        def _fire() -> None:
            self._incident_collect_handles.pop(inc_id, None)
            t = loop.create_task(self._collect_incident(inc_id))
            t.add_done_callback(lambda t: t.exception())
        self._incident_collect_handles[inc_id] = loop.call_later(
            settle, _fire)

    async def _collect_incident(self, inc_id: str) -> None:
        """Fill the incident's links into the other planes: retained
        traces in the window, the firing-alert set, metrics-history
        slices, profiler/recovery state.  Re-runs on merge; every pass
        re-WALs the full incident (full-value set semantics)."""
        inc = self._incidents.get(inc_id)
        if inc is None:
            return
        try:
            now = time.time()
            since = inc["window"][0]
            traces = []
            for trace_id, entry in reversed(self._traces.items()):
                if entry.get("keep") is False:
                    continue
                row = self._trace_summary(trace_id, entry)
                if (row["start"] or 0.0) >= since:
                    traces.append(row)
                if len(traces) >= 50:
                    break
            series = {}
            for name in ("cluster:alive_nodes", "cluster:actors_alive"):
                rows = self._history.query(series=name, since=since)
                if rows:
                    series[name] = rows[0].get("points", [])
            inc["window"][1] = now
            inc["links"] = {
                "trace_ids": [t["trace_id"] for t in traces],
                "traces": traces,
                "alerts_firing": self._history.firing(),
                "timeseries": series,
                "profile_records": len(self._profile),
                "recovery": dict(self._recovery),
            }
            inc["state"] = "collected"
            self._incident_wal(inc)
        except Exception:  # noqa: BLE001 — forensics never wedges
            logger.exception("incident %s link collection failed",
                             inc_id)
            inc["partial"] = True
            inc["state"] = "collected"
            self._incident_wal(inc)

    # replay-safe by construction, not by a seq guard: a retried
    # delivery merges into the incident it just opened (same episode
    # window) and _incident_add_death dedupes on (source, pid), so the
    # INCIDENT_OPEN event emits at most once per episode
    # rtpu-check: disable=retry-safety
    async def handle_report_flight_tail(self, conn, data):
        """Death-notification path: a surviving raylet (or the head
        supervisor) shipped a dead process's flight-ring tail.  Opens
        or merges an incident; the tail attach is failpoint-gated but
        the incident itself always lands."""
        source = data["source"]
        pid = int(data["pid"])
        reason = data.get("reason") or "process died"
        node = data.get("node_id")
        node_hex = node.hex() if isinstance(node, bytes) else node
        inc = self._open_or_merge_incident(
            "death", f"{source} (pid {pid}) died: {reason}",
            node=node_hex)
        self._incident_add_death(
            inc, source, pid, node_hex, reason,
            list(data.get("frames") or []), int(data.get("torn") or 0),
            partial=not data.get("frames"))
        self._incident_wal(inc)
        await self._wal_flush()
        return {"incident_id": inc["id"]}

    @staticmethod
    def _incident_summary(inc: Dict[str, Any]) -> Dict[str, Any]:
        return {
            "id": inc["id"], "kind": inc["kind"], "title": inc["title"],
            "severity": inc["severity"], "state": inc["state"],
            "opened_at": inc["opened_at"],
            "last_update": inc["last_update"],
            "partial": inc.get("partial", False),
            "nodes": list(inc["nodes"]), "jobs": list(inc["jobs"]),
            "deployments": list(inc["deployments"]),
            "n_deaths": len(inc["deaths"]),
            "n_alerts": len(inc["alerts"]),
            "n_traces": len((inc.get("links") or {}).get("trace_ids",
                                                         ())),
        }

    async def handle_list_incidents(self, conn, data):
        data = data or {}
        kind = data.get("kind")
        limit = int(data.get("limit") or 50)
        out = [self._incident_summary(inc)
               for inc in reversed(self._incidents.values())
               if kind is None or inc["kind"] == kind]
        return out[:limit]

    async def handle_get_incident(self, conn, data):
        inc_id = data["incident_id"]
        inc = self._incidents.get(inc_id)
        if inc is None:
            # prefix match (CLI convenience, like trace ids)
            for iid, candidate in reversed(self._incidents.items()):
                if iid.startswith(inc_id):
                    inc = candidate
                    break
        return dict(inc) if inc is not None else None

    def _read_dead_raylet_ring(self, inc: Dict[str, Any],
                               info: "NodeInfo", reason: str) -> None:
        """Same-host node death: the GCS itself reads the dead raylet's
        ring from the session dir (there is no surviving raylet on that
        node to ship it)."""
        if not info.pid or not self._session_dir:
            return
        try:
            for path in _flight.rings_for_pid(self._session_dir,
                                              info.pid):
                tail = _flight.read_ring(path)
                if tail is not None:
                    self._incident_add_death(
                        inc, tail["source"], info.pid,
                        info.node_id.hex(), reason,
                        tail["frames"][-200:], tail["torn"],
                        partial=False)
                try:
                    os.unlink(path)
                except OSError:
                    pass
        except Exception:  # noqa: BLE001 — forensics never wedges
            logger.exception("dead raylet ring read failed")
            inc["partial"] = True

    def _mark_node_dead(self, node_id: NodeID, reason: str) -> None:
        info = self.nodes.get(node_id)
        if info is None or not info.alive:
            return
        info.alive = False
        info.state = NODE_DEAD
        info.resources_available = {}
        self._node_conns.pop(node_id, None)
        # the node_dead record also clears any durable drain verdict
        # and lease table on replay (_wal_apply) — mirror in memory
        self._node_states.pop(node_id.binary(), None)
        self.lease_tables.pop(node_id.hex(), None)
        self._wal_append("node_dead", {"node_id": node_id.binary()})
        _tm.node_death()
        logger.warning("node %s dead: %s", node_id.hex()[:12], reason)
        self._mark_sync_dirty(node_id)
        self._emit_event("ERROR", "NODE_DEAD",
                         f"node {node_id.hex()[:12]} dead: {reason}",
                         node_id=node_id.hex())
        _flight.record("node_dead",
                       f"{node_id.hex()[:12]} {reason}")
        # incident journal: a node death always opens (or joins) an
        # incident; the dead raylet's own flight ring is read here —
        # no surviving process on that node will ship it
        try:
            inc = self._open_or_merge_incident(
                "death", f"node {node_id.hex()[:12]} dead: {reason}",
                node=node_id.hex())
            self._read_dead_raylet_ring(inc, info, reason)
            self._incident_wal(inc)
        except Exception:  # noqa: BLE001 — never wedge the death path
            logger.exception("incident open failed for node death")
        # failpoint: the death broadcast is lost — consumers must
        # converge via the versioned resource-view sync (gap → resync)
        # instead of trusting one pubsub delivery
        if not _fp.failpoint("gcs.node_death.publish_drop"):
            self.publish("nodes",
                         {"event": "dead", "node_id": node_id.binary(),
                          "address": info.raylet_address})
        # fail actors on the node (restart if budget remains)
        for actor in list(self.actors.values()):
            if actor.node_id == node_id and actor.state in (ACTOR_ALIVE,
                                                            ACTOR_PENDING):
                self._on_actor_worker_lost(actor.actor_id,
                                           f"node died: {reason}")
        # placement groups with bundles there must be rescheduled
        for pg in self.placement_groups.values():
            if pg.state == "CREATED" and node_id in pg.bundle_nodes.values():
                pg.state = "RESCHEDULING"
                asyncio.get_running_loop().create_task(self._schedule_pg(pg))

    async def _health_check_loop(self) -> None:
        while True:
            await asyncio.sleep(self.config.health_report_period_s)
            now = time.monotonic()
            for node in list(self.nodes.values()):
                if node.alive and (now - node.last_heartbeat
                                   > self.config.health_timeout_s):
                    self._mark_node_dead(node.node_id, "health check timeout")

    # ------------------------------------------------------------------
    # KV store (GcsInternalKVManager)
    # ------------------------------------------------------------------
    async def handle_kv_put(self, conn, data):
        ns_name = data.get("namespace", "")
        ns = self.kv.setdefault(ns_name, {})
        existed = data["key"] in ns
        overwrite = data.get("overwrite", True)
        if overwrite or not existed:
            ns[data["key"]] = data["value"]
            self._wal_append("kv_put", (ns_name, data["key"],
                                        data["value"], overwrite))
        self._schedule_persist()
        await self._wal_flush()  # the ack promises durability
        return existed

    async def handle_kv_get(self, conn, data):
        return self.kv.get(data.get("namespace", ""), {}).get(data["key"])

    async def handle_kv_del(self, conn, data):
        ns_name = data.get("namespace", "")
        ns = self.kv.get(ns_name, {})
        existed = ns.pop(data["key"], None) is not None
        if existed:
            self._wal_append("kv_del", (ns_name, data["key"]))
        self._schedule_persist()
        await self._wal_flush()
        return existed

    async def handle_kv_keys(self, conn, data):
        ns = self.kv.get(data.get("namespace", ""), {})
        prefix = data.get("prefix", "")
        return [k for k in ns if k.startswith(prefix)]

    # ------------------------------------------------------------------
    # function table (GcsFunctionManager)
    # ------------------------------------------------------------------
    async def handle_register_function(self, conn, data):
        self.functions[data["function_id"]] = data["blob"]
        self._wal_append("function", (data["function_id"], data["blob"]))
        self._schedule_persist()
        await self._wal_flush()
        return True

    async def handle_get_function(self, conn, data):
        return self.functions.get(data["function_id"])

    # ------------------------------------------------------------------
    # jobs (GcsJobManager)
    # ------------------------------------------------------------------
    def _wal_job(self, job_id: JobID) -> None:
        job = self.jobs.get(job_id)
        if job is not None:
            self._wal_append("job", (job_id.binary(), dict(job),
                                     self.job_counter))

    async def handle_register_job(self, conn, data):
        self.job_counter += 1
        job_id = JobID.from_int(self.job_counter)
        self.jobs[job_id] = {"start_time": time.time(),
                             "driver_address": data.get("driver_address"),
                             "alive": True}
        self._wal_job(job_id)
        self._schedule_persist()
        await self._wal_flush()  # the id is live the moment we reply
        return {"job_id": job_id.binary()}

    async def handle_reattach_job(self, conn, data):
        """A driver reconnecting after a head restart re-announces its
        (persisted) job instead of minting a new id."""
        job_id = JobID(data["job_id"])
        job = self.jobs.get(job_id)
        if job is None:
            # snapshot predates the job (e.g. memory storage): recreate
            job = {"start_time": time.time()}
            self.jobs[job_id] = job
            self.job_counter = max(self.job_counter, job_id.int_value())
        job["alive"] = True
        job["driver_address"] = data.get("driver_address")
        self._wal_job(job_id)
        self._schedule_persist()
        await self._wal_flush()
        return {"job_id": job_id.binary()}

    async def handle_job_finished(self, conn, data):
        job_id = JobID(data["job_id"])
        job = self.jobs.get(job_id)
        if job:
            job["alive"] = False
            job["end_time"] = time.time()
            self._wal_job(job_id)
        self._schedule_persist()
        await self._wal_flush()
        return True

    # ------------------------------------------------------------------
    # task events (state API feed; parity: TaskEventBuffer -> GCS)
    # ------------------------------------------------------------------
    async def handle_report_task_events(self, conn, data):
        seq = data.get("seq")
        if seq is not None:
            # the pool re-sends this method after a timed-out ack
            # (IDEMPOTENT_METHODS), but extend/counter folds below do
            # NOT converge on replay — drop any batch at or below the
            # reporting worker's high-water flush seq
            src = data.get("source") or ""
            if self._task_event_seq.get(src, -1) >= seq:
                return True
            self._task_event_seq[src] = seq
        self._task_events.extend(data["events"])
        # monotonic counter for the metrics surface: the ring buffer
        # rotates, so counting FINISHED entries in it is not a counter
        self._tasks_finished_total += sum(
            1 for e in data["events"] if e.get("state") == "FINISHED")
        overflow = len(self._task_events) - self.config.task_events_buffer_size
        if overflow > 0:
            # ring-buffer eviction is DATA LOSS for the state API —
            # count it per job and surface it (debug_state, metrics)
            # instead of deleting silently
            for ev in self._task_events[:overflow]:
                job = ev.get("job_id") or "unknown"
                self._task_event_drops[job] = \
                    self._task_event_drops.get(job, 0) + 1
                _tm.task_events_dropped(job, 1)
            self._task_event_drops_total += overflow
            del self._task_events[:overflow]
            now = time.monotonic()
            if not self._drop_burst_started or \
                    now - self._drop_burst_started > 10.0:
                # log once per overflow burst, not once per batch — a
                # sustained storm would otherwise flood the log
                if self._drop_burst_count:
                    logger.warning(
                        "previous task-event overflow burst dropped %d "
                        "events", self._drop_burst_count)
                logger.warning(
                    "task-event buffer full (%d): dropping oldest events "
                    "(per-job counts in debug_state; raise "
                    "task_events_buffer_size to keep more)",
                    self.config.task_events_buffer_size)
                self._drop_burst_count = 0
            self._drop_burst_started = now
            self._drop_burst_count += overflow
        return True

    # ------------------------------------------------------------------
    # metrics aggregation (parity: MetricsAgent / OpenCensus proxy
    # collector metrics_agent.py:188,374 — here the GCS is the hub)
    # ------------------------------------------------------------------
    def _ingest_metrics(self, records) -> None:
        """Fold one process's flush batch into the cluster table:
        counters/histograms accumulate, gauges replace.  ``_ts`` stamps
        each entry so stale gauges (dead workers' last values) age out
        of the export instead of lingering forever."""
        now = time.monotonic()
        for rec in records:
            key = (rec["name"], tuple(sorted(rec.get("tags", {}).items())))
            cur = self._metrics.get(key)
            if rec["type"] == "counter":
                if cur is None:
                    cur = dict(rec)
                else:
                    cur["value"] += rec["value"]
            elif rec["type"] == "gauge":
                cur = dict(rec)
            elif rec["type"] == "histogram":
                if cur is None:
                    cur = dict(rec)
                else:
                    cur["buckets"] = [a + b for a, b in
                                      zip(cur["buckets"], rec["buckets"])]
                    cur["sum"] += rec["sum"]
                    cur["count"] += rec["count"]
                    if rec.get("exemplars"):
                        # per-bucket exemplars: newest flush wins
                        ex = dict(cur.get("exemplars") or {})
                        ex.update(rec["exemplars"])
                        cur["exemplars"] = ex
            else:
                continue
            cur["_ts"] = now
            self._metrics[key] = cur

    #: gauges older than this stop being exported (their process is gone
    #: or stopped flushing); cumulative series are kept forever
    _GAUGE_STALE_S = 120.0

    async def handle_report_metrics(self, conn, data):
        seq = data.get("seq")
        if seq is not None:
            # counters/histograms ACCUMULATE in _ingest_metrics, so a
            # replayed flush (retry after a lost ack) double-counts —
            # drop batches at or below the source's high-water seq
            src = data.get("source") or ""
            if self._metric_seq.get(src, -1) >= seq:
                return True
            self._metric_seq[src] = seq
        self._ingest_metrics(data.get("records", []))
        return True

    def _sweep_stale_metrics(self) -> None:
        """Periodic stale-gauge pruning (a dead process's last value
        must age out of the export).  Lives on the history tick — NOT
        in the read handler, which used to delete entries mid-iteration
        and would race the history sampler reading the same table."""
        now = time.monotonic()
        for key, rec in list(self._metrics.items()):
            if rec["type"] == "gauge" and \
                    now - rec.get("_ts", now) > self._GAUGE_STALE_S:
                del self._metrics[key]

    async def handle_get_metrics(self, conn, data):
        # side-effect free (stale pruning happens in the periodic
        # sweep): a read RPC must never mutate the table other readers
        # and the history sampler iterate
        return [{k: v for k, v in rec.items() if k != "_ts"}
                for rec in self._metrics.values()]

    # ------------------------------------------------------------------
    # metrics history + alerting (core/metrics_history.py)
    # ------------------------------------------------------------------
    async def _history_loop(self) -> None:
        """Sample tick of the cluster health plane: prune stale gauges,
        fold the merged table into the history rings, re-evaluate
        recording + alert rules, publish transitions, persist the
        firing set.  A failed sample tick (failpoint
        ``gcs.metrics_history.sample_fail``) skips the fold only — the
        evaluator still runs, so alerting survives ingest trouble."""
        hist = self._history
        while True:
            await asyncio.sleep(hist.interval_s)
            now = time.time()
            try:
                self._sweep_stale_metrics()
                try:
                    if _fp.failpoint("gcs.metrics_history.sample_fail"):
                        raise _fp.FailpointError(
                            "gcs.metrics_history.sample_fail")
                    hist.sample(self._metrics, now=now)
                    # tick-local cluster gauges: these must not depend
                    # on any process's flush loop being alive
                    hist.observe("cluster:alive_nodes", sum(
                        1 for n in self.nodes.values() if n.alive), now)
                    hist.observe("cluster:actors_alive", sum(
                        1 for a in self.actors.values()
                        if a.state == ACTOR_ALIVE), now)
                except Exception:  # noqa: BLE001 — skip, never wedge
                    hist.sample_failures += 1
                    _tm.history_sample_failure()
                transitions = hist.evaluate(now=now)
                st = hist.stats()
                _tm.history_stats(
                    st["points"], st["series"],
                    hist.evicted_total - self._history_evicted_reported)
                self._history_evicted_reported = hist.evicted_total
                _tm.alerts_stats(st["alerts_firing"], len(transitions))
                if transitions:
                    self._on_alert_transitions(transitions)
            except asyncio.CancelledError:
                raise
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("metrics history tick failed")

    def _on_alert_transitions(self, transitions) -> None:
        """Publish each transition on the ``alerts`` channel + event
        log, then persist the new firing set so it survives a head
        restart (the WAL record rides the next handler group-commit)."""
        import json as _json

        for t in transitions:
            self.publish("alerts", t)
            sev = "INFO" if t["to"] == "resolved" else (
                "ERROR" if t["severity"] == "critical" else "WARNING")
            tag_txt = " ".join(f"{k}={v}"
                               for k, v in sorted(t["tags"].items()))
            self._emit_event(
                sev, "ALERT_" + t["to"].upper(),
                f"alert {t['rule']} {t['from']} -> {t['to']}"
                + (f" ({tag_txt})" if tag_txt else "")
                + (f" value={t['value']:.4g}"
                   if t.get("value") is not None else ""),
                rule=t["rule"], **t["tags"])
        blob = _json.dumps(self._history.export_firing()).encode()
        self.kv.setdefault("_internal", {})[ALERTS_FIRING_KV_KEY] = blob
        self._wal_append("kv_put", ("_internal", ALERTS_FIRING_KV_KEY,
                                    blob, True))
        self._schedule_persist()
        for t in transitions:
            _flight.record("alert",
                           f"{t['rule']} {t['from']} -> {t['to']}")
        # incident journal: a firing transition opens (or joins) an
        # incident; re-WALed with the transition attached
        firing = [t for t in transitions if t["to"] == "firing"]
        if firing:
            try:
                sev = "error" if any(t["severity"] == "critical"
                                     for t in firing) else "warning"
                inc = self._open_or_merge_incident(
                    "alert",
                    "alert firing: " + ", ".join(
                        sorted({t["rule"] for t in firing})),
                    severity=sev)
                inc["alerts"].extend(firing)
                self._incident_wal(inc)
            except Exception:  # noqa: BLE001 — alerting must survive
                logger.exception("incident open failed for alerts")

    async def handle_get_timeseries(self, conn, data):
        data = data or {}
        return self._history.query(
            series=data.get("series"), since=data.get("since"),
            limit=int(data.get("limit") or 200))

    async def handle_get_alerts(self, conn, data):
        out = self._history.alerts_view()
        out["stats"] = self._history.stats()
        return out

    async def handle_healthz(self, conn, data):
        """One-word cluster verdict for probes: ``ok`` (nothing
        firing), ``degraded`` (warnings firing or persistence
        degraded), ``critical`` (a critical alert is firing)."""
        firing = self._history.firing()
        critical = [a["rule"] for a in firing
                    if a["severity"] == "critical"]
        degraded = bool(firing) or self._wal_degraded \
            or self.table_storage.persist_failures > 0
        status = "critical" if critical else (
            "degraded" if degraded else "ok")
        open_incidents = [i for i in self._incidents.values()
                          if i["state"] == "open"]
        return {
            "ok": not critical,
            "status": status,
            "firing": [a["rule"] for a in firing],
            "alive_nodes": sum(1 for n in self.nodes.values()
                               if n.alive),
            "wal_degraded": self._wal_degraded,
            "persist_failures": self.table_storage.persist_failures,
            "incidents": len(self._incidents),
            "incidents_open": len(open_incidents),
            "last_incident": next(
                reversed(self._incidents.values()))["id"]
            if self._incidents else None,
        }

    async def handle_report_spans(self, conn, data):
        self._spans.extend(data.get("spans", []))
        return True

    async def handle_get_spans(self, conn, data):
        limit = (data or {}).get("limit")
        if limit is None:
            limit = 20000
        if limit <= 0:  # out[-0:] would be the WHOLE table
            return []
        cat = (data or {}).get("cat")
        out = [s for s in self._spans if cat is None or s.get("cat") == cat]
        return out[-limit:]

    async def handle_clock_sync(self, conn, data):
        """Timebase for span alignment: reporters NTP-probe this and
        correct their span timestamps onto the GCS wall clock."""
        return {"time": time.time()}

    # ------------------------------------------------------------------
    # distributed tracing plane (core/tracing.py -> trace ring)
    # ------------------------------------------------------------------
    def _tail_keep(self, trace_id: str, root: Dict[str, Any]) -> bool:
        """Tail-sampling decision, made at trace COMPLETION (the root
        span's arrival), never at ingress: anything anomalous is kept
        in full, fast successes keep a deterministic fraction (hash of
        the trace id, so every process agrees without coordination).
        ``unknown_deployment`` (bad URLs) is client junk, not an
        anomaly — it samples like a success so scanners can't evict
        the real SLO-miss evidence from the bounded ring."""
        if root.get("status", "ok") not in ("ok", "unknown_deployment"):
            return True
        tags = root.get("tags") or {}
        if tags.get("slo_miss") or tags.get("retried"):
            return True
        frac = float(getattr(self.config,
                             "trace_sample_keep_fraction", 0.05))
        if frac >= 1.0:
            return True
        if frac <= 0.0:
            return False
        try:
            return (int(trace_id[:8], 16) % 10000) < frac * 10000
        except ValueError:
            return True  # unhashable id: keep rather than lose signal

    def _note_trace_evicted(self, trace_id: str) -> None:
        if len(self._trace_evicted_ids) >= 8192:
            self._trace_evicted_set.discard(
                self._trace_evicted_ids.popleft())
        self._trace_evicted_ids.append(trace_id)
        self._trace_evicted_set.add(trace_id)

    def _trace_entry(self, trace_id: str) -> Dict[str, Any]:
        entry = self._traces.get(trace_id)
        if entry is None:
            cap = max(16, int(getattr(self.config,
                                      "trace_table_size", 2000)))
            while len(self._traces) >= cap:
                old_id, old = self._traces.popitem(last=False)
                self._note_trace_evicted(old_id)
                if old.get("spans") or old.get("keep") is None:
                    self._traces_evicted += 1
                    _tm.trace_evicted(1)
            entry = self._traces[trace_id] = {
                "spans": [], "keep": None, "root": None,
                "first": time.time(), "truncated": 0}
        return entry

    def _ingest_trace_span(self, span: Dict[str, Any]) -> None:
        trace_id = span.get("trace_id")
        if not trace_id:
            return
        if trace_id not in self._traces \
                and trace_id in self._trace_evicted_set:
            return  # straggler of an evicted trace: gone is gone
        entry = self._trace_entry(trace_id)
        if entry["keep"] is False:
            return  # sampled out: stragglers drop against the tombstone
        if len(entry["spans"]) >= self._trace_span_cap \
                and not span.get("root"):
            # the root is load-bearing (tail-sampling decision, tree
            # anchor, telescoping) — it lands even past the cap
            entry["truncated"] += 1
        else:
            entry["spans"].append(span)
        if span.get("root"):
            entry["root"] = span
            keep = self._tail_keep(trace_id, span)
            entry["keep"] = keep
            if keep:
                self._traces_retained += 1
                _tm.trace_retained(1)
            else:
                entry["spans"] = []
                self._traces_sampled_out += 1
                _tm.trace_sampled_out(1)

    async def handle_report_trace_spans(self, conn, data):
        # failpoint: the trace ingest drops a batch — reporters must not
        # notice (drop-don't-block); only the assembled tree is poorer
        if _fp.active() and _fp.failpoint("gcs.report_spans.trace_drop"):
            return True
        spans = data.get("spans", [])
        _tm.trace_spans_ingested(len(spans))
        for span in spans:
            self._ingest_trace_span(span)
        return True

    def _find_trace(self, trace_id: str
                    ) -> Tuple[Optional[str], Optional[Dict[str, Any]]]:
        entry = self._traces.get(trace_id)
        if entry is not None:
            return trace_id, entry
        # prefix match (CLI convenience: ids print truncated)
        for tid, e in self._traces.items():
            if tid.startswith(trace_id):
                return tid, e
        return None, None

    @staticmethod
    def _trace_summary(trace_id: str, entry: Dict[str, Any]
                       ) -> Dict[str, Any]:
        root = entry.get("root")
        tags = (root or {}).get("tags") or {}
        return {
            "trace_id": trace_id,
            "name": root.get("name") if root else None,
            "status": root.get("status") if root else "incomplete",
            "start": root.get("start") if root
            else entry.get("first"),
            "duration_s": (root["end"] - root["start"]) if root else None,
            "deployment": tags.get("deployment"),
            "slo_miss": bool(tags.get("slo_miss")),
            "retried": bool(tags.get("retried")),
            "n_spans": len(entry.get("spans", [])),
            "complete": root is not None,
        }

    async def handle_get_trace(self, conn, data):
        trace_id, entry = self._find_trace(data["trace_id"])
        if entry is None:
            return None
        if entry.get("keep") is False:
            return {"trace_id": trace_id, "sampled_out": True,
                    "spans": []}
        spans = sorted(entry["spans"], key=lambda s: s.get("start", 0.0))
        out = self._trace_summary(trace_id, entry)
        out["spans"] = spans
        out["truncated_spans"] = entry.get("truncated", 0)
        return out

    async def handle_list_traces(self, conn, data):
        data = data or {}
        deployment = data.get("deployment")
        slo_only = bool(data.get("slo_misses"))
        since = data.get("since")
        until = data.get("until")
        limit = data.get("limit") or 100
        out = []
        for trace_id, entry in reversed(self._traces.items()):
            if entry.get("keep") is False:
                continue
            row = self._trace_summary(trace_id, entry)
            if deployment is not None \
                    and row["deployment"] != deployment:
                continue
            if slo_only and not (row["slo_miss"]
                                 or (row["complete"]
                                     and row["status"] != "ok")):
                continue
            if since is not None and (row["start"] or 0.0) < since:
                continue
            if until is not None and (row["start"] or 0.0) > until:
                continue
            out.append(row)
            if len(out) >= limit:
                break
        return out

    # ------------------------------------------------------------------
    # continuous profiling plane (core/profiler.py)
    # ------------------------------------------------------------------
    async def handle_report_profile(self, conn, data):
        # failpoint: the profile ingest drops a batch — the reporter
        # must not notice (drop-don't-block), only the ring is poorer
        if _fp.active() and _fp.failpoint("gcs.report_profile.drop"):
            return True
        records = data.get("records", [])
        overflow = len(self._profile) + len(records) \
            - (self._profile.maxlen or 0)
        if overflow > 0:
            # deque eviction is silent data loss for get_profile —
            # count it (debug_state + metrics) like task-event drops
            self._profile_evicted += overflow
            _tm.profiler_records_evicted(overflow)
        self._profile.extend(records)
        return True

    async def handle_get_profile(self, conn, data):
        """Merged profile view: fold every reporting process's records
        into one (stack, task, job)-keyed count table (the cluster
        flamegraph), optionally filtered by job / node / window."""
        from ray_tpu_torch.core import profiler as profiler_mod

        data = data or {}
        job = data.get("job")
        node = data.get("node")
        since = data.get("since")
        limit = data.get("limit") or 10000
        rows = [r for r in self._profile
                if (job is None or r.get("job") == job)
                and (node is None
                     or (r.get("node") or "").startswith(node))
                and (since is None or r.get("end", 0) >= since)]
        sources = sorted({(r.get("node"), r.get("pid"))
                          for r in rows})
        merged = profiler_mod.merge_records(rows)[:limit]
        return {"records": merged,
                "total_samples": sum(r.get("count", 0) for r in merged),
                "sources": [{"node": n, "pid": p} for n, p in sources],
                "raw_records": len(rows)}

    async def handle_profiler_control(self, conn, data):
        """Arm/disarm the cluster profiling window: applies to the GCS
        process itself, then fans out to every alive raylet (each
        raylet fans out to its own workers)."""
        from ray_tpu_torch.core import profiler as profiler_mod

        enabled = bool(data["enabled"])
        hz = data.get("hz")
        duration = data.get("duration_s")
        profiler_mod.configure(enabled, hz=hz, duration_s=duration)
        self._profiler_state = {
            "enabled": enabled, "hz": hz,
            "deadline": (time.monotonic() + float(duration)
                         if enabled and duration else None),
        } if enabled else None

        async def one(node):
            conn2 = self._node_conns.get(node.node_id)
            if conn2 is None or conn2.closed:
                return None
            try:
                return await asyncio.wait_for(
                    conn2.call("profiler_control", data), 10.0)
            except Exception:  # noqa: BLE001 — best-effort fan-out
                return None
        replies = await asyncio.gather(
            *(one(n) for n in list(self.nodes.values()) if n.alive))
        applied = [r for r in replies if r]
        return {"nodes_applied": len(applied),
                "workers_applied": sum(r.get("workers_applied", 0)
                                       for r in applied)}

    async def handle_list_jobs(self, conn, data):
        return [{"job_id": jid.hex(), **{k: v for k, v in j.items()}}
                for jid, j in self.jobs.items()]

    async def handle_get_task_events(self, conn, data):
        """Task-event rows, newest-last.  ``job_id``/``state`` filters
        and the limit apply HERE so consumers (state API list_tasks,
        the analyzer) stop shipping the whole ring over the wire and
        filtering client-side."""
        data = data or {}
        limit = data.get("limit", 1000)
        job_id = data.get("job_id")
        state = data.get("state")
        if job_id is None and state is None:
            return self._task_events[-limit:]
        out = [ev for ev in self._task_events
               if (job_id is None or ev.get("job_id") == job_id)
               and (state is None or ev.get("state") == state)]
        return out[-limit:]

    async def handle_get_cluster_stats(self, conn, data):
        """Cheap scalar gauges for the metrics surface (one dict, not a
        thousand event rows per scrape)."""
        return {
            "tasks_finished_total": self._tasks_finished_total,
            "alive_nodes": sum(1 for n in self.nodes.values() if n.alive),
            "actors_alive": sum(1 for a in self.actors.values()
                                if a.state == ACTOR_ALIVE),
            "task_event_drops_total": self._task_event_drops_total,
            "task_event_drops": dict(self._task_event_drops),
        }

    # ------------------------------------------------------------------
    # actor manager (GcsActorManager + GcsActorScheduler)
    # ------------------------------------------------------------------
    def _register_one_actor(self, conn, data
                            ) -> Tuple[Dict[str, Any],
                                       Optional[ActorInfo]]:
        """Table mutation of one actor registration (shared by the
        single and batched handlers).  Returns ``(reply, info)`` where
        ``info`` is the freshly-registered actor the caller must
        schedule, or ``None`` (replayed/existing registration — nothing
        to schedule).  A name conflict raises ``ValueError``.

        Idempotent keyed on ``actor_id``: a replayed registration (a
        retried batch whose first attempt executed but lost its reply)
        converges on the existing directory entry instead of minting a
        second creation task.
        """
        actor_id = ActorID(data["actor_id"])
        prior = self.actors.get(actor_id)
        if prior is not None:
            # replay: re-subscribe the (possibly reconnected) owner and
            # ack with the existing entry — never re-schedule
            self.subscribers.setdefault(
                f"actor:{actor_id.hex()}", set()).add(conn)
            return ({"existing": False, "actor_id": actor_id.binary(),
                     "subscribed": True}, None)
        name = data.get("name")
        namespace = data.get("namespace", "default")
        if name is not None:
            key = (namespace, name)
            existing_id = self.named_actors.get(key)
            if existing_id is not None and existing_id != actor_id:
                existing = self.actors.get(existing_id)
                if existing is not None and existing.state != ACTOR_DEAD:
                    if data.get("get_if_exists"):
                        return ({"existing": True,
                                 "actor_id": existing_id.binary()}, None)
                    raise ValueError(
                        f"actor name {name!r} already taken in {namespace!r}")
            self.named_actors[key] = actor_id
        info = ActorInfo(
            actor_id=actor_id,
            name=name,
            namespace=namespace,
            detached=data.get("detached", False),
            max_restarts=data.get("max_restarts", 0),
            creation_spec_blob=data["spec_blob"],
            resources=dict(data.get("resources", {})),
            owner_job=JobID(data["job_id"]),
            class_name=data.get("class_name", ""),
            pg_id=PlacementGroupID(data["placement_group_id"])
            if data.get("placement_group_id") else None,
            bundle_index=data.get("bundle_index", -1),
            strategy=data.get("strategy") or "DEFAULT",
            strategy_node=data.get("strategy_node"),
            strategy_soft=bool(data.get("strategy_soft", False)),
            env_hash=data.get("env_hash"),
            env_spawn=data.get("env_spawn"),
            locality=data.get("locality"),
        )
        self.actors[actor_id] = info
        # typed WAL record BEFORE the reply can leave (the handler
        # flushes): a registration acked into the snapshot debounce
        # window must survive an immediate SIGKILL, or the registration storm
        # retry converges onto an entry that no longer exists
        self._wal_actor(info)
        self._schedule_persist()
        # auto-subscribe the registering owner to the actor's channel:
        # its submitter needs the ALIVE address anyway, and the explicit
        # subscribe + get_actor round trips cost two driver-side RTTs
        # PER ACTOR during creation storms
        self.subscribers.setdefault(
            f"actor:{actor_id.hex()}", set()).add(conn)
        return ({"existing": False, "actor_id": actor_id.binary(),
                 "subscribed": True}, info)

    async def handle_register_actor(self, conn, data):
        """Register + schedule an actor creation.

        ``data``: actor_id, creation spec blob (pickled TaskSpec),
        resources, name/namespace/detached, max_restarts, class_name.
        """
        # failpoint: GCS stalls/crashes mid-registration — the owner's
        # register future must resolve with a typed error or the retry
        # must converge on ONE directory entry (keyed on actor_id)
        await _fp.afailpoint("gcs.register_actor.stall")
        # traced registrations (the payload carried "trace", re-activated
        # by rpc dispatch) get a gcs.register_actor hop span
        _hop = _trace.start_span("gcs.register_actor")
        try:
            reply, info = self._register_one_actor(conn, data)
        except ValueError:
            if _hop is not None:
                _hop.end(status="error", outcome="name_conflict")
            raise
        if info is not None:
            self._spawn_schedule_task(info)
        if _hop is not None:
            _hop.end(outcome="existing" if reply.get("existing")
                     else None, actor=ActorID(data["actor_id"]).hex()[:12])
        await self._wal_flush()  # ack promises a durable registration
        return reply

    async def handle_register_actor_batch(self, conn, data):
        """Coalesced registration: one RPC registers a whole creation
        burst, then the batch schedules as ONE pipelined bring-up
        (node selection up front, lease fan-out grouped per raylet)
        instead of N independent lease round trips.

        Per-entry semantics match ``register_actor`` exactly — name
        conflicts become per-entry ``{"error": ...}`` replies so one
        bad entry cannot fail its batch-mates; replayed entries (the
        idempotent-retry case) ack against the existing directory
        entry without re-scheduling.
        """
        # failpoint: the batch is lost before ANY table mutation — the
        # owner's idempotent retry (keyed on actor_id) must converge on
        # exactly one directory entry per actor
        if _fp.active() and await _fp.afailpoint(
                "gcs.register_actor_batch.drop"):
            return None
        seq = data.get("seq")
        src = data.get("source") or ""
        if seq is not None:
            cached = self._reg_batch_acks.get(src)
            if cached is not None and cached[0] == seq:
                # replayed batch (the sender retries on a lost ack):
                # each entry is a keyed upsert already, but re-running
                # would double-count the batch telemetry and re-spawn
                # the scheduling task — re-serve the first pass's
                # replies verbatim
                return {"replies": cached[1]}
        entries = data["actors"]
        replies: List[Dict[str, Any]] = []
        to_schedule: List[ActorInfo] = []
        for entry in entries:
            # per-entry trace carrier: a traced creation inside a batch
            # still gets its gcs.register_actor hop span.  The context
            # is reset after the entry so one traced creation cannot
            # leak its attribution over batch-mates (or the shared
            # scheduling task spawned below)
            _hop = _tok = None
            if _trace.enabled() and entry.get("trace") is not None:
                _tok = _trace.set_current(_trace.ctx_of(entry["trace"]))
                _hop = _trace.start_span("gcs.register_actor")
            try:
                try:
                    reply, info = self._register_one_actor(conn, entry)
                except ValueError as e:
                    replies.append({"actor_id": entry["actor_id"],
                                    "error": str(e)})
                    if _hop is not None:
                        _hop.end(status="error", outcome="name_conflict")
                    continue
                replies.append(reply)
                if info is not None:
                    to_schedule.append(info)
                if _hop is not None:
                    _hop.end(outcome="existing" if reply.get("existing")
                             else None)
            finally:
                if _tok is not None:
                    _trace.reset_current(_tok)
        _tm.sched_registration_batch(len(entries))
        self._reg_batches += 1
        self._reg_batch_actors += len(entries)
        if to_schedule:
            t = asyncio.get_running_loop().create_task(
                self._schedule_actor_batch(to_schedule))
            t.add_done_callback(lambda t: t.exception())
        # ONE group-commit flush covers the whole batch's records: a
        # registration storm pays one fsync per batch, not per actor
        await self._wal_flush()
        if seq is not None:
            self._reg_batch_acks[src] = (seq, replies)
        return {"replies": replies}

    def _publish_actor(self, info: ActorInfo) -> None:
        # every published transition also reaches the durable table: the
        # snapshot persists the FULL actor table, so a detached-only gate
        # would leave non-detached actors stale across a head restart.
        # The WAL record is enqueued here (sync transition paths cannot
        # await); client-facing handlers flush before replying
        self._wal_actor(info)
        self._schedule_persist()
        channel = f"actor:{info.actor_id.hex()}"
        self.publish(channel, self._actor_message(info))
        if info.state == ACTOR_DEAD:
            # DEAD is terminal — nothing will be published here again.
            # Dropping the channel now (not at subscriber disconnect)
            # keeps a long-lived driver churning short-lived actors from
            # accreting one auto-subscribed entry per dead actor
            self.subscribers.pop(channel, None)

    def _actor_message(self, info: ActorInfo) -> Dict[str, Any]:
        return {
            "actor_id": info.actor_id.binary(),
            "state": info.state,
            "address": info.address,
            "node_id": info.node_id.binary() if info.node_id else None,
            "num_restarts": info.num_restarts,
            "death_cause": info.death_cause,
        }

    async def _schedule_actor(self, info: ActorInfo) -> None:
        """Pick a node, lease a worker there, push the creation task.

        Parity: GcsActorScheduler::Schedule (gcs_actor_scheduler.cc:49).
        """
        lock = self._actor_creation_locks.setdefault(info.actor_id,
                                                     asyncio.Lock())
        async with lock:
            deadline = time.monotonic() + 120.0
            while time.monotonic() < deadline:
                if info.state == ACTOR_DEAD:
                    return
                if info.state == ACTOR_ALIVE:
                    # a worker already announced (actor_started) —
                    # e.g. one that survived a head restart and
                    # re-registered while this reschedule task was
                    # pending, or a lease whose reply was lost but
                    # whose worker came up.  Leasing again would mint
                    # a SECOND living copy of the actor.
                    return
                pg = self.placement_groups.get(info.pg_id) \
                    if info.pg_id else None
                if info.pg_id is not None:
                    # gang-bound: the bundle's node is the only candidate,
                    # and the lease is charged to the bundle's reservation
                    # (the node pool already paid for it at prepare time)
                    if pg is None or pg.state == "REMOVED":
                        info.state = ACTOR_DEAD
                        info.death_cause = "placement group removed"
                        self._publish_actor(info)
                        return
                    if pg.state != "CREATED":
                        # placement in progress has its own retry loop —
                        # don't burn the lease deadline on it; but an
                        # INFEASIBLE group keeps the fixed deadline so the
                        # actor eventually dies with a diagnostic instead
                        # of pending forever
                        if pg.state != "INFEASIBLE":
                            deadline = time.monotonic() + 120.0
                        await asyncio.sleep(0.25)
                        continue
                    if info.bundle_index >= 0:
                        node_id = pg.bundle_nodes.get(info.bundle_index)
                    else:
                        node_id = next(iter(pg.bundle_nodes.values()), None)
                    node = self.nodes.get(node_id) if node_id else None
                    if node is None or not node.alive:
                        await asyncio.sleep(0.2)
                        continue
                else:
                    node = self._pick_node(info.resources,
                                           strategy=info.strategy,
                                           strategy_node=info.strategy_node,
                                           strategy_soft=info.strategy_soft,
                                           locality=getattr(
                                               info, "locality", None))
                    if node is None:
                        await asyncio.sleep(0.2)  # wait for resources/nodes
                        continue
                # in-flight lease accounting: health-beat load is ~1s
                # stale, so a creation burst would pile onto whichever
                # node looked least loaded at the last beat; counting
                # our own unresolved leases spreads the burst across
                # raylets (parity: GcsActorScheduler's inflight
                # bookkeeping, gcs_actor_scheduler.cc:49).  The charge is
                # held until the actor actually STARTS (actor_started /
                # creation_failed), not merely until the lease RPC
                # returns — a granted-but-still-initializing actor
                # occupies no beat-reported load, so releasing at RPC
                # return erased the spread benefit for bursts larger
                # than the grant-latency window.
                self._charge_actor_lease(info.actor_id, node.node_id)
                try:
                    conn = await self.pool.get(node.raylet_address)
                    reply = await conn.call(
                        "lease_worker_for_actor",
                        {"actor_id": info.actor_id.binary(),
                         "resources": info.resources,
                         "spec_blob": info.creation_spec_blob,
                         "placement_group_id":
                             info.pg_id.binary() if info.pg_id else None,
                         "bundle_index": info.bundle_index,
                         "env_hash": info.env_hash,
                         "env_spawn": info.env_spawn},
                        timeout=60.0,
                    )
                except (rpc.ConnectionLost, rpc.RpcError, OSError,
                        asyncio.TimeoutError) as e:
                    logger.warning("actor lease on %s failed: %s",
                                   node.node_id.hex()[:12], e)
                    self._release_actor_lease_charge(info.actor_id)
                    await asyncio.sleep(0.2)
                    continue
                if not reply.get("granted"):
                    self._release_actor_lease_charge(info.actor_id)
                    await asyncio.sleep(0.1)
                    continue
                await self._settle_actor_grant(info, node, reply)
                return
            self._release_actor_lease_charge(info.actor_id)
            info.state = ACTOR_DEAD
            info.death_cause = "creation timed out: no feasible node"
            self._publish_actor(info)

    def _spawn_schedule_task(self, info: ActorInfo) -> None:
        t = asyncio.get_running_loop().create_task(
            self._schedule_actor(info))
        t.add_done_callback(lambda t: t.exception())

    async def _schedule_actor_batch(self, infos: List[ActorInfo]) -> None:
        """Pipelined bring-up of a registration batch: node selection
        for every actor happens UP FRONT (in-flight lease charges
        applied as assigned, so the spread logic sees its own batch),
        then leases + creation pushes fan out as ONE
        ``lease_workers_for_actors`` RPC per target raylet, all raylets
        in parallel — instead of one awaited round trip per actor.

        Anything the fast path cannot place (gang-bound, no feasible
        node yet, mid-batch failures) falls back to the per-actor
        retry loop ``_schedule_actor``, which owns the 120 s deadline
        and all the slow-path edge cases.
        """
        by_node: Dict[NodeID, List[ActorInfo]] = {}
        for info in infos:
            if info.state in (ACTOR_DEAD, ACTOR_ALIVE):
                continue  # ALIVE: its worker already announced
            if info.pg_id is not None:
                # gang-bound: bundle placement has its own wait loop
                self._spawn_schedule_task(info)
                continue
            node = self._pick_node(
                info.resources, strategy=info.strategy,
                strategy_node=info.strategy_node,
                strategy_soft=info.strategy_soft,
                locality=getattr(info, "locality", None))
            if node is None:
                self._spawn_schedule_task(info)  # waits for capacity
                continue
            self._charge_actor_lease(info.actor_id, node.node_id)
            by_node.setdefault(node.node_id, []).append(info)
        if not by_node:
            return
        await asyncio.gather(*(self._lease_actor_group(node_id, group)
                               for node_id, group in by_node.items()))

    async def _lease_actor_group(self, node_id: NodeID,
                                 group: List[ActorInfo]) -> None:
        """One batched lease+create RPC against one raylet; per-actor
        failures re-enter the single-actor retry loop."""
        node = self.nodes.get(node_id)

        def _fallback(info: ActorInfo) -> None:
            self._release_actor_lease_charge(info.actor_id)
            if info.state != ACTOR_DEAD:
                self._spawn_schedule_task(info)
        if node is None or not node.alive:
            for info in group:
                _fallback(info)
            return
        try:
            conn = await self.pool.get(node.raylet_address)
            reply = await conn.call(
                "lease_workers_for_actors",
                {"actors": [
                    {"actor_id": info.actor_id.binary(),
                     "resources": info.resources,
                     "spec_blob": info.creation_spec_blob,
                     "placement_group_id": None,
                     "bundle_index": -1,
                     "env_hash": info.env_hash,
                     "env_spawn": info.env_spawn}
                    for info in group]},
                timeout=120.0)
            results = {bytes(r["actor_id"]): r
                       for r in (reply or {}).get("results", [])}
        except (rpc.ConnectionLost, rpc.RpcError, OSError,
                asyncio.TimeoutError) as e:
            # OSError included: a raylet that died inside the
            # heartbeat-lag window refuses the CONNECT itself — the
            # whole group must fall back, not strand PENDING with its
            # lease charges leaked
            logger.warning("batched actor lease on %s failed: %s",
                           node_id.hex()[:12], e)
            for info in group:
                _fallback(info)
            return
        for info in group:
            res = results.get(info.actor_id.binary())
            if not res or not res.get("granted"):
                _fallback(info)
                continue
            await self._settle_actor_grant(info, node, res)

    async def _settle_actor_grant(self, info: ActorInfo,
                                  node: "NodeInfo",
                                  reply: Dict[str, Any]) -> None:
        """Post-grant settle shared by the single and batched bring-up
        paths.  Killed while the lease was in flight: don't resurrect
        — reap the leased worker (pg-bound workers are reaped by
        bundle revocation; plain actors need the explicit kill or the
        worker and its resources leak).  Otherwise record placement
        and publish ALIVE, deduped against the worker's own
        ``actor_started`` announcement (usually first)."""
        if info.state == ACTOR_DEAD:
            self._release_actor_lease_charge(info.actor_id)
            try:
                worker_conn = await self.pool.get(
                    tuple(reply["worker_task_address"]))
                worker_conn.push(
                    "kill_actor",
                    {"actor_id": info.actor_id.binary()})
            except Exception:
                pass
            return
        addr = tuple(reply["worker_task_address"])
        if info.state == ACTOR_ALIVE and info.address == addr:
            info.node_id = node.node_id
            return  # actor_started already announced this address
        if info.state == ACTOR_ALIVE and info.address is not None:
            # the actor already has a DIFFERENT living worker (e.g. a
            # pre-restart lease's worker re-announced while a recovery
            # reschedule was in flight): this grant is surplus — reap
            # it, or two processes run the actor and one leaks
            self._release_actor_lease_charge(info.actor_id)
            logger.warning(
                "actor %s: surplus creation grant on %s reaped (already "
                "alive at %s)", info.actor_id.hex()[:12],
                node.node_id.hex()[:12], info.address)
            try:
                worker_conn = await self.pool.get(addr)
                worker_conn.push("kill_actor",
                                 {"actor_id": info.actor_id.binary()})
            except Exception:  # noqa: BLE001 — best-effort reap
                pass
            return
        info.node_id = node.node_id
        info.address = addr
        info.state = ACTOR_ALIVE
        self._publish_actor(info)

    def _charge_actor_lease(self, actor_id: ActorID,
                            node_id: NodeID) -> None:
        self._release_actor_lease_charge(actor_id)  # re-schedule safety
        self._actor_lease_charges[actor_id] = node_id
        self._actor_lease_inflight[node_id] = \
            self._actor_lease_inflight.get(node_id, 0) + 1

    def _release_actor_lease_charge(self, actor_id: ActorID) -> None:
        node_id = self._actor_lease_charges.pop(actor_id, None)
        if node_id is None:
            return
        n_in = self._actor_lease_inflight.get(node_id, 1)
        if n_in <= 1:
            self._actor_lease_inflight.pop(node_id, None)
        else:
            self._actor_lease_inflight[node_id] = n_in - 1

    def _pick_node(self, resources: Dict[str, float],
                   required_node: Optional[NodeID] = None,
                   strategy: str = "DEFAULT",
                   strategy_node: Optional[str] = None,
                   strategy_soft: bool = False,
                   locality: Optional[List[str]] = None
                   ) -> Optional[NodeInfo]:
        """Least-loaded feasible node (actors spread by default); load
        counts this GCS's own unresolved actor leases on top of the
        beat-reported queue so creation bursts fan out immediately.

        ``strategy`` refines the pick: NODE_AFFINITY restricts to the
        named node (``strategy_soft`` falls back to any feasible node
        when it is gone/full), SPREAD ranks by live-actor count so
        sequentially created replicas fan across nodes instead of
        piling onto whichever node's beat-reported load looked lowest
        (equal-load ties broke to the same node every time).

        ``locality``: raylet addresses of nodes already holding the
        creation args' objects (owner-reported).  A DEFAULT-strategy
        pick gives them a soft bonus on the load rank — the creation
        task's arg fetch is then a local arena read instead of a
        cross-node transfer — but load still wins once the holder
        accrues charges, so a burst sharing one arg spreads.
        SPREAD/NODE_AFFINITY ignore the hint: an explicit placement
        intent beats a data-locality preference."""
        if strategy == "NODE_AFFINITY" and strategy_node and \
                required_node is None:
            try:
                required_node = NodeID(bytes.fromhex(strategy_node))
            except ValueError:
                logger.warning("NODE_AFFINITY node id %r is not valid "
                               "hex", strategy_node)
                if not strategy_soft:
                    # a HARD pin must never silently land elsewhere:
                    # stay pending (creation times out with a
                    # diagnostic) rather than violate the pin
                    return None
                required_node = None
        candidates = []
        for node in self.nodes.values():
            if not node.alive or node.state != NODE_ACTIVE:
                # DRAINING/DRAINED nodes finish what they hold but take
                # no new placements — even a hard NODE_AFFINITY pin
                # pends (the drain either completes or aborts shortly)
                continue
            if node.max_workers == 0 and required_node is None:
                # dedicated control node (e.g. a 0-CPU HA head): it can
                # never spawn a worker, so even a 0-resource actor
                # would pend there forever
                continue
            if required_node is not None and node.node_id != required_node:
                continue
            if all(node.resources_available.get(k, 0.0) >= v
                   for k, v in resources.items()):
                candidates.append(node)
        if not candidates:
            if required_node is not None and strategy_soft:
                return self._pick_node(resources)
            return None
        loc: set = set()
        if locality and strategy == "DEFAULT":
            # owner-reported raylet addresses of nodes holding the
            # creation args: a SOFT tie-break bonus on the load rank,
            # never a hard filter — a whole burst sharing one plasma
            # arg must still spread once the holder accrues charges
            # (a hard narrow collapsed fleets onto the arg's node)
            loc = {tuple(a) for a in locality
                   if isinstance(a, (list, tuple))}
        if strategy == "SPREAD":
            per_node: Dict[NodeID, int] = {}
            for other in self.actors.values():
                if other.state == ACTOR_ALIVE and other.node_id is not None:
                    per_node[other.node_id] = \
                        per_node.get(other.node_id, 0) + 1
            return min(candidates, key=lambda n: (
                per_node.get(n.node_id, 0)
                + self._actor_lease_inflight.get(n.node_id, 0),
                n.load))
        return min(candidates,
                   key=lambda n: n.load + self._actor_lease_inflight.get(
                       n.node_id, 0)
                   - (1 if tuple(n.raylet_address) in loc else 0))

    async def handle_actor_started(self, conn, data):
        """The actor worker reports in after executing its creation task."""
        actor_id = ActorID(data["actor_id"])
        conn.context["actor_id"] = actor_id
        self._release_actor_lease_charge(actor_id)
        info = self.actors.get(actor_id)
        if info is None:
            return False
        if info.state == ACTOR_DEAD:
            return False  # killed while starting (e.g. pg removed)
        info.address = tuple(data["task_address"])
        info.state = ACTOR_ALIVE
        self._publish_actor(info)
        await self._wal_flush()
        return True

    async def handle_actor_creation_failed(self, conn, data):
        actor_id = ActorID(data["actor_id"])
        self._on_actor_worker_lost(actor_id, data.get("reason", "creation failed"),
                                   allow_restart=False)
        await self._wal_flush()
        return True

    async def handle_get_actor(self, conn, data):
        if "name" in data:
            key = (data.get("namespace", "default"), data["name"])
            actor_id = self.named_actors.get(key)
            if actor_id is None:
                return None
        else:
            actor_id = ActorID(data["actor_id"])
        info = self.actors.get(actor_id)
        if info is None:
            return None
        msg = self._actor_message(info)
        msg["class_name"] = info.class_name
        msg["name"] = info.name
        return msg

    async def handle_list_actors(self, conn, data):
        return [dict(self._actor_message(a), name=a.name,
                     class_name=a.class_name)
                for a in self.actors.values()]

    async def handle_kill_actor(self, conn, data):
        actor_id = ActorID(data["actor_id"])
        info = self.actors.get(actor_id)
        if info is None:
            return False
        info.max_restarts = 0  # no_restart semantics
        if info.address is not None:
            try:
                worker_conn = await self.pool.get(info.address)
                worker_conn.push("kill_actor", {"actor_id": actor_id.binary()})
            except Exception:
                pass
        self._on_actor_worker_lost(actor_id, "killed via kill_actor",
                                   allow_restart=False)
        await self._wal_flush()  # an acked kill must not resurrect
        return True

    def _on_actor_worker_lost(self, actor_id: ActorID, reason: str,
                              allow_restart: bool = True) -> None:
        self._release_actor_lease_charge(actor_id)
        info = self.actors.get(actor_id)
        if info is None or info.state == ACTOR_DEAD:
            return
        # incident journal: an actor worker lost to a crash is a death
        # episode whether or not a restart saves it (the shipped flight
        # tail of the dead worker merges into the same incident)
        try:
            self._open_or_merge_incident(
                "death",
                f"actor {actor_id.hex()[:12]} "
                f"({info.class_name or 'unknown'}) worker lost: "
                f"{reason}",
                job=info.owner_job.hex() if info.owner_job else None)
        except Exception:  # noqa: BLE001 — never wedge the death path
            logger.exception("incident open failed for actor death")
        if allow_restart and info.num_restarts < info.max_restarts:
            info.num_restarts += 1
            info.state = ACTOR_RESTARTING
            info.address = None
            info.node_id = None
            self._publish_actor(info)
            logger.info("restarting actor %s (%d/%d): %s",
                        actor_id.hex()[:12], info.num_restarts,
                        info.max_restarts, reason)
            self._emit_event(
                "WARNING", "ACTOR_RESTARTING",
                f"actor {actor_id.hex()[:12]} restarting "
                f"({info.num_restarts}/{info.max_restarts}): {reason}",
                actor_id=actor_id.hex(), class_name=info.class_name)
            asyncio.get_running_loop().create_task(self._schedule_actor(info))
        else:
            info.state = ACTOR_DEAD
            info.death_cause = reason
            info.address = None
            self._emit_event(
                "ERROR", "ACTOR_DEAD",
                f"actor {actor_id.hex()[:12]} dead: {reason}",
                actor_id=actor_id.hex(), class_name=info.class_name)
            self._publish_actor(info)
            if info.name is not None:
                self.named_actors.pop((info.namespace, info.name), None)

    # ------------------------------------------------------------------
    # placement groups (GcsPlacementGroupManager/Scheduler, 2-phase)
    # ------------------------------------------------------------------
    async def handle_create_placement_group(self, conn, data):
        pg = PlacementGroupInfo(
            pg_id=PlacementGroupID(data["pg_id"]),
            bundles=[dict(b) for b in data["bundles"]],
            strategy=data.get("strategy", "PACK"),
            name=data.get("name"),
        )
        self.placement_groups[pg.pg_id] = pg
        self._wal_pg(pg)
        await self._schedule_pg(pg)
        self._schedule_persist()
        await self._wal_flush()
        return {"state": pg.state}

    async def handle_placement_group_ready(self, conn, data):
        """Current PG state; with ``block_s`` > 0, long-poll: the reply
        is held until the group reaches CREATED/REMOVED (or the block
        window closes).  One RPC replaces the client-side sleep loop
        whose fixed poll interval quantized create+wait latency."""
        pg_id = PlacementGroupID(data["pg_id"])
        pg = self.placement_groups.get(pg_id)
        if pg is None:
            return {"state": "REMOVED"}
        block_s = float(data.get("block_s") or 0.0)
        if block_s > 0:
            loop = asyncio.get_running_loop()
            deadline = loop.time() + min(block_s, 30.0)
            while pg.state not in ("CREATED", "REMOVED"):
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                ev = self._pg_waiters.setdefault(pg_id, asyncio.Event())
                try:
                    await asyncio.wait_for(ev.wait(), remaining)
                except asyncio.TimeoutError:
                    break
        return {"state": pg.state,
                "bundle_nodes": {i: n.binary()
                                 for i, n in pg.bundle_nodes.items()}}

    async def handle_list_placement_groups(self, conn, data):
        return [
            {"pg_id": pg.pg_id.binary(), "state": pg.state,
             "strategy": pg.strategy, "bundles": pg.bundles,
             "name": pg.name,
             "bundle_nodes": {i: n.binary()
                              for i, n in pg.bundle_nodes.items()}}
            for pg in self.placement_groups.values()
        ]

    async def handle_remove_placement_group(self, conn, data):
        pg = self.placement_groups.get(PlacementGroupID(data["pg_id"]))
        if pg is None:
            return False
        # terminal state BEFORE any await so concurrent _schedule_actor /
        # _schedule_pg loops observe REMOVED and cannot re-lease against
        # the group while bundles are being returned
        pg.state = "REMOVED"
        self._wake_pg_waiters(pg.pg_id)
        targets = [(i, self.nodes.get(n)) for i, n in pg.bundle_nodes.items()]
        pg.bundle_nodes.clear()
        # actors gang-bound to the group die with it, through the common
        # death path (clears named_actors; never restarts); their worker
        # processes are killed by the raylets' return_bundle path
        for info in list(self.actors.values()):
            if info.pg_id == pg.pg_id and info.state != ACTOR_DEAD:
                self._on_actor_worker_lost(info.actor_id,
                                           "placement group removed",
                                           allow_restart=False)
        await self._return_bundles(pg, targets)
        self.publish(f"pg:{pg.pg_id.hex()}", {"state": "REMOVED"})
        self._wal_pg(pg)
        self._schedule_persist()
        await self._wal_flush()
        return True

    async def _pg_retry_loop(self) -> None:
        """Reschedule unplaced groups as resources free up.

        Parity: GcsPlacementGroupManager's pending queue + retry on
        resource change (gcs_placement_group_manager.h:221) — raylet
        resource views are refreshed by health reports, so a group that
        failed placement (e.g. a previous gang's resources not yet
        returned) becomes placeable moments later.
        """
        while True:
            await asyncio.sleep(0.25)
            now = time.monotonic()
            for pg in list(self.placement_groups.values()):
                if pg.state not in ("PENDING", "INFEASIBLE", "RESCHEDULING"):
                    continue
                if now < pg.retry_at:
                    continue
                try:
                    await self._schedule_pg(pg)
                except Exception:
                    logger.exception("pg retry failed %s",
                                     pg.pg_id.hex()[:12])
                if pg.state == "CREATED":
                    pg.retry_backoff = 0.5
                else:  # back off while unplaceable (cap: 5s)
                    pg.retry_at = now + pg.retry_backoff
                    pg.retry_backoff = min(pg.retry_backoff * 2, 5.0)

    async def _schedule_pg(self, pg: PlacementGroupInfo) -> None:
        """Pick nodes per strategy, then two-phase prepare/commit bundles.

        Parity: GcsPlacementGroupScheduler (gcs_placement_group_scheduler.h:265).
        """
        if pg.scheduling or pg.state in ("CREATED", "REMOVED"):
            return
        pg.scheduling = True
        try:
            await self._schedule_pg_inner(pg)
        finally:
            pg.scheduling = False

    def _set_pg_state(self, pg: PlacementGroupInfo, state: str) -> None:
        """Transition + publish, but only on an actual change (the retry
        loop would otherwise re-publish the same state twice a second)."""
        if pg.state == state:
            return
        pg.state = state
        self._wake_pg_waiters(pg.pg_id)
        self.publish(f"pg:{pg.pg_id.hex()}", {"state": state})
        self._wal_pg(pg)
        self._schedule_persist()

    def _wake_pg_waiters(self, pg_id: PlacementGroupID) -> None:
        ev = self._pg_waiters.pop(pg_id, None)
        if ev is not None:
            ev.set()

    async def _return_bundles(self, pg: PlacementGroupInfo,
                              targets: List[Tuple[int, "NodeInfo"]]) -> None:
        """Best-effort return_bundle for each (index, node); dead or
        unreachable raylets drop their reservations when they go away."""
        for index, node in targets:
            if node is None or not node.alive:
                continue
            try:
                conn = await self.pool.get(node.raylet_address)
                await conn.call("return_bundle",
                                {"pg_id": pg.pg_id.binary(),
                                 "bundle_index": index}, timeout=30.0)
            except Exception:
                pass

    async def _schedule_pg_inner(self, pg: PlacementGroupInfo) -> None:
        # a RESCHEDULING group may still hold bundles on surviving nodes
        # from its previous placement; release them before re-planning so
        # they neither block the new plan nor leak when it lands elsewhere
        if pg.bundle_nodes:
            await self._release_pg_bundles(pg, set(pg.bundle_nodes))
            pg.bundle_nodes.clear()
        placement = self._plan_bundles(pg)
        if placement is None:
            self._set_pg_state(pg, "INFEASIBLE")
            return
        # phase 1: prepare on every involved raylet
        prepared: List[int] = []
        ok = True
        for index, node in placement.items():
            try:
                conn = await self.pool.get(node.raylet_address)
                granted = await conn.call(
                    "prepare_bundle",
                    {"pg_id": pg.pg_id.binary(), "bundle_index": index,
                     "resources": pg.bundles[index]}, timeout=30.0)
                if granted:
                    prepared.append(index)
                else:
                    ok = False
                    break
            except (rpc.ConnectionLost, rpc.RpcError, asyncio.TimeoutError):
                # the raylet may have reserved before the reply was lost —
                # include it in the rollback so the reservation can't leak
                prepared.append(index)
                ok = False
                break
        if ok and pg.state != "REMOVED":
            # phase 2: commit
            try:
                for index, node in placement.items():
                    conn = await self.pool.get(node.raylet_address)
                    committed = await conn.call(
                        "commit_bundle",
                        {"pg_id": pg.pg_id.binary(),
                         "bundle_index": index}, timeout=30.0)
                    if not committed:
                        # raylet lost the bundle (e.g. restarted between
                        # prepare and commit) — replan from scratch
                        ok = False
                        break
                    pg.bundle_nodes[index] = node.node_id
            except (rpc.ConnectionLost, rpc.RpcError, asyncio.TimeoutError):
                ok = False
        if not ok or pg.state == "REMOVED":
            # roll back every prepared reservation (committed indices are
            # always a subset — bundle_nodes was cleared at entry)
            await self._return_bundles(
                pg, [(i, placement[i]) for i in sorted(prepared)])
            pg.bundle_nodes.clear()
            if pg.state != "REMOVED":  # removal is terminal — don't resurrect
                self._set_pg_state(pg, "PENDING")
            return
        pg.state = "CREATED"
        self._wake_pg_waiters(pg.pg_id)
        self.publish(f"pg:{pg.pg_id.hex()}",
                     {"state": pg.state,
                      "bundle_nodes": {i: n.binary()
                                       for i, n in pg.bundle_nodes.items()}})
        self._wal_pg(pg)
        self._schedule_persist()

    def _plan_bundles(self, pg: PlacementGroupInfo
                      ) -> Optional[Dict[int, NodeInfo]]:
        """Bundle→node assignment per strategy, slice/topology aware.

        PACK prefers one node (and one TPU slice); SPREAD round-robins;
        STRICT_* are the hard variants (parity:
        policy/bundle_scheduling_policy.cc).  Nodes in the same TPU slice
        sort adjacently so PACKed gangs land on one ICI domain.
        """
        alive = [n for n in self.nodes.values()
                 if n.alive and n.state == NODE_ACTIVE]
        if not alive:
            return None
        alive.sort(key=lambda n: (n.topology.get("slice", ""),
                                  n.topology.get("worker_index", 0)))
        try:
            # native bundle placement (src/sched_core.cc — parity with
            # the reference's C++ bundle_scheduling_policy.cc); node
            # order above keeps same-slice nodes adjacent for PACK
            from ray_tpu_torch.core import native

            assignment = native.sched_place_bundles(
                [n.resources_available for n in alive], pg.bundles,
                pg.strategy)
            if assignment is None:
                return None
            return {i: alive[idx] for i, idx in enumerate(assignment)}
        except OSError:  # toolchain unavailable: python fallback
            pass
        avail = {n.node_id: dict(n.resources_available) for n in alive}

        def fits(node: NodeInfo, bundle: Dict[str, float]) -> bool:
            a = avail[node.node_id]
            return all(a.get(k, 0.0) >= v for k, v in bundle.items())

        def take(node: NodeInfo, bundle: Dict[str, float]) -> None:
            a = avail[node.node_id]
            for k, v in bundle.items():
                a[k] = a.get(k, 0.0) - v

        placement: Dict[int, NodeInfo] = {}
        if pg.strategy in ("PACK", "STRICT_PACK"):
            # try to fit everything on a single node first
            for node in alive:
                trial = dict(avail[node.node_id])
                all_fit = True
                for bundle in pg.bundles:
                    if all(trial.get(k, 0.0) >= v for k, v in bundle.items()):
                        for k, v in bundle.items():
                            trial[k] = trial.get(k, 0.0) - v
                    else:
                        all_fit = False
                        break
                if all_fit:
                    for i, bundle in enumerate(pg.bundles):
                        placement[i] = node
                        take(node, bundle)
                    return placement
            if pg.strategy == "STRICT_PACK":
                return None
            # soft pack: greedy fill node by node
            for i, bundle in enumerate(pg.bundles):
                node = next((n for n in alive if fits(n, bundle)), None)
                if node is None:
                    return None
                placement[i] = node
                take(node, bundle)
            return placement
        else:  # SPREAD / STRICT_SPREAD
            used_nodes: set = set()
            for i, bundle in enumerate(pg.bundles):
                fresh = [n for n in alive
                         if n.node_id not in used_nodes and fits(n, bundle)]
                if fresh:
                    node = fresh[0]
                elif pg.strategy == "STRICT_SPREAD":
                    return None
                else:
                    node = next((n for n in alive if fits(n, bundle)), None)
                    if node is None:
                        return None
                placement[i] = node
                used_nodes.add(node.node_id)
                take(node, bundle)
            return placement

    async def _release_pg_bundles(self, pg: PlacementGroupInfo,
                                  indices: set) -> None:
        node_of = lambda i: self.nodes.get(pg.bundle_nodes[i]) \
            if pg.bundle_nodes.get(i) else None
        await self._return_bundles(pg, [(i, node_of(i)) for i in indices])
