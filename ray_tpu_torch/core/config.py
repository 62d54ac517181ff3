"""Runtime configuration flag table.

Parity with the reference's ``RAY_CONFIG(type, name, default)`` macro table
(reference ``src/ray/common/ray_config_def.h``): a single flat registry of
typed flags, each overridable by an ``RAY_TPU_TORCH_<NAME>`` environment variable
or via ``ray_tpu_torch.init(_system_config={...})``.  The resolved table is
serialized from the head node to every other process so the whole cluster
sees one consistent configuration.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field, fields
from typing import Any, Dict

_ENV_PREFIX = "RAY_TPU_TORCH_"


@dataclass
class Config:
    # ---- memory monitor (reference memory_monitor.h:52 +
    # worker_killing_policy.h:30) -----------------------------------------
    #: host memory-used fraction above which the raylet kills a retriable
    #: task worker instead of risking the OS OOM killer (0 disables)
    memory_usage_threshold: float = 0.95
    #: how often the monitor samples /proc/meminfo (ms; 0 disables)
    memory_monitor_refresh_ms: int = 250

    # ---- object store ----------------------------------------------------
    #: Bytes of shared memory for the per-node object store (0 = auto: 30%
    #: of system memory, capped).
    object_store_memory: int = 0
    #: Objects at or below this size are kept in the owner's in-process
    #: memory store and inlined into task specs instead of going to shm.
    max_direct_call_object_size: int = 100 * 1024
    #: Chunk size for node-to-node object transfer.
    object_transfer_chunk_size: int = 5 * 1024 * 1024
    #: In-flight chunk requests per transfer source (pipelining depth of
    #: a pull; 1 = the old serial request/reply protocol).
    object_transfer_window: int = 8
    #: Max holders a single pull stripes chunks across (sources beyond
    #: this are kept as failover spares).
    object_transfer_max_sources: int = 4
    #: Register in-progress pulls as *partial* locations with the owner
    #: so concurrent pullers chain off each other (1->N broadcasts
    #: self-organize into a tree instead of N pulls hammering the one
    #: sealed holder).
    object_transfer_partial_locations: bool = True
    #: Per-chunk request timeout; also bounds how long a chunk request
    #: against a partial (in-progress) holder waits for that holder's
    #: own transfer to produce the chunk.
    object_transfer_chunk_timeout_s: float = 30.0
    #: When the holder's arena file is visible on this host (multiple
    #: raylets per machine — virtual clusters, multi-node tests), copy
    #: arena-to-arena through shared memory instead of the TCP stack
    #: (the reference runs ONE plasma store per host for this reason;
    #: the pin/lease protocol still runs over RPC).
    object_transfer_shm_fastpath: bool = True
    #: Fraction of store capacity at which LRU eviction starts.
    object_store_eviction_fraction: float = 1.0
    #: Directory for spilled objects ("" = <session_dir>/spill).
    object_spilling_directory: str = ""
    #: External spill tier as a URI (e.g. ``file:///mnt/shared/spill``;
    #: scheme-pluggable via ``ray_tpu_torch.air.storage.register_storage`` —
    #: parity: reference ``_private/external_storage.py`` smart_open
    #: URIs).  When set, spilled primaries go to the URI and the OWNER
    #: records it, so the object survives the spilling node's death and
    #: restores on any node.  "" = local-directory spill only.
    object_spilling_uri: str = ""
    #: Start spilling primary copies when the store is this full.
    #: Deprecated alias of ``object_spill_threshold`` (kept for older
    #: configs; the new name wins when both are set).
    object_spilling_threshold: float = 0.8
    #: Canonical spill-pressure knob: arena-used fraction above which
    #: the raylet spills cold sealed primaries to the disk tier
    #: (LRU by last pin; pinned/unsealed copies never spill).
    #: < 0 = inherit ``object_spilling_threshold``.
    object_spill_threshold: float = -1.0
    #: Cap on bytes resident in the local spill tier (0 = unbounded).
    #: At the cap the raylet stops spilling; creates then fail with
    #: ObjectStoreFullError once eviction is also exhausted.
    object_spill_max_bytes: int = 0
    #: Metadata lock-stripe shards in the native store (0 = library
    #: default, 16).  More shards = less create/seal/get contention
    #: between concurrent writers, at a small cross-shard sweep cost
    #: for stats/eviction scans.
    store_metadata_shards: int = 16
    #: Async spill-AHEAD watermark (arena-used fraction): above it the
    #: raylet's background tick spills cold sealed primaries toward the
    #: watermark OFF the create path, so a streaming shuffle (or any
    #: bursty producer) doesn't pay spill latency inside ``put()`` when
    #: pressure later crosses ``object_spill_threshold``.  0 disables
    #: (spilling then happens only reactively, on the create path).
    object_spill_ahead_watermark: float = 0.0

    # ---- scheduling ------------------------------------------------------
    #: Hybrid policy: pack onto the local/first node until its utilization
    #: exceeds this threshold, then spread (reference
    #: ``hybrid_scheduling_policy.h:48``).
    scheduler_spread_threshold: float = 0.5
    #: Max tasks in flight to a single leased worker before requesting more
    #: workers (pipelining depth).
    max_tasks_in_flight_per_worker: int = 64
    #: Tasks per push RPC frame.  Smaller chunks stream completions back
    #: while the worker executes the next chunk; one cap-sized frame would
    #: serialize driver and worker into lock-step.
    task_push_chunk_size: int = 16
    #: Seconds a leased idle worker is kept before being returned.
    idle_worker_lease_timeout_s: float = 0.25
    #: Number of workers each raylet keeps pre-started.
    #: workers to warm up at raylet start; -1 = auto (min(4, num CPUs)),
    #: parity: reference ``prestart_worker_first_driver``
    num_prestart_workers: int = -1
    #: Hard cap on workers a raylet will spawn (0 = 4 * num_cpus).
    max_workers_per_node: int = 0
    #: Coalesce concurrent driver-side actor registrations into one
    #: ``register_actor_batch`` RPC (idempotent, keyed on actor_id).
    #: Off: one ``register_actor`` round trip per creation.
    actor_register_batch: bool = True
    #: Cap on actors per registration-batch RPC frame.
    actor_register_batch_max: int = 256
    #: Owner-side lease cache: park an idling leased worker keyed by
    #: (raylet, resource shape, runtime-env hash) through its idle grace
    #: so the next compatible scheduling key claims it WITHOUT a raylet
    #: round trip (parity: reference lease reuse in
    #: direct_task_transport).  Off: leases stay private to the
    #: scheduling key that acquired them.
    lease_cache_enabled: bool = True
    #: Max workers parked in the owner-side lease cache at once; beyond
    #: it an idling lease returns to the raylet immediately.
    lease_cache_size: int = 32
    #: Background warm-pool rebuild rate (spawns per 0.2 s reap tick,
    #: per raylet) toward the demand-driven pool target while the lease
    #: plane is quiet — the next actor wave then lands on warm forks.
    warm_pool_rebuild_per_tick: int = 4
    #: Owner-side locality lease routing (parity: the reference's
    #: LocalityAwareLeasePolicy): a DEFAULT-strategy task whose plasma
    #: args are known to live on another node sends its FIRST lease
    #: request to that node's raylet, so the task runs next to its data
    #: (the streaming data plane's map tasks depend on this).  Soft:
    #: the target can still spill the lease back; an unreachable target
    #: falls back to the local route.
    task_locality_enabled: bool = True

    # ---- fault tolerance -------------------------------------------------
    #: GCS table persistence backend: "" / "file" = session-dir pickle,
    #: "memory" = ephemeral, or an air.storage URI (e.g. file:///nfs/gcs)
    #: that survives losing the head host (parity: the reference's
    #: gcs_table_storage over Redis / in-memory store clients)
    gcs_table_storage: str = ""
    #: Write-ahead log in front of the GCS table snapshot: table-
    #: mutating handlers append a typed record and the reply is held
    #: until the record is durable, so an acked mutation survives an
    #: immediate head SIGKILL (the debounced snapshot alone loses the
    #: debounce window).  Off: snapshot-only persistence (old behavior).
    gcs_wal_enabled: bool = True
    #: WAL durability policy: "fsync" = group-commit fsync before the
    #: ack (survives host power loss); "write" = write(2) only (page
    #: cache: survives process SIGKILL, cheaper on real disks).
    gcs_wal_sync: str = "fsync"
    #: Compact (fold the WAL into the snapshot + truncate) when the log
    #: exceeds this many bytes, on top of the debounced snapshot cycle.
    gcs_wal_compact_bytes: int = 8 * 1024 * 1024
    #: Debounce window of the whole-table snapshot while the WAL is
    #: healthy (the WAL carries ack durability, so the snapshot is just
    #: the compaction base).  With the WAL off/degraded the GCS falls
    #: back to a tight 0.2 s debounce.
    gcs_snapshot_debounce_s: float = 2.0
    #: How long drivers (and actor workers) keep retrying to reconnect
    #: after the GCS/head dies before giving up (0 disables reconnect).
    gcs_client_reconnect_timeout_s: float = 60.0
    #: First-retry delay of the GCS reconnect loops (worker
    #: ``_reconnect_head``, raylet ``_try_gcs_reconnect``); grows
    #: exponentially with full jitter so a fleet-wide head restart
    #: doesn't stampede re-registration in lock-step.
    gcs_reconnect_backoff_base_s: float = 0.2
    #: Cap on the reconnect backoff delay.
    gcs_reconnect_backoff_max_s: float = 5.0
    default_max_task_retries: int = 3
    default_max_actor_restarts: int = 0
    #: Period of raylet -> GCS health reports.
    health_report_period_s: float = 1.0
    #: GCS declares a node dead after this long without a report.
    health_timeout_s: float = 10.0
    #: Wall-clock budget for one graceful node drain (the raylet-side
    #: object/spill migration leg).  0 disables the graceful protocol:
    #: drain_node falls back to immediate removal (pre-autoscaler
    #: semantics, used by crash-simulation tests).
    drain_timeout_s: float = 60.0
    #: Max attempts to reconstruct a lost object through lineage.
    max_lineage_reconstruction_depth: int = 100

    # ---- RPC / transport -------------------------------------------------
    rpc_connect_timeout_s: float = 10.0
    #: Base delay for the first RPC retry (grows exponentially).
    rpc_retry_delay_s: float = 0.1
    #: Attempts per retried call chain, counting the first try.
    rpc_max_retries: int = 5
    #: Cap on the exponential backoff between attempts.
    rpc_backoff_max_s: float = 5.0
    #: Backoff growth factor per retry.
    rpc_backoff_multiplier: float = 2.0
    #: ± fraction of jitter applied to every backoff delay (decorrelates
    #: retry storms after a node/GCS blip).
    rpc_backoff_jitter: float = 0.2
    #: Total wall-clock budget for one retried call chain, across all
    #: attempts and backoffs (0 disables the budget).  Per-attempt
    #: timeouts shrink to the remaining budget.
    rpc_call_deadline_s: float = 30.0
    #: Long-poll pubsub batch window.
    pubsub_batch_window_s: float = 0.01

    # ---- workers ---------------------------------------------------------
    worker_register_timeout_s: float = 30.0
    #: Seconds between raylet resource-view broadcasts to the GCS (the
    #: ray_syncer-equivalent cadence).
    resource_broadcast_period_s: float = 0.1

    # ---- GPU / mesh ------------------------------------------------------
    #: Default logical mesh axis names, outermost first.
    mesh_axis_order: str = "dp,fsdp,sp,tp"
    #: Label under which GPUs appear as a schedulable resource.
    gpu_resource_name: str = "GPU"

    # ---- misc ------------------------------------------------------------
    #: Sessions live apart from the JAX package's (``/tmp/ray_tpu``), so
    #: both runtimes can run on one host.
    session_root: str = os.path.join(tempfile.gettempdir(),
                                     "ray_tpu_torch_sessions")
    log_to_driver: bool = True
    event_stats: bool = True
    task_events_buffer_size: int = 10000

    # ---- telemetry -------------------------------------------------------
    #: Period of the per-process metrics/span flush to the GCS (worker,
    #: raylet, and GCS-local loops all use it).
    metrics_report_period_s: float = 5.0
    #: Master switch for the runtime ``ray_tpu_*`` producers and span
    #: recording (user-defined metrics still flush when off).
    metrics_enabled: bool = True
    #: Per-process cap on live tagsets per metric; new tagsets beyond it
    #: are dropped with one warning (guards against unbounded tag values).
    metrics_max_tagsets: int = 64
    #: Per-process buffer of timeline spans awaiting flush (oldest drop).
    telemetry_spans_buffer_size: int = 4096
    #: GCS-side ring of transfer/RPC spans served to ``timeline()``.
    telemetry_spans_table_size: int = 20000

    # ---- metrics history + alerting (core/metrics_history.py) ------------
    #: Period of the GCS history sampler: each tick folds the merged
    #: metrics table into per-series ring buffers (counters as deltas)
    #: and re-evaluates recording + alert rules.
    metrics_history_interval_s: float = 2.0
    #: History retention window.  Ring capacity per series is
    #: ``window / interval`` points — the memory bound is
    #: ``series x capacity`` points, evictions are counted
    #: (``ray_tpu_metrics_history_evicted_total``).
    metrics_history_window_s: float = 300.0
    #: Master switch for the history/alert plane (the GCS loop is a
    #: no-op when off; ``/api/timeseries`` and ``ray-tpu alerts`` then
    #: serve empty views).
    metrics_history_enabled: bool = True
    #: Error budget of the serve SLO burn-rate alert: the fraction of
    #: requests allowed over ``serve_slo_latency_s``.  Burn rate =
    #: observed miss fraction / budget; the built-in rule fires when it
    #: sustains above 1.0.
    serve_slo_error_budget: float = 0.01

    # ---- distributed tracing (core/tracing.py) ---------------------------
    #: Master switch for the native request-scoped tracing plane.  Off:
    #: no trace context is ever born, every hop short-circuits on its
    #: absence — the hot path pays nothing.
    tracing_enabled: bool = True
    #: Tail-sampling retention for FAST SUCCESSFUL traces, decided at
    #: trace completion in the GCS (errors, sheds, deadline misses,
    #: retried and SLO-violating traces are always kept).
    trace_sample_keep_fraction: float = 0.05
    #: GCS-side cap on traces held (assembling + retained); oldest
    #: evict with accounting (``ray_tpu_trace_evicted_total``).
    trace_table_size: int = 2000
    #: Serve latency SLO (seconds): a request slower than this is
    #: tagged ``slo_miss`` on its root span and always retained by tail
    #: sampling (0 disables; errors/sheds are always retained anyway).
    serve_slo_latency_s: float = 0.0

    # ---- serving plane (serve/) ------------------------------------------
    #: Per-deployment backlog cap at the ingress proxy (queued + in
    #: flight); beyond it requests shed with 429 (0 = unbounded, i.e.
    #: shedding off — overload then collapses into queueing delay).
    serve_proxy_queue_limit: int = 128
    #: ``Retry-After`` seconds attached to shed (429) responses.
    serve_shed_retry_after_s: float = 1.0
    #: Default per-request deadline when the client sends none.
    serve_request_deadline_s: float = 60.0
    #: Sustained-signal delay before the autoscaler adds replicas.
    serve_autoscale_upscale_delay_s: float = 0.3
    #: Sustained-signal delay before it removes replicas (hysteresis:
    #: much longer than upscale so brief lulls don't thrash).
    serve_autoscale_downscale_delay_s: float = 2.0
    #: One bounded wait for ALL replica metric probes per reconcile
    #: tick (replaces the old serial per-replica 5 s timeouts).
    serve_metrics_timeout_s: float = 2.0
    #: Attempts for a serve request whose replica died mid-flight
    #: (router re-assigns to a healthy replica between attempts).
    serve_request_retries: int = 3
    #: Gang bring-up budget for a sharded (num_shards > 1) replica: all
    #: shards of the gang must report ready within this window or the
    #: whole gang is killed and retried (all-or-nothing readiness).
    serve_gang_ready_timeout_s: float = 120.0
    #: Route KV pages to the plasma (arena) path regardless of size —
    #: paged KV must live in the shared arena to survive replica
    #: migration and ride the spill tier.  False = place by size like
    #: any other object (small pages then stay in the owner's
    #: in-process store).
    serve_kv_pages_in_arena: bool = True
    #: Default page-table budget per replica (pages); a request whose
    #: page demand would exceed it stays queued until eviction frees
    #: pages.  Overridable per deployment via batching.kv_max_pages.
    serve_kv_max_pages: int = 4096

    # ---- head supervision (core/supervisor.py) ---------------------------
    #: Driver-side monitor for an init()-owned head: when the head
    #: process (GCS + head raylet) dies unexpectedly, respawn it on the
    #: same GCS port and session dir so the HA recovery path
    #: (snapshot+WAL replay, client reconnect backoff) takes over.
    #: Previously only the test harness performed this restart.
    gcs_auto_respawn: bool = True
    #: Max automatic head respawns per driver session (a crash-looping
    #: GCS must not burn the host forever); 0 = unlimited.
    gcs_respawn_max: int = 3

    # ---- continuous profiling (core/profiler.py) -------------------------
    #: Start every process's sampling profiler at boot (always-on mode).
    #: Off by default: the runtime pays ZERO profiling cost unless this
    #: is set or ``ray-tpu profile`` arms the cluster at runtime.
    profiler_enabled: bool = False
    #: Stack samples per second while profiling is active.
    profiler_hz: float = 25.0
    #: Per-process cap on distinct (task, stack) fold keys between
    #: flushes; overflow samples are counted, not stored.
    profiler_max_stacks: int = 2000
    #: GCS-side ring of profile records served by ``get_profile``.
    profiler_table_size: int = 50000

    # ---- incident forensics (core/flight_recorder.py) --------------------
    #: Every process keeps a crash-surviving mmap ring of its recent
    #: state transitions (docs/observability.md "Incidents and
    #: postmortems").  Off: ``flight_recorder.record`` is a single
    #: None test — the hot path pays nothing.
    flight_recorder_enabled: bool = True
    #: Per-process ring file size in bytes (256 B/frame → 1024 frames
    #: at the default; the whole file is the crash-loss bound).
    flight_ring_bytes: int = 262144
    #: GCS-side cap on retained incidents (oldest evicted; incidents
    #: persist via the WAL so the cap also bounds snapshot growth).
    incident_table_size: int = 200
    #: Deaths/alert-firings within this window of an open incident's
    #: last update merge into it instead of opening a new one (a gang
    #: death is one incident, not N).
    incident_window_s: float = 120.0
    #: Per-severity capacity of the GCS cluster-event retention rings
    #: (evictions counted in ``ray_tpu_events_evicted_total``).
    event_ring_size: int = 5000

    def apply_env_overrides(self) -> "Config":
        for f in fields(self):
            env = os.environ.get(_ENV_PREFIX + f.name.upper())
            if env is None:
                continue
            if f.type in ("int", int):
                setattr(self, f.name, int(env))
            elif f.type in ("float", float):
                setattr(self, f.name, float(env))
            elif f.type in ("bool", bool):
                setattr(self, f.name, env.lower() in ("1", "true", "yes"))
            else:
                setattr(self, f.name, env)
        return self

    def apply_overrides(self, overrides: Dict[str, Any] | None) -> "Config":
        for key, value in (overrides or {}).items():
            if not hasattr(self, key):
                raise ValueError(f"Unknown system config key: {key!r}")
            setattr(self, key, value)
        return self

    def to_json(self) -> str:
        return json.dumps({f.name: getattr(self, f.name) for f in fields(self)})

    @classmethod
    def from_json(cls, blob: str) -> "Config":
        return cls(**json.loads(blob))


_global_config: Config | None = None


def get_config() -> Config:
    global _global_config
    if _global_config is None:
        _global_config = Config().apply_env_overrides()
    return _global_config


def set_config(config: Config) -> None:
    global _global_config
    _global_config = config
