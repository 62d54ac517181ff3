"""Runtime telemetry: hot-path metric producers, timeline spans, clock sync.

Parity: the reference's ``src/ray/stats/metric_defs.cc`` (the ``ray_*``
series every core component emits) plus the per-task profile events that
feed ``ray timeline``.  This module is the single home of the runtime's
``ray_tpu_*`` metric instances and of the per-process span buffer; the
flush loops in worker/raylet/GCS drain both toward the GCS every
``metrics_report_period_s``.

Design constraints:

- **Hot paths stay cheap.**  Every helper early-returns on one module
  flag when ``metrics_enabled`` is off.  Per-method tag keys are cached
  (one dict lookup instead of a merge+sort per call), and the two
  per-frame byte counters are plain ints folded into real Counters only
  at flush time (``presample``) — the io loop is single-threaded per
  process, so unlocked increments are safe.
- **Metrics must never hurt the runtime.**  All helpers swallow nothing:
  they do only dict/arithmetic work that cannot raise in practice; the
  flush loops that do I/O live with their owners and drop on failure.

Span records are wall-clock (``time.time()``) pairs corrected by this
process's offset against the GCS clock (measured by ``clock_sync``
round trips — see ``measure_clock_offset``), so cross-host spans line
up in one Perfetto track without per-consumer correction.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.util import metrics as _m

# ---------------------------------------------------------------------------
# enable gate
# ---------------------------------------------------------------------------

_enabled: Optional[bool] = None


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        env = os.environ.get("RAY_TPU_TORCH_METRICS_ENABLED")
        if env is not None:
            _enabled = env.lower() in ("1", "true", "yes")
        else:
            try:
                from ray_tpu_torch.core.config import get_config
                _enabled = bool(getattr(get_config(), "metrics_enabled",
                                        True))
            except Exception:  # noqa: BLE001 — config unavailable: stay on
                _enabled = True
    return _enabled


def _reset_for_tests() -> None:
    global _enabled, _clock_offset_s, _bytes_sent, _bytes_received
    _enabled = None
    _clock_offset_s = 0.0
    _bytes_sent = 0
    _bytes_received = 0
    _spans.clear()


# ---------------------------------------------------------------------------
# metric instances (created lazily so importing this module costs nothing;
# held in module globals so the weakref registry keeps them alive)
# ---------------------------------------------------------------------------

_LAT_BOUNDS = [0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
               0.5, 1.0, 2.5, 5.0, 10.0, 30.0]
_OCC_BOUNDS = [1, 2, 4, 8, 16, 32]
_MBPS_BOUNDS = [1, 5, 25, 50, 100, 250, 500, 1000, 2500, 5000]

_metrics: Dict[str, _m.Metric] = {}
_metrics_lock = threading.Lock()


def _get_metric(name: str, factory) -> _m.Metric:
    # double-checked: helpers run on the io loop AND submitting threads;
    # a racing double-create would register a loser whose pending data
    # drains as a duplicate orphan
    m = _metrics.get(name)
    if m is None:
        with _metrics_lock:
            m = _metrics.get(name)
            if m is None:
                m = _metrics[name] = factory()
    return m


def _counter(name: str, desc: str, tag_keys: Tuple[str, ...] = ()
             ) -> _m.Counter:
    return _get_metric(
        name, lambda: _m.Counter(name, desc, tag_keys=tag_keys))


def _gauge(name: str, desc: str, tag_keys: Tuple[str, ...] = ()) -> _m.Gauge:
    return _get_metric(
        name, lambda: _m.Gauge(name, desc, tag_keys=tag_keys))


def _hist(name: str, desc: str, bounds, tag_keys: Tuple[str, ...] = ()
          ) -> _m.Histogram:
    h = _get_metric(
        name, lambda: _m.Histogram(name, desc, boundaries=bounds,
                                   tag_keys=tag_keys))
    return h


# per-method tag-key cache: method -> (("method", m),)
_method_keys: Dict[str, Tuple] = {}


def _mkey(method: str) -> Tuple:
    key = _method_keys.get(method)
    if key is None:
        key = _method_keys[method] = (("method", method),)
    return key


_EMPTY_KEY: Tuple = ()

# ---------------------------------------------------------------------------
# RPC plane (core/rpc.py)
# ---------------------------------------------------------------------------

#: plain-int per-frame byte accumulators (io-loop-thread confined; folded
#: into Counters by presample() so the per-frame cost is one integer add)
_bytes_sent = 0
_bytes_received = 0


def add_bytes_sent(n: int) -> None:
    global _bytes_sent
    _bytes_sent += n


def add_bytes_received(n: int) -> None:
    global _bytes_received
    _bytes_received += n


def rpc_call_observed(method: str, seconds: float) -> None:
    """Client-side wall latency of one RPC attempt."""
    if not enabled():
        return
    _hist("ray_tpu_rpc_client_latency_s",
          "client-side RPC latency per method (per attempt)",
          _LAT_BOUNDS, ("method",)).observe_key(_mkey(method), seconds)


def rpc_retry(method: str) -> None:
    if not enabled():
        return
    _counter("ray_tpu_rpc_retries_total",
             "RPC retry attempts (beyond the first try)",
             ("method",)).inc_key(_mkey(method))


def rpc_deadline_exceeded(method: str) -> None:
    if not enabled():
        return
    _counter("ray_tpu_rpc_deadline_exceeded_total",
             "retried RPC chains that ran out of deadline budget",
             ("method",)).inc_key(_mkey(method))


# ---------------------------------------------------------------------------
# transfer plane (core/raylet.py)
# ---------------------------------------------------------------------------

_PATH_KEYS = {"net": (("path", "net"),), "shm": (("path", "shm"),)}
_RESULT_KEYS = {("ok", "net"): (("path", "net"), ("result", "ok")),
                ("ok", "shm"): (("path", "shm"), ("result", "ok")),
                ("failed", "net"): (("path", "net"), ("result", "failed")),
                ("failed", "shm"): (("path", "shm"), ("result", "failed"))}


def transfer_chunk(path: str, nbytes: int) -> None:
    """One object-transfer chunk landed (path: net|shm)."""
    if not enabled():
        return
    key = _PATH_KEYS[path]
    _counter("ray_tpu_transfer_chunks_total",
             "object-transfer chunks received", ("path",)).inc_key(key)
    _counter("ray_tpu_transfer_bytes_total",
             "object-transfer bytes received", ("path",)).inc_key(
        key, float(nbytes))


def transfer_window_occupancy(depth: int) -> None:
    """In-flight chunk requests at the moment a new one is issued."""
    if not enabled():
        return
    _hist("ray_tpu_transfer_window_occupancy",
          "in-flight chunk requests per pull when issuing the next",
          _OCC_BOUNDS).observe_key(_EMPTY_KEY, depth)


def transfer_failover() -> None:
    if not enabled():
        return
    _counter("ray_tpu_transfer_failovers_total",
             "mid-transfer source failovers (chunks re-queued to "
             "surviving sources)").inc_key(_EMPTY_KEY)


def transfer_pull_done(ok: bool, path: str, nbytes: int,
                       elapsed_s: float, n_sources: int) -> None:
    if not enabled():
        return
    _counter("ray_tpu_transfer_pulls_total",
             "object pulls completed, by result and data path",
             ("path", "result")).inc_key(
        _RESULT_KEYS[("ok" if ok else "failed", path)])
    if ok and elapsed_s > 0:
        _hist("ray_tpu_transfer_throughput_mbps",
              "per-pull transfer throughput (MB/s)",
              _MBPS_BOUNDS).observe_key(
            _EMPTY_KEY, nbytes / elapsed_s / 1e6)


# ---------------------------------------------------------------------------
# object-store spill tier
# ---------------------------------------------------------------------------

def store_spilled(nbytes: int) -> None:
    """One cold primary written to the spill tier."""
    if not enabled():
        return
    _counter("ray_tpu_store_spilled_bytes_total",
             "bytes spilled from the arena to the disk/URI tier"
             ).inc_key(_EMPTY_KEY, float(nbytes))


def store_restored(nbytes: int) -> None:
    """One spilled blob transparently restored into the arena."""
    if not enabled():
        return
    _counter("ray_tpu_store_restored_bytes_total",
             "bytes restored from the spill tier into the arena"
             ).inc_key(_EMPTY_KEY, float(nbytes))


# ---------------------------------------------------------------------------
# scheduler / lease plane
# ---------------------------------------------------------------------------

def lease_granted(wait_s: float) -> None:
    """Queue-entry -> grant latency of one worker lease on the raylet."""
    if not enabled():
        return
    _hist("ray_tpu_lease_grant_latency_s",
          "worker-lease queue wait until grant on the raylet",
          _LAT_BOUNDS).observe_key(_EMPTY_KEY, wait_s)


def task_dispatch_latency(seconds: float) -> None:
    """Owner-side submit -> push-to-worker latency of one task."""
    if not enabled():
        return
    _hist("ray_tpu_task_dispatch_latency_s",
          "owner-side task submit -> dispatch-to-worker latency",
          _LAT_BOUNDS).observe_key(_EMPTY_KEY, seconds)


_BATCH_BOUNDS = [1, 2, 4, 8, 16, 32, 64, 128, 256]


def sched_registration_batch(n: int) -> None:
    """One coalesced actor/PG registration batch landed at the GCS;
    ``n`` is the actors it carried (1 = no coalescing happened)."""
    if not enabled():
        return
    _hist("ray_tpu_sched_registration_batch_size",
          "actors per coalesced register_actor_batch RPC at the GCS",
          _BATCH_BOUNDS).observe_key(_EMPTY_KEY, n)


_POOL_KEYS = {True: (("result", "hit"),), False: (("result", "miss"),)}


def sched_warm_pool(hit: bool, n: int = 1) -> None:
    """Raylet-side: a lease was served from the warm idle pool (hit) or
    had to wait for a fresh worker spawn (miss)."""
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_sched_warm_pool_total",
             "worker leases served from the warm pool (hit) vs waiting "
             "on a spawn (miss)", ("result",)).inc_key(
        _POOL_KEYS[hit], float(n))


def sched_lease_cache(hit: bool, n: int = 1) -> None:
    """Owner-side: a task claimed a cached compatible lease (hit) or
    fell through to a raylet lease round trip (miss)."""
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_sched_lease_cache_total",
             "owner-side lease-cache claims (hit) vs raylet lease "
             "round trips (miss)", ("result",)).inc_key(
        _POOL_KEYS[hit], float(n))


# ---------------------------------------------------------------------------
# GCS plane
# ---------------------------------------------------------------------------

_channel_keys: Dict[str, Tuple] = {}


def gcs_published(channel: str, n_subscribers: int) -> None:
    """One pubsub publish; ``channel`` is folded to its prefix (the part
    before ``:``) so per-actor channels don't explode cardinality."""
    if not enabled():
        return
    prefix = channel.split(":", 1)[0]
    key = _channel_keys.get(prefix)
    if key is None:
        key = _channel_keys[prefix] = (("channel", prefix),)
    _counter("ray_tpu_gcs_publish_total",
             "GCS pubsub publishes by channel prefix",
             ("channel",)).inc_key(key)
    if n_subscribers:
        _counter("ray_tpu_gcs_publish_deliveries_total",
                 "GCS pubsub per-subscriber deliveries by channel prefix",
                 ("channel",)).inc_key(key, float(n_subscribers))


def heartbeat_miss() -> None:
    """Raylet-side: one failed/timed-out health report to the GCS."""
    if not enabled():
        return
    _counter("ray_tpu_gcs_heartbeat_misses_total",
             "raylet health reports that failed or timed out"
             ).inc_key(_EMPTY_KEY)


def node_death() -> None:
    if not enabled():
        return
    _counter("ray_tpu_gcs_node_deaths_total",
             "nodes the GCS declared dead").inc_key(_EMPTY_KEY)


def autoscaler_decision(action: str) -> None:
    """One AutoscalerMonitor policy verdict (scale_up | allow_down |
    hold), counted per tick."""
    if not enabled():
        return
    _counter("ray_tpu_autoscaler_decisions_total",
             "scaling-policy decisions emitted by the autoscaler "
             "monitor", ("action",)).inc_key((("action", action),))


def autoscaler_launch_failure() -> None:
    """A provider node launch failed (or the launch_fail failpoint
    fired); the monitor backs off exponentially and retries."""
    if not enabled():
        return
    _counter("ray_tpu_autoscaler_launch_failures_total",
             "node provider launches that failed (retried with "
             "backoff)").inc_key(_EMPTY_KEY)


def autoscaler_target_nodes(n: int) -> None:
    if not enabled():
        return
    _gauge("ray_tpu_autoscaler_target_nodes",
           "worker nodes the autoscaler currently maintains "
           "(provider view)").set_key(_EMPTY_KEY, float(n))


def node_drain_transition(state: str) -> None:
    """One node lifecycle transition (docs/autoscaler.md drain
    protocol): DRAINING (drain started), DRAINED (migration complete),
    ACTIVE (drain aborted, node returned to service)."""
    if not enabled():
        return
    _counter("ray_tpu_gcs_node_drain_transitions_total",
             "node lifecycle transitions driven by the drain protocol",
             ("state",)).inc_key((("state", state),))


def task_events_dropped(job_id: Optional[str], n: int) -> None:
    if not enabled() or n <= 0:
        return
    job = job_id or "unknown"
    _counter("ray_tpu_task_events_dropped_total",
             "task events evicted from the GCS ring buffer before "
             "any consumer read them", ("job",)).inc_key(
        (("job", job),), float(n))


# ---------------------------------------------------------------------------
# per-job attribution (tenancy accounting — docs/observability.md):
# counters tagged by job hex so consumption rolls up per tenant in the
# GCS table and `ray-tpu top --jobs`.  Jobs are few (the tagset cap
# guards runaways), and every helper is one cached-key counter inc.
# ---------------------------------------------------------------------------

_job_keys: Dict[str, Tuple] = {}


def _jobkey(job: Optional[str]) -> Tuple:
    job = job or "unknown"
    key = _job_keys.get(job)
    if key is None:
        key = _job_keys[job] = (("job", job),)
    return key


def job_task_finished(job: Optional[str], exec_seconds: float) -> None:
    """Executor-side: one task body finished; ``exec_seconds`` is body
    wall time (arg fetch and env setup excluded — same split the
    analyzer's exec phase uses)."""
    if not enabled():
        return
    key = _jobkey(job)
    _counter("ray_tpu_job_tasks_total",
             "task bodies executed, by owning job",
             ("job",)).inc_key(key)
    if exec_seconds > 0:
        _counter("ray_tpu_job_cpu_seconds_total",
                 "task-body execution seconds, by owning job",
                 ("job",)).inc_key(key, float(exec_seconds))


def job_submitted_bytes(job: Optional[str], nbytes: int) -> None:
    """Owner-side: bytes serialized into the object plane by put()."""
    if not enabled() or nbytes <= 0:
        return
    _counter("ray_tpu_job_submitted_bytes_total",
             "bytes put() into the object plane, by owning job",
             ("job",)).inc_key(_jobkey(job), float(nbytes))


def job_spilled_bytes(job: Optional[str], nbytes: int) -> None:
    """Raylet-side: one primary spilled; the job is derived from the
    ObjectID's embedded lineage (ObjectID -> TaskID -> JobID)."""
    if not enabled() or nbytes <= 0:
        return
    _counter("ray_tpu_job_spilled_bytes_total",
             "bytes spilled to the disk/URI tier, by owning job",
             ("job",)).inc_key(_jobkey(job), float(nbytes))


# ---------------------------------------------------------------------------
# metrics history + alerting plane (core/metrics_history.py; GCS-side)
# ---------------------------------------------------------------------------

def history_stats(points: int, series: int, evicted_delta: int) -> None:
    """Ring accounting exported each sample tick: resident points,
    live series, and evictions since the last tick (the memory-bound
    proof: points <= series x window/interval, overflow is counted)."""
    if not enabled():
        return
    _gauge("ray_tpu_metrics_history_points",
           "time-series points resident in the GCS history rings"
           ).set_key(_EMPTY_KEY, float(points))
    _gauge("ray_tpu_metrics_history_series",
           "series (incl. derived signals) with a live history ring"
           ).set_key(_EMPTY_KEY, float(series))
    if evicted_delta > 0:
        _counter("ray_tpu_metrics_history_evicted_total",
                 "history points evicted by the per-series ring cap "
                 "(window_s / interval_s points per series)"
                 ).inc_key(_EMPTY_KEY, float(evicted_delta))


def history_sample_failure() -> None:
    """One sample tick skipped (failpoint / ingest error): the ring
    misses a point but the evaluator keeps running."""
    if not enabled():
        return
    _counter("ray_tpu_metrics_history_sample_failures_total",
             "history sample ticks that failed and were skipped "
             "(the alert evaluator keeps running)"
             ).inc_key(_EMPTY_KEY)


def alerts_stats(firing: int, transitions: int) -> None:
    if not enabled():
        return
    _gauge("ray_tpu_alerts_firing",
           "alert rule instances currently in state firing"
           ).set_key(_EMPTY_KEY, float(firing))
    if transitions > 0:
        _counter("ray_tpu_alerts_transitions_total",
                 "alert state transitions (pending->firing, "
                 "firing->resolved, restored re-fires)"
                 ).inc_key(_EMPTY_KEY, float(transitions))


# ---------------------------------------------------------------------------
# GCS persistence / HA plane (core/wal.py + table_storage.py)
# ---------------------------------------------------------------------------

def gcs_persist_failure(backend: str) -> None:
    """One failed ``TableStorage.store()`` — the snapshot that should
    have landed didn't; the WAL (if healthy) still covers the acked
    mutations, but the compaction base is stale."""
    if not enabled():
        return
    _counter("ray_tpu_gcs_persist_failures_total",
             "GCS table snapshot writes that failed (by backend)",
             ("backend",)).inc_key((("backend", backend),))


def gcs_wal_append(n: int = 1) -> None:
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_gcs_wal_appends_total",
             "typed mutation records appended to the GCS write-ahead "
             "log").inc_key(_EMPTY_KEY, float(n))


def gcs_wal_fsync(n: int = 1) -> None:
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_gcs_wal_fsyncs_total",
             "group-commit fsync rounds of the GCS write-ahead log "
             "(many acked mutations share one round)"
             ).inc_key(_EMPTY_KEY, float(n))


def gcs_wal_append_failure(n: int = 1) -> None:
    """A WAL append/flush failed: the GCS degraded to snapshot-only
    persistence (tight debounce) rather than failing the mutation."""
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_gcs_wal_append_failures_total",
             "failed WAL appends/flushes (the GCS degrades to "
             "snapshot-only persistence)").inc_key(_EMPTY_KEY, float(n))


def gcs_wal_replayed(n: int) -> None:
    """Records replayed from the WAL at GCS startup (restart recovery)."""
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_gcs_wal_replayed_records_total",
             "WAL records replayed on top of the snapshot at GCS "
             "startup").inc_key(_EMPTY_KEY, float(n))


def gcs_wal_size(nbytes: int) -> None:
    if not enabled():
        return
    _gauge("ray_tpu_gcs_wal_size_bytes",
           "current byte size of the GCS write-ahead log (drops to the "
           "header size at each compaction)").set_key(
        _EMPTY_KEY, float(nbytes))


def gcs_recovery_duration(seconds: float) -> None:
    """Head-restart recovery duration: snapshot load + WAL replay +
    restored-actor revalidation, measured once per recovery."""
    if not enabled():
        return
    _gauge("ray_tpu_gcs_recovery_duration_s",
           "duration of the last GCS restart recovery (snapshot load + "
           "WAL replay + restored-actor revalidation)").set_key(
        _EMPTY_KEY, float(seconds))


# ---------------------------------------------------------------------------
# profiling plane (core/profiler.py / GCS profile ring)
# ---------------------------------------------------------------------------

def profiler_samples(n: int) -> None:
    """Stack samples folded this window (called once per drain, never
    per sample — the sampler keeps plain ints)."""
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_profiler_samples_total",
             "profiler stack samples taken").inc_key(_EMPTY_KEY, float(n))


def profiler_stack_drops(n: int) -> None:
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_profiler_stacks_dropped_total",
             "profiler samples dropped by the per-process "
             "profiler_max_stacks fold-table cap").inc_key(
        _EMPTY_KEY, float(n))


def profiler_records_evicted(n: int) -> None:
    """GCS-side: profile records the ring evicted before any consumer
    read them."""
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_profiler_records_evicted_total",
             "profile records evicted from the GCS ring buffer "
             "(raise profiler_table_size to keep more)").inc_key(
        _EMPTY_KEY, float(n))


# ---------------------------------------------------------------------------
# serving plane (serve/_internal.py, serve/batching.py, serve/http_proxy.py)
# ---------------------------------------------------------------------------

_dep_keys: Dict[str, Tuple] = {}


def _dkey(deployment: str) -> Tuple:
    key = _dep_keys.get(deployment)
    if key is None:
        key = _dep_keys[deployment] = (("deployment", deployment),)
    return key


_OCC_FRAC_BOUNDS = [0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0]
_SHED_KEYS: Dict[Tuple[str, str], Tuple] = {}


def serve_request_observed(deployment: str, seconds: float,
                           trace_id: Optional[str] = None) -> None:
    """End-to-end latency of one served request (replica-side: queue
    wait + decode; proxy-side spans add transport on top).  When the
    request was traced, the observation carries an OpenMetrics exemplar
    linking its latency bucket to the concrete ``trace_id`` — a
    dashboard can jump from "p99 spiked" straight to ``ray-tpu trace``."""
    if not enabled():
        return
    _hist("ray_tpu_serve_request_latency_s",
          "serve request latency (admission to completion) per deployment",
          _LAT_BOUNDS, ("deployment",)).observe_key(
        _dkey(deployment), seconds,
        exemplar={"trace_id": trace_id} if trace_id else None)


def serve_ttft_observed(deployment: str, seconds: float) -> None:
    """Time-to-first-token of one STREAMING (?stream=1) request: submit
    to first generated token, the latency a streaming client actually
    perceives."""
    if not enabled():
        return
    _hist("ray_tpu_serve_ttft_seconds",
          "time-to-first-token for streaming serve requests",
          _LAT_BOUNDS, ("deployment",)).observe_key(
        _dkey(deployment), seconds)


_STEP_BOUNDS = [0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
                0.25, 0.5, 1.0]


def serve_decode_step(deployment: str, seconds: float) -> None:
    """Wall duration of one continuous-batching decode step (the jitted
    hot path; regressions here multiply into every token)."""
    if not enabled():
        return
    _hist("ray_tpu_serve_decode_step_seconds",
          "per-decode-step latency of the continuous batcher",
          _STEP_BOUNDS, ("deployment",)).observe_key(
        _dkey(deployment), seconds)


def serve_request_shed(deployment: str, where: str) -> None:
    """One request shed by backpressure (``where``: proxy|replica)."""
    if not enabled():
        return
    key = _SHED_KEYS.get((deployment, where))
    if key is None:
        key = _SHED_KEYS[(deployment, where)] = (
            ("deployment", deployment), ("where", where))
    _counter("ray_tpu_serve_shed_total",
             "serve requests shed by backpressure (429), by layer",
             ("deployment", "where")).inc_key(key)


def serve_batch_occupancy(deployment: str, frac: float) -> None:
    """Slot-pool occupancy of one continuous-batching decode step."""
    if not enabled():
        return
    _hist("ray_tpu_serve_batch_occupancy",
          "continuous-batch slot occupancy per decode step (fraction)",
          _OCC_FRAC_BOUNDS, ("deployment",)).observe_key(
        _dkey(deployment), frac)


def serve_queue_depth(deployment: str, depth: int) -> None:
    """Pending (unadmitted) requests across a deployment's replicas —
    the autoscaler's primary signal, refreshed each reconcile tick."""
    if not enabled():
        return
    _gauge("ray_tpu_serve_queue_depth",
           "queued serve requests awaiting a batch slot, per deployment",
           ("deployment",)).set_key(_dkey(deployment), float(depth))


def serve_replicas(deployment: str, n: int) -> None:
    if not enabled():
        return
    _gauge("ray_tpu_serve_replicas",
           "live replicas per serve deployment",
           ("deployment",)).set_key(_dkey(deployment), float(n))


# -- sharded serving (serve/sharded.py, serve/kv_cache.py) ------------------

def serve_kv_pages(deployment: str, active: int, allocated_total: int,
                   freed_total: int) -> None:
    """Paged-KV accounting for one deployment, aggregated across its
    replicas each controller reconcile tick.  ``active`` pages are
    pinned arena objects; allocated == freed once a deployment drains
    (the chaos suite's no-leak invariant)."""
    if not enabled():
        return
    key = _dkey(deployment)
    _gauge("ray_tpu_serve_kv_pages_active",
           "live (pinned) KV cache pages in the object-store arena, "
           "per deployment", ("deployment",)).set_key(key, float(active))
    _gauge("ray_tpu_serve_kv_pages_allocated_total",
           "KV cache pages allocated since deployment start",
           ("deployment",)).set_key(key, float(allocated_total))
    _gauge("ray_tpu_serve_kv_pages_freed_total",
           "KV cache pages freed since deployment start",
           ("deployment",)).set_key(key, float(freed_total))


def serve_kv_occupancy(deployment: str, frac: float) -> None:
    """Fraction of the replica page budget (kv_max_pages) in use —
    the continuous batcher's admission signal for paged KV."""
    if not enabled():
        return
    _gauge("ray_tpu_serve_kv_page_occupancy",
           "fraction of the per-replica KV page budget in use",
           ("deployment",)).set_key(_dkey(deployment), float(frac))


def serve_gang_bringup(deployment: str, seconds: float, shards: int) -> None:
    """Wall time from first gang-member creation to all-shards-ready
    for one sharded replica (rides the batched registration +
    pipelined bring-up plane; regressions here multiply into every
    gang respawn after a shard death)."""
    if not enabled():
        return
    _hist("ray_tpu_serve_gang_bringup_seconds",
          "sharded-replica gang bring-up latency (create -> all ready)",
          _LAT_BOUNDS, ("deployment",)).observe_key(
        _dkey(deployment), seconds)
    _gauge("ray_tpu_serve_gang_shards",
           "shards per gang replica of the deployment",
           ("deployment",)).set_key(_dkey(deployment), float(shards))


def serve_gang_death(deployment: str) -> None:
    """One gang torn down because a shard died (all-or-nothing
    readiness: the controller respawns the whole gang)."""
    if not enabled():
        return
    _counter("ray_tpu_serve_gang_deaths_total",
             "sharded-replica gangs killed by a shard death",
             ("deployment",)).inc_key(_dkey(deployment))


# -- serving economics (prefix cache / multiplexing / cross-gang) -----------

_PREFIX_KEYS: Dict[Tuple[str, str], Tuple] = {}

#: swap = engine build + weight restore by arena ref; sub-ms for toys,
#: seconds for real checkpoints — bounds span both
_SWAP_BOUNDS = [0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                5.0, 10.0]


def serve_prefix_cache(deployment: str, result: str) -> None:
    """One prefix-cache lookup at request admission (``result``:
    hit|partial|miss).  The hit ratio is the headline serving-economics
    number — every hit token is prefill compute NOT spent."""
    if not enabled():
        return
    key = _PREFIX_KEYS.get((deployment, result))
    if key is None:
        key = _PREFIX_KEYS[(deployment, result)] = (
            ("deployment", deployment), ("result", result))
    _counter("ray_tpu_serve_prefix_cache_total",
             "KV prefix-cache lookups by outcome (hit|partial|miss)",
             ("deployment", "result")).inc_key(key)


def serve_prefix_pages_shared(deployment: str, n: int) -> None:
    """Sealed KV pages currently held by the prefix cache across the
    deployment's replicas (each possibly adopted by many requests —
    the sharing that converts HBM into throughput)."""
    if not enabled():
        return
    _gauge("ray_tpu_serve_prefix_pages_shared",
           "KV pages resident in the prefix cache, per deployment",
           ("deployment",)).set_key(_dkey(deployment), float(n))


def serve_mux_swap(deployment: str, seconds: float) -> None:
    """One model weight swap on a multiplexed replica (cache miss in
    the resident set).  The histogram prices misses; the router's
    model-resident steering keeps the rate low in steady state."""
    if not enabled():
        return
    _counter("ray_tpu_serve_mux_swaps_total",
             "model weight swaps on multiplexed replicas",
             ("deployment",)).inc_key(_dkey(deployment))
    _hist("ray_tpu_serve_mux_swap_seconds",
          "latency of one multiplexed model swap (build + load by ref)",
          _SWAP_BOUNDS, ("deployment",)).observe_key(
        _dkey(deployment), seconds)


def serve_xgang_steered(deployment: str) -> None:
    """One request steered by next-step-boundary slot availability —
    the router narrowed its candidate set to replicas with a free batch
    slot (cross-gang continuous batching in effect)."""
    if not enabled():
        return
    _counter("ray_tpu_serve_xgang_steered_total",
             "requests steered to a gang with a free batch slot",
             ("deployment",)).inc_key(_dkey(deployment))


def gcs_respawn() -> None:
    """The head supervisor respawned a died GCS/head process."""
    if not enabled():
        return
    _counter("ray_tpu_gcs_respawns_total",
             "automatic head (GCS) respawns by the driver-side "
             "supervisor").inc_key(_EMPTY_KEY)


# ---------------------------------------------------------------------------
# RL pipeline (rllib decoupled acting/learning — docs/rl_pipeline.md)
# ---------------------------------------------------------------------------

def rl_inference_batch(occupancy: float) -> None:
    """One centralized-inference dispatch: ``occupancy`` is real rows /
    padded bucket rows (1.0 = no padding waste); the dispatch count is
    the histogram's sample count."""
    if not enabled():
        return
    _hist("ray_tpu_rl_inference_batch_occupancy",
          "rows / padded bucket per centralized RL inference dispatch",
          _OCC_FRAC_BOUNDS).observe_key(_EMPTY_KEY, occupancy)


def rl_fragment_queue_depth(depth: int) -> None:
    """Learner-side: trajectory fragments ready (returned by env actors)
    but not yet consumed by the PPO update — sustained growth means the
    learner is the bottleneck, sustained zero means acting is."""
    if not enabled():
        return
    _gauge("ray_tpu_rl_fragment_queue_depth",
           "ready-but-unconsumed trajectory fragments at the RL learner"
           ).set_key(_EMPTY_KEY, float(depth))


def rl_weight_sync_age(age_s: float) -> None:
    """Inference-actor-side: seconds since the last weight publish when
    a batch is dispatched — the acting policy's staleness in wall time."""
    if not enabled():
        return
    _gauge("ray_tpu_rl_weight_sync_age_s",
           "age of the acting policy's weights at inference dispatch"
           ).set_key(_EMPTY_KEY, age_s)


def rl_fragments_dropped_stale(n: int = 1) -> None:
    """Fragments discarded by the learner because their weights version
    lagged more than ``rl_max_fragment_lag`` behind."""
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_rl_fragments_dropped_stale_total",
             "trajectory fragments dropped by the off-policy "
             "staleness bound").inc_key(_EMPTY_KEY, float(n))


# ---------------------------------------------------------------------------
# device plane (core/device_telemetry.py — XLA compiles, step phases,
# MFU/goodput, gang rank skew; docs/observability.md "device plane")
# ---------------------------------------------------------------------------

#: compile cost spans four orders of magnitude: a toy-decoder bucket
#: retrace is ~10 ms on CPU, a pod-scale train step graph is minutes
_COMPILE_BOUNDS = [0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0,
                   15.0, 60.0]
_compile_keys: Dict[Tuple[str, str], Tuple] = {}
_fn_keys: Dict[str, Tuple] = {}
_phase_keys: Dict[Tuple[str, str], Tuple] = {}
_plane_keys: Dict[str, Tuple] = {}


def _fnkey(fn: str) -> Tuple:
    key = _fn_keys.get(fn)
    if key is None:
        key = _fn_keys[fn] = (("fn", fn),)
    return key


def xla_compile(fn: str, reason: str, seconds: float) -> None:
    """One detected XLA compilation of a jitted step entry point
    (``reason``: first | shape_miss).  Steady-state steps must never
    land here — the RecompileStorm alert rides the rate of this
    counter."""
    if not enabled():
        return
    key = _compile_keys.get((fn, reason))
    if key is None:
        key = _compile_keys[(fn, reason)] = (("fn", fn),
                                             ("reason", reason))
    _counter("ray_tpu_xla_compiles_total",
             "XLA compilations detected at instrumented step entry "
             "points, by function and trigger (first | shape_miss)",
             ("fn", "reason")).inc_key(key)
    _hist("ray_tpu_xla_compile_seconds",
          "wall seconds of one detected compilation (traced call incl. "
          "first execution)", _COMPILE_BOUNDS,
          ("fn",)).observe_key(_fnkey(fn), seconds)


def step_phase(plane: str, phase: str, seconds: float) -> None:
    """One step's time in one phase of the device-step ladder
    (``data_wait`` / ``host`` / ``device`` / ``sync``); the four
    observations of a step sum to its wall time."""
    if not enabled():
        return
    key = _phase_keys.get((plane, phase))
    if key is None:
        key = _phase_keys[(plane, phase)] = (("plane", plane),
                                             ("phase", phase))
    _hist("ray_tpu_step_phase_seconds",
          "per-step wall time split over the data_wait/host/device/sync "
          "phase ladder, by workload plane",
          _STEP_BOUNDS, ("plane", "phase")).observe_key(key, seconds)


def _planekey(plane: str) -> Tuple:
    key = _plane_keys.get(plane)
    if key is None:
        key = _plane_keys[plane] = (("plane", plane),)
    return key


def step_goodput(plane: str, per_s: float) -> None:
    """Rolling goodput of the instrumented step loop: tokens/s for
    train+serve, rows/s for RL inference — the numerator of MFU."""
    if not enabled():
        return
    _gauge("ray_tpu_step_goodput_per_s",
           "tokens-or-requests per second through the instrumented "
           "step loop, by workload plane",
           ("plane",)).set_key(_planekey(plane), per_s)


def train_step_quality(mfu: float, data_wait_frac: float) -> None:
    """Train-plane step efficiency: model FLOPs utilization and the
    fraction of step wall time spent waiting on input data (the
    starved-accelerator signal the autoscaler and `ray-tpu top` read
    via the train:mfu / train:step_data_wait_frac recording rules)."""
    if not enabled():
        return
    _gauge("ray_tpu_train_mfu",
           "rolling model-FLOPs utilization of the train step loop"
           ).set_key(_EMPTY_KEY, mfu)
    _gauge("ray_tpu_train_step_data_wait_frac",
           "fraction of train step wall time spent waiting for input "
           "data (prefetch handoff)").set_key(_EMPTY_KEY, data_wait_frac)


def serve_decode_device_frac(deployment: str, frac: float) -> None:
    """Fraction of decode-step wall time the device was computing
    (vs host dispatch/sync): low values mean the chip is starved by
    host-side batching work."""
    if not enabled():
        return
    _gauge("ray_tpu_serve_decode_device_frac",
           "device-compute fraction of decode-step wall time per "
           "deployment", ("deployment",)).set_key(_dkey(deployment), frac)


_skew_keys: Dict[Tuple[str, str], Tuple] = {}


def gang_rank_skew(deployment: str, skew_s: float, straggler: int) -> None:
    """Gang-level rank skew: max minus min mean per-rank step duration
    over the rolling step window, tagged with the slowest rank so the
    GangStraggler alert names it."""
    if not enabled():
        return
    tag = (deployment, str(int(straggler)))
    key = _skew_keys.get(tag)
    if key is None:
        key = _skew_keys[tag] = (("deployment", deployment),
                                 ("straggler", tag[1]))
    _gauge("ray_tpu_gang_rank_skew_seconds",
           "spread (max-min) of mean per-rank step duration over a "
           "gang's step window, tagged with the straggling rank",
           ("deployment", "straggler")).set_key(key, skew_s)


# ---------------------------------------------------------------------------
# streaming data plane (data/streaming.py — docs/data.md)
# ---------------------------------------------------------------------------

_REASON_KEYS = {"consumer": (("reason", "consumer"),),
                "arena": (("reason", "arena"),)}
_HIT_KEYS = {True: (("result", "hit"),), False: (("result", "miss"),)}


def data_blocks_in_flight(depth: int) -> None:
    """Streaming executor window occupancy: blocks executing or
    produced-but-unconsumed, sampled at every admission round."""
    if not enabled():
        return
    _gauge("ray_tpu_data_blocks_in_flight",
           "streaming-dataset blocks in flight (executing + ready, "
           "bounded by streaming_block_budget)").set_key(
        _EMPTY_KEY, float(depth))


def data_backpressure_stall(reason: str, n: int = 1) -> None:
    """One producer-side admission stall (``reason``: consumer lag or
    local arena pressure above streaming_arena_watermark)."""
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_data_backpressure_stalls_total",
             "streaming-ingest admission stalls, by backpressure signal",
             ("reason",)).inc_key(_REASON_KEYS[reason], float(n))


def data_blocks_produced(n: int = 1) -> None:
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_data_blocks_produced_total",
             "blocks produced by streaming dataset execution"
             ).inc_key(_EMPTY_KEY, float(n))


def data_prefetch(hit: bool, n: int = 1) -> None:
    """Shard-iterator prefetch accounting: the consumer asked for the
    next batch and it was already assembled (hit) or it had to wait
    (miss) — hit/(hit+miss) is the prefetch hit ratio."""
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_data_prefetch_total",
             "streaming-shard batch requests served from the prefetch "
             "queue (hit) vs waiting on assembly (miss)",
             ("result",)).inc_key(_HIT_KEYS[hit], float(n))


def data_shuffle_spilled(nbytes: int) -> None:
    """Arena bytes the local spill tier absorbed during one streaming
    shuffle (its intermediate working set beyond the arena)."""
    if not enabled() or nbytes <= 0:
        return
    _counter("ray_tpu_data_shuffle_spilled_bytes_total",
             "bytes spilled to the disk tier by streaming-shuffle "
             "intermediates").inc_key(_EMPTY_KEY, float(nbytes))


def sched_locality_lease(n: int = 1) -> None:
    """Owner-side: one worker-lease request routed to a remote raylet
    because the head task's plasma args live there (task locality)."""
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_sched_locality_leases_total",
             "lease requests routed to the raylet holding the task's "
             "plasma args (owner-side locality)").inc_key(
        _EMPTY_KEY, float(n))


# ---------------------------------------------------------------------------
# distributed tracing plane (core/tracing.py / GCS trace ring)
# ---------------------------------------------------------------------------

def trace_spans_ingested(n: int) -> None:
    """GCS-side: trace spans accepted into the assembly ring."""
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_trace_spans_total",
             "trace spans ingested by the GCS trace ring"
             ).inc_key(_EMPTY_KEY, float(n))


def trace_retained(n: int = 1) -> None:
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_trace_retained_total",
             "traces kept by tail sampling (errors/sheds/SLO misses "
             "always; fast successes at trace_sample_keep_fraction)"
             ).inc_key(_EMPTY_KEY, float(n))


def trace_sampled_out(n: int = 1) -> None:
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_trace_sampled_out_total",
             "completed traces dropped by tail sampling (fast successes "
             "beyond the keep fraction)").inc_key(_EMPTY_KEY, float(n))


def trace_evicted(n: int = 1) -> None:
    """GCS-side: traces evicted from the ring before any consumer read
    them (raise trace_table_size to keep more)."""
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_trace_evicted_total",
             "traces evicted from the GCS trace ring"
             ).inc_key(_EMPTY_KEY, float(n))


# ---------------------------------------------------------------------------
# incident forensics (core/flight_recorder.py + GCS incident journal)
# ---------------------------------------------------------------------------

def events_evicted(n: int = 1) -> None:
    """GCS-side: cluster-event records displaced from a per-severity
    retention ring (raise event_ring_size to keep more)."""
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_events_evicted_total",
             "cluster-event records evicted from the per-severity "
             "retention rings").inc_key(_EMPTY_KEY, float(n))


def incident_opened(kind: str) -> None:
    """GCS-side: an incident auto-opened (kind: death | alert)."""
    if not enabled():
        return
    _counter("ray_tpu_incidents_total",
             "incidents auto-opened by the GCS journal",
             ("kind",)).inc_key((("kind", kind),), 1.0)


def incidents_open(n: int) -> None:
    """GCS-side gauge: incidents currently retained in the journal."""
    if not enabled():
        return
    _gauge("ray_tpu_incidents_open",
           "incidents retained in the GCS journal"
           ).set_key(_EMPTY_KEY, float(n))


def flight_tail_shipped(n: int = 1) -> None:
    """GCS-side: dead-process flight tails attached to incidents."""
    if not enabled() or n <= 0:
        return
    _counter("ray_tpu_flight_tails_shipped_total",
             "dead-process flight-recorder tails shipped to the GCS "
             "incident journal").inc_key(_EMPTY_KEY, float(n))


def flight_frames(n: int) -> None:
    """Per-process gauge, set from the flush loops (never per-frame):
    frames this process has recorded into its flight ring."""
    if not enabled():
        return
    _gauge("ray_tpu_flight_frames_total",
           "frames recorded into this process's flight-recorder ring"
           ).set_key(_EMPTY_KEY, float(n))


# ---------------------------------------------------------------------------
# gauges set by the flush loops (samplers run right before a flush)
# ---------------------------------------------------------------------------

def set_gauge(name: str, desc: str, value: float,
              tags: Optional[Dict[str, str]] = None) -> None:
    if not enabled():
        return
    keys = tuple(sorted(tags)) if tags else ()
    _gauge(name, desc, keys).set_key(
        tuple(sorted(tags.items())) if tags else _EMPTY_KEY, value)


def presample() -> None:
    """Fold the plain-int hot counters into real Counter objects; called
    by each flush loop right before ``metrics.flush_all()``."""
    global _bytes_sent, _bytes_received
    if not enabled():
        return
    sent, _bytes_sent = _bytes_sent, 0
    recv, _bytes_received = _bytes_received, 0
    if sent:
        _counter("ray_tpu_rpc_bytes_sent_total",
                 "bytes written to RPC transports (frames incl. OOB "
                 "payloads)").inc_key(_EMPTY_KEY, float(sent))
    if recv:
        _counter("ray_tpu_rpc_bytes_received_total",
                 "bytes received from RPC transports"
                 ).inc_key(_EMPTY_KEY, float(recv))


# ---------------------------------------------------------------------------
# timeline spans (chrome-trace complete events, GCS-clock aligned)
# ---------------------------------------------------------------------------

def _span_cap() -> int:
    try:
        from ray_tpu_torch.core.config import get_config
        return int(getattr(get_config(), "telemetry_spans_buffer_size",
                           4096))
    except Exception:  # noqa: BLE001
        return 4096


_spans: "deque[Dict[str, Any]]" = deque(maxlen=4096)
_span_cap_applied = False
_clock_offset_s = 0.0


def spans_enabled() -> bool:
    return enabled()


def record_span(cat: str, name: str, start: float, end: float,
                **args: Any) -> None:
    """Buffer one completed span (wall-clock seconds, local clock; the
    GCS offset is applied at drain time).  Bounded: the oldest spans
    drop when the buffer outpaces the flush loop."""
    if not enabled():
        return
    global _spans, _span_cap_applied
    if not _span_cap_applied:
        _span_cap_applied = True
        cap = _span_cap()
        if cap != _spans.maxlen:
            _spans = deque(_spans, maxlen=cap)
    _spans.append({"cat": cat, "name": name, "start": start, "end": end,
                   "pid": os.getpid(), "args": args})


def drain_spans(source: str) -> List[Dict[str, Any]]:
    """Pop buffered spans, clock-corrected onto the GCS timebase and
    stamped with their source process."""
    if not _spans:
        return []
    off = _clock_offset_s
    out = []
    while _spans:
        s = _spans.popleft()
        s["start"] += off
        s["end"] += off
        s["source"] = source
        out.append(s)
    return out


def set_clock_offset(offset_s: float) -> None:
    global _clock_offset_s
    _clock_offset_s = offset_s


def clock_offset() -> float:
    return _clock_offset_s


async def measure_clock_offset(gcs_conn, probes: int = 3
                               ) -> Optional[float]:
    """NTP-style offset of this process's wall clock vs the GCS's:
    ``offset = gcs_time - (t0 + t1) / 2`` over the minimum-RTT probe
    (the tightest round trip bounds the error by rtt/2).  Stored via
    :func:`set_clock_offset` on success; returns the measured offset,
    or None when EVERY probe failed (previous offset kept) — callers
    must retry later rather than treating the process as synced."""
    best_rtt = None
    best_off = None
    for _ in range(probes):
        try:
            t0 = time.time()
            reply = await gcs_conn.call("clock_sync", {}, timeout=5.0)
            t1 = time.time()
        except Exception:  # noqa: BLE001 — unreachable GCS: keep old
            continue
        rtt = t1 - t0
        if best_rtt is None or rtt < best_rtt:
            best_rtt = rtt
            best_off = reply["time"] - (t0 + t1) / 2.0
    if best_off is None:
        return None
    set_clock_offset(best_off)
    return best_off
