"""Raylet: per-node scheduler, worker pool, and object plane.

Parity: reference ``src/ray/raylet/`` (NodeManager, ClusterTaskManager /
LocalTaskManager, WorkerPool) and ``src/ray/object_manager/`` (ObjectManager
push/pull transfer, LocalObjectManager spill/restore), with the plasma store
role played by the C++ library behind
:class:`ray_tpu_torch.core.object_store.SharedMemoryStore`.

Scheduling model is the reference's lease protocol: submitters ask the
raylet for a worker lease; the raylet grants a local worker (spawning one
if the pool is empty), replies with a *spillback* hint when another node
should run the task, or queues the request.  Granted leases hold their
resources until returned.  The hybrid policy packs onto the local node
until utilization crosses ``scheduler_spread_threshold``, then prefers the
least-loaded feasible remote node (reference
``hybrid_scheduling_policy.h:48``).

Object plane: workers create/seal objects in the node's shared-memory
arena through this service and read them zero-copy via their own mapping.
Missing objects are located through the *owner* (ownership-based object
directory, reference ``ownership_based_object_directory.h``) and pulled in
chunks from the remote raylet.  Primary copies are pinned until the owner
frees them; under memory pressure they are spilled to disk and restored on
demand (reference ``local_object_manager.h``).
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import subprocess
import sys
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Set, Tuple

from ray_tpu_torch.core import flight_recorder as _flight
from ray_tpu_torch.core import profiler as _prof
from ray_tpu_torch.core import rpc
from ray_tpu_torch.core import telemetry as _tm
from ray_tpu_torch.core import tracing as _trace
from ray_tpu_torch.core.config import Config
from ray_tpu_torch.core.exceptions import ObjectStoreFullError
from ray_tpu_torch.core.ids import NodeID, ObjectID, PlacementGroupID, WorkerID
from ray_tpu_torch.core.object_store import SharedMemoryStore
from ray_tpu_torch.autoscaler.fair_queue import (NODE_ACTIVE, NODE_DRAINED,
                                           NODE_DRAINING, FairQueue,
                                           JobQuota, QuotaExceeded)
from ray_tpu_torch.util import failpoint as _fp

logger = logging.getLogger(__name__)

#: seeded source-sampling stream for pull probes (reproducible runs)
_probe_rng = random.Random(0x52545055)


def _spill_write_failpoint() -> None:
    """Shared chaos site for BOTH spill-tier writers (file and URI):
    the blob write dies mid-flight."""
    _fp.failpoint("raylet.spill.write_fail")


def _restore_read_failpoint() -> None:
    """Shared chaos site for BOTH spill-tier readers (file and URI)."""
    _fp.failpoint("raylet.restore.read_fail")


@dataclass
class WorkerHandle:
    worker_id: WorkerID
    pid: int
    job_id_bin: Optional[bytes]
    conn: rpc.Connection
    task_address: rpc.Address  # the worker's own task server
    proc: Optional[subprocess.Popen] = None
    # whether this process may lease a GPU: cold-spawned workers may;
    # workers forked from the zygote and isolated-env workers do not
    gpu_capable: bool = True
    # runtime env this worker has applied (workers are env-dedicated once
    # an env lands on them; parity: runtime-env-keyed WorkerPool)
    env_hash: "Optional[str]" = None
    # lease state
    leased: bool = False
    lease_resources: Dict[str, float] = field(default_factory=dict)
    lease_bundle: Optional[Tuple[bytes, int]] = None  # (pg_id, bundle_index)
    #: whether the leased work survives a kill (owner retries it)
    lease_retriable: bool = True
    lease_granted_at: float = 0.0
    #: token of the acquiring lease request — keys return_worker so a
    #: retried (duplicate) return can never settle a newer lease
    lease_token: Optional[str] = None
    #: GPU indices assigned to this lease (parity: raylet GPU-id
    #: assignment backing ray.get_gpu_ids)
    lease_gpu_ids: List[int] = field(default_factory=list)
    lease_gpu_share: float = 0.0
    #: fair-queue job key charged for this lease's in-flight usage —
    #: releases and reconciliation settle against it
    lease_job_key: Optional[str] = None
    is_actor: bool = False
    #: connection of the client holding the current lease (reclaim pushes)
    owner_conn: Optional[rpc.Connection] = None
    #: monotonic time this worker joined the idle pool (pool trimming)
    idle_since: float = 0.0


class _ForkedProc:
    """Popen-compatible handle for a zygote-forked worker (pid only)."""

    __slots__ = ("pid", "returncode")

    def __init__(self, pid: int):
        self.pid = pid
        self.returncode: Optional[int] = None

    def poll(self) -> Optional[int]:
        if self.returncode is not None:
            return self.returncode
        try:
            os.kill(self.pid, 0)
            return None
        except ProcessLookupError:
            self.returncode = -1  # reaped by the zygote's SIGCHLD ignore
            return self.returncode
        except PermissionError:
            return None

    def _signal(self, sig: int) -> None:
        try:
            os.kill(self.pid, sig)
        except ProcessLookupError:
            pass

    def terminate(self) -> None:
        import signal as _signal

        self._signal(_signal.SIGTERM)

    def kill(self) -> None:
        import signal as _signal

        self._signal(_signal.SIGKILL)


class _ZygoteClient:
    """Raylet-side handle on the worker fork-server (worker_zygote.py).

    ``spawn`` is a blocking call (write request line, read pid line) —
    the raylet invokes it via ``run_in_executor``; a lock serializes
    concurrent spawns over the single pipe pair."""

    def __init__(self, session_dir: str):
        import threading

        self._session_dir = session_dir
        self._lock = threading.Lock()
        self._proc: Optional[subprocess.Popen] = None

    def _ensure_started(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            return
        from ray_tpu_torch.core.node import safe_die_with_parent

        env = dict(os.environ)
        env["RAY_TPU_TORCH_WORKER"] = "1"
        if safe_die_with_parent():
            env["RAY_TPU_TORCH_PDEATHSIG"] = str(os.getpid())  # armed in zygote main()
        log = open(os.path.join(self._session_dir, "logs",
                                "worker_zygote.err"), "ab")
        self._proc = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.core.worker_zygote"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=log,
            env=env, text=True, close_fds=False)
        ready = self._proc.stdout.readline()
        if "ready" not in ready:
            raise RuntimeError(f"worker zygote failed to start: {ready!r}")

    def spawn(self, argv, env_updates, log_base) -> int:
        import json as json_mod

        with self._lock:
            self._ensure_started()
            req = {"argv": list(argv), "env": env_updates,
                   "log_base": log_base}
            self._proc.stdin.write(json_mod.dumps(req) + "\n")
            self._proc.stdin.flush()
            reply = self._proc.stdout.readline()
            return int(json_mod.loads(reply)["pid"])

    def stop(self) -> None:
        proc, self._proc = self._proc, None
        if proc is not None:
            try:
                proc.stdin.write('{"exit": true}\n')
                proc.stdin.flush()
            except Exception:
                pass
            proc.terminate()


@dataclass
class PendingLease:
    request: Dict[str, Any]
    future: asyncio.Future
    job_id_bin: Optional[bytes]
    resources: Dict[str, float]
    bundle: Optional[Tuple[bytes, int]]
    env_hash: Optional[str] = None
    env_spawn: Optional[Dict[str, Any]] = None
    retriable: bool = True
    enqueued_at: float = field(default_factory=time.monotonic)
    #: client-generated id so the owner can cancel a request whose
    #: backlog drained before the grant (stale grants churned workers
    #: through grant->instant-return cycles, delaying real demand)
    token: Optional[str] = None
    conn: Optional[rpc.Connection] = None
    #: True once this lease was evaluated with no idle worker available
    #: (warm-pool MISS); grants with it still False count as HITS —
    #: each lease contributes exactly one hit or one miss
    pool_missed: bool = False
    #: fair-queue sub-queue this lease is charged to (job id hex, or a
    #: per-connection key for job-less leases)
    job_key: str = ""
    #: worker picked by the scheduling pass's fits() probe, consumed by
    #: the grant commit in the same pass (never survives across passes)
    granted_worker: Optional[WorkerHandle] = None


class _InflightPull:
    """One in-progress incoming transfer (the receive side of a pull).

    Registered in ``Raylet._inflight_pulls`` so the node can serve
    already-received chunk ranges to OTHER pullers before the copy
    seals: a 1->N broadcast then self-organizes into a tree/chain
    instead of N pulls hammering the one sealed holder (parity:
    ObjectManager registers in-progress copies as pull targets).
    """

    __slots__ = ("size", "offset", "chunk", "have", "waiters", "failed")

    def __init__(self, size: int, offset: int, chunk: int):
        self.size = size
        self.offset = offset  # arena offset of the partial create
        self.chunk = chunk    # chunk stride the ``have`` set is keyed by
        self.have: Set[int] = set()  # completed chunk indices
        self.waiters: List[asyncio.Future] = []
        self.failed = False

    def mark(self, index: int) -> None:
        self.have.add(index)
        self._wake()

    def fail(self) -> None:
        self.failed = True
        self._wake()

    def _wake(self) -> None:
        waiters, self.waiters = self.waiters, []
        for fut in waiters:
            if not fut.done():
                fut.set_result(None)

    def covered(self, start: int, n: int) -> bool:
        last = (start + max(n, 1) - 1) // self.chunk
        return all(i in self.have
                   for i in range(start // self.chunk, last + 1))

    async def wait_range(self, start: int, n: int, timeout: float) -> bool:
        """Block until [start, start+n) has been received (True) or the
        transfer failed / the timeout expired (False)."""
        deadline = time.monotonic() + timeout
        while not self.covered(start, n):
            if self.failed:
                return False
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return False
            fut = asyncio.get_running_loop().create_future()
            self.waiters.append(fut)
            try:
                await asyncio.wait_for(fut, remaining)
            except asyncio.TimeoutError:
                return False
        return not self.failed


class Raylet:
    def __init__(self, config: Config, gcs_address: rpc.Address,
                 session_dir: str, resources: Optional[Dict[str, float]] = None,
                 node_id: Optional[NodeID] = None,
                 topology: Optional[Dict[str, Any]] = None,
                 host: str = "127.0.0.1", port: int = 0):
        self.config = config
        self.gcs_address = gcs_address
        self.session_dir = session_dir
        self.node_id = node_id or NodeID.from_random()
        self.topology = topology or {}
        self.server = rpc.Server(self, host=host, port=port)
        self.pool = rpc.ConnectionPool()  # raylet->raylet, raylet->owner
        self.gcs_conn: Optional[rpc.Connection] = None

        if resources is None:
            resources = {"CPU": float(os.cpu_count() or 1)}
        resources.setdefault("CPU", float(os.cpu_count() or 1))
        self.resources_total = dict(resources)
        self.resources_available = dict(resources)

        # object store
        store_capacity = config.object_store_memory
        if store_capacity <= 0:
            store_capacity = min(
                int(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
                    * 0.3),
                16 * 1024 ** 3,
            )
        store_path = os.path.join(
            "/dev/shm" if os.path.isdir("/dev/shm") else session_dir,
            f"rtpu_torch_store_{self.node_id.hex()[:12]}",
        )
        self.store = SharedMemoryStore(
            store_path, store_capacity,
            shards=getattr(config, "store_metadata_shards", 0))
        self.store_capacity = store_capacity
        self._primary: Set[ObjectID] = set()  # pinned primaries
        # jobs whose arena-bytes gauge was non-zero last flush (zeroed
        # once their primaries drain — see _sample_job_arena_bytes)
        self._job_arena_reported: Set[str] = set()
        self._owner_of: Dict[ObjectID, tuple] = {}  # id -> owner address tuple
        self._spilled: Dict[ObjectID, str] = {}  # id -> file path / uri
        self._spilled_sizes: Dict[ObjectID, int] = {}  # id -> payload bytes
        self._spill_bytes = 0  # bytes resident in the spill tier
        self._spill_lock: Optional[asyncio.Lock] = None  # one sweep at a time
        self._spill_ahead_running = False  # one background sweep at a time
        # restores whose blob read / arena write is in flight:
        # id -> [active restore count, freed-mid-restore flag].
        # handle_object_free must NOT store.delete these (the unsealed
        # pin-0 entry would free instantly and the executor thread's
        # write would scribble over whatever re-allocates the block);
        # it sets the flag and the LAST restore's guard-exit deletes.
        # Refcounted, not a bare flag: concurrent restores of one oid
        # are reachable (pull_start's URI path races _make_local), and
        # a second restore's exit must not strip the first's guard.
        self._restoring: Dict[ObjectID, list] = {}
        self._spill_dir = config.object_spilling_directory or os.path.join(
            session_dir, "spill")
        os.makedirs(self._spill_dir, exist_ok=True)
        # per-object pull serialization: oid -> [lock, waiter_count]; the
        # entry is dropped when the last waiter leaves (a bare
        # setdefault'd Lock leaked one dict entry per object pulled)
        self._pull_locks: Dict[ObjectID, list] = {}
        # in-progress incoming transfers, served to other pullers as
        # *partial* sources (emergent broadcast trees; ObjectManager
        # parity: in-progress copies are registered pull targets)
        self._inflight_pulls: Dict[ObjectID, _InflightPull] = {}
        # same-host peer arenas mapped for the shm transfer fast path:
        # store path -> (mmap, base address, ctypes export)
        self._peer_arenas: Dict[str, tuple] = {}

        # worker pool: spawned-but-unregistered procs as
        # (proc, gpu_capable, spawned_with_needs_gpu, spawn_token)
        self._spawned_procs: List[Tuple[Any, bool, bool, Any]] = []
        self.workers: Dict[WorkerID, WorkerHandle] = {}
        self._idle: List[WorkerHandle] = []
        self._starting = 0
        self._starting_gpu = 0  # subset of _starting spawned with needs_gpu
        # isolated-runtime-env worker spawns (venv/conda/container):
        # env_hash -> in-flight count, spawn token -> env_hash (tokens,
        # not pids: container workers see a private pid namespace),
        # env_hash -> build error
        self._starting_env: Dict[str, int] = {}
        self._env_spawn_hash: Dict[str, str] = {}
        self._env_broken: Dict[str, str] = {}
        # weighted-fair lease queue with per-job quotas (pure math in
        # ray_tpu/autoscaler/fair_queue.py; this class feeds it events).
        # Job-less leases key by connection, so multi-client round-robin
        # degenerates to the pre-quota behavior.
        self._fair = FairQueue(resources_of=lambda lease: lease.resources)
        # quota keys installed from the GCS table (health-ack piggyback
        # + "quotas" pubsub); tracked so removals propagate
        self._gcs_quota_jobs: Set[str] = set()
        # node lifecycle (docs/autoscaler.md): while True this raylet
        # grants nothing — new lease requests spill to ACTIVE peers and
        # the drain protocol migrates the object plane before release
        self._draining = False
        self._drain_task: Optional[asyncio.Task] = None
        self._register_waiters: List[asyncio.Future] = []
        # cluster profiling window state (profiler_control): kept so
        # workers that register MID-window join it via the register
        # reply instead of sampling nothing
        self._profiler_state: Optional[Dict[str, Any]] = None
        max_workers = config.max_workers_per_node
        self._max_workers = max_workers if max_workers > 0 else int(
            4 * self.resources_total.get("CPU", 1))

        # placement-group bundles: (pg_id, idx) -> remaining resources
        self._bundles: Dict[Tuple[bytes, int], Dict[str, float]] = {}
        self._bundle_totals: Dict[Tuple[bytes, int], Dict[str, float]] = {}

        # cluster view for spillback (refreshed from GCS health replies)
        self._cluster_view: List[Dict[str, Any]] = []
        # node_id -> (spill count, last-charge time): local charge for
        # spill decisions between resource-view broadcasts
        self._spill_pressure: Dict[bytes, Tuple[float, float]] = {}
        # per-GPU fractional load for GPU-id assignment (whole-GPU
        # leases get disjoint ids because availability gating keeps the
        # total demand <= GPU count)
        self._gpu_load: Dict[int, float] = {
            i: 0.0 for i in range(int(self.resources_total.get("GPU", 0)))}
        # rate limiter for reclaim_idle nudges under pool-cap contention
        self._last_reclaim_push = 0.0
        self._reclaim_timer_armed = False
        self._reclaim_retry_delay = 0.03
        # decaying count of workers claimed by actors recently: actor
        # waves permanently consume pool workers, so the refill target
        # tracks recent claim volume (parity: GcsActorScheduler keeps
        # nodes stocked for the wave it is placing) and decays back to
        # the boot watermark when the storms stop
        self._actor_claims = 0.0
        self._actor_claims_ts = time.monotonic()
        # decaying PEAK of the pending-lease backlog: demand feeds the
        # warm-pool target, so a wave that queued behind cold spawns
        # rebuilds enough warm forks for the NEXT wave of that size
        self._backlog_demand = 0.0
        self._backlog_demand_ts = time.monotonic()
        # actor creation tasks currently executing on this node's
        # workers: the warm-pool rebuild stays parked while >0 (spawn
        # storms mid-wave steal the CPU the wave itself needs)
        self._creating_actors = 0
        # True while a lease batch enqueues: _maybe_schedule holds off
        # so the whole wave lands in ONE scheduling pass (per-enqueue
        # passes over a growing queue were O(n^2) in the batch size)
        self._sched_suspended = False
        # log monitor state: file path -> (offset, pid)
        self._log_pids: Dict[str, int] = {}
        self._log_offsets: Dict[str, int] = {}
        self._tasks: List[asyncio.Task] = []
        self._closing = False
        # monotonic metrics-flush seq (the GCS drops replayed flushes)
        self._metrics_report_seq = 0

    # ------------------------------------------------------------------
    # lifecycle
    # ------------------------------------------------------------------
    async def start(self) -> rpc.Address:
        address = await self.server.start()
        self.address = address
        # carry our handler so the GCS can call back over the
        # registration link (profiler_control fan-out) without opening
        # a second connection
        self.gcs_conn = await rpc.connect(self.gcs_address,
                                          handler=self.server)
        reply = await self.gcs_conn.call("register_node", {
            "node_id": self.node_id.binary(),
            "raylet_address": address,
            "protocol_version": rpc.PROTOCOL_VERSION,
            "resources": self.resources_total,
            "topology": self.topology,
            # worker capacity: a dedicated control node (0 CPUs → cap
            # 0) must never be handed an actor lease it can't serve
            "max_workers": self._max_workers,
            # the GCS reads this raylet's flight ring by pid if the
            # node dies (incident journal, docs/observability.md)
            "pid": os.getpid(),
        })
        # adopt the cluster-wide config decided by the head node
        self.config = Config.from_json(reply["config"])
        # adopt the durable lifecycle verdict + quota table: a raylet
        # re-registering after a GCS restart mid-drain resumes DRAINING
        # instead of silently re-opening its lease plane
        self._apply_gcs_state(reply.get("state"))
        self._apply_quotas(reply.get("quotas"))
        # join an in-progress cluster profiling window (node added
        # mid-`ray-tpu profile`)
        prof = reply.get("profiler")
        if prof and prof.get("enabled"):
            _prof.configure(True, hz=prof.get("hz"),
                            duration_s=prof.get("duration_s"))
            self._profiler_state = {
                "enabled": True, "hz": prof.get("hz"),
                "deadline": (time.monotonic() + prof["duration_s"]
                             if prof.get("duration_s") else None)}
        # adopt cluster-armed failpoints (see util/failpoint.py; no-op
        # unless a chaos test armed sites in the GCS KV)
        await _fp.sync_from_kv(self.gcs_conn)
        loop = asyncio.get_running_loop()
        from ray_tpu_torch.util import event as event_mod
        self._event_mod = event_mod
        event_mod.init("RAYLET", self.session_dir, gcs_conn=self.gcs_conn,
                       loop=loop)
        # crash-surviving flight ring (head node: the GCS opened the
        # process ring already and this is a no-op — first init wins)
        _flight.init("raylet", self.session_dir, self.config)
        # versioned resource-view subscription (parity: ray_syncer —
        # delta broadcasts replace per-beat full-table polling)
        self._view_by_id: Dict[bytes, Dict[str, Any]] = {}
        self._view_version = 0
        self._view_stale = True
        self._view_subscribed = False
        self.gcs_conn.set_push_handler(self._on_gcs_push)
        await self.gcs_conn.call("subscribe", {"channel": "resource_view"})
        self._view_subscribed = True
        # quota updates push immediately; the health-report ack
        # re-carries the full table each beat as the catch-up path
        try:
            await self.gcs_conn.call("subscribe", {"channel": "quotas"})
        except (rpc.ConnectionLost, rpc.RpcError, asyncio.TimeoutError):
            pass
        if getattr(self.config, "event_stats", True):
            from ray_tpu_torch.util.event_stats import HandlerStats, LoopMonitor
            self.server.handler_stats = HandlerStats()
            self._loop_monitor = LoopMonitor(
                f"raylet-{self.node_id.hex()[:8]}",
                self.server.handler_stats)
            self._loop_monitor.start()
        self._tasks.append(loop.create_task(self._health_loop()))
        self._tasks.append(loop.create_task(self._reap_loop()))
        self._tasks.append(loop.create_task(self._log_monitor_loop()))
        self._tasks.append(loop.create_task(self._metrics_flush_loop()))
        # always-on profiling mode (profiler_enabled): sample this
        # raylet's own loop/executor threads too
        _prof.maybe_start_from_config()
        if self.config.memory_monitor_refresh_ms > 0 and \
                self.config.memory_usage_threshold > 0:
            self._tasks.append(
                loop.create_task(self._memory_monitor_loop()))
        n_prestart = self.config.num_prestart_workers
        if n_prestart < 0:
            n_prestart = min(8, 2 * int(self.resources_total.get("CPU", 1)))
        self._prestart_watermark = n_prestart
        for _ in range(n_prestart):
            self._start_worker(None)
        logger.info("raylet %s on %s resources=%s",
                    self.node_id.hex()[:12], address, self.resources_total)
        return address

    async def stop(self) -> None:
        self._closing = True
        if getattr(self, "_loop_monitor", None) is not None:
            self._loop_monitor.stop()
        if getattr(self, "_zygote", None) is not None:
            self._zygote.stop()
        for t in self._tasks:
            t.cancel()
        for w in list(self.workers.values()):
            if w.proc is not None:
                w.proc.terminate()
        await self.server.stop()
        if self.gcs_conn:
            self.gcs_conn.close()
        self.pool.close_all()
        for path in list(self._peer_arenas):
            ent = self._peer_arenas.pop(path)
            ent[2] = None  # drop the ctypes export before unmapping
            try:
                ent[0].close()
            except BufferError:
                pass  # export still referenced; process teardown
        self.store.close()
        _flight.close(unlink=True)  # graceful stop: no crash evidence

    def _on_gcs_push(self, channel: str, data: Any) -> None:
        if channel == "quotas":
            self._apply_quotas(data.get("quotas"))
            return
        if channel != "resource_view":
            return
        version = data.get("version", 0)
        if self._view_stale or version != self._view_version + 1:
            # gap (missed a broadcast, or fresh connection): resync with
            # one full fetch — the syncer contract (versioned deltas +
            # snapshot-on-gap, ray_syncer.h)
            self._view_version = version
            self._view_stale = True
            return
        self._view_version = version
        for entry in data.get("nodes", []):
            self._view_by_id[bytes(entry["node_id"])] = entry
        self._cluster_view = list(self._view_by_id.values())
        self._maybe_schedule()  # fresh capacity may unblock queued work

    async def _resync_view(self) -> None:
        version_before = self._view_version
        view = await self.gcs_conn.call("get_nodes", {}, timeout=5.0)
        self._view_by_id = {bytes(n["node_id"]): n for n in view}
        self._cluster_view = list(self._view_by_id.values())
        # deltas that landed during the await were dropped (stale mode)
        # but may POSTDATE this snapshot (e.g. a node death that never
        # re-dirties) — refetch next beat rather than trusting it
        self._view_stale = self._view_version != version_before
        self._maybe_schedule()

    async def _health_loop(self) -> None:
        while not self._closing:
            try:
                # re-anchor the fair queue's advisory in-flight ledger
                # on ground truth (live leases) each beat: dropped
                # accounting updates (raylet.quota.account_drop, crash
                # paths) converge instead of wedging a job forever
                self._fair.reconcile(self._lease_usage_truth())
                reply = await self.gcs_conn.call("health_report", {
                    "node_id": self.node_id.binary(),
                    "resources_available": self.resources_available,
                    "load": self._fair.pending_count(),
                    # queued resource shapes drive autoscaling (parity:
                    # resource_load_by_shape in the reference's syncer)
                    "pending_demand": [lease.resources for lease in
                                       self._fair.pending()[:100]],
                    # per-job in-flight usage: the GCS WALs it per node
                    # so quota accounting survives a head SIGKILL
                    "lease_usage": self._fair.export_usage(),
                    # per-node reporter payload (parity:
                    # dashboard/modules/reporter) — node cpu/mem plus
                    # per-worker cpu%/rss
                    "node_stats": self._collect_node_stats(),
                }, timeout=5.0)
                if not reply.get("acked"):
                    logger.error("GCS rejected health report; exiting raylet")
                    break
                self._apply_gcs_state(reply.get("state"))
                self._apply_quotas(reply.get("quotas"))
                if not self._view_subscribed:
                    # a re-register's subscribe failed: retry every beat
                    # (without the subscription the view would freeze on
                    # its last snapshot forever)
                    try:
                        await self.gcs_conn.call(
                            "subscribe", {"channel": "resource_view"},
                            timeout=5.0)
                        self._view_subscribed = True
                        self._view_stale = True  # catch missed deltas
                    except (rpc.ConnectionLost, rpc.RpcError,
                            asyncio.TimeoutError):
                        pass
                if self._view_stale:
                    # deltas flow via the resource_view subscription; a
                    # full fetch happens only on startup or version gap
                    await self._resync_view()
                self._gcs_misses = 0
            except (rpc.ConnectionLost, rpc.RpcError, asyncio.TimeoutError):
                if self._closing:
                    break
                self._gcs_misses = getattr(self, "_gcs_misses", 0) + 1
                _tm.heartbeat_miss()
                logger.warning("GCS unreachable from raylet %s (%d)",
                               self.node_id.hex()[:12], self._gcs_misses)
                # the GCS may be RESTARTING (reference: raylets buffer
                # through a GCS restart and re-register —
                # test_gcs_fault_tolerance.py): reconnect + re-register
                # with the same node id before giving up.  Attempts are
                # gated by a jittered exponential backoff clock so a
                # fleet-wide head restart doesn't stampede every raylet
                # into synchronized once-per-beat re-registration.
                now = time.monotonic()
                if now >= getattr(self, "_gcs_reconnect_next", 0.0):
                    self._gcs_reconnect_next = now + rpc.gcs_reconnect_delay(
                        getattr(self, "_gcs_reconnect_attempts", 0),
                        self.config)
                    self._gcs_reconnect_attempts = getattr(
                        self, "_gcs_reconnect_attempts", 0) + 1
                    if await self._try_gcs_reconnect():
                        self._gcs_misses = 0
                        self._gcs_reconnect_attempts = 0
                        self._gcs_reconnect_next = 0.0
                        continue
                if self._gcs_misses * self.config.health_report_period_s > \
                        self.config.health_timeout_s * 3:
                    # head is gone for good: tear down this node (workers
                    # follow via their raylet connections dropping)
                    logger.error("GCS dead; raylet exiting")
                    os._exit(0)
            await asyncio.sleep(self.config.health_report_period_s)

    async def _try_gcs_reconnect(self) -> bool:
        try:
            conn = await rpc.connect(self.gcs_address, timeout=3.0,
                                     handler=self.server)
            reply = await conn.call("register_node", {
                "node_id": self.node_id.binary(),
                "raylet_address": list(self.address),
                "protocol_version": rpc.PROTOCOL_VERSION,
                "resources": self.resources_total,
                "topology": self.topology,
                "max_workers": self._max_workers,
            }, timeout=5.0)
            if self.gcs_conn is not None:
                self.gcs_conn.close()
            self.gcs_conn = conn
            conn.set_push_handler(self._on_gcs_push)
            self._view_stale = True
            self._view_subscribed = False
            try:
                await conn.call("subscribe", {"channel": "resource_view"},
                                timeout=5.0)
                self._view_subscribed = True
            except (rpc.ConnectionLost, rpc.RpcError,
                    asyncio.TimeoutError):
                pass  # the health loop retries each beat
            # resume the durable lifecycle verdict: a GCS restart
            # mid-drain must not re-open a DRAINING node's lease plane
            self._apply_gcs_state(reply.get("state"))
            self._apply_quotas(reply.get("quotas"))
            logger.info("raylet %s re-registered with restarted GCS",
                        self.node_id.hex()[:12])
            return bool(reply)
        except (rpc.ConnectionLost, rpc.RpcError, OSError,
                asyncio.TimeoutError):
            return False

    # ------------------------------------------------------------------
    # node lifecycle + quota plane (docs/autoscaler.md)
    # ------------------------------------------------------------------
    def _lease_usage_truth(self) -> Dict[str, Dict[str, float]]:
        """Per-job in-flight resources from the LIVE lease table (the
        granted workers themselves) — the ground truth the fair queue's
        advisory ledger reconciles against."""
        truth: Dict[str, Dict[str, float]] = {}
        for w in self.workers.values():
            if w.leased and w.lease_job_key:
                usage = truth.setdefault(w.lease_job_key, {})
                for k, v in w.lease_resources.items():
                    usage[k] = usage.get(k, 0.0) + v
        return truth

    def _apply_gcs_state(self, state: Optional[str]) -> None:
        """Adopt the GCS's durable lifecycle verdict for this node.
        DRAINING/DRAINED closes the lease plane (a head restart
        mid-drain re-delivers the verdict here); ACTIVE re-opens it —
        the GCS aborted the drain, so any still-running local drain is
        cancelled and queued leases get scheduled again."""
        if state is None:
            return
        if state in (NODE_DRAINING, NODE_DRAINED):
            if not self._draining:
                logger.info("raylet %s entering %s (GCS verdict)",
                            self.node_id.hex()[:12], state)
                self._draining = True
        elif self._draining:
            task, self._drain_task = self._drain_task, None
            if task is not None and not task.done():
                task.cancel()
            self._draining = False
            logger.info("raylet %s back to ACTIVE (drain aborted)",
                        self.node_id.hex()[:12])
            self._maybe_schedule()

    def _apply_quotas(self, quotas: Optional[Dict[str, Any]]) -> None:
        """Install the GCS quota table (full-state replace: jobs gone
        from the table lose their local quota too)."""
        if quotas is None:
            return
        fresh: Set[str] = set()
        for job, q in quotas.items():
            try:
                self._fair.set_quota(job, JobQuota.from_dict(q))
            except Exception:  # noqa: BLE001 — one bad row, not all
                continue
            fresh.add(job)
        for job in self._gcs_quota_jobs - fresh:
            self._fair.remove_quota(job)
        self._gcs_quota_jobs = fresh

    async def handle_drain(self, conn, data):
        """GCS-driven graceful drain (docs/autoscaler.md): quiesce the
        lease plane, migrate every pinned primary + local spill blob to
        an ACTIVE peer, and reply ok only when NOTHING on this node is
        the last copy of anything.  Any failure replies not-ok — the
        GCS aborts the drain and this node goes back to serving with
        its object plane untouched (the success path is the only one
        that releases pins)."""
        peers = [p for p in data.get("peers", [])
                 if bytes(p["node_id"]) != self.node_id.binary()]
        task = self._drain_task
        if task is None:
            self._draining = True
            task = self._drain_task = asyncio.ensure_future(
                self._drain_impl(peers))
        try:
            # shield: a dropped GCS connection mid-drain must not kill
            # the migration — the GCS retry coalesces onto this task
            result = await asyncio.shield(task)
        except asyncio.CancelledError:
            if not task.cancelled():
                # the HANDLER was cancelled (connection torn down),
                # not the drain — shield kept the migration running
                raise
            # cancelled by _apply_gcs_state (GCS-side abort): the node
            # is already back to ACTIVE there
            return {"ok": False, "error": "drain cancelled"}
        except Exception as e:  # noqa: BLE001 — abort, stay serving
            result = {"ok": False, "error": f"{type(e).__name__}: {e}"}
        if not result.get("ok"):
            self._draining = False
            self._drain_task = None
            self._maybe_schedule()
        return result

    def _respill_queued(self) -> Optional[str]:
        """Move every queued lease to an ACTIVE peer; returns an error
        string when one cannot move (pinned demand, or no feasible
        peer) — the drain must abort so the request is served HERE."""
        for lease in self._fair.pending():
            if lease.future.done():
                self._fair.remove(lease)
                continue
            spill = None
            if lease.bundle is None:
                spill = self._pick_spillback(lease.resources,
                                             lease.request,
                                             force_remote=True)
            if spill is None:
                return ("queued lease %s cannot move to a peer"
                        % (lease.resources,))
            self._fair.remove(lease)
            lease.future.set_result({"spillback": spill})
        return None

    async def _drain_impl(self, peers: List[Dict[str, Any]]
                          ) -> Dict[str, Any]:
        # 1) actors pin their host: their in-memory state can't migrate
        actors = sum(1 for w in self.workers.values() if w.is_actor)
        if actors:
            return {"ok": False,
                    "error": f"{actors} actor(s) hosted on node"}
        # 2) wait (bounded) for in-flight task leases to come home,
        #    nudging owners to cut their idle-lease grace short
        deadline = time.monotonic() + max(
            1.0, 0.4 * getattr(self.config, "drain_timeout_s", 60.0))
        while any(w.leased for w in self.workers.values()):
            for w in list(self.workers.values()):
                c = w.owner_conn
                if w.leased and c is not None and not c.closed:
                    c.push("reclaim_idle", {})
            if time.monotonic() > deadline:
                n = sum(1 for w in self.workers.values() if w.leased)
                return {"ok": False,
                        "error": f"{n} lease(s) still in flight"}
            await asyncio.sleep(0.05)
        # 3) queued leases move to peers (or the drain aborts)
        err = self._respill_queued()
        if err is not None:
            return {"ok": False, "error": err}
        # 4) object migration: every pinned primary and every local
        #    spill blob gets adopted (pulled + re-pinned) by a peer
        #    BEFORE this node drops anything.  URI-spilled blobs
        #    already outlive this node — the owner holds the URI.
        to_move: List[Tuple[ObjectID, bool]] = \
            [(oid, False) for oid in self._primary]
        to_move += [(oid, True) for oid, target in self._spilled.items()
                    if "://" not in target and oid not in self._primary]
        if to_move and not peers:
            return {"ok": False,
                    "error": "no ACTIVE peers to adopt objects"}
        migrated = spill_handed_off = 0
        rr = 0
        for oid, spilled in to_move:
            adopted = None
            for attempt in range(len(peers)):
                peer = peers[(rr + attempt) % len(peers)]
                try:
                    pconn = await self.pool.get(tuple(peer["address"]))
                    owner = self._owner_of.get(oid)
                    reply = await pconn.call("adopt_object", {
                        "object_id": oid.binary(),
                        "owner": list(owner) if owner else None,
                        "source": list(self.server.address),
                        "spilled": spilled,
                    }, timeout=30.0)
                except (rpc.ConnectionLost, rpc.RpcError,
                        asyncio.TimeoutError, OSError):
                    continue
                if reply and reply.get("ok"):
                    adopted = reply
                    break
            rr += 1
            if adopted is None:
                return {"ok": False,
                        "error": f"migration of {oid.hex()[:12]} failed"}
            # byte-identity guard: the adopted copy must be the size we
            # hold (content equality rides the pull protocol's chunking)
            expect = self._spilled_sizes.get(oid)
            if expect is None:
                lease = self.store.lease(oid)
                if lease is not None:
                    expect = lease[1]
                    self.store.release(oid)
            if expect is not None and adopted.get("size") != expect:
                return {"ok": False,
                        "error": f"adopted copy of {oid.hex()[:12]} is "
                                 f"{adopted.get('size')} bytes, "
                                 f"expected {expect}"}
            # hand-off complete: drop OUR claim.  The arena copy left
            # behind is a plain evictable secondary on a node about to
            # terminate; the spill blob is deleted outright.
            if spilled:
                target = self._spilled.pop(oid, None)
                self._spill_bytes -= self._spilled_sizes.pop(oid, 0)
                if target is not None:
                    await asyncio.get_running_loop().run_in_executor(
                        None, self._delete_spill_blob, target)
                spill_handed_off += 1
            else:
                self._primary.discard(oid)
                self.store.release(oid)
                migrated += 1
        # 5) leases that arrived during the migration: move or abort
        err = self._respill_queued()
        if err is not None:
            return {"ok": False, "error": err}
        logger.info("raylet %s drained: %d primaries migrated, %d "
                    "spill blobs handed off", self.node_id.hex()[:12],
                    migrated, spill_handed_off)
        return {"ok": True, "migrated": migrated,
                "spill_handed_off": spill_handed_off}

    async def handle_adopt_object(self, conn, data):
        """Drain-migration target (peer side): pull the object — via
        the owner's directory when it has one, so the transfer chains
        like any broadcast pull, else straight from the draining source
        — and pin it as OUR primary before the drainer releases."""
        oid = ObjectID(data["object_id"])
        owner = tuple(data["owner"]) if data.get("owner") else None
        ok = self.store.contains(oid)
        if not ok and owner is not None:
            ok = await self._make_local(oid, owner,
                                        time.monotonic() + 25.0)
        if not ok and data.get("source"):
            src = tuple(data["source"])
            ok = await self._pull_object(oid, [src], [], None)
        if not ok:
            return {"ok": False, "error": "pull failed"}
        lease = self.store.lease(oid)
        if lease is None:
            return {"ok": False, "error": "adopted copy vanished"}
        size = lease[1]
        self.store.release(oid)
        self._mark_primary(oid, owner)
        return {"ok": True, "size": size}

    # ------------------------------------------------------------------
    # memory monitor + worker killing policy (parity:
    # src/ray/common/memory_monitor.h:52, raylet/worker_killing_policy.h:30)
    # ------------------------------------------------------------------
    @staticmethod
    def _memory_used_fraction() -> float:
        """Host memory pressure from /proc/meminfo (MemAvailable)."""
        try:
            total = avail = None
            with open("/proc/meminfo") as f:
                for line in f:
                    if line.startswith("MemTotal:"):
                        total = float(line.split()[1])
                    elif line.startswith("MemAvailable:"):
                        avail = float(line.split()[1])
                    if total is not None and avail is not None:
                        break
            if not total or avail is None:
                # unknown availability must read as "no pressure", not
                # 100% used — else the monitor becomes a kill loop
                return 0.0
            return 1.0 - avail / total
        except OSError:
            return 0.0

    def _pick_oom_victim(self) -> Optional[WorkerHandle]:
        """Retriable-LIFO (reference policy): among leased workers,
        prefer retriable plain tasks (owners resubmit them), newest
        lease first; non-retriable tasks next; actors only as the last
        resort (killing one loses state)."""
        leased = [w for w in self.workers.values()
                  if w.leased and w.proc is not None]
        for group in (
            [w for w in leased if not w.is_actor and w.lease_retriable],
            [w for w in leased if not w.is_actor and not w.lease_retriable],
            [w for w in leased if w.is_actor],
        ):
            if group:
                return max(group, key=lambda w: w.lease_granted_at)
        return None

    def _collect_node_stats(self) -> Dict[str, Any]:
        """Node + per-worker process stats (parity: the reference's
        dashboard reporter agent collecting psutil stats per node)."""
        try:
            import psutil
        except ImportError:
            return {}
        try:
            vm = psutil.virtual_memory()
            stats: Dict[str, Any] = {
                "cpu_percent": psutil.cpu_percent(interval=None),
                "mem_percent": vm.percent,
                "mem_used": int(vm.used),
                "mem_total": int(vm.total),
                "workers": [],
            }
            for w in list(self.workers.values()):
                try:
                    p = psutil.Process(w.pid)
                    with p.oneshot():
                        stats["workers"].append({
                            "pid": w.pid,
                            "worker_id": w.worker_id.hex(),
                            "cpu_percent": p.cpu_percent(interval=None),
                            "rss": int(p.memory_info().rss),
                            "is_actor": bool(w.is_actor),
                        })
                except (psutil.NoSuchProcess, psutil.AccessDenied):
                    pass
            return stats
        except Exception:  # noqa: BLE001 — stats must never hurt health
            return {}

    async def _memory_monitor_loop(self) -> None:
        period = self.config.memory_monitor_refresh_ms / 1000.0
        threshold = self.config.memory_usage_threshold
        while not self._closing:
            await asyncio.sleep(period)
            try:
                used = self._memory_used_fraction()
                if used <= threshold:
                    continue
                victim = self._pick_oom_victim()
                if victim is None:
                    continue
                logger.warning(
                    "memory pressure %.0f%% > %.0f%%: killing worker "
                    "%s (pid %d) to protect the node; its task will be "
                    "retried", used * 100, threshold * 100,
                    victim.worker_id.hex()[:12], victim.pid)
                victim.proc.kill()
                self._event_mod.emit(
                    "ERROR", "OOM_KILL",
                    f"memory monitor killed worker pid {victim.pid} at "
                    f"{used:.0%} used", node_id=self.node_id.hex(),
                    worker_id=victim.worker_id.hex(), pid=victim.pid)
                self._on_worker_dead(
                    victim, f"killed by memory monitor at "
                            f"{used:.0%} used")
            except Exception:
                logger.exception("memory monitor iteration failed")

    def _forget_worker_logs(self, pid: int) -> None:
        for path in [p for p, wpid in self._log_pids.items()
                     if wpid == pid]:
            self._log_pids.pop(path, None)
            self._log_offsets.pop(path, None)

    @staticmethod
    def _scan_worker_logs(snapshot):
        """Read new complete lines from worker log files.  Sync —
        ``_log_monitor_loop`` runs it in an executor because a tick can
        read up to 1 MiB per file off a cold page cache, which must not
        stall the raylet's event loop (leases, pulls, heartbeats).
        Takes ``[(path, pid, offset)]``; returns ``(batch, offsets)``
        with only the offsets that advanced."""
        batch: List[Dict[str, Any]] = []
        offsets: Dict[str, int] = {}
        for path, pid, offset in snapshot:
            try:
                size = os.path.getsize(path)
                if size <= offset:
                    continue
                with open(path, "rb") as f:
                    f.seek(offset)
                    chunk = f.read(min(size - offset, 1 << 20))
            except OSError:
                # file vanished/unreadable mid-scan (worker reaped):
                # skip it, keep the rest of the tick's batch
                continue
            # only complete lines; partial tail re-read next
            # tick.  A single line longer than the read window
            # would never complete — force-flush so the offset
            # always advances.
            cut = chunk.rfind(b"\n")
            if cut < 0:
                if len(chunk) < (1 << 20):
                    continue
                cut = len(chunk) - 1
            offsets[path] = offset + cut + 1
            lines = chunk[:cut + 1].decode(errors="replace").splitlines()
            if lines:
                batch.append({"pid": pid,
                              "is_err": path.endswith(".err"),
                              "lines": lines})
        return batch, offsets

    async def _log_monitor_loop(self) -> None:
        """Tail worker stdout/stderr files and publish new lines to the
        GCS so drivers can echo them (parity: log_monitor.py:100 ->
        pubsub -> driver '(pid=...)' prefixes)."""
        loop = asyncio.get_running_loop()
        while not self._closing:
            await asyncio.sleep(0.5)
            try:
                snapshot = [(path, pid, self._log_offsets.get(path, 0))
                            for path, pid in self._log_pids.items()]
                batch, offsets = await loop.run_in_executor(
                    None, self._scan_worker_logs, snapshot)
                for path, offset in offsets.items():
                    # a worker reaped mid-scan must stay forgotten
                    if path in self._log_pids:
                        self._log_offsets[path] = offset
                if batch and self.gcs_conn and not self.gcs_conn.closed:
                    await self.gcs_conn.call("publish", {
                        "channel": "worker_logs",
                        "message": {
                            "node_id": self.node_id.hex()[:8],
                            "records": batch,
                        }})
            except (rpc.ConnectionLost, rpc.RpcError, asyncio.TimeoutError):
                pass
            except Exception:
                logger.exception("log monitor iteration failed")

    async def _reap_loop(self) -> None:
        """Detect dead worker processes (parity: WorkerPool SIGCHLD path)."""
        while not self._closing:
            for w in list(self.workers.values()):
                if w.proc is not None and w.proc.poll() is not None:
                    self._on_worker_dead(w, f"exit code {w.proc.returncode}")
            # workers that died before registering (startup crash)
            for entry in list(self._spawned_procs):
                proc, token = entry[0], entry[3]
                if proc.poll() is not None:
                    self._spawned_procs.remove(entry)
                    self._dec_starting(entry[2])
                    env_hash = self._env_spawn_hash.get(token) \
                        if token else None
                    self._dec_starting_env(token)
                    if env_hash is not None:
                        # an isolated-env worker that dies at boot will
                        # keep dying — break the env instead of hot-
                        # looping spawns; leases fail with this message
                        msg = (f"isolated runtime env worker exited "
                               f"{proc.returncode} at startup (see "
                               f"worker logs in {self.session_dir}"
                               f"/logs)")
                        self._env_broken[env_hash] = msg
                        asyncio.get_running_loop().call_later(
                            30.0,
                            lambda h=env_hash:
                            self._env_broken.pop(h, None))
                    logger.warning("worker pid %d died before registering "
                                   "(exit %d)", proc.pid, proc.returncode)
                    self._maybe_schedule()
            # trim the idle pool back to the prestart watermark: demand
            # from many distinct clients can grow it past the per-core
            # cap (see cap_bonus in _maybe_schedule); workers idle >10 s
            # are surplus
            target = self._pool_target()
            now = time.monotonic()
            # env-bound workers get a much longer grace (their
            # interpreter IS the runtime env; a respawn replays the
            # whole env build) but are not exempt — exemption leaked
            # one interpreter per distinct env forever
            while len(self._idle) > target and self._cull_idle_spare(
                    lambda w: now - w.idle_since >
                    (300.0 if w.env_hash is not None else 10.0)):
                pass
            # safety re-kick: if demand is queued with nothing idle and
            # no retry timer armed (e.g. _maybe_schedule ran without a
            # loop), rescan so waiting leases can't stall indefinitely
            if self._fair.pending_count() and not self._idle \
                    and not self._reclaim_timer_armed:
                self._maybe_schedule()
            # demand-driven pool rebuild, only while the lease plane is
            # QUIET (spawn storms during an active wave steal the CPU
            # the wave itself needs) and rate-limited per tick
            # (warm_pool_rebuild_per_tick): the next actor wave then
            # lands on warm forks.  Counted against PLAIN idle workers —
            # idle env workers can't serve ordinary leases and must not
            # suppress the rebuild.
            if not self._fair.pending_count() and not self._closing and \
                    not self._creating_actors and \
                    now - getattr(self, "_last_lease_ts", 0.0) > 1.5:
                idle_plain = sum(1 for w in self._idle
                                 if w.env_hash is None)
                deficit = target - idle_plain - self._starting
                bonus = max(0, target - self._max_workers)
                per_tick = max(1, int(getattr(
                    self.config, "warm_pool_rebuild_per_tick", 4)))
                for _ in range(min(per_tick, deficit)):
                    if not self._start_worker(None, cap_bonus=bonus):
                        break
            self._maybe_spill_ahead()
            await asyncio.sleep(0.2)

    def _maybe_spill_ahead(self) -> None:
        """Async spill-AHEAD: when arena use
        crosses ``object_spill_ahead_watermark`` — a line BELOW the
        create-path spill threshold — kick one background sweep that
        spills cold sealed primaries back toward the watermark, off the
        critical path.  A later pressure burst (streaming shuffle
        intermediates, bursty puts) then finds headroom instead of
        paying blob-write latency inside ``put()``.  One sweep at a
        time; it shares ``_spill_lock`` with the reactive path, so the
        two can never double-spill."""
        wm = float(getattr(self.config, "object_spill_ahead_watermark",
                           0.0) or 0.0)
        if wm <= 0 or self._closing or self._spill_ahead_running:
            return
        target = wm * self.store_capacity
        if self.store.used() <= target:
            return
        self._spill_ahead_running = True
        task = asyncio.get_running_loop().create_task(
            self._spill_ahead_sweep(target))
        task.add_done_callback(lambda t: t.exception())

    async def _spill_ahead_sweep(self, target: float) -> None:
        try:
            if self._spill_lock is None:
                self._spill_lock = asyncio.Lock()
            async with self._spill_lock:
                used = self.store.used()
                if used > target:
                    await self._spill_sweep(int(used - target))
        except Exception:  # noqa: BLE001 — ahead-of-time work only;
            # the reactive create-path sweep still guards correctness
            logger.exception("spill-ahead sweep failed")
        finally:
            self._spill_ahead_running = False

    # ------------------------------------------------------------------
    # worker pool
    # ------------------------------------------------------------------
    def _start_worker(self, job_id_bin: Optional[bytes],
                      needs_gpu: bool = False, cap_bonus: int = 0) -> bool:
        """Returns False when the pool cap declines the spawn.

        ``cap_bonus`` lets demand from DISTINCT clients grow the pool past
        the per-core cap: leases are exclusive per client, so on a
        low-core host N concurrent clients would otherwise serialize
        behind worker handoffs even for CPU:0 work (the 1->8-client
        scaling collapse).  Bounded in _maybe_schedule.
        """
        # the cap bounds the *task pool*; workers holding actors live
        # outside it (parity: reference WorkerPool — actor workers are
        # dedicated, else a few CPU:0 actors starve all task execution)
        pool_size = self._starting + sum(
            1 for w in self.workers.values() if not w.is_actor)
        if pool_size >= self._max_workers + cap_bonus:
            return False
        self._starting += 1
        if needs_gpu:
            self._starting_gpu += 1
        env = dict(os.environ)
        env["RAY_TPU_TORCH_WORKER"] = "1"
        log_base = os.path.join(self.session_dir, "logs",
                                f"worker-{os.getpid()}-{self._starting}-{time.monotonic_ns()}")
        os.makedirs(os.path.dirname(log_base), exist_ok=True)
        worker_args = [
            "--raylet", f"{self.server.address[0]}:{self.server.address[1]}",
            "--gcs", f"{self.gcs_address[0]}:{self.gcs_address[1]}",
            "--node-id", self.node_id.hex(),
            "--store-path", self.store.path,
            "--store-capacity", str(self.store_capacity),
            "--session-dir", self.session_dir,
        ]
        if job_id_bin is not None:
            worker_args += ["--job-id", job_id_bin.hex()]
        if not needs_gpu and time.monotonic() >= getattr(
                self, "_zygote_broken_until", 0.0):
            # fork from the warm zygote (~10 ms) instead of a cold
            # interpreter (~300 ms) — actor-creation rate on many-core
            # hosts is bounded by this.  Forked workers never lease a
            # GPU: a worker that uses CUDA starts from a fresh
            # interpreter, so no CUDA state ever crosses a fork.
            self._spawn_via_zygote(worker_args, log_base, False,
                                   env, needs_gpu)
            return True
        self._spawn_cold(worker_args, log_base, env, True, needs_gpu)
        return True

    def _spawn_cold(self, worker_args, log_base: str, env: Dict[str, str],
                    gpu_capable: bool, needs_gpu: bool = False) -> None:
        cmd = [sys.executable, "-m", "ray_tpu_torch.core.worker_main",
               *worker_args]
        out = open(log_base + ".out", "ab")
        err = open(log_base + ".err", "ab")
        from ray_tpu_torch.core.node import safe_die_with_parent

        # workers die with their raylet (a worker without its raylet is
        # unreachable; reference workers exit on raylet death).  The
        # raylet loop runs on the process main thread, so the PDEATHSIG
        # thread caveat doesn't bite; gate anyway for exotic embeddings.
        # Armed child-side (worker_main) so Popen stays preexec_fn-free
        # and takes the posix_spawn path — forking a process with
        # threads running is the latent-deadlock class.
        if safe_die_with_parent():
            env["RAY_TPU_TORCH_PDEATHSIG"] = str(os.getpid())
        proc = subprocess.Popen(
            cmd, env=env, stdout=out, stderr=err, close_fds=False)
        # log monitor maps these files to the worker pid for prefixes
        self._log_pids[log_base + ".out"] = proc.pid
        self._log_pids[log_base + ".err"] = proc.pid
        # handle registered later in handle_register_worker; remember proc
        self._spawned_procs.append((proc, gpu_capable, needs_gpu, None))

    def _start_env_worker(self, lease: "PendingLease") -> None:
        """Spawn a worker under an isolated runtime env (venv / conda /
        container / py_executable).  The env build (pip install, conda
        create, image pull) can take seconds-to-minutes, so it runs in
        the default executor; the io loop only does bookkeeping.
        Isolated workers register pre-bound to their env_hash and never
        serve other envs."""
        env_hash, env_spawn = lease.env_hash, dict(lease.env_spawn)
        # same cap formula as _start_worker (idle workers are already in
        # self.workers — counting them twice would stall at half cap)
        pool_size = self._starting + sum(
            1 for w in self.workers.values() if not w.is_actor)
        if pool_size >= self._max_workers:
            # make room, else the lease waits for pool churn
            if not self._cull_idle_spare(lambda w: w.env_hash is None):
                return
        token = f"env-{env_hash}-{time.monotonic_ns()}"
        self._starting += 1
        self._starting_env[env_hash] = \
            self._starting_env.get(env_hash, 0) + 1
        env = dict(os.environ)
        env["RAY_TPU_TORCH_WORKER"] = "1"
        env["RAY_TPU_TORCH_WORKER_ENV_HASH"] = env_hash
        env["RAY_TPU_TORCH_WORKER_SPAWN_TOKEN"] = token
        # isolated interpreters may not have ray_tpu_torch on their default
        # path (venv --system-site-packages does; conda/container need
        # the package root)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = pkg_root + (
            ":" + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
        log_base = os.path.join(
            self.session_dir, "logs",
            f"worker-{os.getpid()}-{self._starting}-{time.monotonic_ns()}")
        os.makedirs(os.path.dirname(log_base), exist_ok=True)
        worker_args = [
            "--raylet",
            f"{self.server.address[0]}:{self.server.address[1]}",
            "--gcs", f"{self.gcs_address[0]}:{self.gcs_address[1]}",
            "--node-id", self.node_id.hex(),
            "--store-path", self.store.path,
            "--store-capacity", str(self.store_capacity),
            "--session-dir", self.session_dir,
        ]
        if lease.job_id_bin is not None:
            worker_args += ["--job-id", lease.job_id_bin.hex()]
        from ray_tpu_torch.core.node import safe_die_with_parent

        if safe_die_with_parent():
            env["RAY_TPU_TORCH_PDEATHSIG"] = str(os.getpid())
        loop = asyncio.get_running_loop()

        def build_and_spawn():
            from ray_tpu_torch import runtime_env as renv

            cmd = renv.resolve_worker_command(
                env_spawn,
                [sys.executable, "-m", "ray_tpu_torch.core.worker_main",
                 *worker_args],
                mounts=[self.session_dir],
                passthrough_env={
                    "RAY_TPU_TORCH_WORKER": "1",
                    "RAY_TPU_TORCH_WORKER_ENV_HASH": env_hash,
                    "RAY_TPU_TORCH_WORKER_SPAWN_TOKEN": token,
                })
            out = open(log_base + ".out", "ab")
            err = open(log_base + ".err", "ab")
            return subprocess.Popen(cmd, env=env, stdout=out,
                                    stderr=err, close_fds=False)

        fut = loop.run_in_executor(None, build_and_spawn)

        def _done(f):
            try:
                proc = f.result()
            except Exception as e:  # noqa: BLE001 — report to leases
                logger.exception("isolated runtime env %s build/spawn "
                                 "failed", env_hash)
                msg = f"runtime env build failed: {e}"
                self._env_broken[env_hash] = msg
                # transient causes (network, registry) deserve a retry
                loop.call_later(
                    30.0, lambda: self._env_broken.pop(env_hash, None))
                self._starting -= 1
                self._starting_env[env_hash] -= 1
                self._maybe_schedule()  # fails the waiting leases
                return
            self._log_pids[log_base + ".out"] = proc.pid
            self._log_pids[log_base + ".err"] = proc.pid
            self._env_spawn_hash[token] = env_hash
            self._spawned_procs.append((proc, False, False, token))

        fut.add_done_callback(_done)

    def _spawn_via_zygote(self, worker_args, log_base: str,
                          gpu_capable: bool, env: Dict[str, str],
                          needs_gpu: bool = False) -> None:
        if getattr(self, "_zygote", None) is None:
            self._zygote = _ZygoteClient(self.session_dir)
        loop = asyncio.get_running_loop()
        zygote = self._zygote

        def _fork():
            # failpoint: the zygote fork fails — the raylet must fall
            # back to a cold spawn and back off the fork path for a
            # while, never wedge the lease that wanted the worker
            _fp.failpoint("raylet.zygote.fork_fail")
            return zygote.spawn(worker_args, {"RAY_TPU_TORCH_WORKER": "1"},
                                log_base)

        fut = loop.run_in_executor(None, _fork)

        def _done(f):
            try:
                pid = f.result()
            except Exception:
                # broken zygote: cold-spawn this worker now and stop
                # using the fork path for a while (a hot retry loop
                # would pay a failed ~300ms zygote start per lease)
                logger.exception(
                    "zygote spawn failed; cold-spawning and backing off")
                self._zygote_broken_until = time.monotonic() + 30.0
                try:
                    self._zygote.stop()
                except Exception:
                    pass
                self._zygote = None
                self._spawn_cold(worker_args, log_base, env, True,
                                 needs_gpu)
                return
            handle = _ForkedProc(pid)
            self._log_pids[log_base + ".out"] = pid
            self._log_pids[log_base + ".err"] = pid
            # the child usually registers AFTER this callback (it must
            # finish CoreWorker init first), but adopt either ordering
            for worker in self.workers.values():
                if worker.pid == pid and worker.proc is None:
                    worker.proc = handle
                    worker.gpu_capable = gpu_capable
                    self._dec_starting(needs_gpu)
                    self._maybe_schedule()  # freed pool capacity
                    return
            self._spawned_procs.append((handle, gpu_capable, needs_gpu, None))

        fut.add_done_callback(_done)

    async def handle_register_worker(self, conn, data):
        if data.get("is_driver"):
            # drivers use the object plane but never join the worker pool
            conn.context["is_driver"] = True
            return {"node_id": self.node_id.binary(),
                    "config": self.config.to_json(),
                    "profiler": self._profiler_handoff()}
        wid = WorkerID(data["worker_id"])
        existing = self.workers.get(wid)
        if existing is not None and existing.conn is conn:
            # replayed registration (the pool retries register_worker
            # after a lost ack): the first delivery already adopted the
            # spawn handle, decremented _starting, and pooled the
            # worker — pooling it into _idle AGAIN would double-lease
            # it, so just re-serve the ack
            return {"node_id": self.node_id.binary(),
                    "config": self.config.to_json(),
                    "profiler": self._profiler_handoff()}
        worker = WorkerHandle(
            worker_id=wid,
            pid=data["pid"],
            job_id_bin=data.get("job_id"),
            conn=conn,
            task_address=tuple(data["task_address"]),
        )
        # adopt the spawned process handle: spawn token first (container
        # workers register with a namespaced pid), host pid otherwise
        reg_token = data.get("spawn_token")
        for entry in list(self._spawned_procs):
            proc, gpu_capable, was_gpu_spawn, token = entry
            # with a spawn token, match on it EXCLUSIVELY: a container
            # worker's namespaced pid can collide with an unrelated
            # pending proc entry, mis-adopting the handle and corrupting
            # the _starting accounting
            if (token == reg_token) if reg_token is not None \
                    else (proc.pid == worker.pid):
                worker.proc = proc
                worker.gpu_capable = gpu_capable
                self._spawned_procs.remove(entry)
                self._dec_starting(was_gpu_spawn)
                break
        # isolated-env workers are born bound to their env
        env_hash = data.get("env_hash") \
            or (self._env_spawn_hash.get(reg_token) if reg_token else None)
        if env_hash is not None:
            worker.env_hash = env_hash
            worker.gpu_capable = False
        self._dec_starting_env(reg_token)
        conn.context["worker_id"] = worker.worker_id
        self.workers[worker.worker_id] = worker
        worker.idle_since = time.monotonic()
        self._idle.append(worker)
        self._maybe_schedule()
        return {"node_id": self.node_id.binary(),
                "config": self.config.to_json(),
                "profiler": self._profiler_handoff()}

    def _profiler_handoff(self) -> Optional[Dict[str, Any]]:
        """Profiler state for a registering worker: the remaining slice
        of an in-progress window, or None when not profiling."""
        state = self._profiler_state
        if not state or not state.get("enabled"):
            return None
        deadline = state.get("deadline")
        remaining = None
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self._profiler_state = None
                return None
        return {"enabled": True, "hz": state.get("hz"),
                "remaining_s": remaining}

    async def handle_profiler_control(self, conn, data):
        """Apply a cluster profiling window to this node: the raylet's
        own sampler plus a best-effort fan-out to every live worker
        (dead/wedged workers are exactly what the profile should not
        block on)."""
        enabled = bool(data["enabled"])
        hz = data.get("hz")
        duration = data.get("duration_s")
        _prof.configure(enabled, hz=hz, duration_s=duration)
        self._profiler_state = {
            "enabled": enabled, "hz": hz,
            "deadline": (time.monotonic() + float(duration)
                         if enabled and duration else None),
        } if enabled else None

        async def one(conn2):
            try:
                await asyncio.wait_for(
                    conn2.call("profiler_control", data), 5.0)
                return True
            except Exception:  # noqa: BLE001 — best effort
                return False

        # workers by handle, plus DRIVER registration conns (drivers
        # never join the pool, but a training driver's loop is often
        # exactly the thing worth sampling)
        targets = [w.conn for w in self.workers.values()]
        targets += [c for c in self.server.connections
                    if c.context.get("is_driver") and not c.closed]
        results = await asyncio.gather(*(one(c) for c in targets))
        return {"node_id": self.node_id.hex(),
                "workers_applied": sum(1 for r in results if r),
                "workers_total": len(results)}

    def on_disconnection(self, conn) -> None:
        # release transfer pins a crashed/vanished puller left behind —
        # without this a dead puller pinned this node's copies forever
        # (they could never be evicted or spilled)
        for oid in conn.context.pop("pull_leases", set()):
            try:
                self.store.release(oid)
            except Exception:  # noqa: BLE001 — store may be closing
                pass
        conn.context.pop("pull_offsets", None)
        # close spill-file serves a dead puller left open (the fd pins
        # the blob's inode against owner-free unlinks)
        for fd, _size in conn.context.pop("spill_serves", {}).values():
            try:
                os.close(fd)
            except OSError:
                pass
        worker_id = conn.context.get("worker_id")
        if worker_id is not None:
            w = self.workers.get(worker_id)
            if w is not None:
                self._on_worker_dead(w, "connection lost")

    def _on_worker_dead(self, worker: WorkerHandle, reason: str) -> None:
        self.workers.pop(worker.worker_id, None)
        # stop tailing the dead worker's logs after one more tick (which
        # drains any final lines)
        try:
            asyncio.get_event_loop().call_later(
                2.0, self._forget_worker_logs, worker.pid)
        except RuntimeError:
            self._forget_worker_logs(worker.pid)
        if worker in self._idle:
            self._idle.remove(worker)
        if worker.leased:
            self._release_lease_resources(worker)
        logger.info("worker %s (pid %d) dead: %s",
                    worker.worker_id.hex()[:12], worker.pid, reason)
        _flight.record("worker_dead",
                       f"pid={worker.pid} "
                       f"wid={worker.worker_id.hex()[:12]} {reason}")
        # forensics: ship the dead worker's flight-ring tail to the GCS
        # incident journal.  A gracefully-exiting worker unlinks its own
        # ring (CoreWorker.shutdown), so a surviving ring for a dead pid
        # means a crash; runtime-intended kills (PG bundle revoke,
        # raylet shutdown) are excluded explicitly.
        if not self._closing \
                and reason != "placement group bundle returned":
            self._ship_flight_tail(worker.pid, reason)
        self._maybe_schedule()

    def _ship_flight_tail(self, pid: int, reason: str) -> None:
        """Read the flight ring a dead process left in the session dir
        and fire-and-forget it to the GCS death-notification path.
        Best-effort by design: a missing/foreign ring or a dropped RPC
        degrades the incident to partial, never blocks worker reaping."""
        tails = []
        for path in _flight.rings_for_pid(self.session_dir, pid):
            tail = _flight.read_ring(path)
            if tail is not None:
                tails.append(tail)
            try:
                os.unlink(path)  # dead pid: nobody writes this again
            except OSError:
                pass
        if not tails or self.gcs_conn is None or self.gcs_conn.closed:
            return

        async def _ship():
            for tail in tails:
                try:
                    await self.gcs_conn.call("report_flight_tail", {
                        "source": tail["source"], "pid": pid,
                        "node_id": self.node_id.binary(),
                        "reason": reason, "torn": tail["torn"],
                        "frames": tail["frames"][-200:],
                    }, timeout=5.0)
                except (rpc.ConnectionLost, rpc.RpcError,
                        asyncio.TimeoutError, OSError):
                    pass  # incident opens partial from the death event

        try:
            t = asyncio.get_event_loop().create_task(_ship())
            t.add_done_callback(lambda t: t.exception())
        except RuntimeError:
            pass

    # ------------------------------------------------------------------
    # resource accounting
    # ------------------------------------------------------------------
    def _resource_pool(self, bundle: Optional[Tuple[bytes, int]]
                       ) -> Dict[str, float]:
        if bundle is not None:
            return self._bundles.get(bundle, {})
        return self.resources_available

    def _fits(self, resources: Dict[str, float],
              bundle: Optional[Tuple[bytes, int]]) -> bool:
        pool = self._resource_pool(bundle)
        return all(pool.get(k, 0.0) >= v for k, v in resources.items())

    def _feasible_ever(self, resources: Dict[str, float],
                       bundle: Optional[Tuple[bytes, int]]) -> bool:
        if bundle is not None:
            pool = self._bundle_totals.get(bundle)
            if pool is None:
                return False
            return all(pool.get(k, 0.0) >= v for k, v in resources.items())
        return all(self.resources_total.get(k, 0.0) >= v
                   for k, v in resources.items())

    def _take(self, resources: Dict[str, float],
              bundle: Optional[Tuple[bytes, int]]) -> None:
        pool = self._resource_pool(bundle)
        for k, v in resources.items():
            pool[k] = pool.get(k, 0.0) - v

    def _give(self, resources: Dict[str, float],
              bundle: Optional[Tuple[bytes, int]]) -> None:
        if bundle is not None and bundle not in self._bundles:
            # bundle was returned while this lease was out: return_bundle
            # refunded only the unleased remainder, so the leased share
            # re-enters the node pool here
            pool = self.resources_available
        else:
            pool = self._resource_pool(bundle)
        for k, v in resources.items():
            pool[k] = pool.get(k, 0.0) + v

    def _utilization(self) -> float:
        fractions = []
        for k, total in self.resources_total.items():
            if total > 0:
                fractions.append(
                    1.0 - self.resources_available.get(k, 0.0) / total)
        return max(fractions) if fractions else 0.0

    # ------------------------------------------------------------------
    # lease scheduling (ClusterTaskManager + LocalTaskManager)
    # ------------------------------------------------------------------
    async def handle_request_worker_lease(self, conn, data):
        """Returns {granted, worker_address, lease_id} | {spillback: addr} —
        or blocks (queues) until a local grant is possible."""
        # failpoint: a slow/failed lease grant — owners must keep their
        # backlog intact (freeze or redispatch), never burn retry budget
        # on a raylet that is merely late
        await _fp.afailpoint("raylet.lease_grant.delay")
        resources = dict(data.get("resources", {}))
        bundle = None
        pg_bin = data.get("placement_group_id")
        if pg_bin is not None:
            bundle = (pg_bin, data.get("bundle_index", -1))
            bundle = self._resolve_bundle(bundle, resources)
            if bundle is None:
                return {"error": "placement group bundle not on this node"}
        job_id_bin = data.get("job_id")
        job_key = job_id_bin.hex() if job_id_bin else f"conn-{id(conn):x}"

        if self._draining:
            # a draining node takes no new work: hand the request to an
            # ACTIVE peer outright.  Pinned demand (placement groups /
            # NODE_AFFINITY) queues — the drain's re-spill pass aborts
            # the drain if it cannot move, so the request never fails.
            spill = self._pick_spillback(resources, data,
                                         force_remote=True)
            if spill is not None:
                return {"spillback": spill}
        elif not self._fits(resources, bundle):
            spill = self._pick_spillback(resources, data)
            if spill is not None:
                return {"spillback": spill}
            if bundle is None and not self._feasible_ever(resources, None) \
                    and not self._feasible_anywhere(resources):
                logger.warning(
                    "lease demand %s infeasible cluster-wide; queueing "
                    "(waiting for new nodes)", resources)
        self._last_lease_ts = time.monotonic()
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        lease = PendingLease(
            request=data, future=fut, job_id_bin=job_id_bin,
            resources=resources, bundle=bundle,
            env_hash=data.get("env_hash"),
            env_spawn=data.get("env_spawn"),
            retriable=bool(data.get("retriable", True)),
            token=data.get("token"), conn=conn, job_key=job_key)
        try:
            self._fair.push(lease, job_key)
        except QuotaExceeded as e:
            # reject-mode tenant past its in-flight ceiling: bounce at
            # admission (the queue-mode alternative parks instead)
            return {"error": str(e), "quota_rejected": True}
        self._maybe_schedule()
        # traced lease (the owner forwarded its head task's context):
        # the queue-wait-until-grant hop joins the request's trace tree
        lease_span = _trace.start_span("raylet.lease",
                                       node=self.node_id.hex()[:12])
        if lease_span is None:
            return await fut
        try:
            result = await fut
        except BaseException:
            # owner conn dropped / dispatch cancelled: the queue-wait
            # hop must still land — a lost span would hide exactly the
            # slow-lease case it exists to explain
            lease_span.end(status="error")
            raise
        lease_span.end(granted=bool(result.get("granted"))
                       if isinstance(result, dict) else False)
        return result

    async def handle_cancel_lease(self, conn, data):
        """The owner's backlog drained before the grant: drop the queued
        request so a later grant doesn't churn a worker through a
        grant->instant-return cycle while real demand waits."""
        token = data.get("token")
        if token is None:
            return False
        for lease in self._fair.pending():
            if lease.token == token:
                self._fair.remove(lease)
                if not lease.future.done():
                    lease.future.set_result({"canceled": True})
                return True
        return False

    def _resolve_bundle(self, bundle: Tuple[bytes, int],
                        resources: Dict[str, float]
                        ) -> Optional[Tuple[bytes, int]]:
        if bundle[1] >= 0:
            return bundle if bundle in self._bundles else None
        # bundle_index == -1: any committed bundle of the group that fits
        for key in self._bundles:
            if key[0] == bundle[0]:
                pool = self._bundles[key]
                if all(pool.get(k, 0.0) >= v for k, v in resources.items()):
                    return key
        # fall back to any bundle of the group (will queue)
        for key in self._bundles:
            if key[0] == bundle[0]:
                return key
        return None

    def _feasible_anywhere(self, resources: Dict[str, float]) -> bool:
        for node in self._cluster_view:
            if not node.get("alive") \
                    or node.get("state", NODE_ACTIVE) != NODE_ACTIVE:
                continue
            total = node.get("resources_total", {})
            if all(total.get(k, 0.0) >= v for k, v in resources.items()):
                return True
        return all(self.resources_total.get(k, 0.0) >= v
                   for k, v in resources.items())

    def _pick_spillback(self, resources: Dict[str, float],
                        data: Dict[str, Any],
                        force_remote: bool = False
                        ) -> Optional[rpc.Address]:
        """Hybrid policy: if local is saturated, hand the lease to the
        least-loaded remote node that can run it *now*.  With
        ``force_remote`` (this node is draining) staying local is not
        an option: any ACTIVE peer that could EVER run the shape takes
        it — the lease may queue there, but it never strands on a node
        about to release."""
        strategy = data.get("strategy", "DEFAULT")
        if strategy == "NODE_AFFINITY" or data.get("placement_group_id"):
            return None  # pinned to this node
        remotes = [n for n in self._cluster_view
                   if n.get("alive")
                   and n.get("state", NODE_ACTIVE) == NODE_ACTIVE
                   and bytes(n["node_id"]) != self.node_id.binary()]
        if not remotes:
            return None
        # broadcast load is up to one sync period stale: every spill in
        # that window would pile onto the same "least loaded" node.
        # Charge each spill decision locally with exponential decay
        # (half-life = one sync period, when fresh broadcasts fold the
        # real load back in) so consecutive spills fan out without
        # double-counting for long (parity: the reference tracks its own
        # backlog per node between resource-view updates).
        now = time.monotonic()
        pressure = self._spill_pressure
        half_life = self.config.resource_broadcast_period_s

        def decayed_count(key) -> float:
            entry = pressure.get(key)
            if entry is None:
                return 0.0
            count, ts = entry
            value = count * 0.5 ** ((now - ts) / half_life)
            if value < 0.05:  # expired: drop so dead nodes don't pile up
                del pressure[key]
                return 0.0
            return value

        def charged_load(node) -> float:
            return node.get("load", 0) + decayed_count(
                bytes(node["node_id"]))

        def charge(node) -> None:
            key = bytes(node["node_id"])
            pressure[key] = (decayed_count(key) + 1.0, now)

        if force_remote:
            # feasible-by-TOTAL, least charged load: instant
            # availability is the wrong bar when the alternative is a
            # lease stranded on a draining node
            best = None
            best_load = None
            for node in remotes:
                total = node.get("resources_total", {})
                if all(total.get(k, 0.0) >= v
                       for k, v in resources.items()):
                    load = charged_load(node)
                    if best is None or load < best_load:
                        best, best_load = node, load
            if best is None:
                return None
            charge(best)
            return tuple(best["address"])

        try:
            # the hybrid/spread decision runs in the native scheduling
            # core (src/sched_core.cc — the reference's
            # ClusterResourceScheduler/hybrid policy is C++ too)
            from ray_tpu_torch.core import native

            idx = native.sched_pick_node(
                [(n.get("resources_available", {}), charged_load(n))
                 for n in remotes],
                resources,
                strategy=strategy,
                local_utilization=self._utilization(),
                spread_threshold=self.config.scheduler_spread_threshold,
                local_feasible=self._feasible_ever(resources, None))
            if idx is None:
                return None
            charge(remotes[idx])
            return tuple(remotes[idx]["address"])
        except OSError:  # toolchain unavailable: python fallback
            pass
        best = None
        best_load = None
        for node in remotes:
            avail = node.get("resources_available", {})
            if all(avail.get(k, 0.0) >= v for k, v in resources.items()):
                load = charged_load(node)
                if best is None or load < best_load:
                    best, best_load = node, load
        if best is None:
            return None
        if strategy == "SPREAD":
            charge(best)
            return tuple(best["address"])
        # hybrid: stay local while below the spread threshold and feasible
        if self._utilization() < self.config.scheduler_spread_threshold and \
                self._feasible_ever(resources, None):
            return None
        charge(best)
        return tuple(best["address"])

    def _maybe_schedule(self) -> None:
        """Grant queued leases in weighted deficit-round-robin order —
        per-job sub-queues with quota ceilings (FairQueue); job-less
        leases key by client connection, so the multi-client interleave
        degenerates to the pre-quota round-robin.  Spills queued leases
        to other nodes as the cluster view evolves."""
        if self._closing or self._sched_suspended:
            return
        # pre-pass: drop settled futures; re-evaluate spillback for
        # leases this node can't fit (e.g. demand for a resource this
        # node will never have) — and, while draining, for EVERY lease
        for lease in self._fair.pending():
            if lease.future.done():
                self._fair.remove(lease)
                continue
            if self._draining or not self._fits(lease.resources,
                                                lease.bundle):
                if lease.bundle is None:
                    spill = self._pick_spillback(
                        lease.resources, lease.request,
                        force_remote=self._draining)
                    if spill is not None:
                        self._fair.remove(lease)
                        lease.future.set_result({"spillback": spill})
        if self._draining:
            # a draining node grants nothing: leases that could not
            # spill stay queued — the drain either re-spills them
            # before DRAINED or aborts back to ACTIVE and re-runs this
            self._note_backlog_demand(self._fair.pending_count())
            return
        want_workers: List[Tuple[Optional[bytes], bool, int]] = []
        wanted: Set[int] = set()  # fits() may probe one lease per round
        errors: Dict[int, Tuple[PendingLease, str]] = {}

        def fits(lease: PendingLease) -> bool:
            """Feasibility probe for one grant attempt: resources AND a
            worker.  On success the popped worker rides the lease to
            the commit loop below (same synchronous pass — nothing can
            interleave)."""
            if id(lease) in errors \
                    or not self._fits(lease.resources, lease.bundle):
                return False
            needs_gpu = lease.resources.get("GPU", 0) > 0
            # isolated envs live in the worker's interpreter itself, so
            # only a worker born under that env can serve the lease —
            # pristine pool workers are no substitute
            worker = self._pop_idle(lease.job_id_bin, needs_gpu,
                                    lease.env_hash,
                                    exact_env_only=lease.env_spawn
                                    is not None)
            if worker is None:
                if not lease.pool_missed:
                    lease.pool_missed = True
                    _tm.sched_warm_pool(False)
                if lease.env_spawn is not None \
                        and lease.env_hash is not None:
                    # isolated env: the worker must be BORN under the
                    # env's interpreter/container — spawn dedicated
                    if needs_gpu:
                        errors[id(lease)] = (lease,
                            "isolated runtime envs (venv/conda/"
                            "container/py_executable) cannot lease "
                            "GPUs; use the in-process pip env for "
                            "GPU tasks")
                    elif self._env_broken.get(lease.env_hash) is not None:
                        errors[id(lease)] = (
                            lease, self._env_broken[lease.env_hash])
                    elif self._starting_env.get(lease.env_hash, 0) == 0:
                        self._start_env_worker(lease)
                    return False
                if id(lease) not in wanted:
                    wanted.add(id(lease))
                    want_workers.append((lease.job_id_bin, needs_gpu,
                                         id(lease.conn)))
                return False
            lease.granted_worker = worker
            return True

        fair_grants = self._fair.grant_order(fits)
        for lease, err in errors.values():
            self._fair.remove(lease)
            if not lease.future.done():
                lease.future.set_result({"error": err})
        grants: List[Tuple[PendingLease, WorkerHandle]] = []
        for job_key, lease in fair_grants:
            worker, lease.granted_worker = lease.granted_worker, None
            self._take(lease.resources, lease.bundle)
            _tm.lease_granted(time.monotonic() - lease.enqueued_at)
            if not lease.pool_missed:
                _tm.sched_warm_pool(True)
            worker.leased = True
            worker.lease_resources = lease.resources
            worker.lease_bundle = lease.bundle
            worker.lease_retriable = lease.retriable
            worker.lease_granted_at = time.monotonic()
            worker.lease_token = lease.token
            worker.lease_job_key = job_key
            worker.owner_conn = lease.conn
            if lease.env_hash is not None:
                worker.env_hash = lease.env_hash
            self._assign_gpu_ids(worker, lease.resources.get("GPU", 0.0))
            if _flight.enabled():
                _flight.record("lease_grant",
                               f"pid={worker.pid} "
                               f"res={lease.resources} "
                               f"job={job_key}")
            grants.append((lease, worker))
        remaining = self._fair.pending()
        # Grants resolve AFTER the pass so each reply can carry an exact
        # contention signal: demand is still queued, so the owner should
        # hand the worker back the moment it idles instead of holding it
        # through the idle-lease grace (the grace exists for lease reuse
        # on sync-style submit patterns; under contention it serialized
        # every worker handoff behind a 250 ms timer — the 1->8-client
        # scaling collapse).
        # "contended" means OTHER clients' demand is queued: a client's
        # own phase-2 fan-out (several lease requests for one burst)
        # must not defeat its own idle-lease grace
        for lease, worker in grants:
            contended = any(other.conn is not lease.conn
                            for other in remaining)
            lease.future.set_result({
                "granted": True,
                "worker_address": worker.task_address,
                "worker_id": worker.worker_id.binary(),
                "contended": contended,
            })
        # Spawn exactly enough workers to cover unmet (schedulable) demand —
        # one per waiting lease, minus those already starting (parity:
        # WorkerPool::PrestartWorkers demand accounting).  GPU demand is
        # sliced against the GPU-capable starting count ONLY: plain spares
        # (refill below) can never serve a needs_gpu lease, so counting
        # them would strand GPU leases for a full boot cycle.
        plain_wait = [x for x in want_workers if not x[1]]
        gpu_wait = [x for x in want_workers if x[1]]
        starting_plain = self._starting - self._starting_gpu
        # Leases are exclusive per client: grow the pool past the
        # per-core cap by one worker per DISTINCT waiting client (total
        # pool hard-bounded at 4x the cap), else N clients on a low-core
        # host serialize behind worker handoffs even at constant total
        # work.  Idle trimming in _reap_loop shrinks the pool back.
        cap_bonus = min(len({x[2] for x in want_workers}),
                        3 * self._max_workers)
        for job_id_bin, _, _conn in plain_wait[starting_plain:]:
            self._start_worker(job_id_bin, False, cap_bonus=cap_bonus)
        for job_id_bin, _, _conn in gpu_wait[self._starting_gpu:]:
            if not self._start_worker(job_id_bin, True,
                                      cap_bonus=cap_bonus):
                # pool cap reached while idle PLAIN spares occupy it —
                # those can never serve a needs_gpu lease (eligible()
                # rejects them), so evict one to make room or the lease
                # deadlocks behind its own refill spares
                if self._cull_idle_spare(lambda w: not w.gpu_capable):
                    self._start_worker(job_id_bin, True,
                                       cap_bonus=cap_bonus)
        # anticipatory refill: actors claim pool workers permanently, so
        # creation storms drain the idle pool — respawn spares in the
        # background up to the prestart watermark (bounded by the pool
        # cap inside _start_worker) so the NEXT claims hit warm workers
        # (~4x creation rate vs cold boot on the lease critical path).
        # Skipped while any lease is still waiting (demand-driven spawns
        # own the remaining pool capacity) and while creation tasks are
        # executing — mid-wave forks steal the CPU the wave needs; the
        # reap loop's demand-driven rebuild restocks right after.
        if not remaining and not self._creating_actors:
            refill = getattr(self, "_prestart_watermark", 0) \
                - len(self._idle) - self._starting
            for _ in range(refill):
                self._start_worker(None)
        elif not self._idle:
            # Demand is queued and nothing is idle — either the pool is
            # at its cap or the leases failed _fits because
            # RESOURCES are held by leased workers (including ones
            # merely lingering in their idle grace, which generate no
            # event on their own).  Both cases: ask the owners to hand
            # back idle leases (covers grants made BEFORE the contention
            # arose, which the per-grant contended flag can't reach).
            # Rate-limited: one nudge per grace-ish window.
            now = time.monotonic()
            if now - self._last_reclaim_push >= 0.02:
                self._last_reclaim_push = now
                nudged = set()
                for w in self.workers.values():
                    conn = w.owner_conn
                    if (w.leased and not w.is_actor and conn is not None
                            and not conn.closed and id(conn) not in nudged):
                        nudged.add(id(conn))
                        conn.push("reclaim_idle", {})
            # a holder whose worker is merely BUSY right now generates
            # no event when it later idles into its grace — re-nudge on
            # a short timer until the queued demand is served (without
            # this, a waiting client stalled for the full 250 ms grace
            # of whoever got the workers first).  Exponential backoff to
            # 0.5 s: when every worker runs minutes-long tasks there is
            # nothing to reclaim and a 30 ms rescan would just burn CPU
            # for the whole saturation window.
            if not self._reclaim_timer_armed:
                delay = self._reclaim_retry_delay

                def _retry():
                    self._reclaim_timer_armed = False
                    self._reclaim_retry_delay = min(
                        0.5, self._reclaim_retry_delay * 1.6)
                    if not self._closing and self._fair.pending_count():
                        self._maybe_schedule()
                try:
                    asyncio.get_running_loop().call_later(delay, _retry)
                    self._reclaim_timer_armed = True
                except RuntimeError:
                    pass  # no loop (sync caller); the reap loop re-kicks
        if grants or not remaining:
            # demand moved: future contention starts its backoff fresh
            self._reclaim_retry_delay = 0.03
        self._note_backlog_demand(len(remaining))

    def _note_actor_claim(self) -> None:
        self._actor_claims = self._decayed_actor_claims() + 1.0
        self._actor_claims_ts = time.monotonic()

    def _decayed_actor_claims(self) -> float:
        # half-life 60 s: long enough to keep the pool stocked through a
        # benchmark-style burst sequence, short enough that a one-off
        # storm doesn't pin memory for minutes
        dt = time.monotonic() - self._actor_claims_ts
        return self._actor_claims * 0.5 ** (dt / 60.0)

    def _note_backlog_demand(self, n: int) -> None:
        """Track the decaying PEAK of the pending-lease backlog: the
        demand signal that feeds the warm-pool target (a wave that
        queued behind spawns sizes the pool for the next one)."""
        if n > self._decayed_backlog_demand():
            self._backlog_demand = float(n)
            self._backlog_demand_ts = time.monotonic()

    def _decayed_backlog_demand(self) -> float:
        dt = time.monotonic() - self._backlog_demand_ts
        return self._backlog_demand * 0.5 ** (dt / 60.0)

    def _pool_target(self) -> int:
        """Idle-pool size to maintain: boot watermark plus DEMAND — the
        larger of the recent actor-claim volume (claimed workers leave
        the pool for good) and the recent pending-lease backlog peak
        (leases that had to wait for spawns), decayed with a 60 s
        half-life.  ``max`` not sum: an actor wave appears in both
        signals, and doubling the pool doubles idle-process overhead
        for nothing.  The NEXT wave of the same size then lands on
        warm zygote forks with the fork cost off the critical path."""
        watermark = getattr(self, "_prestart_watermark", 0)
        demand = max(self._decayed_actor_claims(),
                     self._decayed_backlog_demand())
        return watermark + min(int(demand), 3 * self._max_workers)

    def _cull_idle_spare(self, predicate) -> bool:
        """Evict one idle worker matching ``predicate`` to free pool
        capacity; returns True if a worker was released."""
        for i, w in enumerate(self._idle):
            if predicate(w):
                self._idle.pop(i)
                self.workers.pop(w.worker_id, None)
                try:
                    w.conn.push("exit", {})
                except Exception:  # already gone
                    pass
                return True
        return False

    def _dec_starting_env(self, token: Any) -> None:
        if token is None:
            return
        env_hash = self._env_spawn_hash.pop(token, None)
        if env_hash is not None and self._starting_env.get(env_hash):
            self._starting_env[env_hash] -= 1

    def _dec_starting(self, was_gpu_spawn: bool) -> None:
        self._starting -= 1
        if was_gpu_spawn and self._starting_gpu > 0:
            self._starting_gpu -= 1

    def _pop_idle(self, job_id_bin: Optional[bytes],
                  needs_gpu: bool = False,
                  env_hash: Optional[str] = None,
                  exact_env_only: bool = False
                  ) -> Optional[WorkerHandle]:
        # job-dedicated workers: a worker that has loaded job code serves
        # only that job (parity: WorkerPool per-job isolation); likewise a
        # worker that applied a runtime env serves only that env, and
        # env-tasks never land on differently-polluted workers.  Two
        # passes: exact env match first, then pristine workers.
        def eligible(w, want_env):
            if needs_gpu and not w.gpu_capable:
                return False
            if w.env_hash != want_env:
                return False
            return w.job_id_bin is None or job_id_bin is None or \
                w.job_id_bin == job_id_bin

        if env_hash is not None:
            for i, w in enumerate(self._idle):
                if eligible(w, env_hash):
                    return self._idle.pop(i)
        if exact_env_only:
            # isolated env: a pristine worker can't be converted post-hoc
            return None
        for i, w in enumerate(self._idle):
            if eligible(w, None):
                return self._idle.pop(i)
        return None

    async def handle_return_worker(self, conn, data):
        # failpoint: the lease return is lost/failed — the owner RETRIES
        # it (it's classified idempotent), so duplicates must be inert
        await _fp.afailpoint("raylet.lease_return.fail")
        worker = self.workers.get(WorkerID(data["worker_id"]))
        if worker is None:
            return False
        if not worker.leased:
            # duplicate of an already-settled return (the first attempt
            # executed but its reply was lost): appending to the idle
            # pool again would grant one worker to two leases
            return False
        token = data.get("token")
        if token is not None and worker.lease_token is not None \
                and token != worker.lease_token:
            # stale duplicate from a PREVIOUS lease of this worker —
            # releasing it would free the current owner's live lease
            return False
        if data.get("job_id") is not None and worker.job_id_bin is None:
            worker.job_id_bin = data["job_id"]
        self._release_lease_resources(worker)
        if not data.get("disconnect", False):
            worker.idle_since = time.monotonic()
            self._idle.append(worker)
        self._maybe_schedule()
        return True

    def _assign_gpu_ids(self, worker: WorkerHandle, gpus: float) -> None:
        """Pick the least-loaded GPUs for this lease and tell the worker
        (parity: the reference raylet's GPU-id resource assignment that
        ray.get_gpu_ids reads).  Fractional demands share a GPU."""
        if gpus <= 0 or not self._gpu_load:
            return
        k = max(1, int(gpus))
        ids = sorted(self._gpu_load, key=self._gpu_load.get)[:k]
        share = gpus / k
        for i in ids:
            self._gpu_load[i] += share
        worker.lease_gpu_ids = ids
        worker.lease_gpu_share = share
        try:
            worker.conn.push("lease_gpu_ids", {"ids": ids})
        except Exception:
            pass

    def _release_lease_resources(self, worker: WorkerHandle) -> None:
        if worker.leased:
            self._give(worker.lease_resources, worker.lease_bundle)
            # settle the fair queue's in-flight quota charge.  The
            # failpoint models a dropped accounting update (chaos): the
            # ledger drifts until the health beat's reconcile re-anchors
            # it on the live lease table — a drop throttles a job for at
            # most one beat, never forever.
            if worker.lease_job_key is not None and \
                    not _fp.failpoint("raylet.quota.account_drop"):
                self._fair.release(worker.lease_job_key,
                                   worker.lease_resources)
            worker.lease_job_key = None
            worker.leased = False
            worker.lease_token = None
            worker.owner_conn = None
            worker.lease_resources = {}
            worker.lease_bundle = None
            if worker.lease_gpu_ids:
                for i in worker.lease_gpu_ids:
                    if i in self._gpu_load:
                        self._gpu_load[i] = max(
                            0.0, self._gpu_load[i] - worker.lease_gpu_share)
                worker.lease_gpu_ids = []
                worker.lease_gpu_share = 0.0
                try:
                    worker.conn.push("lease_gpu_ids", {"ids": []})
                except Exception:
                    pass

    async def handle_lease_worker_for_actor(self, conn, data):
        """GCS asks this node to host an actor: lease a worker, push the
        creation task to it, reply with its task-server address."""
        return await self._lease_and_create_actor(conn, data)

    async def handle_lease_workers_for_actors(self, conn, data):
        """Batched actor bring-up (GCS pipelined fan-out): EVERY lease
        in the batch enqueues before the first grant resolves — one
        scheduling pass sees the whole wave, so worker spawns cover the
        full deficit at once instead of trickling in per actor — then
        the creation tasks push to their granted workers concurrently.
        Per-actor results; one actor's failure (no grant, constructor
        raised, worker died) never blocks its batch-mates."""
        entries = data["actors"]

        async def one(entry):
            try:
                res = await self._lease_and_create_actor(conn, entry)
            except Exception as e:  # noqa: BLE001 — isolate per actor
                res = {"granted": False,
                       "reason": f"{type(e).__name__}: {e}"}
            res["actor_id"] = entry["actor_id"]
            return res

        # Enqueue-all-then-schedule-once: every per-actor coroutine runs
        # to its grant await (appending its PendingLease) while the
        # scheduler is suspended, then ONE pass grants the whole wave —
        # per-enqueue passes re-scanned a growing queue (O(n^2) lease
        # evaluations, each an O(idle-pool) eligibility scan).
        self._sched_suspended = True
        try:
            tasks = [asyncio.ensure_future(one(e)) for e in entries]
            # one loop yield runs every task to its first real await
            # (the lease future) — all enqueues land before the pass
            await asyncio.sleep(0)
        finally:
            self._sched_suspended = False
        self._maybe_schedule()
        results = await asyncio.gather(*tasks)
        return {"results": list(results)}

    async def _lease_and_create_actor(self, conn, data):
        resources = dict(data.get("resources", {}))
        # the lease path resolves (and refuses missing) bundles itself, so
        # an unbound fallback to the node pool is impossible by design
        reply = await self.handle_request_worker_lease(conn, {
            "resources": resources,
            "job_id": data.get("job_id"),
            "placement_group_id": data.get("placement_group_id"),
            "bundle_index": data.get("bundle_index", -1),
            "strategy": "DEFAULT",
            "env_hash": data.get("env_hash"),
            "env_spawn": data.get("env_spawn"),
        })
        if not reply.get("granted"):
            return {"granted": False, "reason": str(reply)}
        worker = self.workers.get(WorkerID(reply["worker_id"]))
        if worker is None:
            return {"granted": False, "reason": "worker vanished"}
        worker.is_actor = True
        self._note_actor_claim()
        payload = {"spec_blob": data["spec_blob"]}
        # Attach node-cached function + syspath blobs: 25 actors of one
        # class on one node then cost ONE GCS fetch instead of 25 (the
        # per-worker fetches were the dominant GCS load in creation
        # storms — parity motivation: gcs_actor_scheduler.cc batches the
        # equivalent metadata on the lease path).
        try:
            extra = await self._actor_creation_blobs(data["spec_blob"])
            payload.update(extra)
        except Exception:  # cache is best-effort; workers can self-fetch
            logger.debug("actor blob prefetch failed", exc_info=True)
        self._creating_actors += 1
        try:
            result = await worker.conn.call(
                "create_actor", payload, timeout=120.0)
        except (rpc.ConnectionLost, rpc.RpcError) as e:
            self._on_worker_dead(worker, f"actor creation failed: {e}")
            return {"granted": False, "reason": str(e)}
        finally:
            self._creating_actors -= 1
        if not result.get("ok"):
            # creation raised in user code: actor is dead on arrival
            self._release_lease_resources(worker)
            worker.idle_since = time.monotonic()
            self._idle.append(worker)
            worker.is_actor = False
            return {"granted": False, "reason": result.get("error", "unknown"),
                    "creation_error": True}
        return {"granted": True, "worker_task_address": worker.task_address,
                "worker_id": worker.worker_id.binary()}

    async def _actor_creation_blobs(self, spec_blob: bytes) -> Dict[str, Any]:
        """Node-level cache of (function blob, job syspath blob) for actor
        creation, keyed off the pickled spec's ids.  LRU-bounded, and a
        miss (None reply) is NOT cached — a transient GCS anomaly must not
        permanently disable the prefetch for that key."""
        import pickle as pickle_mod
        spec = pickle_mod.loads(spec_blob)
        cache = getattr(self, "_creation_blob_cache", None)
        if cache is None:
            from collections import OrderedDict
            cache = self._creation_blob_cache = OrderedDict()

        async def lookup(key, fetch):
            blob = cache.get(key)
            if blob is not None:
                cache.move_to_end(key)
                return blob
            blob = await fetch()
            if blob is not None:
                cache[key] = blob
                while len(cache) > 128:
                    cache.popitem(last=False)
            return blob

        out: Dict[str, Any] = {}
        fn_blob = await lookup(
            ("fn", spec.function_id),
            lambda: self.gcs_conn.call(
                "get_function", {"function_id": spec.function_id}))
        if fn_blob is not None:
            out["function_blob"] = fn_blob
        if spec.job_id is not None:
            sp_blob = await lookup(
                ("syspath", spec.job_id.binary()),
                lambda: self.gcs_conn.call("kv_get", {
                    "key": f"syspath:{spec.job_id.hex()}",
                    "namespace": "_internal"}))
            if sp_blob is not None:
                out["syspath_blob"] = sp_blob
                out["syspath_job"] = spec.job_id.binary()
        return out

    # ------------------------------------------------------------------
    # telemetry flush (the per-raylet producer half of the metrics
    # pipeline; parity: the per-node MetricsAgent push loop,
    # metrics_agent.py:374)
    # ------------------------------------------------------------------
    def _sample_gauges(self) -> None:
        """Point-in-time gauges refreshed right before each flush; all
        tagged with this node so per-node series don't overwrite each
        other in the GCS aggregation."""
        tags = {"node": self.node_id.hex()[:12]}
        _tm.set_gauge("ray_tpu_sched_pending_leases",
                      "worker-lease requests queued on the raylet",
                      self._fair.pending_count(), tags)
        for job, n in self._fair.throttled_total.items():
            _tm.set_gauge("ray_tpu_sched_quota_throttled_total",
                          "lease grants skipped or rejected by the "
                          "job's quota ceiling (cumulative)",
                          n, {**tags, "job": job})
        _tm.set_gauge("ray_tpu_transfer_inflight_pulls",
                      "object transfers currently being received",
                      len(self._inflight_pulls), tags)
        _tm.set_gauge("ray_tpu_workers_total",
                      "worker processes registered on the node",
                      len(self.workers), tags)
        _tm.set_gauge("ray_tpu_workers_idle",
                      "idle pool workers on the node",
                      len(self._idle), tags)
        try:
            stats = self.store.stats_ex()
        except Exception:  # noqa: BLE001 — stats must not kill the loop
            stats = self.store.stats()
        _tm.set_gauge("ray_tpu_arena_used_bytes",
                      "object-store arena bytes allocated",
                      stats.get("used", 0), tags)
        _tm.set_gauge("ray_tpu_arena_num_objects",
                      "objects resident in the arena",
                      stats.get("num_objects", 0), tags)
        cap = stats.get("capacity", 0)
        _tm.set_gauge("ray_tpu_arena_capacity_bytes",
                      "object-store arena capacity", cap, tags)
        if cap:
            # the arena-pressure signal the history plane's recording
            # rule (cluster:arena_occupancy) and the ArenaPressure
            # alert subscribe to
            _tm.set_gauge("ray_tpu_arena_occupancy_fraction",
                          "arena bytes used / capacity",
                          stats.get("used", 0) / cap, tags)
        self._sample_job_arena_bytes(tags)
        if "reuse_hits" in stats:
            hits = stats["reuse_hits"]
            misses = stats.get("reuse_misses", 0)
            rate = hits / (hits + misses) if hits + misses else 0.0
            _tm.set_gauge("ray_tpu_arena_reuse_hit_rate",
                          "fraction of allocations served from the "
                          "client's warm slab bucket", rate, tags)
            _tm.set_gauge("ray_tpu_arena_doomed_objects",
                          "deleted-while-pinned objects awaiting their "
                          "last release", stats.get("doomed_current", 0),
                          tags)
            _tm.set_gauge("ray_tpu_arena_active_buckets",
                          "slab buckets with live allocations",
                          stats.get("active_buckets", 0), tags)
            _tm.set_gauge("ray_tpu_arena_bucket_free_bytes",
                          "free bytes parked in per-client slab buckets",
                          stats.get("bucket_free_bytes", 0), tags)
        if "shard_contention" in stats:
            _tm.set_gauge("ray_tpu_store_shard_contention_total",
                          "cumulative contended metadata-shard lock "
                          "acquisitions (striping health: near-zero "
                          "means writers aren't colliding)",
                          stats.get("shard_contention", 0), tags)
        _tm.set_gauge("ray_tpu_store_spill_objects",
                      "objects resident in the spill tier",
                      len(self._spilled), tags)

    #: primaries sampled per flush for the per-job arena rollup (the
    #: gauge is approximate on nodes holding more; the cap bounds the
    #: lease/release work a flush tick can do)
    _JOB_ARENA_SAMPLE_CAP = 4096

    def _sample_job_arena_bytes(self, tags) -> None:
        """Per-job arena occupancy: sum primary-copy sizes by the job
        embedded in each ObjectID.  Jobs reported last tick but gone
        now are zeroed so their gauges age out instead of flushing a
        stale value forever."""
        per_job: Dict[str, int] = {}
        primaries = list(self._primary)
        truncated = len(primaries) > self._JOB_ARENA_SAMPLE_CAP
        for oid in primaries[:self._JOB_ARENA_SAMPLE_CAP]:
            lease = self.store.lease(oid)
            if lease is None:
                continue
            _, size = lease
            self.store.release(oid)
            job = oid.job_id().hex()
            per_job[job] = per_job.get(job, 0) + size
        if truncated:
            # a truncated sweep can MISS a job that still holds bytes:
            # zeroing it would flap the gauge between truth and 0 as
            # set order churns — keep last values (approximate but
            # monotone-consistent) until the node drains below the cap
            self._job_arena_reported |= {j for j, n in per_job.items()
                                         if n}
        else:
            for job in self._job_arena_reported - set(per_job):
                per_job[job] = 0  # drained: age the gauge out via 0
            self._job_arena_reported = {j for j, n in per_job.items()
                                        if n}
        for job, nbytes in per_job.items():
            _tm.set_gauge("ray_tpu_job_arena_bytes",
                          "arena bytes held by primary copies, by "
                          "owning job", nbytes, dict(tags, job=job))

    async def _metrics_flush_loop(self) -> None:
        """Batch registry deltas + spans to the GCS metrics/span tables
        every ``metrics_report_period_s``.  Drop-don't-block: an
        unreachable GCS costs this window's deltas, never the loop."""
        from ray_tpu_torch.util import metrics as metrics_mod

        period = max(0.25, getattr(self.config,
                                   "metrics_report_period_s", 5.0))
        synced_conn = None  # re-probe on failure AND after a reconnect
        source = f"raylet-{self.node_id.hex()[:12]}"
        while not self._closing:
            # active profiling flushes at >= 1 Hz (short windows must
            # not wait out the 5 s metrics period)
            await asyncio.sleep(min(period, 1.0) if _prof.pending()
                                else period)
            # profile records flush even with metrics disabled: the
            # profiler is armed explicitly, and skipping drain here
            # would also leave pending() true -> 1 Hz ticks forever
            # (trace spans likewise flush independently of metrics)
            if not _tm.enabled() and not _prof.pending() \
                    and not _trace.pending():
                continue
            conn = self.gcs_conn
            if conn is None or conn.closed:
                continue
            if conn is not synced_conn:
                # a restarted GCS may run on a different host clock
                if await _tm.measure_clock_offset(conn) is not None:
                    synced_conn = conn
            try:
                records: list = []
                spans: list = []
                if _tm.enabled():
                    self._sample_gauges()
                    fstats = _flight.stats()
                    if fstats is not None:
                        _tm.flight_frames(fstats["frames_recorded"])
                    _tm.presample()
                    records = metrics_mod.flush_all()
                    spans = _tm.drain_spans(source)
                profile = _prof.drain()
                if records:
                    self._metrics_report_seq += 1
                    await conn.call("report_metrics",
                                    {"records": records, "source": source,
                                     "seq": self._metrics_report_seq},
                                    timeout=2.0)
                if spans:
                    await conn.call("report_spans", {"spans": spans},
                                    timeout=2.0)
                tspans = _trace.drain(source)
                if tspans:
                    await conn.call("report_trace_spans",
                                    {"spans": tspans}, timeout=2.0)
                if profile:
                    node = self.node_id.hex()
                    for rec in profile:
                        rec["node"] = node
                        rec["source"] = source
                    await conn.call("report_profile",
                                    {"records": profile}, timeout=2.0)
            except (rpc.ConnectionLost, rpc.RpcError,
                    asyncio.TimeoutError, OSError):
                pass  # dropped: counters re-accumulate, gauges refresh
            except Exception:
                logger.exception("metrics flush iteration failed")

    # ------------------------------------------------------------------
    # state API (per-node sources; parity: raylet handlers behind
    # StateDataSourceClient state_manager.py:130)
    # ------------------------------------------------------------------
    async def handle_debug_state(self, conn, data):
        """Event-loop lag + per-handler timings (event_stats parity),
        plus the raylet's live control/data-plane depths for the status
        surface."""
        mon = getattr(self, "_loop_monitor", None)
        out = mon.snapshot() if mon is not None else {}
        out["pending_leases"] = self._fair.pending_count()
        out["draining"] = self._draining
        out["fair_queue"] = self._fair.snapshot()
        out["inflight_pulls"] = len(self._inflight_pulls)
        out["workers"] = len(self.workers)
        out["idle_workers"] = len(self._idle)
        out["starting_workers"] = self._starting
        out["warm_pool_target"] = self._pool_target()
        out["creating_actors"] = self._creating_actors
        out["spilled_objects"] = len(self._spilled)
        out["spill_bytes"] = self._spill_bytes
        try:
            out["store"] = self.store.stats_ex()
            out["store"]["bucket_occupancy"] = \
                self.store.bucket_occupancy()
        except Exception:  # noqa: BLE001
            out["store"] = self.store.stats()
        return out

    async def handle_stack_traces(self, conn, data):
        """All-thread stack dumps from every worker on this node PLUS
        the raylet process itself (parity: the dashboard reporter's
        py-spy fan-out; the raylet's own loop is where transfer/lease
        wedges live, so `ray-tpu stack` must see it too)."""
        async def one(worker):
            try:
                return await asyncio.wait_for(
                    worker.conn.call("stack_trace", {}), 10.0)
            except Exception as e:  # noqa: BLE001 — wedged workers are
                return {"pid": worker.pid,  # exactly what you're hunting
                        "error": f"{type(e).__name__}: {e}"}

        import threading
        import traceback
        names = {t.ident: t.name for t in threading.enumerate()}
        own = [{"thread": names.get(ident, str(ident)),
                "stack": "".join(traceback.format_stack(frame))}
               for ident, frame in sys._current_frames().items()]
        dumps = await asyncio.gather(
            *(one(w) for w in list(self.workers.values())))
        return {"node_id": self.node_id.hex(), "workers": dumps,
                "raylet": {"pid": os.getpid(), "threads": own}}

    async def handle_list_workers(self, conn, data):
        return [{"worker_id": w.worker_id.hex(), "pid": w.pid,
                 "leased": w.leased, "is_actor": w.is_actor,
                 "lease_resources": w.lease_resources}
                for w in self.workers.values()]

    async def handle_list_objects(self, conn, data):
        limit = int(data.get("limit", 1000))
        out = []
        for oid in list(self._primary)[:limit]:
            lease = self.store.lease(oid)
            if lease is None:
                continue
            _, size = lease
            self.store.release(oid)
            out.append({"object_id": oid.hex(), "size": size,
                        "node_id": self.node_id.hex()})
        stats = await self.handle_store_stats(conn, {})
        return {"objects": out, "store_stats": stats,
                "num_spilled": stats["num_spilled"]}

    # ------------------------------------------------------------------
    # placement-group bundles (PlacementGroupResourceManager)
    # ------------------------------------------------------------------
    async def handle_prepare_bundle(self, conn, data):
        # bundle waves are control-plane bursts too: pause the
        # background pool rebuild while one is in flight
        self._last_lease_ts = time.monotonic()
        resources = dict(data["resources"])
        key = (data["pg_id"], data["bundle_index"])
        if key in self._bundle_totals:
            return True  # idempotent: GCS retry of an already-held bundle
        if not all(self.resources_available.get(k, 0.0) >= v
                   for k, v in resources.items()):
            return False
        for k, v in resources.items():
            self.resources_available[k] = self.resources_available.get(k, 0.0) - v
        self._bundles[key] = dict(resources)  # held but uncommitted
        self._bundle_totals[key] = dict(resources)
        return True

    async def handle_commit_bundle(self, conn, data):
        key = (data["pg_id"], data["bundle_index"])
        return key in self._bundles

    async def handle_return_bundle(self, conn, data):
        key = (data["pg_id"], data["bundle_index"])
        self._bundle_totals.pop(key, None)
        remaining = self._bundles.pop(key, None)
        if remaining is not None:
            # refund only the unleased remainder; shares held by live
            # leases come back through _give when each worker releases
            for k, v in remaining.items():
                self.resources_available[k] = \
                    self.resources_available.get(k, 0.0) + v
        # gang semantics: leases from a returned bundle are revoked — kill
        # their workers so the rescheduled gang can't double-book the GPUs
        for worker in list(self.workers.values()):
            if worker.leased and worker.lease_bundle == key:
                if worker.proc is not None:
                    worker.proc.terminate()
                self._on_worker_dead(worker, "placement group bundle returned")
        # queued leases against the bundle can never be granted now — fail
        # them instead of leaving their futures pending forever
        for lease in self._fair.pending():
            if lease.bundle == key:
                self._fair.remove(lease)
                if not lease.future.done():
                    lease.future.set_result(
                        {"error": "placement group bundle removed"})
        self._maybe_schedule()
        return True

    # ------------------------------------------------------------------
    # object plane: local store service
    # ------------------------------------------------------------------
    async def handle_object_create(self, conn, data):
        """Allocate store space, spilling/evicting to make room.

        Retry loop parity: plasma's CreateRequestQueue — under a burst
        of concurrent creates the primaries that COULD be spilled may
        not be sealed yet (create happens before seal), so a single
        spill-then-alloc pass fails spuriously; retrying lets in-flight
        writers seal and become spillable."""
        object_id = ObjectID(data["object_id"])
        size = data["size"]
        if size > self.store_capacity:
            raise ObjectStoreFullError(
                f"object of {size} bytes exceeds the store capacity "
                f"({self.store_capacity}) — no amount of spilling fits it")
        # per-client allocation affinity: creates from one connection
        # (i.e. one producing process) reuse blocks that process freed,
        # so its writes land on page-table-warm offsets.  Fault-expensive
        # hosts write cold pages ~10x slower — with a single shared free
        # list, four concurrent putters permanently shuffled each other
        # onto cold blocks (the multi-client put collapse).
        hint = conn.context.get("alloc_hint")
        if hint is None:
            hint = conn.context["alloc_hint"] = \
                (id(conn) >> 4) % 63 + 1  # 0 is the raylet's own bucket
        deadline = time.monotonic() + 30.0
        while True:
            await self._maybe_spill(size)
            try:
                offset, _ = self.store.alloc(object_id, size, hint)
                return {"offset": offset, "size": size}
            except ValueError:
                raise  # already exists — caller bug, don't retry
            except ObjectStoreFullError:
                if time.monotonic() > deadline:
                    raise
                # fragmentation relief, gated on its signature: the
                # alloc failed although accounting says the object FITS
                # below the pressure threshold — long-lived primaries
                # can checkerboard the striped arena (one block pinning
                # each stripe's region start) until no free run fits
                # ``size`` even with half the arena free.  Spilling is
                # the only block *mover*, so force a small sweep — the
                # spilled primary's region opens and the retry lands.
                # Above the threshold this is genuine pressure: the
                # _maybe_spill at the top of the loop already sweeps,
                # and in-flight writers sealing is the usual cure.
                frac = getattr(self.config, "object_spill_threshold",
                               -1.0)
                if frac is None or frac < 0:
                    frac = self.config.object_spilling_threshold
                if self.store.used() + size <= frac * self.store_capacity:
                    await self._spill_for_fragmentation(size)
                await asyncio.sleep(0.05)

    async def handle_object_seal(self, conn, data):
        object_id = ObjectID(data["object_id"])
        self.store.seal(object_id)
        self._mark_primary(object_id, tuple(data["owner_address"])
                           if data.get("owner_address") else None)
        return True

    def _mark_primary(self, object_id: ObjectID, owner: Optional[tuple]) -> None:
        if object_id not in self._primary:
            if self.store.lease(object_id) is not None:  # pin primary copy
                self._primary.add(object_id)
        if owner is not None:
            self._owner_of[object_id] = owner

    async def handle_object_get(self, conn, data):
        """Resolve objects to {offset,size} leases, pulling remote /
        spilled copies as needed.  The client must release_objects."""
        ids = [ObjectID(b) for b in data["object_ids"]]
        owners = data.get("owners", {})
        timeout = data.get("timeout")
        deadline = None if timeout is None else time.monotonic() + timeout
        out = {}
        for oid in ids:
            lease = self.store.lease(oid)
            if lease is None:
                ok = await self._make_local(oid, owners.get(oid.binary()),
                                            deadline)
                lease = self.store.lease(oid) if ok else None
            if lease is None:
                out[oid.binary()] = None
            else:
                out[oid.binary()] = {"offset": lease[0], "size": lease[1]}
        return out

    async def _make_local(self, oid: ObjectID, owner: Optional[tuple],
                          deadline: Optional[float]) -> bool:
        """Restore from spill or pull from remote holders (serialized
        per object; concurrent readers share one transfer)."""
        entry = self._pull_locks.get(oid)
        if entry is None:
            entry = self._pull_locks[oid] = [asyncio.Lock(), 0]
        entry[1] += 1
        try:
            async with entry[0]:
                return await self._make_local_locked(oid, owner, deadline)
        finally:
            entry[1] -= 1
            if entry[1] == 0 and self._pull_locks.get(oid) is entry:
                del self._pull_locks[oid]

    async def _make_local_locked(self, oid: ObjectID,
                                 owner: Optional[tuple],
                                 deadline: Optional[float]) -> bool:
        if self.store.contains(oid):
            return True
        if oid in self._spilled:
            if await self._restore_from_spill(oid):
                return True
            # unreadable/failed local restore: fall through to the
            # owner's directory — other copies or a URI blob may exist
        if owner is None:
            owner = self._owner_of.get(oid)
        if owner is None:
            return False
        # ownership-based directory: ask the owner where copies live
        failures = 0
        while True:
            try:
                owner_conn = await self.pool.get((owner[1], owner[2]))
                locs = await owner_conn.call(
                    "get_object_locations",
                    {"object_id": oid.binary()}, timeout=10.0)
            except (rpc.ConnectionLost, rpc.RpcError, asyncio.TimeoutError,
                    OSError):
                return False
            if locs is None:
                return False  # owner no longer knows the object
            my_addr = self.server.address
            sealed = [tuple(a) for a in locs.get("nodes", [])
                      if tuple(a) != my_addr]
            partials = [tuple(a) for a in (locs.get("partial_nodes") or [])
                        if tuple(a) != my_addr]
            if (sealed or partials) and await self._pull_object(
                    oid, sealed, partials, owner_conn):
                return True
            if locs.get("spilled_uri"):
                # external tier: restore directly, no matter which
                # node spilled it (it may be dead — that's the point)
                if await self._restore_from_uri(oid, locs["spilled_uri"]):
                    return True
            if locs.get("spilled_on"):
                node_addr = tuple(locs["spilled_on"])
                if node_addr == my_addr:
                    return await self._restore_from_spill(oid)
                if await self._pull_object(oid, [node_addr], [],
                                           owner_conn):
                    return True
            if locs.get("pending"):
                # object not produced yet; wait and retry
                if deadline is not None and time.monotonic() > deadline:
                    return False
                await asyncio.sleep(0.05)
                continue
            failures += 1
            if not (sealed or partials) or failures >= 3:
                return False
            # every source failed mid-transfer: re-query the owner —
            # fresh holders may have sealed since (chained broadcast)
            if deadline is not None and time.monotonic() > deadline:
                return False
            await asyncio.sleep(0.1)

    async def _pull_object(self, oid: ObjectID,
                           sealed_nodes: List[rpc.Address],
                           partial_nodes: List[rpc.Address],
                           owner_conn: Optional[rpc.Connection]) -> bool:
        """Windowed, multi-source pull (parity: ObjectManager Push/Pull,
        pull_manager.h).

        Up to ``object_transfer_window`` chunk requests are kept in
        flight per source, and sources serve disjoint chunks off one
        shared queue, so holders stripe the object between them and a
        faster source automatically carries more.  A source that dies
        mid-transfer re-queues its outstanding chunks for the survivors
        — the transfer restarts only when EVERY source is gone.  While
        the transfer runs it is registered as a *partial* location with
        the owner; once sealed it is registered as a full location, so
        later pullers fan out across the copies instead of all draining
        the producer.
        """
        config = self.config
        window = max(1, getattr(config, "object_transfer_window", 8))
        max_sources = max(1, getattr(config, "object_transfer_max_sources",
                                     4))
        chunk = config.object_transfer_chunk_size
        chunk_timeout = getattr(config, "object_transfer_chunk_timeout_s",
                                30.0)
        partial_cfg = getattr(config, "object_transfer_partial_locations",
                              True)

        t_start = time.monotonic()
        t_wall = time.time()  # span timestamps are wall-clock
        # sample rather than slice when many holders exist: a prefix of
        # dead nodes (the owner never unlearns crashed holders) would
        # otherwise shadow live copies further down the list on every
        # attempt.  Seeded stream for reproducible test runs.
        sealed_pick = list(sealed_nodes)
        if len(sealed_pick) > max_sources + 2:
            sealed_pick = _probe_rng.sample(sealed_pick, max_sources + 2)
        candidates = sealed_pick
        candidates += [addr for addr in partial_nodes[:2]
                       if addr not in candidates]

        async def probe(addr: rpc.Address):
            try:
                conn = await self.pool.get(addr)
                meta = await conn.call(
                    "object_pull_start", {"object_id": oid.binary()},
                    timeout=10.0)
            except (rpc.ConnectionLost, rpc.RpcError, asyncio.TimeoutError,
                    OSError):
                return None
            if meta is None:
                return None
            return {"addr": addr, "conn": conn, "size": meta["size"],
                    "partial": bool(meta.get("partial")), "dead": False,
                    "meta": meta}

        if not candidates:
            return False
        # two-phase probe wait: a single black-holed candidate (e.g. a
        # stale partial location from a crashed puller) must not stall
        # transfer start for its full timeout when a healthy source
        # answered in milliseconds.  Stragglers keep running in the
        # background and release their pins when they land.
        probe_tasks = [asyncio.ensure_future(probe(a)) for a in candidates]
        done, pending_probes = await asyncio.wait(probe_tasks, timeout=2.0)
        if not any(t.result() is not None for t in done):
            if pending_probes:
                more, pending_probes = await asyncio.wait(pending_probes,
                                                          timeout=10.0)
                done |= more
        for t in pending_probes:
            t.add_done_callback(self._release_late_probe(oid))
        probed = [t.result() for t in done if t.result() is not None]
        if not probed:
            return False
        # prefer sealed copies over partial chains (bounded waits beat
        # no waits only when there's nothing better), then cap the
        # stripe width
        probed.sort(key=lambda s: s["partial"])
        sources = [s for s in probed if s["size"] == probed[0]["size"]]
        sources, spares = sources[:max_sources], sources[max_sources:]
        await self._release_sources(oid, spares)
        if not sources:
            return False
        size = sources[0]["size"]

        registered_partial = False
        if partial_cfg and owner_conn is not None and size > chunk:
            # announce the in-progress copy so concurrent pullers can
            # chain on this node instead of re-draining the holders
            try:
                await owner_conn.call("object_location_added", {
                    "object_id": oid.binary(),
                    "node": list(self.server.address),
                    "partial": True}, timeout=5.0)
                registered_partial = True
            except (rpc.ConnectionLost, rpc.RpcError,
                    asyncio.TimeoutError):
                pass

        try:
            await self._maybe_spill(size)
            offset, view = self.store.alloc(oid, size)
        except ValueError:
            # concurrently produced on this node (e.g. a local worker
            # sealed it while we probed)
            await self._release_sources(oid, sources)
            return self.store.contains(oid)
        except ObjectStoreFullError:
            await self._release_sources(oid, sources)
            if registered_partial:
                await self._retract_partial(oid, owner_conn)
            raise

        inflight = _InflightPull(size, offset, chunk)
        self._inflight_pulls[oid] = inflight
        pending = deque((off, min(chunk, size - off))
                        for off in range(0, size, chunk))
        total_chunks = len(pending)
        state = {"active": 0}
        # sinks write into the arena only while the transfer owns the
        # block: a straggler reply arriving after cleanup (its request
        # timed out and the chunk was re-fetched elsewhere) must not
        # scribble over a freed/re-allocated region
        alive = {"ok": True}
        loop = asyncio.get_running_loop()

        async def write_chunk(off: int, data) -> None:
            if len(data) >= (1 << 18):
                # GIL-releasing memmove off the event loop: cold arena
                # pages fault at ~0.3 GB/s on virtualized kernels, which
                # would stall every other RPC this raylet serves
                await loop.run_in_executor(
                    None, self.store.write_range, offset + off, data)
            else:
                view[off:off + len(data)] = data

        async def fetch_loop(src) -> None:
            while not inflight.failed:
                if len(inflight.have) >= total_chunks or src["dead"]:
                    return
                try:
                    item = pending.popleft()
                except IndexError:
                    if state["active"] == 0:
                        return  # done, or every remaining chunk is lost
                    await asyncio.sleep(0.02)
                    continue
                off, n = item
                if off // chunk in inflight.have:
                    continue  # already landed via the shm fast path
                state["active"] += 1
                _tm.transfer_window_occupancy(state["active"])
                got = [0]

                def sink(payload, _off=off, _got=got):
                    # runs synchronously at frame arrival: the chunk
                    # goes from the socket buffer straight into the
                    # arena — no intermediate bytes object
                    if alive["ok"] and not inflight.failed:
                        view[_off:_off + len(payload)] = payload
                        _got[0] = len(payload)

                try:
                    reply = await src["conn"].call(
                        "object_pull_chunk",
                        {"object_id": oid.binary(), "offset": off,
                         "n": n}, timeout=chunk_timeout, sink=sink)
                    if got[0] != n:
                        # no OOB payload: a partial holder / fallback
                        # path served plain bytes (or dropped the object)
                        if reply is None or len(reply) != n:
                            raise IOError(
                                "holder dropped object mid-transfer")
                        await write_chunk(off, reply)
                except (rpc.ConnectionLost, rpc.RpcError,
                        asyncio.TimeoutError, OSError):
                    # mid-transfer failover: the chunk goes back on the
                    # shared queue for the surviving sources; this
                    # source serves no further chunks
                    pending.append(item)
                    if not src["dead"]:
                        _tm.transfer_failover()
                    src["dead"] = True
                    return
                finally:
                    state["active"] -= 1
                _tm.transfer_chunk("net", n)
                inflight.mark(off // chunk)

        async def pump(src) -> None:
            n = min(window, total_chunks)
            # return_exceptions: one crashing fetcher must not strand
            # its siblings mid-write while cleanup deletes the object
            for res in await asyncio.gather(
                    *(fetch_loop(src) for _ in range(n)),
                    return_exceptions=True):
                if isinstance(res, BaseException):
                    logger.exception("pull fetcher failed for %s",
                                     oid.hex()[:12], exc_info=res)
                    inflight.fail()

        # same-host fast path: the holder's arena file is visible on
        # this machine (virtual clusters / multi-raylet hosts) — copy
        # arena-to-arena instead of paying the socket stack.  The
        # source pin taken at pull_start guards the range either way.
        shm_src = None
        if getattr(config, "object_transfer_shm_fastpath", True):
            for s in sources:
                meta = s.get("meta") or {}
                path = meta.get("store_path")
                if not s["partial"] and path and path != self.store.path \
                        and "offset" in meta and os.path.exists(path):
                    shm_src = s
                    break
        try:
            if shm_src is not None:
                try:
                    await self._pull_via_shm(shm_src, size, offset,
                                             inflight, chunk)
                except Exception:  # noqa: BLE001 — any shm failure
                    logger.exception(  # falls back to the socket path
                        "shm fast-path pull of %s failed; falling back "
                        "to network transfer", oid.hex()[:12])
            if len(inflight.have) < total_chunks:
                await asyncio.gather(*(pump(src) for src in sources))
        finally:
            alive["ok"] = False
            ok = len(inflight.have) >= total_chunks and not inflight.failed
            # seal BEFORE popping the inflight entry (no await between):
            # a chained puller must always find the copy either inflight
            # or sealed — the source releases below can take seconds and
            # previously left a neither-state window that broke chains
            if ok:
                self.store.seal(oid)
            self._inflight_pulls.pop(oid, None)
            if not ok:
                inflight.fail()
                self.store.delete(oid)
            await self._release_sources(oid, sources)
        path = "shm" if shm_src is not None else "net"
        elapsed = time.monotonic() - t_start
        _tm.transfer_pull_done(ok, path, size, elapsed, len(sources))
        _tm.record_span(
            "transfer", f"pull:{oid.hex()[:12]}", t_wall,
            t_wall + elapsed, bytes=size, sources=len(sources),
            path=path, ok=ok, node=self.node_id.hex()[:12])
        if not ok:
            if registered_partial:
                await self._retract_partial(oid, owner_conn)
            return False
        log = logger.info if size >= (64 << 20) else logger.debug
        log("pulled %s (%d MiB) in %.2fs via %s from %d source(s)",
            oid.hex()[:12], size >> 20, elapsed,
            "shm" if shm_src is not None else "net", len(sources))
        # secondary copy: not pinned, evictable.  Register it with the
        # owner so later pullers stripe across it and the owner's free
        # fan-out reaches this node.
        if owner_conn is not None:
            try:
                await owner_conn.call("object_location_added", {
                    "object_id": oid.binary(),
                    "node": list(self.server.address),
                    "partial": False}, timeout=5.0)
            except (rpc.ConnectionLost, rpc.RpcError,
                    asyncio.TimeoutError):
                pass
        return True

    def _release_late_probe(self, oid: ObjectID):
        """Done-callback for a probe that outlived the two-phase wait:
        if it did reach its holder, hand the pin straight back."""
        def _cb(task):
            src = None if task.cancelled() else task.result()
            if src is None or self._closing:
                return
            asyncio.ensure_future(self._release_sources(oid, [src]))
        return _cb

    def _peer_arena(self, path: str, capacity: int) -> list:
        """Cached mapping of a same-host peer raylet's arena as a
        ``[mmap, base_addr, export, refcount]`` entry.  Each call also
        sweeps mappings whose backing file is gone (a dead peer's
        unlinked arena would otherwise stay pinned in tmpfs until this
        raylet stops); in-use entries (refcount > 0) are spared."""
        for stale in [p for p, e in self._peer_arenas.items()
                      if e[3] == 0 and not os.path.exists(p)]:
            ent = self._peer_arenas.pop(stale)
            ent[2] = None  # drop the export before unmapping
            try:
                ent[0].close()
            except BufferError:
                pass
        ent = self._peer_arenas.get(path)
        if ent is None:
            from ray_tpu_torch.core.object_store import map_arena

            mm, base, export = map_arena(path, capacity)
            ent = self._peer_arenas[path] = [mm, base, export, 0]
        return ent

    async def _pull_via_shm(self, src, size: int, dest_offset: int,
                            inflight: _InflightPull, chunk: int) -> None:
        """Copy the object straight out of a same-host holder's arena:
        chunked GIL-releasing memmoves in the executor, with per-chunk
        progress marks so partial-location chaining still works."""
        meta = src["meta"]
        ent = self._peer_arena(meta["store_path"], meta["capacity"])
        base = ent[1]
        src_off = meta["offset"]
        loop = asyncio.get_running_loop()
        ent[3] += 1  # hold the mapping against the stale sweep
        try:
            pos = 0
            while pos < size and not inflight.failed:
                n = min(chunk, size - pos)
                await loop.run_in_executor(
                    None, self.store.copy_in, dest_offset + pos,
                    base + src_off + pos, n)
                _tm.transfer_chunk("shm", n)
                inflight.mark(pos // chunk)
                pos += n
        finally:
            ent[3] -= 1

    async def _release_sources(self, oid: ObjectID, sources) -> None:
        """Best-effort pull_end on every source — a dead holder's pins
        are reclaimed by its disconnect cleanup instead (a raising
        ``finally`` here used to mask the transfer's real error)."""
        for src in sources:
            conn = src["conn"]
            if conn.closed:
                continue
            try:
                await conn.call("object_pull_end",
                                {"object_id": oid.binary()}, timeout=5.0)
            except (rpc.ConnectionLost, rpc.RpcError, asyncio.TimeoutError,
                    OSError):
                pass

    async def _retract_partial(self, oid: ObjectID,
                               owner_conn: Optional[rpc.Connection]) -> None:
        if owner_conn is None or owner_conn.closed:
            return
        try:
            await owner_conn.call("object_location_removed", {
                "object_id": oid.binary(),
                "node": list(self.server.address),
                "partial": True}, timeout=5.0)
        except (rpc.ConnectionLost, rpc.RpcError, asyncio.TimeoutError):
            pass

    async def handle_object_pull_start(self, conn, data):
        # failpoint: the transfer source fails at serve start (chaos)
        await _fp.afailpoint("raylet.pull_start.serve")
        oid = ObjectID(data["object_id"])
        lease = self.store.lease(oid)
        if lease is None:
            target = self._spilled.get(oid)
            if target is not None and "://" not in target:
                # local spill file: serve the chunk stream STRAIGHT
                # from the blob — no arena allocation, no restore (a
                # restore under pressure would evict/spill warm
                # objects just to feed a remote reader).  The open fd
                # guards the blob: an owner free may unlink the path
                # mid-transfer, the inode survives until pull_end.
                try:
                    fd = os.open(target, os.O_RDONLY)
                except OSError:
                    return None
                try:
                    size = self._spilled_sizes.get(oid) \
                        or os.fstat(fd).st_size
                    serves = conn.context.setdefault("spill_serves", {})
                    stale = serves.pop(oid, None)
                    if stale is not None:  # duplicate start on this link
                        os.close(stale[0])
                    serves[oid] = (fd, size)
                except BaseException:
                    # fstat on a truncated blob (or a bad stale fd) must
                    # not leak the fresh fd until process exit
                    os.close(fd)
                    raise
                return {"size": size, "spilled": True}
            if target is not None and await self._restore_from_spill(oid):
                lease = self.store.lease(oid)
        if lease is not None:
            leases = conn.context.setdefault("pull_leases", set())
            if oid in leases:
                # duplicate start on this link: keep a single pin so
                # pull_end / disconnect cleanup stays balanced
                self.store.release(oid)
            else:
                leases.add(oid)
            # cache {offset,size} for the whole transfer: chunk serving
            # then reads straight from the arena without re-taking the
            # store lease per chunk (the pin above keeps it valid)
            conn.context.setdefault("pull_offsets", {})[oid] = lease
            # arena coordinates let a same-host puller copy through
            # shared memory instead of the socket (the pin still
            # guards the range until pull_end)
            return {"size": lease[1], "offset": lease[0],
                    "store_path": self.store.path,
                    "capacity": self.store_capacity}
        inflight = self._inflight_pulls.get(oid)
        if inflight is not None and not inflight.failed:
            # in-progress copy: serve as a *partial* source — chunk
            # requests wait (bounded) for this node's own transfer to
            # produce the range (wait-and-chain broadcast)
            return {"size": inflight.size, "partial": True}
        return None

    async def handle_object_pull_chunk(self, conn, data):
        oid = ObjectID(data["object_id"])
        start = data["offset"]
        n = data["n"]
        # failpoint: the source dies mid-transfer (chaos: striped pulls
        # must fail over to the surviving sources)
        if _fp.active():
            await _fp.afailpoint("raylet.pull_chunk.serve")
        if start < 0 or n <= 0:
            return None
        spill_serve = (conn.context.get("spill_serves") or {}).get(oid)
        if spill_serve is not None:
            fd, size = spill_serve
            if start + n > size:
                return None
            # positioned read in the executor: a cold 5 MiB disk read
            # must not stall every other RPC this raylet serves
            payload = await asyncio.get_running_loop().run_in_executor(
                None, os.pread, fd, n, start)
            return payload if len(payload) == n else None
        entry = (conn.context.get("pull_offsets") or {}).get(oid)
        if entry is not None:
            offset, size = entry
            if start + n <= size:
                # out-of-band payload: the chunk travels as raw frame
                # bytes straight from the arena view to the socket — no
                # bytes() copy, no pickle copy.  Safe because the
                # pull_start pin is held and the frame is queued before
                # this handler yields.
                return rpc.OobPayload(
                    {"n": n}, self.store.view(offset + start, n))
            return None
        inflight = self._inflight_pulls.get(oid)
        if inflight is not None:
            ok = await inflight.wait_range(
                start, n,
                getattr(self.config, "object_transfer_chunk_timeout_s",
                        30.0))
            # serve from the in-progress copy only while its transfer
            # still OWNS the block (entry present and not failed): a
            # just-sealed copy is unpinned/evictable, so the sealed
            # case must go through the pinning lease path below
            if ok and not inflight.failed and start + n <= inflight.size \
                    and self._inflight_pulls.get(oid) is inflight:
                return bytes(self.store.view(inflight.offset + start, n))
            # fall through: the transfer may have sealed (serve from the
            # store) or failed (lease below misses -> None)
        lease = self.store.lease(oid)
        if lease is None:
            return None
        try:
            offset, size = lease
            if start + n > size:
                return None
            return bytes(self.store.view(offset + start, n))
        finally:
            self.store.release(oid)

    async def handle_object_pull_end(self, conn, data):
        oid = ObjectID(data["object_id"])
        leases = conn.context.get("pull_leases", set())
        if oid in leases:
            leases.discard(oid)
            (conn.context.get("pull_offsets") or {}).pop(oid, None)
            self.store.release(oid)
        serve = (conn.context.get("spill_serves") or {}).pop(oid, None)
        if serve is not None:
            os.close(serve[0])
        return True

    async def handle_object_release(self, conn, data):
        for b in data["object_ids"]:
            self.store.release(ObjectID(b))
        return True

    async def handle_object_contains(self, conn, data):
        oid = ObjectID(data["object_id"])
        return self.store.contains(oid) or oid in self._spilled

    async def handle_object_free(self, conn, data):
        """Owner-driven free: drop primaries, spill files, local copies."""
        for b in data["object_ids"]:
            oid = ObjectID(b)
            inflight = self._inflight_pulls.get(oid)
            if inflight is not None:
                # freeing mid-pull: fail the transfer and let ITS
                # cleanup delete the create once every writer stopped —
                # deleting here would free the block under in-flight
                # chunk writes and corrupt whatever reuses it
                inflight.fail()
                self._owner_of.pop(oid, None)
                continue
            if oid in self._primary:
                self._primary.discard(oid)
                self.store.release(oid)
            target = self._spilled.pop(oid, None)
            if target:
                self._spill_bytes -= self._spilled_sizes.pop(oid, 0)
                # executor-side: a URI-tier delete is a network call
                # that must not stall this event loop (local unlinks
                # ride along for uniformity)
                await asyncio.get_running_loop().run_in_executor(
                    None, self._delete_spill_blob, target)
            entry = self._restoring.get(oid)
            if entry is not None:
                # an executor thread is writing this object's arena
                # block right now: deleting would free the unsealed
                # pin-0 entry instantly and the write would scribble
                # over whatever re-allocates it — flag the restores to
                # complete the delete on the last guard-exit
                entry[1] = True
            else:
                self.store.delete(oid)
            self._owner_of.pop(oid, None)
        return True

    async def handle_store_info(self, conn, data):
        """Connection bootstrap info for late-joining drivers."""
        return {"store_path": self.store.path,
                "store_capacity": self.store_capacity,
                "session_dir": self.session_dir,
                "node_id": self.node_id.binary()}

    async def handle_store_stats(self, conn, data):
        try:
            stats = self.store.stats_ex()
        except Exception:  # noqa: BLE001 — older .so without stats_ex
            stats = self.store.stats()
        stats["num_primary"] = len(self._primary)
        stats["num_spilled"] = len(self._spilled)
        stats["spill_bytes"] = self._spill_bytes
        return stats

    # ------------------------------------------------------------------
    # spilling (LocalObjectManager)
    # ------------------------------------------------------------------
    async def _maybe_spill(self, incoming: int) -> None:
        """Spill cold sealed primaries to the disk tier under arena
        pressure.

        Selection is LRU by LAST PIN from the native store's spill
        queue (``spill_candidates`` with max_pins=1: the raylet's own
        primary pin — a client-pinned or unsealed object can never be
        picked).  Blob writes run in the executor with the object's
        lease held and commit via rename, so a write that dies
        mid-flight never leaves a half file claiming to be a valid
        blob and the in-store copy survives every failure mode.  One
        sweep runs at a time; concurrent creates ride their own retry
        loop while it makes room."""
        cfg = self.config
        frac = getattr(cfg, "object_spill_threshold", -1.0)
        if frac is None or frac < 0:
            frac = cfg.object_spilling_threshold
        threshold = frac * self.store_capacity
        # lock-free pressure probe: this runs on EVERY create/pull
        # allocation — stats() would sweep all shard mutexes (and
        # inflate the contention counters) just to count objects
        if self.store.used() + incoming <= threshold:
            return
        if self._spill_lock is None:
            self._spill_lock = asyncio.Lock()
        async with self._spill_lock:
            used = self.store.used()
            if used + incoming <= threshold:
                return  # the sweep we waited on already made room
            await self._spill_sweep(used + incoming - int(threshold))

    async def _spill_for_fragmentation(self, need: int) -> None:
        """An allocation failed while accounting says there is room:
        the free space exists but no single run fits (fragmentation —
        long-lived primaries pinning stripe-region starts).  Spill
        ``need`` bytes of the coldest primaries regardless of the
        pressure threshold; a spilled block's region becomes one
        contiguous free run.  Shares ``_spill_lock`` with the pressure
        sweeps, so at most one sweep runs at a time."""
        if self._spill_lock is None:
            self._spill_lock = asyncio.Lock()
        async with self._spill_lock:
            await self._spill_sweep(need)

    async def _spill_sweep(self, need: int) -> None:
        cfg = self.config
        spill_uri = cfg.object_spilling_uri
        max_bytes = getattr(cfg, "object_spill_max_bytes", 0)
        loop = asyncio.get_running_loop()
        spilled = 0
        candidates = self.store.spill_candidates(max_ids=256, max_pins=1)
        if candidates is None:
            # stale .so without the spill queue: fall back to the old
            # behavior — primaries in table order, sizes learned from
            # the lease below (0 here skips only the pre-lease cap
            # check; the post-lease one still applies)
            candidates = [(o, 0) for o in list(self._primary)]
        # owners whose commit RPC failed THIS sweep: skip their other
        # objects instead of burning a timeout each — the sweep runs
        # under _spill_lock, which concurrent creates wait on against
        # their own 30 s deadline
        dead_owners: set = set()
        for oid, size in candidates:
            if spilled >= need:
                break
            if oid not in self._primary or oid in self._spilled:
                continue  # secondary copies just evict; never re-spill
            if self._owner_of.get(oid) in dead_owners:
                continue  # unreachable owner: nothing to commit to
            if max_bytes and self._spill_bytes + size > max_bytes:
                logger.warning(
                    "spill tier at object_spill_max_bytes cap (%d); "
                    "arena pressure will surface as store-full", max_bytes)
                break
            lease = self.store.lease(oid)
            if lease is None:
                self._primary.discard(oid)  # raced away
                continue
            offset, lsize = lease
            if max_bytes and self._spill_bytes + lsize > max_bytes:
                self.store.release(oid)
                break  # true size known only post-lease on the fallback
            # snapshot the owner before the commit await: a concurrent
            # free can pop _owner_of mid-RPC, and a None slipped into
            # dead_owners would match every OWNERLESS later candidate
            owner = self._owner_of.get(oid)
            try:
                view = self.store.view(offset, lsize)
                if spill_uri:
                    # external tier: the blob outlives this node, and
                    # the owner learns the URI so ANY node can restore
                    # (parity: reference external_storage.py)
                    from ray_tpu_torch.air import storage as air_storage
                    uri = air_storage.join(spill_uri, oid.hex())
                    await loop.run_in_executor(
                        None, self._write_spill_uri, uri, view)
                    # two-phase commit: the in-store copy is only
                    # dropped once the OWNER has durably recorded the
                    # blob — a fire-and-forget notify raced node death
                    # (blob written, owner ignorant: the object was
                    # unrestorable AND its blob leaked on free)
                    if not await self._commit_spill_to_owner(oid,
                                                             uri=uri):
                        if owner is not None:
                            dead_owners.add(owner)
                        await loop.run_in_executor(
                            None, self._delete_spill_blob, uri)
                        self.store.release(oid)
                        continue
                    self._spilled[oid] = uri
                else:
                    path = os.path.join(self._spill_dir, oid.hex())
                    await loop.run_in_executor(
                        None, self._write_spill_file, path, view)
                    # local tier: the owner records the NODE so remote
                    # pulls route here and stream from the spill file
                    addr = getattr(self.server, "address", None)
                    if addr and not await self._commit_spill_to_owner(
                            oid, node=list(addr)):
                        if owner is not None:
                            dead_owners.add(owner)
                        await loop.run_in_executor(
                            None, self._delete_spill_blob, path)
                        self.store.release(oid)
                        continue
                    self._spilled[oid] = path
            except Exception:  # noqa: BLE001 — spill tier down: keep
                # the in-store copy (primary pin stays; only the lease
                # taken above is dropped)
                logger.exception("spill of %s failed; keeping in-store",
                                 oid.hex()[:12])
                self.store.release(oid)
                continue
            if not self.store.contains(oid):
                # the owner freed the object while the blob was being
                # written (our lease doomed the delete): registering the
                # spill now would resurrect a freed object and leak its
                # blob — discard and let the release complete the free
                target = self._spilled.pop(oid, None)
                if target is not None:
                    await loop.run_in_executor(
                        None, self._delete_spill_blob, target)
                self.store.release(oid)
                continue
            self._spilled_sizes[oid] = lsize
            self._spill_bytes += lsize
            _tm.store_spilled(lsize)
            # per-job attribution: the owner job rides inside the id
            # (ObjectID -> TaskID -> JobID lineage encoding)
            _tm.job_spilled_bytes(oid.job_id().hex(), lsize)
            self.store.release(oid)  # the lease taken above
            self._primary.discard(oid)
            self.store.release(oid)  # drop the primary pin
            self.store.delete(oid)
            spilled += lsize

    def _write_spill_file(self, path: str, view) -> None:
        """Executor-side blob write: tmp file + rename commit, so a
        failure (or kill) mid-write never publishes a torn blob."""
        tmp = path + ".tmp"
        try:
            with open(tmp, "wb") as f:
                half = len(view) // 2
                f.write(view[:half])
                # failpoint: the spill write dies mid-flight (chaos) —
                # the half-written tmp must be discarded, never adopted
                _spill_write_failpoint()
                f.write(view[half:])
            os.replace(tmp, path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise

    def _write_spill_uri(self, uri: str, view) -> None:
        _spill_write_failpoint()
        from ray_tpu_torch.air import storage as air_storage
        air_storage.write_bytes(uri, bytes(view))

    async def _commit_spill_to_owner(self, oid: ObjectID,
                                     uri: Optional[str] = None,
                                     node: Optional[list] = None) -> bool:
        """Record the blob's location with the owner — a URI (restores
        anywhere, survives this node) or this node's address (local
        spill file; pulls stream straight from it).  The sweep only
        drops the in-store copy on True; an unowned object (no owner
        recorded — e.g. a restored secondary) commits trivially."""
        owner = self._owner_of.get(oid)
        if owner is None:
            return True
        try:
            conn = await self.pool.get((owner[1], owner[2]))
            payload: Dict[str, Any] = {"object_id": oid.binary()}
            if uri is not None:
                payload["uri"] = uri
            if node is not None:
                payload["node"] = node
            # short timeout: the sweep holds _spill_lock, which
            # concurrent creates wait on against their own deadline —
            # a black-holed owner must not stall the whole arena
            await conn.call("object_spilled", payload, timeout=3.0)
            return True
        except Exception:  # noqa: BLE001 — owner unreachable: the
            return False   # caller keeps the in-store copy

    def _delete_spill_blob(self, target: str) -> None:
        try:
            if "://" in target:
                from ray_tpu_torch.air import storage as air_storage
                air_storage.delete(target)
            else:
                os.unlink(target)
        except Exception:  # noqa: BLE001 — best-effort cleanup
            pass

    async def _restore_from_spill(self, oid: ObjectID) -> bool:
        """Transparent restore: read the spilled blob back into the
        arena and seal it (unpinned — a restored copy just evicts; its
        blob stays in the tier until the owner frees the object)."""
        target = self._spilled.get(oid)
        if target is None:
            return False
        if "://" in target:
            return await self._restore_from_uri(oid, target)
        try:
            size = os.path.getsize(target)
        except OSError:
            return False
        # guard entered before the FIRST await — see _finish_restore
        self._restore_guard_enter(oid)
        return await self._finish_restore(
            oid, size, target,
            lambda offset, view: self._read_spill_file(target, view))

    async def _restore_from_uri(self, oid: ObjectID, uri: str) -> bool:
        """Restore a URI-spilled blob — works on ANY node, including
        ones that never held the object (the spiller may be dead)."""
        loop = asyncio.get_running_loop()
        # the guard must span the blob READ too: a free landing while
        # the read runs deletes the (not-yet-existing) arena entry as a
        # no-op — sealing the already-read bytes afterwards would
        # resurrect the freed object as an undeletable zombie
        self._restore_guard_enter(oid)
        try:
            data = await loop.run_in_executor(
                None, self._read_spill_uri, uri)
        except Exception:  # noqa: BLE001 — missing/unreachable tier
            if self._restore_guard_exit(oid):
                self.store.delete(oid)
            return False
        if self._restoring[oid][1]:
            # freed during the read; its blob is already deleted
            if self._restore_guard_exit(oid):
                self.store.delete(oid)
            return False
        return await self._finish_restore(
            oid, len(data), uri,
            lambda offset, view: self.store.write_range(offset, data))

    def _restore_guard_enter(self, oid: ObjectID) -> None:
        ent = self._restoring.get(oid)
        if ent is None:
            ent = self._restoring[oid] = [0, False]
        ent[0] += 1

    def _restore_guard_exit(self, oid: ObjectID) -> bool:
        """Drop one restore's guard; True when this was the LAST guard
        out AND a free arrived mid-restore — the caller then completes
        the deferred delete (earlier exiters must not: a sibling's
        executor thread may still own the block)."""
        ent = self._restoring[oid]
        ent[0] -= 1
        if ent[0] > 0:
            return False
        del self._restoring[oid]
        return ent[1]

    async def _finish_restore(self, oid: ObjectID, size: int,
                              target: str, writer) -> bool:
        """Allocate + executor-write + seal under the freed-mid-restore
        discipline.  The caller has ALREADY entered ``_restoring[oid]``
        (before its first await): handle_object_free must never
        store.delete an oid whose arena block an executor thread may be
        writing — it flags the entry instead and the last guard-exit
        here completes the deferred delete.  Every path out drops the
        guard exactly once."""
        ok = False
        try:
            try:
                # restoring may itself need room: spill colder objects
                # first so larger-than-arena working sets rotate through
                await self._maybe_spill(size)
                offset, view = self.store.alloc(oid, size)
            except ValueError:
                return self.store.contains(oid)  # concurrently restored
            except Exception:  # noqa: BLE001 — full even after spilling
                return False
            loop = asyncio.get_running_loop()
            try:
                # GIL-releasing write off the event loop (restored
                # blobs can be arena-sized)
                await loop.run_in_executor(None, writer, offset, view)
            except Exception:  # noqa: BLE001 — unreadable blob: drop
                # the create so the id isn't stuck half-restored
                logger.exception("restore of %s from %s failed",
                                 oid.hex()[:12], target)
                self.store.delete(oid)
                return False
            # seal before the guard drops: if a free raced in, the
            # guard-exit below deletes the (briefly sealed) copy
            self.store.seal(oid)
            ok = True
        finally:
            if self._restore_guard_exit(oid):
                # freed while the restore ran: complete the deferred
                # delete now that no executor thread owns the block
                self.store.delete(oid)
                ok = False
        if ok:
            _tm.store_restored(size)
            return True
        return False

    def _read_spill_file(self, path: str, view) -> None:
        # failpoint: the restore read fails (chaos) — the caller must
        # surface a miss, not a torn object
        _restore_read_failpoint()
        with open(path, "rb") as f:
            f.readinto(view)

    def _read_spill_uri(self, uri: str) -> bytes:
        _restore_read_failpoint()
        from ray_tpu_torch.air import storage as air_storage
        return air_storage.read_bytes(uri)
