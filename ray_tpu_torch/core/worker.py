"""CoreWorker: the per-process runtime embedded in drivers and workers.

Parity: reference ``src/ray/core_worker/core_worker.h`` — task submission
(lease-then-direct-push, ``direct_task_transport.h``), actor submission
(ordered per-actor queues, ``direct_actor_task_submitter.h``), object
``put``/``get``/``wait`` over a two-tier store (in-process memory store for
small values, node shared-memory store for large ones), ownership-based
reference counting, task retries, and lineage reconstruction.

Threading model: all network I/O runs on one background asyncio loop
("io thread").  User threads call the sync API which bridges with
``run_coroutine_threadsafe``.  Task execution (worker mode) happens on
dedicated executor thread(s) fed by a queue so user code never blocks the
I/O loop.

Zero-copy: values fetched from shared memory deserialize with their
buffers aliasing the store mapping.  Each buffer is wrapped in a
:class:`_PinnedBuffer` (PEP 688 ``__buffer__`` protocol) holding a lease on
the store slot; when the last consuming array is garbage collected the pin
is released and the slot becomes evictable — the same lifetime contract as
the reference's plasma client buffers.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import hashlib
import inspect
import itertools
import logging
import os
import pickle
import queue as queue_mod
import sys
import threading
import time
from collections import deque
from typing import (Any, Awaitable, Callable, Dict, List, Optional, Sequence,
                    Tuple)

import cloudpickle


def _spec_dumps(obj) -> bytes:
    """Wire-serialize a TaskSpec (or list of them).

    Specs are plain dataclasses of ids/bytes/strings — the C pickler
    handles them ~20x faster than cloudpickle (user functions never
    travel here; they're in the GCS function table by id).  Loading uses
    plain ``pickle.loads`` either way.
    """
    try:
        return pickle.dumps(obj, protocol=5)
    except Exception:  # e.g. an exotic strategy payload — keep working
        return cloudpickle.dumps(obj)

from ray_tpu_torch.core import device_telemetry as _dt
from ray_tpu_torch.core import flight_recorder as _flight
from ray_tpu_torch.core import profiler as _prof
from ray_tpu_torch.core import rpc
from ray_tpu_torch.core import telemetry as _tm
from ray_tpu_torch.core.config import Config, get_config, set_config
from ray_tpu_torch.core.exceptions import (
    ActorDiedError,
    ActorExitRequest,
    GetTimeoutError,
    ObjectLostError,
    RayTpuError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.core.ids import (
    ActorID,
    JobID,
    NodeID,
    ObjectID,
    TaskID,
    WorkerID,
    _Counter,
)
from ray_tpu_torch.core.object_ref import ObjectRef, OwnerAddress
from ray_tpu_torch.core.object_store import MemoryStore, StoreClient
from ray_tpu_torch.core.refcount import ReferenceCounter, TaskManager
from ray_tpu_torch.util import failpoint as _fp
from ray_tpu_torch.core.serialization import (
    SerializedObject,
    deserialize,
    serialize,
    serialize_exception,
)
from ray_tpu_torch.core.task_spec import (
    ActorCreationSpec,
    SchedulingStrategy,
    TaskArg,
    TaskSpec,
    TaskType,
)

logger = logging.getLogger(__name__)

PLASMA_MARKER = b"__RTPU_IN_PLASMA__"

#: Cancel-interrupt window (per thread): True only while the exec
#: thread is inside a task BODY (arg resolution + user function).  The
#: worker's SIGINT handler (worker_main._install_cancel_sigint_handler)
#: consults it so a cancel signal that lands after the body returned —
#: during reply commit — is swallowed instead of killing the exec loop.
INTERRUPT_WINDOW = threading.local()


def _renv_hash(runtime_env: Optional[Dict[str, Any]]) -> Optional[str]:
    if not runtime_env:
        return None
    from ray_tpu_torch.runtime_env import env_hash
    return env_hash(runtime_env)


def _renv_spawn(runtime_env: Optional[Dict[str, Any]]
                ) -> Optional[Dict[str, Any]]:
    """Spawn-time requirements (isolated interpreter / container) the
    raylet needs alongside the env hash; None for in-process envs."""
    if not runtime_env:
        return None
    from ray_tpu_torch.runtime_env import spawn_spec
    return spawn_spec(runtime_env)


from ray_tpu_torch.core import tracing as _trace

_tracing_fns: Optional[tuple] = None


def _trace_carrier() -> Optional[Dict[str, str]]:
    global _tracing_fns
    fns = _tracing_fns
    if fns is None:
        from ray_tpu_torch.util.tracing.tracing_helper import (
            current_trace_context, is_tracing_enabled)
        fns = _tracing_fns = (is_tracing_enabled, current_trace_context)
    if not fns[0]():
        return None
    return fns[1]()

_global_worker: Optional["CoreWorker"] = None
_global_lock = threading.Lock()

# Shared wire bytes for the trailing empty-kwargs arg every no-kwarg task
# carries (serializing {} per submission measured ~17 us on nop storms).
_empty_kwargs_cache: Optional[TaskArg] = None


def _empty_kwargs_arg() -> TaskArg:
    global _empty_kwargs_cache
    arg = _empty_kwargs_cache
    if arg is None:
        arg = TaskArg(value_bytes=serialize({}).to_bytes(), contained_ids=[])
        _empty_kwargs_cache = arg
    return arg


def global_worker() -> "CoreWorker":
    if _global_worker is None:
        raise RayTpuError("ray_tpu_torch.init() has not been called")
    return _global_worker


def global_worker_or_none() -> Optional["CoreWorker"]:
    return _global_worker


def set_global_worker(worker: Optional["CoreWorker"]) -> None:
    global _global_worker
    with _global_lock:
        _global_worker = worker


class _PinnedBuffer:
    """Buffer-protocol wrapper that releases a store pin on GC (PEP 688)."""

    def __init__(self, view: memoryview, pin: "_Pin"):
        self._view = view
        self._pin = pin
        pin.count += 1

    def __buffer__(self, flags: int) -> memoryview:
        return self._view

    def __release_buffer__(self, view: memoryview) -> None:
        pass

    def __len__(self) -> int:
        return self._view.nbytes

    def __del__(self):
        pin = self._pin
        pin.count -= 1
        if pin.count == 0:
            pin.release()


class _Pin:
    __slots__ = ("count", "release")

    def __init__(self, release: Callable[[], None]):
        self.count = 0
        self.release = release


class _TaskContext(threading.local):
    task_id: Optional[TaskID] = None
    put_counter: Optional[_Counter] = None
    actor_id: Optional[ActorID] = None
    attempt_number: int = 0
    #: resource demand of the task currently executing on this thread
    current_resources: Optional[Dict[str, float]] = None


class CoreWorker:
    def __init__(self, *, mode: str, gcs_address: rpc.Address,
                 raylet_address: rpc.Address, node_id: NodeID,
                 store_path: str, store_capacity: int, session_dir: str,
                 job_id: Optional[JobID] = None,
                 config: Optional[Config] = None):
        assert mode in ("driver", "worker")
        _trace = os.environ.get("RAY_TPU_TORCH_BOOT_TRACE")
        _t0 = time.perf_counter()

        def _mark(label):
            if _trace:
                import sys as _sys
                _sys.stderr.write(f"BOOT cw.{label} "
                                  f"{1000 * (time.perf_counter() - _t0):.1f}"
                                  f"ms\n")
                _sys.stderr.flush()
        self.mode = mode
        self.gcs_address = gcs_address
        self.raylet_address = raylet_address
        self.node_id = node_id
        self.session_dir = session_dir
        self.worker_id = WorkerID.from_random()
        self._worker_id_hex = self.worker_id.hex()
        self.config = config or get_config()
        # crash-surviving flight ring for this process (no-op if the
        # co-located GCS/raylet already opened one — first init wins)
        _flight.init(mode, session_dir, self.config)

        self.memory_store = MemoryStore()
        _mark("pre_store")
        self.store_client = StoreClient(store_path, store_capacity)
        _mark("store")
        self.reference_counter = ReferenceCounter(
            on_free=self._on_object_freed,
            on_borrow_added=self._on_borrow_added,
            on_borrow_removed=self._on_borrow_removed,
        )
        self.task_manager = TaskManager(self.reference_counter)

        # io loop thread
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._loop.run_forever, name="rtpu-io", daemon=True)
        self._loop_thread.start()
        _mark("loop_thread")

        self._ctx = _TaskContext()
        self._address_cache: Optional[OwnerAddress] = None
        self.job_id = job_id
        self._driver_task_id: Optional[TaskID] = None
        self._object_events: Dict[ObjectID, asyncio.Event] = {}
        # sync-get fast path: calling threads park on a threading.Event
        # that _publish sets DIRECTLY (no io-loop hop) — the loop-based
        # _object_events above serve the coroutine paths
        self._sync_object_waiters: Dict[ObjectID, list] = {}
        self._task_done_events: Dict[TaskID, asyncio.Event] = {}

        # execution (worker mode)
        self._exec_queue: "queue_mod.Queue" = queue_mod.Queue()
        # max_calls worker recycling: executions per function_id; once a
        # spec's max_calls is reached the worker replies with
        # worker_exit=True and exits after the reply flushes
        self._fn_exec_counts: Dict[str, int] = {}
        self._exit_after_reply = False
        #: exit_actor() ran: queued calls fail instead of executing
        self._actor_exiting = False
        #: a future the exit sequence must wait on (exit_actor's GCS ack)
        self._exit_barrier = None
        self._exec_threads: List[threading.Thread] = []
        self._function_cache: Dict[str, Any] = {}
        # raylet-prefetched function blobs, decoded lazily on exec threads
        self._function_blobs: Dict[str, bytes] = {}
        self._registered_functions: set = set()
        self._syspath_applied: set = set()
        self._actor_instance: Any = None
        self._actor_id: Optional[ActorID] = None
        self._actor_creation_spec: Optional[ActorCreationSpec] = None
        self._max_concurrency = 1
        # named concurrency groups: group -> dedicated exec queue
        self._group_queues: Dict[str, "queue_mod.Queue"] = {}
        self._actor_reply_cache: Dict[Tuple, Dict[str, Any]] = {}

        # submitters
        self._lease_states: Dict[Tuple, "_LeaseState"] = {}
        self._actor_states: Dict[ActorID, "_ActorSubmitState"] = {}
        self._lease_tokens = itertools.count(1)
        # node-id -> raylet-address snapshot for locality lease routing
        self._node_addr_cache: Optional[Dict[str, tuple]] = None
        self._node_addr_cache_ts = 0.0
        # coalesced actor registration: creations buffered on the user
        # thread, flushed as ONE register_actor_batch RPC per loop
        # drain (idempotent keyed on actor_id, so the flush can retry
        # a dropped batch without double-registering)
        self._actor_reg_lock = threading.Lock()
        self._actor_reg_buf: List[tuple] = []
        self._actor_reg_scheduled = False
        # owner-side lease cache: (raylet, resource shape, env hash) ->
        # parked idle _LeasedWorkers any compatible scheduling key can
        # claim without a raylet round trip; total size bounded by
        # lease_cache_size, entries expire on their idle-grace timer
        self._lease_cache: Dict[Tuple, List["_LeasedWorker"]] = {}
        self._lease_cache_n = 0
        self._lease_cache_hits = 0
        self._lease_cache_misses = 0
        # head fault tolerance (driver): frozen while the local raylet is
        # unreachable; _reattach_raylet thaws it
        self._raylet_down = False
        self._raylet_repairing = False
        self._raylet_gave_up = False  # repair timed out; fail fast now
        self._reattach_lock: Optional[asyncio.Lock] = None
        self._reconnecting = False

        self._pool = rpc.ConnectionPool()
        self.gcs_conn: Optional[rpc.Connection] = None
        self.raylet_conn: Optional[rpc.Connection] = None
        self.task_server: Optional[rpc.Server] = None
        self.task_address: Optional[rpc.Address] = None
        self._shutdown = False
        self._task_events: List[tuple] = []  # raw task-state tuples, formatted at flush
        # monotonic flush seqs: the GCS folds these reports into
        # accumulating tables, so a retried delivery must carry the SAME
        # seq as its first attempt for the replay guard to drop it
        self._task_event_report_seq = 0
        self._metrics_report_seq = 0
        self._reg_batch_seq = 0
        # task_id bin -> submit monotonic time (dispatch-latency metric)
        self._dispatch_ts: Dict[bytes, float] = {}
        self._lease_gpu_ids: List[int] = []
        # task_id bin -> in-flight owner-side trace span (born at
        # submission, ended at terminal completion/failure); entries
        # live exactly as long as the task is pending
        self._trace_spans: Dict[bytes, "_trace.Span"] = {}

        # GC-driven ref releases (ObjectRef.__del__) are deferred here and
        # drained on the io loop: __del__ can fire on ANY thread at ANY
        # bytecode boundary — including while that thread holds unrelated
        # locks — so the refcount mutation and its free callbacks must not
        # run inline (parity: reference_count.cc posts deletions to the
        # io_service).
        self._gc_release_queue = _BurstQueue(
            self._loop, self.reference_counter.remove_local_ref)

        # Submissions from the driver thread batch into one loop wakeup
        # (one call_soon_threadsafe per burst instead of per task).
        self._touched_states: Dict[Tuple, "_LeaseState"] = {}
        self._submit_queue = _BurstQueue(
            self._loop, self._route_submit, self._flush_submits)
        # Exec-thread completions batch the same way: one self-pipe
        # wakeup per burst of finished tasks instead of one per task
        # (measured ~100us of loop work per wakeup on actor-call storms)
        self._result_queue = _BurstQueue(
            self._loop, lambda item: _set_future(item[0], item[1]))
        # batched pushes stream per-task results back; this maps
        # task_id -> (spec, lease state, worker) until settled
        self._streamed: Dict[bytes, tuple] = {}
        # num_returns="streaming": owner-side per-task stream progress
        # (task_id bin -> _StreamState) and executor-side per-task item
        # emitters (installed by the push handlers, consumed in
        # _post_dynamic_returns)
        self._streaming_states: Dict[bytes, "_StreamState"] = {}
        self._stream_emitters: Dict[bytes, Any] = {}
        # task ids whose StreamingObjectRefGenerator was GC'd while the
        # task still ran: _finish_stream reaps their state at the end
        self._stream_abandoned: set = set()
        self._children_prune_pos = 0
        # same for batched actor pushes: (task_id, attempt) -> (spec, state)
        self._actor_streamed: Dict[tuple, tuple] = {}

        # -- cancellation (parity: reference worker.py:2582 cancel path) --
        # owner side: task_id bins with a cancel requested (suppresses
        # retries so a killed/interrupted attempt fails as CANCELLED,
        # never resubmits) and task_id bin -> executing worker address
        self._cancel_requested: set = set()
        self._task_locations: Dict[bytes, rpc.Address] = {}
        # owner-side object directory extension: nodes holding an
        # IN-PROGRESS copy of an owned object (registered by pulling
        # raylets at transfer start, promoted to a real location on
        # seal) — lets concurrent pullers chain into a broadcast tree
        self._partial_locations: Dict[bytes, set] = {}
        # executor side: queued-task cancels (checked at exec start),
        # currently-executing task per exec thread, and tasks whose exec
        # thread got an async KeyboardInterrupt (so the catch block can
        # tell a cancel interrupt from a user-raised KeyboardInterrupt)
        self._cancelled_exec: set = set()
        self._exec_track_lock = threading.Lock()
        self._executing_by_thread: Dict[int, bytes] = {}
        # profiler attribution: thread ident -> (task name, task_id hex,
        # actor hex, job hex) while that thread executes a task; the
        # sampling profiler snapshots this dict each tick
        self._executing_info: Dict[int, tuple] = {}
        self._interrupted_tasks: set = set()
        # owner side, recursive cancel: parent task -> child TaskIDs
        # submitted from inside its execution on this worker
        self._children: Dict[bytes, List[TaskID]] = {}
        # dependency gating (loop-confined): task_id bin -> (spec, deps)
        # for specs whose owned ref args don't exist yet, and the
        # reverse index object_id -> [entries] for release on publish
        self._waiting_for_deps: Dict[bytes, tuple] = {}
        self._dep_waiters: Dict[ObjectID, list] = {}

        _mark("pre_async_init")
        # load env-armed failpoints up front: site checks (and the actor
        # fast-path gate) then reduce to one empty-dict truth test
        _fp.armed()
        # profiler attribution provider: a dict() copy per sample tick
        # (25 Hz), zero cost on the task hot path itself
        _prof.set_task_info_provider(lambda: dict(self._executing_info))
        self._run(self._async_init())
        _mark("async_init")
        set_global_worker(self)

    # ------------------------------------------------------------------
    # bootstrap / teardown
    # ------------------------------------------------------------------
    def _run(self, coro, timeout: Optional[float] = None):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result(timeout)

    def _post(self, coro) -> None:
        """Fire-and-forget a coroutine on the io loop."""
        def _spawn():
            task = self._loop.create_task(coro)
            task.add_done_callback(lambda t: t.exception())
        try:
            self._loop.call_soon_threadsafe(_spawn)
        except (RuntimeError, AttributeError):
            coro.close()  # loop shut down (interpreter teardown)

    async def _async_init(self) -> None:
        self.task_server = rpc.Server(self, host="127.0.0.1", port=0)
        self.task_address = await self.task_server.start()
        # pooled conns (remote raylets, peer workers) carry our handler so
        # those peers can push back (e.g. reclaim_idle from a spillback
        # raylet, task_results from leased workers)
        self._pool._handler = self.task_server
        # outbound connections carry our handler too, so the raylet/GCS can
        # call back into this worker over the registration link (e.g.
        # create_actor pushes)
        self.gcs_conn = await rpc.connect(self.gcs_address,
                                          handler=self.task_server)
        self.gcs_conn.set_push_handler(self._on_gcs_push)
        if self.mode == "worker":
            # adopt cluster-armed failpoints (tests arm via internal KV
            # after processes exist; env-var arming covers spawn time)
            await _fp.sync_from_kv(self.gcs_conn)
        if self.mode == "driver" and self.config.log_to_driver:
            # stream worker stdout/stderr to this driver (parity: the
            # reference's log monitor -> driver echo with pid prefixes)
            await self.gcs_conn.call("subscribe",
                                     {"channel": "worker_logs"})
        if self.mode == "driver" and self.job_id is None:
            reply = await self.gcs_conn.call(
                "register_job", {"driver_address": self.task_address})
            self.job_id = JobID(reply["job_id"])
            # publish the driver's import paths so workers can deserialize
            # by-reference functions from driver-side modules (parity:
            # the reference's working_dir runtime env / function manager)
            import sys as _sys

            paths = [p for p in _sys.path
                     if p and os.path.isdir(p)][:64]
            await self.gcs_conn.call("kv_put", {
                "key": f"syspath:{self.job_id.hex()}",
                "value": cloudpickle.dumps(paths),
                "namespace": "_internal"})
        self.raylet_conn = await rpc.connect(self.raylet_address,
                                             handler=self.task_server)
        if self.mode == "worker":
            # a worker must not outlive its raylet (orphan prevention —
            # parity: reference workers exit when the raylet socket drops)
            self.raylet_conn._on_close = lambda _c: os._exit(0)
        reply = await self.raylet_conn.call("register_worker", {
            "worker_id": self.worker_id.binary(),
            "pid": os.getpid(),
            "job_id": self.job_id.binary() if self.job_id else None,
            "task_address": self.task_address,
            "is_driver": self.mode == "driver",
            # isolated-env workers are born bound to their env (the
            # interpreter itself is the env); pool workers send None.
            # The spawn token lets the raylet adopt container workers
            # whose in-namespace pid differs from the host Popen pid.
            "env_hash": os.environ.get("RAY_TPU_TORCH_WORKER_ENV_HASH"),
            "spawn_token": os.environ.get("RAY_TPU_TORCH_WORKER_SPAWN_TOKEN"),
        })
        set_config(Config.from_json(reply["config"]))
        self.config = get_config()
        # join an in-progress cluster profiling window (workers spawned
        # mid-`ray-tpu profile` must not appear as blank gaps), else
        # honor the always-on config switch
        prof_state = reply.get("profiler")
        if prof_state and prof_state.get("enabled"):
            _prof.configure(True, hz=prof_state.get("hz"),
                            duration_s=prof_state.get("remaining_s"))
        else:
            _prof.maybe_start_from_config()
        if self.job_id is not None:
            self._bind_driver_context()
        self._flusher = self._loop.create_task(self._task_event_flush_loop())
        self._metrics_flusher = self._loop.create_task(
            self._metrics_flush_loop())
        if self.config.gcs_client_reconnect_timeout_s > 0:
            # head fault tolerance: when the GCS (and, for drivers, the
            # local raylet) dies, reconnect instead of wedging — parity:
            # the reference GcsRpcClient's reconnect-with-backoff
            self.gcs_conn._on_close = lambda _c: self._on_head_conn_lost()
            if self.mode == "driver":
                self.raylet_conn._on_close = \
                    lambda _c: self._on_raylet_conn_lost()

    def _on_raylet_conn_lost(self) -> None:
        """Driver-side: the local raylet died.  Freeze the lease pipeline
        (backlogs hold; no retry budget burns) and repair the route —
        either here (raylet-only crash, GCS still up) or via the GCS
        reconnect path when the whole head went down."""
        if self._shutdown:
            return
        logger.warning("local raylet connection lost; pausing submission")
        self._raylet_down = True

        def _spawn():
            if self._raylet_repairing:
                return
            self._raylet_repairing = True
            task = self._loop.create_task(self._raylet_repair_loop())
            task.add_done_callback(lambda t: t.exception())
        try:
            self._loop.call_soon_threadsafe(_spawn)
        except (RuntimeError, AttributeError):
            pass

    async def _raylet_repair_loop(self) -> None:
        """Reattach to an alive raylet whenever the GCS is reachable; on
        timeout, thaw the pipeline so pending work fails loudly instead
        of hanging forever (the pre-reconnect failure semantics)."""
        deadline = time.monotonic() + \
            self.config.gcs_client_reconnect_timeout_s
        try:
            while not self._shutdown and self._raylet_down and \
                    time.monotonic() < deadline:
                if self.gcs_conn is not None and not self.gcs_conn.closed:
                    try:
                        await self._reattach_raylet()
                        return
                    except Exception:  # noqa: BLE001 — head still coming up
                        pass
                await asyncio.sleep(0.5)
        finally:
            self._raylet_repairing = False
            if self._raylet_down and not self._shutdown:
                logger.error(
                    "raylet unreachable for %.0fs; failing pending tasks",
                    self.config.gcs_client_reconnect_timeout_s)
                # terminal: fail current backlogs OUTRIGHT and fail-fast
                # any later submissions (re-pumping against the closed
                # conn would just re-freeze in an endless repair cycle)
                self._raylet_gave_up = True
                self._raylet_down = False
                err = RayTpuError(
                    "local raylet unreachable (head lost and not "
                    "recovered within gcs_client_reconnect_timeout_s)")
                for state in self._lease_states.values():
                    self._fail_backlog(state, err)

    def _on_head_conn_lost(self) -> None:
        if self._shutdown or self._reconnecting:
            return
        self._reconnecting = True
        logger.warning("GCS connection lost; reconnecting")

        def _spawn():
            task = self._loop.create_task(self._reconnect_head())
            task.add_done_callback(lambda t: t.exception())
        try:
            self._loop.call_soon_threadsafe(_spawn)
        except (RuntimeError, AttributeError):
            pass

    async def _reconnect_head(self) -> None:
        deadline = time.monotonic() + \
            self.config.gcs_client_reconnect_timeout_s
        attempt = 0
        try:
            while not self._shutdown and time.monotonic() < deadline:
                try:
                    conn = await rpc.connect(self.gcs_address,
                                             handler=self.task_server)
                except OSError:
                    # jittered exponential backoff (capped): a fleet of
                    # workers losing the head together must not hammer
                    # the restarting GCS in synchronized 0.5 s waves
                    await asyncio.sleep(rpc.gcs_reconnect_delay(
                        attempt, self.config))
                    attempt += 1
                    continue
                try:
                    await self._resume_head_session(conn)
                except (rpc.ConnectionLost, rpc.RpcError, OSError) as e:
                    logger.info("head session resume failed (%s); retrying",
                                e)
                    conn.close()
                    await asyncio.sleep(rpc.gcs_reconnect_delay(
                        attempt, self.config))
                    attempt += 1
                    continue
                logger.info("reconnected to GCS at %s", self.gcs_address)
                return
            if not self._shutdown:
                logger.error("could not reconnect to the GCS within %.0fs",
                             self.config.gcs_client_reconnect_timeout_s)
        finally:
            self._reconnecting = False

    async def _resume_head_session(self, conn: rpc.Connection) -> None:
        """Re-establish GCS state on a fresh connection, then (drivers)
        re-route the lease pipeline through the restarted local raylet."""
        conn.set_push_handler(self._on_gcs_push)
        self.gcs_conn = conn
        conn._on_close = lambda _c: self._on_head_conn_lost()
        if self.mode == "driver" and self.config.log_to_driver:
            await conn.call("subscribe", {"channel": "worker_logs"})
        # re-arm actor-state subscriptions (address repair channel)
        for state in self._actor_states.values():
            if state.subscribed:
                await conn.call("subscribe", {
                    "channel": f"actor:{state.actor_id.hex()}"})
        if self.mode == "driver" and self.job_id is not None:
            await conn.call("reattach_job", {
                "job_id": self.job_id.binary(),
                "driver_address": self.task_address})
        if self._actor_id is not None:
            # actor worker: re-announce so the restarted GCS repairs its
            # directory entry and re-arms death detection on THIS conn
            await conn.call("actor_started", {
                "actor_id": self._actor_id.binary(),
                "task_address": self.task_address})
        if self.mode == "driver" and \
                (self._raylet_down or self.raylet_conn.closed):
            await self._reattach_raylet()

    async def _reattach_raylet(self) -> None:
        """Find an alive raylet (prefer our host), re-register, remap the
        object store, and thaw the lease pipeline.  Serialized: both the
        raylet repair loop and the GCS reconnect path call this, and a
        double run would register the worker twice and leave a zombie
        connection whose close spuriously re-freezes the pipeline."""
        if self._reattach_lock is None:
            self._reattach_lock = asyncio.Lock()
        async with self._reattach_lock:
            if not self._raylet_down and self.raylet_conn is not None \
                    and not self.raylet_conn.closed:
                return  # the other path already repaired the route
            await self._reattach_raylet_locked()

    async def _reattach_raylet_locked(self) -> None:
        nodes = await self.gcs_conn.call("get_nodes", {})
        alive = [n for n in nodes if n["alive"]]
        if not alive:
            raise rpc.RpcError("no alive nodes after head restart")
        host = self.task_address[0]
        preferred = [n for n in alive if n["address"][0] == host]
        node = (preferred or alive)[0]
        raylet_addr = tuple(node["address"])
        conn = await rpc.connect(raylet_addr, handler=self.task_server)
        reply = await conn.call("register_worker", {
            "worker_id": self.worker_id.binary(),
            "pid": os.getpid(),
            "job_id": self.job_id.binary() if self.job_id else None,
            "task_address": self.task_address,
            "is_driver": True,
        })
        info = await conn.call("store_info", {})
        old_raylet = self.raylet_address
        self.raylet_address = raylet_addr
        self.raylet_conn = conn
        conn._on_close = lambda _c: self._on_raylet_conn_lost()
        self.node_id = NodeID(reply["node_id"])
        if info["store_path"] != self.store_client.path:
            self.store_client = StoreClient(info["store_path"],
                                            info["store_capacity"])
        # leases granted by the dead raylet are gone; leases on surviving
        # raylets (spillback grants) keep working — drop only the dead
        # node's workers, then resume pumping frozen backlogs
        for state in self._lease_states.values():
            for wid, w in list(state.workers.items()):
                if w.raylet == old_raylet:
                    del state.workers[wid]
        # cached leases from the dead raylet are gone; return the rest
        # (their grants predate the outage — start the thaw clean)
        self._flush_lease_cache(drop_raylet=old_raylet)
        self._raylet_down = False
        self._raylet_gave_up = False  # a revived head restores service
        logger.info("reattached to raylet %s", raylet_addr)
        for state in self._lease_states.values():
            self._pump_lease_queue(state)

    def _bind_driver_context(self) -> None:
        self._driver_task_id = TaskID.for_driver(self.job_id)
        self._ctx.task_id = self._driver_task_id
        self._ctx.put_counter = _Counter()
        self._driver_put_counter = self._ctx.put_counter

    @property
    def address(self) -> OwnerAddress:
        # cached: read 2+ times per submitted task, invariant after init
        addr = self._address_cache
        if addr is None or addr[1] != self.task_address[0] \
                or addr[2] != self.task_address[1]:
            addr = (self.node_id.hex(), self.task_address[0],
                    self.task_address[1], self.worker_id.hex())
            self._address_cache = addr
        return addr

    def shutdown(self) -> None:
        if self._shutdown:
            return
        self._shutdown = True
        for _ in self._exec_threads:
            self._exec_queue.put(None)
        async def _close():
            if self.task_server:
                await self.task_server.stop()
            for conn in (self.gcs_conn, self.raylet_conn):
                if conn:
                    conn.close()
            self._pool.close_all()
        try:
            self._run(_close(), timeout=5)
        except Exception:
            pass

        def _drain_and_stop():
            for task in asyncio.all_tasks(self._loop):
                task.cancel()
            self._loop.call_soon(self._loop.stop)

        self._loop.call_soon_threadsafe(_drain_and_stop)
        self._loop_thread.join(timeout=5)
        self.store_client.close()
        # graceful exit removes the flight ring: a surviving ring for a
        # dead pid is then an unambiguous crash signal to the raylet
        _flight.close(unlink=True)
        if global_worker_or_none() is self:
            set_global_worker(None)

    # ------------------------------------------------------------------
    # context helpers
    # ------------------------------------------------------------------
    def _current_task_id(self) -> TaskID:
        if self._ctx.task_id is None:
            # worker thread outside a task (e.g. actor background thread):
            # bind to the driver-style root context lazily
            self._ctx.task_id = TaskID.for_normal_task(self.job_id
                                                       or JobID.from_int(0))
            self._ctx.put_counter = _Counter()
        return self._ctx.task_id

    def _next_put_id(self) -> ObjectID:
        if self._ctx.put_counter is None:
            self._current_task_id()
        return ObjectID.for_put(self._ctx.task_id, self._ctx.put_counter.next())

    def current_task_id(self) -> Optional[TaskID]:
        return self._ctx.task_id

    def current_actor_id(self) -> Optional[ActorID]:
        return self._actor_id

    # ------------------------------------------------------------------
    # object publication (owner side)
    # ------------------------------------------------------------------
    def _publish(self, object_id: ObjectID, data: bytes) -> None:
        self.memory_store.put(object_id, data)
        # wake sync getters inline: store.put above happens-before this
        # pop, so a waiter that registers after the pop re-checks the
        # store and finds the value
        waiters = self._sync_object_waiters.pop(object_id, None)
        if waiters:
            for ev in waiters:
                ev.set()
        self._call_on_loop(self._wake_object_waiters, object_id)

    def _wake_object_waiters(self, object_id: ObjectID) -> None:
        event = self._object_events.pop(object_id, None)
        if event is not None:
            event.set()
        # runs on the io loop for EVERY publish, strictly after any
        # dependency registration that raced it — the safe place to
        # release dependency-gated specs
        if self._dep_waiters:
            self._release_dep_waiters(object_id)

    async def _wait_local_object(self, object_id: ObjectID,
                                 deadline: Optional[float]) -> Optional[bytes]:
        while True:
            data = self.memory_store.get(object_id)
            if data is not None:
                return data
            event = self._object_events.get(object_id)
            if event is None:
                event = asyncio.Event()
                self._object_events[object_id] = event
            timeout = None if deadline is None else deadline - time.monotonic()
            if timeout is not None and timeout <= 0:
                return None
            try:
                await asyncio.wait_for(event.wait(), timeout)
            except asyncio.TimeoutError:
                return None

    # ------------------------------------------------------------------
    # put / get / wait
    # ------------------------------------------------------------------
    def put(self, value: Any, *, force_plasma: bool = False) -> ObjectRef:
        """``force_plasma`` routes the object to the shared-memory arena
        even below ``max_direct_call_object_size`` — used by the serve
        plane's paged KV cache, whose pages must live in the arena
        (spillable, migratable between replicas) regardless of size."""
        object_id = self._next_put_id()
        ser = serialize(value)
        _tm.job_submitted_bytes(
            self.job_id.hex() if self.job_id else None,
            ser.total_size())
        self.reference_counter.add_owned(object_id)
        # refs nested inside the stored value stay alive for the stored
        # object's lifetime — any later reader must be able to borrow
        self.reference_counter.set_contained(
            object_id, [r.id() for r in ser.contained_refs])
        ref = ObjectRef(object_id, self.address)
        if not force_plasma and \
                ser.total_size() <= self.config.max_direct_call_object_size:
            self._publish(object_id, ser.to_bytes())
        else:
            self._run(self._put_plasma(object_id, ser))
            self._publish(object_id, PLASMA_MARKER)
        return ref

    async def _put_plasma(self, object_id: ObjectID,
                          ser: SerializedObject) -> None:
        size = ser.total_size()
        reply = await self.raylet_conn.call(
            "object_create", {"object_id": object_id.binary(), "size": size})
        view = self.store_client.view(reply["offset"], size)
        ser.write_to(view)
        await self.raylet_conn.call("object_seal", {
            "object_id": object_id.binary(),
            "owner_address": self.address,
        })
        self.reference_counter.add_location(
            object_id, tuple(self.raylet_address))

    #: sentinel: the sync fast path cannot serve this get — use the
    #: coroutine machinery
    _SYNC_FALLBACK = object()

    def _get_one_sync(self, ref: ObjectRef, timeout: Optional[float]):
        """Lock-free single-ref get for the sync hot path: owner-local
        inline values resolve (and block) entirely on the CALLING
        thread — no run_coroutine_threadsafe, no coroutine, no io-loop
        wakeups (~90 us/call of machinery on this host).  Borrowed refs
        and plasma values return _SYNC_FALLBACK (their fetch must be
        DRIVEN by a coroutine)."""
        owner = ref.owner_address()
        if owner is not None and owner[3] != self._worker_id_hex:
            return self._SYNC_FALLBACK
        object_id = ref.id()
        data = self.memory_store.get(object_id)
        if data is None:
            if threading.current_thread() is self._loop_thread:
                return self._SYNC_FALLBACK  # never block the io loop
            ev = threading.Event()
            self._sync_object_waiters.setdefault(object_id, []).append(ev)
            # re-check AFTER registering: _publish pops waiters after
            # its store.put, so either we see the data or the publisher
            # sees (and sets) our event
            data = self.memory_store.get(object_id)
            if data is None:
                if not ev.wait(timeout):
                    waiters = self._sync_object_waiters.get(object_id)
                    if waiters is not None:
                        try:
                            waiters.remove(ev)
                        except ValueError:
                            pass
                    return _PendingMarker()
                data = self.memory_store.get(object_id)
                if data is None:  # woken but value migrated (shutdown)
                    return self._SYNC_FALLBACK
        if data == PLASMA_MARKER:
            return self._SYNC_FALLBACK
        value, _is_exc = deserialize(data)
        return value

    def get(self, refs: Sequence[ObjectRef], timeout: Optional[float] = None
            ) -> List[Any]:
        if len(refs) == 1:
            v = self._get_one_sync(refs[0], timeout)
            if v is not self._SYNC_FALLBACK:
                if isinstance(v, _PendingMarker):
                    raise GetTimeoutError(
                        f"get() timed out after {timeout}s")
                if isinstance(v, TaskError):
                    if isinstance(v.cause, BaseException):
                        raise v.cause from v
                    raise v
                return [v]
        deadline = None if timeout is None else time.monotonic() + timeout
        fut = asyncio.run_coroutine_threadsafe(
            self._get_async(list(refs), deadline), self._loop)
        values = fut.result()
        # raise the first exception encountered, like the reference
        for v in values:
            if isinstance(v, _PendingMarker):
                raise GetTimeoutError(f"get() timed out after {timeout}s")
        for v in values:
            if isinstance(v, TaskError):
                if isinstance(v.cause, BaseException):
                    raise v.cause from v
                raise v
        return values

    def get_async(self, ref: ObjectRef) -> concurrent.futures.Future:
        async def _one():
            values = await self._get_async([ref], None)
            v = values[0]
            if isinstance(v, TaskError):
                if isinstance(v.cause, BaseException):
                    raise v.cause
                raise v
            return v
        return asyncio.run_coroutine_threadsafe(_one(), self._loop)

    async def _get_async(self, refs: List[ObjectRef],
                         deadline: Optional[float]) -> List[Any]:
        # ONE deadline for the whole batch: asyncio.wait_for costs ~40 us
        # per call (Timeout context manager + timer handle), so per-ref
        # deadlines dominated large gets.  get() raises on ANY pending ref,
        # so cancelling the whole gather at the deadline is equivalent.
        if deadline is None:
            return list(await asyncio.gather(
                *[self._get_one(ref, None) for ref in refs]))
        timeout = deadline - time.monotonic()
        if timeout <= 0:
            # expired/zero timeout (non-blocking poll): the per-ref path
            # still returns objects that are ALREADY local — wait_for(0)
            # would cancel the gather before any child could check
            return list(await asyncio.gather(
                *[self._get_one(ref, deadline) for ref in refs]))
        # batch_managed: ONE wait_for for the whole batch (a per-ref
        # Timeout context measured ~40 us each); remote legs still carry
        # the cooperative deadline and are shielded from the cancellation
        # (see _shielded) so raylet leases/long-polls complete cleanly.
        gathered = asyncio.gather(
            *[self._get_one(ref, deadline, batch_managed=True)
              for ref in refs])
        try:
            return list(await asyncio.wait_for(gathered, timeout))
        except asyncio.TimeoutError:
            return [_PendingMarker() for _ in refs]

    async def _get_one(self, ref: ObjectRef, deadline: Optional[float],
                       _reconstruction_depth: int = 0,
                       batch_managed: bool = False) -> Any:
        """``batch_managed``: an enclosing batch wait_for owns the deadline
        and will CANCEL this coroutine at expiry.  Local-store waits then
        skip their own (expensive) deadline plumbing — cancellation is safe
        there — while remote legs keep the cooperative deadline AND run
        shielded, because a raylet ``object_get`` cancelled between lease
        grant and reply would leak the lease (and strand the server-side
        pull loop) with nobody left to release it."""
        object_id = ref.id()
        owner = ref.owner_address()
        is_owner = owner is None or owner[3] == self._worker_id_hex
        if is_owner:
            data = await self._wait_local_object(
                object_id, None if batch_managed else deadline)
            if data is None:
                return _PendingMarker()
        else:
            data = self.memory_store.get(object_id)  # borrower-side cache
            if data is None:
                fetch = self._fetch_from_owner(object_id, owner, deadline)
                data = await (self._shielded(fetch) if batch_managed
                              else fetch)
                if data is None:
                    return _PendingMarker()
        if data == PLASMA_MARKER:
            inner = self._get_plasma(ref, deadline, _reconstruction_depth)
            return await (self._shielded(inner) if batch_managed else inner)
        value, is_exc = deserialize(data)
        return value if not is_exc else value  # TaskError instance either way

    def _shielded(self, coro) -> Awaitable:
        """Wrap a remote-protocol coroutine so caller cancellation (batch
        get deadline) detaches from it instead of killing it mid-RPC; the
        inner task runs to its own cooperative deadline and releases any
        resources it acquired.  A result that lands after detachment is
        dropped — plasma pins release via GC of the orphaned value."""
        task = self._loop.create_task(coro)
        task.add_done_callback(
            lambda t: None if t.cancelled() else t.exception())
        return asyncio.shield(task)

    async def _fetch_from_owner(self, object_id: ObjectID,
                                owner: OwnerAddress,
                                deadline: Optional[float]) -> Optional[bytes]:
        try:
            conn = await self._pool.get((owner[1], owner[2]))
            timeout = None if deadline is None else max(
                0.0, deadline - time.monotonic())
            reply = await conn.call(
                "get_small_object",
                {"object_id": object_id.binary(), "timeout": timeout},
                timeout=None if timeout is None else timeout + 5.0)
        except (rpc.ConnectionLost, rpc.RpcError, asyncio.TimeoutError) as e:
            raise ObjectLostError(object_id.hex(),
                                  f"owner unreachable: {e}") from None
        if reply is None:
            return None
        if reply.get("plasma"):
            self.memory_store.put(object_id, PLASMA_MARKER)
            return PLASMA_MARKER
        data = reply["data"]
        self.memory_store.put(object_id, data)  # borrower cache
        return data

    async def _get_plasma(self, ref: ObjectRef, deadline: Optional[float],
                          depth: int = 0) -> Any:
        object_id = ref.id()
        owner = ref.owner_address() or self.address
        timeout = None if deadline is None else max(
            0.0, deadline - time.monotonic())
        reply = await self.raylet_conn.call("object_get", {
            "object_ids": [object_id.binary()],
            "owners": {object_id.binary(): owner},
            "timeout": timeout,
        }, timeout=None)
        lease = reply.get(object_id.binary())
        if lease is None:
            # lost object: lineage reconstruction.  The OWNER resubmits
            # the producing task; a borrower (e.g. a worker whose task
            # arg was lost with a node) asks the owner to do so — without
            # this, chained loss (input AND output gone) never recovers
            # because only the leaf's owner acts (parity:
            # ObjectRecoveryManager recovers via the object's owner).
            if depth < self.config.max_lineage_reconstruction_depth:
                recovered = await self._try_reconstruct(object_id)
                if not recovered:
                    recovered = await self._ask_owner_reconstruct(
                        object_id, ref.owner_address(), deadline)
                if recovered:
                    return await self._get_one(ref, deadline, depth + 1)
            if timeout is not None:
                return _PendingMarker()
            raise ObjectLostError(object_id.hex(),
                                  "no copies found and reconstruction failed")
        view = self.store_client.view(lease["offset"], lease["size"])
        pin = _Pin(release=lambda b=object_id.binary():
                   self._post(self._release_plasma(b)))
        value, _ = _deserialize_pinned(view, pin)
        if pin.count == 0:
            # no out-of-band buffers alias the mapping; release immediately
            await self._release_plasma(object_id.binary())
        return value

    async def _release_plasma(self, object_id_bin: bytes) -> None:
        try:
            await self.raylet_conn.call(
                "object_release", {"object_ids": [object_id_bin]})
        except (rpc.ConnectionLost, rpc.RpcError):
            pass

    async def _ask_owner_reconstruct(self, object_id: ObjectID,
                                     owner: Optional[OwnerAddress],
                                     deadline: Optional[float]) -> bool:
        """Borrower-side recovery: the owner holds the lineage, so route
        the reconstruction request to it and wait for completion."""
        if owner is None or owner[3] == self._worker_id_hex:
            return False
        try:
            conn = await self._pool.get((owner[1], owner[2]))
            timeout = None if deadline is None else max(
                1.0, deadline - time.monotonic())
            logger.info("asking owner %s to reconstruct %s",
                        owner[1:3], object_id.hex()[:16])
            reply = await conn.call(
                "reconstruct_object",
                {"object_id": object_id.binary()},
                timeout=timeout)
            logger.info("owner reconstruct %s -> %s",
                        object_id.hex()[:16], reply)
            return bool(reply)
        except (rpc.ConnectionLost, rpc.RpcError,
                asyncio.TimeoutError) as e:
            logger.info("owner reconstruct %s failed: %s",
                        object_id.hex()[:16], e)
            return False

    async def handle_reconstruct_object(self, conn, data):
        """Owner-side service endpoint for borrower-initiated recovery."""
        return await self._try_reconstruct(ObjectID(data["object_id"]))

    async def _try_reconstruct(self, object_id: ObjectID) -> bool:
        """Lineage reconstruction: resubmit the producing task
        (parity: ObjectRecoveryManager)."""
        producing = object_id.task_id()
        if object_id.is_put():
            return False  # put objects have no lineage
        ref_info = self.reference_counter.get(object_id)
        if ref_info is None or not ref_info.owned:
            return False
        if self.task_manager.is_pending(producing):
            await self._wait_task_done(producing)
            return True
        spec = self.task_manager.resubmit_for_reconstruction(producing)
        if spec is None:
            return False
        logger.info("reconstructing %s via %s", object_id.hex()[:16],
                    spec.debug_name())
        for ret in spec.return_ids():
            self.memory_store.delete(ret)
        self._submit_to_lease_queue(spec)
        await self._wait_task_done(producing)
        return True

    async def _wait_task_done(self, task_id: TaskID) -> None:
        while self.task_manager.is_pending(task_id):
            event = self._task_done_events.get(task_id)
            if event is None:
                event = asyncio.Event()
                self._task_done_events[task_id] = event
            await event.wait()

    def _signal_task_done(self, task_id: TaskID) -> None:
        event = self._task_done_events.pop(task_id, None)
        if event is not None:
            event.set()

    def wait(self, refs: Sequence[ObjectRef], num_returns: int = 1,
             timeout: Optional[float] = None
             ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
        deadline = None if timeout is None else time.monotonic() + timeout

        async def _wait():
            pending = {self._loop.create_task(
                self._probe_ready(ref, deadline)): ref for ref in refs}
            ready: List[ObjectRef] = []
            not_ready = list(refs)
            while pending and len(ready) < num_returns:
                remaining = None if deadline is None else max(
                    0.0, deadline - time.monotonic())
                done, _ = await asyncio.wait(
                    pending, timeout=remaining,
                    return_when=asyncio.FIRST_COMPLETED)
                if not done:
                    break
                for task in done:
                    ref = pending.pop(task)
                    if task.result():
                        ready.append(ref)
                        not_ready.remove(ref)
            for task in pending:
                task.cancel()
            # preserve input order for ready as the reference does
            ready_set = set(ready)
            return ([r for r in refs if r in ready_set],
                    [r for r in refs if r not in ready_set])

        return self._run(_wait())

    async def _probe_ready(self, ref: ObjectRef,
                           deadline: Optional[float]) -> bool:
        object_id = ref.id()
        owner = ref.owner_address()
        is_owner = owner is None or owner[3] == self._worker_id_hex
        if is_owner:
            data = await self._wait_local_object(object_id, deadline)
            return data is not None
        data = self.memory_store.get(object_id)
        if data is not None:
            return True
        try:
            data = await self._fetch_from_owner(object_id, owner, deadline)
        except ObjectLostError:
            return False
        return data is not None

    def free(self, refs: Sequence[ObjectRef]) -> None:
        for ref in refs:
            info = self.reference_counter.get(ref.id())
            if info is not None and info.owned:
                self.memory_store.delete(ref.id())
                self._on_object_freed(ref.id(), info)

    # ------------------------------------------------------------------
    # refcount callbacks (may fire on any thread, incl. GC)
    # ------------------------------------------------------------------
    def deferred_remove_local_ref(self, object_id: ObjectID) -> None:
        """GC-safe local-ref release for ObjectRef.__del__.

        The actual refcount mutation (and any free callback it triggers)
        runs on the io loop, never inline in the finalizer.
        """
        try:
            self._gc_release_queue.push(object_id)
        except (RuntimeError, AttributeError):
            pass  # loop torn down — nothing left to free against

    def _on_object_freed(self, object_id: ObjectID, ref_info) -> None:
        self.memory_store.delete(object_id)
        self._partial_locations.pop(object_id.binary(), None)
        if ref_info.in_plasma and not self._shutdown:
            locations = set(ref_info.locations)
            spilled_uri = getattr(ref_info, "spilled_uri", None)
            # the spilling node usually IS a seal-time location, but a
            # free must reach its spill file even if the location was
            # ever retracted — a leaked blob survives until node death
            spilled_on = getattr(ref_info, "spilled_on", None)
            if spilled_on:
                locations.add(tuple(spilled_on))
            async def _free():
                for node_addr in locations:
                    try:
                        addr = tuple(node_addr)
                        # local raylet: free over the SAME FIFO link the
                        # next object_create rides, so a dropped ref's
                        # arena block is back in this client's allocator
                        # bucket before the next put asks for one
                        # (put/free/put churn then reuses page-table-warm
                        # blocks instead of carving cold slabs)
                        if self.raylet_conn is not None \
                                and not self.raylet_conn.closed \
                                and addr == tuple(self.raylet_address):
                            conn = self.raylet_conn
                        else:
                            conn = await self._pool.get(addr)
                        await conn.call("object_free",
                                        {"object_ids": [object_id.binary()]})
                    except Exception:
                        pass
                if spilled_uri:
                    # the spilling node may be dead — the owner deletes
                    # the external blob so the URI tier doesn't leak
                    try:
                        from ray_tpu_torch.air import storage as air_storage
                        await asyncio.to_thread(air_storage.delete,
                                                spilled_uri)
                    except Exception:  # noqa: BLE001 — best-effort
                        pass
            try:
                self._post(_free())
            except Exception:
                pass
        task_id = object_id.task_id()
        if not object_id.is_put():
            self.task_manager.evict_lineage(task_id)

    def _on_borrow_added(self, object_id: ObjectID,
                         owner: Optional[tuple]) -> None:
        if owner is None or self._shutdown or owner[3] == self._worker_id_hex:
            return
        async def _notify():
            try:
                conn = await self._pool.get((owner[1], owner[2]))
                await conn.call("add_borrow", {
                    "object_id": object_id.binary(),
                    "borrower": self.address})
            except Exception:
                pass
        try:
            self._post(_notify())
        except Exception:
            pass

    def _on_borrow_removed(self, object_id: ObjectID,
                           owner: Optional[tuple]) -> None:
        if owner is None or self._shutdown or owner[3] == self._worker_id_hex:
            return
        self.memory_store.delete(object_id)
        async def _notify():
            try:
                conn = await self._pool.get((owner[1], owner[2]))
                await conn.call("remove_borrow", {
                    "object_id": object_id.binary(),
                    "borrower": self.address})
            except Exception:
                pass
        try:
            self._post(_notify())
        except Exception:
            pass

    # ------------------------------------------------------------------
    # owner-side RPC service (on the task server)
    # ------------------------------------------------------------------
    async def handle_get_small_object(self, conn, data):
        object_id = ObjectID(data["object_id"])
        timeout = data.get("timeout")
        deadline = None if timeout is None else time.monotonic() + timeout
        blob = await self._wait_local_object(object_id, deadline)
        if blob is None:
            return None
        if blob == PLASMA_MARKER:
            return {"plasma": True}
        return {"data": blob}

    async def handle_get_object_locations(self, conn, data):
        object_id = ObjectID(data["object_id"])
        info = self.reference_counter.get(object_id)
        if info is None:
            # unknown object: may be an in-flight return; report pending if
            # its producing task is still running
            if self.task_manager.is_pending(object_id.task_id()):
                return {"nodes": [], "pending": True}
            return None
        locations, spilled = self.reference_counter.get_locations(object_id)
        pending = self.task_manager.is_pending(object_id.task_id())
        partials = self._partial_locations.get(object_id.binary())
        return {"nodes": [list(a) for a in locations],
                "partial_nodes": [list(a) for a in partials]
                if partials else [],
                "spilled_on": list(spilled) if spilled else None,
                "spilled_uri":
                    self.reference_counter.get_spilled_uri(object_id),
                "pending": pending}

    async def handle_object_spilled(self, conn, data):
        """A raylet spilled one of our objects: to the external URI
        tier (record the URI — restores survive that node's death) or
        to its local disk tier (record the node — gets/pulls route
        there and stream straight from the spill file)."""
        object_id = ObjectID(data["object_id"])
        if data.get("uri"):
            self.reference_counter.set_spilled_uri(object_id, data["uri"])
        if data.get("node"):
            self.reference_counter.set_spilled(object_id,
                                               tuple(data["node"]))
        return True

    async def handle_object_location_added(self, conn, data):
        """A raylet holds (or is receiving) a copy of an owned object.

        ``partial=True``: the copy is mid-transfer — recorded separately
        so pullers can chain on it without the owner ever treating it
        as a restorable location.  ``partial=False`` promotes/records a
        sealed copy in the reference counter (later pullers stripe
        across it; the owner's free fan-out reaches it)."""
        oid_bin = data["object_id"]
        object_id = ObjectID(oid_bin)
        node = tuple(data["node"])
        if data.get("partial"):
            # guard against resurrecting an already-freed ref: partials
            # only matter while the owner still tracks the object
            if self.reference_counter.get(object_id) is not None:
                self._partial_locations.setdefault(oid_bin, set()).add(node)
            return True
        partials = self._partial_locations.get(oid_bin)
        if partials is not None:
            partials.discard(node)
            if not partials:
                del self._partial_locations[oid_bin]
        if self.reference_counter.get(object_id) is not None:
            self.reference_counter.add_location(object_id, node)
        return True

    async def handle_object_location_removed(self, conn, data):
        """A transfer failed (partial retraction) or a holder dropped
        its sealed copy."""
        oid_bin = data["object_id"]
        node = tuple(data["node"])
        partials = self._partial_locations.get(oid_bin)
        if partials is not None:
            partials.discard(node)
            if not partials:
                del self._partial_locations[oid_bin]
        if not data.get("partial"):
            self.reference_counter.remove_location(ObjectID(oid_bin), node)
        return True

    async def handle_add_borrow(self, conn, data):
        self.reference_counter.add_borrower(
            ObjectID(data["object_id"]), tuple(data["borrower"]))
        return True

    async def handle_remove_borrow(self, conn, data):
        self.reference_counter.remove_borrower(
            ObjectID(data["object_id"]), tuple(data["borrower"]))
        return True

    async def handle_stack_trace(self, conn, data):
        """All-thread stack dump of this worker (parity: the reference's
        py-spy-backed ``ray stack`` / dashboard reporter — here
        python-native via sys._current_frames, which needs no external
        profiler binary and works inside containers)."""
        import traceback

        frames = sys._current_frames()
        names = {t.ident: t.name for t in threading.enumerate()}
        executing = dict(self._executing_info)
        out = []
        for ident, frame in frames.items():
            stack = "".join(traceback.format_stack(frame))
            entry = {"thread": names.get(ident, str(ident)),
                     "stack": stack}
            info = executing.get(ident)
            if info is not None:
                # task attribution (same table the profiler samples):
                # `ray-tpu stack` names the task each thread is running
                entry["task"] = info[0]
                entry["task_id"] = info[1]
            out.append(entry)
        return {"pid": os.getpid(),
                "actor_id": self._actor_id.hex() if self._actor_id
                else None,
                "threads": out}

    async def handle_profiler_control(self, conn, data):
        """Runtime profiler switch (GCS -> raylet -> worker fan-out;
        see ``ray-tpu profile``)."""
        _prof.configure(bool(data["enabled"]), hz=data.get("hz"),
                        duration_s=data.get("duration_s"))
        return True

    async def handle_ping(self, conn, data):
        return {"worker_id": self.worker_id.hex(), "mode": self.mode,
                "actor_id": self._actor_id.hex() if self._actor_id else None}

    # ------------------------------------------------------------------
    # task submission (normal tasks)
    # ------------------------------------------------------------------
    def register_function(self, blob: bytes) -> str:
        function_id = hashlib.sha256(blob).hexdigest()[:32]
        # idempotent per THIS cluster connection — the registered set
        # lives on the CoreWorker so a fresh cluster in the same process
        # re-exports module-level remote functions
        if function_id not in self._registered_functions:
            self._run(self.gcs_conn.call("register_function", {
                "function_id": function_id, "blob": blob}))
            self._registered_functions.add(function_id)
        return function_id

    def submit_task(self, function_id: str, descriptor: str, args: tuple,
                    kwargs: dict, *, num_returns: int = 1,
                    resources: Optional[Dict[str, float]] = None,
                    max_retries: Optional[int] = None,
                    retry_exceptions: bool = False,
                    scheduling_strategy: Optional[SchedulingStrategy] = None,
                    runtime_env: Optional[Dict[str, Any]] = None,
                    dynamic_returns: bool = False,
                    stream_returns: bool = False,
                    max_calls: int = 0,
                    ) -> List[ObjectRef]:
        task_id = TaskID.for_normal_task(self.job_id)
        task_args, holds = self._build_args(args, kwargs)
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            task_type=TaskType.NORMAL_TASK,
            function_id=function_id,
            function_descriptor=descriptor,
            args=task_args,
            num_returns=num_returns,
            resources=dict(resources or {"CPU": 1.0}),
            max_retries=(self.config.default_max_task_retries
                         if max_retries is None else max_retries),
            retry_exceptions=retry_exceptions,
            scheduling_strategy=scheduling_strategy or SchedulingStrategy(),
            owner_address=self.address,
            depth=self._ctx.attempt_number,
            runtime_env=runtime_env,
            runtime_env_hash=_renv_hash(runtime_env),
            trace_context=_trace_carrier(),
            dynamic_returns=dynamic_returns,
            stream_returns=stream_returns,
            max_calls=max_calls,
        )
        self._trace_begin(spec)
        if _flight.enabled():
            # owner-side breadcrumb: a dead driver's ring shows what it
            # was submitting, and the paired bench (flight_overhead_pct)
            # toggles THIS process's recorder — per-task cost is real
            _flight.record("task_submit",
                           f"{descriptor} task={task_id.hex()[:16]}")
        if stream_returns:
            # register BEFORE submission: the first dynamic_items push
            # can arrive while .remote() is still unwinding
            self._streaming_states[task_id.binary()] = _StreamState()
        rets = self.task_manager.register(spec)
        del holds  # submitted-refs now pin the promoted args
        refs = [ObjectRef(oid, self.address) for oid in rets]
        self._track_child(task_id)
        self._submit_to_lease_queue(spec)
        return refs

    def _trace_begin(self, spec: TaskSpec) -> None:
        """Native tracing tag, applied ONCE at submission: join the
        ambient trace when one is active (a traced serve request or
        parent task submitting children); otherwise a fresh trace is
        born — but only at DRIVER-side ``remote()`` (worker-mode
        submissions outside any trace are runtime plumbing like the
        serve controller's metrics polls, and tracing each would flood
        the ring with noise).  The span ends at the task's terminal
        completion/failure — its status is the tail-sampling signal.
        Disabled tracing costs one cached-bool check."""
        if not _trace.enabled():
            return
        name = f"task:{spec.function_descriptor}"
        ambient = _trace.current()
        if ambient is not None:
            span = _trace.start_span(name, parent=ambient)
        elif self.mode == "driver":
            span = _trace.start_trace(name)
        else:
            return
        if span is None:
            return
        # merge with the optional OTel W3C carrier already on the spec
        if spec.trace_context is None:
            spec.trace_context = span.ctx()
        else:
            spec.trace_context.update(span.ctx())
        self._trace_spans[spec.task_id.binary()] = span

    def _trace_end(self, spec: TaskSpec, status: str, **tags) -> None:
        span = self._trace_spans.pop(spec.task_id.binary(), None)
        if span is not None:
            span.end(status=status, **tags)

    def _track_child(self, task_id: TaskID) -> None:
        """Record parent->child lineage for recursive cancellation: a
        task submitted while this worker executes a parent task is the
        parent's child (this worker owns it)."""
        if self.mode != "worker":
            return
        parent = self._ctx.task_id
        if parent is None:
            return
        self._children.setdefault(parent.binary(), []).append(task_id)
        if len(self._children) > 256:
            # amortized prune: a full rescan of every parent's child
            # list on EVERY submission is quadratic in tree width (and
            # prunes nothing while a fan-out is live); instead sweep a
            # bounded slice per call, rotating through the table
            keys = list(self._children)
            start = self._children_prune_pos % len(keys)
            for key in keys[start:start + 32]:
                kids = self._children.get(key, [])
                if not any(self.task_manager.is_pending(k) for k in kids):
                    self._children.pop(key, None)
            self._children_prune_pos = start + 32

    def _build_args(self, args: tuple, kwargs: dict
                    ) -> Tuple[List[TaskArg], List[ObjectRef]]:
        """Serialize arguments; small values inline, ObjectRefs by
        reference, large values promoted to the object store.

        Returns (task_args, holds): ``holds`` keeps refs created here alive
        until the task is registered (which adds submitted-refs) —
        otherwise a promoted arg would be freed the instant this function
        returns.
        """
        if not kwargs and not args:
            # the overwhelmingly common no-arg call: one shared TaskArg
            # carrying pre-serialized {} (read-only everywhere)
            return [_empty_kwargs_arg()], []
        out: List[TaskArg] = []
        holds: List[ObjectRef] = []
        for value in list(args) + [kwargs or {}]:
            if type(value) is dict and not value:
                out.append(_empty_kwargs_arg())
                continue
            if isinstance(value, ObjectRef):
                out.append(TaskArg(object_id=value.id(),
                                   owner_address=value.owner_address()))
                continue
            ser = serialize(value)
            if ser.total_size() > self.config.max_direct_call_object_size:
                ref = self.put(value)
                holds.append(ref)
                out.append(TaskArg(object_id=ref.id(),
                                   owner_address=ref.owner_address()))
            else:
                # refs nested inside the value must survive until the
                # executing worker borrows them — record them so the
                # TaskManager pins submitted-refs for the flight; they
                # also join `holds` so paths that never register a task
                # (actor creation keeps holds for the actor's lifetime)
                # still pin them
                out.append(TaskArg(
                    value_bytes=ser.to_bytes(),
                    contained_ids=[r.id() for r in ser.contained_refs]))
                holds.extend(ser.contained_refs)
        return out, holds

    def _submit_to_lease_queue(self, spec: TaskSpec) -> None:
        self._record_task_event(spec, "PENDING")
        try:
            self._submit_queue.push(spec)
        except (RuntimeError, AttributeError):
            # loop torn down: surface it — swallowing would hand the
            # caller ObjectRefs that can never resolve
            raise RayTpuError(
                "cannot submit task: the runtime is shut down") from None

    def _route_submit(self, spec: TaskSpec) -> None:
        if spec.task_type == TaskType.ACTOR_TASK:
            # actor calls are NOT gated: per-caller ordering is by
            # sequence number assigned at enqueue, and the actor's exec
            # thread resolving args is reference-equivalent blocking
            # (it occupies no CPU lease)
            self._enqueue_actor_task(spec)
            return
        deps = self._unready_deps(spec)
        if deps is not None:
            # Dependency gating (parity: the reference raylet's task
            # dependency manager — a task is not DISPATCHED until its
            # args exist).  Without this, dependents can occupy every
            # CPU lease while the producers they block on starve in the
            # backlog behind them: a resource deadlock (groupby shuffle
            # hit exactly this interleaving).  The spec parks here and
            # re-routes when the last missing arg publishes.
            entry = (spec, deps)
            self._waiting_for_deps[spec.task_id.binary()] = entry
            for oid in deps:
                self._dep_waiters.setdefault(oid, []).append(entry)
            return
        self._route_ready(spec)

    def _route_ready(self, spec: TaskSpec) -> None:
        state = self._backlog_enqueue(spec)
        self._touched_states[state.key] = state

    def _unready_deps(self, spec: TaskSpec) -> Optional[set]:
        """Object ids among this spec's ref args that WE own and whose
        values do not exist anywhere yet (producing task still pending,
        nothing published/located), or None when every arg is ready —
        the overwhelmingly common case, kept allocation-free.  Borrowed
        args are not gated: their readiness is the remote owner's
        knowledge, and the executing worker's fetch long-polls the
        owner (reference behavior)."""
        out: Optional[set] = None
        for arg in spec.args:
            oid = arg.object_id
            if oid is None:
                continue
            owner = arg.owner_address
            if owner is not None and owner[3] != self._worker_id_hex:
                continue  # borrowed: not our call to gate
            if self.memory_store.get(oid) is not None:
                continue  # value (or plasma marker / error) published
            ref_info = self.reference_counter.get(oid)
            if ref_info is not None and (ref_info.in_plasma
                                         or ref_info.locations):
                continue
            if out is None:
                out = set()
            out.add(oid)
        return out

    def _release_dep_waiters(self, object_id: ObjectID) -> None:
        """An owned object became available: re-route any parked specs
        whose last missing dependency this was.  Runs on the io loop."""
        entries = self._dep_waiters.pop(object_id, None)
        if not entries:
            return
        for spec, deps in entries:
            deps.discard(object_id)
            if deps:
                continue
            if self._waiting_for_deps.pop(spec.task_id.binary(),
                                          None) is None:
                continue  # already released (e.g. cancelled)
            self._route_ready(spec)
        self._flush_submits()

    def _flush_submits(self) -> None:
        touched, self._touched_states = self._touched_states, {}
        for state in touched.values():
            self._pump_lease_queue(state)

    def _backlog_enqueue(self, spec: TaskSpec) -> "_LeaseState":
        key = spec.scheduling_key()
        state = self._lease_states.get(key)
        if state is None:
            state = _LeaseState(key)
            self._lease_states[key] = state
        state.backlog.append(spec)
        return state

    def _enqueue_for_lease(self, spec: TaskSpec) -> None:
        self._pump_lease_queue(self._backlog_enqueue(spec))

    def _pump_lease_queue(self, state: "_LeaseState") -> None:
        if self._raylet_down:
            # head outage: hold backlogs (no lease requests, no retry
            # budget burned); _reattach_raylet re-pumps every state
            return
        # Phase 1 — breadth first: one task per idle worker, so independent
        # tasks spread across workers/nodes instead of serializing into one
        # worker's pipeline.
        for worker in list(state.workers.values()):
            if state.backlog and worker.inflight == 0 \
                    and self._worker_accepts(worker, state.backlog[0]):
                self._dispatch_to_worker(state, worker)
        # Phase 1.5 — claim compatible leases parked in the owner-side
        # cache (same resource shape + runtime-env hash, possibly a
        # DIFFERENT scheduling key) before paying raylet round trips:
        # alternating functions then multiplex one held lease instead of
        # churning grant/return cycles through the raylet.
        while state.backlog:
            worker = self._claim_cached_lease(state)
            if worker is None:
                break
            self._dispatch_to_worker(state, worker)
        # Phase 2 — grow the fleet while there is queued work (the raylet
        # answers with local grants or spillback to other nodes).  Several
        # lease requests may be outstanding so fan-out ramps quickly.
        want = min(len(state.backlog), 8)
        while state.requesting < want:
            state.requesting += 1
            self._lease_cache_misses += 1
            _tm.sched_lease_cache(False)
            task = self._loop.create_task(self._request_lease(state))
            task.add_done_callback(lambda t: t.exception())
        # Phase 3 — pipeline further tasks onto busy workers up to the
        # in-flight cap (throughput for sub-millisecond tasks), but always
        # leave at least one queued task per pending lease grant so new
        # workers (possibly on other nodes) get work on arrival.  Tasks
        # ship as batched RPC frames (per-task frames measured ~420 us of
        # event-loop work each on nop storms) — but in CHUNKS, not one
        # cap-sized batch: the worker replies per chunk, so completions
        # stream back and refill while it executes the next chunk instead
        # of ping-ponging one giant batch per round trip.
        reserve = max(1, state.requesting)
        chunk_size = self.config.task_push_chunk_size
        for worker in list(state.workers.values()):
            room = self.config.max_tasks_in_flight_per_worker \
                - worker.inflight
            while len(state.backlog) > reserve and room > 0:
                batch: List[TaskSpec] = []
                while (len(state.backlog) > reserve and room > 0
                       and len(batch) < chunk_size
                       and self._worker_accepts(worker,
                                                state.backlog[0])):
                    spec = state.backlog.popleft()
                    self._charge_dispatch(worker, spec)
                    batch.append(spec)
                    room -= 1
                if not batch:
                    break
                worker.inflight += len(batch)
                if len(batch) == 1:
                    task = self._loop.create_task(
                        self._push_task(state, worker, batch[0]))
                else:
                    task = self._loop.create_task(
                        self._push_task_batch(state, worker, batch))
                task.add_done_callback(lambda t: t.exception())
        # Phase 4 — arm a return timer on every lease left idle, so leased
        # resources flow back to the raylet for other scheduling keys
        # (leaked leases deadlock the node once CPUs are exhausted).
        # Contended leases (other demand queued at the raylet when they
        # were granted) skip the grace and return the instant they idle —
        # the grace serialized every cross-client handoff behind a 250 ms
        # timer, collapsing multi-client throughput 25x.
        if not state.backlog:
            for worker in list(state.workers.values()):
                if worker.inflight != 0:
                    continue
                if worker.contended:
                    self._return_lease_now(state, worker)
                elif self._park_lease(state, worker):
                    pass  # parked in the shared cache (expiry armed there)
                elif worker.return_handle is None:
                    worker.return_handle = self._loop.call_later(
                        self.config.idle_worker_lease_timeout_s,
                        lambda w=worker, s=state: self._loop.create_task(
                            self._return_lease(s, w)))
            # outstanding lease requests serve no one now: cancel them so
            # the raylet doesn't churn workers through stale grants while
            # other clients' demand waits.  Popped here so repeated pumps
            # with an empty backlog don't re-fire the same cancels (the
            # request chain's ``finally`` tolerates the early pop).
            while state.inflight_requests:
                token, address = state.inflight_requests.popitem()
                task = self._loop.create_task(
                    self._cancel_lease_request(token, address))
                task.add_done_callback(lambda t: t.exception())

    async def _cancel_lease_request(self, token: str,
                                    address: rpc.Address) -> None:
        async def _get():
            return self.raylet_conn if address == self.raylet_address \
                else await self._pool.get(address)
        try:
            # idempotent (keyed on token): retried with backoff so a
            # transient raylet blip doesn't strand a parked request
            await rpc.call_with_retry(
                _get, "cancel_lease", {"token": token},
                invalidate=lambda failed: self._pool.invalidate_conn(
                    address, failed))
        except (rpc.ConnectionLost, rpc.RpcError, OSError,
                asyncio.TimeoutError):
            pass  # best-effort; the request chain handles its own errors

    def _worker_accepts(self, worker: "_LeasedWorker",
                        spec: TaskSpec) -> bool:
        """max_calls dispatch cap: never pipeline more executions of a
        function onto one worker than it will perform before recycling
        (the GPU default of max_calls=1 means exactly one task per
        worker, even under bursts)."""
        mc = getattr(spec, "max_calls", 0)
        if not mc or spec.actor_id is not None:
            return True
        return worker.fn_calls.get(spec.function_id, 0) < mc

    def _charge_dispatch(self, worker: "_LeasedWorker",
                         spec: TaskSpec) -> None:
        if getattr(spec, "max_calls", 0) and spec.actor_id is None:
            worker.fn_calls[spec.function_id] = \
                worker.fn_calls.get(spec.function_id, 0) + 1

    def _dispatch_to_worker(self, state: "_LeaseState",
                            worker: "_LeasedWorker") -> None:
        spec = state.backlog.popleft()
        self._charge_dispatch(worker, spec)
        worker.inflight += 1
        task = self._loop.create_task(self._push_task(state, worker, spec))
        task.add_done_callback(lambda t: t.exception())

    async def _request_lease(self, state: "_LeaseState") -> None:
        """One lease acquisition (follows spillback redirects); holds one
        ``state.requesting`` slot for its whole lifetime.

        The FIRST hop is locality-routed (parity: the reference's
        LocalityAwareLeasePolicy): when the head task's plasma args
        live on another node — or it carries an explicit soft
        NODE_AFFINITY target — the lease request goes straight to that
        node's raylet, so map tasks land where their input block lives
        instead of pulling it across the wire.  An unreachable target
        falls back to the plain local-raylet route before any task
        retry budget is touched."""
        token = f"{self.worker_id.hex()[:12]}:{next(self._lease_tokens)}"
        try:
            start = self.raylet_address
            hint = await self._locality_lease_target(state)
            if hint is not None:
                try:
                    # bounded reachability precheck: a dead hinted node
                    # must cost ~2 s once, not a full connect timeout
                    # on the lease path
                    await asyncio.wait_for(self._pool.get(hint),
                                           timeout=2.0)
                except (rpc.ConnectionLost, rpc.RpcError, OSError,
                        asyncio.TimeoutError):
                    self._pool.invalidate(hint)
                    hint = None
            if hint is not None:
                start = hint
                _tm.sched_locality_lease()
            await self._request_lease_chain(state, start, token)
        finally:
            state.requesting -= 1
            state.inflight_requests.pop(token, None)
            self._pump_lease_queue(state)

    async def _locality_lease_target(self, state: "_LeaseState"
                                     ) -> Optional[rpc.Address]:
        """Remote raylet the head-of-backlog task should lease from,
        or None for the default local route.  Two sources, both soft:
        an explicit NODE_AFFINITY strategy naming another node (the
        streaming data plane pins shard maps this way), else — gated by
        ``task_locality_enabled`` — the owner's object directory: the
        first known location of the task's plasma args (skipped when
        any arg is already local, or for GPU tasks, whose device
        placement beats data locality)."""
        spec = state.backlog[0] if state.backlog else None
        if spec is None:
            return None
        strat = spec.scheduling_strategy
        if strat.placement_group_id is not None:
            return None
        if strat.kind == "NODE_AFFINITY":
            if not strat.node_id_hex \
                    or strat.node_id_hex == self.node_id.hex():
                return None
            return await self._raylet_addr_for_node(strat.node_id_hex)
        if strat.kind != "DEFAULT" \
                or not getattr(self.config, "task_locality_enabled", True):
            return None
        if spec.resources.get("GPU"):
            return None
        locs = self._arg_locality(spec)
        if not locs:
            return None
        local = tuple(self.raylet_address)
        best = None
        for addr in locs:
            t = tuple(addr)
            if t == local:
                return None  # an arg already lives here: stay local
            if best is None:
                best = t
        return best

    async def _raylet_addr_for_node(self, node_hex: str
                                    ) -> Optional[rpc.Address]:
        """node id (hex) -> raylet address, from a cached GCS node-table
        snapshot (refreshed at most every 5 s; misses on a fresh node
        just take the default route until the next refresh)."""
        cache = self._node_addr_cache
        now = time.monotonic()
        if cache is None or now - self._node_addr_cache_ts > 5.0:
            try:
                nodes = await self.gcs_conn.call("get_nodes", {},
                                                 timeout=2.0)
            except Exception:  # noqa: BLE001 — locality is best-effort:
                # keep serving the stale snapshot (the target raylet
                # precheck guards against dead entries) and back off
                # the refresh so a head outage costs ONE bounded probe
                # per window, not one per lease request
                self._node_addr_cache_ts = now
                if cache is None:
                    return None
            else:
                cache = {}
                for n in nodes:
                    if n.get("alive") and n.get("address"):
                        cache[NodeID(n["node_id"]).hex()] = \
                            tuple(n["address"])
                self._node_addr_cache = cache
                self._node_addr_cache_ts = now
        addr = cache.get(node_hex)
        if addr is None or addr == tuple(self.raylet_address):
            return None
        return addr

    async def _request_lease_chain(self, state: "_LeaseState",
                                   raylet_address: rpc.Address,
                                   token: str) -> None:
        spec = state.backlog[0] if state.backlog else None
        if spec is None:
            return
        state.inflight_requests[token] = raylet_address
        try:
            conn = self.raylet_conn if raylet_address == self.raylet_address \
                else await self._pool.get(raylet_address)
            strat = spec.scheduling_strategy
            reply = await conn.call("request_worker_lease", {
                "resources": spec.resources,
                "job_id": self.job_id.binary() if self.job_id else None,
                # SOFT node affinity grants like DEFAULT: the owner
                # already routed this request to the preferred node,
                # and a saturated/infeasible target must keep spillback
                # (a hard NODE_AFFINITY pins and may queue forever)
                "strategy": "DEFAULT"
                if strat.kind == "NODE_AFFINITY" and strat.soft
                else strat.kind,
                "placement_group_id":
                    strat.placement_group_id.binary()
                    if strat.placement_group_id else None,
                "bundle_index": strat.bundle_index,
                "backlog": len(state.backlog),
                "env_hash": spec.runtime_env_hash,
                "env_spawn": _renv_spawn(spec.runtime_env),
                "retriable": spec.max_retries > 0,
                "token": token,
                # head-of-queue task's trace context: the raylet's
                # queue-wait-until-grant span joins that trace's tree
                "trace": _trace.ctx_of(spec.trace_context),
            }, timeout=None)
        except (rpc.ConnectionLost, rpc.RpcError) as e:
            if raylet_address == self.raylet_address and \
                    self.config.gcs_client_reconnect_timeout_s > 0:
                if self._raylet_gave_up:
                    # repair already timed out: fail fast with the real
                    # cause (retrying against the closed conn would burn
                    # the whole budget and report a bogus worker crash)
                    self._fail_backlog(state, RayTpuError(
                        "local raylet unreachable (head lost and not "
                        "recovered within gcs_client_reconnect_timeout_s)"))
                    return
                # the LOCAL raylet died (head loss): freeze — the backlog
                # holds as-is, no retry budget burns, and the repair loop
                # (or the GCS reconnect) reattaches.  Burning retries here
                # exhausted every task's budget within ms of a head kill.
                self._on_raylet_conn_lost()
                return
            if raylet_address != self.raylet_address:
                self._pool.invalidate(raylet_address)
            # a REMOTE raylet died mid-lease (its node was killed): a
            # crash-class fault, so queued tasks retry against a fresh
            # lease (their retry budgets apply) instead of failing
            self._retry_backlog(state, WorkerCrashedError(
                f"lease request failed: {e}"))
            return
        if reply.get("spillback"):
            if token not in state.inflight_requests:
                # canceled while this hop was in flight (backlog
                # drained): following the redirect would re-register the
                # token and park a stale request at the spillback raylet
                # that the already-fired cancel can never reach
                return
            await self._request_lease_chain(state, tuple(reply["spillback"]),
                                            token)
            return
        if reply.get("canceled"):
            return  # our own cancel_lease (backlog drained first)
        if reply.get("error"):
            self._fail_backlog(state, RayTpuError(reply["error"]))
            return
        if reply.get("granted"):
            worker = _LeasedWorker(
                worker_id=WorkerID(reply["worker_id"]),
                address=tuple(reply["worker_address"]),
                raylet=raylet_address,
                contended=bool(reply.get("contended")),
                token=token,
            )
            state.workers[worker.worker_id] = worker

    def _fail_backlog(self, state: "_LeaseState", error: Exception) -> None:
        while state.backlog:
            spec = state.backlog.popleft()
            self._fail_task(spec, error)

    def _retry_backlog(self, state: "_LeaseState",
                       error: Exception) -> None:
        while state.backlog:
            spec = state.backlog.popleft()
            self._retry_or_fail(spec, error)

    async def _push_task(self, state: "_LeaseState", worker: "_LeasedWorker",
                         spec: TaskSpec) -> None:
        if worker.return_handle is not None:
            worker.return_handle.cancel()
            worker.return_handle = None
        tid_bin = spec.task_id.binary()
        if tid_bin in self._cancel_requested:
            # cancelled between backlog pop and dispatch: never send
            worker.inflight -= 1
            self._fail_cancelled(spec)
            self._pump_lease_queue(state)
            return
        self._task_locations[tid_bin] = worker.address
        try:
            if _fp.active():
                await _fp.afailpoint("worker.push_task.pre")
            conn = await self._pool.get(worker.address)
            if spec.stream_returns:
                # dynamic_items pushes ride this conn while it executes
                conn.set_push_handler(self._on_worker_push)
            self._record_task_event(spec, "RUNNING")
            reply = await conn.call(
                "push_task", {"spec_blob": _spec_dumps(spec)},
                timeout=None)
        except (rpc.ConnectionLost, rpc.RpcError, asyncio.TimeoutError,
                OSError, _fp.FailpointError) as e:
            worker.inflight -= 1
            state.workers.pop(worker.worker_id, None)
            self._pool.invalidate(worker.address)
            self._retry_or_fail(spec, WorkerCrashedError(
                f"worker died while running {spec.debug_name()}: {e}"))
            self._pump_lease_queue(state)
            return
        worker.inflight -= 1
        if reply.get("worker_exit"):
            self._drop_exiting_worker(state, worker)
        if reply.get("rejected"):
            # the worker refused the push (exiting): the task never ran,
            # so this is a re-dispatch, not a retry
            self._loop.call_soon_threadsafe(self._enqueue_for_lease, spec)
            self._pump_lease_queue(state)
            return
        self._handle_task_reply(spec, reply)
        self._pump_lease_queue(state)

    def _drop_exiting_worker(self, state: "_LeaseState", worker) -> None:
        """The worker announced max_calls recycling in its reply: stop
        targeting it (the process exits right after the reply flushes;
        the raylet reclaims its lease resources on death)."""
        state.workers.pop(worker.worker_id, None)
        # deliberately NOT invalidating the pooled connection here:
        # pipelined calls may still be awaiting replies on it (the
        # worker drains its queue before exiting); the close lands
        # naturally when the process exits

    async def _push_task_batch(self, state: "_LeaseState",
                               worker: "_LeasedWorker",
                               specs: List[TaskSpec]) -> None:
        """Ship several specs to one leased worker in one RPC frame.

        Results STREAM back as task_result pushes while the batch runs
        (processed by _on_worker_push — required so intra-batch and
        cross-worker dependencies resolve without waiting for the whole
        batch); the final reply settles whatever pushes didn't cover."""
        if worker.return_handle is not None:
            worker.return_handle.cancel()
            worker.return_handle = None
        cancelled = [s for s in specs
                     if s.task_id.binary() in self._cancel_requested]
        if cancelled:
            for spec in cancelled:
                worker.inflight -= 1
                self._fail_cancelled(spec)
            specs = [s for s in specs if s not in cancelled]
            if not specs:
                self._pump_lease_queue(state)
                return
        # key by (task_id, attempt): a retried task re-registers under
        # its new attempt, so a stale batch's final reply cannot steal
        # (and double-settle) the retry's entry
        keys = [(spec.task_id.binary(), spec.attempt_number)
                for spec in specs]
        for spec, key in zip(specs, keys):
            self._streamed[key] = (spec, state, worker)
            self._task_locations[key[0]] = worker.address
        try:
            if _fp.active():
                await _fp.afailpoint("worker.push_tasks.pre")
            conn = await self._pool.get(worker.address)
            conn.set_push_handler(self._on_worker_push)
            for spec in specs:
                self._record_task_event(spec, "RUNNING")
            reply = await conn.call(
                "push_tasks", {"specs_blob": _spec_dumps(specs)},
                timeout=None)
        except (rpc.ConnectionLost, rpc.RpcError, asyncio.TimeoutError,
                OSError, _fp.FailpointError) as e:
            state.workers.pop(worker.worker_id, None)
            self._pool.invalidate(worker.address)
            for spec, key in zip(specs, keys):
                # tasks whose results already streamed in are complete;
                # only the rest died with the worker
                if self._streamed.pop(key, None) is None:
                    continue
                worker.inflight -= 1
                self._retry_or_fail(spec, WorkerCrashedError(
                    f"worker died while running {spec.debug_name()}: {e}"))
            self._pump_lease_queue(state)
            return
        if isinstance(reply, dict) and reply.get("rejected"):
            # the worker refused the whole batch (exiting): nothing ran
            self._drop_exiting_worker(state, worker)
            for spec, key in zip(specs, keys):
                if self._streamed.pop(key, None) is None:
                    continue
                worker.inflight -= 1
                self._loop.call_soon_threadsafe(self._enqueue_for_lease,
                                                spec)
            self._pump_lease_queue(state)
            return
        # results stream on the same FIFO connection BEFORE the final
        # ack, so leftovers here mean a lost push — retry them
        for spec, key in zip(specs, keys):
            if self._streamed.pop(key, None) is None:
                continue
            worker.inflight -= 1
            self._retry_or_fail(spec, WorkerCrashedError(
                f"streamed result missing for {spec.debug_name()}"))
        self._pump_lease_queue(state)

    def _on_worker_push(self, channel: str, data: Any) -> None:
        if channel == "dynamic_items":
            # streaming returns: own + publish each item as announced,
            # then wake the generator's consumer
            for tid_bin, index, dyn_id_bin, entry in data:
                state = self._streaming_states.get(tid_bin)
                oid = ObjectID(dyn_id_bin)
                self.reference_counter.add_owned(
                    oid, producing_task=TaskID(tid_bin))
                object_id_bin, kind, payload = entry
                if kind == "inline":
                    self._publish(oid, payload)
                else:  # ("plasma", node raylet address)
                    self.reference_counter.add_location(oid, tuple(payload))
                    self._publish(oid, PLASMA_MARKER)
                if state is not None:
                    with state.cond:
                        while len(state.dyn_ids) <= index:
                            state.dyn_ids.append(None)
                        state.dyn_ids[index] = dyn_id_bin
                        state.cond.notify_all()
            return
        if channel == "actor_task_results":
            for task_id_bin, attempt, reply in data:
                entry = self._actor_streamed.pop((task_id_bin, attempt),
                                                 None)
                if entry is None:
                    continue  # a stale attempt's late push
                spec, state = entry
                state.pending.pop(spec.sequence_number, None)
                if reply.get("actor_dead"):
                    self._fail_task(spec, ActorDiedError(
                        spec.actor_id.hex()[:12], reply.get("reason", "")))
                else:
                    self._handle_task_reply(spec, reply)
            return
        if channel != "task_results":
            return
        items = data
        states = {}
        for task_id_bin, attempt, reply in items:
            entry = self._streamed.pop((task_id_bin, attempt), None)
            if entry is None:
                continue  # a stale attempt's late push
            spec, state, worker = entry
            worker.inflight -= 1
            if reply.get("worker_exit"):
                self._drop_exiting_worker(state, worker)
            self._handle_task_reply(spec, reply)
            states[id(state)] = state
        for state in states.values():
            self._pump_lease_queue(state)

    # -- owner-side lease cache (park/claim/expire) --------------------
    # A held lease is keyed by (granting raylet, resource shape,
    # runtime-env hash): any scheduling key with a compatible shape
    # multiplexes onto it instead of round-tripping the raylet per
    # task burst (parity: reference direct_task_transport lease reuse,
    # widened across function ids).  Only plain DEFAULT-strategy,
    # non-gang keys participate — an explicit placement intent must
    # keep its raylet round trip.

    @staticmethod
    def _cacheable_key(key: Tuple) -> bool:
        # scheduling_key shape: (function_id, resources, strategy kind,
        # strategy node, pg_id, bundle_index, env_hash)
        return key[2] == "DEFAULT" and key[4] is None

    def _park_lease(self, state: "_LeaseState",
                    worker: "_LeasedWorker") -> bool:
        if not getattr(self.config, "lease_cache_enabled", True):
            return False
        key = state.key
        if not self._cacheable_key(key):
            return False
        if self._lease_cache_n >= int(getattr(self.config,
                                              "lease_cache_size", 32)):
            return False
        if state.workers.pop(worker.worker_id, None) is None:
            return False
        if worker.return_handle is not None:
            worker.return_handle.cancel()
        ckey = (worker.raylet, key[1], key[6])
        self._lease_cache.setdefault(ckey, []).append(worker)
        self._lease_cache_n += 1
        # the idle grace still bounds how long the lease is held: an
        # unclaimed parked worker flows back to the raylet on expiry
        worker.return_handle = self._loop.call_later(
            self.config.idle_worker_lease_timeout_s,
            lambda w=worker, k=ckey: self._expire_cached_lease(k, w))
        return True

    def _expire_cached_lease(self, ckey: Tuple,
                             worker: "_LeasedWorker") -> None:
        bucket = self._lease_cache.get(ckey)
        if not bucket or worker not in bucket:
            return  # claimed (or flushed) before the timer fired
        bucket.remove(worker)
        if not bucket:
            del self._lease_cache[ckey]
        self._lease_cache_n -= 1
        worker.return_handle = None
        task = self._loop.create_task(self._send_return_worker(worker))
        task.add_done_callback(lambda t: t.exception())

    def _claim_cached_lease(self, state: "_LeaseState"
                            ) -> Optional["_LeasedWorker"]:
        if self._lease_cache_n == 0 or not state.backlog:
            return None
        key = state.key
        if not self._cacheable_key(key):
            return None
        shape, env_hash = key[1], key[6]
        spec = state.backlog[0]
        for ckey in list(self._lease_cache):
            if ckey[1] != shape or ckey[2] != env_hash:
                continue
            bucket = self._lease_cache[ckey]
            for i, worker in enumerate(bucket):
                if not self._worker_accepts(worker, spec):
                    continue  # max_calls budget spent for this function
                bucket.pop(i)
                if not bucket:
                    del self._lease_cache[ckey]
                self._lease_cache_n -= 1
                if worker.return_handle is not None:
                    worker.return_handle.cancel()
                    worker.return_handle = None
                state.workers[worker.worker_id] = worker
                self._lease_cache_hits += 1
                _tm.sched_lease_cache(True)
                return worker
        return None

    def _flush_lease_cache(self, drop_raylet=None) -> None:
        """Empty the cache: return every parked lease to its raylet
        (``drop_raylet`` set = that raylet died; just forget its
        leases, there is nothing to return them to)."""
        for ckey in list(self._lease_cache):
            bucket = self._lease_cache.pop(ckey)
            for worker in bucket:
                self._lease_cache_n -= 1
                if worker.return_handle is not None:
                    worker.return_handle.cancel()
                    worker.return_handle = None
                if drop_raylet is not None and \
                        worker.raylet == drop_raylet:
                    continue
                task = self._loop.create_task(
                    self._send_return_worker(worker))
                task.add_done_callback(lambda t: t.exception())

    async def _return_lease(self, state: "_LeaseState",
                            worker: "_LeasedWorker") -> None:
        if worker.inflight > 0 or state.backlog:
            worker.return_handle = None
            return
        if state.workers.pop(worker.worker_id, None) is None:
            return  # already returned (reclaim/contended path)
        await self._send_return_worker(worker)

    def _return_lease_now(self, state: "_LeaseState",
                          worker: "_LeasedWorker") -> None:
        """Synchronously detach the lease and return it (no idle grace);
        the pop-before-RPC makes double-scheduling harmless."""
        if worker.return_handle is not None:
            worker.return_handle.cancel()
            worker.return_handle = None
        if state.workers.pop(worker.worker_id, None) is None:
            return
        task = self._loop.create_task(self._send_return_worker(worker))
        task.add_done_callback(lambda t: t.exception())

    async def _send_return_worker(self, worker: "_LeasedWorker") -> None:
        async def _get():
            return self.raylet_conn if worker.raylet == self.raylet_address \
                else await self._pool.get(worker.raylet)
        try:
            # idempotent (keyed on worker_id): a lost/failed return is
            # retried with backoff — a leaked lease deadlocks the node
            # once its CPUs are exhausted, so this must ride out blips
            await rpc.call_with_retry(
                _get, "return_worker", {
                    "worker_id": worker.worker_id.binary(),
                    "job_id": self.job_id.binary() if self.job_id else None,
                    "token": worker.token,
                },
                invalidate=lambda failed: self._pool.invalidate_conn(
                    worker.raylet, failed))
        except (rpc.ConnectionLost, rpc.RpcError, asyncio.TimeoutError):
            pass

    def push_reclaim_idle(self, conn, data) -> None:
        """Raylet nudge: demand is queued there and the pool is at cap —
        hand back any lease this client is merely keeping warm."""
        for state in self._lease_states.values():
            if state.backlog:
                continue
            for worker in list(state.workers.values()):
                if worker.inflight == 0:
                    self._return_lease_now(state, worker)
        # parked cache leases are idle by definition: give them back too
        self._flush_lease_cache()

    def _handle_task_reply(self, spec: TaskSpec, reply: Dict[str, Any]) -> None:
        if reply.get("system_error"):
            self._retry_or_fail(spec, WorkerCrashedError(reply["system_error"]))
            return
        retryable_app_error = (reply.get("app_error")
                               and spec.retry_exceptions
                               and not reply.get("cancelled"))
        if retryable_app_error:
            retry_spec = self.task_manager.take_for_retry(spec.task_id)
            if retry_spec is not None:
                self._loop.call_soon_threadsafe(
                    self._enqueue_for_lease, retry_spec)
                return
        self._complete_task(spec, reply["results"],
                            reply.get("dynamic_return_ids"),
                            app_error=bool(reply.get("app_error")))

    def _retry_or_fail(self, spec: TaskSpec, error: Exception) -> None:
        if spec.task_id.binary() in self._cancel_requested:
            # a force-killed worker surfaces as WorkerCrashedError here;
            # a cancel-requested task must settle CANCELLED, not retry
            self._fail_cancelled(spec)
            return
        retry_spec = self.task_manager.take_for_retry(spec.task_id)
        if retry_spec is not None:
            logger.info("retrying %s (attempt %d): %s",
                        spec.debug_name(), retry_spec.attempt_number,
                        type(error).__name__)
            self._loop.call_soon_threadsafe(self._enqueue_for_lease, retry_spec)
        else:
            self._fail_task(spec, error)

    def _call_on_loop(self, fn, *args) -> None:
        """Run ``fn`` on the io loop — directly when already there (avoids
        the self-pipe write call_soon_threadsafe pays per call)."""
        if threading.current_thread() is self._loop_thread:
            fn(*args)
        else:
            self._loop.call_soon_threadsafe(fn, *args)

    def _finish_stream(self, spec: TaskSpec,
                       error: Optional[BaseException] = None) -> None:
        if not spec.stream_returns:
            return
        tid_bin = spec.task_id.binary()
        state = self._streaming_states.get(tid_bin)
        if state is None:
            return
        with state.cond:
            state.done = True
            state.error = error
            state.cond.notify_all()
        if tid_bin in self._stream_abandoned:
            # the consumer dropped its generator while the task still
            # ran; nobody will drain (or reap) the state — do it here
            self._stream_abandoned.discard(tid_bin)
            self._reap_stream_remainder(tid_bin)

    def _reap_stream_remainder(self, tid_bin: bytes) -> None:
        """Free published-but-never-consumed streamed items: the
        consumer abandoned the generator (or dropped it after the task
        finished), so those values hold zero ObjectRefs and ordinary
        refcounting can never reclaim them — without this they pin the
        owner's memory store for the life of the process."""
        state = self._streaming_states.pop(tid_bin, None)
        if state is None:
            return
        with state.cond:
            leftovers = [b for b in state.dyn_ids[state.consumed:]
                         if b is not None]
        if not leftovers:
            return

        def _free():
            for b in leftovers:
                oid = ObjectID(b)
                info = self.reference_counter.get(oid)
                if info is not None and info.owned:
                    # ride the normal zero-transition: fires the free
                    # callback AND drops the reference-table entry
                    self.reference_counter.add_local_ref(oid)
                    self.reference_counter.remove_local_ref(oid)
        self._call_on_loop(_free)

    def _fail_task(self, spec: TaskSpec, error: Exception) -> None:
        self._task_locations.pop(spec.task_id.binary(), None)
        self._cancel_requested.discard(spec.task_id.binary())
        self._trace_end(spec, "error", error=type(error).__name__)
        self._finish_stream(spec, error)
        self.task_manager.fail(spec.task_id)
        blob = serialize_exception(
            error if isinstance(error, TaskError)
            else TaskError.from_exception(error, spec.debug_name())
        ).to_bytes()
        for ret in spec.return_ids():
            self._publish(ret, blob)
        self._record_task_event(spec, "FAILED")
        self._call_on_loop(self._signal_task_done, spec.task_id)

    def _complete_task(self, spec: TaskSpec, results: List[Tuple],
                       dynamic_return_ids: Optional[List[bytes]] = None,
                       app_error: bool = False) -> None:
        """Store task results as owner (parity: TaskManager::CompletePendingTask)."""
        self._task_locations.pop(spec.task_id.binary(), None)
        self._cancel_requested.discard(spec.task_id.binary())
        self._trace_end(spec, "error" if app_error else "ok",
                        **({"retried": True} if spec.attempt_number
                           else {}))
        self.task_manager.complete(spec.task_id)
        if dynamic_return_ids:
            # own the yielded objects BEFORE publishing anything (the
            # generator handle contains their refs): ownership links
            # them to the producing task for lineage reconstruction
            for oid_bin in dynamic_return_ids:
                self.reference_counter.add_owned(
                    ObjectID(oid_bin), producing_task=spec.task_id)
        for object_id_bin, kind, payload in results:
            object_id = ObjectID(object_id_bin)
            if kind == "inline":
                self._publish(object_id, payload)
            else:  # ("plasma", node raylet address)
                self.reference_counter.add_location(object_id, tuple(payload))
                self._publish(object_id, PLASMA_MARKER)
        if spec.stream_returns:
            err: Optional[BaseException] = None
            if app_error and results:
                # the stream broke mid-task: surface the task's real
                # error at the consumer's next() position
                try:
                    v, _ = deserialize(results[0][2])
                    if isinstance(v, TaskError):
                        err = v.cause if isinstance(
                            v.cause, BaseException) else v
                except Exception:  # noqa: BLE001 — fall back to generic
                    err = TaskError(None, "", spec.debug_name())
            self._finish_stream(spec, err)
        self._record_task_event(spec, "FINISHED")
        self._call_on_loop(self._signal_task_done, spec.task_id)

    # ------------------------------------------------------------------
    # actors: creation + submission
    # ------------------------------------------------------------------
    def create_actor(self, class_id: str, class_descriptor: str, args: tuple,
                     kwargs: dict, *, resources: Dict[str, float],
                     creation_spec: ActorCreationSpec,
                     scheduling_strategy: Optional[SchedulingStrategy] = None,
                     get_if_exists: bool = False,
                     runtime_env: Optional[Dict[str, Any]] = None) -> ActorID:
        actor_id = ActorID.of(self.job_id)
        task_id = TaskID.for_actor_task(actor_id)
        task_args, holds = self._build_args(args, kwargs)
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id,
            task_type=TaskType.ACTOR_CREATION_TASK,
            function_id=class_id,
            function_descriptor=class_descriptor,
            args=task_args,
            resources=dict(resources),
            owner_address=self.address,
            actor_id=actor_id,
            actor_creation_spec=creation_spec,
            scheduling_strategy=scheduling_strategy or SchedulingStrategy(),
            runtime_env=runtime_env,
            runtime_env_hash=_renv_hash(runtime_env),
            trace_context=_trace_carrier(),
        )
        if _trace.enabled():
            # actor creation under an active trace (e.g. a traced serve
            # scale-up) carries the chain to the GCS registration hop;
            # nothing is born here — creations outside a trace stay
            # untraced (they are not requests)
            _ctx = _trace.current()
            if _ctx is not None:
                if spec.trace_context is None:
                    spec.trace_context = dict(_ctx)
                else:
                    spec.trace_context.update(_ctx)
        strat = spec.scheduling_strategy
        payload = {
            "actor_id": actor_id.binary(),
            "spec_blob": _spec_dumps(spec),
            "resources": resources,
            "name": creation_spec.name,
            "namespace": creation_spec.namespace,
            "detached": creation_spec.lifetime_detached,
            "max_restarts": creation_spec.max_restarts,
            "job_id": self.job_id.binary(),
            "class_name": class_descriptor,
            "get_if_exists": get_if_exists,
            "placement_group_id":
                strat.placement_group_id.binary()
                if strat.placement_group_id else None,
            "bundle_index": strat.bundle_index,
            # placement strategy rides to the GCS actor scheduler:
            # SPREAD fans replicas across nodes, NODE_AFFINITY pins
            # (serve replica spread / per-node proxies depend on this)
            "strategy": strat.kind,
            "strategy_node": strat.node_id_hex,
            "strategy_soft": strat.soft,
            "env_hash": spec.runtime_env_hash,
            "env_spawn": _renv_spawn(spec.runtime_env),
            # trace carrier: the GCS records its registration hop span
            # when the creation belongs to an active trace
            "trace": _trace.ctx_of(spec.trace_context),
            # nodes already holding the creation args' plasma objects:
            # the GCS prefers them for DEFAULT placement so the arg
            # fetch is a local read instead of a transfer
            "locality": self._arg_locality(spec),
        }
        # pin creation args for the actor's lifetime (restarts re-run the
        # creation task and need them)
        self._actor_creation_holds = getattr(self, "_actor_creation_holds", [])
        self._actor_creation_holds.extend(holds)
        if creation_spec.name is None and not get_if_exists:
            # Unnamed actors register ASYNCHRONOUSLY: the id was minted
            # here, no name conflict is possible, and the reply carries
            # nothing the caller needs — so don't serialize creation
            # bursts on per-actor GCS round trips (measured 12 ms/actor
            # with a busy GCS).  Concurrent creations coalesce into one
            # register_actor_batch RPC.  Method submission awaits the
            # ack in _resolve_actor_address before querying actor state.
            state = self._actor_state(actor_id)
            fut = self._register_actor_queued(payload)
            state.register_fut = fut

            def _log_failure(f, state=state):
                exc = f.exception() if not f.cancelled() else None
                if exc is not None:
                    logger.warning("async actor registration for %s "
                                   "failed: %s", actor_id.hex()[:12], exc)
                elif f.result().get("subscribed"):
                    # the GCS auto-subscribed this conn to the actor's
                    # channel at registration: address resolution can
                    # wait for the ALIVE push instead of paying
                    # subscribe + get_actor round trips per actor
                    state.subscribed = True
            fut.add_done_callback(_log_failure)
            return actor_id
        # named / get_if_exists: the reply decides (conflict or reuse).
        # The submit state exists BEFORE the blocking call: a fast
        # creation can deliver the auto-subscribed ALIVE push to
        # _on_gcs_push while this thread still waits on the reply — with
        # no state entry the address would be dropped and the first
        # method call would sleep out the push-first grace.  Named
        # creations ride the same coalescing flush (no added latency:
        # the flush fires on the next loop drain) so concurrent named
        # fleets batch too; this thread just blocks on ITS entry.
        state = self._actor_state(actor_id)
        try:
            reply = self._register_actor_queued(payload).result(180.0)
        except Exception:
            self._actor_states.pop(actor_id, None)
            raise
        if reply.get("error"):
            # per-entry failure inside a batch (name conflict)
            self._actor_states.pop(actor_id, None)
            raise ValueError(reply["error"])
        out_id = ActorID(reply["actor_id"])
        if reply.get("existing"):
            # reusing another registration's actor: our minted id (and
            # its pre-made state) never materialized
            self._actor_states.pop(actor_id, None)
        elif reply.get("subscribed"):
            state.subscribed = True
        return out_id

    def _arg_locality(self, spec: TaskSpec) -> Optional[List[Any]]:
        """Raylet addresses of nodes holding this spec's plasma ref
        args (owner knowledge from the object directory) — the
        locality hint the GCS actor scheduler prefers for DEFAULT
        placement.  None when every arg is inline/unlocated."""
        out: Optional[List[Any]] = None
        for arg in spec.args:
            oid = arg.object_id
            if oid is None:
                continue
            ref = self.reference_counter.get(oid)
            if ref is None or not ref.locations:
                continue
            if out is None:
                out = []
            for addr in ref.locations:
                addr = list(addr)
                if addr not in out:
                    out.append(addr)
            if len(out) >= 4:  # enough preference signal; bound the wire
                break
        return out

    def _register_actor_queued(self, payload: Dict[str, Any]
                               ) -> "concurrent.futures.Future":
        """Queue one actor registration for the coalescing flush;
        returns a future resolving to the actor's per-entry reply."""
        fut: "concurrent.futures.Future" = concurrent.futures.Future()
        if not getattr(self.config, "actor_register_batch", True):
            rfut = asyncio.run_coroutine_threadsafe(
                self.gcs_conn.call("register_actor", payload), self._loop)

            def _chain(f):
                if f.cancelled():
                    fut.cancel()
                elif f.exception() is not None:
                    fut.set_exception(f.exception())
                else:
                    fut.set_result(f.result())
            rfut.add_done_callback(_chain)
            return fut
        with self._actor_reg_lock:
            self._actor_reg_buf.append((payload, fut))
            scheduled = self._actor_reg_scheduled
            self._actor_reg_scheduled = True
        if not scheduled:
            try:
                self._loop.call_soon_threadsafe(self._spawn_reg_flush)
            except RuntimeError:
                # loop torn down: no flush will EVER run — fail the
                # whole buffer, not just this caller's entry (batch-
                # mates that skipped scheduling would otherwise hang)
                with self._actor_reg_lock:
                    stranded = self._actor_reg_buf
                    self._actor_reg_buf = []
                    self._actor_reg_scheduled = False
                for _, sfut in stranded:
                    if not sfut.done():
                        sfut.set_exception(RayTpuError(
                            "cannot register actor: the runtime is "
                            "shut down"))
        return fut

    def _spawn_reg_flush(self) -> None:
        task = self._loop.create_task(self._flush_actor_registrations())
        task.add_done_callback(lambda t: t.exception())

    async def _flush_actor_registrations(self) -> None:
        """Drain the registration buffer as register_actor_batch RPCs.

        Coalescing is purely opportunistic — the flush runs on the next
        io-loop drain, so a lone creation pays no extra latency while a
        tight creation loop (whose user thread outruns the loop)
        batches naturally."""
        with self._actor_reg_lock:
            batch = self._actor_reg_buf
            self._actor_reg_buf = []
            self._actor_reg_scheduled = False
        if not batch:
            return
        cap = max(1, int(getattr(self.config,
                                 "actor_register_batch_max", 256)))
        for i in range(0, len(batch), cap):
            await self._send_actor_reg_batch(batch[i:i + cap])

    async def _send_actor_reg_batch(self, batch: List[tuple]) -> None:
        payloads = [p for p, _ in batch]
        # one payload dict for the whole retry loop: every replay of
        # this batch carries the SAME seq, so the GCS ack cache can
        # re-serve the first pass's replies instead of re-counting
        self._reg_batch_seq += 1
        request = {"actors": payloads, "source": self._worker_id_hex,
                   "seq": self._reg_batch_seq}
        reply = None
        err: Optional[BaseException] = None
        # retry budget spans a HEAD RESTART: the reconnect loop swaps
        # self.gcs_conn underneath us, registration is idempotent keyed
        # on actor_id (the restarted GCS replays acked entries from its
        # WAL), so a storm interrupted by a GCS SIGKILL converges on
        # exactly one directory entry per actor instead of failing the
        # whole fleet after a fixed 4-attempt ~0.4 s window
        deadline = time.monotonic() + max(
            5.0, self.config.gcs_client_reconnect_timeout_s)
        attempt = 0
        while True:
            if attempt:
                # idempotent replay (GCS keys on actor_id): a dropped
                # or failed batch re-sends whole and converges on one
                # directory entry per actor
                await asyncio.sleep(rpc.gcs_reconnect_delay(
                    attempt - 1, self.config))
            try:
                reply = await self.gcs_conn.call(
                    "register_actor_batch", request, timeout=60.0)
                err = None
            except (rpc.ConnectionLost, rpc.RpcError, OSError,
                    asyncio.TimeoutError) as e:
                err = e
                reply = None
                if isinstance(e, rpc.RpcError) and not isinstance(
                        e, rpc.RpcDeadlineExceeded) and attempt >= 3:
                    # a handler-raised error (not transport trouble)
                    # that survived several replays is deterministic —
                    # fail fast instead of burning the reconnect budget
                    break
            if isinstance(reply, dict) and "replies" in reply:
                break
            attempt += 1
            if self._shutdown or time.monotonic() >= deadline:
                break
        if not isinstance(reply, dict) or "replies" not in reply:
            exc = err if err is not None else RayTpuError(
                "register_actor_batch returned no replies")
            for _, fut in batch:
                if not fut.done():
                    fut.set_exception(exc)
            return
        for (_, fut), r in zip(batch, reply["replies"]):
            if not fut.done():
                fut.set_result(r)

    def _actor_state(self, actor_id: ActorID) -> "_ActorSubmitState":
        state = self._actor_states.get(actor_id)
        if state is None:
            state = _ActorSubmitState(actor_id)
            self._actor_states[actor_id] = state
        return state

    def submit_actor_task(self, actor_id: ActorID, method_name: str,
                          args: tuple, kwargs: dict, *, num_returns: int = 1,
                          max_task_retries: int = 0,
                          concurrency_group: str = "") -> List[ObjectRef]:
        task_id = TaskID.for_actor_task(actor_id)
        task_args, holds = self._build_args(args, kwargs)
        spec = TaskSpec(
            task_id=task_id,
            job_id=self.job_id or actor_id.job_id(),
            task_type=TaskType.ACTOR_TASK,
            function_id="",
            function_descriptor=method_name,
            args=task_args,
            num_returns=num_returns,
            max_retries=max_task_retries,
            owner_address=self.address,
            actor_id=actor_id,
            concurrency_group=concurrency_group,
            trace_context=_trace_carrier(),
        )
        self._trace_begin(spec)
        rets = self.task_manager.register(spec)
        del holds  # submitted-refs now pin the promoted args
        refs = [ObjectRef(oid, self.address) for oid in rets]
        self._track_child(task_id)
        # same batched loop-wakeup path as normal tasks; FIFO drain keeps
        # per-actor sequence-number order equal to submission order
        self._submit_to_lease_queue(spec)
        return refs

    def _enqueue_actor_task(self, spec: TaskSpec) -> None:
        state = self._actor_state(spec.actor_id)
        spec.sequence_number = state.next_seq
        state.next_seq += 1
        state.pending[spec.sequence_number] = spec
        # Fast path for the latency case (sync call loops): idle sender,
        # resolved address, live pooled conn — start the RPC on THIS
        # loop tick instead of spinning up a sender-loop coroutine.
        # Ordering holds: the queue is empty and sends are synchronous
        # start_calls in submission order on this thread, so this frame
        # is the next in sequence (a backoff-delayed retry can be
        # leapfrogged, exactly as with an idle sender loop today).
        # len(pending)==1 gates it to the pure-latency shape: with other
        # calls in flight (an async burst), frames must keep flowing
        # through the sender loop so they BATCH (push_actor_tasks) —
        # per-call frames were exactly the n:n cost this trades against.
        # Armed failpoints route through the sender loop so injection
        # sites see every call (dormant registries keep the fast path).
        if not _fp.active() \
                and len(state.pending) == 1 and not state.queue \
                and state.address is not None \
                and state.dead_cause is None \
                and (state.sender_task is None
                     or state.sender_task.done()):
            conn = self._pool.get_if_connected(state.address)
            if conn is not None and self._start_single_push(
                    state, spec, state.address, conn):
                return
        state.queue.append(spec)
        self._kick_actor_sender(state)

    def _start_single_push(self, state: "_ActorSubmitState",
                           spec: TaskSpec, address: rpc.Address,
                           conn: rpc.Connection) -> bool:
        """Initiate one un-batched actor-task RPC (shared by the
        enqueue fast path and the sender loop); False means the conn
        died before any bytes were written — requeue/resend is safe."""
        tid_bin = spec.task_id.binary()
        if tid_bin in self._cancel_requested:
            state.pending.pop(spec.sequence_number, None)
            self._fail_cancelled(spec)
            return True  # settled (as cancelled) — nothing to resend
        self._task_locations[tid_bin] = address
        self._record_task_event(spec, "RUNNING")
        try:
            reply_fut = conn.start_call(
                "push_actor_task", {"spec_blob": _spec_dumps(spec)})
        except rpc.ConnectionLost:
            self._pool.invalidate(address)
            state.address = None
            return False
        waiter = self._loop.create_task(
            self._await_actor_reply(state, spec, address, reply_fut))
        waiter.add_done_callback(lambda t: t.exception())
        return True

    def _kick_actor_sender(self, state: "_ActorSubmitState") -> None:
        if state.sender_task is None or state.sender_task.done():
            state.sender_task = self._loop.create_task(
                self._actor_sender_loop(state))
            state.sender_task.add_done_callback(lambda t: t.exception())

    async def _actor_sender_loop(self, state: "_ActorSubmitState") -> None:
        """Drain the per-actor submit queue, initiating the RPC writes in
        sequence-number order (parity: ``SequentialActorSubmitQueue``).  The
        write happens synchronously via ``start_call`` so frames hit the TCP
        stream in order; replies resolve concurrently (pipelined).

        Queued runs ship as ONE batched frame (``push_actor_tasks``) whose
        results stream back per task — framing + dispatch dominated
        per-call cost on n:n call storms.  A lone call keeps the
        single-frame path (no streaming machinery on the latency path)."""
        while state.queue:
            # pop BEFORE any await: a retry re-sort during the await can
            # put a different spec at queue[0], and a peek-then-pop
            # would settle one spec twice while dropping the other
            spec = state.queue.popleft()
            try:
                # failpoint: the actor's address resolution / connect
                # fails mid-restart — the per-task retry budget applies,
                # and the restarted actor's new address must be re-read
                if _fp.active():
                    await _fp.afailpoint("worker.actor_resolve.pre")
                address = await self._resolve_actor_address(state)
                conn = await self._pool.get(address)
            except ActorDiedError as e:
                state.pending.pop(spec.sequence_number, None)
                self._fail_task(spec, e)
                continue
            except (rpc.ConnectionLost, rpc.RpcError, OSError,
                    _fp.FailpointError):
                state.address = None
                await self._retry_or_fail_actor_task(state, spec,
                                                     "connect failed")
                continue
            if state.queue:
                batch: List[TaskSpec] = [spec]
                while state.queue and len(batch) < 64:
                    batch.append(state.queue.popleft())
                self._send_actor_batch(state, batch, address, conn)
                continue
            if not self._start_single_push(state, spec, address, conn):
                # conn died before any bytes were written: resend on a
                # fresh connection without burning the retry budget
                state.queue.appendleft(spec)
                continue

    def _send_actor_batch(self, state: "_ActorSubmitState",
                          batch: List[TaskSpec], address: rpc.Address,
                          conn: rpc.Connection) -> None:
        dropped = [s for s in batch
                   if s.task_id.binary() in self._cancel_requested]
        if dropped:
            for spec in dropped:
                state.pending.pop(spec.sequence_number, None)
                self._fail_cancelled(spec)
            batch = [s for s in batch if s not in dropped]
            if not batch:
                return
        keys = [(spec.task_id.binary(), spec.attempt_number)
                for spec in batch]
        for spec, key in zip(batch, keys):
            self._actor_streamed[key] = (spec, state)
            self._task_locations[key[0]] = address
            self._record_task_event(spec, "RUNNING")
        conn.set_push_handler(self._on_worker_push)
        try:
            reply_fut = conn.start_call(
                "push_actor_tasks", {"specs_blob": _spec_dumps(batch)})
        except rpc.ConnectionLost:
            self._pool.invalidate(address)
            state.address = None
            for spec, key in zip(batch, keys):
                if self._actor_streamed.pop(key, None) is not None:
                    self._post(self._retry_or_fail_actor_task(
                        state, spec, "connection lost"))
            return
        waiter = self._loop.create_task(self._await_actor_batch(
            state, batch, keys, address, reply_fut))
        waiter.add_done_callback(lambda t: t.exception())

    async def _await_actor_batch(self, state: "_ActorSubmitState",
                                 batch: List[TaskSpec], keys: List[tuple],
                                 address: rpc.Address, reply_fut) -> None:
        try:
            reply = await reply_fut
        except (rpc.ConnectionLost, rpc.RpcError) as e:
            self._pool.invalidate(address)
            state.address = None
            for spec, key in zip(batch, keys):
                if self._actor_streamed.pop(key, None) is not None:
                    await self._retry_or_fail_actor_task(
                        state, spec, f"connection lost: {e}")
            return
        dead = reply.get("actor_dead")
        # results stream on the same FIFO connection BEFORE the final
        # ack, so leftovers mean the push was lost (or the actor died
        # before executing them)
        for spec, key in zip(batch, keys):
            if self._actor_streamed.pop(key, None) is None:
                continue
            if dead:
                state.pending.pop(spec.sequence_number, None)
                self._fail_task(spec, ActorDiedError(
                    spec.actor_id.hex()[:12], reply.get("reason", "")))
            else:
                await self._retry_or_fail_actor_task(
                    state, spec, "streamed result missing")

    async def _await_actor_reply(self, state: "_ActorSubmitState",
                                 spec: TaskSpec, address: rpc.Address,
                                 reply_fut) -> None:
        try:
            reply = await reply_fut
        except (rpc.ConnectionLost, rpc.RpcError) as e:
            self._pool.invalidate(address)
            state.address = None
            await self._retry_or_fail_actor_task(
                state, spec, f"connection lost: {e}")
            return
        state.pending.pop(spec.sequence_number, None)
        if reply.get("actor_dead"):
            self._fail_task(spec, ActorDiedError(
                spec.actor_id.hex()[:12], reply.get("reason", "")))
            return
        self._handle_task_reply(spec, reply)

    async def _retry_or_fail_actor_task(self, state: "_ActorSubmitState",
                                        spec: TaskSpec, reason: str) -> None:
        if spec.task_id.binary() in self._cancel_requested:
            state.pending.pop(spec.sequence_number, None)
            self._fail_cancelled(spec)
            return
        # the actor may be restarting; re-resolve and retry if allowed
        if spec.max_retries > 0:
            retry_spec = self.task_manager.take_for_retry(spec.task_id)
            if retry_spec is not None:
                retry_spec.sequence_number = spec.sequence_number
                state.pending[spec.sequence_number] = retry_spec

                def _requeue():
                    # keep the queue sorted by sequence number so a retried
                    # task runs before later submissions (in-order contract)
                    state.queue.append(retry_spec)
                    ordered = sorted(state.queue,
                                     key=lambda s: s.sequence_number)
                    state.queue.clear()
                    state.queue.extend(ordered)
                    self._kick_actor_sender(state)

                # backoff without stalling the sender loop for other tasks
                self._loop.call_later(0.1, _requeue)
                return
        state.pending.pop(spec.sequence_number, None)
        self._fail_task(spec, ActorDiedError(
            spec.actor_id.hex()[:12], reason))

    async def _resolve_actor_address(self, state: "_ActorSubmitState"
                                     ) -> rpc.Address:
        if state.register_fut is not None:
            # async registration (unnamed actors): the GCS must have
            # acked before get_actor can answer — await, don't clear
            # (one-shot future; concurrent resolvers all await it)
            try:
                await asyncio.wrap_future(state.register_fut)
            except Exception as e:  # noqa: BLE001 — surfaced as actor death
                raise ActorDiedError(
                    state.actor_id.hex()[:12],
                    f"registration failed: {e}") from e
        if state.address is not None:
            return state.address
        # auto-subscribed at registration: an ALIVE push is already on
        # its way — give it a head start before paying a get_actor poll
        # (two RTTs per actor dominated the driver side of creation
        # storms)
        push_first = state.subscribed
        if not state.subscribed:
            # Event-driven resolution: subscribe BEFORE the state query so
            # no ALIVE/DEAD transition can fall between them, then sleep
            # on the push event (the 100 ms poll loop this replaces put
            # ~half its period of dead latency on every actor creation).
            # The subscription stays active afterwards — restart and
            # death transitions keep repairing state.address for free.
            state.subscribed = True
            await self.gcs_conn.call(
                "subscribe", {"channel": f"actor:{state.actor_id.hex()}"})
        deadline = time.monotonic() + 120.0
        while time.monotonic() < deadline:
            if state.address is not None:
                return state.address
            if state.dead_cause is not None:
                raise ActorDiedError(state.actor_id.hex()[:12],
                                     state.dead_cause)
            # Cleared BEFORE the poll: an ALIVE push racing the in-flight
            # get_actor reply re-sets it, so the post-poll wait returns
            # immediately instead of sleeping the 2 s fallback (clearing
            # after the poll erased exactly that wakeup).
            if state.resolve_event is None:
                state.resolve_event = asyncio.Event()
            state.resolve_event.clear()
            if push_first:
                push_first = False
                try:
                    await asyncio.wait_for(state.resolve_event.wait(), 2.0)
                except asyncio.TimeoutError:
                    pass  # lost push: fall through to the poll
                continue
            reply = await self.gcs_conn.call(
                "get_actor", {"actor_id": state.actor_id.binary()})
            if reply is None:
                raise ActorDiedError(state.actor_id.hex()[:12],
                                     "actor not found")
            if reply["state"] == "ALIVE" and reply["address"]:
                state.address = tuple(reply["address"])
                return state.address
            if reply["state"] == "DEAD":
                raise ActorDiedError(state.actor_id.hex()[:12],
                                     reply.get("death_cause", "dead"))
            try:
                # event-driven wake; 2 s re-poll covers a lost push
                await asyncio.wait_for(state.resolve_event.wait(), 2.0)
            except asyncio.TimeoutError:
                pass
        raise ActorDiedError(state.actor_id.hex()[:12],
                             "timed out resolving actor address")

    def current_lease_resources(self) -> Dict[str, float]:
        """Resource demand of the currently-executing task (empty in a
        driver or outside task execution)."""
        return dict(self._ctx.current_resources or {})

    def gcs_call(self, method: str, data: Optional[dict] = None,
                 timeout: float = 30.0):
        """Generic GCS RPC (autoscaler monitor, state API, dashboards)."""
        return self._run(self.gcs_conn.call(method, data or {},
                                            timeout=timeout))

    def raylet_call(self, address, method: str,
                    data: Optional[dict] = None, timeout: float = 30.0):
        """Generic RPC to any raylet (state API per-node sources)."""
        async def _call():
            conn = await self._pool.get(tuple(address))
            return await conn.call(method, data or {}, timeout=timeout)
        return self._run(_call())

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self._run(self.gcs_conn.call("kill_actor",
                                     {"actor_id": actor_id.binary()}))
        state = self._actor_states.get(actor_id)
        if state is not None:
            state.address = None

    def kill_actor_async(self, actor_id: ActorID) -> None:
        """Fire-and-forget kill, safe from GC/__del__ contexts (cannot
        block on the event loop).  Defers the kill until this owner's
        in-flight tasks to the actor have drained, so patterns like
        ``get(Cls.remote().method.remote())`` (handle GC'd right after
        submit) don't race the kill against the call."""
        if self._shutdown or self.gcs_conn is None or self.gcs_conn.closed:
            return

        async def _kill():
            deadline = time.monotonic() + 60.0
            state = self._actor_states.get(actor_id)
            while state is not None and time.monotonic() < deadline and \
                    (state.pending or state.queue):
                await asyncio.sleep(0.05)
            try:
                await self.gcs_conn.call("kill_actor",
                                         {"actor_id": actor_id.binary()})
            except Exception:  # noqa: BLE001
                pass

        try:
            self._post(_kill())
        except Exception:  # noqa: BLE001
            pass

    # ------------------------------------------------------------------
    # task cancellation (parity: reference worker.py:2582 ray.cancel ->
    # CoreWorker::CancelTask; the cancel RPC reaches the EXECUTING
    # worker and interrupts the running task)
    # ------------------------------------------------------------------
    def cancel_task(self, task_id: TaskID, *, force: bool = False,
                    recursive: bool = False) -> None:
        """Cancel a submitted task: unqueue it if it has not started,
        interrupt it (KeyboardInterrupt) if it is running, kill the
        executing worker on ``force=True``.  ``get`` on its returns
        raises :class:`TaskCancelledError`.  Best-effort: a task that
        completes before the cancel lands keeps its result."""
        spec = self.task_manager.pending_spec(task_id)
        if spec is None:
            return  # already finished / unknown: nothing to cancel
        if force and spec.task_type == TaskType.ACTOR_TASK:
            raise ValueError(
                "force=True is not supported for actor tasks (kill the "
                "actor with ray_tpu_torch.kill to interrupt it hard)")
        self._call_on_loop(self._cancel_on_loop, task_id, force, recursive)

    def _cancel_on_loop(self, task_id: TaskID, force: bool,
                        recursive: bool) -> None:
        tid_bin = task_id.binary()
        if not self.task_manager.is_pending(task_id):
            return
        self._cancel_requested.add(tid_bin)
        # (0) parked on unready dependencies: unpark + fail
        parked = self._waiting_for_deps.pop(tid_bin, None)
        if parked is not None:
            self._fail_cancelled(parked[0])
            return
        # (1) still queued owner-side: unqueue + fail without any RPC
        for state in self._lease_states.values():
            for spec in state.backlog:
                if spec.task_id == task_id:
                    state.backlog.remove(spec)
                    self._fail_cancelled(spec)
                    return
        for astate in self._actor_states.values():
            for spec in list(astate.queue):
                if spec.task_id == task_id:
                    astate.queue.remove(spec)
                    astate.pending.pop(spec.sequence_number, None)
                    self._fail_cancelled(spec)
                    return
        # (2) dispatched: route the cancel to the worker executing it
        address = self._task_locations.get(tid_bin)
        if address is not None:
            task = self._loop.create_task(
                self._send_cancel(tid_bin, address, force, recursive))
            task.add_done_callback(lambda t: t.exception())
        # (3) in neither place (dispatch in flight): _cancel_requested is
        # checked at push time and at reply time, so it still dies

    async def _send_cancel(self, tid_bin: bytes, address: rpc.Address,
                           force: bool, recursive: bool) -> None:
        try:
            conn = await self._pool.get(address)
            await conn.call("cancel_task",
                            {"task_id": tid_bin, "force": force,
                             "recursive": recursive}, timeout=10.0)
        except (rpc.ConnectionLost, rpc.RpcError, asyncio.TimeoutError,
                OSError):
            # force kills the worker mid-call: the push_task reply path
            # sees the connection drop and settles the task as cancelled
            pass

    def _fail_cancelled(self, spec: TaskSpec) -> None:
        self._fail_task(spec, TaskCancelledError(spec.debug_name()))

    def get_actor_info(self, *, actor_id: Optional[ActorID] = None,
                       name: Optional[str] = None,
                       namespace: str = "default") -> Optional[Dict[str, Any]]:
        if name is not None:
            return self._run(self.gcs_conn.call(
                "get_actor", {"name": name, "namespace": namespace}))
        return self._run(self.gcs_conn.call(
            "get_actor", {"actor_id": actor_id.binary()}))

    # ------------------------------------------------------------------
    # GCS conveniences
    # ------------------------------------------------------------------
    def _gcs_call_retry(self, method: str, data: dict):
        """Idempotent GCS call that rides out a head restart: each
        attempt re-reads ``self.gcs_conn`` (the reconnect loop swaps in
        the fresh connection), backing off under the config policy."""
        async def _get():
            conn = self.gcs_conn
            if conn is None or conn.closed:
                raise rpc.ConnectionLost()
            return conn
        return self._run(rpc.call_with_retry(_get, method, data))

    def kv_put(self, key: str, value: bytes, namespace: str = "") -> None:
        self._gcs_call_retry("kv_put", {
            "key": key, "value": value, "namespace": namespace})

    def kv_get(self, key: str, namespace: str = "") -> Optional[bytes]:
        return self._gcs_call_retry("kv_get", {
            "key": key, "namespace": namespace})

    def kv_del(self, key: str, namespace: str = "") -> bool:
        return self._gcs_call_retry("kv_del", {
            "key": key, "namespace": namespace})

    def kv_keys(self, prefix: str = "", namespace: str = "") -> List[str]:
        return self._gcs_call_retry("kv_keys", {
            "prefix": prefix, "namespace": namespace})

    def get_nodes(self) -> List[Dict[str, Any]]:
        return self._gcs_call_retry("get_nodes", {})

    def cluster_resources(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for node in self.get_nodes():
            if node["alive"]:
                for k, v in node["resources_total"].items():
                    total[k] = total.get(k, 0.0) + v
        return total

    def available_resources(self) -> Dict[str, float]:
        total: Dict[str, float] = {}
        for node in self.get_nodes():
            if node["alive"]:
                for k, v in node["resources_available"].items():
                    total[k] = total.get(k, 0.0) + v
        return total

    def set_log_hook(self, hook) -> None:
        """Route ``worker_logs`` pubsub batches to ``hook(message)``
        instead of the default driver echo (``ray-tpu logs`` filters)."""
        self._log_hook = hook

    def _on_gcs_push(self, channel: str, message: Any) -> None:
        if channel == "worker_logs":
            hook = getattr(self, "_log_hook", None)
            if hook is not None:
                try:
                    hook(message)
                except Exception:  # noqa: BLE001 — consumer bug only
                    logger.debug("log hook failed", exc_info=True)
                return
            import sys as _sys
            node = message.get("node_id", "")
            for rec in message.get("records", []):
                stream = _sys.stderr if rec.get("is_err") else _sys.stdout
                for line in rec.get("lines", []):
                    print(f"(pid={rec['pid']}, node={node}) {line}",
                          file=stream)
            return
        if channel.startswith("actor:"):
            actor_id = ActorID.from_hex(channel.split(":", 1)[1])
            state = self._actor_states.get(actor_id)
            if state is not None:
                if message["state"] == "ALIVE" and message["address"]:
                    state.address = tuple(message["address"])
                    state.dead_cause = None  # restart completed
                    # pre-warm the submit connection: in a creation
                    # burst the first-call storm otherwise pays one
                    # serial TCP connect per actor right when every
                    # process is busiest
                    try:
                        t = self._loop.create_task(
                            self._pool.get(state.address))
                        t.add_done_callback(
                            lambda f: f.exception()
                            if not f.cancelled() else None)
                    except Exception:  # noqa: BLE001 — best effort
                        pass
                elif message["state"] == "DEAD":
                    state.address = None
                    state.dead_cause = message.get("death_cause") or "dead"
                    # DEAD is terminal in the GCS — drop the subscription
                    # so long-lived drivers creating ephemeral actors
                    # don't accrete one GCS subscriber entry per actor
                    if state.subscribed:
                        state.subscribed = False
                        try:
                            fut = self.gcs_conn.start_call(
                                "unsubscribe", {"channel": channel})
                            fut.add_done_callback(lambda f: f.exception()
                                                  if not f.cancelled()
                                                  else None)
                        except rpc.ConnectionLost:
                            pass
                else:  # RESTARTING etc.
                    state.address = None
                if state.resolve_event is not None:
                    state.resolve_event.set()

    # ------------------------------------------------------------------
    # task events (state API feed)
    # ------------------------------------------------------------------
    def _record_task_event(self, spec: TaskSpec, state: str) -> None:
        # raw tuple on the hot path; formatted into dicts at flush time.
        # PENDING rows carry lineage (submitting task + the tasks that
        # produced ref args — ObjectIDs embed their producing TaskID),
        # which is what `ray-tpu analyze` reconstructs the DAG from.
        lineage = None
        if state == "PENDING":
            deps = [a.object_id.task_id() for a in spec.args
                    if a.object_id is not None]
            for a in spec.args:
                deps.extend(c.task_id() for c in a.contained_ids)
            lineage = (self._ctx.task_id, deps)
        self._task_events.append(
            (spec.task_id, spec.function_descriptor, state,
             spec.task_type, spec.actor_id, time.time(),
             spec.attempt_number, lineage))
        # owner-side submit -> dispatch latency: PENDING stamps, RUNNING
        # observes; terminal states clear stamps of never-dispatched
        # tasks (cancelled / failed in queue) so the table can't grow
        tid_bin = spec.task_id.binary()
        if state == "PENDING":
            self._dispatch_ts[tid_bin] = time.monotonic()
        else:
            t0 = self._dispatch_ts.pop(tid_bin, None)
            if t0 is not None and state == "RUNNING":
                _tm.task_dispatch_latency(time.monotonic() - t0)

    def _format_task_events(self, batch) -> List[Dict[str, Any]]:
        wid = self.worker_id.hex()
        job = self.job_id.hex() if self.job_id else None
        # same GCS-clock correction the span reporters apply, so task
        # rows and transfer/rpc spans share one timeline() timebase
        off = _tm.clock_offset()
        out = []
        for (task_id, name, state, task_type, actor_id, ts, attempt,
             lineage) in batch:
            row = {
                "task_id": task_id.hex(),
                "name": name,
                "state": state,
                "type": task_type.name,
                "actor_id": actor_id.hex() if actor_id else None,
                "time": ts + off,
                "attempt": attempt,
                "worker_id": wid,
                "job_id": job,
            }
            if lineage is not None:
                parent, deps = lineage
                row["parent_task_id"] = parent.hex() if parent else None
                row["deps"] = sorted({d.hex() for d in deps})
            out.append(row)
        return out

    async def _task_event_flush_loop(self) -> None:
        while not self._shutdown:
            await asyncio.sleep(1.0)
            if self._task_events and self.gcs_conn and not self.gcs_conn.closed:
                batch, self._task_events = self._task_events, []
                self._task_event_report_seq += 1
                try:
                    await self.gcs_conn.call(
                        "report_task_events",
                        {"events": self._format_task_events(batch),
                         "source": self._worker_id_hex,
                         "seq": self._task_event_report_seq})
                except (rpc.ConnectionLost, rpc.RpcError):
                    pass

    def _queued_task_depth(self) -> int:
        """Owner-side backlog: tasks waiting for a lease/dispatch plus
        queued actor calls (the queue-depth metric)."""
        n = sum(len(s.backlog) for s in self._lease_states.values())
        n += sum(len(s.queue) for s in self._actor_states.values())
        n += len(self._waiting_for_deps)
        return n

    async def _metrics_flush_loop(self) -> None:
        """Per-process half of the metrics pipeline (parity: the
        reference worker pushing its OpenCensus view deltas to the node
        MetricsAgent).  Batches registry deltas + runtime spans to the
        GCS every ``metrics_report_period_s`` with drop-don't-block
        semantics: an unreachable GCS costs the window's deltas only."""
        from ray_tpu_torch.util import metrics as metrics_mod

        period = max(0.25, getattr(self.config,
                                   "metrics_report_period_s", 5.0))
        synced_conn = None  # re-probe on failure AND after a reconnect
        source = f"{self.mode}-{self._worker_id_hex[:8]}"
        wid_tags = {"wid": self._worker_id_hex[:8]}
        while not self._shutdown:
            # an active profiling window flushes at >= 1 Hz so a short
            # `ray-tpu profile --duration 2` sees its samples arrive
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
                    _tm.set_gauge("ray_tpu_task_backlog",
                                  "tasks queued owner-side awaiting "
                                  "lease/dispatch",
                                  self._queued_task_depth(), wid_tags)
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
                pass  # dropped: counters re-accumulate next window
            except Exception:
                logger.exception("metrics flush iteration failed")

    # ------------------------------------------------------------------
    # task execution (worker mode)
    # ------------------------------------------------------------------
    def run_exec_loop(self) -> None:
        """Main loop of a worker process: execute queued tasks until
        shutdown (parity: worker.main_loop / RunTaskExecutionLoop)."""
        self._consume_exec_queue()

    def _exec_one(self, spec: TaskSpec) -> Dict[str, Any]:
        """_execute_task plus a late-interrupt backstop: a cancel's
        PyThreadState_SetAsyncExc can be delivered after the task body
        returned (in _execute_task's finally, while it waits on the
        tracking lock) — without this catch it would kill the exec loop
        and drop the computed reply."""
        if self._actor_exiting:
            # calls queued behind exit_actor() fail with actor death
            # instead of executing (reference exit semantics)
            return self._actor_dead_reply(spec)
        try:
            return self._execute_task(spec)
        except KeyboardInterrupt:
            return self._cancelled_reply(spec)

    def _actor_exit_reply(self, spec: TaskSpec) -> Dict[str, Any]:
        """The method called exit_actor(): the caller gets
        ActorDiedError, the GCS is told to mark the actor DEAD with no
        restart (kill_actor), and _exit_after_reply recycles the
        process once the reply flushes."""
        self._exit_after_reply = True
        self._actor_exiting = True
        aid = self._actor_id

        def _notify():
            try:
                fut = self.gcs_conn.start_call(
                    "kill_actor", {"actor_id": aid.binary()})
                self._exit_barrier = fut
                fut.add_done_callback(
                    lambda f: f.exception() if not f.cancelled() else None)
            except Exception:  # noqa: BLE001 — exit proceeds regardless
                pass
        self._loop.call_soon_threadsafe(_notify)
        return self._actor_dead_reply(spec)

    def _actor_dead_reply(self, spec: TaskSpec) -> Dict[str, Any]:
        aid = self._actor_id
        blob = serialize_exception(ActorDiedError(
            f"actor {aid.hex()[:12]} exited via exit_actor() "
            f"({spec.debug_name()} will not run)")).to_bytes()
        return {"results": [(rid.binary(), "inline", blob)
                            for rid in spec.return_ids()],
                "app_error": True}

    def _exec_queue_for(self, spec: TaskSpec) -> "queue_mod.Queue":
        """Concurrency-group routing (parity: reference actor.py:65-83):
        an actor task runs in its named group's executor pool when the
        call (or the method's @method declaration) names one; everything
        else shares the default pool.  A saturated default pool can then
        never starve control-plane methods in their own group."""
        if not self._group_queues:
            return self._exec_queue
        group = spec.concurrency_group
        if not group and self._actor_instance is not None:
            meth = getattr(type(self._actor_instance),
                           spec.function_descriptor, None)
            group = (getattr(meth, "__rtpu_method_options__", None)
                     or {}).get("concurrency_group", "")
        return self._group_queues.get(group, self._exec_queue)

    def _consume_exec_queue(self, q: Optional["queue_mod.Queue"] = None
                            ) -> None:
        q = q if q is not None else self._exec_queue
        while not self._shutdown:
            try:
                item = q.get()
            except KeyboardInterrupt:
                continue  # stray cancel interrupt between tasks
            if item is None:
                break
            if len(item) == 3:  # batched push with per-task streaming
                specs, reply_fut, stream = item
                replies = []
                # Results stream out the moment they exist: a later task
                # in THIS batch (or on another worker) may depend on one —
                # withholding results until the whole batch returns
                # deadlocks intra-batch dependencies.  But one loop wakeup
                # per result is a self-pipe syscall each; instead results
                # accumulate in a deque and ONE scheduled drain ships
                # whatever is ready (promptness preserved: the drain runs
                # as soon as the loop wakes, typically within ~10us).
                out_batch: list = []

                def _ship(out_batch=out_batch, stream=stream):
                    if out_batch:
                        stream(out_batch[:])
                        out_batch.clear()
                ready = _BurstQueue(self._loop, out_batch.append, _ship)
                for i, s in enumerate(specs):
                    r = self._exec_one(s)
                    self._track_max_calls(s, r)
                    if i == len(specs) - 1 and self._exit_after_reply:
                        # flag BEFORE the push: the streamed copy is the
                        # only one the owner reads, and the drain races
                        # this thread.  Overshoot is bounded by one
                        # pushed batch: specs already shipped here run.
                        r["worker_exit"] = True
                    replies.append(r)
                    ready.push((s, r))
                self._loop.call_soon_threadsafe(_set_future, reply_fut,
                                                replies)
                if self._exit_after_reply and q.empty():
                    self._schedule_worker_exit()
                continue
            spec, reply_fut = item
            reply = self._exec_one(spec)
            self._track_max_calls(spec, reply)
            if self._exit_after_reply:
                reply["worker_exit"] = True
            while True:
                # commit must survive a late SetAsyncExc interrupt (the
                # extra-exec-thread cancel path has no signal-handler
                # gate): a duplicate push is tolerated downstream, a
                # dropped reply would hang the owner forever
                try:
                    self._result_queue.push((reply_fut, reply))
                    break
                except KeyboardInterrupt:
                    continue
            if self._exit_after_reply and q.empty():
                self._schedule_worker_exit()

    def _track_max_calls(self, spec: TaskSpec, reply) -> None:
        if not getattr(spec, "max_calls", 0) or spec.actor_id is not None:
            return
        if reply.get("cancelled"):
            return  # cancelled while queued: the body never executed
        n = self._fn_exec_counts.get(spec.function_id, 0) + 1
        self._fn_exec_counts[spec.function_id] = n
        if n >= spec.max_calls:
            self._exit_after_reply = True

    def _schedule_worker_exit(self) -> None:
        """Exit AFTER (a) any pending GCS notification (exit_actor's
        kill_actor must land before the death report, or the GCS would
        restart the actor) and (b) every in-flight reply has DRAINED to
        the kernel; the owner already learned from worker_exit in the
        reply, and the raylet reclaims lease resources on death.

        The drain replaces a fixed 0.25 s grace: a large final reply (or
        a slow link) could outlive the grace, and the owner would see
        the connection drop first — misreporting a COMPLETED max_calls
        task as WorkerCrashedError and re-executing it (double side
        effects)."""
        def _arm():
            logger.info("worker exiting: %s",
                        "exit_actor" if self._exit_barrier is not None
                        else "max_calls reached")

            async def _exit_soon():
                barrier = self._exit_barrier
                if barrier is not None:
                    try:
                        await asyncio.wait_for(asyncio.shield(barrier), 5.0)
                    except Exception:  # noqa: BLE001 — exit regardless
                        pass
                await _fp.afailpoint("worker.exit.predrain")
                # the exec thread schedules the reply-future resolution
                # before calling us, but the reply FRAME is only queued
                # once the handler coroutine resumes — drain each owner
                # link (in-flight dispatches done + socket buffers in
                # the kernel) under one shared deadline
                deadline = self._loop.time() + 2.0
                server = self.task_server
                for conn in (list(server.connections) if server else []):
                    remaining = deadline - self._loop.time()
                    if remaining <= 0:
                        break
                    await conn.drain_outbound(remaining)
                os._exit(0)
            self._loop.create_task(_exit_soon())
        self._loop.call_soon_threadsafe(_arm)

    def _start_extra_exec_threads(self, n: int) -> None:
        for _ in range(n):
            t = threading.Thread(target=self._consume_exec_queue,
                                 name="rtpu-exec", daemon=True)
            t.start()
            self._exec_threads.append(t)

    def _start_concurrency_groups(self, groups: Dict[str, int]) -> None:
        """One dedicated queue + thread pool per named group."""
        for name, n_threads in groups.items():
            gq: "queue_mod.Queue" = queue_mod.Queue()
            self._group_queues[name] = gq
            for _ in range(max(1, int(n_threads))):
                t = threading.Thread(
                    target=self._consume_exec_queue, args=(gq,),
                    name=f"rtpu-exec-{name}", daemon=True)
                t.start()
                self._exec_threads.append(t)

    async def handle_cancel_task(self, conn, data):
        """Owner -> executing-worker cancel RPC (parity: reference
        CoreWorker::HandleCancelTask / _raylet.pyx:713).

        Running task: raise KeyboardInterrupt inside its exec thread
        (PyThreadState_SetAsyncExc — the CPython equivalent of the
        reference's Cython-level interrupt).  Queued task: marked so it
        returns a cancelled reply instead of starting.  ``force``: the
        whole worker process exits — the owner observes the connection
        drop and settles the task as cancelled; the raylet's worker
        death handling reclaims the lease.  ``recursive``: cancel the
        children this worker owns (tasks submitted from inside the
        cancelled task) first."""
        import ctypes

        tid_bin = data["task_id"]
        if data.get("recursive"):
            for child in self._children.pop(tid_bin, []):
                try:
                    self.cancel_task(child, force=bool(data.get("force")),
                                     recursive=True)
                except ValueError:
                    # force on an actor-task child: soft-cancel instead
                    self.cancel_task(child, recursive=True)
        running = False
        with self._exec_track_lock:
            for thread_id, executing in self._executing_by_thread.items():
                if executing == tid_bin:
                    running = True
                    self._interrupted_tasks.add(tid_bin)
                    if thread_id == threading.main_thread().ident:
                        # the primary exec loop IS the worker's main
                        # thread (worker_main.py): a REAL signal (not
                        # PyThreadState_SetAsyncExc) is required to
                        # interrupt a blocking C call like time.sleep —
                        # pthread_kill gives the thread EINTR and
                        # Python's default SIGINT handler then raises
                        # KeyboardInterrupt in the main thread (PEP 475
                        # re-raise instead of retry).  This matches the
                        # reference's cancel semantics (_raylet.pyx:713)
                        import signal as signal_mod
                        try:
                            signal_mod.pthread_kill(
                                thread_id, signal_mod.SIGINT)
                        except (OSError, RuntimeError, ValueError):
                            ctypes.pythonapi.PyErr_SetInterrupt()
                    else:
                        # extra exec threads (max_concurrency > 1):
                        # async exc lands at the next bytecode boundary
                        ctypes.pythonapi.PyThreadState_SetAsyncExc(
                            ctypes.c_ulong(thread_id),
                            ctypes.py_object(KeyboardInterrupt))
                    break
            else:
                self._cancelled_exec.add(tid_bin)
                if len(self._cancelled_exec) > 4096:
                    self._cancelled_exec.pop()
        if data.get("force") and running:
            # kill only when the task is actually EXECUTING here: a
            # queued (or already-finished) target is handled by the
            # soft mark above, and unrelated tasks sharing this worker
            # must not die for it.  Brief delay lets this reply (and
            # any streamed results) flush before the process dies.
            self._loop.call_later(0.05, os._exit, 1)
        return {"running": running}

    def _install_stream_emitter(self, spec: TaskSpec, conn) -> None:
        """Executor side of num_returns="streaming": each yielded item
        is pushed to the owner on the task's own connection the moment
        it is posted (FIFO: items always precede the final reply)."""
        if not spec.stream_returns:
            return
        tid_bin = spec.task_id.binary()

        def emit(index: int, dyn_id_bin: bytes, result: tuple,
                 _conn=conn, _tid=tid_bin):
            self._loop.call_soon_threadsafe(
                _conn.push, "dynamic_items",
                [(_tid, index, dyn_id_bin, result)])

        self._stream_emitters[tid_bin] = emit

    async def handle_push_task(self, conn, data):
        if self._exit_after_reply:
            # the exit decision is made: never accept new work (a task
            # accepted here could be killed mid-run by the exit timer)
            return {"rejected": "worker exiting", "worker_exit": True}
        spec: TaskSpec = pickle.loads(data["spec_blob"])
        self._install_stream_emitter(spec, conn)
        reply_fut = self._loop.create_future()
        # enqueue synchronously (before any await) to preserve arrival order
        self._exec_queue.put((spec, reply_fut))
        return await reply_fut

    async def handle_push_tasks(self, conn, data):
        """Batched variant of push_task: one frame, one exec handoff.
        Each task's result is PUSHED back as it completes (see
        _consume_exec_queue); the final reply carries the full list as
        the authoritative completion for bookkeeping."""
        if self._exit_after_reply or (
                _fp.active()
                and _fp.failpoint("worker.push_tasks.reject")):
            # failpoint: force the exiting-worker rejection reply — the
            # production trigger (a batch racing the max_calls exit
            # decision) is a sub-millisecond window no test can hit
            # deterministically
            return {"rejected": "worker exiting", "worker_exit": True}
        specs: List[TaskSpec] = pickle.loads(data["specs_blob"])
        for spec in specs:
            self._install_stream_emitter(spec, conn)
        reply_fut = self._loop.create_future()

        def stream(items: List[Tuple[TaskSpec, Dict[str, Any]]]) -> None:
            conn.push("task_results", [
                (s.task_id.binary(), s.attempt_number, r)
                for s, r in items])

        self._exec_queue.put((specs, reply_fut, stream))
        await reply_fut
        # results already streamed (FIFO before this reply); the ack
        # only closes the call — shipping the replies again would double
        # the bandwidth of every inline result
        return {"acked": len(specs)}

    async def handle_push_actor_task(self, conn, data):
        if self._actor_instance is None:
            return {"actor_dead": True, "reason": "no actor in this worker"}
        spec: TaskSpec = pickle.loads(data["spec_blob"])
        caller = spec.owner_address[3] if spec.owner_address else ""
        cache_key = (caller, spec.sequence_number, spec.task_id.binary())
        cached = self._actor_reply_cache.get(cache_key)
        if cached is not None:  # duplicate delivery after a retry
            return cached
        reply_fut = self._loop.create_future()
        self._exec_queue_for(spec).put((spec, reply_fut))
        reply = await reply_fut
        self._cache_actor_reply(cache_key, reply)
        return reply

    def _cache_actor_reply(self, cache_key: tuple, reply) -> None:
        self._actor_reply_cache[cache_key] = reply
        if len(self._actor_reply_cache) > 1024:
            self._actor_reply_cache.pop(next(iter(self._actor_reply_cache)))

    async def handle_push_actor_tasks(self, conn, data):
        """Batched actor-call frame: each task's result is PUSHED back as
        it completes (``actor_task_results``); the final reply only acks.
        Specs enqueue per-task (not as one exec unit) so concurrency
        groups (max_concurrency > 1) still execute them in parallel."""
        if self._actor_instance is None:
            return {"actor_dead": True, "reason": "no actor in this worker"}
        specs: List[TaskSpec] = pickle.loads(data["specs_blob"])
        out_batch: list = []

        def _ship():
            if out_batch:
                conn.push("actor_task_results", out_batch[:])
                out_batch.clear()

        ready = _BurstQueue(self._loop, out_batch.append, _ship)
        waiters = []
        cached_out = []
        for spec in specs:
            caller = spec.owner_address[3] if spec.owner_address else ""
            cache_key = (caller, spec.sequence_number,
                         spec.task_id.binary())
            cached = self._actor_reply_cache.get(cache_key)
            if cached is not None:
                # duplicate delivery after a retry: pushed directly (not
                # via the burst queue) so an ALL-cached batch still puts
                # its results on the wire BEFORE the ack below — the
                # sender treats results-after-ack as a lost push and
                # would retry successfully-executed tasks forever
                cached_out.append((spec.task_id.binary(),
                                   spec.attempt_number, cached))
                continue
            reply_fut = self._loop.create_future()

            def _done(f, spec=spec, key=cache_key):
                if f.cancelled():
                    return
                reply = f.result()
                self._cache_actor_reply(key, reply)
                ready.push((spec.task_id.binary(), spec.attempt_number,
                            reply))

            reply_fut.add_done_callback(_done)
            waiters.append(reply_fut)
            self._exec_queue_for(spec).put((spec, reply_fut))
        if cached_out:
            conn.push("actor_task_results", cached_out)
        if waiters:
            await asyncio.gather(*waiters)
        return {"acked": len(specs)}

    async def handle_create_actor(self, conn, data):
        spec: TaskSpec = pickle.loads(data["spec_blob"])
        # Seed caches from the raylet's node-level prefetch so this worker
        # skips its own GCS round trips.  Syspath FIRST: unpickling a
        # driver-module class by reference needs the driver's import paths.
        sp_blob = data.get("syspath_blob")
        if sp_blob is not None and data.get("syspath_job") is not None:
            try:
                self._merge_syspath(JobID(data["syspath_job"]), sp_blob)
            except Exception:
                logger.debug("prefetched syspath blob unusable",
                             exc_info=True)
        fn_blob = data.get("function_blob")
        if fn_blob is not None and spec.function_id not in self._function_cache:
            # raw bytes only here: cloudpickle.loads of a user class can
            # trigger seconds of module imports, which must happen on the
            # exec thread (_get_function), never on this io loop
            self._function_blobs[spec.function_id] = fn_blob
        reply_fut = self._loop.create_future()
        self._exec_queue.put((spec, reply_fut))
        reply = await reply_fut
        if reply.get("app_error") or reply.get("system_error"):
            return {"ok": False,
                    "error": reply.get("system_error", "constructor raised")}
        creation = spec.actor_creation_spec or ActorCreationSpec()
        self._actor_id = spec.actor_id
        self._actor_creation_spec = creation
        self._max_concurrency = max(1, creation.max_concurrency)
        if self._max_concurrency > 1:
            self._start_extra_exec_threads(self._max_concurrency - 1)
        if creation.concurrency_groups:
            self._start_concurrency_groups(creation.concurrency_groups)
        # register on our own GCS connection so the GCS can detect death
        # of this actor when the connection drops.  Fired without awaiting:
        # the reply carries nothing, and blocking actor creation on a GCS
        # round trip serialized creation storms on GCS latency (liveness
        # is already established by the scheduler's lease grant).
        try:
            fut = self.gcs_conn.start_call("actor_started", {
                "actor_id": spec.actor_id.binary(),
                "task_address": self.task_address,
            })
            fut.add_done_callback(
                lambda f: f.exception() if not f.cancelled() else None)
        except rpc.ConnectionLost:
            pass
        return {"ok": True}

    def _cancelled_reply(self, spec: TaskSpec) -> Dict[str, Any]:
        blob = serialize_exception(
            TaskCancelledError(spec.debug_name())).to_bytes()
        return {"results": [(rid.binary(), "inline", blob)
                            for rid in spec.return_ids()],
                "app_error": True, "cancelled": True}

    def _execute_task(self, spec: TaskSpec) -> Dict[str, Any]:
        """Run one task on this thread; returns the wire reply."""
        tid_bin = spec.task_id.binary()
        with self._exec_track_lock:
            if tid_bin in self._cancelled_exec:
                # cancelled while queued: never starts (drop any
                # streaming emitter installed at push time — the
                # finally below is never reached)
                self._cancelled_exec.discard(tid_bin)
                self._stream_emitters.pop(tid_bin, None)
                return self._cancelled_reply(spec)
            ident = threading.get_ident()
            self._executing_by_thread[ident] = tid_bin
            self._executing_info[ident] = (
                spec.function_descriptor, spec.task_id.hex(),
                spec.actor_id.hex() if spec.actor_id else None,
                spec.job_id.hex() if spec.job_id else None)
        if _flight.enabled():
            # last-executing identity: the frame a postmortem reads
            # first when this worker dies mid-task
            _flight.record(
                "task_start",
                f"{spec.function_descriptor} task={spec.task_id.hex()[:16]}"
                f" actor={spec.actor_id.hex()[:16] if spec.actor_id else '-'}"
                f" job={spec.job_id.hex() if spec.job_id else '-'}"
                f" attempt={spec.attempt_number}")
        _fl_status = "error"  # overwritten on every non-raising path
        exec_t0 = None  # stamped AFTER arg resolution (fetch != exec)
        espan = None  # executor-side trace span (traced tasks only)
        trace_token = None  # ambient-context reset token (outer finally)
        prev = (self._ctx.task_id, self._ctx.put_counter,
                self._ctx.attempt_number, self._ctx.current_resources)
        self._ctx.task_id = spec.task_id
        self._ctx.put_counter = _Counter()
        self._ctx.attempt_number = spec.attempt_number
        if self.job_id is None:
            self.job_id = spec.job_id
        self._ctx.current_resources = dict(spec.resources)
        try:
            INTERRUPT_WINDOW.open = True
            self._apply_job_syspath(spec.job_id)
            self._ensure_runtime_env(spec)
            args, kwargs = self._resolve_args(spec)
            # body start: env setup + network arg pulls above belong to
            # the analyzer's 'fetch' phase, not 'exec'
            exec_t0 = time.time()
            # device-seconds attribution: StepMonitors accumulate this
            # thread's device-compute time; the body-interval delta
            # rides the task_exec span so the analyzer can split exec
            # into exec_host / exec_device
            dev_s0 = _dt.device_seconds()
            fn = self._resolve_callable(spec)
            # native trace context: the executor span becomes the body's
            # ambient parent, so nested submissions / serve batcher
            # spans nest UNDER the exec hop (keeps the phase rollup
            # telescoping instead of double-counting siblings).  Gated
            # on THIS process's switch too: a node with tracing
            # disabled must pay nothing even for spec-carried contexts
            # (same contract as rpc._dispatch).
            nctx = _trace.ctx_of(spec.trace_context) \
                if _trace.enabled() else None
            if nctx is not None:
                espan = _trace.start_span(
                    f"exec:{spec.function_descriptor}", parent=nctx,
                    task_id=spec.task_id.hex()[:16],
                    attempt=spec.attempt_number)
                # reset in the OUTER finally, not here: an async body
                # only runs inside asyncio.run below (calling fn merely
                # built the coroutine), and dynamic-returns generators
                # resume in _post_dynamic_returns — both must still see
                # the ambient context or their nested submissions fall
                # off the trace
                trace_token = _trace.set_current(espan.ctx())
            if spec.trace_context is not None \
                    and "traceparent" in spec.trace_context:
                # opt-in OTel half (separate exporter pipeline)
                from ray_tpu_torch.util.tracing.tracing_helper import \
                    execute_with_trace
                value = execute_with_trace(
                    fn, spec.function_descriptor, spec.trace_context,
                    *args, **kwargs)
            else:
                value = fn(*args, **kwargs)
            if inspect.iscoroutine(value):
                # inspect (not asyncio) iscoroutine: before 3.11 the
                # asyncio variant also matched plain GENERATORS (legacy
                # generator-coroutines), feeding streaming task bodies
                # to asyncio.run -> "Task got bad yield"
                value = asyncio.run(value)
            if spec.dynamic_returns:
                # the generator BODY runs inside _post_dynamic_returns
                # (calling fn only created the generator object), so the
                # cancel-interrupt window must stay open through the
                # iteration — it closes in there before results commit
                _fl_status = "ok"
                return self._post_dynamic_returns(spec, value)
            # body done: results are being committed from here on — a
            # cancel interrupt landing now must not drop them
            INTERRUPT_WINDOW.open = False
            _fl_status = "ok"
            if spec.task_type == TaskType.ACTOR_CREATION_TASK:
                results = [(rid.binary(), "inline", serialize(None).to_bytes())
                           for rid in spec.return_ids()]
                return {"results": results}
            if spec.num_returns == 1:
                values = [value]
            else:
                values = list(value)
                if len(values) != spec.num_returns:
                    raise ValueError(
                        f"task returned {len(values)} values, expected "
                        f"{spec.num_returns}")
            results = []
            for rid, v in zip(spec.return_ids(), values):
                results.append(self._post_return(rid, v, spec))
            return {"results": results}
        except BaseException as e:  # noqa: BLE001 — errors travel to caller
            if espan is not None:
                # the finally's end() is then a no-op: a failed body
                # must not render as an ok exec hop in the trace tree
                espan.end(status="error", error=type(e).__name__)
            if (isinstance(e, KeyboardInterrupt)
                    and tid_bin in self._interrupted_tasks):
                # cancel-driven interrupt (handle_cancel_task raised it
                # into this thread), not a user Ctrl-C
                self._interrupted_tasks.discard(tid_bin)
                _fl_status = "cancelled"
                return self._cancelled_reply(spec)
            if isinstance(e, ActorExitRequest):
                _fl_status = "exit"
                return self._actor_exit_reply(spec)
            logger.debug("task %s raised", spec.debug_name(), exc_info=True)
            blob = serialize_exception(
                TaskError.from_exception(e, spec.debug_name())).to_bytes()
            results = [(rid.binary(), "inline", blob)
                       for rid in spec.return_ids()]
            return {"results": results, "app_error": True}
        finally:
            INTERRUPT_WINDOW.open = False
            # executor-side exec span: the analyzer splits RUNNING ->
            # FINISHED into fetch/exec/reply phases with this (spans
            # are clock-corrected at drain, same timebase as events).
            # exec_t0 is None when env/arg resolution itself failed —
            # no body ran, so no span.
            if exec_t0 is not None:
                _tm.record_span("task_exec", spec.function_descriptor,
                                exec_t0, time.time(),
                                task_id=spec.task_id.hex(),
                                attempt=spec.attempt_number,
                                job=spec.job_id.hex() if spec.job_id
                                else None,
                                device_s=round(
                                    _dt.device_seconds() - dev_s0, 6))
                # per-job attribution: body seconds + task count roll
                # up by tenant (ray_tpu_job_* series, `top --jobs`)
                _tm.job_task_finished(
                    spec.job_id.hex() if spec.job_id else None,
                    time.time() - exec_t0)
            if trace_token is not None:
                _trace.reset_current(trace_token)
            if espan is not None:
                # executor-side hop of the request's trace tree
                # (parent = the owner's task span); a failed body
                # already ended it with status=error (end is idempotent)
                espan.end()
            if _flight.enabled():
                _flight.record(
                    "task_finish",
                    f"{spec.function_descriptor} "
                    f"task={spec.task_id.hex()[:16]} {_fl_status}")
            (self._ctx.task_id, self._ctx.put_counter,
             self._ctx.attempt_number, self._ctx.current_resources) = prev
            with self._exec_track_lock:
                ident = threading.get_ident()
                self._executing_by_thread.pop(ident, None)
                self._executing_info.pop(ident, None)
                self._interrupted_tasks.discard(tid_bin)
            self._stream_emitters.pop(tid_bin, None)  # errored pre-yield

    def _post_dynamic_returns(self, spec: TaskSpec, value: Any
                              ) -> Dict[str, Any]:
        """num_returns="dynamic" (parity: _raylet.pyx:603-622,946): the
        task body is a generator; each yielded value becomes its own
        object (stored as the owner's, with a deterministic id so
        lineage reconstruction regenerates it), and the task's single
        declared return resolves to an ObjectRefGenerator over them."""
        from ray_tpu_torch.core.object_ref import ObjectRefGenerator

        emit = self._stream_emitters.pop(spec.task_id.binary(), None)
        results = []
        refs = []
        for i, item in enumerate(value):
            # still USER code (the generator body resumes per item):
            # leave the cancel-interrupt window open while iterating,
            # close it around each commit so an interrupt cannot drop a
            # produced entry
            INTERRUPT_WINDOW.open = False
            rid = spec.dynamic_return_id(i)
            entry = self._post_return(rid, item, spec)
            results.append(entry)
            if emit is not None:
                # streaming: announce the item NOW — the owner's
                # generator hands out its ref while we keep iterating
                emit(i, rid.binary(), entry)
            refs.append(ObjectRef(rid, spec.owner_address,
                                  _register=False))
            INTERRUPT_WINDOW.open = True
        INTERRUPT_WINDOW.open = False  # commit phase
        gen_id = spec.return_ids()[0]
        gen = ObjectRefGenerator(refs)
        # the generator handle is listed LAST: the owner registers the
        # dynamic ids as owned before any consumer can see their refs
        results.append(self._post_return(gen_id, gen, spec))
        return {"results": results,
                "dynamic_return_ids": [r.id().binary() for r in refs]}

    def _post_return(self, object_id: ObjectID, value: Any,
                     spec: TaskSpec) -> Tuple[bytes, str, Any]:
        ser = serialize(value)
        if ser.total_size() <= self.config.max_direct_call_object_size:
            return (object_id.binary(), "inline", ser.to_bytes())
        # large return: store in this node's shm; owner learns the location
        async def _store():
            size = ser.total_size()
            reply = await self.raylet_conn.call(
                "object_create",
                {"object_id": object_id.binary(), "size": size})
            view = self.store_client.view(reply["offset"], size)
            ser.write_to(view)
            await self.raylet_conn.call("object_seal", {
                "object_id": object_id.binary(),
                "owner_address": spec.owner_address,
            })
        self._run(_store())
        return (object_id.binary(), "plasma", tuple(self.raylet_address))

    def _resolve_args(self, spec: TaskSpec) -> Tuple[list, dict]:
        resolved: List[Any] = []
        empty_kwargs = _empty_kwargs_arg().value_bytes
        for arg in spec.args:
            if arg.is_inline():
                if arg.value_bytes == empty_kwargs:
                    resolved.append({})
                    continue
                value, is_exc = deserialize(arg.value_bytes)
                if is_exc:
                    raise value.cause or value
                resolved.append(value)
            else:
                ref = ObjectRef._restore(arg.object_id.binary(),
                                         arg.owner_address)
                resolved.append(self.get([ref])[0])
        kwargs = resolved.pop() if resolved else {}
        return resolved, kwargs

    def _resolve_callable(self, spec: TaskSpec) -> Callable:
        if spec.task_type == TaskType.ACTOR_TASK:
            method = getattr(self._actor_instance, spec.function_descriptor,
                             None)
            if method is None:
                raise AttributeError(
                    f"actor has no method {spec.function_descriptor!r}")
            return method
        fn_or_class = self._get_function(spec.function_id)
        if spec.task_type == TaskType.ACTOR_CREATION_TASK:
            def _construct(*args, **kwargs):
                self._actor_instance = fn_or_class(*args, **kwargs)
                return None
            return _construct
        return fn_or_class

    def _ensure_runtime_env(self, spec: TaskSpec) -> None:
        if not spec.runtime_env:
            return
        mgr = getattr(self, "_runtime_env_mgr", None)
        if mgr is None:
            from ray_tpu_torch.runtime_env import RuntimeEnvManager
            mgr = RuntimeEnvManager(
                lambda key, ns: self.kv_get(key, namespace=ns))
            self._runtime_env_mgr = mgr
        mgr.ensure_applied(spec.runtime_env)

    def _apply_job_syspath(self, job_id: Optional[JobID]) -> None:
        """Merge the driver's import paths into this worker (parity: the
        reference's working_dir runtime env) so by-reference pickles of
        driver-side modules can be deserialized."""
        if job_id is None or job_id in self._syspath_applied:
            return
        try:
            blob = self._run(self.gcs_conn.call("kv_get", {
                "key": f"syspath:{job_id.hex()}", "namespace": "_internal"}))
        except (rpc.ConnectionLost, rpc.RpcError):
            return  # transient — retry on the next task
        # mark applied only after a successful fetch
        if not blob:
            self._syspath_applied.add(job_id)
            return
        self._merge_syspath(job_id, blob)

    def _merge_syspath(self, job_id: JobID, blob: bytes) -> None:
        """Merge a pickled driver path list into sys.path, once per job.
        Single merge implementation for both the GCS-fetch path and the
        raylet-prefetch seed in handle_create_actor."""
        if job_id in self._syspath_applied:
            return
        import sys as _sys

        for p in cloudpickle.loads(blob):
            if p not in _sys.path and os.path.isdir(p):
                _sys.path.append(p)
        self._syspath_applied.add(job_id)

    def _get_function(self, function_id: str) -> Callable:
        fn = self._function_cache.get(function_id)
        if fn is None:
            # raylet-prefetched blob (actor creation) decodes here on the
            # exec thread; otherwise fetch from the GCS function table
            blob = self._function_blobs.pop(function_id, None)
            if blob is None:
                blob = self._run(self.gcs_conn.call(
                    "get_function", {"function_id": function_id}))
            if blob is None:
                raise RayTpuError(f"function {function_id} not registered")
            fn = cloudpickle.loads(blob)
            self._function_cache[function_id] = fn
        return fn

    def push_lease_gpu_ids(self, conn, data) -> None:
        """Raylet tells this worker which GPUs its lease holds."""
        self._lease_gpu_ids = list(data.get("ids", []))

    def current_gpu_ids(self) -> List[int]:
        return list(self._lease_gpu_ids)

    def push_kill_actor(self, conn, data) -> None:
        """Forced actor kill (GCS or owner initiated)."""
        logger.info("actor %s killed", data.get("actor_id", b"").hex()[:12])
        os._exit(1)

    def push_exit(self, conn, data) -> None:
        """Graceful exit request from the raylet (idle worker culling)."""
        self._shutdown = True
        self._exec_queue.put(None)


def _set_future(fut: asyncio.Future, value: Any) -> None:
    if not fut.done():
        fut.set_result(value)


class _BurstQueue:
    """Cross-thread deque + scheduled-drain flag: the wakeup-elision
    protocol shared by task submission, GC ref releases, and worker-side
    result streaming.

    Invariants (all three call sites depend on these — fix races HERE):
    - producer: ``append`` then check-flag; ``deque.append`` is
      GC-reentrancy-safe so finalizers may push.
    - the first push of a burst pays one ``call_soon_threadsafe``
      (self-pipe write); while the burst lasts, the drain re-polls each
      loop tick via plain ``call_soon`` with the flag left True.
    - the flag is repaired in a ``finally`` so an exception from
      ``on_item``/``on_flush`` can never strand queued items.
    - the closed race (append between the final popleft and the flag
      clear) is caught by re-checking the deque after clearing.
    """

    __slots__ = ("_q", "_scheduled", "_loop", "_on_item", "_on_flush")

    def __init__(self, loop, on_item: Callable[[Any], None],
                 on_flush: Optional[Callable[[], None]] = None):
        self._q: deque = deque()
        self._scheduled = False
        self._loop = loop
        self._on_item = on_item
        self._on_flush = on_flush

    def push(self, item: Any) -> None:
        """Any thread.  Raises if the loop is torn down (after restoring
        the flag so a later push can try again)."""
        self._q.append(item)
        if not self._scheduled:
            self._scheduled = True
            try:
                self._loop.call_soon_threadsafe(self._drain)
            except (RuntimeError, AttributeError):
                self._scheduled = False
                raise

    def _drain(self) -> None:
        q = self._q
        drained = 0
        try:
            try:
                while True:
                    try:
                        item = q.popleft()
                    except IndexError:
                        break
                    drained += 1
                    self._on_item(item)
            finally:
                if drained and self._on_flush is not None:
                    self._on_flush()
        finally:
            if drained:
                self._loop.call_soon(self._drain)
            else:
                self._scheduled = False
                if q:
                    self._scheduled = True
                    self._loop.call_soon(self._drain)


class _StreamState:
    """Owner-side progress of one streaming-returns task."""

    __slots__ = ("cond", "dyn_ids", "done", "error", "consumed")

    def __init__(self):
        self.cond = threading.Condition()
        self.dyn_ids: List[bytes] = []
        self.done = False
        self.error: Optional[BaseException] = None
        #: items the consumer turned into ObjectRefs (those are governed
        #: by normal refcounting; anything past this index has NO refs)
        self.consumed = 0


class _PendingMarker:
    pass


class _LeasedWorker:
    __slots__ = ("worker_id", "address", "raylet", "inflight",
                 "return_handle", "contended", "fn_calls", "token")

    def __init__(self, worker_id: WorkerID, address: rpc.Address,
                 raylet: rpc.Address, contended: bool = False,
                 token: Optional[str] = None):
        self.worker_id = worker_id
        self.address = address
        self.raylet = raylet
        # the acquiring lease request's token: keys the eventual
        # return_worker so a RETRIED return can never settle a newer
        # lease of the same worker
        self.token = token
        self.inflight = 0
        self.return_handle = None
        # granted while other demand queued at the raylet: hand the
        # worker back the moment it idles (skip the idle-lease grace)
        self.contended = contended
        # dispatched executions per function_id, mirroring the worker's
        # max_calls accounting so pipelining never overshoots the cap
        self.fn_calls: Dict[str, int] = {}


class _LeaseState:
    __slots__ = ("key", "backlog", "workers", "requesting",
                 "inflight_requests")

    def __init__(self, key):
        self.key = key
        self.backlog: deque = deque()
        self.workers: Dict[WorkerID, _LeasedWorker] = {}
        self.requesting = 0  # outstanding lease-request chains
        # token -> raylet address currently asked (for cancel_lease)
        self.inflight_requests: Dict[str, rpc.Address] = {}


class _ActorSubmitState:
    __slots__ = ("actor_id", "address", "next_seq", "pending", "queue",
                 "sender_task", "register_fut", "subscribed",
                 "resolve_event", "dead_cause")

    def __init__(self, actor_id: ActorID):
        self.actor_id = actor_id
        self.address: Optional[rpc.Address] = None
        self.next_seq = 0
        self.pending: Dict[int, TaskSpec] = {}
        self.queue: deque = deque()
        self.sender_task: Optional[asyncio.Task] = None
        # async-registration ack (unnamed actors); resolvers await it
        self.register_fut = None
        # actor-channel pubsub (event-driven address resolution)
        self.subscribed = False
        self.resolve_event: Optional[asyncio.Event] = None
        self.dead_cause: Optional[str] = None


def _deserialize_pinned(view: memoryview, pin: _Pin):
    """Deserialize with out-of-band buffers wrapped in _PinnedBuffer so the
    store slot stays pinned while any consumer is alive.

    The zero-copy wrapper relies on PEP 688 (``__buffer__``), which the
    interpreter only honors for Python classes from 3.12 on.  On older
    runtimes consumers (e.g. ``np.frombuffer``) reject the wrapper, so
    each buffer is copied out instead — correctness over zero-copy."""
    import pickle
    import struct as struct_mod
    import sys as sys_mod
    from ray_tpu_torch.core import serialization as ser_mod

    zero_copy = sys_mod.version_info >= (3, 12)
    magic = ser_mod._MAGIC
    if bytes(view[: len(magic)]) != magic:
        raise ValueError("corrupt serialized object (bad magic)")
    offset = len(magic)
    (meta_len,) = struct_mod.unpack_from("<I", view, offset)
    offset += 4
    meta = bytes(view[offset : offset + meta_len])
    offset += meta_len
    (n_buffers,) = struct_mod.unpack_from("<I", view, offset)
    offset += 4
    buffers = []
    for _ in range(n_buffers):
        (buf_len,) = struct_mod.unpack_from("<Q", view, offset)
        offset = ser_mod._pad(offset + 8)
        chunk = view[offset : offset + buf_len]
        buffers.append(_PinnedBuffer(chunk, pin) if zero_copy
                       else bytes(chunk))
        offset += buf_len
    is_exception = meta.endswith(ser_mod.META_EXCEPTION)
    if is_exception:
        meta = meta[: -len(ser_mod.META_EXCEPTION)]
    value = ser_mod._unpickle(meta, buffers)
    return value, is_exception
