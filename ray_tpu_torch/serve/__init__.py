"""ray_tpu_torch.serve — model serving on the actor substrate.

Parity: reference ``python/ray/serve`` — ``@serve.deployment``,
``serve.run``, handles, batching, autoscaling, HTTP ingress.
"""

from __future__ import annotations

import functools
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Union

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch._port import reject_tpu_options
from ray_tpu_torch.serve._internal import (CONTROLLER_NAME, DeploymentConfig,
                                     Router, ServeController)

_router: Optional[Router] = None
_router_lock = threading.Lock()


def start(detached: bool = True) -> Any:
    """Start (or connect to) the Serve controller (parity: serve.start)."""
    try:
        return ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        pass
    controller = ServeController.options(
        name=CONTROLLER_NAME, lifetime="detached",
        max_concurrency=16).remote()
    ray_tpu_torch.get(controller.list_deployments.remote(), timeout=60)
    return controller


_router_core = None


def _get_router() -> Router:
    global _router, _router_core
    from ray_tpu_torch.core import worker as _worker_mod
    core = _worker_mod.global_worker()
    with _router_lock:
        # a cached router is only valid for the cluster it was built on —
        # reconnecting (tests, notebooks) must rebuild against the new
        # controller
        if _router is None or _router_core is not core:
            if _router is not None:
                _router.stop()  # retire the stale cluster's poll thread
            # lazy-init double-checked lock: the blocking bootstrap RPC
            # runs at most once per cluster, and every waiter NEEDS the
            # router it produces — serializing them is the point
            # rtpu-check: disable=lock-order-cycle
            _router = Router(start())
            _router_core = core
        return _router


def _stop_router() -> None:
    """Retire the process-wide router (poll thread + cache).  Called from
    ``serve.shutdown()`` and from ``ray_tpu_torch.shutdown()``."""
    global _router, _router_core
    with _router_lock:
        if _router is not None:
            _router.stop()
        _router = None
        _router_core = None


def shutdown() -> None:
    _stop_router()
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
        ray_tpu_torch.get(controller.graceful_shutdown.remote(), timeout=30)
        ray_tpu_torch.kill(controller)
    except ValueError:
        pass


class _SlotWaiter:
    """ONE shared background thread releasing router slots as results
    land.  Replaces the old thread-per-request waiter (a daemon thread
    per in-flight request collapses under load: 10k in-flight requests
    was 10k threads).  Completions drain in batches through a single
    ``ray_tpu_torch.wait`` over everything outstanding."""

    _MAX_WAIT_S = 3600.0  # a ref that never resolves still frees its slot

    def __init__(self):
        self._lock = threading.Lock()
        self._pending: Dict[ray_tpu_torch.ObjectRef, tuple] = {}
        self._wake = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def add(self, router, key, ref: ray_tpu_torch.ObjectRef) -> None:
        with self._lock:
            self._pending[ref] = (router, key, time.monotonic())
            if self._thread is None or not self._thread.is_alive():
                self._thread = threading.Thread(
                    target=self._run, name="rtpu-serve-waiter", daemon=True)
                self._thread.start()
        self._wake.set()

    def _run(self) -> None:
        while True:
            with self._lock:
                refs = list(self._pending)
            if not refs:
                self._wake.wait(timeout=1.0)
                self._wake.clear()
                continue
            done: List[ray_tpu_torch.ObjectRef] = []
            try:
                # short timeout on purpose: the wait covers a SNAPSHOT
                # of pending refs, and refs added while it blocks are
                # invisible to it — a long block would delay THEIR slot
                # release past the poll period and stall the router's
                # admission (fast requests queueing behind slow ones)
                ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                        timeout=0.2)
                done.extend(ready)
            except Exception:  # noqa: BLE001 — cluster torn down: every
                done.extend(refs)  # slot frees (router is stale anyway)
            now = time.monotonic()
            with self._lock:
                for ref in refs:
                    entry = self._pending.get(ref)
                    if entry is None:
                        continue
                    if ref in done or now - entry[2] > self._MAX_WAIT_S:
                        self._pending.pop(ref, None)
                        try:
                            entry[0].release(entry[1])
                        except Exception:  # noqa: BLE001
                            pass


_slot_waiter = _SlotWaiter()


class DeploymentHandle:
    """Parity: reference ``serve/handle.py`` RayServeHandle."""

    def __init__(self, deployment_name: str, method_name: str = "__call__"):
        self._name = deployment_name
        self._method = method_name

    def options(self, *, method_name: str) -> "DeploymentHandle":
        return DeploymentHandle(self._name, method_name)

    def __getattr__(self, name: str) -> "DeploymentHandle":
        if name.startswith("_"):
            raise AttributeError(name)
        return DeploymentHandle(self._name, name)

    def remote(self, *args, _deadline_s: Optional[float] = None,
               _request_id: Optional[str] = None,
               **kwargs) -> ray_tpu_torch.ObjectRef:
        """Fast path: one dispatch to a routed replica; the returned ref
        errors if that replica dies mid-request (use :meth:`call`, or
        the HTTP ingress, for transparent retry-on-death).

        On a disaggregated deployment the request CHAINS: the prompt
        pass dispatches to a prefill replica, and the decode dispatch
        takes the prefill ref as its argument — still non-blocking,
        with KV pages travelling between the tiers as object refs."""
        router = _get_router()
        prefill_name = router.prefill_for(self._name) \
            if self._method in ("", "__call__") else None
        if prefill_name is not None:
            pre_replica, pre_key = router.assign(prefill_name)
            pre_ref = pre_replica.handle_request.remote(
                "__prefill__", args, kwargs, deadline_s=_deadline_s,
                request_id=_request_id)
            _slot_waiter.add(router, pre_key, pre_ref)
            replica, key = router.assign(self._name)
            ref = replica.handle_request.remote(
                "__decode__", (pre_ref,), {}, deadline_s=_deadline_s,
                request_id=_request_id)
            _slot_waiter.add(router, key, ref)
            return ref
        replica, key = router.assign(self._name)
        ref = replica.handle_request.remote(
            self._method, args, kwargs, deadline_s=_deadline_s,
            request_id=_request_id)
        _slot_waiter.add(router, key, ref)
        return ref

    def call(self, *args, timeout: Optional[float] = None,
             _deadline_s: Optional[float] = None, **kwargs):
        """Blocking request with replica-death retry: a replica that
        dies mid-request is excluded and the request re-dispatches to a
        healthy replica (parity: the reference router's
        retry-on-replica-failure).  Application errors never retry."""
        from ray_tpu_torch.core.config import get_config
        from ray_tpu_torch.core.exceptions import (ActorDiedError,
                                             WorkerCrashedError)
        from ray_tpu_torch.serve.batching import (ModelSwapFailed,
                                            RequestPrefillLost)

        attempts = max(1, int(getattr(get_config(),
                                      "serve_request_retries", 3)))
        router = _get_router()
        prefill_name = router.prefill_for(self._name) \
            if self._method in ("", "__call__") else None
        # multiplexed deployments: steer toward a replica where the
        # request's model is already resident (no weight swap)
        model: Optional[str] = None
        if args and isinstance(args[0], dict) and args[0].get("model"):
            model = str(args[0]["model"])
        exclude: List[bytes] = []
        pre_exclude: List[bytes] = []
        last_err: Optional[BaseException] = None
        for _ in range(attempts):
            method, call_args = self._method, args
            pre_ref = None
            if prefill_name is not None:
                pre_replica, pre_key = router.assign(
                    prefill_name, exclude=tuple(pre_exclude))
                pre_ref = pre_replica.handle_request.remote(
                    "__prefill__", args, kwargs,
                    deadline_s=_deadline_s)
                _slot_waiter.add(router, pre_key, pre_ref)
                method, call_args = "__decode__", (pre_ref,)
            replica, key = router.assign(self._name,
                                         exclude=tuple(exclude),
                                         model=model)
            ref = replica.handle_request.remote(
                method, call_args, {} if pre_ref is not None else kwargs,
                deadline_s=_deadline_s)
            try:
                return ray_tpu_torch.get(ref, timeout=timeout)
            except RequestPrefillLost as e:
                # the prefill result was lost (replica death OR a lost
                # page object); the decode replica is healthy — exclude
                # the prefill pick for this request's retries only (a
                # genuinely dead replica leaves the routing table when
                # the controller reaps it)
                last_err = e
                pre_exclude.append(pre_key[1])
            except ModelSwapFailed as e:
                # the replica couldn't make the model resident: exclude
                # the pick and retry elsewhere WITHOUT marking it dead
                # (its already-resident models keep serving)
                last_err = e
                exclude.append(key[1])
            except (ActorDiedError, WorkerCrashedError) as e:
                # the decode pick died mid-request; exclude it so the
                # retry lands on a survivor
                last_err = e
                exclude.append(key[1])
                router.mark_dead(key)
            finally:
                router.release(key)
        raise last_err  # type: ignore[misc]


class Application:
    """A bound deployment graph node (parity: ``serve.deployment.bind``)."""

    def __init__(self, deployment: "Deployment", args: tuple, kwargs: dict):
        self.deployment = deployment
        self.args = args
        self.kwargs = kwargs


class Deployment:
    """Parity: reference ``serve/deployment.py`` Deployment."""

    def __init__(self, func_or_class: Any, name: str,
                 config: DeploymentConfig):
        self._target = func_or_class
        self.name = name
        self.config = config

    def options(self, *, name: Optional[str] = None,
                num_replicas: Optional[int] = None,
                max_concurrent_queries: Optional[int] = None,
                user_config: Any = None,
                ray_actor_options: Optional[Dict[str, Any]] = None,
                autoscaling_config: Optional[Dict[str, Any]] = None,
                batching: Optional[Dict[str, Any]] = None,
                max_queued_requests: Optional[int] = None,
                num_shards: Optional[int] = None,
                prefill_replicas: Optional[int] = None,
                multiplexed_models: Optional[Dict[str, Any]] = None,
                multiplex_max_resident: Optional[int] = None,
                **_ignored) -> "Deployment":
        reject_tpu_options("ray_actor_options", ray_actor_options or {})
        cfg = DeploymentConfig(
            num_replicas=num_replicas if num_replicas is not None
            else self.config.num_replicas,
            max_concurrent_queries=max_concurrent_queries
            if max_concurrent_queries is not None
            else self.config.max_concurrent_queries,
            user_config=user_config if user_config is not None
            else self.config.user_config,
            ray_actor_options=ray_actor_options
            if ray_actor_options is not None
            else self.config.ray_actor_options,
            autoscaling_config=autoscaling_config
            if autoscaling_config is not None
            else self.config.autoscaling_config,
            batching=batching if batching is not None
            else self.config.batching,
            max_queued_requests=max_queued_requests
            if max_queued_requests is not None
            else self.config.max_queued_requests,
            num_shards=num_shards if num_shards is not None
            else self.config.num_shards,
            prefill_replicas=prefill_replicas
            if prefill_replicas is not None
            else self.config.prefill_replicas,
            multiplexed_models=multiplexed_models
            if multiplexed_models is not None
            else self.config.multiplexed_models,
            multiplex_max_resident=multiplex_max_resident
            if multiplex_max_resident is not None
            else self.config.multiplex_max_resident,
        )
        return Deployment(self._target, name or self.name, cfg)

    def bind(self, *args, **kwargs) -> Application:
        return Application(self, args, kwargs)

    def deploy(self, *init_args, **init_kwargs) -> DeploymentHandle:
        controller = start()
        blob = cloudpickle.dumps(self._target)
        version = ray_tpu_torch.get(controller.deploy.remote(
            self.name, blob, init_args, init_kwargs, self.config), timeout=60)
        _wait_for_replicas(controller, self.name, self.config, version)
        return DeploymentHandle(self.name)

    def get_handle(self) -> DeploymentHandle:
        return DeploymentHandle(self.name)


def _wait_for_replicas(controller, name: str, config: DeploymentConfig,
                       version: int, timeout: float = 120.0) -> None:
    target = config.num_replicas
    if config.autoscaling_config:
        target = config.autoscaling_config.get("min_replicas", 1)
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        deps = ray_tpu_torch.get(controller.list_deployments.remote(), timeout=30)
        info = deps.get(name)
        if info and info["num_replicas"] >= target and \
                info["version"] == version and \
                info.get("stale_replicas", 0) == 0:
            return
        time.sleep(0.05)
    raise TimeoutError(f"deployment {name} did not reach {target} replicas")


def deployment(func_or_class: Any = None, *, name: Optional[str] = None,
               num_replicas: int = 1, max_concurrent_queries: int = 100,
               user_config: Any = None,
               ray_actor_options: Optional[Dict[str, Any]] = None,
               autoscaling_config: Optional[Dict[str, Any]] = None,
               batching: Optional[Dict[str, Any]] = None,
               max_queued_requests: int = -1,
               num_shards: int = 1,
               prefill_replicas: int = 0,
               multiplexed_models: Optional[Dict[str, Any]] = None,
               multiplex_max_resident: int = 0,
               **_ignored):
    """``@serve.deployment`` decorator (parity: serve/api.py).

    ``batching``: continuous-batching knobs (see
    ``serve.batching.BatchingConfig``) — the decorated class must
    implement the decode-engine protocol; requests then share an
    in-flight autoregressive batch.  ``max_queued_requests``: ingress
    backlog cap before 429 shedding (-1 = global knob, 0 = unbounded).

    ``num_shards > 1`` makes every replica a GANG of tensor-parallel
    shard workers (the class must implement the sharded-engine
    protocol — ``shard_step``/``combine`` + ``rank``/``world`` kwargs;
    see docs/serving.md).  ``prefill_replicas > 0`` disaggregates the
    prompt pass onto a dedicated prefill tier that streams finished KV
    pages to the decode replicas as object refs.

    ``multiplexed_models`` hosts N models per replica: a dict of
    model-id -> init-kwarg overrides for the engine factory (first key
    is the default model).  Requests pick a model with a ``"model"``
    field in their payload; weights swap by arena ref with an
    LRU-bounded resident set (``multiplex_max_resident``, 0 =
    unbounded).  Requires ``batching``; see docs/serving.md.
    """

    reject_tpu_options("ray_actor_options", ray_actor_options or {})

    def wrap(target):
        cfg = DeploymentConfig(
            num_replicas=num_replicas,
            max_concurrent_queries=max_concurrent_queries,
            user_config=user_config,
            ray_actor_options=ray_actor_options or {},
            autoscaling_config=autoscaling_config,
            batching=batching,
            max_queued_requests=max_queued_requests,
            num_shards=num_shards,
            prefill_replicas=prefill_replicas,
            multiplexed_models=multiplexed_models,
            multiplex_max_resident=multiplex_max_resident,
        )
        return Deployment(target, name or target.__name__, cfg)

    if func_or_class is not None:
        return wrap(func_or_class)
    return wrap


def run(target: Union[Application, Deployment], *, _blocking: bool = True,
        **_ignored) -> DeploymentHandle:
    """Deploy an application (parity: ``serve.run``)."""
    if isinstance(target, Application):
        return target.deployment.deploy(*target.args, **target.kwargs)
    return target.deploy()


def delete(name: str) -> None:
    controller = start()
    ray_tpu_torch.get(controller.delete_deployment.remote(name), timeout=30)


def status() -> Dict[str, Any]:
    """Deployment table; raises if serve is not running (a read-only
    status query must not start a controller as a side effect)."""
    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        raise RuntimeError("serve is not running on this cluster "
                           "(serve.run() starts it)") from None
    return ray_tpu_torch.get(controller.list_deployments.remote(), timeout=30)


def get_deployment_handle(name: str, *_a, **_k) -> DeploymentHandle:
    return DeploymentHandle(name)


def warmup(name: str, dataset: Any, *, batch_size: int = 32,
           method: str = "__call__", max_batches: int = 0,
           timeout_s: float = 300.0) -> int:
    """Stream a warmup/eval ``Dataset`` through every routed replica of
    the deployment (``iter_batches(streaming=True)`` on the replica —
    the corpus never materializes into the arena).  One parallel
    fan-out, one bounded wait; returns total batches consumed."""
    router = _get_router()
    deadline = time.monotonic() + timeout_s
    while not router.known(name):
        if time.monotonic() > deadline:
            raise KeyError(f"no deployment named {name!r}")
        time.sleep(0.05)
    replicas = router.replicas_of(name)
    if not replicas:
        return 0
    refs = [r.warm_up.remote(dataset, batch_size, method, max_batches)
            for r in replicas]
    ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                            timeout=max(1.0,
                                        deadline - time.monotonic()))
    total = 0
    for ref in ready:
        total += int(ray_tpu_torch.get(ref, timeout=30))
    return total


# ----------------------------------------------------------------------
# batching (parity: reference serve/batching.py @serve.batch)
# ----------------------------------------------------------------------
class _BatchQueue:
    def __init__(self, fn: Callable, max_batch_size: int,
                 batch_wait_timeout_s: float):
        self.fn = fn
        self.max_batch_size = max_batch_size
        self.timeout = batch_wait_timeout_s
        self.lock = threading.Lock()
        self.items: List[Any] = []
        self.results: Dict[int, Any] = {}
        self.errors: Dict[int, BaseException] = {}
        self.cv = threading.Condition(self.lock)
        self.batch_start: Optional[float] = None
        self.next_id = 0

    def submit(self, item: Any) -> Any:
        with self.cv:
            my_id = self.next_id
            self.next_id += 1
            self.items.append((my_id, item))
            if self.batch_start is None:
                self.batch_start = time.monotonic()
            # leader: first waiter whose batch fills or times out runs fn
            while True:
                if my_id in self.results:
                    return self.results.pop(my_id)
                if my_id in self.errors:
                    raise self.errors.pop(my_id)
                full = len(self.items) >= self.max_batch_size
                expired = (self.batch_start is not None and
                           time.monotonic() - self.batch_start >= self.timeout)
                if self.items and (full or expired):
                    batch = self.items[:self.max_batch_size]
                    self.items = self.items[self.max_batch_size:]
                    self.batch_start = (time.monotonic()
                                        if self.items else None)
                    ids = [i for i, _ in batch]
                    values = [v for _, v in batch]
                    self.lock.release()
                    try:
                        try:
                            outs = self.fn(values)
                        except BaseException as e:  # noqa: BLE001
                            outs = None
                            err = e
                        else:
                            err = None
                    finally:
                        self.lock.acquire()
                    if err is not None:
                        for i in ids:
                            self.errors[i] = err
                    else:
                        for i, out in zip(ids, outs):
                            self.results[i] = out
                    self.cv.notify_all()
                    continue
                self.cv.wait(timeout=max(self.timeout / 4, 0.001))


# per-process registry of lazily created batch queues; keyed by the wrapped
# function so nothing unpicklable (locks) is attached to user classes
_batch_queues: Dict[int, _BatchQueue] = {}
_batch_queues_lock = threading.Lock()


def batch(fn: Callable = None, *, max_batch_size: int = 8,
          batch_wait_timeout_s: float = 0.01):
    """``@serve.batch``: transparently batch concurrent calls — on TPU the
    natural fit for jitted inference with a batch dimension."""

    def wrap(f):
        @functools.wraps(f)
        def wrapper(self_or_item, *rest):
            # late import by name: this closure is cloudpickled by value
            # inside user deployment classes, and a direct reference to the
            # module-level lock would make them unpicklable
            from ray_tpu_torch import serve as serve_mod

            # support both methods (self, item) and free functions (item)
            if rest:
                bound_self, item = self_or_item, rest[0]
                key = id(bound_self)
                target = lambda vals, s=bound_self: f(s, vals)  # noqa: E731
            else:
                bound_self, item = None, self_or_item
                key = id(wrapper)
                target = f
            with serve_mod._batch_queues_lock:
                q = serve_mod._batch_queues.get(key)
                if q is None:
                    q = serve_mod._BatchQueue(target, max_batch_size,
                                              batch_wait_timeout_s)
                    serve_mod._batch_queues[key] = q
            return q.submit(item)

        return wrapper

    if fn is not None:
        return wrap(fn)
    return wrap
