"""Actor API: @remote classes, handles, and method invocation.

Parity: reference ``python/ray/actor.py`` — ``ActorClass`` (decorated user
class), ``ActorClass.remote(...)`` / ``.options(...)``, ``ActorHandle``
with dynamic ``.method.remote(...)`` dispatch, named/detached actors,
``max_restarts`` / ``max_task_retries`` fault-tolerance knobs.
"""

from __future__ import annotations

import threading
from typing import Any, Dict, List, Optional, Union

import cloudpickle

from ray_tpu_torch._port import reject_tpu_options
from ray_tpu_torch.core.ids import ActorID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core.task_spec import ActorCreationSpec
from ray_tpu_torch.core import worker as worker_mod
from ray_tpu_torch.remote_function import _resolve_strategy


class ActorMethod:
    def __init__(self, handle: "ActorHandle", method_name: str,
                 num_returns: int = 1, concurrency_group: str = ""):
        self._handle = handle
        self._method_name = method_name
        self._num_returns = num_returns
        self._concurrency_group = concurrency_group

    def options(self, **opts) -> "ActorMethod":
        return ActorMethod(
            self._handle, self._method_name,
            num_returns=int(opts.get("num_returns", self._num_returns)),
            concurrency_group=opts.get("concurrency_group",
                                       self._concurrency_group))

    def remote(self, *args, **kwargs) -> Union[ObjectRef, List[ObjectRef]]:
        core = worker_mod.global_worker()
        refs = core.submit_actor_task(
            self._handle._actor_id,
            self._method_name,
            args,
            kwargs,
            num_returns=self._num_returns,
            max_task_retries=self._handle._max_task_retries,
            concurrency_group=self._concurrency_group,
        )
        return refs[0] if self._num_returns == 1 else refs

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor method {self._method_name!r} cannot be called directly; "
            f"use .remote()")


# per-process count of owned handles per actor; when the creator process
# drops its last handle the actor is killed (parity: reference actor handle
# reference counting — non-detached actors die with their owner scope)
_owned_handle_counts: Dict[bytes, int] = {}
_handle_lock = threading.Lock()


class ActorHandle:
    def __init__(self, actor_id: ActorID, class_name: str = "",
                 max_task_retries: int = 0, owned: bool = False):
        self._actor_id = actor_id
        self._class_name = class_name
        self._max_task_retries = max_task_retries
        self._owned = owned
        if owned:
            with _handle_lock:
                key = actor_id.binary()
                _owned_handle_counts[key] = \
                    _owned_handle_counts.get(key, 0) + 1

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str) -> ActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ActorMethod(self, name)

    def __repr__(self) -> str:
        return f"ActorHandle({self._class_name}, {self._actor_id.hex()[:12]})"

    def __reduce__(self):
        # copies in other processes are borrows, not owners
        return (ActorHandle,
                (self._actor_id, self._class_name, self._max_task_retries))

    def __del__(self):
        if not getattr(self, "_owned", False):
            return
        key = self._actor_id.binary()
        with _handle_lock:
            n = _owned_handle_counts.get(key, 1) - 1
            if n > 0:
                _owned_handle_counts[key] = n
                return
            _owned_handle_counts.pop(key, None)
        try:
            core = worker_mod.global_worker_or_none()
            if core is not None:
                core.kill_actor_async(self._actor_id)
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass

    def _detach(self) -> "ActorHandle":
        """Return a non-owning copy (the actor outlives this handle)."""
        return ActorHandle(self._actor_id, self._class_name,
                           self._max_task_retries)

    def __ray_ready__(self) -> ObjectRef:
        """Ref resolving once the actor can serve calls."""
        return ActorMethod(self, "__rtpu_ping__").remote()


def _rebuild_actor_class(cls, options):
    return ActorClass(cls, **options)


class ActorClass:
    def __init__(self, cls, **options):
        reject_tpu_options("remote", options)
        self._cls = cls
        self._options = options
        self._descriptor = f"{cls.__module__}.{cls.__qualname__}"
        self._class_id: Optional[str] = None
        self._pickled: Optional[bytes] = None
        self._exported_core: Optional[Any] = None
        self._export_lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        raise TypeError(
            f"Actor class {self._descriptor} cannot be instantiated "
            f"directly; use .remote()")

    def __reduce__(self):
        # actor classes travel inside closures/args of tasks (parity:
        # ActorClass.__getstate__); rebuild from the plain class
        return (_rebuild_actor_class, (self._cls, self._options))

    def options(self, **options) -> "ActorClass":
        merged = dict(self._options)
        merged.update(options)
        clone = ActorClass(self._cls, **merged)
        clone._class_id = self._class_id
        clone._pickled = self._pickled
        return clone

    def _export(self, core) -> str:
        with self._export_lock:
            # core-identity cache (see RemoteFunction._export)
            if self._class_id is None or self._exported_core is not core:
                if self._pickled is None:
                    self._pickled = cloudpickle.dumps(
                        _wrap_actor_class(self._cls))
                self._class_id = core.register_function(self._pickled)
                self._exported_core = core
        return self._class_id

    def bind(self, *args, **kwargs):
        """Author an actor-instantiation DAG node (reference
        ``dag/class_node.py``); methods of the node are bindable."""
        from ray_tpu_torch.dag.dag_node import ClassNode
        return ClassNode(self, args, kwargs)

    def remote(self, *args, **kwargs) -> ActorHandle:
        core = worker_mod.global_worker()
        class_id = self._export(core)
        opts = self._options
        resources = dict(opts.get("resources") or {})
        # actors default to zero CPUs for their lifetime (parity: reference
        # actor.py — creation is cheap, a per-actor CPU would deadlock
        # workloads with more actors than cores)
        resources.setdefault("CPU", float(opts.get("num_cpus") or 0))
        if opts.get("num_gpus"):
            resources["GPU"] = float(opts["num_gpus"])
        creation = ActorCreationSpec(
            max_restarts=int(opts.get("max_restarts", 0)),
            max_task_retries=int(opts.get("max_task_retries", 0)),
            name=opts.get("name"),
            namespace=opts.get("namespace", "default"),
            lifetime_detached=opts.get("lifetime") == "detached",
            max_concurrency=int(opts.get("max_concurrency", 1)),
            concurrency_groups={
                str(k): int(v) for k, v in
                (opts.get("concurrency_groups") or {}).items()},
        )
        renv = opts.get("runtime_env")
        if renv:
            from ray_tpu_torch import runtime_env as renv_mod
            renv = renv_mod.package(renv_mod.validate(renv), core.kv_put)
        actor_id = core.create_actor(
            class_id,
            self._descriptor,
            args,
            kwargs,
            resources=resources,
            creation_spec=creation,
            scheduling_strategy=_resolve_strategy(
                opts.get("scheduling_strategy")),
            get_if_exists=bool(opts.get("get_if_exists", False)),
            runtime_env=renv,
        )
        return ActorHandle(actor_id, self._descriptor,
                           max_task_retries=creation.max_task_retries,
                           owned=not creation.lifetime_detached)


def _wrap_actor_class(cls):
    """Add framework-internal methods to the user's class."""
    if hasattr(cls, "__rtpu_ping__"):
        return cls

    class Wrapped(cls):  # type: ignore[misc,valid-type]
        def __rtpu_ping__(self):
            return True

    Wrapped.__name__ = cls.__name__
    Wrapped.__qualname__ = cls.__qualname__
    Wrapped.__module__ = cls.__module__
    return Wrapped


def get_actor(name: str, namespace: str = "default") -> ActorHandle:
    """Look up a named actor (parity: ``ray.get_actor``)."""
    core = worker_mod.global_worker()
    info = core.get_actor_info(name=name, namespace=namespace)
    if info is None:
        raise ValueError(f"no actor named {name!r} in namespace {namespace!r}")
    return ActorHandle(ActorID(info["actor_id"]),
                       info.get("class_name", ""))


def exit_actor() -> None:
    """Intentionally exit the current actor (reference
    ``ray.actor.exit_actor``): the in-flight call raises
    ``ActorDiedError`` at its caller, queued calls fail with actor
    death, the actor is marked DEAD with no restart (even with
    ``max_restarts``), and the worker process exits."""
    from ray_tpu_torch.core import worker as worker_mod
    from ray_tpu_torch.core.exceptions import ActorExitRequest

    core = worker_mod.global_worker()
    if getattr(core, "_actor_id", None) is None:
        raise RuntimeError("exit_actor() called outside an actor")
    raise ActorExitRequest()
