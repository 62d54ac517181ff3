"""PyTorch/CUDA port of ray_tpu, for one NVIDIA H100.

The JAX package ``ray_tpu`` is the reference this package is held
against; nothing here imports it.  Its runtime (GCS, raylet, core
worker, object store, serve) is this package's own copy, whose workers
run ``ray_tpu_torch.core.worker_main``; plain tensor code is PyTorch,
and every Pallas kernel on a ported path is a CUDA C++ kernel under
``ray_tpu_torch/ops/csrc`` built for ``sm_90a`` at first use.

Public core API (parity: reference ``python/ray/__init__.py`` /
``_private/worker.py``): ``init``, ``shutdown``, ``remote``, ``get``,
``put``, ``wait``, ``kill``, ``cancel``, ``get_actor``, plus cluster
introspection helpers.  GPUs are the accelerator resource: ``num_gpus``
on ``init``, tasks and actors, ``get_gpu_ids()`` inside them.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(``resolve_device``); on CPU tensors the kernel wrappers compute their
plain PyTorch versions.  Importing the package does not import torch:
the runtime's daemons and workers start without it, and
``resolve_device`` loads it on first use.
"""

from __future__ import annotations

import atexit
import logging
import os
import subprocess
import sys
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

from ray_tpu_torch.core.config import Config, get_config, set_config
from ray_tpu_torch.core.exceptions import (  # noqa: F401 — public API
    ActorDiedError,
    ActorError,
    GetTimeoutError,
    ObjectLostError,
    ObjectStoreFullError,
    RayTpuError,
    TaskCancelledError,
    TaskError,
    WorkerCrashedError,
)
from ray_tpu_torch.core.ids import ActorID, JobID, NodeID, ObjectID, TaskID  # noqa: F401
from ray_tpu_torch.core.object_ref import (  # noqa: F401
    ObjectRef,
    ObjectRefGenerator,
    StreamingObjectRefGenerator,
)
from ray_tpu_torch.core import worker as _worker_mod
from ray_tpu_torch.actor import ActorClass, ActorHandle, get_actor  # noqa: F401
from ray_tpu_torch.remote_function import RemoteFunction
from ray_tpu_torch.runtime_context import get_runtime_context  # noqa: F401
from ray_tpu_torch._port import reject_tpu_options

__version__ = "0.1.0"

logger = logging.getLogger(__name__)

_init_lock = threading.Lock()
_head_proc: Optional[subprocess.Popen] = None
_head_supervisor = None
_owns_head = False


def _client_or_none():
    # no client can be connected before its module is imported: every
    # API call looks it up without importing it
    mod = sys.modules.get("ray_tpu_torch.util.client")
    return None if mod is None else mod._client


def is_initialized() -> bool:
    return (_worker_mod.global_worker_or_none() is not None
            or _client_or_none() is not None)


def init(address: Optional[str] = None, *,
         num_cpus: Optional[int] = None,
         num_gpus: Optional[int] = None,
         resources: Optional[Dict[str, float]] = None,
         object_store_memory: Optional[int] = None,
         _system_config: Optional[Dict[str, Any]] = None,
         ignore_reinit_error: bool = False,
         **unknown: Any) -> Dict[str, Any]:
    """Start (or connect to) a cluster and attach this process as driver.

    With no ``address``, spawns a head node (GCS + raylet) subprocess and
    connects to it — reference ``ray.init()`` semantics.  With
    ``address="host:port"`` (a GCS address), connects to an existing
    cluster by asking the GCS for a raylet on this host (or the head's).
    """
    global _head_proc, _owns_head
    reject_tpu_options("init", unknown)
    if unknown:
        raise TypeError(f"init() got unexpected keyword arguments "
                        f"{sorted(unknown)}")
    with _init_lock:
        if is_initialized():
            if ignore_reinit_error:
                return connection_info()
            raise RayTpuError("ray_tpu_torch.init() called twice")

        if address and address.startswith("ray://"):
            # remote-driver (client) mode: no local runtime, everything
            # proxies through the cluster's client server
            from ray_tpu_torch.util import client as client_mod
            client_mod.connect(address[len("ray://"):])
            atexit.register(shutdown)
            return {"address": address, "mode": "client"}

        config = Config().apply_env_overrides().apply_overrides(_system_config)
        if object_store_memory:
            config.object_store_memory = int(object_store_memory)
        set_config(config)

        from ray_tpu_torch.core import node as node_mod
        from ray_tpu_torch.core.ids import NodeID as _NodeID
        from ray_tpu_torch.core.worker import CoreWorker

        if address is None:
            # job drivers launched by a JobSupervisor join the cluster
            # via env var (reference: RAY_ADDRESS)
            address = os.environ.get("RAY_TPU_TORCH_ADDRESS") or None
        if address == "auto":
            # find a running cluster: env var, else the head recorded by
            # `ray-tpu start --head`
            env_addr = os.environ.get("RAY_TPU_TORCH_ADDRESS")
            address = env_addr if env_addr and env_addr != "auto" else None
            if address is None:
                from ray_tpu_torch.scripts.cli import _load_latest
                latest = _load_latest()
                if latest:
                    address = "{}:{}".format(*latest["gcs_address"])
            if address is None:
                raise RayTpuError(
                    "address='auto' but no running cluster found (set "
                    "RAY_TPU_TORCH_ADDRESS or run `python -m "
                    "ray_tpu_torch.scripts.cli start --head`)")
        if address is None:
            session_dir = node_mod.new_session_dir(config)
            res: Dict[str, float] = dict(resources or {})
            if num_cpus is not None:
                res["CPU"] = float(num_cpus)
            if num_gpus is not None:
                res["GPU"] = float(num_gpus)
            _head_proc, handshake = node_mod.spawn_head(
                config, session_dir, res or None,
                die_with_parent=node_mod.safe_die_with_parent())
            _owns_head = True
            if getattr(config, "gcs_auto_respawn", False):
                # monitor the head: an unexpected GCS death respawns it
                # on the same port/session and the HA recovery path
                # (snapshot + WAL replay, client reconnect) takes over
                from ray_tpu_torch.core.supervisor import HeadSupervisor

                def _swap_head(proc, _handshake):
                    global _head_proc
                    _head_proc = proc

                global _head_supervisor
                _head_supervisor = HeadSupervisor(
                    config, session_dir, res or None, _head_proc,
                    gcs_port=handshake["gcs_address"][1],
                    on_respawn=_swap_head)
        else:
            host, port = address.rsplit(":", 1)
            handshake = _discover_via_gcs((host, int(port)))
            _owns_head = False

        CoreWorker(
            mode="driver",
            gcs_address=tuple(handshake["gcs_address"]),
            raylet_address=tuple(handshake["raylet_address"]),
            node_id=_NodeID.from_hex(handshake["node_id"]),
            store_path=handshake["store_path"],
            store_capacity=handshake["store_capacity"],
            session_dir=handshake["session_dir"],
            config=config,
        )
        atexit.register(shutdown)
        return connection_info()


def _discover_via_gcs(gcs_address: Tuple[str, int]) -> Dict[str, Any]:
    """Connect to a running cluster: pick a raylet from the GCS node table."""
    import asyncio

    from ray_tpu_torch.core import rpc

    async def _probe():
        conn = await rpc.connect(gcs_address)
        try:
            nodes = await conn.call("get_nodes", {})
        finally:
            conn.close()
        alive = [n for n in nodes if n["alive"]]
        if not alive:
            raise RayTpuError(f"no alive nodes at GCS {gcs_address}")
        return alive[0]

    node = asyncio.run(_probe())
    raylet_addr = tuple(node["address"])

    async def _store_info():
        conn = await rpc.connect(raylet_addr)
        try:
            # the raylet tells drivers where its store lives
            return await conn.call("store_info", {})
        finally:
            conn.close()

    info = asyncio.run(_store_info())
    return {
        "gcs_address": list(gcs_address),
        "raylet_address": list(raylet_addr),
        "node_id": NodeID(node["node_id"]).hex(),
        "store_path": info["store_path"],
        "store_capacity": info["store_capacity"],
        "session_dir": info["session_dir"],
    }


def connection_info() -> Dict[str, Any]:
    client = _client_or_none()
    if client is not None:
        return {"address": "ray://{}:{}".format(*client._address),
                "mode": "client"}
    core = _worker_mod.global_worker()
    return {
        "gcs_address": core.gcs_address,
        "raylet_address": core.raylet_address,
        "node_id": core.node_id.hex(),
        "job_id": core.job_id.hex() if core.job_id else None,
        "session_dir": core.session_dir,
    }


def shutdown() -> None:
    global _head_proc, _head_supervisor, _owns_head
    with _init_lock:
        if _head_supervisor is not None:
            _head_supervisor.stop()  # intentional: never respawn now
            _head_supervisor = None
        from ray_tpu_torch.util import client as client_mod
        client_mod.disconnect()
        # retire any serve router poll thread bound to this cluster
        import sys as _sys
        _serve = _sys.modules.get("ray_tpu_torch.serve")
        if _serve is not None:
            _serve._stop_router()
        core = _worker_mod.global_worker_or_none()
        if core is not None:
            core.shutdown()
        if _head_proc is not None and _owns_head:
            _head_proc.terminate()
            try:
                _head_proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                _head_proc.kill()
            _head_proc = None


def remote(*args, **options):
    """``@remote`` decorator for functions and classes (parity:
    ``ray.remote``)."""
    def decorate(fn_or_class):
        if _client_or_none() is not None:
            from ray_tpu_torch.util.client import (ClientActorClass,
                                             ClientRemoteFunction)
            if isinstance(fn_or_class, type):
                return ClientActorClass(fn_or_class, **options)
            return ClientRemoteFunction(fn_or_class, **options)
        if isinstance(fn_or_class, type):
            return ActorClass(fn_or_class, **options)
        return RemoteFunction(fn_or_class, **options)

    if len(args) == 1 and not options and callable(args[0]):
        return decorate(args[0])
    if args:
        raise TypeError("@remote takes keyword options only")
    return decorate


def get(refs: Union[ObjectRef, Sequence[ObjectRef]],
        *, timeout: Optional[float] = None) -> Any:
    client = _client_or_none()
    if client is not None:
        single = isinstance(refs, ObjectRef)
        out = client.get([refs] if single else list(refs), timeout=timeout)
        return out[0] if single else out
    core = _worker_mod.global_worker()
    single = isinstance(refs, ObjectRef)
    out = core.get([refs] if single else list(refs), timeout=timeout)
    return out[0] if single else out


def put(value: Any, *, _force_plasma: bool = False) -> ObjectRef:
    """``_force_plasma`` (internal) places the object in the shm arena
    even when small enough for the in-process store — the serve plane's
    KV pages need arena residency (spill tier, cross-replica pulls)."""
    client = _client_or_none()
    if client is not None:
        return client.put(value)
    return _worker_mod.global_worker().put(value, force_plasma=_force_plasma)


def wait(refs: Sequence[ObjectRef], *, num_returns: int = 1,
         timeout: Optional[float] = None
         ) -> Tuple[List[ObjectRef], List[ObjectRef]]:
    client = _client_or_none()
    if client is not None:
        return client.wait(refs, num_returns=num_returns, timeout=timeout)
    return _worker_mod.global_worker().wait(
        refs, num_returns=num_returns, timeout=timeout)


def kill(actor: "ActorHandle", *, no_restart: bool = True) -> None:
    client = _client_or_none()
    if client is not None:
        client.kill_actor(actor.actor_id, no_restart=no_restart)
        return
    _worker_mod.global_worker().kill_actor(actor.actor_id,
                                           no_restart=no_restart)


def cancel(ref: ObjectRef, *, force: bool = False,
           recursive: bool = False) -> None:
    """Cancel the task that produces ``ref`` (parity: reference
    ``python/ray/_private/worker.py:2582``).  A queued task never runs;
    a running task gets ``KeyboardInterrupt`` raised inside it;
    ``force=True`` kills the executing worker process outright (not
    supported for actor tasks); ``recursive=True`` also cancels the
    task's children.  ``get`` on the ref then raises
    :class:`TaskCancelledError` — unless the task finished first."""
    from ray_tpu_torch.core.object_ref import StreamingObjectRefGenerator
    streaming = isinstance(ref, StreamingObjectRefGenerator)
    client = _client_or_none()
    if client is not None:
        if streaming:
            # the generator's task id is the handle: route it through
            # the client cancel protocol (parity: the reference cancels
            # streaming generators through the client too)
            client.cancel_task_id(ref.task_id.binary(), force=force,
                                  recursive=recursive)
            return
        client.cancel(ref, force=force, recursive=recursive)
        return
    # the streaming handle is the ONLY thing a streaming caller holds
    # (parity: the reference cancels the generator object directly)
    task_id = ref.task_id if streaming else ref.task_id()
    _worker_mod.global_worker().cancel_task(
        task_id, force=force, recursive=recursive)


def free(refs: Sequence[ObjectRef]) -> None:
    client = _client_or_none()
    if client is not None:
        client.free(list(refs))
        return
    _worker_mod.global_worker().free(list(refs))


def nodes() -> List[Dict[str, Any]]:
    client = _client_or_none()
    if client is not None:
        return client.cluster_info("nodes")
    return _worker_mod.global_worker().get_nodes()


def cluster_resources() -> Dict[str, float]:
    client = _client_or_none()
    if client is not None:
        return client.cluster_info("cluster_resources")
    return _worker_mod.global_worker().cluster_resources()


def available_resources() -> Dict[str, float]:
    client = _client_or_none()
    if client is not None:
        return client.cluster_info("available_resources")
    return _worker_mod.global_worker().available_resources()


def get_actor(name: str, namespace: str = "default"):
    """Look up a named actor (parity: ``ray.get_actor``)."""
    client = _client_or_none()
    if client is not None:
        return client.get_named_actor(name, namespace)
    from ray_tpu_torch import actor as _actor_mod
    return _actor_mod.get_actor(name, namespace)


def method(**options):
    """Decorator for actor methods (parity: ``ray.method`` — reference
    ``python/ray/actor.py:65-83``).  ``num_returns`` and
    ``concurrency_group`` options; the latter routes the method into
    the named executor pool declared via
    ``@remote(concurrency_groups={...})``."""
    def decorate(m):
        m.__rtpu_method_options__ = options
        return m
    return decorate


def get_gpu_ids() -> List[int]:
    """GPUs leased to the current worker (parity: ``ray.get_gpu_ids``;
    the JAX package's ``get_tpu_ids``).

    The raylet assigns the least-loaded GPU indices to each GPU lease
    and pushes them to the worker; inside a task or actor the list is
    stable for the lease's lifetime (actors keep theirs across method
    calls).  Fractional demands share a GPU, whole-GPU demands get
    disjoint ids."""
    return _worker_mod.global_worker().current_gpu_ids()


def timeline(filename: Optional[str] = None) -> List[Dict[str, Any]]:
    """Chrome-trace export of task events (reference ``ray.timeline``)."""
    from ray_tpu_torch.experimental.state.api import timeline as _timeline
    return _timeline(filename)


def __getattr__(name: str):
    # torch is imported on first use, never by the runtime's own imports
    if name == "resolve_device":
        from ray_tpu_torch._device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
