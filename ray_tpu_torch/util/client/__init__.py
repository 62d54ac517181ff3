"""Ray-Client-equivalent: remote driver mode over ``ray://``.

Parity: reference ``python/ray/util/client/`` — ``ray.init("ray://…")``
turns this process into a thin client of a cluster-side proxy server
(``server.py`` here, ``RayletServicer`` in the reference): tasks,
actors, and objects are owned by the server's driver connection; the
client holds opaque ids and pickled values travel the wire.  The public
``ray_tpu_torch`` API transparently routes to the active client
(``ray_tpu_torch.init(address="ray://host:port")``).

Values cross the boundary by the object store's rule for tensors
(``core.serialization``): a CUDA tensor comes back on the reader's
current card, or raises where the reader has no CUDA; the server holds
the ones it relays on the host (``hold_cuda_on_host``), so it never
starts CUDA itself.
"""

from __future__ import annotations

import asyncio
import hashlib
import io
import threading
from typing import Any, Dict, List, Optional, Sequence, Tuple

import cloudpickle

from ray_tpu_torch._port import reject_tpu_options
from ray_tpu_torch.core import rpc, serialization
from ray_tpu_torch.core.exceptions import RayTpuError
from ray_tpu_torch.core.ids import ActorID, ObjectID
from ray_tpu_torch.core.object_ref import ObjectRef

def dumps(value: Any) -> bytes:
    """``value`` as the bytes that cross the ray:// boundary."""
    sink = io.BytesIO()
    serialization.dump_in_band(value, sink)
    return sink.getvalue()


loads = cloudpickle.loads


_client_lock = threading.Lock()
_client: Optional["ClientWorker"] = None


def client_connected() -> bool:
    return _client is not None


def get_client() -> "ClientWorker":
    if _client is None:
        raise RayTpuError("no ray:// client connection; call "
                          "ray_tpu_torch.init(address='ray://host:port')")
    return _client


def connect(address: str) -> "ClientWorker":
    """Connect this process as a remote driver (``ray://host:port``)."""
    global _client
    with _client_lock:
        if _client is not None:
            raise RayTpuError("ray:// client already connected")
        _client = ClientWorker(address)
        return _client


def disconnect() -> None:
    global _client
    with _client_lock:
        if _client is not None:
            _client.close()
            _client = None


class ClientWorker:
    """Sync facade over one framed-RPC connection, run on a dedicated
    asyncio thread (the client process has no runtime of its own)."""

    def __init__(self, address: str):
        host, port = address.rsplit(":", 1)
        self._address: Tuple[str, int] = (host, int(port))
        self._loop = asyncio.new_event_loop()
        self._thread = threading.Thread(
            target=self._loop.run_forever, name="ray-tpu-client",
            daemon=True)
        self._thread.start()
        self._conn = self._run(rpc.connect(self._address))
        self._registered_fns: set = set()
        self._registered_classes: set = set()
        # sanity ping
        self._call("cluster_info", {"kind": "ping"})

    def _run(self, coro, timeout: Optional[float] = None):
        fut = asyncio.run_coroutine_threadsafe(coro, self._loop)
        return fut.result(timeout)

    def _call(self, method: str, data: Any,
              timeout: Optional[float] = None) -> Any:
        return self._run(self._conn.call(method, data), timeout)

    def close(self) -> None:
        try:
            self._conn.close()
        except Exception:
            pass
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(timeout=5)

    # -- data plane ------------------------------------------------------
    def _make_ref(self, reply: Dict[str, Any]) -> ObjectRef:
        return ObjectRef(ObjectID(reply["id"]), reply.get("owner"),
                         _register=False)

    #: keep in sync with server.CHUNK_SIZE (4 MiB): larger payloads go
    #: over the wire in pieces so one big put/get can't head-of-line
    #: block every other call on the connection
    CHUNK_SIZE = 4 * 1024 * 1024

    def put(self, value: Any) -> ObjectRef:
        blob = dumps(value)
        if len(blob) <= self.CHUNK_SIZE:
            return self._make_ref(self._call("put", {"value": blob}))
        import uuid
        token = uuid.uuid4().hex
        for i in range(0, len(blob), self.CHUNK_SIZE):
            self._call("put_chunk", {
                "token": token, "seq": i // self.CHUNK_SIZE,
                "data": blob[i:i + self.CHUNK_SIZE]})
        return self._make_ref(self._call("put", {"token": token}))

    def get(self, refs: List[ObjectRef],
            timeout: Optional[float] = None) -> List[Any]:
        reply = self._call("get", {"ids": [r.binary() for r in refs],
                                   "timeout": timeout})
        out = []
        for entry in reply["values"]:
            if entry.get("token") is not None:
                n = entry["chunks"]
                pieces = []
                for i in range(n):
                    piece = self._call("get_chunk", {
                        "token": entry["token"], "i": i,
                        "last": i == n - 1})
                    pieces.append(piece["data"])
                out.append(loads(b"".join(pieces)))
            else:
                out.append(loads(entry["value"]))
        return out

    def wait(self, refs: Sequence[ObjectRef], *, num_returns: int = 1,
             timeout: Optional[float] = None):
        reply = self._call("wait", {"ids": [r.binary() for r in refs],
                                    "num_returns": num_returns,
                                    "timeout": timeout})
        by_id = {r.binary(): r for r in refs}
        return ([by_id[b] for b in reply["ready"]],
                [by_id[b] for b in reply["pending"]])

    # -- tasks -----------------------------------------------------------
    def submit_task(self, fn, options: Dict[str, Any], args, kwargs):
        pickled = dumps(fn)
        fid = hashlib.sha1(pickled).hexdigest()
        if fid not in self._registered_fns:
            self._call("register_function", {"id": fid, "pickled": pickled})
            self._registered_fns.add(fid)
        reply = self._call("task", {
            "id": fid, "options": options,
            "args": dumps(args),
            "kwargs": dumps(kwargs)})
        if "ids" in reply:
            return [self._make_ref(r) for r in reply["ids"]]
        return self._make_ref(reply)

    # -- actors ----------------------------------------------------------
    def create_actor(self, cls, options: Dict[str, Any], args, kwargs
                     ) -> "ClientActorHandle":
        pickled = dumps(cls)
        cid = hashlib.sha1(pickled).hexdigest()
        if cid not in self._registered_classes:
            self._call("register_actor_class",
                       {"id": cid, "pickled": pickled})
            self._registered_classes.add(cid)
        reply = self._call("create_actor", {
            "id": cid, "options": options,
            "args": dumps(args),
            "kwargs": dumps(kwargs)})
        return ClientActorHandle(self, ActorID(reply["actor_id"]),
                                 cls.__name__)

    def actor_call(self, actor_id: ActorID, method: str, args, kwargs):
        reply = self._call("actor_call", {
            "actor_id": actor_id.binary(), "method": method,
            "args": dumps(args),
            "kwargs": dumps(kwargs)})
        if "ids" in reply:
            return [self._make_ref(r) for r in reply["ids"]]
        return self._make_ref(reply)

    def get_named_actor(self, name: str, namespace: Optional[str] = None
                        ) -> "ClientActorHandle":
        reply = self._call("get_named_actor",
                           {"name": name, "namespace": namespace})
        return ClientActorHandle(self, ActorID(reply["actor_id"]), name)

    def kill_actor(self, actor_id: ActorID, no_restart: bool = True) -> None:
        self._call("kill_actor", {"actor_id": actor_id.binary(),
                                  "no_restart": no_restart})

    # -- placement groups ------------------------------------------------
    def pg_create(self, bundles, strategy, name):
        from ray_tpu_torch.core.ids import PlacementGroupID
        from ray_tpu_torch.util.placement_group import PlacementGroup
        reply = self._call("pg_create", {
            "bundles": bundles, "strategy": strategy, "name": name})
        return PlacementGroup(PlacementGroupID(reply["pg_id"]),
                              bundles, strategy)

    def pg_remove(self, pg_id) -> None:
        self._call("pg_remove", {"pg_id": pg_id.binary()})

    def pg_wait(self, pg_id, timeout_seconds: float) -> bool:
        return self._call("pg_wait", {
            "pg_id": pg_id.binary(),
            "timeout": timeout_seconds})["ready"]

    def pg_ready(self, pg_id) -> ObjectRef:
        return self._make_ref(self._call("pg_ready",
                                         {"pg_id": pg_id.binary()}))

    def pg_bundle_nodes(self, pg_id):
        return self._call("pg_bundle_nodes",
                          {"pg_id": pg_id.binary()})["bundle_nodes"]

    def pg_table(self):
        return self._call("pg_table", {})["table"]

    def cancel(self, ref: ObjectRef, *, force: bool = False,
               recursive: bool = False) -> None:
        self._call("cancel", {"id": ref.binary(), "force": force,
                              "recursive": recursive})

    def cancel_task_id(self, task_id_bin: bytes, *, force: bool = False,
                       recursive: bool = False) -> None:
        """Cancel by task id — the only handle a streaming-generator
        caller holds (parity: the reference cancels the generator object
        directly; over ray:// the task id travels instead)."""
        self._call("cancel_task_id", {
            "task_id": task_id_bin, "force": force,
            "recursive": recursive})

    def free(self, refs: List[ObjectRef]) -> None:
        self._call("free", {"ids": [r.binary() for r in refs]})

    # -- introspection ---------------------------------------------------
    def cluster_info(self, kind: str) -> Any:
        return self._call("cluster_info", {"kind": kind})["value"]


class ClientRemoteFunction:
    """Client-side ``@remote`` function: ``.remote()`` proxies to the
    server (reference ``util/client/common.py`` ``ClientRemoteFunc``)."""

    def __init__(self, fn, **options):
        reject_tpu_options(getattr(fn, "__name__", "remote"), options)
        self._fn = fn
        self._options = options
        self.__name__ = getattr(fn, "__name__", "remote_function")

    def __call__(self, *a, **k):
        raise TypeError(f"Remote function {self.__name__} cannot be "
                        f"called directly; use .remote()")

    def options(self, **options) -> "ClientRemoteFunction":
        merged = dict(self._options)
        merged.update(options)
        return ClientRemoteFunction(self._fn, **merged)

    def remote(self, *args, **kwargs):
        return get_client().submit_task(self._fn, self._options, args,
                                        kwargs)


class ClientActorClass:
    """Client-side actor class (reference ``ClientActorClass``)."""

    def __init__(self, cls, **options):
        reject_tpu_options(cls.__name__, options)
        self._cls = cls
        self._options = options
        self.__name__ = cls.__name__

    def __call__(self, *a, **k):
        raise TypeError(f"Actor class {self.__name__} cannot be "
                        f"instantiated directly; use .remote()")

    def options(self, **options) -> "ClientActorClass":
        merged = dict(self._options)
        merged.update(options)
        return ClientActorClass(self._cls, **merged)

    def remote(self, *args, **kwargs) -> "ClientActorHandle":
        return get_client().create_actor(self._cls, self._options, args,
                                         kwargs)


class ClientActorMethod:
    def __init__(self, handle: "ClientActorHandle", name: str):
        self._handle = handle
        self._name = name

    def remote(self, *args, **kwargs):
        return self._handle._client.actor_call(
            self._handle.actor_id, self._name, args, kwargs)


class ClientActorHandle:
    def __init__(self, client: ClientWorker, actor_id: ActorID,
                 class_name: str = ""):
        self._client = client
        self._actor_id = actor_id
        self._class_name = class_name

    @property
    def actor_id(self) -> ActorID:
        return self._actor_id

    def __getattr__(self, name: str) -> ClientActorMethod:
        if name.startswith("_"):
            raise AttributeError(name)
        return ClientActorMethod(self, name)

    def __repr__(self) -> str:
        return (f"ClientActorHandle({self._class_name}, "
                f"{self._actor_id.hex()[:12]})")
