"""Client server: the cluster-side proxy for remote drivers.

Parity: reference ``python/ray/util/client/server/server.py``
(``RayletServicer``:96, ``Schedule``:593) — a server process on the
cluster holding a real driver connection; remote clients speak a thin
RPC protocol (here the runtime's framed asyncio RPC instead of gRPC)
and the server executes ``put/get/wait/submit/actor`` on their behalf.
The server owns every ObjectRef a client holds (owner-based lifetime,
reference ``proxier.py`` semantics): refs are tracked per client
connection and released when the client disconnects or sends
``release``.

Run with ``python -m ray_tpu_torch.util.client.server --address <gcs>
--port 10001`` or let the CLI's ``start --head`` spawn it.
"""

from __future__ import annotations

import argparse
import asyncio
import logging
from typing import Any, Dict, Tuple

import cloudpickle

import ray_tpu_torch
from ray_tpu_torch.core import rpc, serialization
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.util.client import dumps, loads

logger = logging.getLogger(__name__)


def _unpickle_with_refs(payload: bytes, refs: Dict[bytes, ObjectRef]):
    """Client args arrive cloudpickled; ObjectRefs inside them unpickle
    into unregistered stubs — swap in the server-owned refs so ownership
    bookkeeping stays with the server's driver connection."""
    value = loads(payload)

    def swap(x):
        if isinstance(x, ObjectRef):
            owned = refs.get(x.binary())
            return owned if owned is not None else x
        if isinstance(x, (list, tuple)):
            out = [swap(v) for v in x]
            return type(x)(out) if isinstance(x, tuple) else out
        if isinstance(x, dict):
            return {k: swap(v) for k, v in x.items()}
        return x

    return swap(value)


#: payloads above this ride the wire in pieces instead of one frame
#: (parity: the reference dataservicer's 64 MiB chunking —
#: ``util/client/server/dataservicer.py``; one giant frame head-of-line
#: blocks every other call on the connection while it serializes)
CHUNK_SIZE = 4 * 1024 * 1024


class ClientService:
    """One service for all client connections; per-connection ref/actor
    tables keyed by the Connection object."""

    def __init__(self, single_client: bool = False):
        self._refs: Dict[Any, Dict[bytes, ObjectRef]] = {}
        self._actors: Dict[Any, Dict[bytes, Any]] = {}
        # placement groups created by each client; removed at disconnect
        # (a remote driver's gangs die with it, like local-driver PGs)
        self._pgs: Dict[Any, Dict[bytes, Any]] = {}
        # per-connection, like _refs/_actors: client-supplied ids must not
        # collide across clients (an id collision would silently run
        # another client's function)
        self._functions: Dict[Any, Dict[str, Any]] = {}
        self._actor_classes: Dict[Any, Dict[str, Any]] = {}
        # chunked-transfer staging, also per-connection; entries carry a
        # timestamp and stale ones are purged on the next staging op
        # (an interrupted large get/put must not pin its blob for the
        # life of the connection)
        self._upload: Dict[Any, Dict[str, tuple]] = {}
        self._download: Dict[Any, Dict[str, tuple]] = {}
        #: proxied (isolated) mode: this process serves ONE client and
        #: exits when it disconnects
        self.single_client = single_client
        self.closed = asyncio.Event() if single_client else None
        self._served_one = False

    # -- connection lifecycle -------------------------------------------
    def on_connection(self, conn) -> None:
        if self.single_client and self._served_one:
            conn.close()  # this process belongs to another client
            return
        self._served_one = True
        self._refs[conn] = {}
        self._actors[conn] = {}
        self._functions[conn] = {}
        self._actor_classes[conn] = {}
        self._upload[conn] = {}
        self._download[conn] = {}
        self._pgs[conn] = {}

    def on_disconnection(self, conn) -> None:
        # dropping the table drops the server-side refs -> distributed GC
        dropped = self._refs.pop(conn, None)
        self._actors.pop(conn, None)
        self._functions.pop(conn, None)
        self._actor_classes.pop(conn, None)
        self._upload.pop(conn, None)
        self._download.pop(conn, None)
        pgs = list((self._pgs.pop(conn, None) or {}).values())
        if pgs:
            # reap off-loop: each removal is a GCS round trip, and this
            # runs on the shared server loop — blocking it would stall
            # every other connected client (the pg_* handlers use
            # to_thread for the same reason)
            import asyncio as _asyncio

            def _reap():
                from ray_tpu_torch.util.placement_group import \
                    remove_placement_group
                for pg in pgs:
                    try:
                        remove_placement_group(pg)
                    except Exception:  # noqa: BLE001 — best-effort reap
                        logger.debug("client PG cleanup failed",
                                     exc_info=True)
            try:
                loop = _asyncio.get_running_loop()
                task = loop.create_task(_asyncio.to_thread(_reap))
                task.add_done_callback(lambda t: t.exception())
            except RuntimeError:
                _reap()  # not on a loop (tests/teardown): inline
        if self.single_client and dropped is not None:
            self.closed.set()

    def _track(self, conn, ref: ObjectRef) -> Dict[str, Any]:
        self._refs[conn][ref.binary()] = ref
        return {"id": ref.binary(), "owner": ref.owner_address()}

    # -- data plane ------------------------------------------------------
    _STAGING_TTL_S = 600.0

    @staticmethod
    def _purge_stale(table: Dict[str, tuple]) -> None:
        import time
        cutoff = time.monotonic() - ClientService._STAGING_TTL_S
        for token in [t for t, (_, ts) in table.items() if ts < cutoff]:
            del table[token]

    async def handle_put_chunk(self, conn, data) -> None:
        """Stage one piece of a large upload (client assembles via a
        token; ``put`` with that token commits)."""
        import time
        self._purge_stale(self._upload[conn])
        entry = self._upload[conn].get(data["token"])
        if entry is None:
            entry = ([], time.monotonic())
        # refresh last-touched on EVERY chunk: a slow multi-minute
        # upload must not be purged (and silently truncated) mid-stream
        self._upload[conn][data["token"]] = (entry[0], time.monotonic())
        entry[0].append(data["data"])

    async def handle_put(self, conn, data) -> Dict[str, Any]:
        if data.get("token") is not None:
            entry = self._upload[conn].pop(data["token"], None)
            if entry is None:
                raise rpc.RpcError(
                    f"upload token {data['token']!r} is unknown or was "
                    f"purged after {self._STAGING_TTL_S:.0f}s idle — "
                    "restart the chunked put")
            payload = b"".join(entry[0])
        else:
            payload = data["value"]
        value = _unpickle_with_refs(payload, self._refs[conn])
        ref = await asyncio.to_thread(ray_tpu_torch.put, value)
        return self._track(conn, ref)

    async def handle_get(self, conn, data) -> Dict[str, Any]:
        import time
        import uuid

        refs = [self._resolve(conn, b) for b in data["ids"]]
        values = await asyncio.to_thread(
            ray_tpu_torch.get, refs, timeout=data.get("timeout"))
        self._purge_stale(self._download[conn])
        out = []
        for v in values:
            blob = dumps(v)
            if len(blob) <= CHUNK_SIZE:
                out.append({"value": blob})
            else:
                token = uuid.uuid4().hex
                self._download[conn][token] = (blob, time.monotonic())
                out.append({"token": token, "size": len(blob),
                            "chunks": -(-len(blob) // CHUNK_SIZE)})
        return {"values": out}

    async def handle_get_chunk(self, conn, data) -> Dict[str, Any]:
        import time
        entry = self._download[conn].get(data["token"])
        if entry is None:
            raise rpc.RpcError(
                f"download token {data['token']!r} is unknown or was "
                f"purged after {self._STAGING_TTL_S:.0f}s idle — "
                "re-issue the get")
        blob, _ts = entry
        i = data["i"]
        piece = blob[i * CHUNK_SIZE:(i + 1) * CHUNK_SIZE]
        if data.get("last"):
            del self._download[conn][data["token"]]
        else:
            # refresh last-touched so a slow multi-minute download is
            # not purged (and broken) between chunk reads
            self._download[conn][data["token"]] = (blob, time.monotonic())
        return {"data": piece}

    async def handle_wait(self, conn, data) -> Dict[str, Any]:
        refs = [self._resolve(conn, b) for b in data["ids"]]
        ready, pending = await asyncio.to_thread(
            ray_tpu_torch.wait, refs, num_returns=data.get("num_returns", 1),
            timeout=data.get("timeout"))
        return {"ready": [r.binary() for r in ready],
                "pending": [r.binary() for r in pending]}

    async def handle_release(self, conn, data) -> None:
        for b in data["ids"]:
            self._refs[conn].pop(b, None)

    # -- placement groups (reference ray_client.proto: the client proxy
    # carries the full PG surface, not just tasks/actors) ---------------
    async def handle_pg_create(self, conn, data) -> Dict[str, Any]:
        from ray_tpu_torch.util.placement_group import placement_group
        pg = await asyncio.to_thread(
            placement_group, data["bundles"],
            strategy=data.get("strategy", "PACK"),
            name=data.get("name"))
        self._pgs[conn][pg.id.binary()] = pg
        return {"pg_id": pg.id.binary(), "strategy": pg.strategy}

    def _resolve_pg(self, conn, pg_id_bin: bytes):
        pg = self._pgs[conn].get(pg_id_bin)
        if pg is None:
            raise rpc.RpcError(
                f"placement group {pg_id_bin.hex()} unknown on this "
                "connection (removed or from another session)")
        return pg

    async def handle_pg_remove(self, conn, data) -> None:
        from ray_tpu_torch.util.placement_group import remove_placement_group
        pg = self._resolve_pg(conn, data["pg_id"])
        await asyncio.to_thread(remove_placement_group, pg)
        self._pgs[conn].pop(data["pg_id"], None)

    async def handle_pg_wait(self, conn, data) -> Dict[str, Any]:
        pg = self._resolve_pg(conn, data["pg_id"])
        ready = await asyncio.to_thread(
            pg.wait, data.get("timeout", 30.0))
        return {"ready": ready}

    async def handle_pg_ready(self, conn, data) -> Dict[str, Any]:
        pg = self._resolve_pg(conn, data["pg_id"])
        return self._track(conn, pg.ready())

    async def handle_pg_bundle_nodes(self, conn, data) -> Dict[str, Any]:
        pg = self._resolve_pg(conn, data["pg_id"])
        return {"bundle_nodes": await asyncio.to_thread(pg.bundle_nodes)}

    async def handle_pg_table(self, conn, data) -> Dict[str, Any]:
        from ray_tpu_torch.util.placement_group import placement_group_table
        return {"table": await asyncio.to_thread(placement_group_table)}

    async def handle_cancel(self, conn, data) -> None:
        ref = self._resolve(conn, data["id"])
        await asyncio.to_thread(
            ray_tpu_torch.cancel, ref, force=bool(data.get("force")),
            recursive=bool(data.get("recursive")))

    async def handle_cancel_task_id(self, conn, data) -> None:
        """Cancel by task id (streaming generators hold no ObjectRef the
        client could resolve — the id is the handle)."""
        from ray_tpu_torch.core import worker as _worker_mod
        from ray_tpu_torch.core.ids import TaskID

        core = _worker_mod.global_worker()
        await asyncio.to_thread(
            core.cancel_task, TaskID(data["task_id"]),
            force=bool(data.get("force")),
            recursive=bool(data.get("recursive")))

    async def handle_free(self, conn, data) -> None:
        refs = [self._resolve(conn, b) for b in data["ids"]]
        await asyncio.to_thread(ray_tpu_torch.free, refs)

    def _resolve(self, conn, id_bin: bytes) -> ObjectRef:
        ref = self._refs[conn].get(id_bin)
        if ref is None:
            raise rpc.RpcError(f"client ref {id_bin.hex()} unknown "
                               f"(released or from another session)")
        return ref

    # -- tasks -----------------------------------------------------------
    async def handle_register_function(self, conn, data) -> None:
        fid = data["id"]
        table = self._functions[conn]
        if fid not in table:
            fn = cloudpickle.loads(data["pickled"])
            table[fid] = ray_tpu_torch.remote(fn)

    async def handle_task(self, conn, data) -> Dict[str, Any]:
        fn = self._functions[conn].get(data["id"])
        if fn is None:
            raise rpc.RpcError(
                f"client function {data['id']!r} is not registered on "
                f"this connection (reconnect re-registers functions)")
        if data.get("options"):
            fn = fn.options(**data["options"])
        args = _unpickle_with_refs(data["args"], self._refs[conn])
        kwargs = _unpickle_with_refs(data["kwargs"], self._refs[conn])
        ref = await asyncio.to_thread(fn.remote, *args, **kwargs)
        if isinstance(ref, list):  # num_returns > 1
            return {"ids": [self._track(conn, r) for r in ref]}
        return self._track(conn, ref)

    # -- actors ----------------------------------------------------------
    async def handle_register_actor_class(self, conn, data) -> None:
        cid = data["id"]
        table = self._actor_classes[conn]
        if cid not in table:
            cls = cloudpickle.loads(data["pickled"])
            table[cid] = ray_tpu_torch.remote(cls)

    async def handle_create_actor(self, conn, data) -> Dict[str, Any]:
        ac = self._actor_classes[conn].get(data["id"])
        if ac is None:
            raise rpc.RpcError(
                f"client actor class {data['id']!r} is not registered on "
                f"this connection (reconnect re-registers classes)")
        if data.get("options"):
            ac = ac.options(**data["options"])
        args = _unpickle_with_refs(data["args"], self._refs[conn])
        kwargs = _unpickle_with_refs(data["kwargs"], self._refs[conn])
        handle = await asyncio.to_thread(ac.remote, *args, **kwargs)
        self._actors[conn][handle.actor_id.binary()] = handle
        return {"actor_id": handle.actor_id.binary()}

    async def handle_actor_call(self, conn, data) -> Dict[str, Any]:
        handle = self._actors[conn].get(data["actor_id"])
        if handle is None:
            raise rpc.RpcError(
                f"actor {data['actor_id'].hex()} unknown on this "
                f"connection (killed or from another session)")
        method = getattr(handle, data["method"])
        args = _unpickle_with_refs(data["args"], self._refs[conn])
        kwargs = _unpickle_with_refs(data["kwargs"], self._refs[conn])
        ref = await asyncio.to_thread(method.remote, *args, **kwargs)
        if isinstance(ref, list):
            return {"ids": [self._track(conn, r) for r in ref]}
        return self._track(conn, ref)

    async def handle_get_named_actor(self, conn, data) -> Dict[str, Any]:
        handle = await asyncio.to_thread(
            ray_tpu_torch.get_actor, data["name"],
            namespace=data.get("namespace") or "default")
        # don't displace an owning handle for the same actor — dropping
        # it would GC-kill the actor out from under the client
        self._actors[conn].setdefault(handle.actor_id.binary(), handle)
        return {"actor_id": handle.actor_id.binary()}

    async def handle_kill_actor(self, conn, data) -> None:
        handle = self._actors[conn].get(data["actor_id"])
        if handle is not None:
            await asyncio.to_thread(
                ray_tpu_torch.kill, handle,
                no_restart=data.get("no_restart", True))

    # -- introspection ---------------------------------------------------
    async def handle_cluster_info(self, conn, data) -> Dict[str, Any]:
        kind = data["kind"]
        if kind == "nodes":
            return {"value": await asyncio.to_thread(ray_tpu_torch.nodes)}
        if kind == "cluster_resources":
            return {"value": await asyncio.to_thread(
                ray_tpu_torch.cluster_resources)}
        if kind == "available_resources":
            return {"value": await asyncio.to_thread(
                ray_tpu_torch.available_resources)}
        if kind == "ping":
            return {"value": "pong"}
        if kind == "server_pid":
            import os
            return {"value": os.getpid()}
        raise rpc.RpcError(f"unknown cluster_info kind {kind!r}")


async def _serve(host: str, port: int, single_client: bool = False
                 ) -> None:
    # the ray:// surface reuses core method NAMES with client-shaped
    # payloads; core schema validation does not apply here
    service = ClientService(single_client=single_client)
    server = rpc.Server(service, host=host, port=port,
                        validate_schemas=False)
    addr = await server.start()
    logger.info("client server listening on %s:%s", *addr)
    print(f"ray_tpu_torch client server ready on ray://{addr[0]}:{addr[1]}",
          flush=True)
    try:
        if single_client:
            await service.closed.wait()  # exit with our one client
        else:
            await asyncio.Event().wait()
    finally:
        await server.stop()


async def _serve_isolated(gcs_address: str, host: str, port: int) -> None:
    """Per-client isolation (parity: reference ``proxier.py``): a mux
    accepts on the public port and, for EVERY client connection, spawns
    a dedicated server process with its own driver (own job id, logs,
    and ref/actor lifetime), splicing bytes between the two sockets.
    The child exits — and its driver's refs/actors are GC'd — when its
    client disconnects."""
    import sys

    async def splice(reader, writer):
        try:
            while True:
                data = await reader.read(256 * 1024)
                if not data:
                    break
                writer.write(data)
                await writer.drain()
        except ConnectionError:
            pass
        except asyncio.CancelledError:
            # swallowing this would mark the splice task as finished
            # cleanly and leave the canceller waiting on a half-open
            # proxy; close the writer (finally) and keep cancelling
            raise
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def on_client(creader, cwriter):
        proc = await asyncio.create_subprocess_exec(
            sys.executable, "-m", "ray_tpu_torch.util.client.server",
            "--address", gcs_address, "--host", "127.0.0.1",
            "--port", "0", "--single-client",
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL)
        child_port = None
        try:
            while True:
                line = await asyncio.wait_for(proc.stdout.readline(), 120)
                if not line:
                    break
                text = line.decode(errors="replace")
                if "ready on ray://" in text:
                    child_port = int(text.rsplit(":", 1)[1])
                    break
            if child_port is None:
                raise RuntimeError("per-client server died at startup")

            async def drain_stdout():
                # keep the pipe flowing: a child that later prints past
                # the OS pipe buffer would block inside its own writes
                try:
                    while await proc.stdout.read(64 * 1024):
                        pass
                except Exception:  # noqa: BLE001
                    pass

            asyncio.ensure_future(drain_stdout())
            sreader, swriter = await asyncio.open_connection(
                "127.0.0.1", child_port)
        except Exception:  # noqa: BLE001
            logger.exception("per-client server bring-up failed")
            cwriter.close()
            proc.terminate()
            return
        logger.info("client %s -> dedicated server pid %d (port %d)",
                    cwriter.get_extra_info("peername"), proc.pid,
                    child_port)
        await asyncio.gather(splice(creader, swriter),
                             splice(sreader, cwriter))
        # client gone: the child notices its socket close and exits;
        # terminate as a backstop
        try:
            await asyncio.wait_for(proc.wait(), 15)
        except asyncio.TimeoutError:
            proc.terminate()

    server = await asyncio.start_server(on_client, host, port)
    addr = server.sockets[0].getsockname()
    print(f"ray_tpu_torch client server (isolated) ready on "
          f"ray://{addr[0]}:{addr[1]}", flush=True)
    async with server:
        await server.serve_forever()


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(
        description="ray_tpu_torch client server (remote-driver proxy)")
    parser.add_argument("--address", required=True,
                        help="GCS address host:port of the cluster")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=10001)
    parser.add_argument("--isolate", action="store_true",
                        help="one dedicated server process (own driver/"
                             "job) per client connection")
    parser.add_argument("--single-client", action="store_true",
                        help=argparse.SUPPRESS)  # spawned by --isolate
    args = parser.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.isolate:
        # the mux holds no driver at all; children own theirs
        asyncio.run(_serve_isolated(args.address, args.host, args.port))
        return
    # a relay: CUDA tensors stay on the host here and keep their kind
    serialization.hold_cuda_on_host()
    # init outside the event loop (driver connection is synchronous)
    ray_tpu_torch.init(address=args.address)
    asyncio.run(_serve(args.host, args.port,
                       single_client=args.single_client))


if __name__ == "__main__":
    main()
