"""HTTP ingress for serve (parity: reference ``serve/_private/http_proxy.py``
``HTTPProxy:218`` — uvicorn is unavailable here, so a small asyncio
HTTP/1.1 server provides the same routing contract: ``/<deployment>``
or ``/<deployment>/<method>`` paths dispatch to replicas, JSON in/out).

Production behaviors layered onto the routing contract:

- **Backpressure / load shedding**: each deployment has an ingress
  backlog budget (``max_queued_requests`` on the deployment, falling
  back to the ``serve_proxy_queue_limit`` knob; 0 = unbounded).  A
  request arriving past the budget is shed immediately with ``429 Too
  Many Requests`` + ``Retry-After`` instead of joining an unbounded
  queue — under overload the deployment keeps serving at capacity
  (goodput) rather than collapsing into queueing delay.
- **Power-of-two-choices routing**: dispatch goes through the shared
  Router, which picks the less-loaded of two random replicas by
  estimated queue depth (controller-reported snapshot + local in-flight
  delta) instead of blind round-robin.
- **Replica-death retry**: a replica dying mid-request (chaos, scale-in
  race, crash) is marked dead, excluded, and the request re-dispatched
  to a healthy replica — the client sees an answer, not an error.
- **Deadlines + cancellation**: the per-request deadline (header
  ``x-serve-deadline-s``, default ``serve_request_deadline_s``) rides to
  the replica's batcher, which evicts expired requests at step
  boundaries; a client that disconnects mid-request triggers
  ``cancel_request`` on the replica so an abandoned connection frees
  its batch slot instead of decoding into the void.
- **Streaming**: ``?stream=1`` (or header ``x-serve-stream: 1``) writes
  a list-valued result incrementally as chunked JSON lines, one element
  per chunk, so clients consume partial output as it exists.

The whole request path is async — dispatch, result wait, disconnect
watch and shedding never block the proxy's event loop; only control
queries (``/``, ``serve.status``) hop to the executor.
"""

from __future__ import annotations

import asyncio
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, Optional, Tuple

import ray_tpu_torch
from ray_tpu_torch.core import telemetry as _tm
from ray_tpu_torch.core import tracing as _trace
from ray_tpu_torch.util import failpoint as _fp

_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            429: "Too Many Requests", 500: "Internal Server Error",
            503: "Service Unavailable", 504: "Gateway Timeout"}


class _ClientGone(Exception):
    """The HTTP client disconnected before the response was ready."""


from ray_tpu_torch.serve._internal import _serve_knob as _knob  # noqa: E402


@ray_tpu_torch.remote
class HTTPProxy:
    """Per-cluster (or per-node) HTTP proxy actor."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8000):
        self._host = host
        self._port = port
        self._started = threading.Event()
        self._router = None
        self._router_lock = threading.Lock()
        #: per-deployment requests admitted and not yet answered — the
        #: ingress backlog the shed budget is enforced against
        self._admitted: Dict[str, int] = {}
        self._shed: Dict[str, int] = {}
        self._rid = itertools.count()
        # pid alone collides across per-node proxies (containers reuse
        # pids); a colliding request id would let one client's
        # disconnect cancel another client's batch slot
        self._rid_prefix = f"{os.getpid():x}-{os.urandom(3).hex()}"
        self._thread = threading.Thread(target=self._serve_forever,
                                        daemon=True)
        self._thread.start()
        self._started.wait(timeout=30)

    def address(self) -> tuple:
        return (self._host, self._port)

    def ready(self) -> bool:
        return self._started.is_set()

    def node_id(self) -> str:
        return ray_tpu_torch.get_runtime_context().get_node_id()

    def proxy_stats(self) -> Dict[str, Any]:
        return {"admitted": dict(self._admitted),
                "shed": dict(self._shed)}

    def _serve_forever(self) -> None:
        asyncio.run(self._main())

    async def _main(self) -> None:
        server = await asyncio.start_server(self._handle_conn, self._host,
                                            self._port)
        sock = server.sockets[0]
        self._port = sock.getsockname()[1]
        self._started.set()
        async with server:
            await server.serve_forever()

    def _get_router(self):
        # the shared process-wide Router (blocking bootstrap — callers
        # hop through the executor on first touch)
        from ray_tpu_torch import serve
        with self._router_lock:
            # same lazy-init shape as serve._get_router: the one-time
            # bootstrap RPC is exactly what the waiters are waiting for
            # rtpu-check: disable=lock-order-cycle
            return serve._get_router()

    # -- connection handling ----------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        try:
            request_line = await reader.readline()
            if not request_line:
                return
            method, path, _ = request_line.decode().split(" ", 2)
            headers: Dict[str, str] = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                k, _, v = line.decode().partition(":")
                headers[k.strip().lower()] = v.strip()
            body = b""
            length = int(headers.get("content-length", "0"))
            if length:
                body = await reader.readexactly(length)
            await self._route(method, path, headers, body, reader, writer)
            await writer.drain()
        except _ClientGone:
            pass  # nothing to write to
        except Exception:  # noqa: BLE001 — a broken connection must not
            pass  # take the acceptor down
        finally:
            try:
                writer.close()
            except Exception:  # noqa: BLE001
                pass

    async def _write_json(self, writer: asyncio.StreamWriter, status: int,
                          payload: Any,
                          extra_headers: Tuple[Tuple[str, str], ...] = ()
                          ) -> None:
        blob = json.dumps(payload).encode()
        head = [f"HTTP/1.1 {status} {_REASONS.get(status, 'OK')}",
                "content-type: application/json",
                f"content-length: {len(blob)}", "connection: close"]
        head.extend(f"{k}: {v}" for k, v in extra_headers)
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + blob)
        await writer.drain()

    async def _write_stream(self, writer: asyncio.StreamWriter,
                            items) -> None:
        """Chunked transfer encoding, one JSON line per item — written
        incrementally so a slow consumer reads partial output early."""
        writer.write(b"HTTP/1.1 200 OK\r\n"
                     b"content-type: application/json-lines\r\n"
                     b"transfer-encoding: chunked\r\n"
                     b"connection: close\r\n\r\n")
        for item in items:
            chunk = (json.dumps(item) + "\n").encode()
            writer.write(f"{len(chunk):x}\r\n".encode() + chunk + b"\r\n")
            await writer.drain()
        writer.write(b"0\r\n\r\n")
        await writer.drain()

    async def _route(self, method: str, path: str, headers: Dict[str, str],
                     body: bytes, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        loop = asyncio.get_running_loop()
        path, _, query = path.partition("?")
        name, _, sub = path.strip("/").partition("/")
        if not name:
            deployments = await loop.run_in_executor(None, self._status)
            await self._write_json(writer, 200,
                                   {"deployments": deployments})
            return
        if name in ("-", "healthz"):
            await self._write_json(writer, 200, {"status": "ok"})
            return
        stream = "stream=1" in query \
            or headers.get("x-serve-stream") in ("1", "true")
        method_name = sub or "__call__"
        try:
            deadline_s = float(headers["x-serve-deadline-s"]) \
                if "x-serve-deadline-s" in headers \
                else float(_knob("serve_request_deadline_s", 60.0))
        except ValueError:
            deadline_s = float(_knob("serve_request_deadline_s", 60.0))
        args: tuple = ()
        if body:
            try:
                args = (json.loads(body),)
            except ValueError:
                await self._write_json(writer, 400,
                                       {"error": "body is not JSON"})
                return

        router = self._router
        if router is None:
            router = self._router = await loop.run_in_executor(
                None, self._get_router)

        # trace is BORN here (the serve ingress); its root span's status
        # at completion is the tail-sampling signal, so every shed /
        # error / SLO-missing request is retained in full while fast
        # successes sample down.  Tagged once — no per-hop branching.
        tspan = _trace.start_trace(f"ingress:{name}", deployment=name,
                                   http_method=method_name)

        # -- admission / shedding -------------------------------------
        limit = router.queue_limit(name)
        backlog = self._admitted.get(name, 0)
        if limit and backlog >= limit:
            self._shed[name] = self._shed.get(name, 0) + 1
            _tm.serve_request_shed(name, "proxy")
            retry_after = float(_knob("serve_shed_retry_after_s", 1.0))
            await self._write_json(
                writer, 429,
                {"error": "deployment overloaded", "backlog": backlog,
                 "retry_after_s": retry_after},
                (("retry-after", f"{max(1, int(retry_after + 0.999))}"),))
            if tspan is not None:
                tspan.end(status="shed", where="proxy")
            return

        self._admitted[name] = backlog + 1
        try:
            outcome, attempts = await self._dispatch(
                router, name, method_name, args, deadline_s, stream,
                reader, writer, tspan)
        except _ClientGone:
            if tspan is not None:
                tspan.end(status="client_gone")
            raise
        except BaseException:
            if tspan is not None:
                tspan.end(status="error")
            raise
        finally:
            self._admitted[name] = max(0, self._admitted.get(name, 1) - 1)
        if tspan is not None:
            tags: Dict[str, Any] = {}
            if attempts > 1:
                tags["retried"] = True  # retry hops are always retained
            slo = float(_knob("serve_slo_latency_s", 0.0))
            if slo > 0 and time.time() - tspan.start > slo:
                tags["slo_miss"] = True
            tspan.end(status=outcome, **tags)

    async def _dispatch(self, router, name: str, method_name: str,
                        args: tuple, deadline_s: float, stream: bool,
                        reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter,
                        tspan=None) -> Tuple[str, int]:
        """Returns (outcome, attempts_used) for the root trace span —
        every return path has written the HTTP response."""
        from ray_tpu_torch.core.exceptions import (ActorDiedError, TaskError,
                                             WorkerCrashedError)
        from ray_tpu_torch.serve.batching import (ModelSwapFailed,
                                            ReplicaOverloaded,
                                            RequestCancelled,
                                            RequestDeadlineExceeded,
                                            RequestPrefillLost)

        rid = f"http-{self._rid_prefix}-{next(self._rid)}"
        # multiplexed deployments: the request's model id steers the
        # router toward replicas where the model is already resident
        model: Optional[str] = None
        if args and isinstance(args[0], dict) and args[0].get("model"):
            model = str(args[0]["model"])
        attempts = max(1, int(_knob("serve_request_retries", 3)))
        deadline = time.monotonic() + deadline_s
        exclude: list = []
        pre_exclude: list = []
        # disaggregated deployment: chain prompt pass -> decode, KV
        # pages travelling between the tiers as refs (never through
        # the proxy)
        prefill_name = router.prefill_for(name) \
            if method_name == "__call__" else None
        last_death: Optional[BaseException] = None
        root_ctx = tspan.ctx() if tspan is not None else None
        for attempt in range(attempts):
            await _fp.afailpoint("serve.proxy.dispatch")
            dspan = _trace.start_span("proxy.dispatch", parent=root_ctx,
                                      attempt=attempt)
            dctx = dspan.ctx() if dspan is not None else None
            # every arm below sets dstatus and returns/raises/continues;
            # ONE finally ends the attempt's span, so a future exception
            # arm cannot leak it (a lost span reads as unattributed gap)
            dstatus = "error"
            dtags: Dict[str, Any] = {}
            try:
                # PREFILL tier first: its assign may wait for capacity,
                # and waiting must not pin a decode slot (a saturated
                # prefill tier would otherwise make the decode tier
                # look full while doing no decode work)
                pre_key = None
                pre_ref = None
                if prefill_name is not None:
                    try:
                        pre_replica, pre_key = await router.assign_async(
                            prefill_name,
                            timeout_s=max(0.05,
                                          deadline - time.monotonic()),
                            exclude=tuple(pre_exclude))
                    except (KeyError, RuntimeError) as e:
                        dstatus = "no_replica"
                        await self._write_json(writer, 503,
                                               {"error": str(e)})
                        return "error", attempt + 1
                    with _trace.use_ctx(dctx):
                        pre_ref = pre_replica.handle_request.remote(
                            "__prefill__", args, {},
                            deadline_s=max(0.05,
                                           deadline - time.monotonic()),
                            request_id=rid)
                aspan = _trace.start_span("router.assign", parent=dctx)
                # "error" until the assign SUCCEEDS: the finally must
                # not touch `key` (unbound) when e.g. a CancelledError
                # escapes the await
                astatus = "error"
                try:
                    replica, key = await router.assign_async(
                        name,
                        timeout_s=max(0.05, deadline - time.monotonic()),
                        exclude=tuple(exclude), model=model)
                    astatus = "ok"
                except KeyError as e:
                    astatus = dstatus = "unknown_deployment"
                    await self._write_json(writer, 404,
                                           {"error": str(e)})
                    # NOT "error": a bad URL is client junk, and junk
                    # must be tail-SAMPLED, not always-retained — a
                    # scanner hammering 404s would otherwise evict the
                    # real anomaly traces from the bounded ring
                    return "unknown_deployment", attempt + 1
                except RuntimeError as e:
                    astatus = dstatus = "no_replica"
                    await self._write_json(writer, 503,
                                           {"error": str(e)})
                    return "error", attempt + 1
                finally:
                    if astatus != "ok" and pre_key is not None:
                        # the prefill slot was taken above; its result
                        # is abandoned with the failed decode assign
                        router.release(pre_key)
                    if aspan is not None:
                        aspan.end(status=astatus, **(
                            {"replica": key[1].hex()[:12]}
                            if astatus == "ok" else {}))
                dtags["replica"] = key[1].hex()[:12]
                # the actor call is submitted under the dispatch span's
                # context, so the owner-side task span (and the
                # replica's exec/batch spans under it) join this
                # attempt's subtree
                with _trace.use_ctx(dctx):
                    if pre_ref is not None:
                        ref = replica.handle_request.remote(
                            "__decode__", (pre_ref,), {},
                            deadline_s=max(0.05,
                                           deadline - time.monotonic()),
                            request_id=rid, stream=stream)
                    else:
                        ref = replica.handle_request.remote(
                            method_name, args, {},
                            deadline_s=max(0.05,
                                           deadline - time.monotonic()),
                            request_id=rid, stream=stream)
                try:
                    result = await self._await_or_disconnect(
                        ref, reader, replica, rid)
                except (ActorDiedError, WorkerCrashedError) as e:
                    # the DECODE pick died mid-request (a prefill death
                    # arrives as RequestPrefillLost below, never this):
                    # exclude it and re-dispatch — the client gets an
                    # answer from a surviving replica
                    last_death = e
                    exclude.append(key[1])
                    router.mark_dead(key)
                    dstatus = "replica_died"
                    continue
                except RequestPrefillLost as e:
                    # the prefill result was lost (replica death OR a
                    # lost page object): exclude the pick for THIS
                    # request's retries but don't mark it dead — the
                    # replica may be healthy (a dead one leaves the
                    # table when the controller reaps it)
                    last_death = e
                    if pre_key is not None:
                        pre_exclude.append(pre_key[1])
                    dstatus = "prefill_lost"
                    continue
                except ModelSwapFailed as e:
                    # the replica couldn't make the model resident:
                    # exclude the pick and retry elsewhere — do NOT
                    # mark it dead, its resident models keep serving
                    last_death = e
                    exclude.append(key[1])
                    dstatus = "model_swap_failed"
                    continue
                except ReplicaOverloaded as e:
                    dstatus = "shed"
                    retry_after = getattr(e, "retry_after_s", 1.0)
                    await self._write_json(
                        writer, 429,
                        {"error": "replica overloaded",
                         "retry_after_s": retry_after},
                        (("retry-after",
                          f"{max(1, int(retry_after + 0.999))}"),))
                    return "shed", attempt + 1
                except RequestDeadlineExceeded as e:
                    dstatus = "deadline"
                    await self._write_json(
                        writer, 504,
                        {"error": f"deadline exceeded: {e}"})
                    return "deadline", attempt + 1
                except RequestCancelled:
                    dstatus = "client_gone"
                    raise _ClientGone()  # our cancel racing the reply
                except TaskError as e:
                    # app errors whose cause was unpicklable arrive
                    # wrapped
                    dstatus = "error"
                    await self._write_json(writer, 500,
                                           {"error": str(e)})
                    return "error", attempt + 1
                except _ClientGone:
                    dstatus = "client_gone"
                    raise
                except Exception as e:  # noqa: BLE001 — transport-level
                    dstatus = "error"
                    await self._write_json(writer, 500,
                                           {"error": str(e)})
                    return "error", attempt + 1
                finally:
                    router.release(key)
                    if pre_key is not None:
                        router.release(pre_key)
                dstatus = "ok"
                if stream and isinstance(result, (list, tuple)):
                    await self._write_stream(writer, result)
                else:
                    await self._write_json(writer, 200,
                                           {"result": result})
                return "ok", attempt + 1
            finally:
                if dspan is not None:
                    dspan.end(status=dstatus, **dtags)
        await self._write_json(
            writer, 503,
            {"error": f"all {attempts} dispatch attempts hit dying "
                      f"replicas: {last_death}"})
        return "error", attempts

    async def _await_or_disconnect(self, ref, reader: asyncio.StreamReader,
                                   replica, rid: str):
        """Wait for the result while watching the connection: a client
        that goes away mid-request cancels the replica-side work (the
        batcher frees its slot at the next step boundary)."""

        async def _get():
            return await ref

        loop = asyncio.get_running_loop()
        result_t = asyncio.ensure_future(_get())
        eof_t = asyncio.ensure_future(reader.read(1))
        try:
            done, _ = await asyncio.wait(
                {result_t, eof_t}, return_when=asyncio.FIRST_COMPLETED)
            if result_t in done:
                return result_t.result()
            # connection closed (or client wrote garbage — treat as
            # abandoned): free the batch slot, drop the task
            try:
                replica.cancel_request.remote(rid)
            except Exception:  # noqa: BLE001 — replica may be dying
                pass
            await loop.run_in_executor(None, self._cancel_quietly, ref)
            raise _ClientGone()
        finally:
            for t in (result_t, eof_t):
                if not t.done():
                    t.cancel()

    @staticmethod
    def _cancel_quietly(ref) -> None:
        try:
            ray_tpu_torch.cancel(ref)
        except Exception:  # noqa: BLE001 — best-effort
            pass

    @staticmethod
    def _status():
        from ray_tpu_torch import serve
        try:
            return list(serve.status().keys())
        except Exception:  # noqa: BLE001 — controller not up yet
            return []


_proxy_handle: Optional[Any] = None


def start_proxy(port: int = 0) -> tuple:
    """Start (or fetch) the cluster HTTP proxy; returns (host, port)."""
    global _proxy_handle
    try:
        _proxy_handle = ray_tpu_torch.get_actor("SERVE_HTTP_PROXY")
    except ValueError:
        _proxy_handle = HTTPProxy.options(
            name="SERVE_HTTP_PROXY", lifetime="detached",
            max_concurrency=32).remote(port=port)
    ray_tpu_torch.get(_proxy_handle.ready.remote(), timeout=60)
    return tuple(ray_tpu_torch.get(_proxy_handle.address.remote(), timeout=30))


def start_proxies_every_node(port: int = 0) -> Dict[str, tuple]:
    """Proxy-per-node deployment (reference ``http_state.py``
    ``HTTPProxyStateManager`` with ``ProxyLocation.EveryNode``): one
    pinned proxy actor per alive node, each routing with node-locality
    preference (its Router ranks same-node replicas first).  Returns
    {node_id_hex: (host, port)}.  Idempotent — existing proxies are
    reused; call again after adding nodes to cover them."""
    from ray_tpu_torch.util.scheduling_strategies import (
        NodeAffinitySchedulingStrategy)

    out: Dict[str, tuple] = {}
    handles: Dict[str, Any] = {}
    for node in ray_tpu_torch.nodes():
        if not node.get("alive", True):
            continue
        node_hex = node["node_id"].hex() \
            if isinstance(node["node_id"], bytes) else str(node["node_id"])
        name = f"SERVE_HTTP_PROXY-{node_hex[:12]}"
        try:
            handle = ray_tpu_torch.get_actor(name)
        except ValueError:
            handle = HTTPProxy.options(
                name=name, lifetime="detached", max_concurrency=32,
                scheduling_strategy=NodeAffinitySchedulingStrategy(
                    node_id=node_hex, soft=False),
            ).remote(port=port)
        handles[node_hex] = handle
    for node_hex, handle in handles.items():
        ray_tpu_torch.get(handle.ready.remote(), timeout=60)
        out[node_hex] = tuple(
            ray_tpu_torch.get(handle.address.remote(), timeout=30))
    return out
