"""Asyncio message transport used by every control-plane service.

Parity: the reference's gRPC layer (``src/ray/rpc/grpc_server.h``) plus its
long-poll pubsub push channel (``src/ray/pubsub/``).  One framed protocol
covers both: request/reply correlated by message id, and unsolicited PUSH
frames for subscriptions.  Payloads are pickled Python structures; large
tensors never travel this path (they go through the shared-memory object
plane), so pickling cost is bounded by control-message size.

Frame layout: ``[8B LE length][1B version][8B LE msg_id][1B kind]
[payload]`` where payload is ``pickle((method, data))`` and length counts
everything after the length field.  Version, correlation id, and kind
ride the HEADER — outside the pickle — so a frame from an incompatible
peer is rejected with a structured error before any payload bytes are
interpreted (parity: the reference's versioned protobuf schemas).
Payload shapes for the core control-plane methods are declared in
``core/messages.py`` and validated at dispatch.

Transport: a raw ``asyncio.Protocol`` (not StreamReader/Writer) — frames
are parsed in ``data_received`` with zero coroutine overhead and all
frames arriving in one TCP segment dispatch in one tight loop; outbound
frames produced within one event-loop tick coalesce into a single
transport write.  On nop-task storms the reader-coroutine version spent
~40% of loop time in readexactly wakeups.
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import pickle
import random
import struct
import time
from dataclasses import dataclass
from typing import Any, Awaitable, Callable, Dict, Optional, Tuple

from ray_tpu_torch.core.messages import validate as _validate_schema
from ray_tpu_torch.core import telemetry as _tm
from ray_tpu_torch.core import tracing as _trace
from ray_tpu_torch.util import failpoint as _fp

logger = logging.getLogger(__name__)

#: Wire-protocol version (parity: the reference's versioned protobuf
#: schemas).  Carried on EVERY frame header (plus the registration
#: handshakes); a mismatched frame gets a structured per-message
#: rejection at the boundary instead of an unpickle traceback.
#: v3: out-of-band payload frames (KIND_OOB_FLAG + payload-length
#: prefix in the frame body) for the object-transfer data plane.
PROTOCOL_VERSION = 3

_LEN = struct.Struct("<Q")
#: post-length header: [1B version][8B LE msg_id][1B kind]
_HDR = struct.Struct("<BQB")
_PLEN = struct.Struct("<Q")

KIND_REQ = 0
KIND_REP = 1
KIND_ERR = 2
KIND_PUSH = 3
#: kind-byte flag: an out-of-band payload (raw bytes, outside the
#: pickle) is appended to the frame as [8B payload_len][pickle][payload]
KIND_OOB_FLAG = 0x40
KIND_MASK = 0x3F

Address = Tuple[str, int]


class OobPayload:
    """Reply wrapper carrying a bulk buffer OUT of the pickle stream.

    ``meta`` rides the pickled frame body as usual; ``payload`` (any
    bytes-like — typically a pinned object-store arena view) is appended
    to the frame raw.  The object-transfer data plane uses this to cut
    per-chunk copies: the sender never pickles the chunk, and a receiver
    that registered a ``sink`` (see :meth:`Connection.start_call`)
    consumes it straight out of the receive buffer — one copy from
    socket buffer to destination instead of three.  A receiver without a
    sink gets the whole ``OobPayload`` back with ``payload`` as bytes.
    """

    __slots__ = ("meta", "payload")

    def __init__(self, meta: Any, payload):
        self.meta = meta
        self.payload = payload


class RpcError(Exception):
    """Remote handler raised; message carries the remote repr."""


class ConnectionLost(Exception):
    pass


class RpcDeadlineExceeded(RpcError):
    """A retried call chain ran out of its total deadline budget."""


#: Methods safe to retry blindly after they MAY have executed once.
#: Reads are trivially safe; the mutations listed are keyed on a
#: caller-supplied id (node/worker/actor/token) or naturally converge
#: (kv_put overwrites, kv_del/object_release/unsubscribe are no-ops the
#: second time, return_worker/cancel_lease hit an already-settled entry,
#: health_report is per-beat state).  Everything else — push_task(s),
#: push_actor_task(s), request_worker_lease, lease_worker_for_actor,
#: register_job, register_actor, object_create/seal — either executes
#: user code, allocates a resource, or assigns an id, and must only be
#: retried by its caller's own dedup/redispatch logic.
IDEMPOTENT_METHODS = frozenset({
    # pure reads
    "ping", "get_nodes", "kv_get", "kv_keys", "get_actor", "list_actors",
    "get_cluster_load", "get_function", "store_info", "store_stats",
    "debug_state", "get_metrics", "list_jobs", "get_task_events",
    "get_cluster_stats", "list_events", "object_contains", "list_workers",
    "list_objects", "stack_traces", "list_placement_groups",
    "get_object_locations", "object_pull_chunk", "clock_sync", "get_spans",
    "get_trace", "list_traces", "get_timeseries", "get_alerts", "healthz",
    "list_incidents", "get_incident",
    # keyed on (source, pid): a replayed tail dedups in the handler
    "report_flight_tail",
    # keyed / convergent mutations
    "register_node", "register_worker", "subscribe", "unsubscribe",
    "kv_put", "kv_del", "health_report", "actor_started",
    # keyed on each entry's actor_id: a replayed batch returns the
    # existing directory entries instead of re-registering
    "register_actor_batch",
    "object_release", "return_worker", "cancel_lease", "cancel_task",
    # report_spans is deliberately NOT here: its handler appends, so a
    # retry-after-send would duplicate spans (flush loops drop instead)
    "report_metrics", "report_task_events", "drain_node", "reattach_job",
    # transfer bookkeeping: pull_start re-pins idempotently (the holder
    # keeps one pin per link), pull_end/location updates converge
    "object_pull_end", "object_location_added", "object_location_removed",
})


def is_idempotent(method: str) -> bool:
    return method in IDEMPOTENT_METHODS


@dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff with jitter and a total deadline budget
    (parity: the reference GcsRpcClient's retry/backoff and gRPC
    service-config retryPolicy).  ``max_attempts`` counts the first try;
    ``deadline_s`` caps the WHOLE chain — per-attempt timeouts shrink to
    whatever budget remains, so a retried call can never outlive its
    deadline no matter how many attempts fit."""

    max_attempts: int = 5
    base_delay_s: float = 0.1
    max_delay_s: float = 5.0
    multiplier: float = 2.0
    jitter: float = 0.2
    deadline_s: Optional[float] = 30.0

    @classmethod
    def from_config(cls, config=None) -> "RetryPolicy":
        if config is None:
            from ray_tpu_torch.core.config import get_config
            config = get_config()
        deadline = getattr(config, "rpc_call_deadline_s", 30.0)
        return cls(
            max_attempts=max(1, int(getattr(config, "rpc_max_retries", 5))),
            base_delay_s=getattr(config, "rpc_retry_delay_s", 0.1),
            max_delay_s=getattr(config, "rpc_backoff_max_s", 5.0),
            multiplier=getattr(config, "rpc_backoff_multiplier", 2.0),
            jitter=getattr(config, "rpc_backoff_jitter", 0.2),
            deadline_s=deadline if deadline and deadline > 0 else None,
        )

    def backoff_delay(self, retry_index: int, rng: random.Random) -> float:
        raw = min(self.max_delay_s,
                  self.base_delay_s * self.multiplier ** retry_index)
        if self.jitter:
            raw *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, raw)


#: process-local jitter stream; seeded so a test re-run reproduces the
#: same backoff schedule (determinism > cross-process decorrelation — a
#: cluster's processes still decorrelate via their differing call mixes)
_retry_rng = random.Random(0x52504331)


def gcs_reconnect_delay(attempt: int, config,
                        rng: Optional[random.Random] = None) -> float:
    """Jittered exponential backoff for the GCS reconnect loops (worker
    ``_reconnect_head``, raylet ``_try_gcs_reconnect``).  Full jitter
    (uniform over [half-base, current-ceiling]) instead of a fixed
    sleep: when a whole fleet loses the head at once, decorrelated
    delays keep the restarted GCS from eating every re-registration in
    one synchronized stampede wave.

    ``attempt`` is 0-based; the ceiling is
    ``gcs_reconnect_backoff_base_s * 2**attempt`` capped at
    ``gcs_reconnect_backoff_max_s``."""
    base = max(0.01, float(getattr(config,
                                   "gcs_reconnect_backoff_base_s", 0.2)))
    cap = max(base, float(getattr(config,
                                  "gcs_reconnect_backoff_max_s", 5.0)))
    ceiling = min(cap, base * (2.0 ** max(0, attempt)))
    return (rng or _retry_rng).uniform(base * 0.5, ceiling)


async def call_with_retry(get_conn, method: str, data: Any = None, *,
                          policy: Optional[RetryPolicy] = None,
                          timeout: Optional[float] = None,
                          idempotent: Optional[bool] = None,
                          invalidate: Optional[
                              Callable[[Optional["Connection"]],
                                       None]] = None
                          ) -> Any:
    """One retried call chain with backoff + deadline budget.

    ``get_conn``: async callable returning a live :class:`Connection`
    (called fresh each attempt so the caller can reconnect between
    attempts); ``invalidate`` is called with the FAILED attempt's
    connection (or None if none was obtained) before a retry, so the
    caller can drop exactly that connection from its pool — never a
    fresh one another coroutine raced in.

    Classification: failures while OBTAINING the connection (OSError,
    ConnectionLost, TimeoutError, an armed connect failpoint) are always
    retryable — no request bytes went out.  Failures after the request
    may have been sent (ConnectionLost, per-attempt timeout) are retried
    only when the method is idempotent (callee keyed/convergent — see
    ``IDEMPOTENT_METHODS``) or the caller forces ``idempotent=True``
    because it dedupes.  A structured remote error (``RpcError``) is
    never retried: the peer is healthy and deterministic."""
    if policy is None:
        policy = RetryPolicy.from_config()
    if idempotent is None:
        idempotent = is_idempotent(method)
    loop = asyncio.get_running_loop()
    deadline = (loop.time() + policy.deadline_s
                if policy.deadline_s is not None else None)

    def _remaining() -> Optional[float]:
        if deadline is None:
            return None
        return deadline - loop.time()

    def _attempt_timeout() -> Optional[float]:
        rem = _remaining()
        if rem is None:
            return timeout
        if timeout is None:
            return max(rem, 0.001)
        return max(min(timeout, rem), 0.001)

    last_exc: Optional[BaseException] = None
    failed_conn: Optional[Connection] = None
    chain_start = time.time()
    for attempt in range(policy.max_attempts):
        if attempt:
            if invalidate is not None:
                invalidate(failed_conn)
            failed_conn = None
            delay = policy.backoff_delay(attempt - 1, _retry_rng)
            rem = _remaining()
            if rem is not None and rem <= delay:
                break  # budget can't fund another attempt
            _tm.rpc_retry(method)
            await asyncio.sleep(delay)
        raw = get_conn()
        try:
            conn = await asyncio.wait_for(_ensure_coro(raw),
                                          _attempt_timeout())
        except (ConnectionLost, OSError, asyncio.TimeoutError,
                _fp.FailpointError) as e:
            if hasattr(raw, "close") and not isinstance(raw, Connection):
                raw.close()  # un-awaited coroutine (cancelled pre-start)
            last_exc = e  # nothing was sent: always retryable
            continue
        try:
            result = await conn.call(method, data,
                                     timeout=_attempt_timeout())
        except RpcDeadlineExceeded:
            raise
        except (ConnectionLost, asyncio.TimeoutError,
                _fp.FailpointError) as e:
            last_exc = e
            failed_conn = conn
            if not idempotent:
                raise
            continue
        if attempt:
            # a chain that actually retried is a timeline-worthy anomaly
            _tm.record_span("rpc_retry", f"rpc:{method}", chain_start,
                            time.time(), attempts=attempt + 1,
                            outcome="ok")
        return result
    _tm.rpc_deadline_exceeded(method)
    _tm.record_span("rpc_retry", f"rpc:{method}", chain_start, time.time(),
                    attempts=policy.max_attempts, outcome="deadline",
                    error=f"{type(last_exc).__name__}: {last_exc}")
    raise RpcDeadlineExceeded(
        f"{method} failed after {policy.max_attempts} attempt(s)"
        + (f" within {policy.deadline_s:.1f}s" if policy.deadline_s else "")
        + f": {type(last_exc).__name__}: {last_exc}")


async def _ensure_coro(value):
    # inspect (not asyncio) iscoroutine: the asyncio variant also
    # matches plain generators before 3.11
    import inspect
    if inspect.iscoroutine(value) or isinstance(value, asyncio.Future):
        return await value
    return value


class _FrameProtocol(asyncio.BufferedProtocol):
    """Length-prefixed frame parser bound to one Connection.

    A ``BufferedProtocol``: the transport ``recv_into``s the parse
    buffer directly, so inbound bytes are copied exactly once from the
    socket into ``_buf`` (the default ``Protocol`` path allocates a
    fresh bytes object per recv and we'd append it into the parse buffer
    — two copies per byte, which dominated multi-MiB object-transfer
    frames on slow-memcpy virtualized hosts)."""

    #: always expose at least this much writable space to recv_into
    _MIN_READ = 256 * 1024

    def __init__(self, handler: Optional["Server"] = None,
                 on_close: Optional[Callable[["Connection"], None]] = None,
                 server_side: bool = False):
        self._handler = handler
        self._on_close = on_close
        self._server_side = server_side
        self._buf = bytearray(self._MIN_READ)
        self._start = 0  # parse position
        self._end = 0    # filled position
        self.conn: Optional[Connection] = None

    def connection_made(self, transport) -> None:
        # large kernel buffers: fewer (expensive) syscalls per transfer
        # frame and less write-pause churn under windowed pulls
        sock = transport.get_extra_info("socket")
        if sock is not None:
            import socket as socket_mod
            for opt in (socket_mod.SO_RCVBUF, socket_mod.SO_SNDBUF):
                try:
                    sock.setsockopt(socket_mod.SOL_SOCKET, opt, 4 << 20)
                except OSError:
                    pass
        self.conn = Connection(transport, self, handler=self._handler,
                               on_close=self._on_close)
        # only server-ACCEPTED links join server.connections / fire the
        # on_connection hook; client-initiated links may carry a handler
        # (so the peer can call back) without being tracked
        if self._server_side and self._handler is not None:
            self._handler._on_connect(self.conn)

    def connection_lost(self, exc) -> None:
        if self.conn is not None:
            self.conn._teardown()

    def pause_writing(self) -> None:
        if self.conn is not None:
            self.conn._writable.clear()

    def resume_writing(self) -> None:
        if self.conn is not None:
            self.conn._writable.set()

    def get_buffer(self, sizehint: int) -> memoryview:
        buf = self._buf
        avail = len(buf) - self._end
        if avail < self._MIN_READ:
            if self._start:
                # compact the consumed prefix (bounded: runs at most
                # once per buffer-full of parsed frames)
                n = self._end - self._start
                buf[:n] = buf[self._start:self._end]
                self._start = 0
                self._end = n
                avail = len(buf) - n
            while avail < self._MIN_READ:
                try:
                    buf += bytes(len(buf))  # double in place
                except BufferError:
                    # someone still exports a view of this buffer (an
                    # arena sink mid-copy on another conn's frame, a
                    # transport read view): bytearray resize is illegal
                    # with live exports, so move the unparsed region to
                    # a fresh buffer instead — the old one stays alive
                    # (and intact) exactly as long as its exports do
                    new = bytearray(max(len(buf) * 2, self._MIN_READ))
                    n = self._end - self._start
                    new[:n] = buf[self._start:self._end]
                    self._buf = buf = new
                    self._start = 0
                    self._end = n
                avail = len(buf) - self._end
        return memoryview(buf)[self._end:]

    def buffer_updated(self, nbytes: int) -> None:
        _tm.add_bytes_received(nbytes)
        self._end += nbytes
        self._parse()
        if self._start == self._end:
            self._start = self._end = 0  # cheap reset, no compaction
            if len(self._buf) > (4 << 20):
                # shrink after a large-transfer backlog: long-lived
                # peer links must not pin their high-water buffer
                self._buf = bytearray(self._MIN_READ)
        elif self._start > (1 << 20):
            # keep long-lived partial frames anchored near the buffer
            # head so get_buffer doesn't keep doubling
            n = self._end - self._start
            self._buf[:n] = self._buf[self._start:self._end]
            self._start = 0
            self._end = n

    def _parse(self) -> None:
        buf = self._buf
        offset = self._start
        total = self._end
        conn = self.conn
        while True:
            if total - offset < 8:
                break
            (length,) = _LEN.unpack_from(buf, offset)
            if total - offset - 8 < length:
                break
            frame_end = offset + 8 + length
            body = offset + 8
            offset = frame_end
            if length < _HDR.size:
                logger.error("runt frame (%d bytes) from %s", length,
                             conn.peername if conn else "?")
                continue
            version, msg_id, kind = _HDR.unpack_from(buf, body)
            if version != PROTOCOL_VERSION:
                # structured per-message rejection BEFORE any payload
                # bytes are interpreted — a mixed-version cluster fails
                # at the boundary with a clear error, not mid-unpickle
                if conn is not None:
                    conn._reject_version(msg_id, kind & KIND_MASK, version)
                continue
            pickle_start = body + _HDR.size
            pickle_end = frame_end
            oob_view = None
            if kind & KIND_OOB_FLAG:
                kind &= KIND_MASK
                if frame_end - pickle_start < _PLEN.size:
                    logger.error("runt OOB frame from %s",
                                 conn.peername if conn else "?")
                    continue
                (oob_len,) = _PLEN.unpack_from(buf, pickle_start)
                pickle_start += _PLEN.size
                if oob_len > frame_end - pickle_start:
                    logger.error("bad OOB length from %s",
                                 conn.peername if conn else "?")
                    continue
                pickle_end = frame_end - oob_len
                oob_view = memoryview(buf)[pickle_end:frame_end]
            try:
                try:
                    method, payload = pickle.loads(
                        memoryview(buf)[pickle_start:pickle_end])
                except Exception:
                    logger.exception("undecodable frame from %s",
                                     conn.peername if conn else "?")
                    continue
                if conn is not None:
                    try:
                        conn._on_frame(msg_id, kind, method, payload,
                                       oob_view)
                    except Exception:
                        # a malformed frame must skip, not fatal-error the
                        # transport and kill every in-flight RPC on the link
                        logger.exception("bad frame from %s", conn.peername)
            finally:
                if oob_view is not None:
                    # the view must be consumed synchronously — a live
                    # export would make buffer compaction/growth raise
                    oob_view.release()
        self._start = offset


class Connection:
    """One bidirectional peer link; usable as client and/or server side."""

    def __init__(self, transport, protocol: _FrameProtocol,
                 handler: Optional["Server"] = None,
                 on_close: Optional[Callable[["Connection"], None]] = None):
        self._transport = transport
        self._protocol = protocol
        self._handler = handler
        self._on_close = on_close
        self._msg_ids = itertools.count(1)
        self._pending: Dict[int, asyncio.Future] = {}
        #: msg_id -> callable(memoryview) consuming a reply's OOB
        #: payload synchronously at frame arrival (object-transfer
        #: chunks land straight in the store arena, no intermediate
        #: bytes object)
        self._payload_sinks: Dict[int, Callable] = {}
        self._push_handler: Optional[Callable[[str, Any], None]] = None
        self._closed = False
        self.peername = transport.get_extra_info("peername")
        # Outbound frames produced within one event-loop tick coalesce
        # into a single transport write (one send(2) instead of one per
        # frame) — the per-frame syscall dominated nop-task storms.
        self._wbuf: list = []
        self._wflush_scheduled = False
        self._loop = asyncio.get_running_loop()
        self._writable = asyncio.Event()
        self._writable.set()
        #: request handlers currently running on this link (drain gate
        #: for graceful process exit — see Connection.drain_outbound)
        self._dispatching = 0
        # Application state slot (e.g. the worker/node this conn belongs to).
        self.context: Dict[str, Any] = {}

    # -- receive path ----------------------------------------------------
    def _reject_version(self, msg_id: int, kind: int, peer_ver: int) -> None:
        if peer_ver == 0x80:
            # pickle protocol magic: the peer speaks the pre-header (v1)
            # framing and cannot parse ANY reply we send — close the link
            # so its RPCs fail fast with ConnectionLost instead of
            # hanging on garbage replies
            logger.error(
                "peer %s speaks the pre-header wire framing (v1); this "
                "process speaks v%d — closing (upgrade the older side)",
                self.peername, PROTOCOL_VERSION)
            self._teardown()
            return
        msg = (f"wire protocol mismatch: frame is v{peer_ver}, this "
               f"process speaks v{PROTOCOL_VERSION} — upgrade the older "
               f"side")
        logger.error("%s (from %s)", msg, self.peername)
        if kind == KIND_REQ and not self._closed:
            # headers are version-stable from v2 on, so the newer peer
            # can correlate this structured rejection to its request
            try:
                self._send_frame(msg_id, KIND_ERR, "_protocol", msg)
            except Exception:
                self._teardown()
        elif kind in (KIND_REP, KIND_ERR):
            # a reply from a mismatched peer: fail OUR pending call with
            # the structured error — dropping it would strand callers
            # that wait without a timeout
            fut = self._pending.pop(msg_id, None)
            if fut is not None and not fut.done():
                fut.set_exception(RpcError(msg))

    def _on_frame(self, msg_id: int, kind: int, method: str,
                  data: Any, oob: Optional[memoryview] = None) -> None:
        if kind == KIND_REQ:
            self._loop.create_task(self._dispatch(msg_id, method, data))
        elif kind == KIND_REP:
            fut = self._pending.pop(msg_id, None)
            sink = self._payload_sinks.pop(msg_id, None)
            if oob is not None:
                if sink is not None:
                    try:
                        sink(oob)
                    except Exception as e:  # noqa: BLE001 — surface to
                        if fut is not None and not fut.done():  # caller
                            fut.set_exception(
                                RpcError(f"payload sink failed: {e!r}"))
                        return
                else:
                    data = OobPayload(data, bytes(oob))
            if fut is not None and not fut.done():
                fut.set_result(data)
        elif kind == KIND_ERR:
            self._payload_sinks.pop(msg_id, None)
            fut = self._pending.pop(msg_id, None)
            if fut is not None and not fut.done():
                fut.set_exception(RpcError(data))
        elif kind == KIND_PUSH:
            try:
                if self._push_handler is not None:
                    self._push_handler(method, data)
                elif self._handler is not None:
                    # server side: route to service push_<channel>
                    self._handler.dispatch_push(self, method, data)
            except Exception:
                logger.exception("push handler failed: %s", method)

    def set_push_handler(self, fn: Callable[[str, Any], None]) -> None:
        self._push_handler = fn

    # -- send path -------------------------------------------------------
    def _send_frame(self, msg_id: int, kind: int, method: str,
                    data: Any) -> None:
        oob = None
        if isinstance(data, OobPayload):
            oob = data.payload
            data = data.meta
            kind |= KIND_OOB_FLAG
        body = pickle.dumps((method, data), protocol=5)
        if oob is None:
            _tm.add_bytes_sent(8 + _HDR.size + len(body))
            self._wbuf.append(_LEN.pack(_HDR.size + len(body)))
            self._wbuf.append(_HDR.pack(PROTOCOL_VERSION, msg_id, kind))
            self._wbuf.append(body)
        else:
            n = len(oob)
            _tm.add_bytes_sent(8 + _HDR.size + _PLEN.size + len(body) + n)
            self._wbuf.append(_LEN.pack(
                _HDR.size + _PLEN.size + len(body) + n))
            self._wbuf.append(_HDR.pack(PROTOCOL_VERSION, msg_id, kind))
            self._wbuf.append(_PLEN.pack(n))
            self._wbuf.append(body)
            # appended as its own buffer: _flush_wbuf hands big items to
            # the transport un-joined, so the bulk bytes go from their
            # source buffer (e.g. a pinned arena view) to the socket
            # without an intermediate copy
            self._wbuf.append(oob)
        if not self._wflush_scheduled:
            self._wflush_scheduled = True
            self._loop.call_soon(self._flush_wbuf)

    #: frames at or above this size are handed to the transport on their
    #: own instead of being joined with neighbors: re-joining multi-MiB
    #: object-transfer chunks copied every chunk an extra time
    _BIG_FRAME = 1 << 20

    def _flush_wbuf(self) -> None:
        self._wflush_scheduled = False
        if not self._wbuf:
            return
        items, self._wbuf = self._wbuf, []
        if self._closed:
            return
        small: list = []
        try:
            for item in items:
                if len(item) >= self._BIG_FRAME:
                    if small:
                        self._transport.write(b"".join(small))
                        small = []
                    self._transport.write(item)
                else:
                    small.append(item)
            if small:
                self._transport.write(
                    small[0] if len(small) == 1 else b"".join(small))
        except Exception:
            self._teardown()

    def _teardown(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._wbuf:
            # hand already-queued frames (e.g. a reply written this tick)
            # to the transport so close() can flush them
            try:
                self._transport.write(b"".join(self._wbuf))
            except Exception:
                pass
            self._wbuf.clear()
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionLost())
        self._pending.clear()
        self._payload_sinks.clear()
        # wake any drain() waiter parked on a paused transport
        self._writable.set()
        try:
            self._transport.close()
        except Exception:
            pass
        if self._on_close is not None:
            try:
                self._on_close(self)
            except Exception:
                logger.exception("on_close callback failed")

    async def _dispatch(self, msg_id: int, method: str, data: Any) -> None:
        self._dispatching += 1
        # trace-context propagation: a request payload carrying the
        # ``"trace"`` carrier re-activates it for the handler (and for
        # everything the handler awaits — contextvars ride the task).
        # Untraced requests pay one cached-bool check; tracing off pays
        # the same.
        if _trace.enabled() and type(data) is dict:
            tctx = data.get("trace")
            if tctx is not None:
                _trace.set_current(_trace.ctx_of(tctx))
        try:
            try:
                if self._handler is None:
                    raise RpcError(f"no handler for {method}")
                # failpoint: delay/raise/kill BEFORE the handler runs —
                # models a stalled executor / a handler crash (dormant:
                # one module-global truth test)
                if _fp.active():
                    await _fp.afailpoint(f"rpc.{method}.handler_delay")
                result = await self._handler.dispatch(self, method, data)
                reply = (msg_id, KIND_REP, method, result)
            except Exception as e:
                logger.debug("handler %s raised", method, exc_info=True)
                reply = (msg_id, KIND_ERR, method,
                         f"{type(e).__name__}: {e}")
            if _fp.active():
                # failpoint: the handler ran but its reply is lost or
                # late (drop/delay) — the partial failure node-kill
                # chaos can never produce
                if await _fp.afailpoint(f"rpc.{method}.reply_drop"):
                    logger.warning("dropping %s reply (failpoint)", method)
                    return
            if not self._closed:
                try:
                    self._send_frame(*reply)
                except Exception:
                    self._teardown()
        finally:
            self._dispatching -= 1

    def start_call(self, method: str, data: Any = None,
                   sink: Optional[Callable] = None) -> asyncio.Future:
        """Queue the request frame and return the reply future.

        Frames are delivered in ``start_call`` order (the write buffer is
        FIFO and flushed once per loop tick), so callers that need ordered
        delivery (e.g. per-actor sequential submission) can sequence their
        ``start_call``s without waiting for replies.

        ``sink``: consumes the reply's out-of-band payload (a
        ``memoryview`` valid only for the duration of the call) the
        moment the frame arrives; the future then resolves to the
        reply's meta.  Replies without an OOB payload leave the sink
        uncalled.
        """
        if self._closed:
            raise ConnectionLost()
        msg_id = next(self._msg_ids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[msg_id] = fut
        if sink is not None:
            self._payload_sinks[msg_id] = sink
        if _fp.active():
            # failpoint: the request frame is lost on the wire (drop) or
            # the caller crashes at send (raise/kill); the pending
            # future is left to the caller's timeout/deadline budget
            if _fp.failpoint(f"rpc.{method}.request_drop"):
                logger.warning("dropping %s request (failpoint)", method)
                return fut
        self._send_frame(msg_id, KIND_REQ, method, data)
        return fut

    async def call(self, method: str, data: Any = None,
                   timeout: Optional[float] = None,
                   sink: Optional[Callable] = None) -> Any:
        t0 = self._loop.time()
        fut = self.start_call(method, data, sink=sink)
        try:
            if timeout is None:
                return await fut
            return await asyncio.wait_for(fut, timeout)
        finally:
            _tm.rpc_call_observed(method, self._loop.time() - t0)

    def push(self, channel: str, data: Any) -> None:
        """Fire-and-forget push (pubsub delivery, notifications)."""
        if self._closed:
            return
        try:
            self._send_frame(0, KIND_PUSH, channel, data)
        except Exception:
            self._teardown()

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def pending_dispatches(self) -> int:
        """Request handlers still running on this link (their replies
        are not yet queued)."""
        return self._dispatching

    def outbound_pending(self) -> int:
        """Bytes queued toward the peer: the per-tick coalescing buffer
        plus whatever the transport hasn't handed to the kernel yet."""
        n = sum(len(b) for b in self._wbuf)
        try:
            n += self._transport.get_write_buffer_size()
        except Exception:  # noqa: BLE001 — transport already closed
            pass
        return n

    async def drain_outbound(self, timeout: float = 2.0) -> bool:
        """Wait until every in-flight handler has queued its reply and
        the socket buffer is handed to the kernel (or the link closed).
        Returns False on deadline — the caller decides whether to exit
        anyway.  Used by graceful worker exit so a final reply is never
        torn off mid-flush (a completed task must not be reported as a
        worker crash)."""
        deadline = self._loop.time() + timeout
        while not self._closed and self._loop.time() < deadline:
            self._flush_wbuf()
            if self._dispatching == 0 and self.outbound_pending() == 0:
                return True
            await asyncio.sleep(0.005)
        return self._closed or (self._dispatching == 0
                                and self.outbound_pending() == 0)

    async def drain(self) -> None:
        self._flush_wbuf()
        await self._writable.wait()
        if self._closed:
            raise ConnectionLost()

    def close(self) -> None:
        self._teardown()


class Server:
    """Listens on a port; dispatches ``handle_<method>`` coroutines defined
    on a service object."""

    def __init__(self, service: Any, host: str = "127.0.0.1", port: int = 0,
                 validate_schemas: bool = True):
        self._service = service
        self._host = host
        self._port = port
        #: services whose method names overlap the core control plane
        #: with DIFFERENT payload shapes (e.g. the ray:// client proxy)
        #: opt out — the registry keys on bare method names
        self._validate_schemas = validate_schemas
        self._server: Optional[asyncio.AbstractServer] = None
        self.connections: set[Connection] = set()
        #: optional HandlerStats (util/event_stats.py) — when set, every
        #: dispatched handler records its wall duration (parity:
        #: instrumented_io_context handler stats).  Wall time includes
        #: awaits, so long-poll methods legitimately read "slow".
        self.handler_stats = None

    async def start(self) -> Address:
        loop = asyncio.get_running_loop()
        self._server = await loop.create_server(
            lambda: _FrameProtocol(handler=self,
                                   on_close=self._on_disconnect,
                                   server_side=True),
            self._host, self._port)
        sock = self._server.sockets[0]
        self._host, self._port = sock.getsockname()[:2]
        return (self._host, self._port)

    @property
    def address(self) -> Address:
        return (self._host, self._port)

    def _on_connect(self, conn: Connection) -> None:
        self.connections.add(conn)
        hook = getattr(self._service, "on_connection", None)
        if hook is not None:
            hook(conn)

    def _on_disconnect(self, conn: Connection) -> None:
        self.connections.discard(conn)
        hook = getattr(self._service, "on_disconnection", None)
        if hook is not None:
            hook(conn)

    async def dispatch(self, conn: Connection, method: str, data: Any) -> Any:
        handler: Optional[Callable[..., Awaitable[Any]]] = getattr(
            self._service, f"handle_{method}", None
        )
        if handler is None:
            raise RpcError(f"{type(self._service).__name__} has no method {method}")
        # typed boundary: registered control-plane methods reject
        # malformed payloads with a structured SchemaError naming the
        # method and field (core/messages.py)
        if self._validate_schemas:
            _validate_schema(method, data)
        stats = self.handler_stats
        if stats is None:
            return await handler(conn, data)
        import time as _time

        t0 = _time.monotonic()
        try:
            return await handler(conn, data)
        finally:
            stats.record(method, _time.monotonic() - t0)

    def dispatch_push(self, conn: Connection, channel: str, data: Any) -> None:
        handler = getattr(self._service, f"push_{channel}", None)
        if handler is not None:
            handler(conn, data)

    async def stop(self) -> None:
        # close live connections BEFORE wait_closed(): since 3.12
        # wait_closed blocks until every connection handler finishes
        for conn in list(self.connections):
            conn.close()
        if self._server is not None:
            self._server.close()
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2.0)
            except asyncio.TimeoutError:
                pass


async def connect(address: Address, handler: Optional[Server] = None,
                  timeout: float = 10.0) -> Connection:
    if _fp.active():
        # failpoint: connection establishment fails/stalls — models a
        # peer in a connect() backlog storm or a dropped SYN
        await _fp.afailpoint("rpc.connect")
    loop = asyncio.get_running_loop()
    _, protocol = await asyncio.wait_for(
        loop.create_connection(
            lambda: _FrameProtocol(handler=handler), address[0],
            address[1]),
        timeout)
    assert protocol.conn is not None
    return protocol.conn


class ConnectionPool:
    """Caches one connection per remote address (parity:
    ``core_worker_client_pool.h``)."""

    def __init__(self, handler: Optional[Server] = None):
        self._handler = handler
        self._conns: Dict[Address, Connection] = {}
        self._locks: Dict[Address, asyncio.Lock] = {}

    def get_if_connected(self, address: Address) -> Optional[Connection]:
        """Synchronous: the cached live connection, or None (for loop-
        thread fast paths that must not await)."""
        conn = self._conns.get(address)
        return conn if conn is not None and not conn.closed else None

    async def get(self, address: Address) -> Connection:
        conn = self._conns.get(address)
        if conn is not None and not conn.closed:
            return conn
        lock = self._locks.setdefault(address, asyncio.Lock())
        async with lock:
            conn = self._conns.get(address)
            if conn is not None and not conn.closed:
                return conn
            conn = await connect(address, handler=self._handler)
            self._conns[address] = conn
            return conn

    async def call(self, address: Address, method: str, data: Any = None,
                   *, timeout: Optional[float] = None,
                   policy: Optional[RetryPolicy] = None,
                   idempotent: Optional[bool] = None) -> Any:
        """Retried call through the pool: reconnects between attempts
        (dead cached connections are invalidated) under the policy's
        backoff + deadline budget.  Retry-after-send only happens for
        idempotent methods — see :func:`call_with_retry`."""
        return await call_with_retry(
            lambda: self.get(address), method, data, policy=policy,
            timeout=timeout, idempotent=idempotent,
            invalidate=lambda failed: self.invalidate_conn(address, failed))

    def invalidate(self, address: Address) -> None:
        conn = self._conns.pop(address, None)
        if conn is not None:
            conn.close()

    def invalidate_conn(self, address: Address,
                        conn: Optional[Connection]) -> None:
        """Drop/close exactly ``conn``, and only if this pool still
        caches it — never a fresh connection another coroutine raced in,
        and never a caller-owned link (e.g. the worker's registration
        conn) that merely timed out."""
        if conn is None:
            return
        if self._conns.get(address) is conn:
            self._conns.pop(address, None)
            conn.close()

    def close_all(self) -> None:
        for conn in self._conns.values():
            conn.close()
        self._conns.clear()
