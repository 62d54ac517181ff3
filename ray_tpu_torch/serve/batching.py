"""Continuous-batching replica runtime for autoregressive decode.

Parity model: the reference Serve's ``@serve.batch`` handles *one-shot*
batching (gather N requests, run once, scatter).  Autoregressive decode
on an XLA-compiled predictor breaks that model: a request is not one
call but a *sequence* of steps, and naive request-at-a-time serving
leaves the chip idle between requests while fixed-per-request shapes
force a fresh XLA compile whenever the prompt length moves.  This
module implements the production shape (vLLM/Orca-style **continuous
batching**, the Gemma-on-TPU serving recipe):

- one decode loop per replica owns a fixed pool of ``max_batch_size``
  slots; new requests are admitted into free slots **at step
  boundaries**, mid-flight — the batch never drains to empty before
  refilling;
- input shapes are **padding-bucketed**: the token buffer passed to the
  model is always ``[max_batch_size, bucket]`` where ``bucket`` comes
  from a small capped set of power-of-two lengths, so XLA compiles once
  per bucket instead of once per request shape;
- every request carries a **deadline**: expired requests are evicted at
  the next step boundary (their slot frees immediately), and an
  abandoned client can :meth:`ContinuousBatcher.cancel` to release its
  slot without waiting for the deadline;
- admission is bounded: when the pending queue exceeds
  ``max_queue_len`` the submit **sheds** (raises
  :class:`ReplicaOverloaded`) instead of growing an unbounded backlog —
  the ingress translates that into HTTP 429 + ``Retry-After``.

Engine protocol (duck-typed; :mod:`ray_tpu_torch.serve.toy_decoder` is the
reference implementation):

``begin_request(payload) -> state``
    Parse one request payload into a mutable per-request state dict
    with at least ``tokens`` (list[int] prompt) and ``max_new_tokens``.
``step(tokens, lengths, active) -> next_tokens``
    One decode step over the whole slot pool.  ``tokens`` is an int32
    array ``[max_batch_size, bucket]`` (right-padded with ``pad_token``),
    ``lengths`` an int32 ``[max_batch_size]`` of real lengths, ``active``
    a bool ``[max_batch_size]`` mask.  Returns one next token per slot
    (ignored for inactive slots), as an array or a torch tensor, which
    may still be in flight on the card: the batcher waits for it as the
    step's device time, then copies it to the host (:func:`host_array`).
    This is the hot path — its input shapes only change when the bucket
    does.
``finish_request(state) -> result``
    Build the response value once the request completes.
``eos_token`` (attribute, optional)
    Token id that terminates a sequence early; ``None`` decodes to
    ``max_new_tokens`` always.
``pad_token`` (attribute, optional, default 0)
    Fill value for padded positions.
"""

from __future__ import annotations

import sys
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ray_tpu_torch.core import device_telemetry as _dt
from ray_tpu_torch.core import flight_recorder as _flight
from ray_tpu_torch.core import telemetry as _tm
from ray_tpu_torch.core import tracing as _trace

__all__ = [
    "BatchingConfig", "ContinuousBatcher", "ModelSwapFailed",
    "ReplicaOverloaded", "RequestCancelled", "RequestDeadlineExceeded",
    "RequestPrefillLost", "default_buckets", "host_array",
]


def host_array(x: Any):
    """An engine's step output as a numpy array: a torch tensor (on the
    card or not) through ``.cpu().numpy()``, anything else through
    ``np.asarray``.  torch is looked up in ``sys.modules``: an engine
    that returned a tensor has imported it."""
    import numpy as np

    torch = sys.modules.get("torch")
    if torch is not None and isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class ReplicaOverloaded(Exception):
    """Raised at submit time when the replica's admission queue is full.
    Carries a retry hint so ingress layers can map it straight onto
    ``429 Too Many Requests`` + ``Retry-After``."""

    def __init__(self, deployment: str = "", queue_len: int = 0,
                 retry_after_s: float = 1.0):
        super().__init__(
            f"replica overloaded (queue={queue_len}); retry in "
            f"{retry_after_s:.1f}s")
        self.deployment = deployment
        self.queue_len = queue_len
        self.retry_after_s = retry_after_s

    def __reduce__(self):
        # keep the structured fields across the task-error pickle round
        # trip (default Exception pickling would replay the formatted
        # message into the ``deployment`` arg)
        return (type(self),
                (self.deployment, self.queue_len, self.retry_after_s))


class RequestDeadlineExceeded(Exception):
    """The request's deadline passed before decode finished; its batch
    slot was reclaimed at the step boundary."""


class RequestCancelled(Exception):
    """The client cancelled (or abandoned) the request; its batch slot
    was reclaimed at the step boundary."""


class RequestPrefillLost(Exception):
    """The prefill tier's result (KV pages) became unavailable before
    the decode replica could adopt it — typically the prefill replica
    died mid-handoff.  Retryable: the router re-runs the prompt pass on
    a surviving prefill replica; the DECODE replica is healthy and must
    NOT be marked dead."""


class ModelSwapFailed(Exception):
    """A multiplexed replica failed to page in the requested model's
    weights (arena ref lost, build error, injected fault).  Retryable:
    the router EXCLUDES this replica pick and tries another — the
    replica itself is healthy (its resident models keep serving) and
    must NOT be marked dead."""

    def __init__(self, deployment: str = "", model: str = ""):
        super().__init__(
            f"model {model!r} swap failed on deployment {deployment!r}")
        self.deployment = deployment
        self.model = model

    def __reduce__(self):
        # structured fields survive the task-error pickle round trip
        return (type(self), (self.deployment, self.model))


def default_buckets(max_seq_len: int, cap: int = 8) -> Tuple[int, ...]:
    """Powers of two up to ``max_seq_len`` (inclusive, rounded up),
    keeping at most ``cap`` buckets — each bucket is one XLA compile, so
    the set stays small.  When the range needs more than ``cap`` doubling
    steps the SMALLEST buckets are dropped (short prompts pad a little
    more; long prompts keep their granularity)."""
    buckets: List[int] = []
    b = 8
    while b < max_seq_len:
        buckets.append(b)
        b *= 2
    buckets.append(b)  # first power of two >= max_seq_len
    return tuple(buckets[-cap:])


@dataclass
class BatchingConfig:
    """Knobs for one replica's continuous batcher.  Travels inside
    ``DeploymentConfig.batching`` as a plain dict (cloudpickle-free)."""

    #: slot-pool size — the fixed batch dimension of every step call
    max_batch_size: int = 8
    #: hard cap on tokens per sequence (prompt + generated)
    max_seq_len: int = 256
    #: padding buckets (sorted ascending); () = default_buckets()
    bucket_lens: Tuple[int, ...] = ()
    #: cap on the bucket set when derived (one XLA compile per bucket)
    max_buckets: int = 8
    #: pending-queue cap; submits beyond it shed with ReplicaOverloaded
    max_queue_len: int = 64
    #: deadline applied when a request does not carry its own
    default_deadline_s: float = 30.0
    #: Retry-After hint attached to shed responses
    shed_retry_after_s: float = 1.0
    #: paged KV cache: tokens per page (0 = paged KV off — requests
    #: keep no arena-resident state, the pre-PR behavior)
    kv_page_tokens: int = 0
    #: page budget per replica; admission holds a request queued while
    #: its worst-case page demand exceeds the free budget (0 = the
    #: ``serve_kv_max_pages`` knob)
    kv_max_pages: int = 0
    #: shared prompt-PREFIX page cache (kv_cache.py chain table): cap on
    #: cached pages per replica, over and above ``kv_max_pages``.  0 =
    #: off.  Requires ``kv_page_tokens > 0``; a request whose prompt
    #: extends a cached chain adopts those pages and prefills only the
    #: tail (``state["prefix_len"]`` tells the engine how much to skip).
    prefix_cache_pages: int = 0

    def resolved_buckets(self) -> Tuple[int, ...]:
        buckets = tuple(sorted(self.bucket_lens)) or default_buckets(
            self.max_seq_len, self.max_buckets)
        if buckets[-1] < self.max_seq_len:
            buckets = buckets + (self.max_seq_len,)
        return buckets

    @classmethod
    def from_dict(cls, d: Optional[Dict[str, Any]]) -> "BatchingConfig":
        d = dict(d or {})
        if "bucket_lens" in d:
            d["bucket_lens"] = tuple(d["bucket_lens"])
        known = {f.name for f in cls.__dataclass_fields__.values()}  # type: ignore[attr-defined]
        return cls(**{k: v for k, v in d.items() if k in known})


@dataclass
class _Request:
    payload: Any
    future: Future
    deadline: float
    request_id: str
    enqueued_at: float
    state: Optional[Dict[str, Any]] = None
    slot: int = -1
    cancelled: bool = False
    generated: int = 0
    extras: Dict[str, Any] = field(default_factory=dict)
    #: streaming (?stream=1) request: its first generated token feeds
    #: the ray_tpu_serve_ttft_seconds histogram
    stream: bool = False
    #: trace carrier captured at submit (ambient context of the
    #: submitting handler thread); None = untraced, zero further cost
    trace: Optional[Dict[str, str]] = None
    #: wall-clock submit stamp (spans use wall time; enqueued_at stays
    #: monotonic for deadlines)
    t0_wall: float = 0.0
    #: prefilled paged state from a prefill replica (``{"export": ...,
    #: "tokens": [...], "meta": {...}}``): admission adopts the pages
    #: and skips begin_request/prefill entirely
    prefilled: Optional[Dict[str, Any]] = None
    #: live decode span (admission -> finish) of a traced request
    decode_span: Optional[Any] = None
    #: per-step spans already recorded (capped; see _STEP_SPAN_CAP)
    step_spans: int = 0


class ContinuousBatcher:
    """One replica's decode loop + admission queue.

    Thread model: submitters are the replica's request-handling threads
    (the actor's execution pool); one dedicated ``rtpu-serve-batcher``
    thread runs the decode loop.  Submitters block on a per-request
    Future, so the replica's ``max_concurrency`` still bounds in-flight
    requests end to end.

    Tracing: a traced request's per-step spans are capped (the decode
    span keeps the full step count in its ``steps`` tag) so a
    max_new_tokens=4096 request cannot flood the span buffer.
    """

    #: per-request cap on decode.step spans (full count rides the
    #: decode span's ``steps`` tag)
    _STEP_SPAN_CAP = 64

    def __init__(self, engine: Any, config: BatchingConfig,
                 deployment: str = "", kv_table: Any = None):
        self._engine = engine
        self._cfg = config
        self._deployment = deployment
        self._buckets = config.resolved_buckets()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queue: List[_Request] = []
        self._by_id: Dict[str, _Request] = {}
        self._slots: List[Optional[_Request]] = \
            [None] * config.max_batch_size
        self._active = 0
        self._stop = False
        self._next_id = 0
        # paged KV cache (kv_cache.py): request state lives as arena
        # pages; admission reserves pages, eviction frees them
        self._kv = kv_table
        if self._kv is None and config.kv_page_tokens > 0:
            from ray_tpu_torch.serve._internal import _serve_knob
            from ray_tpu_torch.serve.kv_cache import KVPageTable

            self._kv = KVPageTable(
                config.kv_page_tokens,
                config.kv_max_pages
                or int(_serve_knob("serve_kv_max_pages", 4096)),
                deployment,
                kv_payload=getattr(engine, "kv_page_payload", None),
                prefix_cache_pages=config.prefix_cache_pages)
        #: multiplexing engine (serve/multiplex.py): step() takes a
        #: per-slot model-id vector so one batch mixes models
        self._mux = bool(getattr(engine, "multiplexed", False))
        #: requests admitted this pass, awaiting (possibly expensive)
        #: prefill + paging OUTSIDE the lock on the decode thread
        self._newly_admitted: List[Tuple[int, _Request]] = []
        #: request_ids whose KV pages await freeing — _finish_locked
        #: only RECORDS the release; _drain_kv_releases performs it
        #: with the lock dropped, because page freeing reaches
        #: ray_tpu_torch.free (a blocking client RPC on the arena path) and
        #: holding self._lock across that round trip would stall every
        #: submit()/cancel() behind the network
        self._kv_release_pending: List[str] = []
        # stats the replica exports for routing/autoscaling/tests
        self._steps = 0
        self._step_shapes: set = set()
        self._shed_total = 0
        self._completed = 0
        self._occupancy_sum = 0.0
        self._latencies_ms: List[float] = []  # bounded ring, p99 source
        self._step_ms: List[float] = []  # decode-step durations (ring)
        # device-plane step attribution: phase ladder + goodput/MFU
        # (engine-declared FLOPs-per-token; 0 = goodput only)
        fpt = getattr(engine, "flops_per_token", 0.0)
        self._monitor = _dt.StepMonitor(
            "serve", name=f"serve.{deployment or 'batcher'}",
            deployment=deployment,
            flops_per_token=float(fpt() if callable(fpt) else fpt or 0.0))
        #: idle seconds since the last decode step (the decode loop
        #: parked waiting for admissions) — the serve plane's data_wait
        self._idle_wait_s = 0.0
        self._thread = threading.Thread(
            target=self._run, name="rtpu-serve-batcher", daemon=True)
        self._thread.start()

    # -- submit side -------------------------------------------------------
    def submit(self, payload: Any, *, deadline_s: Optional[float] = None,
               request_id: Optional[str] = None,
               stream: bool = False,
               prefilled: Optional[Dict[str, Any]] = None) -> Future:
        """Enqueue one request; returns a Future resolving to the
        engine's ``finish_request`` value.  Sheds when the queue is
        full.  The request joins the in-flight batch at the next step
        boundary with a free slot.  A request submitted under an active
        trace context gets queue-wait / decode / per-step spans.
        ``prefilled`` carries an adopted paged state (tokens already
        materialized by the handler thread) — admission then skips
        ``begin_request``/``prefill``."""
        now = time.monotonic()
        budget = self._cfg.default_deadline_s if deadline_s is None \
            else deadline_s
        fut: Future = Future()
        trace = _trace.current()
        with self._lock:
            if self._stop:
                raise RuntimeError("batcher stopped")
            backlog = len(self._queue)
            if backlog >= self._cfg.max_queue_len:
                self._shed_total += 1
                raise ReplicaOverloaded(
                    self._deployment, backlog, self._cfg.shed_retry_after_s)
            if request_id is None:
                request_id = f"r{self._next_id}"
                self._next_id += 1
            req = _Request(payload=payload, future=fut,
                           deadline=now + budget, request_id=request_id,
                           enqueued_at=now, stream=stream, trace=trace,
                           t0_wall=time.time() if trace or stream else 0.0,
                           prefilled=prefilled)
            self._queue.append(req)
            self._by_id[request_id] = req
            self._wake.notify()
        return fut

    def __call__(self, payload: Any, *, deadline_s: Optional[float] = None,
                 request_id: Optional[str] = None,
                 stream: bool = False,
                 prefilled: Optional[Dict[str, Any]] = None) -> Any:
        """Blocking submit — what the replica's request handler calls."""
        fut = self.submit(payload, deadline_s=deadline_s,
                          request_id=request_id, stream=stream,
                          prefilled=prefilled)
        return fut.result()

    def cancel(self, request_id: str) -> bool:
        """Release the request's slot at the next step boundary (or
        immediately when still queued).  True if the request was known
        and not yet finished."""
        with self._lock:
            req = self._by_id.get(request_id)
            if req is None or req.future.done():
                return False
            req.cancelled = True
            if req.slot < 0 and req in self._queue:
                self._queue.remove(req)
                self._finish_locked(req, error=RequestCancelled(request_id))
            self._wake.notify()
        self._drain_kv_releases()
        return True

    def stop(self) -> None:
        with self._lock:
            self._stop = True
            self._wake.notify()
        self._thread.join(timeout=5.0)
        # fail whatever never ran (slots drain in the loop's last pass)
        with self._lock:
            for req in list(self._queue):
                self._finish_locked(
                    req, error=RuntimeError("replica shutting down"))
            self._queue.clear()
        self._drain_kv_releases()
        if self._kv is not None:
            self._kv.release_all()  # belt-and-braces: zero leaked pages

    # -- stats -------------------------------------------------------------
    def stats(self) -> Dict[str, Any]:
        kv = self._kv.stats() if self._kv is not None else {}
        # device-plane step attribution (outside self._lock: the
        # monitor owns its own lock); compile count is process-global —
        # steady-state steps must keep it flat (one per bucket, warmup)
        dev = self._monitor.stats()
        with self._lock:
            lat = sorted(self._latencies_ms)
            p99 = lat[min(len(lat) - 1, int(len(lat) * 0.99))] if lat \
                else 0.0
            p50 = lat[len(lat) // 2] if lat else 0.0
            sms = sorted(self._step_ms)
            return {
                **kv,
                # step-boundary slot availability: what the router's
                # cross-gang steering keys on (queued requests will
                # take free slots first, so they count against it)
                "slots_free": max(
                    0, self._cfg.max_batch_size - self._active
                    - len(self._queue)),
                "max_batch_size": self._cfg.max_batch_size,
                "step_p50_ms": sms[len(sms) // 2] if sms else 0.0,
                "step_p99_ms":
                    sms[min(len(sms) - 1, int(len(sms) * 0.99))]
                    if sms else 0.0,
                "queue_depth": len(self._queue),
                "active": self._active,
                "steps": self._steps,
                "step_shapes": sorted(self._step_shapes),
                "shed_total": self._shed_total,
                "completed": self._completed,
                "mean_occupancy": (self._occupancy_sum / self._steps)
                if self._steps else 0.0,
                "p50_ms": p50,
                "p99_ms": p99,
                "mfu": dev["mfu"],
                "goodput_per_s": dev["goodput_per_s"],
                "device_frac": dev["device_frac"],
                "data_wait_frac": dev["data_wait_frac"],
                "phase_s": dev["phase_s"],
                "compiles": _dt.compile_count(),
            }

    # -- decode loop -------------------------------------------------------
    def _bucket_for(self, length: int) -> int:
        for b in self._buckets:
            if length <= b:
                return b
        return self._buckets[-1]

    def _finish_locked(self, req: _Request, *, value: Any = None,
                       error: Optional[BaseException] = None) -> None:
        self._by_id.pop(req.request_id, None)
        if self._kv is not None:
            # single funnel: every completed/evicted/cancelled request
            # frees its KV pages exactly once (the no-leak invariant).
            # The free itself is DEFERRED past the lock drop — it can
            # block on ray_tpu_torch.free — so every caller that exits
            # self._lock after finishing requests must drain
            self._kv_release_pending.append(req.request_id)
        if req.decode_span is not None:
            # trace-span append only — the metrics registry (its own
            # locks) is never touched under self._lock
            req.decode_span.end(
                status="ok" if error is None else type(error).__name__,
                steps=req.generated)
            req.decode_span = None
        if req.future.done():
            return
        if error is not None:
            req.future.set_exception(error)
            return
        self._latencies_ms.append(
            (time.monotonic() - req.enqueued_at) * 1e3)
        if len(self._latencies_ms) > 512:
            del self._latencies_ms[:-512]
        self._completed += 1
        req.future.set_result(value)

    def _drain_kv_releases(self) -> None:
        """Free KV pages recorded by ``_finish_locked`` — called with
        ``self._lock`` RELEASED (the free path can issue a blocking
        ``ray_tpu_torch.free``).  Draining promptly after the finishing lock
        section keeps the page budget honest for the next admission
        boundary."""
        if self._kv is None:
            return
        with self._lock:
            pending, self._kv_release_pending = \
                self._kv_release_pending, []
        for rid in pending:
            self._kv.release(rid)

    def _admit_locked(self, now: float) -> None:
        """Step boundary: free finished/cancelled/expired slots already
        handled; pull queued requests into free slots.  Paged-KV
        admission is budget-gated: a request whose worst-case page
        demand exceeds the free budget stays queued (FIFO — nothing
        behind it jumps ahead) until eviction frees pages.  Expensive
        per-request work (engine ``prefill``, page sealing) is deferred
        to the decode thread OUTSIDE the lock via ``_newly_admitted``
        so submitters never block behind it."""
        if not self._queue:
            return
        for i, slot in enumerate(self._slots):
            if slot is not None or not self._queue:
                continue
            req = self._queue[0]
            if req.cancelled:
                self._queue.pop(0)
                self._finish_locked(
                    req, error=RequestCancelled(req.request_id))
                continue
            if now > req.deadline:
                self._queue.pop(0)
                self._finish_locked(
                    req, error=RequestDeadlineExceeded(
                        f"request {req.request_id} expired in queue"))
                continue
            if req.state is None:
                try:
                    if req.prefilled is not None:
                        # pages sealed by a prefill replica; tokens were
                        # materialized on the handler thread
                        meta = dict(req.prefilled.get("meta") or {})
                        state = dict(meta)
                        state["tokens"] = list(req.prefilled["tokens"])
                        state.setdefault(
                            "prompt_len", len(state["tokens"]))
                    else:
                        state = self._engine.begin_request(req.payload)
                except Exception as e:  # noqa: BLE001 — bad payload:
                    self._queue.pop(0)  # that request only
                    self._finish_locked(req, error=e)
                    continue
                state.setdefault("max_new_tokens", 16)
                tokens = list(state.get("tokens") or [0])
                cap = self._cfg.max_seq_len
                if len(tokens) >= cap:
                    tokens = tokens[:cap - 1]
                state["tokens"] = tokens
                req.state = state  # parsed once; reused if re-gated
            if self._kv is not None:
                need = min(len(req.state["tokens"])
                           + int(req.state["max_new_tokens"]),
                           self._cfg.max_seq_len)
                # reservation is atomic at admission: two admissions in
                # one boundary can't both pass a stale budget check
                if not self._kv.reserve(req.request_id, need):
                    break  # budget-gated: wait for eviction to free pages
            self._queue.pop(0)
            if req.trace is not None:
                admit_wall = time.time()
                _trace.record("batch.queue", req.t0_wall, admit_wall,
                              parent=req.trace, slot=i)
                req.decode_span = _trace.start_span(
                    "batch.decode", parent=req.trace, slot=i)
            req.slot = i
            req.generated = 0
            self._slots[i] = req
            self._active += 1
            self._newly_admitted.append((i, req))

    def _evict_locked(self, now: float) -> None:
        for i, req in enumerate(self._slots):
            if req is None:
                continue
            if req.cancelled:
                self._release_slot_locked(
                    i, error=RequestCancelled(req.request_id))
            elif now > req.deadline:
                self._release_slot_locked(
                    i, error=RequestDeadlineExceeded(
                        f"request {req.request_id} expired after "
                        f"{req.generated} tokens"))
        # QUEUED requests expire on their deadline too — a full slot
        # pool must not hold an already-dead request (and its blocked
        # submitter) hostage until a slot happens to free
        expired = [r for r in self._queue
                   if r.cancelled or now > r.deadline]
        for req in expired:
            self._queue.remove(req)
            if req.cancelled:
                self._finish_locked(
                    req, error=RequestCancelled(req.request_id))
            else:
                self._finish_locked(
                    req, error=RequestDeadlineExceeded(
                        f"request {req.request_id} expired in queue"))

    def _release_slot_locked(self, i: int, *, value: Any = None,
                             error: Optional[BaseException] = None) -> None:
        req = self._slots[i]
        self._slots[i] = None
        self._active -= 1
        if req is not None:
            self._finish_locked(req, value=value, error=error)

    def _prepare_admitted(self, i: int, req: _Request) -> None:
        """Post-admission work on the decode thread, OUTSIDE the lock:
        engine ``prefill`` (the expensive prompt pass — in a unified
        deployment this is exactly what stalls the step loop behind a
        long prompt; disaggregation moves it to a prefill replica) and
        KV page registration/sealing."""
        try:
            need = min(len(req.state["tokens"])
                       + int(req.state["max_new_tokens"]),
                       self._cfg.max_seq_len)
            if req.prefilled is not None:
                if self._kv is not None:
                    self._kv.adopt(req.request_id,
                                   req.prefilled.get("export") or {},
                                   req.state["tokens"],
                                   reserve_tokens=need)
            else:
                prefill = getattr(self._engine, "prefill", None)
                if self._kv is not None and self._kv.prefix_enabled:
                    # prefix path: page FIRST so the chain match tells
                    # the engine how many prompt tokens it can skip
                    # (adopted pages already hold their KV)
                    matched = self._kv.begin(
                        req.request_id, req.state["tokens"],
                        reserve_tokens=need,
                        model=str(req.state.get("model") or ""))
                    req.state["prefix_len"] = int(matched)
                    if prefill is not None:
                        req.state = prefill(req.state) or req.state
                else:
                    if prefill is not None:
                        req.state = prefill(req.state) or req.state
                    if self._kv is not None:
                        self._kv.begin(req.request_id,
                                       req.state["tokens"],
                                       reserve_tokens=need)
        except Exception as e:  # noqa: BLE001 — that request only
            with self._lock:
                if self._slots[req.slot] is req:
                    self._release_slot_locked(req.slot, error=e)
            self._drain_kv_releases()

    def _run(self) -> None:
        import numpy as np

        B = self._cfg.max_batch_size
        pad = int(getattr(self._engine, "pad_token", 0) or 0)
        eos = getattr(self._engine, "eos_token", None)
        while True:
            with self._lock:
                stopping = self._stop
                if stopping:
                    for i in range(B):
                        if self._slots[i] is not None:
                            self._release_slot_locked(
                                i, error=RuntimeError(
                                    "replica shutting down"))
                else:
                    self._evict_locked(time.monotonic())
            # page frees from evictions run with the lock RELEASED
            # (they can reach a blocking ray_tpu_torch.free); draining
            # between evict and admit keeps the freed budget visible
            # to THIS boundary's admissions
            self._drain_kv_releases()
            if stopping:
                return
            with self._lock:
                self._admit_locked(time.monotonic())
                admitted = self._newly_admitted
                self._newly_admitted = []
                if self._active == 0:
                    # idle: park until a submit/cancel/stop wakes us;
                    # the parked time is the next step's data_wait
                    t_park = time.time()
                    self._wake.wait(timeout=0.1)
                    self._idle_wait_s += time.time() - t_park
                    continue
            # prefill + page sealing for fresh admissions runs with the
            # lock RELEASED: submitters/cancels never queue behind a
            # long prompt's prefill (the decode loop itself does stall
            # — the unified-mode cost disaggregation removes)
            for i, req in admitted:
                self._prepare_admitted(i, req)
            with self._lock:
                if self._active == 0:
                    continue  # every admission failed in prepare
                # snapshot the batch under the lock; run the step outside
                batch: List[Tuple[int, _Request]] = [
                    (i, r) for i, r in enumerate(self._slots)
                    if r is not None]
                longest = max(len(r.state["tokens"]) + 1
                              for _, r in batch)
                bucket = self._bucket_for(longest)
                tokens = np.full((B, bucket), pad, dtype=np.int32)
                lengths = np.zeros((B,), dtype=np.int32)
                active = np.zeros((B,), dtype=bool)
                models: Optional[List[Any]] = [None] * B \
                    if self._mux else None
                for i, r in batch:
                    seq = r.state["tokens"]
                    tokens[i, :len(seq)] = seq
                    lengths[i] = len(seq)
                    active[i] = True
                    if models is not None:
                        models[i] = r.state.get("model")
                occupancy = len(batch) / B
                self._occupancy_sum += occupancy
            # metric export stays OUTSIDE the lock: the registry takes
            # its own locks and must not serialize submit()/cancel()
            _tm.serve_batch_occupancy(self._deployment, occupancy)
            span = self._monitor.step(data_wait_s=self._idle_wait_s)
            self._idle_wait_s = 0.0
            step_t0 = time.time()
            try:
                if models is not None:
                    next_tokens = self._engine.step(
                        tokens, lengths, active, models)
                else:
                    next_tokens = self._engine.step(
                        tokens, lengths, active)
            except Exception as e:  # noqa: BLE001 — a broken step fails
                # the whole in-flight batch (callers see the error);
                # queued requests stay queued for the next pass
                with self._lock:
                    for i, _ in batch:
                        if self._slots[i] is not None:
                            self._release_slot_locked(i, error=e)
                self._drain_kv_releases()
                continue
            # host dispatch ended when step() returned; device compute
            # ends when the result is ready (a CUDA synchronise)
            span.dispatched()
            span.device_done(next_tokens)
            step_t1 = time.time()
            _tm.serve_decode_step(self._deployment, step_t1 - step_t0)
            if _flight.enabled():
                # a replica SIGKILLed mid-decode leaves its last steps
                # in the crash-surviving ring (incident forensics)
                _flight.record(
                    "batch_step",
                    f"{self._deployment} n={len(batch)} "
                    f"{(step_t1 - step_t0) * 1e3:.1f}ms")
            # local ring too: replica metrics expose step p50/p99 so a
            # bench/operator can see decode-step latency directly (the
            # gang fan-out's whole cost lives here)
            self._step_ms.append((step_t1 - step_t0) * 1e3)
            if len(self._step_ms) > 512:
                del self._step_ms[:-512]
            next_tokens = host_array(next_tokens).reshape(-1)
            ttfts: List[float] = []  # emitted outside the lock
            kv_appends: List[Tuple[str, int]] = []  # paged outside too
            with self._lock:
                self._steps += 1
                self._step_shapes.add((B, bucket))
                for i, req in batch:
                    if self._slots[i] is not req:
                        continue  # cancelled during the step
                    tok = int(next_tokens[i])
                    req.state["tokens"].append(tok)
                    if self._kv is not None:
                        kv_appends.append((req.request_id, tok))
                    req.generated += 1
                    if req.generated == 1 and req.stream:
                        # time-to-first-token: what a streaming client
                        # perceives as responsiveness
                        ttfts.append(time.monotonic() - req.enqueued_at)
                    if req.decode_span is not None \
                            and req.step_spans < self._STEP_SPAN_CAP:
                        req.step_spans += 1
                        _trace.record("decode.step", step_t0, step_t1,
                                      parent=req.decode_span.ctx(),
                                      step=req.generated, bucket=bucket)
                    done = (eos is not None and tok == eos) \
                        or req.generated >= int(req.state["max_new_tokens"]) \
                        or len(req.state["tokens"]) >= self._cfg.max_seq_len
                    if done:
                        try:
                            value = self._engine.finish_request(req.state)
                        except Exception as e:  # noqa: BLE001
                            self._release_slot_locked(i, error=e)
                            continue
                        self._release_slot_locked(i, value=value)
            self._drain_kv_releases()
            for ttft in ttfts:
                _tm.serve_ttft_observed(self._deployment, ttft)
            if kv_appends:
                # page sealing (an arena put per page_tokens tokens)
                # happens off the lock; a request released during the
                # step is a no-op append
                for rid, tok in kv_appends:
                    self._kv.append(rid, tok)
            # sync phase: result scatter + ttft export + page sealing
            # (one generated token per active slot this step)
            span.done(tokens=float(len(batch)), requests=float(len(batch)))


def bucketize(lengths: Sequence[int], buckets: Sequence[int]) -> List[int]:
    """Map each length onto its padding bucket (helper for tests and
    offline capacity planning)."""
    out = []
    for n in lengths:
        for b in buckets:
            if n <= b:
                out.append(b)
                break
        else:
            out.append(buckets[-1])
    return out
