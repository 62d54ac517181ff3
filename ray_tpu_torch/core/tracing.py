"""Native request-scoped distributed tracing: context, spans, buffer.

Parity motivation: the reference runtime's OpenTelemetry integration
(``util/tracing/tracing_helper.py`` here) is opt-in, needs an external
exporter, and covers none of the serve hops — when a p99 SLO burns, the
``ray_tpu_serve_*`` histograms say *that* it burned, not *where*.  This
module is the always-available half: a trace context (trace_id +
parent span_id) is born at the serve HTTP ingress and at driver-side
``remote()`` submission, rides existing RPC payloads / task specs
through every hop, and each process buffers completed spans here until
its telemetry flush loop ships them to the GCS trace ring
(``report_trace_spans``, drop-don't-block) where **tail-based
sampling** decides retention at trace completion (``core/gcs.py``).

Cost discipline:

- ``tracing_enabled`` off: ingress/submit sites never create a context,
  every hop sees ``ctx is None`` and skips — nothing rides the wire,
  nothing is buffered.  The tag happens ONCE at the trace's birth; no
  per-hop sampling branch exists.
- enabled: a span is one small dict append into a bounded deque (oldest
  drop when the buffer outpaces the flush loop).  Producers never do
  I/O; the flush loops that do live with their owners.

Span timestamps are wall-clock (``time.time()``), corrected onto the
GCS timebase at drain with the same clock offset the telemetry spans
use (``telemetry.measure_clock_offset``), so a cross-host trace tree
lines up without per-consumer correction.

Context propagation conventions:

- RPC payload dicts carry the carrier under the ``"trace"`` key;
  ``rpc.Connection._dispatch`` re-activates it for the handler (the
  ``trace-propagation`` rtpu-check rule keeps serve / submit-path call
  sites honest).
- Task specs carry it inside ``TaskSpec.trace_context`` (the native
  ``trace_id``/``span_id`` keys coexist with the optional W3C
  ``traceparent`` of the OTel helper).
- In-process, the ambient context is a :data:`contextvars.ContextVar`
  (works across threads and asyncio tasks).
"""

from __future__ import annotations

import itertools
import os
import time
from collections import deque
from contextvars import ContextVar
from typing import Any, Dict, List, Optional

__all__ = [
    "enabled", "current", "use_ctx", "Span", "start_trace", "start_span",
    "record", "drain", "ctx_of", "new_trace_id",
]

# ---------------------------------------------------------------------------
# enable gate (mirrors telemetry.enabled(): one cached bool per process)
# ---------------------------------------------------------------------------

_enabled: Optional[bool] = None


def enabled() -> bool:
    global _enabled
    if _enabled is None:
        env = os.environ.get("RAY_TPU_TORCH_TRACING_ENABLED")
        if env is not None:
            _enabled = env.lower() in ("1", "true", "yes")
        else:
            try:
                from ray_tpu_torch.core.config import get_config
                _enabled = bool(getattr(get_config(), "tracing_enabled",
                                        True))
            except Exception:  # noqa: BLE001 — config unavailable: stay on
                _enabled = True
    return _enabled


def _reset_for_tests(force: Optional[bool] = None) -> None:
    global _enabled
    _enabled = force
    _buf.clear()


# ---------------------------------------------------------------------------
# ids + ambient context
# ---------------------------------------------------------------------------

#: id generation: a process-local PRNG seeded ONCE from os.urandom.
#: urandom/getpid are multi-microsecond syscalls on hardened kernels —
#: paying one per span put tracing at 14% of the sync-task microbench;
#: getrandbits is ~0.3us.  Fork safety comes from os.register_at_fork
#: (workers FORK from the zygote; an inherited RNG/prefix would collide
#: span ids across processes and mis-link assembled trees) plus a lazy
#: None check for spawn-fresh processes.
_rng: Optional[Any] = None  # random.Random, imported lazily
_id_prefix = ""
_span_counter = itertools.count(1)

_current: "ContextVar[Optional[Dict[str, str]]]" = ContextVar(
    "rtpu_trace_ctx", default=None)


def _reseed() -> None:
    global _rng, _id_prefix, _span_counter
    import random
    _rng = random.Random(int.from_bytes(os.urandom(16), "little"))
    _id_prefix = f"{_rng.getrandbits(32):08x}"
    _span_counter = itertools.count(1)


if hasattr(os, "register_at_fork"):  # CPython >= 3.7, POSIX
    os.register_at_fork(after_in_child=_reseed)


def new_trace_id() -> str:
    """Fully random 64-bit hex id — it feeds the deterministic
    tail-sampling hash, so it must be uniform."""
    if _rng is None:
        _reseed()
    return f"{_rng.getrandbits(64):016x}"


def _new_span_id() -> str:
    if _rng is None:
        _reseed()
    return f"{_id_prefix}{next(_span_counter):08x}"


def current() -> Optional[Dict[str, str]]:
    """The ambient trace carrier (``{"trace_id", "span_id"}``) or None."""
    return _current.get()


def set_current(ctx: Optional[Dict[str, str]]):
    """Low-level: activate ``ctx``; returns the reset token."""
    return _current.set(ctx)


def reset_current(token) -> None:
    _current.reset(token)


class use_ctx:
    """``with use_ctx(ctx): ...`` — activate a carrier for a block.
    ``ctx=None`` deactivates (children see no trace)."""

    __slots__ = ("_ctx", "_token")

    def __init__(self, ctx: Optional[Dict[str, str]]):
        self._ctx = ctx
        self._token = None

    def __enter__(self):
        self._token = _current.set(self._ctx)
        return self._ctx

    def __exit__(self, *exc):
        _current.reset(self._token)
        return False


def ctx_of(carrier: Optional[Dict[str, str]]
           ) -> Optional[Dict[str, str]]:
    """Extract the native context from a mixed carrier (a TaskSpec
    ``trace_context`` may also hold the OTel ``traceparent``)."""
    if not carrier:
        return None
    tid = carrier.get("trace_id")
    sid = carrier.get("span_id")
    if tid is None or sid is None:
        return None
    return {"trace_id": tid, "span_id": sid}


# ---------------------------------------------------------------------------
# span buffer
# ---------------------------------------------------------------------------

#: bounded pending-span buffer (oldest drop; the flush loop drains it
#: every metrics_report_period_s).  Appends/popleft are GIL-atomic, so
#: batcher threads and the io loop share it without a lock.
_buf: "deque[Dict[str, Any]]" = deque(maxlen=8192)
#: spans displaced by the bound before any flush (diagnostic; GIL int
#: increment — a lock would cost more than the count is worth)
_dropped = 0

#: optional span-completion sink (the flight recorder registers one so
#: span completions land in the crash-surviving ring as well as the
#: flush buffer).  One global load + None test when nothing registered.
_span_sink = None


def dropped() -> int:
    """Spans this process dropped to the buffer bound (never flushed)."""
    return _dropped


def set_span_sink(fn) -> None:
    """Install (or clear, with None) the per-process span-completion
    sink.  The sink must be cheap and must never raise."""
    global _span_sink
    _span_sink = fn


def _append(rec: Dict[str, Any]) -> None:
    global _dropped
    if len(_buf) == _buf.maxlen:
        _dropped += 1
    _buf.append(rec)
    sink = _span_sink
    if sink is not None:
        try:
            sink(rec)
        except Exception:  # noqa: BLE001 — forensics never breaks tracing
            pass


class Span:
    """One in-flight span.  Create via :func:`start_trace` /
    :func:`start_span`; finish with :meth:`end` (idempotent)."""

    __slots__ = ("trace_id", "span_id", "parent_id", "name", "start",
                 "tags", "root", "_done")

    def __init__(self, trace_id: str, span_id: str,
                 parent_id: Optional[str], name: str, root: bool,
                 tags: Optional[Dict[str, Any]]):
        self.trace_id = trace_id
        self.span_id = span_id
        self.parent_id = parent_id
        self.name = name
        self.start = time.time()
        self.tags = tags
        self.root = root
        self._done = False

    def ctx(self) -> Dict[str, str]:
        """Carrier for children of this span."""
        return {"trace_id": self.trace_id, "span_id": self.span_id}

    def set_tag(self, key: str, value: Any) -> None:
        if self.tags is None:
            self.tags = {}
        self.tags[key] = value

    def end(self, status: str = "ok", **tags: Any) -> None:
        if self._done:
            return
        self._done = True
        if tags:
            if self.tags is None:
                self.tags = {}
            self.tags.update(tags)
        rec: Dict[str, Any] = {
            "trace_id": self.trace_id, "span_id": self.span_id,
            "parent_id": self.parent_id, "name": self.name,
            "start": self.start, "end": time.time(), "status": status,
        }
        if self.root:
            rec["root"] = True
        if self.tags:
            rec["tags"] = self.tags
        _append(rec)


def start_trace(name: str, **tags: Any) -> Optional[Span]:
    """Born at an ingress: a fresh trace whose root span decides tail
    retention when it ends.  None when tracing is disabled — every
    downstream hop then short-circuits on the absent context."""
    if not enabled():
        return None
    return Span(new_trace_id(), _new_span_id(), None, name, True,
                tags or None)


def start_span(name: str, parent: Optional[Dict[str, str]] = None,
               **tags: Any) -> Optional[Span]:
    """Child span under ``parent`` (default: the ambient context).
    None when there is no trace to join — untraced requests pay one
    ContextVar read per hop, nothing more."""
    if parent is None:
        parent = _current.get()
        if parent is None:
            return None
    tid = parent.get("trace_id")
    if tid is None:
        return None
    return Span(tid, _new_span_id(), parent.get("span_id"), name, False,
                tags or None)


def record(name: str, start: float, end: float,
           parent: Optional[Dict[str, str]] = None, status: str = "ok",
           **tags: Any) -> None:
    """One-shot child span from precomputed wall stamps (hot paths that
    already hold their own timestamps)."""
    if parent is None:
        parent = _current.get()
        if parent is None:
            return
    tid = parent.get("trace_id")
    if tid is None:
        return
    rec: Dict[str, Any] = {
        "trace_id": tid, "span_id": _new_span_id(),
        "parent_id": parent.get("span_id"), "name": name,
        "start": start, "end": end, "status": status,
    }
    if tags:
        rec["tags"] = tags
    _append(rec)


def pending() -> int:
    return len(_buf)


def drain(source: str) -> List[Dict[str, Any]]:
    """Pop buffered spans, clock-corrected onto the GCS timebase and
    stamped with their source process (same contract as
    ``telemetry.drain_spans``)."""
    if not _buf:
        return []
    from ray_tpu_torch.core import telemetry as _tm
    off = _tm.clock_offset()
    out: List[Dict[str, Any]] = []
    while _buf:
        try:
            rec = _buf.popleft()
        except IndexError:  # racing drains (tests)
            break
        rec["start"] += off
        rec["end"] += off
        rec["source"] = source
        out.append(rec)
    return out
