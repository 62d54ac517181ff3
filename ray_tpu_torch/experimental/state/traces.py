"""Trace assembly, tree rendering, and Perfetto export.

Consumer half of the distributed tracing plane (``core/tracing.py``
producers -> GCS trace ring -> here).  Three outputs from the same
assembled span set:

- :func:`format_trace` — the CLI's ``trace <id>`` tree: per-hop
  durations indented under their parents, uncovered parent time called
  out as gaps, and a telescoping check at the bottom proving the spans
  account for the client-observed latency (the same trust property the
  critical-path analyzer (``analyze``) enforces: if the numbers don't add up,
  the clocks are lying, and the residual is printed as skew).
- :func:`format_trace_list` — the CLI's ``trace --slo-misses <dep>``.
- :func:`perfetto_events` — chrome-trace JSON for ``/api/traces``
  (loads directly in Perfetto / chrome://tracing).

Phase attribution reuses ``analyze``'s vocabulary: every span name maps to
one of ``sched`` (router.assign / batch.queue / raylet.lease), ``exec``
(exec:* / batch.decode / decode.step), ``fetch``, or ``reply``; root
time not covered by any child is ``gap``.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import worker as worker_mod

#: span-name prefix -> ``analyze`` phase bucket
_PHASE_OF = (
    ("router.assign", "sched"),
    ("batch.queue", "sched"),
    ("raylet.lease", "sched"),
    ("gcs.register", "sched"),
    ("exec:", "exec"),
    ("batch.decode", "exec"),
    ("decode.step", "exec"),
    ("fetch", "fetch"),
)

PHASES = ("gap", "sched", "fetch", "exec", "reply")


def _core():
    return worker_mod.global_worker()


def get_trace(trace_id: str) -> Optional[Dict[str, Any]]:
    """Assembled trace (summary + spans) from the GCS ring; prefix ids
    accepted.  None when unknown."""
    return _core().gcs_call("get_trace", {"trace_id": trace_id})


def list_traces(deployment: Optional[str] = None,
                slo_misses: bool = False,
                since: Optional[float] = None,
                until: Optional[float] = None,
                limit: int = 100) -> List[Dict[str, Any]]:
    return _core().gcs_call("list_traces", {
        "deployment": deployment, "slo_misses": slo_misses,
        "since": since, "until": until, "limit": limit})


# ---------------------------------------------------------------------------
# tree assembly
# ---------------------------------------------------------------------------

def build_tree(spans: List[Dict[str, Any]]
               ) -> List[Dict[str, Any]]:
    """Parent-link the spans; returns root spans (parentless or orphan
    — a dropped producer batch must not hide the rest of the tree),
    each with a ``children`` list sorted by start."""
    by_id = {s["span_id"]: dict(s, children=[]) for s in spans}
    roots: List[Dict[str, Any]] = []
    for s in by_id.values():
        parent = by_id.get(s.get("parent_id"))
        if parent is not None and parent is not s:
            parent["children"].append(s)
        else:
            roots.append(s)
    for s in by_id.values():
        s["children"].sort(key=lambda c: c.get("start", 0.0))
    roots.sort(key=lambda s: (not s.get("root", False),
                              s.get("start", 0.0)))
    return roots


def _phase_of(name: str) -> Optional[str]:
    for prefix, phase in _PHASE_OF:
        if name.startswith(prefix):
            return phase
    return None


def _union_len(intervals: List[Tuple[float, float]]) -> float:
    """Total covered length of possibly-overlapping intervals."""
    total = 0.0
    end = float("-inf")
    for a, b in sorted(intervals):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def phase_rollup(root: Dict[str, Any]) -> Dict[str, float]:
    """Telescoping phase attribution of one trace: each span's
    SELF time (duration minus children coverage) lands in its phase
    bucket; root self time splits into ``reply`` (after the last child
    ends — response serialization/write) and ``gap`` (uncovered time
    between hops: scheduling seams, network, untraced work)."""
    totals = dict.fromkeys(PHASES, 0.0)

    def visit(span: Dict[str, Any]) -> None:
        dur = max(0.0, span["end"] - span["start"])
        kids = span.get("children") or []
        covered = _union_len([
            (max(c["start"], span["start"]), min(c["end"], span["end"]))
            for c in kids if c["end"] > span["start"]
            and c["start"] < span["end"]])
        self_time = max(0.0, dur - covered)
        phase = _phase_of(span.get("name", ""))
        if phase is not None:
            totals[phase] += self_time
        elif span is root:
            last_child_end = max((c["end"] for c in kids),
                                 default=span["start"])
            tail = max(0.0, span["end"]
                       - max(last_child_end, span["start"]))
            tail = min(tail, self_time)
            totals["reply"] += tail
            totals["gap"] += self_time - tail
        else:
            totals["gap"] += self_time
        for c in kids:
            visit(c)

    visit(root)
    return totals


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _fmt_ms(seconds: float) -> str:
    ms = seconds * 1e3
    return f"{ms:8.1f}ms" if ms < 10000 else f"{seconds:7.2f}s "


def format_trace(trace: Dict[str, Any]) -> str:
    """Human tree for the CLI's ``trace <id>``."""
    if trace is None:
        return "trace not found (evicted, still assembling, or never "\
               "reported — traces land at the GCS on the ~2-5s flush "\
               "cadence)"
    if trace.get("sampled_out"):
        return (f"trace {trace['trace_id']}: sampled out by tail "
                f"sampling (fast success beyond "
                f"trace_sample_keep_fraction)")
    spans = trace.get("spans") or []
    lines: List[str] = []
    status = trace.get("status")
    dur = trace.get("duration_s")
    head = f"trace {trace['trace_id']}: {trace.get('name') or '?'}"
    head += f"  status={status}"
    if dur is not None:
        head += f"  e2e={dur * 1e3:.1f}ms"
    if trace.get("slo_miss"):
        head += "  SLO-MISS"
    if trace.get("retried"):
        head += "  retried"
    if not trace.get("complete"):
        head += "  (incomplete: root span not yet reported)"
    lines.append(head)
    if not spans:
        lines.append("  (no spans)")
        return "\n".join(lines)
    roots = build_tree(spans)
    t0 = min(s["start"] for s in spans)

    def emit(span: Dict[str, Any], depth: int) -> None:
        dur_s = max(0.0, span["end"] - span["start"])
        pad = "  " * depth
        tags = span.get("tags") or {}
        extra = " ".join(f"{k}={v}" for k, v in sorted(tags.items()))
        st = span.get("status", "ok")
        st_txt = "" if st == "ok" else f"  [{st}]"
        src = span.get("source", "?")
        lines.append(
            f"  {_fmt_ms(dur_s)}  +{(span['start'] - t0) * 1e3:7.1f}ms"
            f"  {pad}{span['name']}  ({src}){st_txt}"
            + (f"  {extra}" if extra else ""))
        prev_end = None
        for c in span["children"]:
            if prev_end is not None and c["start"] - prev_end > 0.0005:
                lines.append(
                    f"  {_fmt_ms(c['start'] - prev_end)}  "
                    f"+{(prev_end - t0) * 1e3:7.1f}ms"
                    f"  {'  ' * (depth + 1)}(gap)")
            emit(c, depth + 1)
            prev_end = max(prev_end or c["end"], c["end"])

    for root in roots:
        emit(root, 0)
    # telescoping check: per-hop spans must account for the root's
    # client-observed duration (residual = clock skew + untraced gaps)
    main = roots[0]
    if main.get("root"):
        rollup = phase_rollup(main)
        root_dur = max(0.0, main["end"] - main["start"])
        accounted = sum(rollup.values())
        lines.append(
            "phases: " + "  ".join(
                f"{p}={rollup[p] * 1e3:.1f}ms" for p in PHASES
                if rollup[p] > 0))
        lines.append(
            f"telescoping: e2e {root_dur * 1e3:.1f}ms = accounted "
            f"{accounted * 1e3:.1f}ms + skew "
            f"{(root_dur - accounted) * 1e3:+.1f}ms")
    if trace.get("truncated_spans"):
        lines.append(f"({trace['truncated_spans']} spans truncated by "
                     f"the per-trace cap)")
    return "\n".join(lines)


def format_trace_list(rows: List[Dict[str, Any]]) -> str:
    if not rows:
        return "no matching traces retained (tail sampling keeps " \
               "errors/sheds/SLO misses and a fraction of successes)"
    lines = [f"{'trace_id':<16} {'status':<12} {'e2e':>9} "
             f"{'deployment':<16} {'flags':<14} name"]
    for r in rows:
        dur = f"{r['duration_s'] * 1e3:.1f}ms" \
            if r.get("duration_s") is not None else "-"
        flags = ",".join(
            f for f, on in (("slo_miss", r.get("slo_miss")),
                            ("retried", r.get("retried")),
                            ("incomplete", not r.get("complete")))
            if on)
        lines.append(
            f"{r['trace_id'][:16]:<16} {str(r.get('status')):<12} "
            f"{dur:>9} {str(r.get('deployment') or '-'):<16} "
            f"{flags:<14} {r.get('name') or '?'}")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# Perfetto / chrome-trace export
# ---------------------------------------------------------------------------

def perfetto_events(spans: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Complete ("X") events, one track per source process — loads in
    Perfetto / chrome://tracing as-is."""
    out = []
    for s in spans:
        out.append({
            "name": s.get("name", "?"),
            "cat": "trace",
            "ph": "X",
            "ts": s["start"] * 1e6,
            "dur": max(0.0, s["end"] - s["start"]) * 1e6,
            "pid": s.get("source", "?"),
            "tid": s.get("source", "?"),
            "args": {
                "trace_id": s.get("trace_id"),
                "span_id": s.get("span_id"),
                "parent_id": s.get("parent_id"),
                "status": s.get("status", "ok"),
                **(s.get("tags") or {}),
            },
        })
    return out
