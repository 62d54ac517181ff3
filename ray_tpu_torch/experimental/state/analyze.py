"""Job time-attribution analyzer: task DAG + critical path + phases.

Parity motivation: Ray's task events power ``ray timeline``, but the
question that actually decides a scaling debug session — *which chain
of tasks set the job's wall clock, and was the time queueing, transfer,
or compute?* (the TPU-concurrency study's straggler-phase hunt) — is
left to a human squinting at Perfetto.  This module answers it from
data the GCS already holds:

- **task events** (owner-recorded PENDING/RUNNING/FINISHED rows, GCS
  clock-corrected; PENDING rows carry lineage: the submitting task and
  the producing tasks of every ObjectRef argument), and
- **``task_exec`` spans** (executor-recorded body start/end, same
  timebase), which split the owner's RUNNING->FINISHED interval into
  dispatch+arg-fetch / execute / result-post+reply.

Per (task, attempt) the analyzer derives the phase ladder::

    PENDING --sched--> RUNNING --fetch--> exec_start --exec-->
        exec_end --reply--> FINISHED

then walks the data DAG backwards from the last-finishing task, at each
step following the dependency that finished latest, yielding the job's
critical path.  Segment durations along the path telescope to the job
makespan by construction (clamped at clock-sync tolerance), which is
what makes the output trustworthy: if the phases don't add up, the
clocks are lying, and the residual is reported as ``skew``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import worker as worker_mod

#: terminal task-event states
_TERMINAL = ("FINISHED", "FAILED")

#: phase display order (critical path and totals tables).  ``gap`` is
#: path-only: time between the critical dependency finishing and this
#: task being submitted (driver think time / submit latency).  The
#: body interval splits into host vs device time when the executor's
#: ``task_exec`` span carries a ``device_s`` attribution (accumulated
#: by device-plane StepMonitors on the executing thread); without one,
#: the whole body reads as ``exec_host``.
PHASES = ("gap", "sched", "fetch", "exec_host", "exec_device", "reply")


def _core():
    return worker_mod.global_worker()


# ---------------------------------------------------------------------------
# task table reconstruction
# ---------------------------------------------------------------------------

def _fetch(job: Optional[str], limit: int) -> Tuple[list, list, list]:
    core = _core()
    events = core.gcs_call("get_task_events",
                           {"limit": limit, "job_id": job})
    try:
        spans = core.gcs_call("get_spans",
                              {"cat": "task_exec", "limit": limit})
    except Exception:  # noqa: BLE001 — pre-telemetry GCS: events only
        spans = []
    try:
        gang = core.gcs_call("get_spans", {"cat": "gang", "limit": 256})
    except Exception:  # noqa: BLE001 — pre-telemetry GCS
        gang = []
    return events, spans, gang


def _latest_job(events: List[Dict[str, Any]]) -> Optional[str]:
    last: Dict[str, float] = {}
    for ev in events:
        job = ev.get("job_id")
        if job:
            last[job] = max(last.get(job, 0.0), ev.get("time", 0.0))
    if not last:
        return None
    return max(last, key=lambda j: last[j])


def build_tasks(events: List[Dict[str, Any]],
                spans: List[Dict[str, Any]]
                ) -> Dict[Tuple[str, int], Dict[str, Any]]:
    """Fold event rows + exec spans into one record per (task, attempt)."""
    tasks: Dict[Tuple[str, int], Dict[str, Any]] = {}
    for ev in events:
        key = (ev["task_id"], ev.get("attempt", 0))
        t = tasks.get(key)
        if t is None:
            t = tasks[key] = {
                "task_id": ev["task_id"], "attempt": ev.get("attempt", 0),
                "name": ev.get("name"), "state": None,
                "pending": None, "running": None, "finished": None,
                "exec_start": None, "exec_end": None, "device_s": 0.0,
                "deps": [], "parent": None,
                "worker_id": ev.get("worker_id"),
            }
        state = ev.get("state")
        ts = ev.get("time", 0.0)
        if state == "PENDING":
            t["pending"] = ts if t["pending"] is None \
                else min(t["pending"], ts)
            if ev.get("deps"):
                t["deps"] = ev["deps"]
            if ev.get("parent_task_id"):
                t["parent"] = ev["parent_task_id"]
        elif state == "RUNNING":
            t["running"] = ts if t["running"] is None \
                else min(t["running"], ts)
        elif state in _TERMINAL:
            t["finished"] = ts if t["finished"] is None \
                else max(t["finished"], ts)
            t["state"] = state
        if t["state"] is None:
            t["state"] = state
    for span in spans:
        args = span.get("args") or {}
        tid = args.get("task_id")
        if tid is None:
            continue
        key = (tid, args.get("attempt", 0))
        t = tasks.get(key)
        if t is not None:
            t["exec_start"] = span.get("start")
            t["exec_end"] = span.get("end")
            try:
                t["device_s"] = max(0.0, float(args.get("device_s") or 0))
            except (TypeError, ValueError):
                t["device_s"] = 0.0
    return tasks


def _phases(t: Dict[str, Any], anchor: Optional[float]
            ) -> Dict[str, float]:
    """Phase durations of one task, telescoping from ``anchor`` (the
    latest-finishing dependency's end) to its FINISHED stamp.  The
    segment STARTS at the anchor — time before it belongs to the
    dependency's own segment, which is what makes critical-path
    segments sum to the job makespan instead of double counting
    pipelined submissions.  Missing intermediate stamps collapse their
    phase into the enclosing one instead of dropping time."""
    pending = t.get("pending")
    running = t.get("running")
    finished = t.get("finished")
    ex0, ex1 = t.get("exec_start"), t.get("exec_end")
    out = dict.fromkeys(PHASES, 0.0)
    if finished is None:
        return out
    start = pending if pending is not None else running
    if start is None:
        return out
    if anchor is not None:
        if start > anchor:
            # submitted AFTER the dep finished: the driver sat between
            # them, and on the critical path that gap is real time
            out["gap"] = start - anchor
            cursor = start
        else:
            # submitted early, parked on deps until the anchor
            cursor = anchor
    else:
        cursor = start
    if running is not None and running > cursor:
        out["sched"] = running - cursor
        cursor = running
    if ex0 is not None and ex1 is not None and ex1 >= ex0:
        if ex0 > cursor:
            out["fetch"] = ex0 - cursor
            cursor = ex0
        end_exec = min(max(ex1, cursor), finished)
        if end_exec > cursor:
            # body interval: the span's device_s attribution (clamped
            # to the interval — clock correction can shave the span)
            # is device time; the rest ran python
            body = end_exec - cursor
            device = min(max(0.0, t.get("device_s", 0.0)), body)
            out["exec_device"] = device
            out["exec_host"] = body - device
            cursor = end_exec
        if finished > cursor:
            out["reply"] = finished - cursor
    elif finished > cursor:
        # no executor span (telemetry off / span ring rotated): the
        # whole RUNNING->FINISHED interval counts as host exec
        out["exec_host"] = finished - cursor
    return out


# ---------------------------------------------------------------------------
# critical path
# ---------------------------------------------------------------------------

def critical_path(tasks: Dict[Tuple[str, int], Dict[str, Any]]
                  ) -> List[Dict[str, Any]]:
    """Walk the data DAG backwards from the last-finishing task,
    following the latest-finishing dependency at each step.  Returns
    root-first segments with per-phase durations."""
    finished = [t for t in tasks.values() if t.get("finished") is not None]
    if not finished:
        return []
    # newest attempt wins per task_id (retries supersede)
    by_id: Dict[str, Dict[str, Any]] = {}
    for t in finished:
        cur = by_id.get(t["task_id"])
        if cur is None or t["attempt"] >= cur["attempt"]:
            by_id[t["task_id"]] = t
    cur = max(by_id.values(), key=lambda t: t["finished"])
    path: List[Dict[str, Any]] = []
    seen = set()
    while cur is not None and cur["task_id"] not in seen:
        seen.add(cur["task_id"])
        dep_tasks = [by_id[d] for d in cur.get("deps", []) if d in by_id]
        anchor_task = max(dep_tasks, key=lambda t: t["finished"]) \
            if dep_tasks else None
        anchor = anchor_task["finished"] if anchor_task else None
        phases = _phases(cur, anchor)
        path.append({
            "task_id": cur["task_id"], "name": cur["name"],
            "attempt": cur["attempt"], "state": cur["state"],
            "finished": cur["finished"],
            "start": cur.get("pending") or cur.get("running"),
            "phases": phases,
            "total": sum(phases.values()),
        })
        cur = anchor_task
    path.reverse()
    return path


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def analyze_job(job: Optional[str] = None,
                limit: int = 100_000) -> Dict[str, Any]:
    """Full analysis dict for one job (None = the job with the most
    recent task event)."""
    if job is None:
        # newest-job discovery only needs the tail of the ring (rows
        # come back newest-last); the filtered fetch below then rides
        # the GCS-side job_id pushdown.  The CLI's `status` runs this on
        # every invocation — keep it O(tail), not O(ring)
        job = _latest_job(_core().gcs_call(
            "get_task_events", {"limit": 1000}))
        if job is None:
            return {"job": None, "n_tasks": 0, "error": "no task events"}
    events, spans, gang_spans = _fetch(job, limit)
    tasks = build_tasks(events, spans)
    done = [t for t in tasks.values() if t.get("finished") is not None]
    if not done:
        return {"job": job, "n_tasks": len(tasks),
                "error": "no finished tasks"}
    # a long job can overflow the GCS event ring: a task's FINISHED row
    # may survive eviction of its PENDING/RUNNING rows, leaving no
    # start stamp — fall back to finished stamps rather than crash
    starts = [s for s in (t.get("pending") or t.get("running")
                          for t in done) if s is not None]
    job_start = min(starts) if starts \
        else min(t["finished"] for t in done)
    job_end = max(t["finished"] for t in done)
    makespan = job_end - job_start
    path = critical_path(tasks)
    # telescoped path duration: segments cover [path_start, job_end];
    # time before the first path task's submit is driver think time
    path_total = sum(seg["total"] for seg in path)
    lead_in = (path[0]["start"] - job_start) \
        if path and path[0]["start"] is not None else 0.0
    skew = makespan - (path_total + max(0.0, lead_in))
    # per-phase totals across EVERY task (not just the path)
    totals: Dict[str, float] = dict.fromkeys(PHASES, 0.0)
    per_task: List[Dict[str, Any]] = []
    for t in done:
        ph = _phases(t, None)
        for k, v in ph.items():
            totals[k] += v
        per_task.append({"task_id": t["task_id"], "name": t["name"],
                         "phases": ph})
    top: Dict[str, List[Tuple[str, float]]] = {}
    for phase in ("exec_host", "exec_device", "sched", "fetch"):
        agg: Dict[str, float] = defaultdict(float)
        for row in per_task:
            agg[row["name"] or "?"] += row["phases"][phase]
        top[phase] = sorted(agg.items(), key=lambda kv: -kv[1])[:5]
    # gang straggler annotations (sharded.py records one span per
    # straggler change): newest span per deployment
    stragglers: Dict[str, Dict[str, Any]] = {}
    for span in gang_spans:
        args = span.get("args") or {}
        dep = args.get("deployment") or "?"
        cur = stragglers.get(dep)
        if cur is None or span.get("end", 0.0) > cur["at"]:
            stragglers[dep] = {"deployment": dep,
                               "rank": args.get("rank"),
                               "skew_s": args.get("skew_s", 0.0),
                               "at": span.get("end", 0.0)}
    return {
        "job": job,
        "n_tasks": len({t["task_id"] for t in done}),
        "n_attempts": len(done),
        "start": job_start, "end": job_end,
        "makespan_s": makespan,
        "critical_path": path,
        "critical_path_s": path_total,
        "lead_in_s": max(0.0, lead_in),
        "skew_s": skew,
        "phase_totals": totals,
        "top": top,
        "stragglers": sorted(stragglers.values(),
                             key=lambda s: -float(s["skew_s"] or 0)),
    }


def _pct(part: float, whole: float) -> str:
    return f"{100.0 * part / whole:.0f}%" if whole > 0 else "0%"


def format_report(result: Dict[str, Any]) -> str:
    """Human-readable report for the CLI's ``analyze``."""
    if result.get("error"):
        return (f"job {result.get('job') or '?'}: {result['error']}")
    lines = []
    mk = result["makespan_s"]
    lines.append(
        f"job {result['job']}: {result['n_tasks']} tasks "
        f"({result['n_attempts']} attempts), makespan {mk:.3f}s")
    path = result["critical_path"]
    lines.append(
        f"critical path: {len(path)} tasks, {result['critical_path_s']:.3f}s"
        f" ({_pct(result['critical_path_s'], mk)} of makespan; "
        f"driver lead-in {result['lead_in_s']:.3f}s, "
        f"clock skew residual {result['skew_s']:+.3f}s)")
    hdr = (f"  {'task':<28} {'total':>8}  "
           + "  ".join(f"{p:>9}" for p in PHASES))
    lines.append(hdr)
    for seg in path:
        name = (seg["name"] or seg["task_id"][:12])[:28]
        lines.append(
            f"  {name:<28} {seg['total']:>7.3f}s  "
            + "  ".join(f"{seg['phases'][p]:>8.3f}s" for p in PHASES))
    totals = result["phase_totals"]
    busy = sum(totals.values())
    lines.append("per-phase totals over all tasks "
                 f"(task-seconds, {busy:.3f}s busy):")
    lines.append("  " + "  ".join(
        f"{p}={totals[p]:.3f}s ({_pct(totals[p], busy)})"
        for p in PHASES))
    for phase in ("exec_host", "exec_device", "sched", "fetch"):
        rows = [r for r in result["top"][phase] if r[1] > 0]
        if rows:
            lines.append(f"top {phase} offenders: " + ", ".join(
                f"{name} {secs:.3f}s" for name, secs in rows))
    for s in result.get("stragglers") or []:
        lines.append(
            f"gang straggler: {s['deployment']} rank {s['rank']} "
            f"(+{float(s['skew_s'] or 0) * 1e3:.1f}ms per step)")
    return "\n".join(lines)


def summary_line(result: Dict[str, Any]) -> str:
    """One-liner for the CLI's ``status``."""
    if result.get("error"):
        return f"analyze: job {result.get('job') or '?'} — " \
               f"{result['error']}"
    totals = result["phase_totals"]
    busy = sum(totals.values()) or 1.0
    mix = " ".join(f"{p} {_pct(totals[p], busy)}"
                   for p in PHASES if totals[p] > 0)
    return (f"job {result['job']}: makespan {result['makespan_s']:.2f}s, "
            f"critical path {len(result['critical_path'])} tasks "
            f"{result['critical_path_s']:.2f}s — {mix}")
