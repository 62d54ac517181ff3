"""Cluster state API.

Parity: reference ``python/ray/experimental/state/api.py``
(``list_tasks/actors/objects/nodes/placement_groups/jobs/workers``,
``summarize_tasks``) backed by ``StateAPIManager``
(``dashboard/state_aggregator.py:132``) fanning out to GCS + per-node
raylet sources (``state_manager.py:130``).  Here the fan-out happens
client-side: GCS tables for cluster-scoped state, raylet RPCs for
per-node workers/objects.

Also home of the chrome-trace ``timeline`` export (reference
``ray timeline``, built from per-task profile events).
"""

from __future__ import annotations

import json
from collections import defaultdict
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import worker as worker_mod


def _core():
    return worker_mod.global_worker()


def _apply_filters(rows: List[Dict[str, Any]],
                   filters: Optional[List[tuple]]) -> List[Dict[str, Any]]:
    """filters: [(key, "=" | "!=", value)] (reference StateApiClient)."""
    for key, op, value in filters or []:
        if op == "=":
            rows = [r for r in rows if str(r.get(key)) == str(value)]
        elif op == "!=":
            rows = [r for r in rows if str(r.get(key)) != str(value)]
        else:
            raise ValueError(f"unsupported filter op {op!r}")
    return rows


def list_nodes(filters=None, limit: int = 1000) -> List[Dict[str, Any]]:
    rows = _core().gcs_call("get_nodes", {})
    for r in rows:
        r["node_id"] = r["node_id"].hex() \
            if isinstance(r["node_id"], bytes) else r["node_id"]
        r["state"] = "ALIVE" if r.pop("alive", False) else "DEAD"
    return _apply_filters(rows, filters)[:limit]


def list_actors(filters=None, limit: int = 1000) -> List[Dict[str, Any]]:
    rows = _core().gcs_call("list_actors", {})
    for r in rows:
        for k in ("actor_id", "node_id"):
            if isinstance(r.get(k), bytes):
                r[k] = r[k].hex()
    return _apply_filters(rows, filters)[:limit]


def list_placement_groups(filters=None, limit: int = 1000
                          ) -> List[Dict[str, Any]]:
    rows = _core().gcs_call("list_placement_groups", {})
    for r in rows:
        if isinstance(r.get("pg_id"), bytes):
            r["placement_group_id"] = r.pop("pg_id").hex()
        r["bundle_nodes"] = {i: (n.hex() if isinstance(n, bytes) else n)
                             for i, n in r.get("bundle_nodes", {}).items()}
    return _apply_filters(rows, filters)[:limit]


def list_jobs(filters=None, limit: int = 1000) -> List[Dict[str, Any]]:
    return _apply_filters(_core().gcs_call("list_jobs", {}),
                          filters)[:limit]


def list_tasks(filters=None, limit: int = 1000,
               latest_state_only: bool = True) -> List[Dict[str, Any]]:
    """Task rows from the GCS task-event buffer; by default one row per
    task attempt, carrying its latest state.

    ``job_id``/``state`` equality filters are pushed down into the GCS
    handler so a busy cluster ships matching rows, not the whole ring
    (state only in raw-event mode: filtering events by state BEFORE the
    latest-state fold would resurrect superseded states)."""
    query: Dict[str, Any] = {"limit": 100_000}
    remaining = []
    for key, op, value in filters or []:
        if op == "=" and key == "job_id" and "job_id" not in query:
            query["job_id"] = str(value)
        elif op == "=" and key == "state" and not latest_state_only \
                and "state" not in query:
            query["state"] = str(value)
        else:
            remaining.append((key, op, value))
    filters = remaining
    if not latest_state_only:
        # NOTE: the GCS applies `limit` to the TAIL (newest rows) while
        # this API has always truncated the HEAD of the filtered set —
        # so ship the filters down but keep the wide fetch limit and
        # truncate client-side to preserve oldest-first semantics
        events = _core().gcs_call("get_task_events", query)
        return _apply_filters(events, filters)[:limit]
    events = _core().gcs_call("get_task_events", query)
    latest: Dict[tuple, Dict[str, Any]] = {}
    for ev in events:
        key = (ev["task_id"], ev.get("attempt", 0))
        cur = latest.get(key)
        if cur is None or ev["time"] >= cur["time"]:
            latest[key] = ev
    rows = sorted(latest.values(), key=lambda e: e["time"])
    return _apply_filters(rows, filters)[:limit]


def list_cluster_events(filters=None, limit: int = 1000,
                        severity: Optional[str] = None
                        ) -> List[Dict[str, Any]]:
    """Structured cluster events (parity: reference ``ray list
    cluster-events`` / dashboard event module; see util/event.py)."""
    rows = _core().gcs_call("list_events",
                            {"limit": limit, "severity": severity})
    return _apply_filters(rows, filters)[:limit]


def node_stats() -> List[Dict[str, Any]]:
    """Per-node reporter payloads: cpu/mem + per-worker cpu%/rss
    (parity: dashboard/modules/reporter)."""
    return [{"node_id": n["node_id"], "state": n["state"],
             **(n.get("stats") or {})} for n in list_nodes()]


def summarize_tasks() -> Dict[str, Dict[str, int]]:
    """{func_name: {state: count}} (reference ``ray summary tasks``)."""
    out: Dict[str, Dict[str, int]] = defaultdict(lambda: defaultdict(int))
    for row in list_tasks(limit=100_000):
        out[row["name"]][row["state"]] += 1
    return {k: dict(v) for k, v in out.items()}


def _each_raylet(method: str, data: Dict[str, Any]) -> List[Any]:
    core = _core()
    out = []
    for n in core.gcs_call("get_nodes", {}):
        if not n.get("alive"):
            continue
        try:
            out.append(core.raylet_call(tuple(n["address"]), method, data))
        except Exception:
            continue
    return out


def list_workers(filters=None, limit: int = 1000) -> List[Dict[str, Any]]:
    rows = [w for per_node in _each_raylet("list_workers", {})
            for w in per_node]
    return _apply_filters(rows, filters)[:limit]


def list_objects(filters=None, limit: int = 1000) -> List[Dict[str, Any]]:
    rows = [o for per_node in _each_raylet("list_objects",
                                           {"limit": limit})
            for o in per_node["objects"]]
    return _apply_filters(rows, filters)[:limit]


def object_store_stats() -> List[Dict[str, Any]]:
    """Per-node store stats (used/capacity/spilled; ``ray memory``)."""
    return [dict(per_node["store_stats"],
                 num_spilled=per_node["num_spilled"])
            for per_node in _each_raylet("list_objects", {"limit": 0})]


def cluster_resources() -> Dict[str, float]:
    total: Dict[str, float] = defaultdict(float)
    for n in list_nodes():
        if n["state"] == "ALIVE":
            for k, v in n["resources_total"].items():
                total[k] += v
    return dict(total)


def available_resources() -> Dict[str, float]:
    avail: Dict[str, float] = defaultdict(float)
    for n in list_nodes():
        if n["state"] == "ALIVE":
            for k, v in n["resources_available"].items():
                avail[k] += v
    return dict(avail)


def list_spans(cat: Optional[str] = None, limit: int = 20000
               ) -> List[Dict[str, Any]]:
    """Raw runtime spans (object transfers, RPC retry chains) from the
    GCS span table; timestamps are already corrected onto the GCS
    clock by the reporting process."""
    return _core().gcs_call("get_spans", {"cat": cat, "limit": limit})


def get_profile(job: Optional[str] = None, node: Optional[str] = None,
                since: Optional[float] = None,
                limit: Optional[int] = None) -> Dict[str, Any]:
    """Merged continuous-profiling records from the GCS ring (see
    core/profiler.py; the CLI's ``profile`` / dashboard ``/profile``)."""
    return _core().gcs_call("get_profile", {
        "job": job, "node": node, "since": since, "limit": limit})


def analyze(job: Optional[str] = None) -> Dict[str, Any]:
    """Job time-attribution analysis (critical path + phase breakdown;
    see experimental/state/analyze.py)."""
    from ray_tpu_torch.experimental.state import analyze as analyze_mod
    return analyze_mod.analyze_job(job)


def task_event_drops() -> Dict[str, Any]:
    """Per-job counts of task events the GCS ring buffer evicted before
    any consumer read them (0s mean the state API is lossless so far)."""
    stats = _core().gcs_call("get_cluster_stats", {})
    return {"total": stats.get("task_event_drops_total", 0),
            "by_job": stats.get("task_event_drops", {})}


def timeline(filename: Optional[str] = None) -> List[Dict[str, Any]]:
    """Chrome-trace (``chrome://tracing`` / Perfetto) export of task
    events (reference ``ray timeline``, profiling.h events), merged
    with the runtime's object-transfer and RPC-retry spans.  Span
    sources clock-correct against the GCS before reporting, so
    cross-host rows line up on one Perfetto timebase."""
    events = _core().gcs_call("get_task_events", {"limit": 100_000})
    # pair RUNNING -> FINISHED/FAILED per (task, attempt)
    starts: Dict[tuple, Dict[str, Any]] = {}
    trace: List[Dict[str, Any]] = []
    for ev in sorted(events, key=lambda e: e["time"]):
        key = (ev["task_id"], ev.get("attempt", 0))
        if ev["state"] == "RUNNING":
            starts[key] = ev
        elif ev["state"] in ("FINISHED", "FAILED") and key in starts:
            start = starts.pop(key)
            trace.append({
                "name": ev["name"], "ph": "X", "cat": "task",
                "ts": start["time"] * 1e6,
                "dur": (ev["time"] - start["time"]) * 1e6,
                "pid": ev.get("worker_id", "worker")[:8],
                "tid": ev["task_id"][:8],
                "args": {"state": ev["state"], "attempt": ev.get("attempt")},
            })
    try:
        spans = list_spans()
    except Exception:  # noqa: BLE001 — pre-telemetry GCS: tasks only
        spans = []
    for span in spans:
        trace.append({
            "name": span.get("name", "span"), "ph": "X",
            "cat": span.get("cat", "runtime"),
            "ts": span["start"] * 1e6,
            "dur": max(0.0, (span["end"] - span["start"]) * 1e6),
            "pid": span.get("source", "runtime"),
            "tid": span.get("cat", "runtime"),
            "args": dict(span.get("args") or {}),
        })
    if filename:
        with open(filename, "w") as f:
            json.dump(trace, f)
    return trace
