"""Incident journal consumers: listing, postmortem rendering, bundles.

Consumer half of the incident forensics plane (``core/flight_recorder``
producers -> GCS incident journal in ``core/gcs.py`` -> here).  Three
outputs from the same incident record:

- :func:`format_incident_list` — the CLI's ``incidents`` table.
- :func:`format_incident` — the CLI's ``postmortem`` report: death
  cause + the dead processes' flight tails, the linked trace trees
  (reusing the trace renderer), the alert timeline, and sparkline
  slices of the cluster series across the incident window.  One
  command answers "what just happened" without ssh'ing anywhere.
- :func:`build_bundle` — the CLI's ``debug-bundle``: a portable tar
  (manifest + incident JSON + rendered postmortem + linked-plane
  snapshots) that can be attached to a ticket and read offline.
"""

from __future__ import annotations

import io
import json
import tarfile
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import worker as worker_mod
from ray_tpu_torch.experimental.state import traces as traces_mod

BUNDLE_FORMAT = 1


def _core():
    return worker_mod.global_worker()


def list_incidents(kind: Optional[str] = None,
                   limit: int = 50) -> List[Dict[str, Any]]:
    """Incident summaries, newest first (``kind``: death | alert)."""
    return _core().gcs_call("list_incidents",
                            {"kind": kind, "limit": limit}) or []


def get_incident(incident_id: str) -> Optional[Dict[str, Any]]:
    """Full incident record; prefix ids accepted.  None when unknown."""
    return _core().gcs_call("get_incident",
                            {"incident_id": incident_id})


def last_incident() -> Optional[Dict[str, Any]]:
    rows = list_incidents(limit=1)
    return get_incident(rows[0]["id"]) if rows else None


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def _ts(t: Optional[float]) -> str:
    if t is None:
        return "..."
    return time.strftime("%H:%M:%S", time.localtime(t)) \
        + f".{int((t % 1) * 1000):03d}"


def format_incident_list(rows: List[Dict[str, Any]]) -> str:
    if not rows:
        return "no incidents recorded (deaths and firing alerts open " \
               "them automatically)"
    lines = [f"{'incident':<18} {'kind':<7} {'sev':<8} {'state':<10} "
             f"{'opened':>9} {'deaths':>7} {'alerts':>7} title"]
    for r in rows:
        flags = " [partial]" if r.get("partial") else ""
        lines.append(
            f"{r['id']:<18} {r['kind']:<7} {r['severity']:<8} "
            f"{r['state']:<10} {_ts(r['opened_at']):>9} "
            f"{r['n_deaths']:>7} {r['n_alerts']:>7} "
            f"{r['title']}{flags}")
    return "\n".join(lines)


def _flight_tail_lines(death: Dict[str, Any], limit: int = 40
                       ) -> List[str]:
    frames = death.get("frames") or []
    torn = death.get("torn", 0)
    out = []
    head = (f"    flight tail: {len(frames)} frames"
            + (f", {torn} torn (dropped)" if torn else ""))
    if death.get("partial"):
        head += "  [PARTIAL: tail lost in the death path]"
    out.append(head)
    if not frames:
        return out
    shown = frames[-limit:]
    if len(frames) > len(shown):
        out.append(f"      ... {len(frames) - len(shown)} earlier "
                   f"frames in the record ...")
    for fr in shown:
        out.append(f"      {_ts(fr['ts'])}  {fr['type']:<12} "
                   f"{fr['detail']}")
    return out


def _alert_lines(alerts: List[Dict[str, Any]]) -> List[str]:
    out = []
    for a in alerts:
        val = f"  value={a['value']:.4g}" \
            if a.get("value") is not None else ""
        tags = ",".join(f"{k}={v}"
                        for k, v in sorted((a.get("tags") or {}).items()))
        out.append(f"  {_ts(a.get('ts'))}  [{a.get('severity', '?'):>8}] "
                   f"{a['rule']}" + (f"[{tags}]" if tags else "")
                   + f"  {a.get('from', '?')} -> {a.get('to', '?')}{val}")
    return out


def _sparkline(points: List, width: int = 24) -> str:
    bars = "▁▂▃▄▅▆▇█"
    vals = [p[1] for p in points][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(bars[min(7, int((v - lo) / span * 7.999))]
                   for v in vals)


def format_incident(inc: Optional[Dict[str, Any]],
                    fetch_trace=None, max_traces: int = 3) -> str:
    """The postmortem report.  ``fetch_trace(trace_id)`` (optional)
    pulls full span sets so the linked traces render as trees;
    without it (offline bundles) the summaries still print."""
    if inc is None:
        return "incident not found (evicted by incident_table_size, " \
               "or never opened)"
    lines: List[str] = []
    w0, w1 = (inc.get("window") or [None, None])[:2]
    lines.append(f"incident {inc['id']}  [{inc['kind']}]  "
                 f"severity={inc['severity']}  state={inc['state']}"
                 + ("  PARTIAL" if inc.get("partial") else ""))
    lines.append(f"  {inc['title']}")
    lines.append(f"  window: {_ts(w0)} .. {_ts(w1)}  "
                 f"(opened {_ts(inc['opened_at'])}, last update "
                 f"{_ts(inc['last_update'])})")
    if inc.get("nodes"):
        lines.append("  nodes: " + ", ".join(
            n[:12] for n in inc["nodes"]))
    if inc.get("jobs"):
        lines.append("  jobs: " + ", ".join(
            j[:12] for j in inc["jobs"]))
    if inc.get("deployments"):
        lines.append("  deployments: " + ", ".join(inc["deployments"]))

    deaths = inc.get("deaths") or []
    if deaths:
        lines.append("")
        lines.append(f"deaths ({len(deaths)}):")
        for d in deaths:
            node = f" on node {d['node'][:12]}" if d.get("node") else ""
            lines.append(f"  {_ts(d.get('ts'))}  {d['source']} "
                         f"pid {d['pid']}{node} — {d['reason']}")
            lines.extend(_flight_tail_lines(d))

    alerts = inc.get("alerts") or []
    firing = (inc.get("links") or {}).get("alerts_firing") or []
    if alerts or firing:
        lines.append("")
        lines.append("alert timeline:")
        lines.extend(_alert_lines(alerts))
        for a in firing:
            lines.append(f"  still firing at collection: "
                         f"[{a.get('severity', '?'):>8}] {a['rule']}  "
                         f"since {_ts(a.get('since'))}")

    links = inc.get("links") or {}
    trace_rows = links.get("traces") or []
    if trace_rows:
        lines.append("")
        lines.append(f"retained traces in the window "
                     f"({len(trace_rows)}):")
        lines.append(traces_mod.format_trace_list(trace_rows))
        if fetch_trace is not None:
            interesting = [r for r in trace_rows
                           if r.get("retried") or r.get("slo_miss")
                           or r.get("status") not in (None, "ok")]
            for row in (interesting or trace_rows)[:max_traces]:
                trace = fetch_trace(row["trace_id"])
                if trace:
                    lines.append("")
                    lines.append(traces_mod.format_trace(trace))

    series = links.get("timeseries") or {}
    if any(series.values()):
        lines.append("")
        lines.append("cluster series across the window:")
        for name in sorted(series):
            points = series[name]
            if not points:
                continue
            lines.append(f"  {name:<28}{points[-1][1]:>10.4g}  "
                         f"{_sparkline(points)}")

    if links.get("recovery", {}).get("restored"):
        rec = links["recovery"]
        lines.append("")
        lines.append(
            f"recovery during the window: "
            f"{rec.get('actors_recovered', 0)} actors restored "
            f"(+{rec.get('wal_records_replayed', 0)} WAL records) "
            f"in {rec.get('duration_s', 0):.2f}s")
    if links.get("profile_records"):
        lines.append(f"profiler: {links['profile_records']} records "
                     f"retained (the CLI's profile pulls flamegraphs)")
    return "\n".join(lines)


# ---------------------------------------------------------------------------
# debug bundles
# ---------------------------------------------------------------------------

def build_bundle(out_path: str,
                 incident: Optional[Dict[str, Any]] = None,
                 window_s: Optional[float] = None) -> Dict[str, Any]:
    """Write a portable postmortem tar and return its manifest.

    Contents: ``manifest.json`` (index + format version), the incident
    record + rendered postmortem (when one exists), and snapshots of
    every linked plane — healthz, debug_state, nodes, recent events,
    metrics, retained traces (full span sets for the incident's linked
    ids), alerts view.  Everything is JSON; the tar opens anywhere.
    ``window_s`` widens/narrows the trace/event slice for bundles
    taken without an incident."""
    w = _core()
    now = time.time()
    if incident is not None:
        w0 = (incident.get("window") or [None])[0] \
            or incident["opened_at"] - 30.0
        w1 = (incident.get("window") or [None, None])[1] or now
    else:
        w0, w1 = now - (window_s or 600.0), now
    files: Dict[str, Any] = {}

    def grab(name: str, method: str, payload: Dict[str, Any]) -> Any:
        try:
            data = w.gcs_call(method, payload)
        except Exception as e:  # noqa: BLE001 — partial bundles beat
            data = {"error": f"{type(e).__name__}: {e}"}  # no bundles
        files[name] = data
        return data

    grab("healthz.json", "healthz", {})
    grab("debug_state.json", "debug_state", {})
    nodes = grab("nodes.json", "get_nodes", {})
    if isinstance(nodes, list):
        for n in nodes:
            if isinstance(n.get("node_id"), bytes):
                n["node_id"] = n["node_id"].hex()
    grab("events.json", "list_events", {"limit": 500})
    grab("metrics.json", "get_metrics", {})
    grab("alerts.json", "get_alerts", {})
    rows = grab("traces.json", "list_traces",
                {"since": w0, "until": w1, "limit": 200})
    # full span sets: the incident's linked traces, else the windowed
    # list (capped — bundles stay attachable)
    want = list((incident or {}).get("links", {}).get("trace_ids",
                                                      ()))[:20]
    if not want and isinstance(rows, list):
        want = [r["trace_id"] for r in rows[:10]]
    full = {}
    for tid in want:
        try:
            t = w.gcs_call("get_trace", {"trace_id": tid})
        except Exception:  # noqa: BLE001
            t = None
        if t:
            full[tid] = t
    files["trace_spans.json"] = full
    if incident is not None:
        files["incident.json"] = incident
        files["postmortem.txt"] = format_incident(
            incident, fetch_trace=lambda tid: full.get(tid))

    manifest = {
        "format": BUNDLE_FORMAT,
        "created_at": now,
        "window": [w0, w1],
        "incident_id": incident["id"] if incident else None,
        "files": sorted(files) + ["manifest.json"],
    }
    with tarfile.open(out_path, "w:gz") as tar:
        def add(name: str, blob: bytes) -> None:
            info = tarfile.TarInfo(name)
            info.size = len(blob)
            info.mtime = int(now)
            tar.addfile(info, io.BytesIO(blob))

        add("manifest.json",
            json.dumps(manifest, indent=2).encode())
        for name, data in sorted(files.items()):
            if name.endswith(".txt"):
                add(name, str(data).encode())
            else:
                add(name, json.dumps(data, indent=2,
                                     default=str).encode())
    return manifest
