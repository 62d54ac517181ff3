"""The port's command line: ``python -m ray_tpu_torch.scripts.cli``.

Parity: reference ``python/ray/scripts/scripts.py`` (``ray start/stop/
status/timeline/memory/microbenchmark``) and
``experimental/state/state_cli.py`` (``ray list/summary``) plus the job
CLI (``dashboard/modules/job/cli.py``).  argparse-based (click is a
dependency we don't take).

``start --head`` daemonizes a head node and records its address at
``<session_root>/latest_head.json`` so later CLI invocations (and
``init(address="auto")``) find it without arguments.

``dashboard`` serves the JSON dashboard and its job routes, ``job``
submits and follows jobs through them, and ``up`` / ``down`` launch and
tear down a cluster from a YAML config.  The JAX package's ``debug`` and
``metrics export-config`` (ROADMAP.md queue 1, item 7.7) parse as there
and raise ``not_ported``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from typing import Any, Dict, Optional

from ray_tpu_torch._port import not_ported

LATEST = "latest_head.json"


def _session_root() -> str:
    from ray_tpu_torch.core.config import Config
    return Config().apply_env_overrides().session_root


def _latest_path() -> str:
    return os.path.join(_session_root(), LATEST)


def _load_latest() -> Optional[Dict[str, Any]]:
    try:
        with open(_latest_path()) as f:
            return json.load(f)
    except (FileNotFoundError, json.JSONDecodeError):
        return None


def _resolve_address(args) -> str:
    addr = getattr(args, "address", None) \
        or os.environ.get("RAY_TPU_TORCH_ADDRESS")
    if not addr:
        latest = _load_latest()
        if latest:
            addr = "{}:{}".format(*latest["gcs_address"])
    if not addr:
        sys.exit("no cluster address: pass --address, set "
                 "RAY_TPU_TORCH_ADDRESS, or run `python -m "
                 "ray_tpu_torch.scripts.cli start --head`")
    return addr


def _connect(args) -> None:
    import ray_tpu_torch
    ray_tpu_torch.init(address=_resolve_address(args),
                 ignore_reinit_error=True)


# ----------------------------------------------------------------------
def cmd_start(args) -> None:
    from ray_tpu_torch.core.config import Config
    from ray_tpu_torch.core import node as node_mod

    config = Config().apply_env_overrides()
    resources: Dict[str, float] = {}
    if args.num_cpus is not None:
        resources["CPU"] = float(args.num_cpus)
    if args.num_gpus is not None:
        resources["GPU"] = float(args.num_gpus)
    if args.resources:
        resources.update(json.loads(args.resources))

    if args.head:
        session_dir = node_mod.new_session_dir(config)
        proc, handshake = node_mod.spawn_head(config, session_dir,
                                              resources or None)
        record = dict(handshake, pid=proc.pid)
        with open(_latest_path(), "w") as f:
            json.dump(record, f)
        gcs = handshake["gcs_address"]
        print(f"head started (pid {proc.pid})")
        print(f"  GCS address: {gcs[0]}:{gcs[1]}")
        print(f"  session dir: {handshake['session_dir']}")
        if args.ray_client_server_port:
            import subprocess as sp
            # the server logs beside the head's, so that this command's
            # own stdout closes when it exits; it is ready once it says so
            log = os.path.join(handshake["session_dir"], "logs",
                               f"client-server-{args.ray_client_server_port}"
                               ".out")
            with open(log, "ab") as out:
                client_proc = sp.Popen(
                    [sys.executable, "-m",
                     "ray_tpu_torch.util.client.server",
                     "--address", f"{gcs[0]}:{gcs[1]}",
                     "--port", str(args.ray_client_server_port)],
                    stdout=out, stderr=sp.STDOUT, start_new_session=True)
            _await_line(log, "ready on ray://", client_proc)
            record["client_server_pid"] = client_proc.pid
            with open(_latest_path(), "w") as f:
                json.dump(record, f)
            print(f"  client server: "
                  f"ray://{gcs[0]}:{args.ray_client_server_port} "
                  f"(pid {client_proc.pid})")
        print(f"connect with: "
              f"ray_tpu_torch.init(address=\"{gcs[0]}:{gcs[1]}\")"
              f" or ray_tpu_torch.init(address=\"auto\") with "
              f"RAY_TPU_TORCH_ADDRESS={gcs[0]}:{gcs[1]}")
    else:
        addr = _resolve_address(args)
        host, port = addr.rsplit(":", 1)
        session_dir = node_mod.new_session_dir(config)
        proc, handshake = node_mod.spawn_node(
            config, session_dir, (host, int(port)), resources or None)
        print(f"worker node started (pid {proc.pid}) joined {addr}")


def _await_line(path: str, text: str, proc, timeout: float = 120.0
                ) -> None:
    """Wait until ``proc`` writes ``text`` to its log at ``path``."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        with open(path, errors="replace") as f:
            if text in f.read():
                return
        if proc.poll() is not None:
            sys.exit(f"client server exited with {proc.returncode}; "
                     f"see {path}")
        time.sleep(0.1)
    sys.exit(f"client server not ready after {timeout:.0f}s; see {path}")


def cmd_stop(args) -> None:
    latest = _load_latest()
    if latest is None:
        sys.exit("no recorded head (nothing started via the CLI's `start`)")
    pid = latest.get("pid")
    client_pid = latest.get("client_server_pid")
    if client_pid:
        try:
            os.kill(client_pid, signal.SIGTERM)
            print(f"sent SIGTERM to client server (pid {client_pid})")
        except ProcessLookupError:
            pass
    try:
        os.kill(pid, signal.SIGTERM)
        print(f"sent SIGTERM to head (pid {pid})")
    except ProcessLookupError:
        print(f"head (pid {pid}) already gone")
    try:
        os.remove(_latest_path())
    except FileNotFoundError:
        pass


def _metric_total(records, name: str) -> float:
    """Sum a metric's value across every tagset in the GCS table."""
    return sum(r.get("value", 0) for r in records if r["name"] == name)


def cmd_status(args) -> None:
    """One-screen cluster snapshot: nodes/resources, per-node arena +
    transfer/lease state (from raylet ``debug_state``), and the
    cluster-wide telemetry counters (retries, heartbeat misses, event
    drops) from the GCS metrics table."""
    _connect(args)
    from ray_tpu_torch.core.worker import global_worker
    from ray_tpu_torch.experimental.state import api as state
    w = global_worker()
    nodes = state.list_nodes()
    total = state.cluster_resources()
    avail = state.available_resources()
    print(f"nodes: {len(nodes)} "
          f"({sum(1 for n in nodes if n['state'] == 'ALIVE')} alive)")
    for k in sorted(total):
        print(f"  {k}: {avail.get(k, 0):g}/{total[k]:g} available")
    # per-node reporter (cpu/mem + workers) and runtime plane snapshot
    for n in nodes:
        stats = n.get("stats") or {}
        if stats:
            print(f"node {n['node_id'][:12]}: "
                  f"cpu {stats.get('cpu_percent', 0):.0f}%  "
                  f"mem {stats.get('mem_percent', 0):.0f}% "
                  f"({stats.get('mem_used', 0)/2**30:.1f}/"
                  f"{stats.get('mem_total', 0)/2**30:.1f} GiB)")
            for wk in stats.get("workers", []):
                kind = "actor " if wk.get("is_actor") else "worker"
                print(f"    {kind} pid {wk['pid']:>7}  "
                      f"cpu {wk.get('cpu_percent', 0):5.1f}%  "
                      f"rss {wk.get('rss', 0)/2**20:8.1f} MiB")
        if n["state"] != "ALIVE":
            continue
        try:
            dbg = w.raylet_call(tuple(n["address"]), "debug_state", {})
        except Exception:  # noqa: BLE001 — raylet unreachable
            print(f"  node {n['node_id'][:12]}: debug_state unreachable")
            continue
        store = dbg.get("store") or {}
        cap = store.get("capacity", 0) or 1
        line = (f"  arena {store.get('used', 0)/2**20:8.1f}/"
                f"{cap/2**20:.0f} MiB  "
                f"objects {store.get('num_objects', 0)}")
        hits = store.get("reuse_hits", 0)
        misses = store.get("reuse_misses", 0)
        if hits + misses:
            line += f"  reuse {hits / (hits + misses):.0%}"
        if store.get("doomed_current"):
            line += f"  doomed {store['doomed_current']}"
        print(line)
        print(f"  transfers inflight {dbg.get('inflight_pulls', 0)}  "
              f"leases queued {dbg.get('pending_leases', 0)}  "
              f"workers {dbg.get('workers', 0)} "
              f"({dbg.get('idle_workers', 0)} idle)  "
              f"spilled {dbg.get('spilled_objects', 0)}")
    # cluster-wide telemetry counters (populated by the per-process
    # flush loops; zeros just mean a quiet or freshly-booted cluster)
    try:
        records = w.gcs_call("get_metrics", {})
        gcs_dbg = w.gcs_call("debug_state", {})
    except Exception:  # noqa: BLE001
        return
    retries = _metric_total(records, "ray_tpu_rpc_retries_total")
    deadlines = _metric_total(records,
                              "ray_tpu_rpc_deadline_exceeded_total")
    misses = _metric_total(records, "ray_tpu_gcs_heartbeat_misses_total")
    pulls = _metric_total(records, "ray_tpu_transfer_pulls_total")
    tbytes = _metric_total(records, "ray_tpu_transfer_bytes_total")
    drops = gcs_dbg.get("task_event_drops_total", 0)
    print(f"rpc: {retries:g} retries, {deadlines:g} deadline-exceeded, "
          f"{misses:g} heartbeat misses")
    print(f"transfers: {pulls:g} pulls, {tbytes/2**20:.1f} MiB moved")
    if gcs_dbg.get("incidents"):
        line = (f"incidents: {gcs_dbg['incidents']} recorded"
                f" ({gcs_dbg.get('incidents_open', 0)} open)")
        print(line + "  — the CLI's `postmortem` for the newest")
    _print_persistence_section(gcs_dbg)
    if drops:
        print(f"WARNING: {drops} task events dropped by the GCS ring "
              f"buffer (per-job: {gcs_dbg.get('task_event_drops')})")
    # serving plane: one line per deployment (replicas, queue depth,
    # shed, p99 from the controller's replica poll) + SLO-miss trace
    # counts from the GCS trace ring
    try:
        _print_serve_section(w)
    except Exception:  # noqa: BLE001 — serve not running
        pass
    # one-line time attribution of the most recent job (full breakdown
    # via the CLI's `analyze`)
    try:
        from ray_tpu_torch.experimental.state import analyze as analyze_mod
        result = analyze_mod.analyze_job()
        if not result.get("error"):
            print(analyze_mod.summary_line(result))
    except Exception:  # noqa: BLE001 — status must survive a quiet GCS
        pass


def _print_persistence_section(gcs_dbg: dict) -> None:
    """GCS durability health: storage backend, snapshot freshness, WAL
    size/appends, degradation, and (after a head restart) how the
    recovery went — all from the GCS ``debug_state`` persistence/
    recovery blocks (docs/ha.md)."""
    health = gcs_dbg.get("persistence")
    if not health:
        return  # pre-HA GCS
    line = f"persistence: {health.get('backend', '?')}"
    age = health.get("last_persist_age_s")
    if age is not None:
        line += f"  last snapshot {age:.1f}s ago"
    wal = health.get("wal")
    if wal:
        line += (f"  wal {wal.get('size_bytes', 0)/2**10:.1f} KiB "
                 f"({wal.get('appends', 0)} appends, "
                 f"{wal.get('fsyncs', 0)} fsyncs, {wal.get('sync')})")
    elif health.get("wal_degraded"):
        line += "  WAL DEGRADED (snapshot-only)"
    else:
        line += "  wal off"
    if health.get("persist_failures"):
        line += f"  WARNING: {health['persist_failures']} persist failures"
    print(line)
    rec = gcs_dbg.get("recovery") or {}
    if rec.get("restored"):
        print(f"recovery: {rec.get('actors_recovered', 0)} actors "
              f"(+{rec.get('wal_records_replayed', 0)} WAL records) "
              f"restored in {rec.get('duration_s', 0):.2f}s"
              + ("" if rec.get("complete")
                 else "  [reconvergence in progress]"))


def _print_serve_section(w) -> None:
    """Serve deployments in the one-screen status (sourced from the
    controller's per-replica metrics poll + the GCS trace ring)."""
    import ray_tpu_torch
    from ray_tpu_torch.serve._internal import CONTROLLER_NAME

    try:
        controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    except ValueError:
        return  # serve never started on this cluster
    deps = ray_tpu_torch.get(controller.list_deployments.remote(), timeout=10)
    if not deps:
        return
    # SLO-miss/error trace counts per deployment from tail sampling
    miss_counts: Dict[str, int] = {}
    try:
        for row in w.gcs_call("list_traces",
                              {"slo_misses": True, "limit": 1000}):
            dep = row.get("deployment")
            if dep:
                miss_counts[dep] = miss_counts.get(dep, 0) + 1
    except Exception:  # noqa: BLE001 — pre-tracing GCS
        pass
    print("serve deployments:")
    for name in sorted(deps):
        info = deps[name]
        line = (f"  {name}: replicas "
                f"{info['num_replicas']}/{info['target_replicas']}  "
                f"queue {info.get('queue_depth', 0)}  "
                f"shed {info.get('shed_total', 0)}  "
                f"p99 {info.get('p99_ms', 0.0):.1f}ms")
        misses = miss_counts.get(name, 0)
        if misses:
            line += (f"  SLO-miss traces {misses} "
                     f"(trace --slo-misses {name})")
        print(line)


_SPARK_BARS = "▁▂▃▄▅▆▇█"


def _sparkline(points, width: int = 16) -> str:
    """History points -> a fixed-width unicode sparkline (newest
    right); flat series render as a flat bar, not noise."""
    vals = [p[1] for p in points][-width:]
    if not vals:
        return ""
    lo, hi = min(vals), max(vals)
    span = (hi - lo) or 1.0
    return "".join(_SPARK_BARS[min(7, int((v - lo) / span * 7.999))]
                   for v in vals)


def _gauge_by_tag(records, name: str, tag: str) -> Dict[str, float]:
    """Latest value of a gauge per distinct value of one tag."""
    out: Dict[str, float] = {}
    for r in records:
        if r["name"] == name:
            out[r.get("tags", {}).get(tag, "?")] = r.get("value", 0)
    return out


def _fmt_since(ts: float) -> str:
    age = max(0.0, time.time() - ts)
    if age < 90:
        return f"{age:.0f}s"
    if age < 5400:
        return f"{age / 60:.0f}m"
    return f"{age / 3600:.1f}h"


def _render_top(w, jobs: bool = False) -> list:
    """One frame of the CLI's ``top``: health verdict, firing alerts,
    per-node gauges, derived-signal sparklines — and with ``jobs``,
    the per-tenant attribution table."""
    lines = []
    verdict = w.gcs_call("healthz", {})
    records = w.gcs_call("get_metrics", {})
    lines.append(
        f"health: {verdict.get('status', '?')}  "
        f"nodes alive: {verdict.get('alive_nodes', 0)}  "
        f"firing alerts: {len(verdict.get('firing', []))}"
        + (f" ({', '.join(verdict['firing'])})"
           if verdict.get("firing") else ""))
    # per-node gauges (node-tagged series from the raylet flush loops)
    used = _gauge_by_tag(records, "ray_tpu_arena_used_bytes", "node")
    cap = _gauge_by_tag(records, "ray_tpu_arena_capacity_bytes", "node")
    workers = _gauge_by_tag(records, "ray_tpu_workers_total", "node")
    idle = _gauge_by_tag(records, "ray_tpu_workers_idle", "node")
    leases = _gauge_by_tag(records, "ray_tpu_sched_pending_leases",
                           "node")
    pulls = _gauge_by_tag(records, "ray_tpu_transfer_inflight_pulls",
                          "node")
    if used:
        lines.append("")
        lines.append(f"{'node':<14}{'arena':>18}{'occ':>6}"
                     f"{'workers':>9}{'leases':>8}{'pulls':>7}")
        for node in sorted(used):
            c = cap.get(node, 0) or 1
            lines.append(
                f"{node:<14}"
                f"{used[node] / 2**20:>8.1f}/{c / 2**20:<6.0f}MiB"
                f"{used[node] / c:>6.0%}"
                f"{workers.get(node, 0):>5.0f}"
                f"({idle.get(node, 0):.0f})"
                f"{leases.get(node, 0):>8.0f}"
                f"{pulls.get(node, 0):>7.0f}")
    # derived signals + history sparklines from the health plane
    rows = []
    for prefix in ("cluster:", "serve:", "gcs:"):
        rows.extend(w.gcs_call("get_timeseries",
                               {"series": prefix + "*", "limit": 50}))
    if rows:
        lines.append("")
        lines.append(f"{'signal':<34}{'now':>12}  history")
        for row in rows:
            if not row["points"]:
                continue
            tags = ",".join(f"{k}={v}"
                            for k, v in sorted(row["tags"].items()))
            label = row["name"] + (f"[{tags}]" if tags else "")
            lines.append(f"{label:<34}{row['points'][-1][1]:>12.4g}  "
                         f"{_sparkline(row['points'])}")
    if jobs:
        lines.append("")
        try:
            qview = w.gcs_call("get_job_quotas", {}) or {}
        except Exception:  # noqa: BLE001 — pre-quota GCS
            qview = {}
        lines.extend(_render_jobs(records, qview.get("quotas"),
                                  qview.get("lease_tables")))
    return lines


def _render_jobs(records, quotas=None, lease_tables=None) -> list:
    """Per-job attribution rollup: the ``ray_tpu_job_*`` series plus
    the fair-queue view (quota weight, in-flight CPU the lease tables
    attribute to the job, leases throttled behind its weight)."""
    cols = {"ray_tpu_job_tasks_total": "tasks",
            "ray_tpu_job_cpu_seconds_total": "cpu_s",
            "ray_tpu_job_submitted_bytes_total": "submitted",
            "ray_tpu_job_spilled_bytes_total": "spilled",
            "ray_tpu_job_arena_bytes": "arena"}
    per_job: Dict[str, Dict[str, float]] = {}
    for r in records:
        col = cols.get(r["name"])
        if col is None:
            if r["name"] == "ray_tpu_sched_quota_throttled_total":
                job = r.get("tags", {}).get("job", "unknown")
                row = per_job.setdefault(job, {})
                row["throttled"] = row.get("throttled", 0.0) \
                    + r.get("value", 0)
            continue
        job = r.get("tags", {}).get("job", "unknown")
        row = per_job.setdefault(job, {})
        # arena gauges are per (node, job): sum across nodes
        row[col] = row.get(col, 0.0) + r.get("value", 0)
    quotas = quotas or {}
    for job in quotas:
        per_job.setdefault(job, {})
    # in-flight usage: the per-node lease tables, summed across nodes
    for table in (lease_tables or {}).values():
        for job, usage in (table or {}).items():
            row = per_job.setdefault(job, {})
            row["in_use"] = row.get("in_use", 0.0) \
                + float((usage or {}).get("CPU", 0.0))
    out = [f"{'job':<14}{'tasks':>8}{'cpu-s':>9}{'submitted':>11}"
           f"{'spilled':>9}{'arena':>9}{'wt':>5}{'in-use':>8}"
           f"{'thrtl':>7}"]
    if not per_job:
        out.append("  (no per-job series yet — run some tasks)")
        return out
    for job in sorted(per_job,
                      key=lambda j: -per_job[j].get("cpu_s", 0)):
        row = per_job[job]
        q = quotas.get(job) or {}
        wt = f"{float(q.get('weight', 1.0)):g}" if q else "-"
        out.append(
            f"{job:<14}{row.get('tasks', 0):>8.0f}"
            f"{row.get('cpu_s', 0):>9.2f}"
            f"{row.get('submitted', 0) / 2**20:>10.1f}M"
            f"{row.get('spilled', 0) / 2**20:>8.1f}M"
            f"{row.get('arena', 0) / 2**20:>8.1f}M"
            f"{wt:>5}"
            f"{row.get('in_use', 0.0):>8.1f}"
            f"{row.get('throttled', 0):>7.0f}")
    return out


def cmd_top(args) -> None:
    """Live refreshing cluster view: per-node arena/lease/worker
    gauges plus history-derived rates with sparkline columns, all off
    the GCS health plane (``--jobs`` adds per-tenant attribution;
    ``--once`` prints a single frame for scripts/tests)."""
    _connect(args)
    from ray_tpu_torch.core.worker import global_worker
    w = global_worker()
    try:
        while True:
            lines = _render_top(w, jobs=args.jobs)
            if not args.once:
                sys.stdout.write("\x1b[2J\x1b[H")  # clear + home
            print("\n".join(lines), flush=True)
            if args.once:
                return
            time.sleep(args.interval)
    except KeyboardInterrupt:
        pass


def cmd_alerts(args) -> None:
    """Firing + recently-resolved alerts from the GCS health table
    (rule, value, since; ``--json`` for the raw view)."""
    _connect(args)
    from ray_tpu_torch.core.worker import global_worker
    view = global_worker().gcs_call("get_alerts", {})
    if args.json:
        print(json.dumps(view, indent=2, default=str))
        return
    firing = view.get("firing", [])
    if firing:
        print("FIRING:")
        for a in firing:
            tags = ",".join(f"{k}={v}"
                            for k, v in sorted(a["tags"].items()))
            val = f"{a['value']:.4g}" if a.get("value") is not None \
                else "?"
            print(f"  [{a['severity']:>8}] {a['rule']}"
                  + (f"[{tags}]" if tags else "")
                  + f"  value={val}  since {_fmt_since(a['since'])} ago"
                  + ("  (restored)" if a.get("restored") else ""))
    else:
        print("no alerts firing")
    resolved = view.get("resolved", [])
    if resolved:
        print("recently resolved:")
        for a in resolved[-args.limit:]:
            tags = ",".join(f"{k}={v}"
                            for k, v in sorted(a["tags"].items()))
            print(f"  {a['rule']}" + (f"[{tags}]" if tags else "")
                  + f"  resolved {_fmt_since(a['resolved_at'])} ago "
                  f"(fired {_fmt_since(a['since'])} ago)")


def cmd_nodes(args) -> None:
    """Node lifecycle table: ACTIVE/DRAINING/DRAINED/DEAD state per
    node (the drain protocol's view, docs/autoscaler.md) plus the
    autoscaler monitor's last recorded decision."""
    _connect(args)
    from ray_tpu_torch.core.worker import global_worker
    w = global_worker()
    nodes = w.gcs_call("get_nodes", {}) or []
    if args.json:
        for n in nodes:
            n["node_id"] = n["node_id"].hex()
        print(json.dumps(nodes, indent=2, default=str))
        return
    print(f"{'node':<14}{'state':<10}{'alive':<7}{'cpu':>10}"
          f"{'gpu':>8}{'load':>6}  reason")
    for n in sorted(nodes, key=lambda n: n["node_id"]):
        total = n.get("resources_total", {})
        avail = n.get("resources_available", {})
        cpu = f"{avail.get('CPU', 0):g}/{total.get('CPU', 0):g}"
        gpu = f"{avail.get('GPU', 0):g}/{total.get('GPU', 0):g}" \
            if total.get("GPU") else "-"
        print(f"{n['node_id'].hex()[:12]:<14}"
              f"{n.get('state', 'ACTIVE'):<10}"
              f"{'yes' if n.get('alive') else 'no':<7}"
              f"{cpu:>10}{gpu:>8}"
              f"{n.get('load', 0):>6}  "
              f"{n.get('drain_reason') or ''}")
    # the autoscaler monitor's last decision (internal KV record)
    try:
        from ray_tpu_torch.core.gcs import AUTOSCALER_DECISION_KV_KEY
        raw = w.gcs_call("kv_get",
                         {"key": AUTOSCALER_DECISION_KV_KEY})
    except Exception:  # noqa: BLE001 — pre-autoscaler GCS
        raw = None
    if raw:
        if isinstance(raw, bytes):
            raw = raw.decode()
        try:
            d = json.loads(raw)
        except ValueError:
            d = None
        if d:
            line = (f"autoscaler: {d.get('action', '?')}"
                    + (" (urgent)" if d.get("urgent") else ""))
            if d.get("reason"):
                line += f"  [{d['reason']}]"
            launched = d.get("launched") or {}
            if launched:
                line += "  launched " + ", ".join(
                    f"{v}x{k}" for k, v in sorted(launched.items()))
            if d.get("terminated"):
                line += f"  terminated {len(d['terminated'])}"
            if d.get("ts") is not None:
                line += f"  workers={d.get('num_workers', '?')}"
            print(line)
    else:
        print("autoscaler: no decision recorded "
              "(monitor not running)")


def cmd_events(args) -> None:
    _connect(args)
    from ray_tpu_torch.experimental.state import api as state
    rows = state.list_cluster_events(limit=args.limit,
                                     severity=args.severity)
    for r in rows:
        ts = time.strftime("%H:%M:%S", time.localtime(r["timestamp"]))
        print(f"{ts} [{r['severity']:>7}] {r['source_type']:<8} "
              f"{r['label']:<18} {r['message']}")


def cmd_list(args) -> None:
    _connect(args)
    from ray_tpu_torch.experimental.state import api as state
    fn = {
        "tasks": state.list_tasks,
        "actors": state.list_actors,
        "nodes": state.list_nodes,
        "workers": state.list_workers,
        "objects": state.list_objects,
        "placement-groups": state.list_placement_groups,
        "jobs": state.list_jobs,
        "cluster-events": state.list_cluster_events,
    }[args.resource]
    rows = fn(limit=args.limit)
    print(json.dumps(rows, indent=2, default=str))


def cmd_summary(args) -> None:
    _connect(args)
    from ray_tpu_torch.experimental.state import api as state
    print(json.dumps(state.summarize_tasks(), indent=2))


def cmd_timeline(args) -> None:
    _connect(args)
    import ray_tpu_torch
    events = ray_tpu_torch.timeline(args.output)
    print(f"wrote {len(events)} trace events to {args.output}")


def cmd_memory(args) -> None:
    _connect(args)
    from ray_tpu_torch.experimental.state import api as state
    for i, s in enumerate(state.object_store_stats()):
        print(f"node {i}: {s['used']}/{s['capacity']} bytes, "
              f"{s['num_objects']} objects, {s['num_spilled']} spilled")
    objs = state.list_objects(limit=args.limit)
    for o in objs:
        print(f"  {o['object_id'][:16]}…  {o['size']:>10} B  "
              f"node {o['node_id'][:8]}")


def cmd_serve(args) -> None:
    """Serve status/shutdown against a running cluster (reference
    ``serve status`` / ``serve shutdown`` CLI)."""
    _connect(args)
    from ray_tpu_torch import serve as serve_mod

    if args.serve_cmd == "status":
        try:
            from ray_tpu_torch.serve.schema import status_config
            status = status_config()
        except Exception as e:  # noqa: BLE001
            sys.exit(f"serve is not running: {e}")
        print(json.dumps(status, indent=2, default=str))
    elif args.serve_cmd == "shutdown":
        serve_mod.shutdown()
        print("serve shut down")
    elif args.serve_cmd == "deploy":
        from ray_tpu_torch.serve.schema import deploy_config
        names = deploy_config(args.config_file)
        print(f"deployed: {', '.join(names)}")


def cmd_dashboard(args) -> None:
    _connect(args)
    from ray_tpu_torch.dashboard import Dashboard
    dash = Dashboard(host=args.host, port=args.port)
    url = dash.start()
    print(f"dashboard at {url} (ctrl-c to exit)", flush=True)
    try:
        while True:
            time.sleep(3600)
    except KeyboardInterrupt:
        dash.stop()


def cmd_job(args) -> None:
    from ray_tpu_torch.job import JobSubmissionClient
    client = JobSubmissionClient(args.dashboard_address)
    if args.job_cmd == "submit":
        sid = client.submit_job(entrypoint=" ".join(args.entrypoint))
        print(f"submitted: {sid}")
        if args.wait:
            status = client.wait_until_finished(sid)
            print(f"{sid}: {status}")
            print(client.get_job_logs(sid))
    elif args.job_cmd == "status":
        print(client.get_job_status(args.submission_id))
    elif args.job_cmd == "logs":
        print(client.get_job_logs(args.submission_id))
    elif args.job_cmd == "stop":
        print(client.stop_job(args.submission_id))
    elif args.job_cmd == "list":
        print(json.dumps(client.list_jobs(), indent=2))


def cmd_microbenchmark(args) -> None:
    from ray_tpu_torch.scripts.ray_perf import main as perf_main
    perf_main()


def cmd_debug(args) -> None:
    raise not_ported("the remote debugger (util/rpdb.py)",
                     "queue 1, item 7.7")


def cmd_stack(args) -> None:
    """All-thread stack dumps from every worker in the cluster
    (parity: `ray stack`, without needing py-spy)."""
    _connect(args)
    from ray_tpu_torch.core.worker import global_worker
    from ray_tpu_torch.experimental.state import api as state

    w = global_worker()
    for n in state.list_nodes():
        if n["state"] != "ALIVE":
            continue
        try:
            dump = w.raylet_call(tuple(n["address"]),
                                 "stack_traces", {})
        except Exception as e:  # noqa: BLE001
            print(f"node {n['node_id'][:12]}: unreachable ({e})")
            continue
        print(f"=== node {dump['node_id'][:12]} "
              f"({len(dump['workers'])} workers) ===")
        raylet = dump.get("raylet")
        if raylet:
            print(f"--- raylet pid {raylet.get('pid')} ---")
            for t in raylet.get("threads", []):
                print(f"  thread {t['thread']}:")
                for line in t["stack"].rstrip().splitlines():
                    print(f"    {line}")
        for wk in dump["workers"]:
            head = f"--- pid {wk.get('pid')}"
            if wk.get("actor_id"):
                head += f" actor {wk['actor_id'][:12]}"
            print(head + " ---")
            if wk.get("error"):
                print(f"  <{wk['error']}>")
                continue
            for t in wk.get("threads", []):
                head = f"  thread {t['thread']}"
                if t.get("task"):
                    head += (f" [task {t['task']}"
                             f" {(t.get('task_id') or '')[:12]}]")
                print(head + ":")
                for line in t["stack"].rstrip().splitlines():
                    print(f"    {line}")


def cmd_profile(args) -> None:
    """Arm the cluster's continuous profiler for a window, then pull
    the merged flamegraph (collapsed-stack + speedscope files)."""
    _connect(args)
    from ray_tpu_torch.core import profiler as profiler_mod
    from ray_tpu_torch.core.worker import global_worker

    w = global_worker()
    duration = max(0.5, args.duration)
    # the GCS profile ring keeps records from EARLIER windows; scope
    # this pull to samples drained after the arm (GCS timebase)
    window_start = w.gcs_call("clock_sync", {}).get("time")
    reply = w.gcs_call("profiler_control", {
        "enabled": True, "hz": args.hz, "duration_s": duration})
    print(f"profiling {reply.get('nodes_applied', 0)} nodes / "
          f"{reply.get('workers_applied', 0)} workers at "
          f"{args.hz or 'default'} Hz for {duration:g}s ...")
    time.sleep(duration)
    # wait for the per-process flush loops (1 Hz while profiling) to
    # land the tail of the window: poll until the ring stops growing
    query = {"job": args.job, "node": args.node, "since": window_start}
    prev = -1
    deadline = time.time() + 15.0
    profile = w.gcs_call("get_profile", query)
    while time.time() < deadline:
        if profile["raw_records"] > 0 and \
                profile["raw_records"] == prev:
            break
        prev = profile["raw_records"]
        time.sleep(1.0)
        profile = w.gcs_call("get_profile", query)
    records = profile["records"]
    if not records:
        sys.exit("no profile samples collected (cluster idle, or the "
                 "window was too short)")
    base = args.output
    collapsed_path = base + ".collapsed"
    speedscope_path = base + ".speedscope.json"
    with open(collapsed_path, "w") as f:
        f.write(profiler_mod.to_collapsed(records))
    with open(speedscope_path, "w") as f:
        json.dump(profiler_mod.to_speedscope(
            records, name=f"ray_tpu_torch {duration:g}s @ "
                          f"{args.hz or 'default'} Hz"), f)
    total = profile["total_samples"]
    print(f"{total} samples from {len(profile['sources'])} processes, "
          f"{len(records)} distinct stacks")
    print(f"  collapsed:  {collapsed_path}")
    print(f"  speedscope: {speedscope_path} "
          f"(open at https://speedscope.app)")
    print("top stacks:")
    for rec in records[:args.top]:
        leaf = (rec.get("stack") or "?").rsplit(";", 1)[-1]
        task = f"  [{rec['task']}]" if rec.get("task") else ""
        print(f"  {rec['count']:>6} ({rec['count']/total:5.1%}) "
              f"{leaf}{task}")


def cmd_analyze(args) -> None:
    """Per-task time attribution of one job: critical path + phase
    breakdown (pending->sched->fetch->exec->reply)."""
    _connect(args)
    from ray_tpu_torch.experimental.state import analyze as analyze_mod

    job = None if args.job in (None, "latest") else args.job
    result = analyze_mod.analyze_job(job)
    if args.json:
        print(json.dumps(result, indent=2, default=str))
    else:
        print(analyze_mod.format_report(result))


def cmd_trace(args) -> None:
    """Render one assembled request trace (span tree with per-hop
    durations telescoping to the client-observed latency), or list
    retained traces (``--slo-misses <deployment>``, ``--list``)."""
    _connect(args)
    from ray_tpu_torch.experimental.state import traces as traces_mod

    if args.trace_id:
        trace = traces_mod.get_trace(args.trace_id)
        if args.json:
            print(json.dumps(trace, indent=2, default=str))
        else:
            print(traces_mod.format_trace(trace))
        return
    rows = traces_mod.list_traces(
        deployment=args.slo_misses or args.deployment,
        slo_misses=args.slo_misses is not None,
        limit=args.limit)
    if args.json:
        print(json.dumps(rows, indent=2, default=str))
    else:
        print(traces_mod.format_trace_list(rows))


def cmd_incidents(args) -> None:
    """The cluster incident journal: auto-opened on process/node
    deaths and firing alerts (``incidents`` lists,
    ``incidents <id>`` shows one; full report via
    ``postmortem``)."""
    _connect(args)
    from ray_tpu_torch.experimental.state import incidents as inc_mod

    if args.incident_id:
        inc = inc_mod.get_incident(args.incident_id)
        if args.json:
            print(json.dumps(inc, indent=2, default=str))
        else:
            print(inc_mod.format_incident(inc))
        return
    rows = inc_mod.list_incidents(kind=args.kind, limit=args.limit)
    if args.json:
        print(json.dumps(rows, indent=2, default=str))
    else:
        print(inc_mod.format_incident_list(rows))


def cmd_postmortem(args) -> None:
    """One-command postmortem: death cause, each dead process's
    flight-recorder tail, the linked trace trees, the alert timeline,
    and cluster-series sparklines across the incident window."""
    _connect(args)
    from ray_tpu_torch.experimental.state import incidents as inc_mod
    from ray_tpu_torch.experimental.state import traces as traces_mod

    if args.incident_id:
        inc = inc_mod.get_incident(args.incident_id)
    else:
        inc = inc_mod.last_incident()
        if inc is None:
            sys.exit("no incidents recorded — nothing to postmortem")
    if args.json:
        print(json.dumps(inc, indent=2, default=str))
        return
    print(inc_mod.format_incident(inc,
                                  fetch_trace=traces_mod.get_trace))


def cmd_debug_bundle(args) -> None:
    """Portable forensics tar: the incident (default: newest) plus
    snapshots of every linked plane, indexed by a manifest — built to
    be attached to a ticket and read offline."""
    _connect(args)
    from ray_tpu_torch.experimental.state import incidents as inc_mod

    inc = None
    if args.incident_id:
        inc = inc_mod.get_incident(args.incident_id)
        if inc is None:
            sys.exit(f"incident {args.incident_id!r} not found")
    elif not args.window:
        inc = inc_mod.last_incident()
    out = args.output
    if not out:
        tag = inc["id"] if inc else time.strftime("%Y%m%d-%H%M%S")
        out = f"debug-bundle-{tag}.tar.gz"
    manifest = inc_mod.build_bundle(out, incident=inc,
                                    window_s=args.window)
    print(f"wrote {out}")
    print("  incident: " + (manifest["incident_id"]
                            or "(none — windowed snapshot only)"))
    print(f"  files: {', '.join(manifest['files'])}")


def cmd_logs(args) -> None:
    """Tail worker stdout/stderr cluster-wide off the ``worker_logs``
    GCS channel (the raylet log monitors already publish; this is the
    first consumer beyond the driver echo)."""
    import re as re_mod

    _connect(args)
    from ray_tpu_torch.core.worker import global_worker

    w = global_worker()
    pattern = re_mod.compile(args.grep) if args.grep else None

    def show(message) -> None:
        node = message.get("node_id", "")
        if args.node and not node.startswith(args.node):
            return
        for rec in message.get("records", []):
            if args.pid and rec.get("pid") != args.pid:
                continue
            stream = sys.stderr if rec.get("is_err") else sys.stdout
            for line in rec.get("lines", []):
                if pattern is not None and not pattern.search(line):
                    continue
                print(f"(pid={rec['pid']}, node={node}) {line}",
                      file=stream, flush=True)

    w.set_log_hook(show)
    # idempotent when the driver already auto-subscribed (log_to_driver)
    w.gcs_call("subscribe", {"channel": "worker_logs"})
    print("tailing worker logs (ctrl-c to exit)", file=sys.stderr)
    deadline = time.time() + args.duration if args.duration else None
    try:
        while deadline is None or time.time() < deadline:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass


def cmd_metrics_export_config(args) -> None:
    raise not_ported("metrics export-config (util/metrics_config.py)",
                     "queue 1, item 7.7")


def cmd_up(args) -> None:
    from ray_tpu_torch.autoscaler import launcher
    launcher.up(args.cluster_config)


def cmd_down(args) -> None:
    from ray_tpu_torch.autoscaler import launcher
    launcher.down(args.cluster_config)


# ----------------------------------------------------------------------
def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m ray_tpu_torch.scripts.cli",
        description="ray_tpu_torch's distributed runtime CLI")
    sub = p.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("start", help="start a head or worker node")
    sp.add_argument("--head", action="store_true")
    sp.add_argument("--ray-client-server-port", type=int, default=None,
                    help="also start a ray:// client server on this port")
    sp.add_argument("--address", help="GCS address to join (worker mode)")
    sp.add_argument("--num-cpus", type=float)
    sp.add_argument("--num-gpus", type=float)
    sp.add_argument("--resources", help="extra resources as JSON")
    sp.set_defaults(fn=cmd_start)

    sp = sub.add_parser("stop", help="stop the recorded head node")
    sp.set_defaults(fn=cmd_stop)

    sp = sub.add_parser(
        "stack", help="all-thread stack dumps from every worker")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_stack)

    sp = sub.add_parser(
        "profile",
        help="sample the whole cluster for a window and emit a merged "
             "flamegraph (collapsed + speedscope)")
    sp.add_argument("--duration", "-d", type=float, default=10.0,
                    help="sampling window in seconds (default 10)")
    sp.add_argument("--hz", type=float, default=None,
                    help="samples/s per process (default: profiler_hz)")
    sp.add_argument("--job", default=None,
                    help="only samples attributed to this job (hex)")
    sp.add_argument("--node", default=None,
                    help="only samples from this node (hex prefix)")
    sp.add_argument("--output", "-o", default="profile",
                    help="output path prefix (default ./profile)")
    sp.add_argument("--top", type=int, default=10,
                    help="top stacks to print (default 10)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_profile)

    sp = sub.add_parser(
        "analyze",
        help="job critical path + per-phase time attribution")
    sp.add_argument("job", nargs="?", default="latest",
                    help="job id hex (default: most recent job)")
    sp.add_argument("--json", action="store_true",
                    help="emit the raw analysis dict as JSON")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_analyze)

    sp = sub.add_parser(
        "trace",
        help="render a distributed request trace (or list retained "
             "traces / SLO misses)")
    sp.add_argument("trace_id", nargs="?", default=None,
                    help="trace id (prefix ok); omit to list traces")
    sp.add_argument("--slo-misses", default=None, metavar="DEPLOYMENT",
                    help="list retained SLO-missing/error traces of "
                         "this deployment")
    sp.add_argument("--deployment", default=None,
                    help="filter the trace list by deployment")
    sp.add_argument("--limit", type=int, default=50)
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_trace)

    sp = sub.add_parser(
        "incidents",
        help="the cluster incident journal (deaths, firing alerts)")
    sp.add_argument("incident_id", nargs="?", default=None,
                    help="incident id (prefix ok); omit to list")
    sp.add_argument("--kind", choices=["death", "alert"], default=None)
    sp.add_argument("--limit", type=int, default=50)
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_incidents)

    sp = sub.add_parser(
        "postmortem",
        help="full report on one incident: flight tails, trace trees, "
             "alert timeline, series sparklines")
    sp.add_argument("incident_id", nargs="?", default=None,
                    help="incident id (prefix ok; default: newest)")
    sp.add_argument("--last", action="store_true",
                    help="the newest incident (explicit spelling of "
                         "the default)")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_postmortem)

    sp = sub.add_parser(
        "debug-bundle",
        help="portable postmortem tar (incident + linked-plane "
             "snapshots + manifest)")
    sp.add_argument("incident_id", nargs="?", default=None,
                    help="incident to bundle (default: newest)")
    sp.add_argument("--window", type=float, default=None, metavar="S",
                    help="bundle the last S seconds instead of an "
                         "incident")
    sp.add_argument("--output", "-o", default=None,
                    help="output path (default "
                         "./debug-bundle-<id>.tar.gz)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_debug_bundle)

    sp = sub.add_parser(
        "logs", help="tail worker logs cluster-wide")
    sp.add_argument("--node", default=None,
                    help="only this node (hex prefix)")
    sp.add_argument("--pid", type=int, default=None,
                    help="only this worker pid")
    sp.add_argument("--grep", default=None,
                    help="only lines matching this regex")
    sp.add_argument("--duration", type=float, default=None,
                    help="stop after N seconds (default: until ctrl-c)")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_logs)

    sp = sub.add_parser(
        "metrics", help="metrics tooling")
    msub = sp.add_subparsers(dest="metrics_cmd", required=True)
    m = msub.add_parser("export-config",
                        help="write prometheus.yml + grafana "
                             "provisioning configs")
    m.add_argument("--output-dir", default="./ray_tpu_metrics")
    m.add_argument("--dashboard-address", default=None)
    m.set_defaults(fn=cmd_metrics_export_config)

    sp = sub.add_parser(
        "up", help="bring up a cluster from a YAML cluster config")
    sp.add_argument("cluster_config")
    sp.set_defaults(fn=cmd_up)

    sp = sub.add_parser(
        "down", help="tear down a cluster started with `up`")
    sp.add_argument("cluster_config")
    sp.set_defaults(fn=cmd_down)

    sp = sub.add_parser("status", help="cluster resource summary")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_status)

    sp = sub.add_parser(
        "top", help="live cluster view: per-node gauges + "
                    "history-derived rates with sparklines")
    sp.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds (default 2)")
    sp.add_argument("--once", action="store_true",
                    help="print one frame and exit (for scripts)")
    sp.add_argument("--jobs", action="store_true",
                    help="add the per-job attribution table")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_top)

    sp = sub.add_parser(
        "alerts", help="firing + recently-resolved alerts")
    sp.add_argument("--limit", type=int, default=10,
                    help="recently-resolved rows to show (default 10)")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_alerts)

    sp = sub.add_parser(
        "nodes", help="node lifecycle states (ACTIVE/DRAINING/DRAINED)"
                      " + last autoscaler decision")
    sp.add_argument("--json", action="store_true")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_nodes)

    sp = sub.add_parser("list", help="list cluster state")
    sp.add_argument("resource", choices=[
        "tasks", "actors", "nodes", "workers", "objects",
        "placement-groups", "jobs", "cluster-events"])
    sp.add_argument("--limit", type=int, default=100)
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_list)

    sp = sub.add_parser("events", help="structured cluster events")
    sp.add_argument("--limit", type=int, default=200)
    sp.add_argument("--severity", default=None,
                    choices=[None, "DEBUG", "INFO", "WARNING", "ERROR",
                             "FATAL"])
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_events)

    sp = sub.add_parser("summary", help="task summary by function/state")
    sp.add_argument("resource", choices=["tasks"])
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_summary)

    sp = sub.add_parser("timeline", help="export chrome trace")
    sp.add_argument("--output", "-o", default="timeline.json")
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_timeline)

    sp = sub.add_parser("memory", help="object store usage")
    sp.add_argument("--limit", type=int, default=20)
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_memory)

    sp = sub.add_parser("dashboard", help="serve the JSON dashboard")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8265)
    sp.add_argument("--address")
    sp.set_defaults(fn=cmd_dashboard)

    sp = sub.add_parser("job", help="job submission")
    jsub = sp.add_subparsers(dest="job_cmd", required=True)
    j = jsub.add_parser("submit")
    j.add_argument("entrypoint", nargs=argparse.REMAINDER)
    j.add_argument("--wait", action="store_true")
    for name in ("status", "logs", "stop"):
        j = jsub.add_parser(name)
        j.add_argument("submission_id")
    jsub.add_parser("list")
    sp.add_argument("--dashboard-address",
                    default=os.environ.get("RAY_TPU_TORCH_DASHBOARD",
                                           "http://127.0.0.1:8265"))
    sp.set_defaults(fn=cmd_job)

    sp = sub.add_parser("serve", help="serve application control")
    ssub = sp.add_subparsers(dest="serve_cmd", required=True)
    for name in ("status", "shutdown"):
        child = ssub.add_parser(name)
        child.add_argument("--address")
    child = ssub.add_parser("deploy", help="deploy a serve config yaml")
    child.add_argument("config_file")
    child.add_argument("--address")
    sp.set_defaults(fn=cmd_serve)

    sp = sub.add_parser("microbenchmark", help="core perf suite")
    sp.set_defaults(fn=cmd_microbenchmark)

    sp = sub.add_parser("debug",
                        help="attach to a remote pdb breakpoint")
    sp.add_argument("--address")
    sp.add_argument("--id", help="breakpoint id (default: newest)")
    sp.set_defaults(fn=cmd_debug)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
