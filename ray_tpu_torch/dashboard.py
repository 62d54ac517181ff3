"""Dashboard: JSON state endpoints + Prometheus metrics export.

Parity: reference ``dashboard/head.py:70`` (aiohttp server) and the
``dashboard/modules/{node,actor,job,metrics,...}`` REST surface — the
React client is an explicit non-goal (SURVEY.md §7); all state is served
as JSON, which the CLI and tests consume.  ``/metrics`` serves the
aggregated GCS metrics table in Prometheus text format (parity:
``metrics_agent.py:489`` service-discovery target).

Job-submission REST (``/api/jobs``) is mounted here too, mirroring the
reference where job endpoints live in the dashboard
(``dashboard/modules/job/job_head.py:145``).

The routes, status codes, JSON bodies and metric names (``ray_tpu_*``,
as the port's telemetry names them) are the JAX package's; the
dashboard serves from the driver's connection to a port cluster and
never touches a device.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
from typing import Any, Dict, Optional

from aiohttp import web

logger = logging.getLogger(__name__)


def _escape_label_value(value) -> str:
    """Prometheus text-format label escaping (exposition spec): backslash
    first, then quote and newline — unescaped values broke scrapes for
    any tag carrying a path, quote, or multi-line message."""
    return (str(value).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _escape_help(text: str) -> str:
    return str(text).replace("\\", "\\\\").replace("\n", "\\n")


def _prometheus_text(records, exemplars: bool = False) -> str:
    """Prometheus text exposition.  ``exemplars=True`` switches bucket
    lines to OpenMetrics exemplar syntax (``... # {trace_id="..."} v ts``)
    so a dashboard can jump from a hot latency bucket to the concrete
    trace — classic Prometheus parsers reject that syntax, so it is
    opt-in via ``/metrics?openmetrics=1``."""
    lines = []
    seen_help = set()
    for rec in records:
        name = rec["name"].replace(".", "_").replace("-", "_")
        if name not in seen_help:
            if rec.get("description"):
                lines.append(
                    f"# HELP {name} {_escape_help(rec['description'])}")
            lines.append(f"# TYPE {name} {rec['type']}")
            seen_help.add(name)
        tags = ",".join(f'{k}="{_escape_label_value(v)}"' for k, v in
                        sorted(rec.get("tags", {}).items()))
        label = f"{{{tags}}}" if tags else ""
        if rec["type"] == "histogram":
            cum = 0
            bounds = rec["boundaries"] + ["+Inf"]
            bucket_exemplars = rec.get("exemplars") or {}
            for idx, (count, bound) in enumerate(
                    zip(rec["buckets"], bounds)):
                cum += count
                btags = tags + ("," if tags else "") + f'le="{bound}"'
                line = f"{name}_bucket{{{btags}}} {cum}"
                ex = bucket_exemplars.get(idx) if exemplars else None
                if ex:
                    ex_tags = ",".join(
                        f'{k}="{_escape_label_value(v)}"'
                        for k, v in sorted(ex.items())
                        if k not in ("value", "ts"))
                    line += (f" # {{{ex_tags}}} {ex.get('value', 0)}"
                             f" {ex.get('ts', 0)}")
                lines.append(line)
            lines.append(f"{name}_sum{label} {rec['sum']}")
            lines.append(f"{name}_count{label} {rec['count']}")
        else:
            lines.append(f"{name}{label} {rec['value']}")
    return "\n".join(lines) + "\n"


class Dashboard:
    """JSON/Prometheus server over the driver's GCS connection."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8265):
        self.host = host
        self.port = port
        self._runner: Optional[web.AppRunner] = None
        self._thread: Optional[threading.Thread] = None
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._started = threading.Event()

    # -- request handlers (each runs gcs/raylet calls in a worker
    # thread so the serving loop never blocks) -------------------------
    async def _state(self, fn, *args):
        return await asyncio.get_running_loop().run_in_executor(
            None, fn, *args)

    def _json(self, data) -> web.Response:
        return web.json_response(json.loads(json.dumps(data, default=str)))

    async def handle_nodes(self, request):
        from ray_tpu_torch.experimental.state.api import list_nodes
        return self._json(await self._state(list_nodes))

    async def handle_actors(self, request):
        from ray_tpu_torch.experimental.state.api import list_actors
        return self._json(await self._state(list_actors))

    async def handle_tasks(self, request):
        from ray_tpu_torch.experimental.state.api import list_tasks
        return self._json(await self._state(list_tasks))

    async def handle_pgs(self, request):
        from ray_tpu_torch.experimental.state.api import list_placement_groups
        return self._json(await self._state(list_placement_groups))

    async def handle_cluster_status(self, request):
        from ray_tpu_torch.experimental.state.api import (available_resources,
                                                    cluster_resources,
                                                    object_store_stats)
        total = await self._state(cluster_resources)
        avail = await self._state(available_resources)
        stores = await self._state(object_store_stats)
        return self._json({"cluster_resources": total,
                           "available_resources": avail,
                           "object_store": stores})

    async def handle_serve(self, request):
        """Serve application status (parity: serve REST api/serve/
        applications — reference serve/schema.py status surface)."""
        def fetch():
            import ray_tpu_torch
            from ray_tpu_torch.serve._internal import CONTROLLER_NAME
            try:
                controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
            except Exception:
                return {}  # serve never started — a GET must not start it
            try:
                return ray_tpu_torch.get(
                    controller.list_deployments.remote(), timeout=30)
            except Exception:
                return {}
        return self._json(await self._state(fetch))

    async def handle_events(self, request):
        from ray_tpu_torch.experimental.state.api import list_cluster_events
        return self._json(await self._state(list_cluster_events))

    async def handle_node_stats(self, request):
        """Fan out to per-node dashboard agents (reference
        dashboard/agent.py pull model: the head queries agents on
        demand, so stats never ride the GCS hot path at fleet scale);
        nodes whose agent is unreachable fall back to the last
        health-beat snapshot."""
        from ray_tpu_torch.experimental.state.api import node_stats

        beat_rows = await self._state(node_stats)
        agents = await self._agent_addresses()
        if not agents:
            return self._json(beat_rows)

        import aiohttp

        async def fetch(sess, node_hex: str, addr: str):
            try:
                async with sess.get(
                        f"http://{addr}/api/local/stats") as resp:
                    return node_hex, await resp.json()
            except Exception:  # noqa: BLE001 — agent may be down
                return node_hex, None

        timeout = aiohttp.ClientTimeout(total=3.0)
        async with aiohttp.ClientSession(timeout=timeout) as sess:
            live = dict(await asyncio.gather(
                *(fetch(sess, n, a) for n, a in agents.items())))
        out = []
        for row in beat_rows:
            node_hex = row["node_id"].hex() \
                if isinstance(row["node_id"], bytes) else str(
                    row["node_id"])
            fresh = live.get(node_hex)
            if fresh:
                fresh["node_id"] = row["node_id"]
                fresh["state"] = row.get("state")
                fresh["source"] = "agent"
                out.append(fresh)
            else:
                row = dict(row)
                row["source"] = "health_beat"
                out.append(row)
        return self._json(out)

    async def _agent_addresses(self) -> Dict[str, str]:
        """Live agents only: each agent re-registers every 30s with a
        timestamp; entries older than 3 beats belong to dead nodes and
        would stall the fan-out on their connect timeout."""
        import time

        from ray_tpu_torch.core import worker as worker_mod

        def fetch():
            w = worker_mod.global_worker()
            keys = w.gcs_call("kv_keys", {
                "namespace": "_internal", "prefix": "dashboard_agent:"})
            out = {}
            now = time.time()
            for key in keys:
                val = w.gcs_call("kv_get", {
                    "namespace": "_internal", "key": key})
                if not val:
                    continue
                try:
                    entry = json.loads(val.decode())
                    if now - float(entry.get("ts", 0)) > 95.0:
                        continue  # stale: agent (or its node) is gone
                    out[key.split(":", 1)[1]] = entry["address"]
                except (ValueError, KeyError):
                    continue
            return out

        try:
            return await self._state(fetch)
        except Exception:  # noqa: BLE001 — agents are optional
            return {}

    async def handle_profile(self, request):
        """Merged continuous-profiling view from the GCS ring.  Query
        params: job, node, since (epoch s), format=json|collapsed|
        speedscope (speedscope output loads directly at
        https://speedscope.app)."""
        from ray_tpu_torch.core import profiler as profiler_mod
        from ray_tpu_torch.core import worker as worker_mod

        job = request.query.get("job")
        node = request.query.get("node")
        since = request.query.get("since")
        fmt = request.query.get("format", "json")

        def fetch():
            core = worker_mod.global_worker()
            return core.gcs_call("get_profile", {
                "job": job, "node": node,
                "since": float(since) if since else None})
        profile = await self._state(fetch)
        if fmt == "collapsed":
            return web.Response(
                text=profiler_mod.to_collapsed(profile["records"]),
                content_type="text/plain")
        if fmt == "speedscope":
            return self._json(profiler_mod.to_speedscope(
                profile["records"]))
        return self._json(profile)

    async def handle_analyze(self, request):
        """Job time-attribution analysis (?job=<hex>, default latest)."""
        from ray_tpu_torch.experimental.state import analyze as analyze_mod

        job = request.query.get("job")
        return self._json(await self._state(analyze_mod.analyze_job, job))

    async def handle_timeseries(self, request):
        """History-ring contents (``?series=<name|prefix*>``,
        ``?since=<epoch s>``, ``?limit=``) from the GCS metrics-history
        plane — counters serve per-tick deltas, gauges raw values,
        derived recording-rule signals their computed points."""
        from ray_tpu_torch.core import worker as worker_mod

        series = request.query.get("series")
        since = request.query.get("since")
        limit = request.query.get("limit")

        def fetch():
            core = worker_mod.global_worker()
            return core.gcs_call("get_timeseries", {
                "series": series,
                "since": float(since) if since else None,
                "limit": int(limit) if limit else None})
        return self._json(await self._state(fetch))

    async def handle_alerts(self, request):
        """Firing + recently-resolved alerts and the rule table."""
        from ray_tpu_torch.core import worker as worker_mod

        def fetch():
            core = worker_mod.global_worker()
            return core.gcs_call("get_alerts", {})
        return self._json(await self._state(fetch))

    async def handle_healthz(self, request):
        """Cluster verdict: 200 ok/degraded, 503 critical — wired for
        load-balancer / k8s probes."""
        from ray_tpu_torch.core import worker as worker_mod

        def fetch():
            core = worker_mod.global_worker()
            return core.gcs_call("healthz", {})
        try:
            verdict = await self._state(fetch)
        except Exception:  # noqa: BLE001 — GCS unreachable IS critical
            return web.json_response(
                {"ok": False, "status": "unreachable"}, status=503)
        return web.json_response(
            json.loads(json.dumps(verdict, default=str)),
            status=200 if verdict.get("ok") else 503)

    async def handle_metrics(self, request):
        from ray_tpu_torch.core import worker as worker_mod

        def fetch():
            core = worker_mod.global_worker()
            records = list(core.gcs_call("get_metrics", {}))
            # core cluster gauges alongside the user-defined metrics
            # (parity: the reference exports ray_* system metrics;
            # the generated Grafana dashboard panels query these)
            try:
                stats = core.gcs_call("get_cluster_stats", {})
                records.append({
                    "name": "ray_tpu_alive_nodes", "type": "gauge",
                    "description": "nodes alive in the GCS view",
                    "value": stats["alive_nodes"]})
                records.append({
                    "name": "ray_tpu_actors_alive", "type": "gauge",
                    "description": "actors in state ALIVE",
                    "value": stats["actors_alive"]})
                records.append({
                    "name": "ray_tpu_tasks_finished_total",
                    "type": "counter",
                    "description": "tasks finished (monotonic)",
                    "value": stats["tasks_finished_total"]})
                # ring-buffer drops export as the per-job
                # ray_tpu_task_events_dropped_total counter (GCS-side
                # producer) — no derived duplicate here
                store = core.raylet_call(core.raylet_address,
                                         "store_stats", {})
                records.append({
                    "name": "ray_tpu_object_store_used_bytes",
                    "type": "gauge",
                    "description": "head-node object store bytes used",
                    "value": store.get("used", 0)})
            except Exception:  # noqa: BLE001 — user metrics still serve
                logger.debug("core metric collection failed",
                             exc_info=True)
            return records
        records = await self._state(fetch)
        exemplars = request.query.get("openmetrics") in ("1", "true")
        return web.Response(text=_prometheus_text(records,
                                                  exemplars=exemplars),
                            content_type="text/plain")

    async def handle_traces(self, request):
        """Distributed traces from the GCS ring.  ``?trace_id=`` emits
        ONE trace's spans as Perfetto-compatible chrome-trace JSON;
        without it, a JSON list of retained trace summaries
        (``?deployment=``, ``?slo_misses=1``, ``?since=``/``?until=``
        epoch-seconds window, ``?limit=``)."""
        from ray_tpu_torch.core import worker as worker_mod
        from ray_tpu_torch.experimental.state import traces as traces_mod

        trace_id = request.query.get("trace_id")
        since = request.query.get("since")
        until = request.query.get("until")

        def fetch():
            core = worker_mod.global_worker()
            if trace_id:
                return core.gcs_call("get_trace", {"trace_id": trace_id})
            return core.gcs_call("list_traces", {
                "deployment": request.query.get("deployment"),
                "slo_misses": request.query.get("slo_misses")
                in ("1", "true"),
                "since": float(since) if since else None,
                "until": float(until) if until else None,
                "limit": int(request.query.get("limit", "100"))})
        result = await self._state(fetch)
        if trace_id:
            if result is None:
                return self._json({"error": "trace not found"})
            return self._json({
                "trace_id": result.get("trace_id"),
                "status": result.get("status"),
                "duration_s": result.get("duration_s"),
                "traceEvents": traces_mod.perfetto_events(
                    result.get("spans") or []),
            })
        return self._json(result)

    async def handle_incidents(self, request):
        """The incident journal.  ``?incident_id=`` returns one full
        record (flight tails included); without it, newest-first
        summaries (``?kind=death|alert``, ``?limit=``)."""
        from ray_tpu_torch.core import worker as worker_mod

        incident_id = request.query.get("incident_id")

        def fetch():
            core = worker_mod.global_worker()
            if incident_id:
                return core.gcs_call("get_incident",
                                     {"incident_id": incident_id})
            return core.gcs_call("list_incidents", {
                "kind": request.query.get("kind"),
                "limit": int(request.query.get("limit", "50"))})
        result = await self._state(fetch)
        if incident_id and result is None:
            return self._json({"error": "incident not found"})
        return self._json(result)

    # -- lifecycle ------------------------------------------------------
    def _make_app(self) -> web.Application:
        app = web.Application()
        app.router.add_get("/api/nodes", self.handle_nodes)
        app.router.add_get("/api/actors", self.handle_actors)
        app.router.add_get("/api/tasks", self.handle_tasks)
        app.router.add_get("/api/placement_groups", self.handle_pgs)
        app.router.add_get("/api/cluster_status", self.handle_cluster_status)
        app.router.add_get("/api/serve/applications", self.handle_serve)
        app.router.add_get("/api/events", self.handle_events)
        app.router.add_get("/api/node_stats", self.handle_node_stats)
        app.router.add_get("/api/profile", self.handle_profile)
        app.router.add_get("/profile", self.handle_profile)
        app.router.add_get("/api/analyze", self.handle_analyze)
        app.router.add_get("/api/traces", self.handle_traces)
        app.router.add_get("/api/incidents", self.handle_incidents)
        app.router.add_get("/api/timeseries", self.handle_timeseries)
        app.router.add_get("/api/alerts", self.handle_alerts)
        app.router.add_get("/healthz", self.handle_healthz)
        app.router.add_get("/metrics", self.handle_metrics)
        try:
            from ray_tpu_torch.job.job_head import add_job_routes
            add_job_routes(app)
        except ImportError:
            pass
        return app

    def start(self) -> str:
        def run():
            self._loop = asyncio.new_event_loop()
            asyncio.set_event_loop(self._loop)

            async def serve():
                self._runner = web.AppRunner(self._make_app())
                await self._runner.setup()
                site = web.TCPSite(self._runner, self.host, self.port)
                await site.start()
                if self.port == 0:
                    self.port = self._runner.addresses[0][1]
                self._started.set()

            self._loop.run_until_complete(serve())
            self._loop.run_forever()

        self._thread = threading.Thread(target=run, name="dashboard",
                                        daemon=True)
        self._thread.start()
        if not self._started.wait(timeout=10):
            raise RuntimeError("dashboard failed to start")
        return f"http://{self.host}:{self.port}"

    def stop(self) -> None:
        if self._loop is not None:
            async def shutdown():
                if self._runner is not None:
                    await self._runner.cleanup()
                self._loop.stop()
            asyncio.run_coroutine_threadsafe(shutdown(), self._loop)
            if self._thread is not None:
                self._thread.join(timeout=5)
