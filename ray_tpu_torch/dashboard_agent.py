"""Per-node dashboard agent.

Parity: reference ``dashboard/agent.py:54`` (``DashboardAgent``) — one
lightweight process per node that serves node-local observability over
HTTP, so the head never has to aggregate per-process stats on the hot
path.  The head dashboard's ``/api/node_stats`` fans out to these
agents on demand (and falls back to the health-beat snapshot for nodes
whose agent is unreachable), which keeps the GCS beat payload small at
fleet scale.

Endpoints:
- ``GET /healthz``             — liveness
- ``GET /api/local/stats``     — node cpu/mem + per-worker cpu%/rss
  (workers discovered by their ``--session-dir`` cmdline argument, the
  same contract the reference agent uses to find its raylet's children)
- ``GET /api/local/logs?name=<file>&lines=<n>`` — tail a session log

The agent registers ``dashboard_agent:{node_id}`` -> ``host:port`` in
the GCS internal KV at startup; the head discovers agents by prefix
scan.

Every node spawns one (``python -m ray_tpu_torch.dashboard_agent``), so
the agent imports no torch: it would cost each node seconds at boot.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import logging
import os
from typing import Any, Dict

from aiohttp import web

logger = logging.getLogger(__name__)


class DashboardAgent:
    def __init__(self, session_dir: str, node_id_hex: str,
                 gcs_address: tuple, host: str = "127.0.0.1",
                 port: int = 0):
        self.session_dir = os.path.abspath(session_dir)
        self.node_id_hex = node_id_hex
        self.gcs_address = gcs_address
        self.host = host
        self.port = port
        self._gcs_conn = None

    # -- worker discovery ----------------------------------------------
    def _session_processes(self):
        """Processes of THIS session: their cmdline names our session
        dir (worker_main/node daemons take ``--session-dir``)."""
        import psutil

        out = []
        for proc in psutil.process_iter(["pid", "cmdline", "name"]):
            try:
                cmdline = proc.info["cmdline"] or []
                if any(self.session_dir == os.path.abspath(a)
                       for a in cmdline if isinstance(a, str)
                       and not a.startswith("-")):
                    out.append(proc)
            except (psutil.NoSuchProcess, psutil.AccessDenied):
                continue
        return out

    def collect_stats(self) -> Dict[str, Any]:
        try:
            import psutil
        except ImportError:
            return {"error": "psutil unavailable"}
        vm = psutil.virtual_memory()
        stats: Dict[str, Any] = {
            "node_id": self.node_id_hex,
            "cpu_percent": psutil.cpu_percent(interval=None),
            "mem_percent": vm.percent,
            "mem_used": int(vm.used),
            "mem_total": int(vm.total),
            "workers": [],
        }
        for proc in self._session_processes():
            try:
                with proc.oneshot():
                    cmd = proc.cmdline()
                    kind = "worker" if any(
                        "worker_main" in c for c in cmd) else (
                        "daemon" if any("ray_tpu_torch.core.node" in c
                                        for c in cmd) else "other")
                    stats["workers"].append({
                        "pid": proc.pid,
                        "kind": kind,
                        "cpu_percent": proc.cpu_percent(interval=None),
                        "rss": int(proc.memory_info().rss),
                    })
            except Exception:  # noqa: BLE001 — races with process exit
                continue
        return stats

    # -- http ----------------------------------------------------------
    async def handle_healthz(self, request):
        return web.json_response({"status": "ok",
                                  "node_id": self.node_id_hex})

    async def handle_stats(self, request):
        stats = await asyncio.get_running_loop().run_in_executor(
            None, self.collect_stats)
        return web.json_response(stats)

    async def handle_logs(self, request):
        name = request.query.get("name", "")
        lines = int(request.query.get("lines", "100"))
        # session logs only — no path escapes
        if "/" in name or ".." in name:
            return web.json_response({"error": "bad name"}, status=400)
        path = os.path.join(self.session_dir, "logs", name)
        if not name:
            logs_dir = os.path.join(self.session_dir, "logs")
            names = sorted(os.listdir(logs_dir)) \
                if os.path.isdir(logs_dir) else []
            return web.json_response({"logs": names})
        if not os.path.isfile(path):
            return web.json_response({"error": "no such log"}, status=404)

        def tail():
            with open(path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - 256 * 1024))
                data = f.read().decode(errors="replace")
            return data.splitlines()[-lines:]

        out = await asyncio.get_running_loop().run_in_executor(None, tail)
        return web.json_response({"lines": out})

    async def handle_stacks(self, request):
        """All-thread stack dumps from this node's workers (parity:
        the reference reporter module's py-spy stack dumps)."""
        from ray_tpu_torch.core import rpc

        if self._gcs_conn is None or self._gcs_conn.closed:
            self._gcs_conn = await rpc.connect(tuple(self.gcs_address))
        nodes = await self._gcs_conn.call("get_nodes", {})
        me = bytes.fromhex(self.node_id_hex)
        mine = next((n for n in nodes
                     if bytes(n["node_id"]) == me), None)
        if mine is None:
            return web.json_response({"error": "node not in GCS view"},
                                     status=404)
        conn = await rpc.connect(tuple(mine["address"]))
        try:
            dumps = await conn.call("stack_traces", {}, timeout=30)
        finally:
            conn.close()
        return web.json_response(dumps)

    # -- lifecycle -----------------------------------------------------
    async def start(self) -> tuple:
        app = web.Application()
        app.router.add_get("/healthz", self.handle_healthz)
        app.router.add_get("/api/local/stats", self.handle_stats)
        app.router.add_get("/api/local/logs", self.handle_logs)
        app.router.add_get("/api/local/stacks", self.handle_stacks)
        runner = web.AppRunner(app)
        await runner.setup()
        site = web.TCPSite(runner, self.host, self.port)
        await site.start()
        self.port = site._server.sockets[0].getsockname()[1]
        await self._register()
        logger.info("dashboard agent for node %s on %s:%d",
                    self.node_id_hex[:12], self.host, self.port)
        return (self.host, self.port)

    async def _register(self) -> None:
        """(Re-)publish address + liveness beat; the head drops agents
        whose beat goes stale.  Reuses one GCS connection, reconnecting
        only when the old one is gone (a per-beat reconnect would leak
        an fd every 30s)."""
        import time

        from ray_tpu_torch.core import rpc

        if self._gcs_conn is None or self._gcs_conn.closed:
            if self._gcs_conn is not None:
                try:
                    self._gcs_conn.close()
                except Exception:  # noqa: BLE001
                    pass
            self._gcs_conn = await rpc.connect(tuple(self.gcs_address))
        await self._gcs_conn.call("kv_put", {
            "namespace": "_internal",
            "key": f"dashboard_agent:{self.node_id_hex}",
            "value": json.dumps({
                "address": f"{self.host}:{self.port}",
                "ts": time.time(),
            }).encode(),
        }, timeout=10)

    async def run_forever(self) -> None:
        await self.start()
        # re-register periodically: the beat proves liveness (the head
        # ignores stale entries) and restores the entry after a GCS
        # restart
        while True:
            await asyncio.sleep(30.0)
            try:
                await self._register()
            except Exception:  # noqa: BLE001 — GCS may be restarting
                self._gcs_conn = None


def main() -> None:
    from ray_tpu_torch.core.node import maybe_arm_pdeathsig

    maybe_arm_pdeathsig()
    parser = argparse.ArgumentParser()
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--node-id", required=True)
    parser.add_argument("--gcs", required=True)
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=0)
    args = parser.parse_args()
    logging.basicConfig(
        level=os.environ.get("RAY_TPU_TORCH_LOG_LEVEL", "INFO"),
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    host, port = args.gcs.rsplit(":", 1)
    agent = DashboardAgent(args.session_dir, args.node_id,
                           (host, int(port)), host=args.host,
                           port=args.port)
    asyncio.run(agent.run_forever())


if __name__ == "__main__":
    main()
