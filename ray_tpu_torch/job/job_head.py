"""Job-submission REST endpoints, mounted on the dashboard.

Parity: reference ``dashboard/modules/job/job_head.py:145`` — POST
/api/jobs/ submits, GET /api/jobs/ lists, GET /api/jobs/{id} status,
GET /api/jobs/{id}/logs, POST /api/jobs/{id}/stop.
"""

from __future__ import annotations

import asyncio
from typing import Any, Dict

from aiohttp import web

from ray_tpu_torch.job.job_manager import JobManager

_manager = JobManager()


async def _call(fn, *args, **kwargs):
    return await asyncio.get_running_loop().run_in_executor(
        None, lambda: fn(*args, **kwargs))


async def submit(request: web.Request) -> web.Response:
    body: Dict[str, Any] = await request.json()
    if "entrypoint" not in body:
        return web.json_response({"error": "entrypoint required"},
                                 status=400)
    try:
        sid = await _call(_manager.submit_job,
                          entrypoint=body["entrypoint"],
                          submission_id=body.get("submission_id"),
                          metadata=body.get("metadata"),
                          runtime_env=body.get("runtime_env"))
    except ValueError as e:
        return web.json_response({"error": str(e)}, status=400)
    return web.json_response({"submission_id": sid})


async def list_jobs(request: web.Request) -> web.Response:
    return web.json_response(await _call(_manager.list_jobs))


async def status(request: web.Request) -> web.Response:
    info = await _call(_manager.get_job_info,
                       request.match_info["submission_id"])
    if info is None:
        return web.json_response({"error": "not found"}, status=404)
    return web.json_response(info)


async def logs(request: web.Request) -> web.Response:
    try:
        text = await _call(_manager.get_job_logs,
                           request.match_info["submission_id"])
    except ValueError as e:
        return web.json_response({"error": str(e)}, status=404)
    return web.json_response({"logs": text})


async def stop(request: web.Request) -> web.Response:
    ok = await _call(_manager.stop_job,
                     request.match_info["submission_id"])
    return web.json_response({"stopped": bool(ok)})


def add_job_routes(app: web.Application) -> None:
    app.router.add_post("/api/jobs/", submit)
    app.router.add_get("/api/jobs/", list_jobs)
    app.router.add_get("/api/jobs/{submission_id}", status)
    app.router.add_get("/api/jobs/{submission_id}/logs", logs)
    app.router.add_post("/api/jobs/{submission_id}/stop", stop)
