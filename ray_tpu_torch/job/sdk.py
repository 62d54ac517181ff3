"""Job submission SDK.

Parity: reference ``dashboard/modules/job/sdk.py``
(``JobSubmissionClient``:40) — a thin HTTP client over the dashboard's
job REST endpoints.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Any, Dict, List, Optional

from ray_tpu_torch.job.job_manager import TERMINAL


class JobSubmissionClient:
    def __init__(self, address: str = "http://127.0.0.1:8265"):
        self.address = address.rstrip("/")

    def _request(self, method: str, path: str,
                 body: Optional[Dict[str, Any]] = None):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(
            self.address + path, data=data, method=method,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=60) as resp:
                return json.loads(resp.read())
        except urllib.error.HTTPError as e:
            detail = e.read().decode(errors="replace")
            raise RuntimeError(f"{method} {path} -> {e.code}: {detail}")

    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None,
                   runtime_env: Optional[Dict[str, Any]] = None) -> str:
        reply = self._request("POST", "/api/jobs/", {
            "entrypoint": entrypoint, "submission_id": submission_id,
            "metadata": metadata, "runtime_env": runtime_env})
        return reply["submission_id"]

    def get_job_status(self, submission_id: str) -> str:
        return self._request("GET", f"/api/jobs/{submission_id}")["status"]

    def get_job_info(self, submission_id: str) -> Dict[str, Any]:
        return self._request("GET", f"/api/jobs/{submission_id}")

    def get_job_logs(self, submission_id: str) -> str:
        return self._request("GET",
                             f"/api/jobs/{submission_id}/logs")["logs"]

    def stop_job(self, submission_id: str) -> bool:
        return self._request("POST",
                             f"/api/jobs/{submission_id}/stop")["stopped"]

    def list_jobs(self) -> List[Dict[str, Any]]:
        return self._request("GET", "/api/jobs/")

    def wait_until_finished(self, submission_id: str,
                            timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.get_job_status(submission_id)
            if status in TERMINAL:
                return status
            time.sleep(0.5)
        raise TimeoutError(f"job {submission_id} still running after "
                           f"{timeout}s")
