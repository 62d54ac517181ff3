"""Cluster-level job lifecycle.

Parity: reference ``dashboard/modules/job/job_manager.py``
(``JobManager``:431, ``JobSupervisor``:133) — an entrypoint shell
command runs as a subprocess of a detached supervisor actor; status and
logs live in the GCS KV, so any client (REST, SDK, CLI) can query them
without touching the supervisor.

The entrypoint inherits the supervisor worker's environment, which
holds no GPU lease: a job that wants the card asks for it in its tasks
or actors (``num_gpus=1``), whose workers the raylet gives their GPU.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
import uuid
from typing import Any, Dict, List, Optional

import ray_tpu_torch

JOB_KV_NS = "job"

# terminal states (reference JobStatus)
PENDING = "PENDING"
RUNNING = "RUNNING"
SUCCEEDED = "SUCCEEDED"
FAILED = "FAILED"
STOPPED = "STOPPED"
TERMINAL = (SUCCEEDED, FAILED, STOPPED)


def _kv():
    from ray_tpu_torch.core import worker as worker_mod
    return worker_mod.global_worker()


def _put_info(submission_id: str, info: Dict[str, Any]) -> None:
    _kv().kv_put(f"info:{submission_id}", json.dumps(info).encode(),
                 namespace=JOB_KV_NS)


def _get_info(submission_id: str) -> Optional[Dict[str, Any]]:
    blob = _kv().kv_get(f"info:{submission_id}", namespace=JOB_KV_NS)
    return json.loads(blob) if blob else None


class JobSupervisor:
    """Detached actor owning one job's subprocess (reference :133)."""

    def __init__(self, submission_id: str, entrypoint: str,
                 metadata: Dict[str, str], env_vars: Dict[str, str],
                 log_path: str):
        self.submission_id = submission_id
        self.entrypoint = entrypoint
        self.log_path = log_path
        self.proc: Optional[subprocess.Popen] = None
        self._stopped = False
        env = dict(os.environ)
        env.update(env_vars or {})
        # the job driver must find this framework regardless of its cwd
        pkg_root = os.path.dirname(os.path.dirname(
            os.path.abspath(ray_tpu_torch.__file__)))
        env["PYTHONPATH"] = pkg_root + os.pathsep + env.get("PYTHONPATH", "")
        # the job driver joins this cluster, not a new one
        info = ray_tpu_torch.connection_info()
        gcs = info.get("gcs_address")
        if gcs:
            env["RAY_TPU_TORCH_ADDRESS"] = f"{gcs[0]}:{gcs[1]}"
        os.makedirs(os.path.dirname(log_path), exist_ok=True)
        self._log_f = open(log_path, "ab", buffering=0)
        self.proc = subprocess.Popen(
            entrypoint, shell=True, env=env,
            stdout=self._log_f, stderr=subprocess.STDOUT,
            start_new_session=True)
        info_rec = _get_info(submission_id) or {}
        info_rec.update(status=RUNNING, start_time=time.time())
        _put_info(submission_id, info_rec)

    def wait(self) -> str:
        """Block until the entrypoint exits; record the terminal state."""
        code = self.proc.wait()
        info = _get_info(self.submission_id) or {}
        if self._stopped:
            status = STOPPED
        else:
            status = SUCCEEDED if code == 0 else FAILED
        info.update(status=status, end_time=time.time(), exit_code=code)
        _put_info(self.submission_id, info)
        return status

    def stop(self) -> bool:
        self._stopped = True
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                self.proc.kill()
        return True

    def ping(self) -> bool:
        return True


class JobManager:
    """Driver-side job orchestration (reference ``JobManager``:431)."""

    def __init__(self, log_dir: Optional[str] = None):
        self.log_dir = log_dir or os.path.join(
            os.environ.get("TMPDIR", "/tmp"), "ray_tpu_torch_jobs")

    def submit_job(self, *, entrypoint: str,
                   submission_id: Optional[str] = None,
                   metadata: Optional[Dict[str, str]] = None,
                   runtime_env: Optional[Dict[str, Any]] = None
                   ) -> str:
        submission_id = submission_id or f"raysubmit_{uuid.uuid4().hex[:12]}"
        if _get_info(submission_id) is not None:
            raise ValueError(f"job {submission_id!r} already exists")
        log_path = os.path.join(self.log_dir, f"{submission_id}.log")
        _put_info(submission_id, {
            "submission_id": submission_id,
            "entrypoint": entrypoint,
            "status": PENDING,
            "metadata": metadata or {},
            "submit_time": time.time(),
            "log_path": log_path,
        })
        env_vars = dict((runtime_env or {}).get("env_vars", {}))
        Supervisor = ray_tpu_torch.remote(JobSupervisor)
        actor = Supervisor.options(
            name=f"_job_supervisor:{submission_id}",
            lifetime="detached").remote(
                submission_id, entrypoint, metadata or {}, env_vars,
                log_path)
        # fire-and-forget: wait() runs on the actor until the job exits
        actor.wait.remote()
        return submission_id

    def get_job_status(self, submission_id: str) -> Optional[str]:
        info = _get_info(submission_id)
        return info["status"] if info else None

    def get_job_info(self, submission_id: str) -> Optional[Dict[str, Any]]:
        return _get_info(submission_id)

    def get_job_logs(self, submission_id: str) -> str:
        info = _get_info(submission_id)
        if info is None:
            raise ValueError(f"no job {submission_id!r}")
        try:
            with open(info["log_path"], "rb") as f:
                return f.read().decode(errors="replace")
        except FileNotFoundError:
            return ""

    def stop_job(self, submission_id: str) -> bool:
        info = _get_info(submission_id)
        if info is None or info["status"] in TERMINAL:
            return False
        try:
            actor = ray_tpu_torch.get_actor(
                f"_job_supervisor:{submission_id}")
            return ray_tpu_torch.get(actor.stop.remote(), timeout=30)
        except ValueError:
            return False

    def list_jobs(self) -> List[Dict[str, Any]]:
        core = _kv()
        out = []
        for key in core.kv_keys(prefix="info:", namespace=JOB_KV_NS):
            blob = core.kv_get(key, namespace=JOB_KV_NS)
            if blob:
                out.append(json.loads(blob))
        return sorted(out, key=lambda j: j.get("submit_time", 0))
