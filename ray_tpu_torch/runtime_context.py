"""Runtime context introspection (parity: ``python/ray/runtime_context.py``)."""

from __future__ import annotations

from typing import Any, Dict, Optional

from ray_tpu_torch.core import worker as worker_mod


class RuntimeContext:
    @property
    def _core(self):
        return worker_mod.global_worker()

    def get_job_id(self) -> Optional[str]:
        return self._core.job_id.hex() if self._core.job_id else None

    def get_task_id(self) -> Optional[str]:
        task_id = self._core.current_task_id()
        return task_id.hex() if task_id else None

    def get_actor_id(self) -> Optional[str]:
        actor_id = self._core.current_actor_id()
        return actor_id.hex() if actor_id else None

    def get_node_id(self) -> str:
        return self._core.node_id.hex()

    def get_worker_id(self) -> str:
        return self._core.worker_id.hex()

    @property
    def was_current_actor_reconstructed(self) -> bool:
        return False

    def get(self) -> Dict[str, Any]:
        return {
            "job_id": self.get_job_id(),
            "task_id": self.get_task_id(),
            "actor_id": self.get_actor_id(),
            "node_id": self.get_node_id(),
            "worker_id": self.get_worker_id(),
        }


def get_runtime_context() -> RuntimeContext:
    return RuntimeContext()
