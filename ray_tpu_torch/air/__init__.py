"""AIR-style shared vocabulary: configs, checkpoints, session, results.

Parity: reference ``python/ray/air/`` — the common layer Train/Tune/
Serve share (``air/config.py``, ``air/checkpoint.py``, ``air/session.py``,
``air/result.py``).  The concrete implementations live with Train (as
in the reference, where AIR grew out of Train); this package is the
stable import surface.  ``air.storage`` is the URI storage the raylet
spills objects to and checkpoints mirror to.
"""

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ray_tpu_torch.train.checkpoint import Checkpoint  # noqa: F401
from ray_tpu_torch.train.config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)


@dataclass
class Result:
    """Terminal state of a run (reference ``air/result.py``)."""

    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[BaseException] = None
    path: Optional[str] = None

    @property
    def config(self) -> Optional[Dict[str, Any]]:
        return self.metrics.get("config")


class session:
    """Function-style session facade (reference ``air/session.py``):
    ``air.session.report(...)`` inside a training loop."""

    @staticmethod
    def report(metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        from ray_tpu_torch.train.session import report as _report
        _report(metrics, checkpoint=checkpoint)

    @staticmethod
    def get_world_rank() -> int:
        from ray_tpu_torch.train.session import get_world_rank
        return get_world_rank()

    @staticmethod
    def get_world_size() -> int:
        from ray_tpu_torch.train.session import get_world_size
        return get_world_size()

    @staticmethod
    def get_local_rank() -> int:
        from ray_tpu_torch.train.session import get_local_rank
        return get_local_rank()

    @staticmethod
    def get_dataset_shard(name: str = "train"):
        from ray_tpu_torch.train.session import get_dataset_shard
        return get_dataset_shard(name)
