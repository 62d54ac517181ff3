"""Trainer configuration dataclasses.

Parity: reference ``python/ray/air/config.py`` — ``ScalingConfig``
(:79), ``FailureConfig`` (:454), ``CheckpointConfig`` (:513),
``RunConfig`` (:641).  Workers are processes, each holding
``gpus_per_worker`` GPUs (the JAX package's ``tpus_per_worker`` chips;
that keyword raises a ``TypeError`` here), and the intra-program
parallelism is a :class:`ray_tpu_torch.parallel.MeshConfig`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from ray_tpu_torch import _port
from ray_tpu_torch.parallel.mesh import MeshConfig


@dataclass(init=False)
class ScalingConfig:
    #: number of training worker processes
    num_workers: int = 1
    #: GPUs claimed by each worker (0 = CPU-only training/testing)
    gpus_per_worker: float = 0
    cpus_per_worker: float = 1
    #: extra custom resources per worker
    resources_per_worker: Dict[str, float] = field(default_factory=dict)
    #: gang placement strategy over nodes
    placement_strategy: str = "PACK"
    #: intra-program parallelism over the global device mesh
    mesh: Optional[MeshConfig] = None

    def __init__(self, num_workers: int = 1, gpus_per_worker: float = 0,
                 cpus_per_worker: float = 1,
                 resources_per_worker: Optional[Dict[str, float]] = None,
                 placement_strategy: str = "PACK",
                 mesh: Optional[MeshConfig] = None, **others: Any):
        _port.reject_tpu_options("ScalingConfig", others)
        if others:
            raise TypeError(f"ScalingConfig: unexpected keyword arguments "
                            f"{sorted(others)}")
        self.num_workers = num_workers
        self.gpus_per_worker = gpus_per_worker
        self.cpus_per_worker = cpus_per_worker
        self.resources_per_worker = dict(resources_per_worker or {})
        self.placement_strategy = placement_strategy
        self.mesh = mesh

    def worker_resources(self) -> Dict[str, float]:
        out = dict(self.resources_per_worker)
        out["CPU"] = float(self.cpus_per_worker)
        if self.gpus_per_worker:
            out["GPU"] = float(self.gpus_per_worker)
        return out


@dataclass
class FailureConfig:
    #: gang restarts allowed before giving up (-1 = unlimited)
    max_failures: int = 0


@dataclass
class CheckpointConfig:
    num_to_keep: Optional[int] = None
    checkpoint_score_attribute: Optional[str] = None
    checkpoint_score_order: str = "max"
    checkpoint_frequency: int = 0


@dataclass
class RunConfig:
    name: Optional[str] = None
    storage_path: Optional[str] = None
    failure_config: FailureConfig = field(default_factory=FailureConfig)
    checkpoint_config: CheckpointConfig = field(default_factory=CheckpointConfig)
    verbose: int = 1
    #: tune callbacks (loggers etc. — reference ``tune/callback.py``);
    #: None means the default CSV+JSON loggers when a local_dir exists
    callbacks: Optional[list] = None
    #: a Stopper / callable / dict of metric thresholds (reference
    #: ``tune/stopper/``) applied to every trial result
    stop: Optional[object] = None
    #: where logger callbacks write per-trial files (defaults to
    #: ~/ray_tpu_torch_results/<name>)
    local_dir: Optional[str] = None
    #: console progress reporting period (0 disables; reference
    #: ``tune/progress_reporter.py``)
    progress_report_s: float = 0.0
