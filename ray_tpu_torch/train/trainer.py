"""TorchTrainer: the Train entry point.

Parity: reference ``train/data_parallel_trainer.py`` (``DataParallelTrainer``)
+ ``base_trainer.py`` (``fit`` contract) + ``train/torch/torch_trainer.py``:
the trainer gangs one actor per worker (each holding
``ScalingConfig.gpus_per_worker`` GPUs), runs the torch backend on it (the
leased GPU as each worker's device; a process group when the gang has
more than one worker), and the user's ``train_loop_per_worker`` runs the
same code on every worker.  It is the counterpart of the JAX package's
``JaxTrainer`` (its accelerator path, where a jax runtime took the place
of the process group) and covers that package's gloo ``TorchTrainer``
too.

Fault tolerance (reference ``FailureConfig`` semantics): a worker/actor
failure tears down the gang and restarts it from the latest streamed
checkpoint, up to ``max_failures`` times.
"""

from __future__ import annotations

import logging
import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.core.exceptions import RayTpuError
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager
from ray_tpu_torch.train.config import (
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.worker_group import WorkerGroup

logger = logging.getLogger(__name__)


@dataclass
class Result:
    metrics: Dict[str, Any] = field(default_factory=dict)
    checkpoint: Optional[Checkpoint] = None
    error: Optional[str] = None
    metrics_history: List[Dict[str, Any]] = field(default_factory=list)

    @property
    def best_checkpoint(self) -> Optional[Checkpoint]:
        return self.checkpoint


class TorchTrainer:
    #: which runtime setup_backend installs on the gang
    _backend = "torch"

    def __init__(self, train_loop_per_worker: Callable[[Dict[str, Any]], None],
                 *, train_loop_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        self._fn = train_loop_per_worker
        self._config = dict(train_loop_config or {})
        self.scaling_config = scaling_config or ScalingConfig()
        self.run_config = run_config or RunConfig()
        self.datasets = datasets or {}
        self._resume_checkpoint = resume_from_checkpoint

    # ------------------------------------------------------------------
    @staticmethod
    def _list_checkpoints(path: str):
        """(backend, backend_path, well-formed checkpoint names) — residue
        from interrupted atomic swaps (``.tmp``/``.old``) is excluded."""
        from ray_tpu_torch.air import storage
        backend, spath = storage.get_storage(path)
        names = [n for n in backend.listdir(spath)
                 if CheckpointManager.checkpoint_index(n) is not None]
        return backend, spath, names

    @classmethod
    def can_restore(cls, path: str) -> bool:
        return bool(cls._list_checkpoints(path)[2])

    @classmethod
    def restore(cls, path: str,
                train_loop_per_worker: Callable[[Dict[str, Any]], None],
                **kwargs) -> "TorchTrainer":
        """Resume a run from its (possibly remote) checkpoint root.

        Parity: reference ``BaseTrainer.restore(path)`` — download the
        latest synced checkpoint and construct a trainer that resumes
        from it; new checkpoints continue landing at the same URI.
        """
        import dataclasses

        backend, spath, names = cls._list_checkpoints(path)
        if not names:
            raise ValueError(f"no checkpoints found under {path!r}")
        local = tempfile.mkdtemp(prefix="rtpu_train_restore_")
        backend.download_dir(f"{spath.rstrip('/')}/{max(names)}", local)
        # dict-backed so the resume checkpoint pickles to gang workers on
        # other hosts (a dir-backed object ships only a local path)
        resume = Checkpoint.from_dict(
            Checkpoint.from_directory(local).to_dict())
        run_config = kwargs.pop("run_config", None) or RunConfig()
        # copy — silently rewriting a caller-shared config's storage_path
        # would redirect their OTHER trainers' checkpoints here
        run_config = dataclasses.replace(run_config, storage_path=path)
        return cls(train_loop_per_worker, run_config=run_config,
                   resume_from_checkpoint=resume,
                   **kwargs)

    # ------------------------------------------------------------------
    def fit(self) -> Result:
        storage_path = self.run_config.storage_path
        default_dir = os.path.join(
            tempfile.gettempdir(), "ray_tpu_torch_train",
            self.run_config.name or f"run_{int(time.time())}")
        if storage_path and "://" in storage_path:
            # URI-addressed durable storage: checkpoints stage locally and
            # mirror to the URI (a plain path keeps the old local-dir
            # behavior — it may itself be a shared filesystem)
            storage_uri: Optional[str] = storage_path
            ckpt_dir = default_dir
        else:
            storage_uri = None
            ckpt_dir = storage_path or default_dir
        manager = CheckpointManager(ckpt_dir,
                                    self.run_config.checkpoint_config,
                                    storage_uri=storage_uri)
        failures_allowed = self.run_config.failure_config.max_failures
        attempt = 0
        resume = self._resume_checkpoint
        history: List[Dict[str, Any]] = []
        while True:
            try:
                result = self._run_attempt(manager, resume, history)
                result.metrics_history = history
                return result
            except _GangFailure as failure:
                attempt += 1
                if failures_allowed != -1 and attempt > failures_allowed:
                    return Result(
                        metrics=history[-1] if history else {},
                        checkpoint=manager.latest_checkpoint(),
                        error=str(failure),
                        metrics_history=history)
                logger.warning(
                    "training gang failed (attempt %d/%s): %s — restarting "
                    "from latest checkpoint", attempt,
                    failures_allowed if failures_allowed != -1 else "inf",
                    failure)
                resume = manager.latest_checkpoint() or \
                    self._resume_checkpoint

    def _run_attempt(self, manager: CheckpointManager,
                     resume: Optional[Checkpoint],
                     history: List[Dict[str, Any]]) -> Result:
        group = WorkerGroup(self.scaling_config)
        try:
            group.start()
            group.setup_backend(self._backend)
            shards = self._shard_datasets()
            try:
                group.run(self._fn, self._config, shards, resume)
            except RayTpuError as e:
                # a loop that kills its worker before run's reply arrives
                # is a gang failure too (the JAX package lets it escape)
                raise _GangFailure(f"worker run failed: {e}") from e
            last_metrics: Dict[str, Any] = {}
            while True:
                try:
                    polls = group.poll(timeout=1.0)
                except RayTpuError as e:
                    raise _GangFailure(f"worker poll failed: {e}") from e
                round_metrics: List[Dict[str, Any]] = []
                for poll in polls:
                    if poll["error"]:
                        raise _TrainLoopError(poll["error"])
                    for item in poll["results"]:
                        round_metrics.append(item)
                        if item["checkpoint"] is not None and \
                                item["rank"] == 0:
                            manager.register(item["checkpoint"],
                                             item["metrics"])
                for item in round_metrics:
                    if item["rank"] == 0:
                        last_metrics = item["metrics"]
                        history.append(last_metrics)
                if all(p["finished"] for p in polls):
                    break
            return Result(metrics=last_metrics,
                          checkpoint=manager.latest_checkpoint())
        except _TrainLoopError as e:
            # deterministic user-code error: do not retry
            return Result(metrics={}, checkpoint=manager.latest_checkpoint(),
                          error=str(e))
        finally:
            group.shutdown()

    def _shard_datasets(self) -> Optional[List[Any]]:
        """Per-rank dataset shards.  ray_tpu_torch Datasets shard through
        ``streaming_split`` when streaming ingest is on (DataContext.
        streaming_train_ingest): each rank gets a picklable StreamShard
        whose read/map tasks are submitted BY that rank as it iterates
        — blocks are produced node-local to their consumer, admission
        is bounded by the streaming budget, and the shard's prefetch
        thread assembles the next batch while the step runs (docs/
        data.md).  Off (default), the old materialize-then-split path."""
        if not self.datasets:
            return None
        n = self.scaling_config.num_workers
        try:
            from ray_tpu_torch.data.context import DataContext
            streaming_ingest = bool(
                DataContext.get_current().streaming_train_ingest)
        except Exception:  # noqa: BLE001 — data layer absent/stubbed
            streaming_ingest = False
        shards: List[Dict[str, Any]] = [dict() for _ in range(n)]
        for name, dataset in self.datasets.items():
            if streaming_ingest and callable(
                    getattr(dataset, "streaming_split", None)):
                parts = dataset.streaming_split(n)
            elif hasattr(dataset, "shard"):  # huggingface datasets API
                parts = [dataset.shard(num_shards=n, index=i)
                         for i in range(n)]
            elif callable(getattr(dataset, "split", None)):
                parts = dataset.split(n)
            else:
                parts = [dataset] * n
            for i in range(n):
                shards[i][name] = parts[i]
        return shards


class _GangFailure(RuntimeError):
    pass


class _TrainLoopError(RuntimeError):
    pass


class TensorflowTrainer(TorchTrainer):
    """Data-parallel TensorFlow training over gang actors.

    Parity: reference ``train/tensorflow/tensorflow_trainer.py`` —
    ``setup_backend`` writes TF_CONFIG across the gang so the user loop
    can build ``tf.distribute.MultiWorkerMirroredStrategy()``; same
    fit/report contract as :class:`TorchTrainer`.
    """

    _backend = "tensorflow"
