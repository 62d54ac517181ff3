"""Training worker gangs.

Parity: reference ``python/ray/train/_internal/worker_group.py`` (actor
gang) + ``backend_executor.py`` (backend lifecycle).  A
:class:`WorkerGroup` places N ``TrainWorker`` actors inside a placement
group (PACK by default) and runs the same function on every worker in
lockstep.

The torch backend is the reference's process-group bootstrap
(``train/torch/config.py:69-113``), where the JAX package ran
``jax.distributed.initialize``: a GPU worker first makes the GPU it
leased its current device; a gang of more than one then joins a process
group at rank 0's TCP store, ``"nccl"`` on GPU workers and ``"gloo"`` on
CPU workers; shutdown destroys the group.
"""

from __future__ import annotations

import logging
import os
import queue
import socket
import threading
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train import session as session_mod
from ray_tpu_torch.train.config import ScalingConfig
from ray_tpu_torch.util.placement_group import (
    PlacementGroup,
    placement_group,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import PlacementGroupSchedulingStrategy

logger = logging.getLogger(__name__)


class TrainWorker:
    """Actor hosting one training process."""

    def __init__(self, world_rank: int, world_size: int):
        self.world_rank = world_rank
        self.world_size = world_size
        self._thread: Optional[threading.Thread] = None
        self._session: Optional[session_mod._TrainSession] = None
        self._device: Optional[int] = None  # the leased GPU, once set up

    def hostname_and_port(self) -> tuple:
        """Reserve a coordinator port (called on rank 0 only)."""
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
        s.close()
        return (socket.gethostbyname(socket.gethostname()), port)

    def setup_torch(self, init_method: Optional[str], use_gpu: bool) -> bool:
        """The torch backend for this worker (parity: the reference's
        _setup_torch_process_group, train/torch/config.py:69-113).

        A GPU worker makes the GPU it leased its current device
        (``get_gpu_ids()``).  Lease ids index the GPUs this host sees,
        ``CUDA_VISIBLE_DEVICES`` included, and no worker's view is
        narrowed to its lease, so the id is the device.  The current device
        belongs to a thread: :meth:`run` sets it again on the loop's
        thread, so that every CUDA tensor the loop makes lands there.
        A gang of more than one joins a process group at rank 0's TCP
        store (``init_method``): ``"nccl"`` on GPU workers, ``"gloo"``
        on CPU workers.  A single CPU worker imports nothing."""
        if use_gpu:
            import torch

            ids = ray_tpu_torch.get_gpu_ids()
            if not ids:
                raise RuntimeError("a GPU train worker holds no GPU lease")
            self._device = int(ids[0])
            torch.cuda.set_device(self._device)
        if init_method is not None and self.world_size > 1:
            import torch.distributed as dist

            if dist.is_initialized():
                dist.destroy_process_group()
            dist.init_process_group("nccl" if use_gpu else "gloo",
                                    init_method=init_method,
                                    rank=self.world_rank,
                                    world_size=self.world_size)
        return True

    def setup_tensorflow(self, cluster_workers: List[str]) -> bool:
        """Write TF_CONFIG for MultiWorkerMirroredStrategy (parity:
        reference ``train/tensorflow/config.py`` ``_setup_tensorflow_
        environment`` — cluster spec of every gang member plus this
        worker's task index)."""
        import json

        os.environ["TF_CONFIG"] = json.dumps({
            "cluster": {"worker": cluster_workers},
            "task": {"type": "worker", "index": self.world_rank},
        })
        return True

    def run(self, fn: Callable, config: Dict[str, Any],
            dataset_shard: Any = None, resume_checkpoint=None) -> bool:
        """Start the user loop on a background thread; returns
        immediately.  Results stream via ``next_results``."""
        self._session = session_mod._TrainSession(
            self.world_rank, self.world_size, local_rank=0,
            dataset_shard=dataset_shard)
        self._session.resume_checkpoint = resume_checkpoint
        session_mod._set_session(self._session)
        device = self._device

        def _target():
            try:
                if device is not None:
                    import torch
                    torch.cuda.set_device(device)
                fn(config)
            except BaseException as e:  # noqa: BLE001 — forwarded to driver
                logger.exception("train loop failed on rank %d",
                                 self.world_rank)
                self._session.error = e
            finally:
                self._session.finished.set()

        self._thread = threading.Thread(target=_target, daemon=True,
                                        name="train-loop")
        self._thread.start()
        return True

    def next_results(self, timeout: float = 1.0) -> Dict[str, Any]:
        """Drain queued results; reports liveness and errors."""
        assert self._session is not None
        results: List[Dict[str, Any]] = []
        try:
            results.append(self._session.result_queue.get(timeout=timeout))
            while True:
                results.append(self._session.result_queue.get_nowait())
        except queue.Empty:
            pass
        error = None
        if self._session.error is not None:
            import traceback

            error = "".join(traceback.format_exception(self._session.error))
        return {
            "results": results,
            "finished": self._session.finished.is_set()
                        and self._session.result_queue.empty(),
            "error": error,
        }

    def shutdown_torch(self) -> bool:
        """Leave the process group, if this worker joined one."""
        import sys

        dist = sys.modules.get("torch.distributed")
        if dist is not None and dist.is_available() and dist.is_initialized():
            dist.destroy_process_group()
        return True



class WorkerGroup:
    def __init__(self, scaling: ScalingConfig):
        self.scaling = scaling
        self.pg: Optional[PlacementGroup] = None
        self.workers: List[Any] = []

    def start(self) -> None:
        bundles = [self.scaling.worker_resources()
                   for _ in range(self.scaling.num_workers)]
        self.pg = placement_group(bundles,
                                  strategy=self.scaling.placement_strategy)
        if not self.pg.wait(120):
            remove_placement_group(self.pg)
            raise RuntimeError(
                f"could not place training gang: {bundles} "
                f"({self.scaling.placement_strategy})")
        actor_cls = ray_tpu_torch.remote(TrainWorker)
        self.workers = []
        for rank in range(self.scaling.num_workers):
            strategy = PlacementGroupSchedulingStrategy(
                placement_group=self.pg,
                placement_group_bundle_index=rank)
            worker = actor_cls.options(
                num_cpus=self.scaling.cpus_per_worker,
                num_gpus=self.scaling.gpus_per_worker or None,
                resources=self.scaling.resources_per_worker or None,
                scheduling_strategy=strategy,
                max_concurrency=4,  # run + poll concurrently
            ).remote(rank, self.scaling.num_workers)
            self.workers.append(worker)
        # barrier: all actors alive
        ray_tpu_torch.get([w.__ray_ready__() for w in self.workers], timeout=300)

    def setup_backend(self, backend: str = "torch") -> None:
        if backend == "torch":
            init_method = None
            if self.scaling.num_workers > 1:
                host, port = ray_tpu_torch.get(
                    self.workers[0].hostname_and_port.remote(), timeout=60)
                init_method = f"tcp://{host}:{port}"
            use_gpu = (self.scaling.gpus_per_worker or 0) > 0
            ray_tpu_torch.get([w.setup_torch.remote(init_method, use_gpu)
                               for w in self.workers], timeout=600)
            return
        if backend == "tensorflow":
            addrs = ray_tpu_torch.get(
                [w.hostname_and_port.remote() for w in self.workers],
                timeout=60)
            cluster = [f"{h}:{p}" for h, p in addrs]
            ray_tpu_torch.get([w.setup_tensorflow.remote(cluster)
                               for w in self.workers], timeout=600)
            return
        raise ValueError(f"unknown train backend {backend!r}")

    def run(self, fn: Callable, config: Dict[str, Any],
            dataset_shards: Optional[List[Any]] = None,
            resume_checkpoint=None) -> None:
        ray_tpu_torch.get([
            w.run.remote(fn, config,
                         dataset_shards[i] if dataset_shards else None,
                         resume_checkpoint)
            for i, w in enumerate(self.workers)
        ], timeout=300)

    def poll(self, timeout: float = 1.0) -> List[Dict[str, Any]]:
        return ray_tpu_torch.get(
            [w.next_results.remote(timeout) for w in self.workers],
            timeout=max(60.0, timeout * 10))

    def shutdown(self) -> None:
        if self.scaling.num_workers > 1 and self.workers:
            try:  # the gang's process group, before its processes go
                ray_tpu_torch.get([w.shutdown_torch.remote()
                                   for w in self.workers], timeout=30)
            except Exception:  # noqa: BLE001 — a dead gang has no group
                pass
        for w in self.workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.workers = []
        if self.pg is not None:
            try:
                remove_placement_group(self.pg)
            except Exception:
                pass
            self.pg = None
