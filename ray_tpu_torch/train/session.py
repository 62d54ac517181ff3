"""Per-worker training session.

Parity: reference ``python/ray/train/_internal/session.py`` — inside
``train_loop_per_worker`` user code calls ``session.report(metrics,
checkpoint=...)`` to stream results/checkpoints to the driver and
``session.get_*`` for rank/world/dataset context.  The session is a
process-global bound by the TrainWorker actor around the loop.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Dict, Optional

from ray_tpu_torch.core import device_telemetry as _dt
from ray_tpu_torch.train.checkpoint import Checkpoint

_session: Optional["_TrainSession"] = None
_lock = threading.Lock()


class _TrainSession:
    def __init__(self, world_rank: int, world_size: int, local_rank: int,
                 dataset_shard: Any = None):
        self.world_rank = world_rank
        self.world_size = world_size
        self.local_rank = local_rank
        self.dataset_shard = dataset_shard
        self.result_queue: "queue.Queue" = queue.Queue()
        self.finished = threading.Event()
        self.error: Optional[BaseException] = None
        # device-plane attribution for this rank's train loop; loops
        # opt in via session.step_monitor() step brackets (zero-step
        # monitors stay silent: no gauges, empty device stats)
        self.step_monitor = _dt.StepMonitor(
            "train", name=f"train.rank{world_rank}")

    def report(self, metrics: Dict[str, Any],
               checkpoint: Optional[Checkpoint] = None) -> None:
        row: Dict[str, Any] = {"metrics": dict(metrics),
                               "checkpoint": checkpoint,
                               "rank": self.world_rank}
        # device stats ride as a SIBLING of metrics so result consumers
        # comparing metrics dicts are unaffected
        dev = self.step_monitor.stats()
        if dev["steps"]:
            row["device"] = dev
        self.result_queue.put(row)


def _set_session(session: Optional[_TrainSession]) -> None:
    global _session
    with _lock:
        _session = session


def _get_session() -> _TrainSession:
    if _session is None:
        raise RuntimeError(
            "No training session active — this API must be called inside "
            "train_loop_per_worker")
    return _session


# -- public API (reference: ray.air.session / ray.train.session) -------------

def report(metrics: Dict[str, Any],
           checkpoint: Optional[Checkpoint] = None) -> None:
    _get_session().report(metrics, checkpoint)


def get_world_rank() -> int:
    return _get_session().world_rank


def get_world_size() -> int:
    return _get_session().world_size


def get_local_rank() -> int:
    return _get_session().local_rank


def get_dataset_shard(name: str = "train") -> Any:
    shard = _get_session().dataset_shard
    if isinstance(shard, dict):
        return shard.get(name)
    return shard


def get_checkpoint() -> Optional[Checkpoint]:
    session = _get_session()
    return getattr(session, "resume_checkpoint", None)


def step_monitor() -> "_dt.StepMonitor":
    """This rank's device-plane step monitor.  A train loop brackets
    each step with it to light up MFU / phase attribution::

        mon = session.step_monitor()
        mon.flops_per_token = cfg.flops_per_token()
        for batch in shard.to_torch(batch_size=...):
            span = mon.step(data_wait_s=wait)
            loss = train_step(model, opt, batch["tokens"])  # dispatch
            span.dispatched()
            span.device_done(loss)              # synchronises the card
            span.done(tokens=batch_tokens)

    Unbracketed loops keep working — the monitor just reports zero
    steps and exports nothing.
    """
    return _get_session().step_monitor
