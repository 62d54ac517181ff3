"""Trial state + the trial actor.

Parity: reference ``python/ray/tune/experiment/trial.py`` (Trial state
machine) and ``tune/trainable/function_trainable.py`` (function trainables
report via a session from a worker thread).  Each trial runs inside one
actor; the runner polls buffered results so schedulers see intermediate
iterations (the ASHA/PBT contract).

An actor leased a GPU (``resources_per_trial={"GPU": x}``) makes the GPU
of its lease the current device on the trial's thread before the
trainable runs, as the port's ``TrainWorker`` does on its loop's thread:
the current CUDA device belongs to a thread.  An actor without a GPU
lease imports no torch.
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint

PENDING = "PENDING"
RUNNING = "RUNNING"
PAUSED = "PAUSED"
TERMINATED = "TERMINATED"
ERROR = "ERROR"


class _StopTrial(Exception):
    pass


class _SharedTrialState:
    """Mutable state shared between the trainable thread (via the session)
    and the actor's RPC methods."""

    def __init__(self):
        self.lock = threading.Lock()
        self.cv = threading.Condition(self.lock)
        self.results: List[Dict[str, Any]] = []
        self.latest_checkpoint: Optional[Checkpoint] = None
        self.restore_checkpoint: Optional[Checkpoint] = None
        self.stop_requested = False
        self.iteration = 0


_session = threading.local()  # .shared -> _SharedTrialState


def report(metrics: Optional[Dict[str, Any]] = None, *,
           checkpoint: Optional[Checkpoint] = None, **kw) -> None:
    """In-trial reporting (parity: ``ray.air.session.report`` /
    ``tune.report`` — both ``report({"loss": x})`` and the legacy
    ``report(loss=x)`` kwarg style work)."""
    sh: _SharedTrialState = getattr(_session, "shared", None)
    if sh is None:
        raise RuntimeError("tune.report() called outside a trial")
    if metrics is None:
        metrics = {}
    if not isinstance(metrics, dict):
        raise TypeError("metrics must be a dict")
    metrics = {**metrics, **kw}
    with sh.cv:
        # bounded queue (parity: the reference function-trainable result
        # queue is size 1) — backpressure lets schedulers stop a trial
        # between iterations instead of after it finishes
        while len(sh.results) >= 1 and not sh.stop_requested:
            sh.cv.wait(timeout=0.5)
        if sh.stop_requested:
            raise _StopTrial()
        sh.iteration += 1
        metrics.setdefault("training_iteration", sh.iteration)
        if checkpoint is not None:
            sh.latest_checkpoint = checkpoint
            metrics["_has_checkpoint"] = True
        sh.results.append(metrics)


def get_checkpoint() -> Optional[Checkpoint]:
    sh = getattr(_session, "shared", None)
    return sh.restore_checkpoint if sh else None


@ray_tpu_torch.remote
class TrialActor:
    """Hosts one trial: runs the trainable fn on a worker thread, buffers
    reported results for the runner's poll loop."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[str] = None
        self._done = False
        self._shared = _SharedTrialState()

    def run(self, fn: Callable[[Dict[str, Any]], Any], config: Dict[str, Any],
            checkpoint: Optional[Checkpoint] = None) -> bool:
        self._shared.restore_checkpoint = checkpoint
        shared = self._shared
        # lease ids index the GPUs this host sees, so the id is the device
        ids = ray_tpu_torch.get_gpu_ids()
        device = int(ids[0]) if ids else None

        def target():
            # late import by module name: the actor class is cloudpickled by
            # value (its importable name is shadowed by @remote), so a direct
            # reference to the module-global `_session` would capture an
            # unpicklable thread-local AND diverge from the instance that
            # report() (imported by name on this worker) actually reads
            from ray_tpu_torch.tune import trial as trial_mod

            trial_mod._session.shared = shared
            try:
                if device is not None:
                    import torch
                    torch.cuda.set_device(device)
                fn(dict(config))
            except trial_mod._StopTrial:  # class identity: by-name module
                pass
            except Exception as e:  # noqa: BLE001 — reported to the runner
                import traceback

                with shared.lock:
                    self._error = f"{e}\n{traceback.format_exc()}"
            finally:
                with shared.lock:
                    self._done = True

        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()
        return True

    def poll(self) -> Dict[str, Any]:
        with self._shared.cv:
            results = list(self._shared.results)
            self._shared.results.clear()
            self._shared.cv.notify_all()
            return {"results": results, "done": self._done,
                    "error": self._error}

    def request_stop(self) -> bool:
        with self._shared.cv:
            self._shared.stop_requested = True
            self._shared.cv.notify_all()
        return True

    def get_checkpoint(self) -> Optional[Checkpoint]:
        with self._shared.lock:
            return self._shared.latest_checkpoint

    def join(self, timeout: float = 10.0) -> bool:
        if self._thread is not None:
            self._thread.join(timeout)
        return self._done


@dataclass
class Trial:
    """Parity: reference ``tune/experiment/trial.py`` Trial."""

    config: Dict[str, Any]
    trial_id: str = field(default_factory=lambda: uuid.uuid4().hex[:8])
    status: str = PENDING
    last_result: Dict[str, Any] = field(default_factory=dict)
    results: List[Dict[str, Any]] = field(default_factory=list)
    error: Optional[str] = None
    checkpoint: Optional[Checkpoint] = None
    #: durable-storage location of the last synced checkpoint (set by the
    #: runner's experiment sync; survives head loss)
    checkpoint_uri: Optional[str] = None
    num_failures: int = 0
    actor: Any = None

    @property
    def metric_history(self) -> List[Dict[str, Any]]:
        return self.results
