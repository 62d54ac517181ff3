"""Training library (parity: ``ray.train`` + the AIR session/config
surface): :class:`TorchTrainer` over gang actors, checkpoints of torch
tensor pytrees, predictors.

The JAX package's framework trainers (``XGBoostTrainer``,
``LightGBMTrainer``, ``SklearnTrainer``, ``HuggingFaceTrainer``,
``RLTrainer``) and ``HuggingFacePredictor`` are not ported yet: their
names raise ``NotImplementedError`` naming the ROADMAP.md item that
brings them.
"""

from ray_tpu_torch import _port
from ray_tpu_torch.train import session  # noqa: F401
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager  # noqa: F401
from ray_tpu_torch.train.config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.predictor import (  # noqa: F401
    BatchPredictor,
    Predictor,
    SklearnPredictor,
    TorchPredictor,
)
from ray_tpu_torch.train.trainer import (  # noqa: F401
    Result,
    TensorflowTrainer,
    TorchTrainer,
)
from ray_tpu_torch.train.worker_group import TrainWorker, WorkerGroup  # noqa: F401

# names of the JAX package's ray_tpu.train that later slices bring
_LATER = {
    "XGBoostTrainer": "queue 1, item 4 (framework trainers)",
    "LightGBMTrainer": "queue 1, item 4 (framework trainers)",
    "SklearnTrainer": "queue 1, item 4 (framework trainers)",
    "HuggingFaceTrainer": "queue 1, item 4 (framework trainers)",
    "HuggingFacePredictor": "queue 1, item 4 (framework trainers)",
    "RLTrainer": "queue 1, item 6 (RL)",
}


def __getattr__(name: str):
    if name in _LATER:
        raise _port.not_ported(f"ray_tpu_torch.train.{name}", _LATER[name])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
