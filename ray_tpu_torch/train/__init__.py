"""Training library (parity: ``ray.train`` + the AIR session/config
surface): :class:`TorchTrainer` over gang actors, checkpoints of torch
tensor pytrees, predictors.

:class:`RLTrainer` runs an RLlib algorithm under the fit contract.  The
framework trainers are the JAX package's: :class:`SklearnTrainer` fits
on the host, :class:`XGBoostTrainer` and :class:`LightGBMTrainer` raise
``ImportError`` without their library, :class:`HuggingFaceTrainer` runs
``transformers.Trainer`` on the torch gang, and
:class:`HuggingFacePredictor` runs its checkpoint on the card unless
given ``device="cpu"``.
"""

from ray_tpu_torch.train import session  # noqa: F401
from ray_tpu_torch.train.checkpoint import Checkpoint, CheckpointManager  # noqa: F401
from ray_tpu_torch.train.config import (  # noqa: F401
    CheckpointConfig,
    FailureConfig,
    RunConfig,
    ScalingConfig,
)
from ray_tpu_torch.train.gbdt import LightGBMTrainer, XGBoostTrainer  # noqa: F401
from ray_tpu_torch.train.huggingface import HuggingFaceTrainer  # noqa: F401
from ray_tpu_torch.train.predictor import (  # noqa: F401
    BatchPredictor,
    HuggingFacePredictor,
    Predictor,
    SklearnPredictor,
    TorchPredictor,
)
from ray_tpu_torch.train.rl import RLTrainer  # noqa: F401
from ray_tpu_torch.train.sklearn import SklearnTrainer  # noqa: F401
from ray_tpu_torch.train.trainer import (  # noqa: F401
    Result,
    TensorflowTrainer,
    TorchTrainer,
)
from ray_tpu_torch.train.worker_group import TrainWorker, WorkerGroup  # noqa: F401

# names of the JAX package's ray_tpu.train that later slices bring: none
# (JaxTrainer and JaxPredictor are TorchTrainer and TorchPredictor here)
_LATER: dict = {}
