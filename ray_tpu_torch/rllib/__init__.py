"""RLlib-equivalent: scalable reinforcement learning on the actor
substrate with PyTorch learners on the card.

Parity: reference ``rllib/`` — Algorithm + AlgorithmConfig driver,
RolloutWorker actor fleets, SampleBatch, GAE postprocessing, torch
policies.  Distributed pattern (SURVEY.md §3.6): driver Algorithm +
rollout actor fleet sampling on host CPUs, the learner's updates on the
GPU (``num_gpus_per_learner=0`` names the CPU).

The JAX package's ``JaxPolicy`` is :class:`TorchPolicy` here.  Every
algorithm of the JAX package is in ``ray_tpu_torch.rllib.algorithms``,
with ``tuned_examples``; DD-PPO's learners are its remote rollout
workers, each on a share of the card.
"""

from ray_tpu_torch.rllib.algorithm import Algorithm  # noqa: F401
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig  # noqa: F401
from ray_tpu_torch.rllib.env import (  # noqa: F401
    Box,
    CartPole,
    CartPoleVector,
    Discrete,
    MultiAgentCartPole,
    MultiAgentEnv,
    Pendulum,
    RandomEnv,
    SyncVectorEnv,
    VectorEnv,
    as_vector_env,
    make_env,
    register_env,
    register_vector_env,
)
from ray_tpu_torch.rllib.execution import DecoupledPipeline  # noqa: F401
from ray_tpu_torch.rllib.inference import (  # noqa: F401
    InferenceActor,
    InferenceBatcher,
)
from ray_tpu_torch.rllib.connectors import (  # noqa: F401
    ClipActions,
    ClipObs,
    Connector,
    ConnectorPipeline,
    FlattenObs,
    NormalizeObs,
)
from ray_tpu_torch.rllib.policy import TorchPolicy  # noqa: F401
from ray_tpu_torch.rllib.policy_server import (  # noqa: F401
    PolicyClient,
    PolicyServerInput,
)
from ray_tpu_torch.rllib.postprocessing import compute_gae  # noqa: F401
from ray_tpu_torch.rllib.rollout_worker import (  # noqa: F401
    EnvActor,
    RolloutWorker,
)
from ray_tpu_torch.rllib.sample_batch import (  # noqa: F401
    MultiAgentBatch,
    SampleBatch,
    concat_samples,
)
from ray_tpu_torch.rllib.worker_set import WorkerSet  # noqa: F401
