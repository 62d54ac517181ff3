"""RLlib-equivalent: scalable reinforcement learning on the actor
substrate with PyTorch learners on the card.

Parity: reference ``rllib/`` — Algorithm + AlgorithmConfig driver,
RolloutWorker actor fleets, SampleBatch, GAE postprocessing, torch
policies.  Distributed pattern (SURVEY.md §3.6): driver Algorithm +
rollout actor fleet sampling on host CPUs, the learner's updates on the
GPU (``num_gpus_per_learner=0`` names the CPU).

The JAX package's ``JaxPolicy`` is :class:`TorchPolicy` here.  Of the
algorithms (``ray_tpu_torch.rllib.algorithms``), PPO, IMPALA/APPO,
PG/A2C/A3C, MARWIL/BC, DQN/SimpleQ/Ape-X DQN, R2D2, SAC, DDPG/TD3/Ape-X
DDPG, CQL, CRR, ES/ARS, LinUCB/LinTS, AlphaStar, MAML, MBMPO, Decision
Transformer, AlphaZero and SlateQ are ported, with ``tuned_examples``;
the others' names (MADDPG, QMIX, Dreamer, DD-PPO) raise
``NotImplementedError`` naming the ROADMAP.md item that brings them.
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
