"""Typed, chainable algorithm configuration.

Parity: reference ``rllib/algorithms/algorithm_config.py`` — the builder
pattern (``.environment().rollouts().training().build()``) with the same
method/field names the reference uses, narrowed to the PyTorch stack.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Type

from ray_tpu_torch import _port


def learner_gpus(config: Dict[str, Any]) -> int:
    """The config's ``num_gpus_per_learner``: 1 (the default) or 0.  The
    learner is one policy on one device, so a count above 1 would still
    give it one card: it raises instead."""
    n = config.get("num_gpus_per_learner", 1)
    if n not in (0, 1):
        raise ValueError(f"num_gpus_per_learner must be 0 (the CPU) or 1 "
                         f"(one card), got {n!r}: no multi-card learner "
                         f"exists")
    return int(n)


class AlgorithmConfig:
    #: set by each algorithm's subclass
    algo_class: Optional[type] = None

    def __init__(self):
        # environment
        self.env: Any = None
        self.env_config: Dict[str, Any] = {}
        # rollouts
        self.num_rollout_workers = 0
        self.num_envs_per_worker = 1
        self.sample_async = False
        self.rollout_fragment_length = 200
        # decoupled (Podracer/Sebulba) pipeline — docs/rl_pipeline.md
        self.decoupled = False
        self.num_env_actors: Optional[int] = None
        self.rl_envs_per_actor: Optional[int] = None
        self.rl_env_groups = 1
        self.rl_inference_batch_size = 0
        self.rl_num_inference_actors = 1
        self.rl_max_fragment_lag = 2
        self.rl_inference_max_wait_s = 0.002
        self.rl_inference_device: Optional[str] = None
        # training
        self.lr = 5e-4
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.use_gae = True
        self.train_batch_size = 4000
        self.grad_clip = 0.0
        self.model: Dict[str, Any] = {"fcnet_hiddens": (64, 64),
                                      "fcnet_activation": "tanh",
                                      "vf_share_layers": False}
        # resources
        self.num_cpus_per_worker = 1
        #: the learner's GPUs: 1 puts it on the card (the JAX package's
        #: learner stays on the host unless granted TPUs); 0 names the CPU
        self.num_gpus_per_learner = 1
        # evaluation
        self.evaluation_interval: Optional[int] = None
        self.evaluation_duration = 10
        # debugging
        self.seed: Optional[int] = None
        # fault tolerance
        self.recreate_failed_workers = False
        # multi-agent (empty == single-agent mode)
        self.policies: Dict[str, Any] = {}
        self.policy_mapping_fn: Optional[Any] = None
        self.policies_to_train: Optional[Any] = None

    # -- chainable setters (reference naming) ---------------------------
    def environment(self, env: Any = None, *,
                    env_config: Optional[Dict[str, Any]] = None
                    ) -> "AlgorithmConfig":
        if env is not None:
            self.env = env
        if env_config is not None:
            self.env_config = dict(env_config)
        return self

    def rollouts_input(self, input_: Any) -> "AlgorithmConfig":
        """External sampling input: callable(worker) -> reader with
        ``.next()`` (reference ``input_`` — e.g. PolicyServerInput)."""
        self.input_ = input_
        return self

    def rollouts(self, *, num_rollout_workers: Optional[int] = None,
                 num_envs_per_worker: Optional[int] = None,
                 rollout_fragment_length: Optional[int] = None,
                 sample_async: Optional[bool] = None,
                 decoupled: Optional[bool] = None,
                 num_env_actors: Optional[int] = None,
                 rl_envs_per_actor: Optional[int] = None,
                 rl_env_groups: Optional[int] = None,
                 rl_inference_batch_size: Optional[int] = None,
                 rl_num_inference_actors: Optional[int] = None,
                 rl_max_fragment_lag: Optional[int] = None,
                 rl_inference_max_wait_s: Optional[float] = None,
                 ) -> "AlgorithmConfig":
        if num_rollout_workers is not None:
            self.num_rollout_workers = int(num_rollout_workers)
        if num_envs_per_worker is not None:
            self.num_envs_per_worker = int(num_envs_per_worker)
        if rollout_fragment_length is not None:
            self.rollout_fragment_length = int(rollout_fragment_length)
        if sample_async is not None:
            # overlap sampling with the learner update (reference
            # ``sample_async`` / the LearnerThread shape): workers keep
            # one fragment in flight through learn_on_batch, at the cost
            # of <=1-update-stale weights per fragment
            self.sample_async = bool(sample_async)
        if decoupled is not None:
            # Podracer-style decoupled acting/learning: vectorized env
            # actors + centralized batched inference + async learner
            # (docs/rl_pipeline.md); falls back to the classic paths for
            # multi-agent / recurrent / external-input configs
            self.decoupled = bool(decoupled)
        if num_env_actors is not None:
            self.num_env_actors = int(num_env_actors)
        if rl_envs_per_actor is not None:
            self.rl_envs_per_actor = int(rl_envs_per_actor)
        if rl_env_groups is not None:
            self.rl_env_groups = int(rl_env_groups)
        if rl_inference_batch_size is not None:
            self.rl_inference_batch_size = int(rl_inference_batch_size)
        if rl_num_inference_actors is not None:
            self.rl_num_inference_actors = int(rl_num_inference_actors)
        if rl_max_fragment_lag is not None:
            self.rl_max_fragment_lag = int(rl_max_fragment_lag)
        if rl_inference_max_wait_s is not None:
            self.rl_inference_max_wait_s = float(rl_inference_max_wait_s)
        return self

    def training(self, **kwargs) -> "AlgorithmConfig":
        _port.reject_tpu_options("AlgorithmConfig.training", kwargs)
        for k, v in kwargs.items():
            if not hasattr(self, k):
                raise ValueError(f"unknown training option {k!r}")
            setattr(self, k, v)
        return self

    def resources(self, *, num_cpus_per_worker: Optional[float] = None,
                  num_gpus_per_learner: Optional[int] = None,
                  **unknown: Any) -> "AlgorithmConfig":
        """Resources of the samplers and the learner.
        ``num_gpus_per_learner`` is 1 (the learner on the card, the
        default) or 0 (on the CPU); no multi-card learner exists, so any
        other value raises ``ValueError``."""
        _port.reject_tpu_options("AlgorithmConfig.resources", unknown)
        if unknown:
            raise TypeError(f"resources() got unexpected options "
                            f"{sorted(unknown)}")
        if num_cpus_per_worker is not None:
            self.num_cpus_per_worker = num_cpus_per_worker
        if num_gpus_per_learner is not None:
            self.num_gpus_per_learner = learner_gpus(
                {"num_gpus_per_learner": num_gpus_per_learner})
        return self

    def multi_agent(self, *, policies: Optional[Dict[str, Any]] = None,
                    policy_mapping_fn: Optional[Any] = None,
                    policies_to_train: Optional[Any] = None
                    ) -> "AlgorithmConfig":
        """Configure multi-agent training (reference
        ``AlgorithmConfig.multi_agent``).  ``policies`` maps policy id ->
        None (infer spaces from the env's first mapped agent) or
        ``(obs_space, act_space, config_overrides)``;
        ``policy_mapping_fn(agent_id)`` -> policy id."""
        if policies is not None:
            self.policies = dict(policies)
        if policy_mapping_fn is not None:
            self.policy_mapping_fn = policy_mapping_fn
        if policies_to_train is not None:
            self.policies_to_train = list(policies_to_train)
        return self

    def framework(self, framework: str = "torch") -> "AlgorithmConfig":
        if framework not in ("torch",):
            raise ValueError("this stack is PyTorch-native; "
                             "framework='torch'")
        return self

    def evaluation(self, *, evaluation_interval: Optional[int] = None,
                   evaluation_duration: Optional[int] = None
                   ) -> "AlgorithmConfig":
        if evaluation_interval is not None:
            self.evaluation_interval = evaluation_interval
        if evaluation_duration is not None:
            self.evaluation_duration = evaluation_duration
        return self

    def debugging(self, *, seed: Optional[int] = None) -> "AlgorithmConfig":
        if seed is not None:
            self.seed = seed
        return self

    def fault_tolerance(self, *, recreate_failed_workers: Optional[bool]
                        = None) -> "AlgorithmConfig":
        if recreate_failed_workers is not None:
            self.recreate_failed_workers = recreate_failed_workers
        return self

    # -- materialization ------------------------------------------------
    def copy(self) -> "AlgorithmConfig":
        return copy.deepcopy(self)

    def to_dict(self) -> Dict[str, Any]:
        return {k: v for k, v in vars(self).items()
                if not k.startswith("_")}

    def build(self, env: Any = None):
        if env is not None:
            self.env = env
        if self.algo_class is None:
            raise ValueError("use an algorithm-specific config "
                             "(e.g. PPOConfig) to build()")
        return self.algo_class(self)
