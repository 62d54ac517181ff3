"""Contextual bandits: LinUCB and LinTS.

Parity: reference ``rllib/algorithms/bandit/`` — linear upper-
confidence-bound and linear Thompson-sampling policies over per-arm
ridge-regression posteriors, trained online from (context, arm, reward)
interactions.  The posterior update is exact linear algebra (rank-1
Sherman-Morrison), numpy on the host, as in the reference: the bandits
have no device code, so ``num_gpus_per_learner`` does not apply.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.env import Discrete
from ray_tpu_torch.rllib.execution import synchronous_parallel_sample
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class BanditLinUCBConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.alpha = 1.0          # exploration width
        self.lambda_reg = 1.0     # ridge prior
        self.train_batch_size = 32
        self.rollout_fragment_length = 32
        self.use_gae = False

    @property
    def algo_class(self):
        return BanditLinUCB


class BanditLinTSConfig(BanditLinUCBConfig):
    def __init__(self):
        super().__init__()
        self.sample_scale = 1.0   # posterior sample temperature

    @property
    def algo_class(self):
        return BanditLinTS


class _LinearBanditPolicy:
    """Per-arm ridge posterior: A = lam*I + X'X, b = X'r."""

    thompson = False

    def __init__(self, observation_space, action_space, config):
        if not isinstance(action_space, Discrete):
            raise ValueError("bandit policies need a Discrete action space")
        self.observation_space = observation_space
        self.action_space = action_space
        self.config = config
        #: the posteriors are numpy arrays on the host
        self.device = torch.device("cpu")
        d = int(np.prod(observation_space.shape))
        k = action_space.n
        lam = float(config.get("lambda_reg", 1.0))
        self._A_inv = np.stack([np.eye(d) / lam for _ in range(k)])
        self._b = np.zeros((k, d))
        self._theta = np.zeros((k, d))
        self._np_rng = np.random.default_rng(
            int(config.get("seed", 0) or 0))

    # -- acting ----------------------------------------------------------
    def compute_actions(self, obs: np.ndarray, explore: bool = True):
        obs = np.asarray(obs, np.float64)
        scores = obs @ self._theta.T  # [B, k]
        if explore:
            if self.thompson:
                scale = float(self.config.get("sample_scale", 1.0))
                for a in range(self._theta.shape[0]):
                    theta_s = self._np_rng.multivariate_normal(
                        self._theta[a], scale * self._A_inv[a])
                    scores[:, a] = obs @ theta_s
            else:
                alpha = float(self.config.get("alpha", 1.0))
                for a in range(self._theta.shape[0]):
                    width = np.sqrt(np.einsum(
                        "bi,ij,bj->b", obs, self._A_inv[a], obs))
                    scores[:, a] += alpha * width
        return scores.argmax(axis=1).astype(np.int64), {}

    def postprocess_trajectory(self, batch, last_obs=None, truncated=False):
        return batch

    # -- learning --------------------------------------------------------
    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        obs = np.asarray(batch[SampleBatch.OBS], np.float64)
        acts = np.asarray(batch[SampleBatch.ACTIONS], np.int64)
        rews = np.asarray(batch[SampleBatch.REWARDS], np.float64)
        for x, a, r in zip(obs, acts, rews):
            Ai = self._A_inv[a]
            # Sherman-Morrison rank-1 update of A^-1
            Ax = Ai @ x
            self._A_inv[a] = Ai - np.outer(Ax, Ax) / (1.0 + x @ Ax)
            self._b[a] += r * x
            self._theta[a] = self._A_inv[a] @ self._b[a]
        return {"cumulative_regret_proxy": float(-rews.sum())}

    # -- weights ---------------------------------------------------------
    def get_weights(self):
        return {"A_inv": self._A_inv.copy(), "b": self._b.copy(),
                "theta": self._theta.copy()}

    def set_weights(self, weights) -> None:
        self._A_inv = np.asarray(weights["A_inv"])
        self._b = np.asarray(weights["b"])
        self._theta = np.asarray(weights["theta"])

    def get_state(self):
        return {"weights": self.get_weights()}

    def set_state(self, state):
        self.set_weights(state["weights"])

    def compute_values(self, obs):
        return np.zeros(len(obs), np.float32)


class _LinUCBPolicy(_LinearBanditPolicy):
    thompson = False


class _LinTSPolicy(_LinearBanditPolicy):
    thompson = True


class _BanditBase(Algorithm):
    def training_step(self) -> Dict[str, Any]:
        batch = synchronous_parallel_sample(
            self.workers,
            max_env_steps=int(self.config.get("train_batch_size", 32)))
        self._timesteps_total += len(batch)
        stats = self.workers.local_worker.policy.learn_on_batch(batch)
        self.workers.sync_weights()
        return stats


class BanditLinUCB(_BanditBase):
    policy_class = _LinUCBPolicy


class BanditLinTS(_BanditBase):
    policy_class = _LinTSPolicy
