"""Deep Q-Networks with replay and target network.

Parity: reference ``rllib/algorithms/dqn/`` — epsilon-greedy
exploration with linear decay, (prioritized) replay, double-DQN target,
periodic target-network sync, n-step=1.  The TD update runs on the
learner's device; the target network is a second copy of the model on
that device, which :meth:`DQNPolicy.update_target` overwrites with the
online weights.  Replay and the epsilon-greedy draws stay on the host
(numpy's generator, as in the JAX package).
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.execution import synchronous_parallel_sample
from ray_tpu_torch.rllib.policy import TorchPolicy, _to_numpy, _to_tensors
from ray_tpu_torch.rllib.replay_buffer import (PrioritizedReplayBuffer,
                                               ReplayBuffer)
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class DQNConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.train_batch_size = 32
        self.rollout_fragment_length = 4
        self.replay_buffer_capacity = 50_000
        self.prioritized_replay = False
        self.prioritized_replay_alpha = 0.6
        self.prioritized_replay_beta = 0.4
        self.num_steps_sampled_before_learning_starts = 1000
        self.target_network_update_freq = 500  # env steps
        self.double_q = True
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.02
        self.epsilon_timesteps = 10_000
        self.training_intensity = 1.0  # learn updates per sampled step

    @property
    def algo_class(self):
        return DQN


def huber(td: torch.Tensor) -> torch.Tensor:
    """0.5 td^2 inside |td| < 1, |td| - 0.5 outside (the JAX package's
    branch: |td| == 1 takes the linear side)."""
    return torch.where(torch.abs(td) < 1.0, 0.5 * td ** 2,
                       torch.abs(td) - 0.5)


def epsilon_greedy(policy, q: np.ndarray, explore: bool) -> np.ndarray:
    """Greedy actions over ``q`` (on the host), each replaced with
    probability ``policy._epsilon()`` by a uniform one from the policy's
    numpy generator; the policy's step count advances when exploring."""
    actions = q.argmax(axis=-1)
    if explore:
        eps = policy._epsilon()
        policy._steps += len(actions)
        mask = policy._np_rng.random(len(actions)) < eps
        random_actions = policy._np_rng.integers(
            0, policy.action_space.n, size=len(actions))
        actions = np.where(mask, random_actions, actions)
    return actions.astype(np.int64)


class DQNPolicy(TorchPolicy):
    """Q-network policy: FCNet logits are Q-values; vf head unused."""

    def __init__(self, observation_space, action_space, config):
        super().__init__(observation_space, action_space, config)
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        self._steps = 0

    # -- exploration ----------------------------------------------------
    def _epsilon(self) -> float:
        cfg = self.config
        if cfg.get("per_worker_exploration"):
            # Ape-X constant per-worker ladder: worker i of N explores
            # at eps ** (1 + alpha * i / (N-1)) (reference
            # ``PerWorkerEpsilonGreedy``); the local worker anneals.
            i = int(cfg.get("worker_index", 0))
            n = max(1, int(cfg.get("num_rollout_workers", 1)))
            if i > 0 and n > 1:
                alpha = float(cfg.get("per_worker_eps_alpha", 7.0))
                return 0.4 ** (1.0 + alpha * (i - 1) / (n - 1))
        frac = min(1.0, self._steps
                   / float(cfg.get("epsilon_timesteps", 10_000)))
        e0 = float(cfg.get("epsilon_initial", 1.0))
        e1 = float(cfg.get("epsilon_final", 0.02))
        return e0 + frac * (e1 - e0)

    def compute_actions(self, obs, explore: bool = True):
        with torch.no_grad():
            q = self.model(self._tensor(obs))[0].cpu().numpy()
        return epsilon_greedy(self, q, explore), {}

    # -- no GAE: replay stores raw transitions -------------------------
    def postprocess_trajectory(self, batch, last_obs=None, truncated=False):
        return batch

    # -- TD loss --------------------------------------------------------
    def loss(self, batch):
        cfg = self.config
        gamma = float(cfg.get("gamma", 0.99))
        q_all, _ = self.model(batch[SampleBatch.OBS])
        q_taken = torch.gather(
            q_all, -1, batch[SampleBatch.ACTIONS].long()[:, None]
        ).squeeze(-1)
        with torch.no_grad():
            q_next_target, _ = self.target_model(batch[SampleBatch.NEXT_OBS])
            if cfg.get("double_q", True):
                q_next_online, _ = self.model(batch[SampleBatch.NEXT_OBS])
                best = torch.argmax(q_next_online, dim=-1)
                q_next = torch.gather(q_next_target, -1,
                                      best[:, None]).squeeze(-1)
            else:
                q_next = torch.max(q_next_target, dim=-1).values
            done = batch[SampleBatch.TERMINATEDS].float()
            target = batch[SampleBatch.REWARDS] \
                + gamma * (1.0 - done) * q_next
        td_error = q_taken - target
        weights = batch.get("weights")
        loss = torch.mean(huber(td_error) * weights) \
            if weights is not None else torch.mean(huber(td_error))
        return loss, {"mean_q": torch.mean(q_taken).detach(),
                      "td_error_abs": torch.mean(
                          torch.abs(td_error)).detach(),
                      "_td_error": td_error.detach()}

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        stats = self._update(self._device_batch(batch))
        td = stats.pop("_td_error").cpu().numpy()
        out = {k: float(v) for k, v in stats.items()}
        out["_td_error_np"] = td
        return out

    def update_target(self) -> None:
        self.target_model.load_state_dict(self.model.state_dict())

    def get_state(self):
        state = super().get_state()
        state["target_params"] = _to_numpy(self.target_model.state_dict())
        state["steps"] = self._steps
        return state

    def set_state(self, state):
        super().set_state(state)
        if "target_params" in state:
            self.target_model.load_state_dict(
                _to_tensors(state["target_params"]))
        self._steps = int(state.get("steps", 0))


class DQN(Algorithm):
    policy_class = DQNPolicy

    def setup(self) -> None:
        super().setup()
        cfg = self.config
        if cfg.get("prioritized_replay"):
            self.replay = PrioritizedReplayBuffer(
                int(cfg.get("replay_buffer_capacity", 50_000)),
                alpha=float(cfg.get("prioritized_replay_alpha", 0.6)),
                beta=float(cfg.get("prioritized_replay_beta", 0.4)),
                seed=cfg.get("seed"))
        else:
            self.replay = ReplayBuffer(
                int(cfg.get("replay_buffer_capacity", 50_000)),
                seed=cfg.get("seed"))
        self._since_target_update = 0

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        policy: DQNPolicy = self.workers.local_worker.policy
        fragment = int(cfg.get("rollout_fragment_length", 4)) \
            * max(1, int(cfg.get("num_envs_per_worker", 1)))
        batch = synchronous_parallel_sample(self.workers,
                                            max_env_steps=fragment)
        self.replay.add(batch)
        self._timesteps_total += len(batch)
        self._since_target_update += len(batch)

        stats: Dict[str, Any] = {"replay_size": len(self.replay)}
        warmup = int(cfg.get("num_steps_sampled_before_learning_starts",
                             1000))
        if len(self.replay) >= max(warmup,
                                   int(cfg.get("train_batch_size", 32))):
            updates = max(1, round(float(cfg.get("training_intensity", 1.0))
                                   * len(batch)
                                   / int(cfg.get("train_batch_size", 32))))
            for _ in range(updates):
                mb = self.replay.sample(int(cfg.get("train_batch_size", 32)))
                out = policy.learn_on_batch(mb)
                td = out.pop("_td_error_np", None)
                if td is not None and hasattr(self.replay,
                                              "update_priorities"):
                    self.replay.update_priorities(mb["batch_indexes"], td)
                stats.update(out)
            if self._since_target_update >= int(
                    cfg.get("target_network_update_freq", 500)):
                policy.update_target()
                self._since_target_update = 0
            self.workers.sync_weights()
        return stats


class SimpleQConfig(DQNConfig):
    """SimpleQ: DQN without double-Q or prioritized replay (reference
    ``rllib/algorithms/simple_q/``)."""

    def __init__(self):
        super().__init__()
        self.double_q = False
        self.prioritized_replay = False

    @property
    def algo_class(self):
        return SimpleQ


class SimpleQ(DQN):
    pass


class ApexDQNConfig(DQNConfig):
    """Ape-X: DQN with a large distributed sampler fleet feeding
    prioritized replay (reference ``rllib/algorithms/apex_dqn/``).  The
    execution skeleton maps onto the actor fleet directly: many rollout
    workers with per-worker epsilons, prioritized replay beside the learner,
    high training intensity."""

    def __init__(self):
        super().__init__()
        self.prioritized_replay = True
        self.num_rollout_workers = 4
        self.training_intensity = 4.0
        self.target_network_update_freq = 2000
        self.per_worker_exploration = True
        self.per_worker_eps_alpha = 7.0

    @property
    def algo_class(self):
        return ApexDQN


class ApexDQN(DQN):
    pass
