"""DDPG and TD3 (deterministic continuous control, off-policy).

Parity: reference ``rllib/algorithms/ddpg/`` and ``rllib/algorithms/td3/``
— deterministic actor + Q critic with target networks and exploration
noise; TD3 adds twin critics (clipped double-Q), target-policy
smoothing, and delayed policy updates.  One update runs on the
learner's device: the critic steps first, and the actor's loss reads
the updated critic.  The delayed actor step is a branch on the host's
update counter (it reads nothing back from the device); both targets
are Polyak-averaged after every update.  All update noise comes from
:meth:`DDPGPolicy._update_noise`.
"""

from __future__ import annotations

import copy
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.sac import adam_step, polyak_
from ray_tpu_torch.rllib.env import Box
from ray_tpu_torch.rllib.execution import synchronous_parallel_sample
from ray_tpu_torch.rllib.models import TwinQNetwork, _dense, _generator
from ray_tpu_torch.rllib.policy import (Adam, TorchPolicy, _to_numpy,
                                        _to_tensors, normalize_actions,
                                        rescale_actions)
from ray_tpu_torch.rllib.replay_buffer import (PrioritizedReplayBuffer,
                                               ReplayBuffer)
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class DDPGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.actor_lr = 1e-3
        self.critic_lr = 1e-3
        self.gamma = 0.99
        self.tau = 0.005
        self.train_batch_size = 256
        self.rollout_fragment_length = 1
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.exploration_noise = 0.1   # N(0, sigma) on actions
        self.training_intensity = 1.0
        # TD3 extensions, off for plain DDPG
        self.twin_q = False
        self.policy_delay = 1
        self.smooth_target_policy = False
        self.target_noise = 0.2
        self.target_noise_clip = 0.5

    @property
    def algo_class(self):
        return DDPG


class TD3Config(DDPGConfig):
    """TD3 = DDPG + twin critics + delayed & smoothed policy updates
    (reference ``td3/td3.py`` — a DDPGConfig preset)."""

    def __init__(self):
        super().__init__()
        self.twin_q = True
        self.policy_delay = 2
        self.smooth_target_policy = True
        self.exploration_noise = 0.1

    @property
    def algo_class(self):
        return TD3


class _DetActor(nn.Module):
    """obs -> tanh action; ReLU torso.  flax's Dense names and init."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hiddens: tuple = (256, 256), seed: int = 0):
        super().__init__()
        gen = _generator(seed)
        self.hiddens = tuple(int(h) for h in hiddens)
        sizes = (obs_dim,) + self.hiddens
        for i in range(len(self.hiddens)):
            self.add_module(f"fc_{i}", _dense(sizes[i], sizes[i + 1], gen))
        self.out = _dense(sizes[-1], act_dim, gen)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        x = obs
        for i in range(len(self.hiddens)):
            x = F.relu(getattr(self, f"fc_{i}")(x))
        return torch.tanh(self.out(x))


class DDPGPolicy(TorchPolicy):
    """Deterministic-actor policy; like SACPolicy it replaces the FCNet
    actor-critic wholesale and reuses only TorchPolicy's rollout-facing
    surface (``_tensor``/``_device_batch``)."""

    def __init__(self, observation_space, action_space, config):
        if not isinstance(action_space, Box):
            raise ValueError("DDPG requires a continuous (Box) action space")
        self.observation_space = observation_space
        self.action_space = action_space
        self.config = config
        self.recurrent = False
        self.act_dim = int(np.prod(action_space.shape))
        obs_dim = int(np.prod(observation_space.shape))
        self._low = np.asarray(action_space.low, np.float32)
        self._high = np.asarray(action_space.high, np.float32)
        self.device = resolve_device(config.get("_device"))
        seed = int(config.get("seed", 0) or 0)
        self.actor = _DetActor(obs_dim, self.act_dim, seed=seed)
        self.critic = TwinQNetwork(obs_dim, self.act_dim,
                                   twin=bool(config.get("twin_q", False)),
                                   seed=seed + 1)
        self.actor.to(self.device)
        self.critic.to(self.device)
        self.target_actor = copy.deepcopy(self.actor).requires_grad_(False)
        self.target_critic = copy.deepcopy(
            self.critic).requires_grad_(False)
        self.actor_opt = Adam(self.actor.parameters(),
                              lr=float(config.get("actor_lr", 1e-3)))
        self.critic_opt = Adam(self.critic.parameters(),
                               lr=float(config.get("critic_lr", 1e-3)))
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._np_rng = np.random.default_rng(seed)
        self._updates = 0
        self._policy_delay = int(config.get("policy_delay", 1))

    def _rescale(self, act: np.ndarray) -> np.ndarray:
        return rescale_actions(act, self._low, self._high)

    def _normalize_actions(self, acts: np.ndarray) -> np.ndarray:
        return normalize_actions(acts, self._low, self._high)

    # -- rollout surface -------------------------------------------------
    def compute_actions(self, obs, explore: bool = True):
        with torch.no_grad():
            act = self.actor(self._tensor(obs)).cpu().numpy()
        if explore:
            sigma = self._exploration_sigma()
            act = np.clip(
                act + self._np_rng.normal(0.0, sigma, act.shape),
                -1.0, 1.0).astype(np.float32)
        return self._rescale(act), {}

    def _exploration_sigma(self) -> float:
        """Per-worker noise scale.  With ``per_worker_exploration`` on
        (Ape-X), worker i of N samples with sigma_i = sigma_base **
        (1 + alpha * i / (N - 1)) — the reference's
        ``PerWorkerEpsilonGreedy`` ladder applied to Gaussian noise."""
        cfg = self.config
        sigma = float(cfg.get("exploration_noise", 0.1))
        if cfg.get("per_worker_exploration"):
            i = int(cfg.get("worker_index", 0))
            n = max(1, int(cfg.get("num_rollout_workers", 1)))
            if i > 0 and n > 1:
                alpha = float(cfg.get("per_worker_noise_alpha", 3.0))
                sigma = sigma ** (1.0 + alpha * (i - 1) / (n - 1))
        return sigma

    def postprocess_trajectory(self, batch, last_obs=None, truncated=False):
        return batch

    def compute_values(self, obs):
        return np.zeros(len(obs), np.float32)

    # -- learning --------------------------------------------------------
    def _update_noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """Every random draw of one update: standard normals for the
        target-policy smoothing, ``[B, act_dim]`` (none without it)."""
        if not self.config.get("smooth_target_policy", False):
            return {}
        return {"target": torch.randn((batch_size, self.act_dim),
                                      generator=self._gen,
                                      device=self.device)}

    def _update_impl(self, batch, noise, do_actor: bool):
        cfg = self.config
        gamma = float(cfg.get("gamma", 0.99))
        obs = batch[SampleBatch.OBS]
        nobs = batch[SampleBatch.NEXT_OBS]
        acts = batch[SampleBatch.ACTIONS]
        rew = batch[SampleBatch.REWARDS]
        with torch.no_grad():
            done = batch[SampleBatch.TERMINATEDS].float()
            nact = self.target_actor(nobs)
            if "target" in noise:
                tclip = float(cfg.get("target_noise_clip", 0.5))
                eps = torch.clamp(
                    float(cfg.get("target_noise", 0.2)) * noise["target"],
                    -tclip, tclip)
                nact = torch.clamp(nact + eps, -1.0, 1.0)
            tq1, tq2 = self.target_critic(nobs, nact)
            target = rew + gamma * (1 - done) * torch.minimum(tq1, tq2)

        # importance weights (prioritized replay); ones otherwise
        w = batch.get("weights", torch.ones_like(rew))
        q1, q2 = self.critic(obs, acts)
        if self.critic.twin:
            c_loss = torch.mean(w * ((q1 - target) ** 2
                                     + (q2 - target) ** 2))
        else:
            c_loss = torch.mean(w * (q1 - target) ** 2)
        td_error = (q1 - target).detach()
        adam_step(self.critic_opt, list(self.critic.parameters()), c_loss)

        if do_actor:  # delayed policy update: the host's counter decides
            a_loss = -torch.mean(self.critic(obs, self.actor(obs))[0])
            adam_step(self.actor_opt, list(self.actor.parameters()), a_loss)
            a_loss = a_loss.detach()
        else:
            a_loss = torch.zeros((), device=self.device)
        tau = float(cfg.get("tau", 0.005))
        polyak_(self.target_actor, self.actor, tau)
        polyak_(self.target_critic, self.critic, tau)
        return {"critic_loss": c_loss.detach(), "actor_loss": a_loss,
                "mean_q_target": torch.mean(target)}, td_error

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        batch = SampleBatch(dict(
            batch, **{SampleBatch.ACTIONS: self._normalize_actions(
                np.asarray(batch[SampleBatch.ACTIONS]))}))
        self._updates += 1
        do_actor = (self._updates % self._policy_delay) == 0
        stats, td_error = self._update_impl(
            self._device_batch(batch), self._update_noise(len(batch)),
            do_actor)
        out = {k: float(v) for k, v in stats.items()}
        out["_td_error_np"] = td_error.cpu().numpy()
        return out

    # -- weights ---------------------------------------------------------
    def get_weights(self):
        return {"actor": _to_numpy(self.actor.state_dict())}

    def set_weights(self, weights) -> None:
        self.actor.load_state_dict(_to_tensors(dict(weights["actor"])))

    def get_state(self):
        return {"weights": self.get_weights(),
                "critic": _to_numpy(self.critic.state_dict()),
                "targets": (_to_numpy(self.target_actor.state_dict()),
                            _to_numpy(self.target_critic.state_dict())),
                "opt_states": (_to_numpy(self.actor_opt.state_dict()),
                               _to_numpy(self.critic_opt.state_dict())),
                "updates": self._updates}

    def set_state(self, state):
        self.set_weights(state["weights"])
        self.critic.load_state_dict(_to_tensors(state["critic"]))
        target_actor, target_critic = state["targets"]
        self.target_actor.load_state_dict(_to_tensors(target_actor))
        self.target_critic.load_state_dict(_to_tensors(target_critic))
        # load_state_dict moves each moment to its parameter's device
        for opt, s in zip((self.actor_opt, self.critic_opt),
                          state["opt_states"]):
            opt.load_state_dict(_to_tensors(s))
        self._updates = int(state.get("updates", 0))


class DDPG(Algorithm):
    policy_class = DDPGPolicy

    def setup(self) -> None:
        super().setup()
        cfg = self.config
        if cfg.get("prioritized_replay"):
            self.replay = PrioritizedReplayBuffer(
                int(cfg.get("replay_buffer_capacity", 100_000)),
                alpha=float(cfg.get("prioritized_replay_alpha", 0.6)),
                beta=float(cfg.get("prioritized_replay_beta", 0.4)),
                seed=cfg.get("seed"))
        else:
            self.replay = ReplayBuffer(
                int(cfg.get("replay_buffer_capacity", 100_000)),
                seed=cfg.get("seed"))

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        policy: DDPGPolicy = self.workers.local_worker.policy
        fragment = max(1, int(cfg.get("rollout_fragment_length", 1))
                       * int(cfg.get("num_envs_per_worker", 1)))
        batch = synchronous_parallel_sample(self.workers,
                                            max_env_steps=fragment)
        self.replay.add(batch)
        self._timesteps_total += len(batch)
        stats: Dict[str, Any] = {"replay_size": len(self.replay)}
        warmup = int(cfg.get("num_steps_sampled_before_learning_starts",
                             1000))
        bs = int(cfg.get("train_batch_size", 256))
        if len(self.replay) >= max(warmup, bs):
            updates = max(1, round(float(cfg.get("training_intensity", 1.0))
                                   * len(batch)))
            for _ in range(updates):
                mb = self.replay.sample(bs)
                out = policy.learn_on_batch(mb)
                td = out.pop("_td_error_np", None)
                if td is not None and hasattr(self.replay,
                                              "update_priorities"):
                    self.replay.update_priorities(mb["batch_indexes"], td)
                stats.update(out)
            self.workers.sync_weights()
        return stats


class TD3(DDPG):
    pass


class ApexDDPGConfig(DDPGConfig):
    """Ape-X DDPG (reference ``rllib/algorithms/apex_ddpg/``): DDPG with
    a distributed sampler fleet on a per-worker exploration-noise
    ladder feeding prioritized replay at high training intensity."""

    def __init__(self):
        super().__init__()
        self.prioritized_replay = True
        self.num_rollout_workers = 4
        self.training_intensity = 4.0
        self.per_worker_exploration = True
        self.per_worker_noise_alpha = 3.0
        self.exploration_noise = 0.4

    @property
    def algo_class(self):
        return ApexDDPG


class ApexDDPG(DDPG):
    pass
