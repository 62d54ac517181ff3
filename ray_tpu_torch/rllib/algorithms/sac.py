"""Soft Actor-Critic (continuous control, off-policy).

Parity: reference ``rllib/algorithms/sac/`` — squashed-Gaussian actor,
twin Q critics with target networks (clipped double-Q), entropy-
regularized objectives with a learned temperature alpha against a
target entropy, replay-driven updates.  One update runs the critic,
actor and alpha steps on the learner's device, each with its own Adam
in optax's order (:class:`~ray_tpu_torch.rllib.policy.Adam`); the actor
loss reads the critic after its step.  The target critic, ``log_alpha``
and every Adam moment live on that device; the target critic is
Polyak-averaged after each update.  All update noise comes from
:meth:`SACPolicy._update_noise`.
"""

from __future__ import annotations

import copy
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.env import Box
from ray_tpu_torch.rllib.execution import synchronous_parallel_sample
from ray_tpu_torch.rllib.models import TwinQNetwork, _dense, _generator
from ray_tpu_torch.rllib.policy import (Adam, TorchPolicy, _to_numpy,
                                        _to_tensors, normalize_actions,
                                        rescale_actions)
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch

_HALF_LOG_2PI = 0.5 * math.log(2 * math.pi)


class SACConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.gamma = 0.99
        self.tau = 0.005  # Polyak factor for target critics
        self.train_batch_size = 256
        self.rollout_fragment_length = 1
        self.replay_buffer_capacity = 100_000
        self.num_steps_sampled_before_learning_starts = 1000
        self.initial_alpha = 1.0
        self.target_entropy: Any = "auto"  # -|A| when auto
        self.training_intensity = 1.0

    @property
    def algo_class(self):
        return SAC


class _SquashedActor(nn.Module):
    """obs -> (mean, log_std) of the pre-tanh Gaussian; ReLU torso, the
    log_std clipped to [-20, 2].  flax's Dense names and init."""

    def __init__(self, obs_dim: int, act_dim: int,
                 hiddens: tuple = (256, 256), seed: int = 0):
        super().__init__()
        gen = _generator(seed)
        self.hiddens = tuple(int(h) for h in hiddens)
        sizes = (obs_dim,) + self.hiddens
        for i in range(len(self.hiddens)):
            self.add_module(f"fc_{i}", _dense(sizes[i], sizes[i + 1], gen))
        self.mean = _dense(sizes[-1], act_dim, gen)
        self.log_std = _dense(sizes[-1], act_dim, gen)

    def forward(self, obs: torch.Tensor):
        x = obs
        for i in range(len(self.hiddens)):
            x = F.relu(getattr(self, f"fc_{i}")(x))
        return self.mean(x), torch.clamp(self.log_std(x), -20.0, 2.0)


def _sample_squashed(mean, log_std, eps):
    """tanh-squashed Gaussian sample + log prob (SAC appendix C) from
    standard normal draws ``eps`` of ``mean``'s shape."""
    std = torch.exp(log_std)
    pre = mean + std * eps
    act = torch.tanh(pre)
    logp = torch.sum(
        -0.5 * (eps ** 2) - log_std - _HALF_LOG_2PI
        - torch.log(1 - act ** 2 + 1e-6), dim=-1)
    return act, logp


def polyak_(target: nn.Module, source: nn.Module, tau: float) -> None:
    """``t = (1 - tau) * t + tau * p`` for every parameter, written as the
    JAX package writes it (``lerp`` rounds differently)."""
    with torch.no_grad():
        for t, p in zip(target.parameters(), source.parameters()):
            t.copy_((1 - tau) * t + tau * p)


def adam_step(opt: Adam, params, loss: torch.Tensor) -> None:
    """Gradients of ``loss`` for ``params`` alone (other modules the loss
    reads keep theirs), then one step of ``opt``."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    for p, g in zip(params, grads):
        p.grad = torch.zeros_like(p) if g is None else g
    opt.step()


class SACPolicy(TorchPolicy):
    """Replaces the FCNet actor-critic wholesale: SAC needs its own
    actor/critic/alpha structure, so only the rollout-facing surface of
    TorchPolicy is reused."""

    def __init__(self, observation_space, action_space, config):
        if not isinstance(action_space, Box):
            raise ValueError("SAC requires a continuous (Box) action space")
        self.observation_space = observation_space
        self.action_space = action_space
        self.config = config
        self.recurrent = False
        self.act_dim = int(np.prod(action_space.shape))
        obs_dim = int(np.prod(observation_space.shape))
        # bounds for rescaling tanh output into the env's range
        self._low = np.asarray(action_space.low, np.float32)
        self._high = np.asarray(action_space.high, np.float32)
        self.device = resolve_device(config.get("_device"))
        seed = int(config.get("seed", 0) or 0)
        self.actor = _SquashedActor(obs_dim, self.act_dim, seed=seed)
        self.critic = TwinQNetwork(obs_dim, self.act_dim, seed=seed + 1)
        self.actor.to(self.device)
        self.critic.to(self.device)
        self.target_critic = copy.deepcopy(
            self.critic).requires_grad_(False)
        # the log taken in f32, as the JAX package takes it
        self.log_alpha = nn.Parameter(torch.log(torch.tensor(
            float(config.get("initial_alpha", 1.0)),
            dtype=torch.float32)).to(self.device))
        lr = float(config.get("lr", 3e-4))
        self.actor_opt = Adam(self.actor.parameters(), lr=lr)
        self.critic_opt = Adam(self.critic.parameters(), lr=lr)
        self.alpha_opt = Adam([self.log_alpha], lr=lr)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self._np_rng = np.random.default_rng(seed)
        te = config.get("target_entropy", "auto")
        self.target_entropy = float(-self.act_dim if te == "auto" else te)

    def _rescale(self, act: np.ndarray) -> np.ndarray:
        return rescale_actions(act, self._low, self._high)

    def _normalize_actions(self, acts: np.ndarray) -> np.ndarray:
        return normalize_actions(acts, self._low, self._high)

    def _normal(self, shape) -> torch.Tensor:
        return torch.randn(shape, generator=self._gen, device=self.device)

    # -- rollout surface (matches TorchPolicy's contract) ---------------
    def compute_actions(self, obs, explore: bool = True):
        with torch.no_grad():
            mean, log_std = self.actor(self._tensor(obs))
            if explore:
                act, _ = _sample_squashed(mean, log_std,
                                          self._normal(mean.shape))
            else:
                act = torch.tanh(mean)
        return self._rescale(act.cpu().numpy()), {}

    def postprocess_trajectory(self, batch, last_obs=None, truncated=False):
        return batch  # replay stores raw transitions

    def compute_values(self, obs):  # TorchPolicy surface; unused by SAC
        return np.zeros(len(obs), np.float32)

    # -- learning -------------------------------------------------------
    def _update_noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """Every random draw of one update, by use: standard normals for
        the next action of the critic target and for the actor loss's
        action, each ``[B, act_dim]``."""
        shape = (batch_size, self.act_dim)
        return {"next": self._normal(shape), "actor": self._normal(shape)}

    def _critic_target(self, batch, noise, alpha):
        gamma = float(self.config.get("gamma", 0.99))
        with torch.no_grad():
            nmean, nlstd = self.actor(batch[SampleBatch.NEXT_OBS])
            nact, nlogp = _sample_squashed(nmean, nlstd, noise["next"])
            tq1, tq2 = self.target_critic(batch[SampleBatch.NEXT_OBS], nact)
            done = batch[SampleBatch.TERMINATEDS].float()
            soft = torch.minimum(tq1, tq2)
            if alpha is not None:
                soft = soft - alpha * nlogp
            return batch[SampleBatch.REWARDS] + gamma * (1 - done) * soft

    def _actor_alpha_step(self, batch, noise, alpha):
        """SAC's actor step against the (already updated) critic, then the
        temperature's step; returns the actor loss."""
        obs = batch[SampleBatch.OBS]
        actor_params = list(self.actor.parameters())
        mean, log_std = self.actor(obs)
        act, logp = _sample_squashed(mean, log_std, noise["actor"])
        q1, q2 = self.critic(obs, act)
        a_loss = torch.mean(alpha * logp - torch.minimum(q1, q2))
        adam_step(self.actor_opt, actor_params, a_loss)
        al_loss = -torch.mean(torch.exp(self.log_alpha)
                              * (logp + self.target_entropy).detach())
        adam_step(self.alpha_opt, [self.log_alpha], al_loss)
        return a_loss.detach()

    def _update_impl(self, batch, noise):
        obs = batch[SampleBatch.OBS]
        acts = batch[SampleBatch.ACTIONS]
        alpha = torch.exp(self.log_alpha).detach()
        target = self._critic_target(batch, noise, alpha)
        q1, q2 = self.critic(obs, acts)
        c_loss = torch.mean((q1 - target) ** 2 + (q2 - target) ** 2)
        adam_step(self.critic_opt, list(self.critic.parameters()), c_loss)
        a_loss = self._actor_alpha_step(batch, noise, alpha)
        return {"critic_loss": c_loss.detach(), "actor_loss": a_loss,
                "alpha": torch.exp(self.log_alpha).detach(),
                "mean_q": torch.mean(target)}

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        tau = float(self.config.get("tau", 0.005))
        batch = SampleBatch(dict(
            batch, **{SampleBatch.ACTIONS: self._normalize_actions(
                np.asarray(batch[SampleBatch.ACTIONS]))}))
        dev = self._device_batch(batch)
        stats = self._update_impl(dev, self._update_noise(len(batch)))
        polyak_(self.target_critic, self.critic, tau)
        return {k: float(v) for k, v in stats.items()}

    # -- weights --------------------------------------------------------
    def get_weights(self):
        # rollout workers only act — the critic stays learner-side
        # (halves weight-broadcast bytes; checkpoints carry it via
        # get_state)
        return {"actor": _to_numpy(self.actor.state_dict())}

    def set_weights(self, weights) -> None:
        self.actor.load_state_dict(_to_tensors(dict(weights["actor"])))
        if "critic" in weights:
            self.critic.load_state_dict(
                _to_tensors(dict(weights["critic"])))

    def _opts(self):
        return (self.actor_opt, self.critic_opt, self.alpha_opt)

    def get_state(self):
        return {"weights": {"actor": _to_numpy(self.actor.state_dict()),
                            "critic": _to_numpy(self.critic.state_dict())},
                "target_critic": _to_numpy(self.target_critic.state_dict()),
                "log_alpha": float(self.log_alpha.detach()),
                "opt_states": tuple(_to_numpy(o.state_dict())
                                    for o in self._opts())}

    def set_state(self, state):
        self.set_weights(state["weights"])
        self.target_critic.load_state_dict(
            _to_tensors(state["target_critic"]))
        with torch.no_grad():
            self.log_alpha.fill_(float(state["log_alpha"]))
        if "opt_states" in state:
            # load_state_dict moves each moment to its parameter's device
            for opt, s in zip(self._opts(), state["opt_states"]):
                opt.load_state_dict(_to_tensors(s))


class SAC(Algorithm):
    policy_class = SACPolicy

    def setup(self) -> None:
        super().setup()
        cfg = self.config
        self.replay = ReplayBuffer(
            int(cfg.get("replay_buffer_capacity", 100_000)),
            seed=cfg.get("seed"))

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        policy: SACPolicy = self.workers.local_worker.policy
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
                stats.update(policy.learn_on_batch(self.replay.sample(bs)))
            self.workers.sync_weights()
        return stats
