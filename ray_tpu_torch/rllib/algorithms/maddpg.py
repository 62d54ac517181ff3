"""MADDPG: multi-agent DDPG with centralized critics.

Parity: reference ``rllib/algorithms/maddpg/`` — per-agent deterministic
actors μ_i(o_i) trained through per-agent centralized critics
Q_i(o_1..o_n, a_1..a_n) (critics see the joint observation/action, so
the environment is stationary from each critic's view), soft target
networks for both.  All agents' actors and critics are one module
(:class:`_PerAgentNets`) on the learner's device (the card unless
``num_gpus_per_learner=0``), with one Adam for the actors and one for
the critics (optax's ``multi_transform`` in the JAX package); the target
networks are a copy of it, Polyak-averaged after each update.

Scope: continuous (Box) action spaces — the classic MADDPG setting.
Sampling drives the env inline in ``training_step`` (cooperative team
envs step as one unit); exploration noise and replay indices are numpy
draws from ``default_rng(seed)``.
"""

from __future__ import annotations

import copy
import os
import pickle
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ray_tpu_torch import _port
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import (AlgorithmConfig,
                                                  learner_gpus)
from ray_tpu_torch.rllib.algorithms.sac import polyak_
from ray_tpu_torch.rllib.env import Box, MultiAgentEnv, make_env
from ray_tpu_torch.rllib.models import _dense, _generator
from ray_tpu_torch.rllib.policy import Adam, _to_numpy, _to_tensors


class MADDPGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.actor_lr = 1e-3
        self.critic_lr = 1e-3
        self.gamma = 0.95
        self.tau = 0.05  # soft target update
        self.train_batch_size = 64
        self.replay_buffer_capacity = 50_000
        self.actor_hiddens = (64, 64)
        self.critic_hiddens = (64, 64)
        self.exploration_noise = 0.4
        self.num_steps_sampled_before_learning_starts = 500
        self.rollout_episodes_per_step = 4
        self.updates_per_step = 8

    @property
    def algo_class(self):
        return MADDPG


class _MLP(nn.Module):
    """``fc_<i>`` Denses with ReLU, then ``out`` (flax's names)."""

    def __init__(self, n_in: int, n_out: int, hiddens: Sequence[int],
                 gen: torch.Generator):
        super().__init__()
        self.n_hidden = len(hiddens)
        for i, h in enumerate(hiddens):
            self.add_module(f"fc_{i}", _dense(n_in, h, gen))
            n_in = h
        self.out = _dense(n_in, n_out, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"fc_{i}")(x))
        return self.out(x)


class _Actor(_MLP):
    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.tanh(super().forward(obs))


class _Critic(_MLP):
    def forward(self, joint_obs: torch.Tensor,
                joint_act: torch.Tensor) -> torch.Tensor:
        return super().forward(
            torch.cat([joint_obs, joint_act], dim=-1))[..., 0]


class _PerAgentNets(nn.Module):
    """All agents' actors + critics in one module; flax's ``actors_<i>``
    / ``critics_<i>`` are ``actors.<i>`` / ``critics.<i>``."""

    def __init__(self, n_agents: int, obs_dim: int, act_dim: int,
                 actor_hiddens: Sequence[int],
                 critic_hiddens: Sequence[int], seed: int = 0):
        super().__init__()
        gen = _generator(seed)
        self.n_agents = n_agents
        self.actors = nn.ModuleList(
            _Actor(obs_dim, act_dim, actor_hiddens, gen)
            for _ in range(n_agents))
        joint = n_agents * (obs_dim + act_dim)
        self.critics = nn.ModuleList(
            _Critic(joint, 1, critic_hiddens, gen)
            for _ in range(n_agents))

    def act(self, obs: torch.Tensor) -> torch.Tensor:
        """obs [B, n, obs_dim] -> actions [B, n, act_dim]."""
        return torch.stack([self.actors[i](obs[:, i])
                            for i in range(self.n_agents)], dim=1)

    def critic_values(self, joint_obs: torch.Tensor,
                      joint_act: torch.Tensor) -> torch.Tensor:
        """-> [B, n] per-agent centralized Q."""
        return torch.stack([c(joint_obs, joint_act) for c in self.critics],
                           dim=1)


class MADDPGLearner:
    """The networks, their targets, the two Adams and the update on one
    device."""

    def __init__(self, n_agents: int, obs_dim: int, act_dim: int,
                 config: Dict[str, Any], device=None):
        self.config = config
        self.device = resolve_device(device)
        self.nets = _PerAgentNets(
            n_agents, obs_dim, act_dim,
            tuple(config.get("actor_hiddens", (64, 64))),
            tuple(config.get("critic_hiddens", (64, 64))),
            seed=int(config.get("seed", 0) or 0)).to(self.device)
        self.target = copy.deepcopy(self.nets)
        self.actor_opt = Adam(self.nets.actors.parameters(),
                              lr=float(config.get("actor_lr", 1e-3)))
        self.critic_opt = Adam(self.nets.critics.parameters(),
                               lr=float(config.get("critic_lr", 1e-3)))
        self.gamma = float(config.get("gamma", 0.95))
        # the JAX package's default when the config has no "tau"
        self.tau = float(config.get("tau", 0.01))

    def tensors(self, batch: Dict[str, np.ndarray]
                ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def act(self, obs: np.ndarray) -> np.ndarray:
        """obs [B, n, obs_dim] -> the actors' actions, on the host."""
        with torch.no_grad():
            return self.nets.act(torch.as_tensor(
                obs, device=self.device)).cpu().numpy()

    def _update(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One step of both Adams from the critic and actor losses at the
        same parameters, then the Polyak target; returns both losses."""
        nets, n = self.nets, self.nets.n_agents
        obs, actions = batch["obs"], batch["actions"]
        b = obs.shape[0]
        joint_obs = obs.reshape(b, -1)
        joint_act = actions.reshape(b, -1)
        with torch.no_grad():
            next_acts = self.target.act(batch["next_obs"]).reshape(b, -1)
            q_next = self.target.critic_values(
                batch["next_obs"].reshape(b, -1), next_acts)
            target = batch["rewards"] + self.gamma \
                * (1.0 - batch["dones"][:, None]) * q_next
        q = nets.critic_values(joint_obs, joint_act)
        critic_loss = torch.mean((q - target) ** 2)
        # agent i's own action from its actor, the others' from the
        # batch; only the actors learn from this loss
        acts = nets.act(obs)
        actor_losses = []
        for i in range(n):
            mixed = torch.cat([actions[:, :i], acts[:, i:i + 1],
                               actions[:, i + 1:]], dim=1)
            qi = nets.critics[i](joint_obs, mixed.reshape(b, -1))
            actor_losses.append(-torch.mean(qi))
        actor_loss = torch.stack(actor_losses).sum()
        critic_params = list(nets.critics.parameters())
        actor_params = list(nets.actors.parameters())
        g_critic = torch.autograd.grad(critic_loss, critic_params)
        g_actor = torch.autograd.grad(actor_loss, actor_params)
        for params, grads in ((critic_params, g_critic),
                              (actor_params, g_actor)):
            for p, g in zip(params, grads):
                p.grad = g
        self.critic_opt.step()
        self.actor_opt.step()
        polyak_(self.target, nets, self.tau)
        return critic_loss.detach(), actor_loss.detach()

    def update(self, batch: Dict[str, np.ndarray]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`_update` on numpy columns; the losses stay on the
        device."""
        return self._update(self.tensors(batch))

    def get_state(self) -> Dict[str, Any]:
        return {"weights": _to_numpy(self.nets.state_dict()),
                "target": _to_numpy(self.target.state_dict()),
                "actor_opt": _to_numpy(self.actor_opt.state_dict()),
                "critic_opt": _to_numpy(self.critic_opt.state_dict())}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.nets.load_state_dict(_to_tensors(state["weights"]))
        self.target.load_state_dict(_to_tensors(state["target"]))
        if "actor_opt" in state:
            self.actor_opt.load_state_dict(_to_tensors(state["actor_opt"]))
            self.critic_opt.load_state_dict(
                _to_tensors(state["critic_opt"]))


class SimpleTargetChase(MultiAgentEnv):
    """Tiny continuous cooperative env for MADDPG smoke/regression runs:
    each agent moves on a line toward its own target; shared reward is
    the negative summed distance (cooperative; critics benefit from the
    joint view because obs include only the own position/target)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.n = int(config.get("num_agents", 2))
        self.horizon = int(config.get("horizon", 25))
        self._rng = np.random.default_rng(config.get("seed"))
        obs_space = Box(-2.0, 2.0, (2,))
        act_space = Box(-1.0, 1.0, (1,))
        self.observation_spaces = {i: obs_space for i in range(self.n)}
        self.action_spaces = {i: act_space for i in range(self.n)}

    def _obs(self):
        return {i: np.asarray([self.pos[i], self.targets[i]], np.float32)
                for i in range(self.n)}

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self.pos = self._rng.uniform(-1, 1, self.n)
        self.targets = self._rng.uniform(-1, 1, self.n)
        self.t = 0
        return self._obs(), {i: {} for i in range(self.n)}

    def step(self, action_dict):
        for i in range(self.n):
            self.pos[i] = float(np.clip(
                self.pos[i] + 0.1 * float(np.asarray(
                    action_dict[i]).ravel()[0]), -2.0, 2.0))
        self.t += 1
        dist = sum(abs(self.pos[i] - self.targets[i])
                   for i in range(self.n))
        rew = {i: -dist / self.n for i in range(self.n)}
        done = self.t >= self.horizon
        terms = {i: False for i in range(self.n)}
        terms["__all__"] = False
        truncs = {i: done for i in range(self.n)}
        truncs["__all__"] = done
        return self._obs(), rew, terms, truncs, {i: {} for i in range(self.n)}


class MADDPG(Algorithm):
    supports_multi_agent = True

    def setup(self) -> None:
        cfg = self.config
        _port.reject_tpu_options("MADDPG", cfg)
        self.env = make_env(cfg["env"], dict(cfg.get("env_config", {})))
        if not isinstance(self.env, MultiAgentEnv):
            raise ValueError("MADDPG requires a MultiAgentEnv")
        self.agent_ids: List[Any] = list(self.env.agent_ids)
        n = len(self.agent_ids)
        act_space = self.env.action_space_for(self.agent_ids[0])
        if not isinstance(act_space, Box):
            raise ValueError("this MADDPG supports continuous (Box) "
                             "action spaces")
        obs_space = self.env.observation_space_for(self.agent_ids[0])
        self.n_agents = n
        self.act_dim = int(np.prod(act_space.shape))
        self.obs_dim = int(np.prod(obs_space.shape))
        self._act_low = np.asarray(act_space.low, np.float32)
        self._act_high = np.asarray(act_space.high, np.float32)
        self.learner = MADDPGLearner(
            n, self.obs_dim, self.act_dim, cfg,
            device=None if learner_gpus(cfg) else "cpu")
        self._replay: deque = deque(
            maxlen=int(cfg.get("replay_buffer_capacity", 50_000)))
        self._np_rng = np.random.default_rng(int(cfg.get("seed", 0) or 0))
        self._pending_returns: List[float] = []
        self._pending_lens: List[int] = []

    def get_policy(self, policy_id: Optional[str] = None) -> MADDPGLearner:
        return self.learner

    # -- sampling -------------------------------------------------------
    def _stack_obs(self, obs) -> np.ndarray:
        return np.stack([np.asarray(obs[a], np.float32).ravel()
                         for a in self.agent_ids])

    def _act(self, stacked: np.ndarray, explore: bool) -> np.ndarray:
        acts = self.learner.act(stacked[None])[0]  # [n, act_dim]
        if explore:
            noise = float(self.config.get("exploration_noise", 0.1))
            acts = acts + noise * self._np_rng.standard_normal(acts.shape)
        return np.clip(acts, self._act_low, self._act_high) \
            .astype(np.float32)

    def _run_episode(self, explore: bool = True) -> Tuple[float, int]:
        obs, _ = self.env.reset()
        total, steps = 0.0, 0
        while True:
            stacked = self._stack_obs(obs)
            actions = self._act(stacked, explore)
            action_dict = {a: actions[i]
                           for i, a in enumerate(self.agent_ids)}
            obs, rews, terms, truncs, _ = self.env.step(action_dict)
            rew_vec = np.asarray([float(rews[a]) for a in self.agent_ids],
                                 np.float32)
            done = bool(terms.get("__all__") or truncs.get("__all__"))
            self._replay.append((stacked, actions, rew_vec,
                                 self._stack_obs(obs), float(done)))
            total += float(rew_vec.sum())
            steps += 1
            self._timesteps_total += 1
            if done:
                return total, steps

    # -- training -------------------------------------------------------
    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        for _ in range(int(cfg.get("rollout_episodes_per_step", 4))):
            ret, length = self._run_episode()
            self._pending_returns.append(ret)
            self._pending_lens.append(length)
        stats: Dict[str, Any] = {"replay_size": len(self._replay)}
        warmup = int(cfg.get("num_steps_sampled_before_learning_starts",
                             500))
        bs = int(cfg.get("train_batch_size", 64))
        if len(self._replay) >= max(warmup, bs):
            # the JAX package's default when the config has no count
            for _ in range(int(cfg.get("updates_per_step", 4))):
                idx = self._np_rng.integers(0, len(self._replay), bs)
                rows = [self._replay[i] for i in idx]
                batch = {
                    "obs": np.stack([r[0] for r in rows]),
                    "actions": np.stack([r[1] for r in rows]),
                    "rewards": np.stack([r[2] for r in rows]),
                    "next_obs": np.stack([r[3] for r in rows]),
                    "dones": np.asarray([r[4] for r in rows], np.float32),
                }
                critic_loss, actor_loss = self.learner.update(batch)
            stats["critic_loss"] = float(critic_loss)
            stats["actor_loss"] = float(actor_loss)
        return stats

    # -- Algorithm plumbing without a worker fleet ----------------------
    def _collect_metrics(self):
        out = [{"episode_returns": list(self._pending_returns),
                "episode_lens": list(self._pending_lens)}]
        self._pending_returns.clear()
        self._pending_lens.clear()
        return out

    def evaluate(self) -> Dict[str, Any]:
        returns = []
        for _ in range(int(self.config.get("evaluation_duration", 10))):
            ret, _ = self._run_episode(explore=False)
            returns.append(ret)
        return {"episode_reward_mean": float(np.mean(returns)),
                "episode_reward_min": float(np.min(returns)),
                "episode_reward_max": float(np.max(returns))}

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "wb") as f:
            pickle.dump({
                "params": _to_numpy(self.learner.nets.state_dict()),
                "target_params": _to_numpy(
                    self.learner.target.state_dict()),
                "iteration": self.iteration,
                "timesteps_total": self._timesteps_total,
            }, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        self.learner.nets.load_state_dict(_to_tensors(state["params"]))
        self.learner.target.load_state_dict(
            _to_tensors(state["target_params"]))
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]

    def stop(self) -> None:
        pass
