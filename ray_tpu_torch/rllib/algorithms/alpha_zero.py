"""AlphaZero: MCTS-guided policy iteration.

Parity: reference ``rllib/algorithms/alpha_zero/`` — PUCT tree search
over a *cloneable* environment with priors/values from a policy+value
network, trained on (visit-count distribution, observed return) targets.
Like the reference's single-player variant, the env contract is
``get_state()/set_state()`` (deep-copyable state) and deterministic
transitions; the bundled smoke target is deterministic CartPole via
state snapshotting.

The tree walk is host-side Python (tiny and branchy); the network, its
Adam and each update live on the learner's device (the card unless
``num_gpus_per_learner=0``), and each leaf is evaluated there as it is
reached, one forward and one copy back to the host a simulation, as the
JAX package's jitted forward is on its default device.
"""

from __future__ import annotations

import copy
import math
import os
import pickle
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import (AlgorithmConfig,
                                                  learner_gpus)
from ray_tpu_torch.rllib.env import Discrete, make_env
from ray_tpu_torch.rllib.models import FCNet
from ray_tpu_torch.rllib.policy import Adam, _to_numpy, _to_tensors


class AlphaZeroConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.num_simulations = 30
        self.c_puct = 1.5
        self.dirichlet_alpha = 0.3
        self.dirichlet_frac = 0.25
        self.temperature_steps = 20  # sample by visit counts this long
        self.train_batch_size = 128
        self.replay_buffer_capacity = 20_000
        self.rollout_episodes_per_step = 2
        self.updates_per_step = 8
        self.max_episode_steps = 200
        self.gamma = 0.997

    @property
    def algo_class(self):
        return AlphaZero


class _Node:
    __slots__ = ("prior", "visits", "value_sum", "children", "reward",
                 "state", "obs", "done")

    def __init__(self, prior: float):
        self.prior = prior
        self.visits = 0
        self.value_sum = 0.0
        self.children: Dict[int, "_Node"] = {}
        self.reward = 0.0
        self.state = None
        self.obs = None
        self.done = False

    @property
    def value(self) -> float:
        return self.value_sum / self.visits if self.visits else 0.0


def _puct_select(node: _Node, c_puct: float) -> int:
    """The child action of highest PUCT score (the first of equals)."""
    total = math.sqrt(node.visits)
    best, best_score = None, -float("inf")
    for a, child in node.children.items():
        u = child.value + c_puct * child.prior * total / (1 + child.visits)
        if u > best_score:
            best, best_score = a, u
    return best


def _env_state(env):
    """Snapshot for tree search: env.get_state() when provided, else a
    deepcopy of the env's __dict__ (works for the bundled pure-python
    envs — the reference similarly requires cloneable envs)."""
    fn = getattr(env, "get_state", None)
    if fn is not None:
        return fn()
    return copy.deepcopy(env.__dict__)


def _env_restore(env, state) -> None:
    fn = getattr(env, "set_state", None)
    if fn is not None:
        fn(state)
    else:
        env.__dict__.update(copy.deepcopy(state))


class AlphaZeroLearner:
    """The policy+value network (an FCNet with a shared torso), its Adam
    and the update on one device."""

    def __init__(self, obs_dim: int, num_actions: int,
                 config: Dict[str, Any], device=None):
        self.config = config
        self.device = resolve_device(device)
        self.model = FCNet(obs_dim, num_actions, hiddens=(64, 64),
                           vf_share_layers=True,
                           seed=int(config.get("seed", 0) or 0)
                           ).to(self.device)
        self.opt = Adam(self.model.parameters(),
                        lr=float(config.get("lr", 1e-3)))

    def _infer(self, obs: torch.Tensor):
        """(softmax priors, values) for a batch of observations."""
        with torch.no_grad():
            logits, value = self.model(obs)
            return F.softmax(logits, dim=-1), value

    def infer(self, obs: np.ndarray) -> Tuple[np.ndarray, float]:
        """One observation's priors and value, on the host."""
        flat = np.asarray(obs, np.float32).reshape(1, -1)  # images too
        priors, value = self._infer(torch.as_tensor(flat,
                                                    device=self.device))
        return priors[0].cpu().numpy(), float(value[0])

    def _update(self, batch: Dict[str, torch.Tensor]):
        """One Adam step on the visit-distribution cross-entropy plus the
        value error; returns (policy_loss, value_loss)."""
        logits, value = self.model(batch["obs"])
        logp = F.log_softmax(logits, dim=-1)
        policy_loss = -torch.mean(torch.sum(batch["pi"] * logp, dim=-1))
        value_loss = torch.mean((value - batch["z"]) ** 2)
        self.opt.zero_grad(set_to_none=False)
        (policy_loss + value_loss).backward()
        self.opt.step()
        return policy_loss.detach(), value_loss.detach()

    def update(self, batch: Dict[str, np.ndarray]):
        """:meth:`_update` on numpy columns; the losses stay on the
        device."""
        return self._update({k: torch.as_tensor(v, device=self.device)
                             for k, v in batch.items()})

    def get_state(self) -> Dict[str, Any]:
        return {"weights": _to_numpy(self.model.state_dict()),
                "opt_state": _to_numpy(self.opt.state_dict())}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(_to_tensors(state["weights"]))
        if "opt_state" in state:
            self.opt.load_state_dict(_to_tensors(state["opt_state"]))


class AlphaZero(Algorithm):
    def setup(self) -> None:
        cfg = self.config
        self.env = make_env(cfg["env"], dict(cfg.get("env_config", {})))
        if not isinstance(self.env.action_space, Discrete):
            raise ValueError("AlphaZero requires a Discrete action space")
        self.num_actions = int(self.env.action_space.n)
        self.obs_dim = int(np.prod(self.env.observation_space.shape))
        self.learner = AlphaZeroLearner(
            self.obs_dim, self.num_actions, cfg,
            device=None if learner_gpus(cfg) else "cpu")
        self._replay: deque = deque(
            maxlen=int(cfg.get("replay_buffer_capacity", 20_000)))
        self._np_rng = np.random.default_rng(int(cfg.get("seed", 0) or 0))
        self._pending_returns: List[float] = []
        self._pending_lens: List[int] = []
        #: tree-search simulations run so far
        self.simulations = 0

    def get_policy(self, policy_id: Optional[str] = None
                   ) -> AlphaZeroLearner:
        return self.learner

    # -- MCTS -----------------------------------------------------------
    def _mcts(self, env, obs: np.ndarray, explore: bool) -> np.ndarray:
        cfg = self.config
        n_sim = int(cfg.get("num_simulations", 30))
        c_puct = float(cfg.get("c_puct", 1.5))
        gamma = float(cfg.get("gamma", 0.997))

        root = _Node(0.0)
        root.state = _env_state(env)
        root.obs = obs
        priors, value = self.learner.infer(obs)
        if explore:
            noise = self._np_rng.dirichlet(
                [float(cfg.get("dirichlet_alpha", 0.3))] * self.num_actions)
            frac = float(cfg.get("dirichlet_frac", 0.25))
            priors = (1 - frac) * priors + frac * noise
        for a in range(self.num_actions):
            root.children[a] = _Node(float(priors[a]))
        root.visits = 1
        root.value_sum = value

        for _ in range(n_sim):
            node = root
            path = [root]
            # select to a leaf
            while node.children and not node.done:
                action = _puct_select(node, c_puct)
                parent = node
                node = node.children[action]
                if node.state is None:
                    # expand: step a restored copy of the env
                    _env_restore(env, parent.state)
                    nobs, rew, term, trunc, _ = env.step(action)
                    node.state = _env_state(env)
                    node.obs = np.asarray(nobs, np.float32)
                    node.reward = float(rew)
                    node.done = bool(term or trunc)
                path.append(node)
            # evaluate leaf
            if node.done:
                leaf_value = 0.0
            else:
                priors, leaf_value = self.learner.infer(node.obs)
                if not node.children:
                    for a in range(self.num_actions):
                        node.children[a] = _Node(float(priors[a]))
            # backup (discounted through the path's rewards).  A node's
            # value INCLUDES its entering reward: Q(parent, a) ==
            # child.value, so selection sees immediate rewards —
            # crediting the reward one level up would make terminal
            # moves (the catch/miss in terminal-reward games)
            # indistinguishable at selection time
            value = leaf_value
            for n in reversed(path):
                value = n.reward + gamma * value
                n.visits += 1
                n.value_sum += value
        self.simulations += n_sim
        counts = np.asarray(
            [root.children[a].visits for a in range(self.num_actions)],
            np.float64)
        _env_restore(env, root.state)
        return counts / counts.sum()

    # -- self-play ------------------------------------------------------
    def _run_episode(self, explore: bool = True) -> Tuple[float, int]:
        cfg = self.config
        obs, _ = self.env.reset()
        obs = np.asarray(obs, np.float32)
        history: List[Tuple[np.ndarray, np.ndarray, float]] = []
        total, steps = 0.0, 0
        max_steps = int(cfg.get("max_episode_steps", 200))
        temp_steps = int(cfg.get("temperature_steps", 20))
        while steps < max_steps:
            pi = self._mcts(self.env, obs, explore)
            if explore and steps < temp_steps:
                action = int(self._np_rng.choice(self.num_actions, p=pi))
            else:
                action = int(np.argmax(pi))
            nobs, rew, term, trunc, _ = self.env.step(action)
            history.append((obs, pi, float(rew)))
            total += float(rew)
            steps += 1
            self._timesteps_total += 1
            obs = np.asarray(nobs, np.float32)
            if term or trunc:
                break
        # returns-to-go as value targets
        gamma = float(cfg.get("gamma", 0.997))
        z = 0.0
        for obs_t, pi_t, rew_t in reversed(history):
            z = rew_t + gamma * z
            self._replay.append((np.asarray(obs_t,
                                            np.float32).reshape(-1),
                                 pi_t.astype(np.float32), float(z)))
        return total, steps

    # -- training -------------------------------------------------------
    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        for _ in range(int(cfg.get("rollout_episodes_per_step", 2))):
            ret, length = self._run_episode()
            self._pending_returns.append(ret)
            self._pending_lens.append(length)
        stats: Dict[str, Any] = {"replay_size": len(self._replay)}
        bs = int(cfg.get("train_batch_size", 128))
        if len(self._replay) >= bs:
            for _ in range(int(cfg.get("updates_per_step", 8))):
                idx = self._np_rng.integers(0, len(self._replay), bs)
                rows = [self._replay[i] for i in idx]
                pl, vl = self.learner.update({
                    "obs": np.stack([r[0] for r in rows]),
                    "pi": np.stack([r[1] for r in rows]),
                    "z": np.asarray([r[2] for r in rows], np.float32)})
            stats["policy_loss"] = float(pl)
            stats["value_loss"] = float(vl)
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
        for _ in range(int(self.config.get("evaluation_duration", 5))):
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
                "params": _to_numpy(self.learner.model.state_dict()),
                "iteration": self.iteration,
                "timesteps_total": self._timesteps_total,
            }, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        self.learner.model.load_state_dict(_to_tensors(state["params"]))
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]

    def stop(self) -> None:
        pass
