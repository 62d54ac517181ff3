"""SlateQ: Q-learning for recommendation slates.

Parity: reference ``rllib/algorithms/slateq/`` — the SlateQ
decomposition (Ie et al.): the value of a slate factorizes over its
items through the user-choice model, ``Q(s, slate) = Σ_i P(click=i |
s, slate) · Q(s, i)``, so a per-item Q-network plus a known/learned
choice model replaces the combinatorial slate action space.  Item
scoring, the softmax choice model and the TD update over the decomposed
target run on the learner's device (the card unless
``num_gpus_per_learner=0``); the next state's greedy slate is a top-k
that breaks ties toward the lower index, as ``jax.lax.top_k`` does
(``torch.topk`` promises no order among equals).

Includes :class:`SimpleRecEnv`, a minimal RecSim-style environment
(user interest vector drifting with consumed docs, myopic click choice
with a no-click option) standing in for the reference's RecSim
interest-evolution env.
"""

from __future__ import annotations

import copy
import os
import pickle
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import (AlgorithmConfig,
                                                  learner_gpus)
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.models import _dense, _generator
from ray_tpu_torch.rllib.policy import Adam, _to_numpy, _to_tensors


class SlateQConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.gamma = 0.95
        self.train_batch_size = 64
        self.replay_buffer_capacity = 20_000
        self.hiddens = (64, 64)
        self.target_network_update_freq = 300
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_timesteps = 5_000
        self.num_steps_sampled_before_learning_starts = 500
        self.rollout_episodes_per_step = 4
        self.updates_per_step = 4

    @property
    def algo_class(self):
        return SlateQ


class SimpleRecEnv:
    """Slate recommendation env: each step presents ``num_docs``
    candidate docs (topic vectors); the agent picks a ``slate_size``
    slate; the user clicks per a softmax choice model over affinity
    (with a no-click option) and the interest vector drifts toward the
    clicked doc.  Reward = click relevance; episode = user budget."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.num_docs = int(config.get("num_docs", 10))
        self.slate_size = int(config.get("slate_size", 3))
        self.topic_dim = int(config.get("topic_dim", 4))
        self.horizon = int(config.get("horizon", 20))
        self._rng = np.random.default_rng(config.get("seed"))
        self.obs_dim = self.topic_dim + self.num_docs * self.topic_dim

    def _docs(self) -> np.ndarray:
        d = self._rng.normal(size=(self.num_docs, self.topic_dim))
        return (d / np.linalg.norm(d, axis=1, keepdims=True)) \
            .astype(np.float32)

    def _obs(self) -> np.ndarray:
        return np.concatenate(
            [self.interest, self.docs.ravel()]).astype(np.float32)

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        v = self._rng.normal(size=self.topic_dim)
        self.interest = (v / np.linalg.norm(v)).astype(np.float32)
        self.docs = self._docs()
        self.t = 0
        return self._obs(), {}

    def choice_probs(self, slate: np.ndarray) -> np.ndarray:
        """P(click doc | slate) + trailing no-click prob."""
        aff = self.docs[slate] @ self.interest  # [slate]
        logits = np.concatenate([2.0 * aff, [0.0]])  # no-click logit 0
        e = np.exp(logits - logits.max())
        return e / e.sum()

    def step(self, slate):
        slate = np.asarray(slate, np.int64)[:self.slate_size]
        probs = self.choice_probs(slate)
        pick = self._rng.choice(len(probs), p=probs)
        if pick < len(slate):
            doc = self.docs[slate[pick]]
            reward = float(doc @ self.interest)
            drift = self.interest + 0.2 * doc
            self.interest = (drift / np.linalg.norm(drift)) \
                .astype(np.float32)
        else:
            reward = 0.0
        self.t += 1
        self.docs = self._docs()
        done = self.t >= self.horizon
        return self._obs(), reward, False, done, {"clicked": int(pick)}


class _ItemQNet(nn.Module):
    """Per-item Q(s, doc): user state ⊕ doc features -> scalar; ReLU
    torso ``fc_<i>`` and ``out``, flax's names and init."""

    def __init__(self, topic_dim: int, hiddens: Tuple[int, ...] = (64, 64),
                 seed: int = 0):
        super().__init__()
        gen = _generator(seed)
        self.hiddens = tuple(int(h) for h in hiddens)
        sizes = (2 * topic_dim,) + self.hiddens
        for i in range(len(self.hiddens)):
            self.add_module(f"fc_{i}", _dense(sizes[i], sizes[i + 1], gen))
        self.out = _dense(sizes[-1], 1, gen)

    def forward(self, state: torch.Tensor, doc: torch.Tensor
                ) -> torch.Tensor:
        x = torch.cat([state, doc], dim=-1)
        for i in range(len(self.hiddens)):
            x = F.relu(getattr(self, f"fc_{i}")(x))
        return self.out(x)[..., 0]


def top_k_indices(x: torch.Tensor, k: int) -> torch.Tensor:
    """``jax.lax.top_k(x, k)[1]`` along the last axis: the k largest,
    in descending order, equals in index order."""
    return torch.sort(x, dim=-1, descending=True, stable=True)[1][..., :k]


class SlateQLearner:
    """The item-Q network, its target copy, Adam and the decomposed TD
    update on one device."""

    def __init__(self, topic_dim: int, slate_size: int,
                 config: Dict[str, Any], device=None):
        self.config = config
        self.device = resolve_device(device)
        self.slate_size = int(slate_size)
        self.model = _ItemQNet(topic_dim, tuple(config.get("hiddens",
                                                           (64, 64))),
                               seed=int(config.get("seed", 0) or 0)
                               ).to(self.device)
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        self.opt = Adam(self.model.parameters(),
                        lr=float(config.get("lr", 1e-3)))

    def _item_qs(self, model, state, docs) -> torch.Tensor:
        """state [B,T], docs [B,D,T] -> [B,D]."""
        b, d, t = docs.shape
        s = state[:, None].expand(b, d, t).reshape(b * d, t)
        return model(s, docs.reshape(b * d, t)).reshape(b, d)

    def _score(self, state, docs) -> torch.Tensor:
        with torch.no_grad():
            return self._item_qs(self.model, state, docs)

    def score(self, state: np.ndarray, docs: np.ndarray) -> np.ndarray:
        """One user state's item Qs over its candidate docs, on the
        host."""
        t = lambda x: torch.as_tensor(x[None], device=self.device)  # noqa
        return self._score(t(state), t(docs))[0].cpu().numpy()

    def _target(self, batch) -> torch.Tensor:
        """SlateQ's decomposed target: the next state's greedy slate is
        top-k by choice-weighted Q; its value is the choice-probability
        mixture of per-item Qs (+ no-click 0)."""
        gamma = float(self.config.get("gamma", 0.95))
        k = self.slate_size
        with torch.no_grad():
            q_next = self._item_qs(self.target_model, batch["next_state"],
                                   batch["next_docs"])  # [B,D]
            aff_next = torch.einsum("bdt,bt->bd", batch["next_docs"],
                                    batch["next_state"])
            top = top_k_indices(q_next * torch.sigmoid(aff_next), k)
            q_top = torch.gather(q_next, 1, top)
            aff_top = torch.gather(aff_next, 1, top)
            logits = torch.cat([2.0 * aff_top,
                                torch.zeros_like(aff_top[:, :1])], dim=1)
            probs = F.softmax(logits, dim=1)
            v_next = torch.sum(probs[:, :k] * q_top, dim=1)
            return batch["reward"] + gamma * (1.0 - batch["done"]) * v_next

    def _update(self, batch: Dict[str, torch.Tensor]):
        """One Adam step; returns (loss, mean |td|).  Only the clicked
        item's Q trains (no-click steps train nothing — their value flows
        through the bootstrap)."""
        target = self._target(batch)
        q_clicked = self.model(batch["state"], batch["clicked_doc"])
        td = (q_clicked - target) * batch["click_mask"]
        denom = torch.clamp(batch["click_mask"].sum(), min=1.0)
        loss = torch.sum(td ** 2) / denom
        self.opt.zero_grad(set_to_none=False)
        loss.backward()
        self.opt.step()
        return loss.detach(), torch.sum(torch.abs(td.detach())) / denom

    def update(self, batch: Dict[str, np.ndarray]):
        """:meth:`_update` on numpy columns; the stats stay on the
        device."""
        return self._update({k: torch.as_tensor(v, device=self.device)
                             for k, v in batch.items()})

    def sync_target(self) -> None:
        self.target_model.load_state_dict(self.model.state_dict())

    def get_state(self) -> Dict[str, Any]:
        return {"weights": _to_numpy(self.model.state_dict()),
                "target_weights": _to_numpy(self.target_model.state_dict()),
                "opt_state": _to_numpy(self.opt.state_dict())}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(_to_tensors(state["weights"]))
        self.target_model.load_state_dict(
            _to_tensors(state["target_weights"]))
        if "opt_state" in state:
            self.opt.load_state_dict(_to_tensors(state["opt_state"]))


class SlateQ(Algorithm):
    def setup(self) -> None:
        cfg = self.config
        env_config = dict(cfg.get("env_config", {}))
        env = cfg["env"]
        self.env = (SimpleRecEnv(env_config) if env in
                    ("SimpleRecEnv", SimpleRecEnv, None)
                    else make_env(env, env_config))
        self.num_docs = self.env.num_docs
        self.slate_size = self.env.slate_size
        self.topic_dim = self.env.topic_dim
        self.learner = SlateQLearner(
            self.topic_dim, self.slate_size, cfg,
            device=None if learner_gpus(cfg) else "cpu")
        self._replay: deque = deque(
            maxlen=int(cfg.get("replay_buffer_capacity", 20_000)))
        self._np_rng = np.random.default_rng(int(cfg.get("seed", 0) or 0))
        self._since_target = 0
        self._pending_returns: List[float] = []
        self._pending_lens: List[int] = []

    def get_policy(self, policy_id: Optional[str] = None) -> SlateQLearner:
        return self.learner

    # -- acting ---------------------------------------------------------
    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._timesteps_total
                   / float(cfg.get("epsilon_timesteps", 5_000)))
        return float(cfg.get("epsilon_initial", 1.0)) + frac * (
            float(cfg.get("epsilon_final", 0.05))
            - float(cfg.get("epsilon_initial", 1.0)))

    def _build_slate(self, state, docs, explore: bool) -> np.ndarray:
        if explore and self._np_rng.random() < self._epsilon():
            return self._np_rng.choice(self.num_docs, self.slate_size,
                                       replace=False)
        q = self.learner.score(state, docs)
        aff = docs @ state
        score = q * (1.0 / (1.0 + np.exp(-aff)))
        return np.argsort(-score)[:self.slate_size]

    def _split_obs(self, obs: np.ndarray):
        state = obs[:self.topic_dim]
        docs = obs[self.topic_dim:].reshape(self.num_docs, self.topic_dim)
        return state, docs

    def _run_episode(self, explore: bool = True) -> Tuple[float, int]:
        obs, _ = self.env.reset()
        total, steps = 0.0, 0
        while True:
            state, docs = self._split_obs(np.asarray(obs, np.float32))
            slate = self._build_slate(state, docs, explore)
            obs, rew, term, trunc, info = self.env.step(slate)
            next_state, next_docs = self._split_obs(
                np.asarray(obs, np.float32))
            clicked = info.get("clicked", self.slate_size)
            if clicked < self.slate_size:
                clicked_doc = docs[slate[clicked]]
                click_mask = 1.0
            else:
                clicked_doc = np.zeros(self.topic_dim, np.float32)
                click_mask = 0.0
            done = bool(term or trunc)
            self._replay.append((state, clicked_doc, click_mask,
                                 float(rew), next_state, next_docs,
                                 float(done)))
            total += float(rew)
            steps += 1
            self._timesteps_total += 1
            self._since_target += 1
            if done:
                return total, steps

    def _replay_batch(self, bs: int) -> Dict[str, np.ndarray]:
        idx = self._np_rng.integers(0, len(self._replay), bs)
        rows = [self._replay[i] for i in idx]
        f32 = lambda j: np.asarray([r[j] for r in rows],  # noqa: E731
                                   np.float32)
        return {"state": np.stack([r[0] for r in rows]),
                "clicked_doc": np.stack([r[1] for r in rows]),
                "click_mask": f32(2), "reward": f32(3),
                "next_state": np.stack([r[4] for r in rows]),
                "next_docs": np.stack([r[5] for r in rows]),
                "done": f32(6)}

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
            for _ in range(int(cfg.get("updates_per_step", 4))):
                loss, td_abs = self.learner.update(self._replay_batch(bs))
            stats["loss"] = float(loss)
            stats["td_error_abs"] = float(td_abs)
            if self._since_target >= int(
                    cfg.get("target_network_update_freq", 300)):
                self.learner.sync_target()
                self._since_target = 0
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
        learner = self.learner
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "wb") as f:
            pickle.dump({
                "params": _to_numpy(learner.model.state_dict()),
                "target_params": _to_numpy(
                    learner.target_model.state_dict()),
                "iteration": self.iteration,
                "timesteps_total": self._timesteps_total,
            }, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        self.learner.model.load_state_dict(_to_tensors(state["params"]))
        self.learner.target_model.load_state_dict(
            _to_tensors(state["target_params"]))
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]

    def stop(self) -> None:
        pass
