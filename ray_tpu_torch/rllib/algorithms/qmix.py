"""QMIX: monotonic value factorisation for cooperative multi-agent RL.

Parity: reference ``rllib/algorithms/qmix/`` — per-agent Q-networks whose
chosen-action values feed a state-conditioned *mixing hypernetwork* with
non-negative weights, so argmax of each agent's Q is also argmax of
Q_tot (the monotonicity constraint), trained end-to-end with a DQN-style
TD target.  The agents, the mixer, their target copy and Adam live on
the learner's device (the card unless ``num_gpus_per_learner=0``); one
update is one forward of both, one backward and one Adam step there.

Like the reference (``qmix_policy.py`` trains RNN agents over episode
batches), agents are RECURRENT by default: a shared GRU cell (flax's,
:class:`ray_tpu_torch.rllib.models.GRUCell`) unrolled over whole
episodes drawn from episode-level replay, with hidden states threaded
through sampling and zero-padded sequence training.  Set
``recurrent=False`` for the feed-forward/transition-replay variant
(cheaper on fully-observed team envs).  Sampling drives the env inline
in ``training_step`` — cooperative team envs step as one unit, so there
is no per-agent fleet to fan out; epsilon-greedy choices and replay
indices are numpy draws from ``default_rng(seed)``.
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
import torch.nn.functional as F

from ray_tpu_torch import _port
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import (AlgorithmConfig,
                                                  learner_gpus)
from ray_tpu_torch.rllib.env import MultiAgentEnv, make_env
from ray_tpu_torch.rllib.models import GRUCell, _dense, _generator
from ray_tpu_torch.rllib.policy import Adam, _to_numpy, _to_tensors


class QMixConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.gamma = 0.99
        self.train_batch_size = 32
        self.replay_buffer_capacity = 10_000
        self.mixing_embed_dim = 32
        self.hypernet_hiddens = 64
        self.agent_hiddens = (64,)
        self.target_network_update_freq = 200  # env steps
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_timesteps = 5_000
        self.num_steps_sampled_before_learning_starts = 200
        self.rollout_episodes_per_step = 8
        #: GRU agents over episode replay (reference default); False =
        #: feed-forward agents over transition replay
        self.recurrent = True
        self.agent_gru_hidden = 64

    @property
    def algo_class(self):
        return QMix


class _AgentQNet(nn.Module):
    """Shared per-agent Q-network: (obs ⊕ one-hot agent id) -> Q[a]."""

    def __init__(self, obs_dim: int, num_actions: int,
                 hiddens: Sequence[int], gen: torch.Generator):
        super().__init__()
        self.n_hidden = len(hiddens)
        for i, h in enumerate(hiddens):
            self.add_module(f"fc_{i}", _dense(obs_dim, h, gen))
            obs_dim = h
        self.q_out = _dense(obs_dim, num_actions, gen)

    def forward(self, obs_id: torch.Tensor) -> torch.Tensor:
        x = obs_id
        for i in range(self.n_hidden):
            x = torch.relu(getattr(self, f"fc_{i}")(x))
        return self.q_out(x)


class _Mixer(nn.Module):
    """State-conditioned monotonic mixer (QMIX eq. 4-6): Q_tot =
    w2(s)·elu(w1(s)·q + b1(s)) + b2(s) with w1, w2 ≥ 0 via abs()."""

    def __init__(self, n_agents: int, state_dim: int, embed_dim: int,
                 hypernet_hiddens: int, gen: torch.Generator):
        super().__init__()
        self.n_agents, self.embed_dim = n_agents, embed_dim
        self.hyper_w1 = _dense(state_dim, n_agents * embed_dim, gen)
        self.hyper_b1 = _dense(state_dim, embed_dim, gen)
        self.hyper_w2 = _dense(state_dim, embed_dim, gen)
        self.hyper_b2_in = _dense(state_dim, hypernet_hiddens, gen)
        self.hyper_b2_out = _dense(hypernet_hiddens, 1, gen)

    def forward(self, agent_qs: torch.Tensor,
                state: torch.Tensor) -> torch.Tensor:
        # agent_qs [B, n], state [B, state_dim]
        b = agent_qs.shape[0]
        w1 = torch.abs(self.hyper_w1(state)).reshape(
            b, self.n_agents, self.embed_dim)
        b1 = self.hyper_b1(state)
        hidden = F.elu(torch.einsum("bn,bne->be", agent_qs, w1) + b1)
        w2 = torch.abs(self.hyper_w2(state))
        v = self.hyper_b2_in(state)
        b2 = self.hyper_b2_out(torch.relu(v))[:, 0]
        return torch.einsum("be,be->b", hidden, w2) + b2


class _RecurrentAgentQNet(nn.Module):
    """Shared GRU agent (reference ``RNNAgent``): per step,
    (carry, obs ⊕ id) -> (carry', Q[a])."""

    def __init__(self, obs_dim: int, num_actions: int, hidden: int,
                 gen: torch.Generator):
        super().__init__()
        self.fc_in = _dense(obs_dim, hidden, gen)
        self.gru = GRUCell(hidden, hidden, gen)
        self.q_out = _dense(hidden, num_actions, gen)

    def forward(self, carry: torch.Tensor, obs_seq: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """carry [B, n, H], obs_seq [B, T, n, D] -> (carry, Q [B, T, n,
        A]): flax's ``nn.scan`` over axis 1 as a loop."""
        x = torch.relu(self.fc_in(obs_seq))
        outs = []
        for t in range(obs_seq.shape[1]):
            carry = self.gru(carry, x[:, t])
            outs.append(carry)
        return carry, self.q_out(torch.stack(outs, dim=1))


class _RecurrentQMixModel(nn.Module):
    """GRU agents unrolled over episodes + monotonic mixer.  The one
    agent instance serves acting (T=1) and the unroll."""

    def __init__(self, n_agents: int, obs_dim: int, state_dim: int,
                 num_actions: int, gru_hidden: int, embed_dim: int,
                 hypernet_hiddens: int, seed: int = 0):
        super().__init__()
        gen = _generator(seed)
        self.n_agents, self.gru_hidden = n_agents, gru_hidden
        self.agent = _RecurrentAgentQNet(obs_dim, num_actions, gru_hidden,
                                         gen)
        self.mixer = _Mixer(n_agents, state_dim, embed_dim,
                            hypernet_hiddens, gen)

    def init_carry(self, batch: int, device=None) -> torch.Tensor:
        return torch.zeros((batch, self.n_agents, self.gru_hidden),
                           device=device)

    def agent_step(self, carry: torch.Tensor, obs: torch.Tensor):
        """One acting step: carry [B,n,H], obs [B,n,D] -> q [B,n,A]."""
        carry, q = self.agent(carry, obs[:, None])
        return carry, q[:, 0]

    def unroll(self, obs_seq: torch.Tensor) -> torch.Tensor:
        """[B,T,n,D] -> per-step agent Qs [B,T,n,A] from zero carries."""
        carry = self.init_carry(obs_seq.shape[0], obs_seq.device)
        return self.agent(carry, obs_seq)[1]

    def mix(self, chosen_qs: torch.Tensor, state: torch.Tensor):
        """chosen_qs [B,n], state [B,S] -> Q_tot [B]."""
        return self.mixer(chosen_qs, state)


class _QMixModel(nn.Module):
    def __init__(self, n_agents: int, obs_dim: int, state_dim: int,
                 num_actions: int, agent_hiddens: Sequence[int],
                 embed_dim: int, hypernet_hiddens: int, seed: int = 0):
        super().__init__()
        gen = _generator(seed)
        self.agent = _AgentQNet(obs_dim, num_actions, agent_hiddens, gen)
        self.mixer = _Mixer(n_agents, state_dim, embed_dim,
                            hypernet_hiddens, gen)

    def agent_qs(self, obs: torch.Tensor) -> torch.Tensor:
        """obs [B, n, obs_dim+n] (agent one-hot appended) -> [B, n, A]."""
        return self.agent(obs)

    def q_tot(self, obs: torch.Tensor, actions: torch.Tensor,
              state: torch.Tensor) -> torch.Tensor:
        q = self.agent(obs)  # [B, n, A]
        chosen = torch.gather(q, -1, actions.long()[..., None])[..., 0]
        return self.mixer(chosen, state)

    def q_tot_target(self, obs: torch.Tensor,
                     state: torch.Tensor) -> torch.Tensor:
        """max over per-agent actions (decentralised argmax = joint
        argmax under monotonicity), mixed."""
        return self.mixer(self.agent(obs).amax(dim=-1), state)


class QMixLearner:
    """The agents and mixer, their target copy, Adam and the TD update
    on one device."""

    def __init__(self, n_agents: int, obs_dim: int, state_dim: int,
                 num_actions: int, config: Dict[str, Any], device=None):
        self.config = config
        self.device = resolve_device(device)
        self.recurrent = bool(config.get("recurrent", True))
        seed = int(config.get("seed", 0) or 0)
        embed = int(config.get("mixing_embed_dim", 32))
        hyper = int(config.get("hypernet_hiddens", 64))
        if self.recurrent:
            self.model = _RecurrentQMixModel(
                n_agents, obs_dim, state_dim, num_actions,
                int(config.get("agent_gru_hidden", 64)), embed, hyper, seed)
        else:
            self.model = _QMixModel(
                n_agents, obs_dim, state_dim, num_actions,
                tuple(config.get("agent_hiddens", (64,))), embed, hyper,
                seed)
        self.model.to(self.device)
        self.target_model = copy.deepcopy(self.model)
        self.opt = Adam(self.model.parameters(),
                        lr=float(config.get("lr", 5e-4)))
        self.gamma = float(config.get("gamma", 0.99))

    def tensors(self, batch: Dict[str, np.ndarray]
                ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def sync_target(self) -> None:
        """The target takes a copy of the current weights."""
        self.target_model.load_state_dict(self.model.state_dict())

    # -- acting ---------------------------------------------------------
    def initial_carry(self) -> torch.Tensor:
        return self.model.init_carry(1, self.device)

    def agent_step(self, carry: torch.Tensor, obs: np.ndarray
                   ) -> Tuple[torch.Tensor, np.ndarray]:
        """The GRU agents' step on obs [1, n, D]: the new carry (on the
        device) and the Qs on the host."""
        with torch.no_grad():
            carry, q = self.model.agent_step(
                carry, torch.as_tensor(obs, device=self.device))
        return carry, q.cpu().numpy()

    def agent_qs(self, obs: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            return self.model.agent_qs(torch.as_tensor(
                obs, device=self.device)).cpu().numpy()

    # -- learning -------------------------------------------------------
    def _loss(self, batch: Dict[str, torch.Tensor]):
        model, target_model = self.model, self.target_model
        if not self.recurrent:
            q_tot = model.q_tot(batch["obs"], batch["actions"],
                                batch["state"])
            with torch.no_grad():
                q_next = target_model.q_tot_target(batch["next_obs"],
                                                   batch["next_state"])
                target = batch["rewards"] + self.gamma \
                    * (1.0 - batch["dones"]) * q_next
            td = q_tot - target
            return torch.mean(td ** 2), torch.mean(torch.abs(td))
        # obs_seq [B,T+1,n,D]; step t consumes obs_t, the target consumes
        # obs_{t+1} from the SAME unroll — hidden states stay aligned
        # with their episodes
        n = model.n_agents
        q_seq = model.unroll(batch["obs_seq"])
        B, tp1 = q_seq.shape[:2]
        T = tp1 - 1
        chosen = torch.gather(q_seq[:, :-1], -1,
                              batch["actions"].long()[..., None])[..., 0]
        q_tot = model.mix(
            chosen.reshape(B * T, n),
            batch["state_seq"][:, :-1].reshape(B * T, -1)).reshape(B, T)
        with torch.no_grad():
            tq = target_model.unroll(batch["obs_seq"])
            t_tot = target_model.mix(
                tq[:, 1:].amax(dim=-1).reshape(B * T, n),
                batch["state_seq"][:, 1:].reshape(B * T, -1)
            ).reshape(B, T)
            target = batch["rewards"] + self.gamma \
                * (1.0 - batch["dones"]) * t_tot
        mask = batch["mask"]
        td = (q_tot - target) * mask
        denom = torch.clamp(mask.sum(), min=1.0)
        return (td ** 2).sum() / denom, torch.abs(td).sum() / denom

    def _update(self, batch: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One Adam step on the TD loss; returns (loss, mean |td|)."""
        loss, td_abs = self._loss(batch)
        self.opt.zero_grad(set_to_none=False)
        loss.backward()
        self.opt.step()
        return loss.detach(), td_abs.detach()

    def update(self, batch: Dict[str, np.ndarray]
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """:meth:`_update` on numpy columns; the losses stay on the
        device."""
        return self._update(self.tensors(batch))

    def get_state(self) -> Dict[str, Any]:
        return {"weights": _to_numpy(self.model.state_dict()),
                "target": _to_numpy(self.target_model.state_dict()),
                "opt_state": _to_numpy(self.opt.state_dict())}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(_to_tensors(state["weights"]))
        self.target_model.load_state_dict(_to_tensors(state["target"]))
        if "opt_state" in state:
            self.opt.load_state_dict(_to_tensors(state["opt_state"]))


class QMix(Algorithm):
    """Inline-sampling cooperative learner (no rollout fleet)."""

    supports_multi_agent = True

    def setup(self) -> None:
        cfg = self.config
        _port.reject_tpu_options("QMix", cfg)
        self.env = make_env(cfg["env"], dict(cfg.get("env_config", {})))
        if not isinstance(self.env, MultiAgentEnv):
            raise ValueError("QMIX requires a MultiAgentEnv")
        self.agent_ids: List[Any] = list(self.env.agent_ids)
        n = len(self.agent_ids)
        act_space = self.env.action_space_for(self.agent_ids[0])
        obs_space = self.env.observation_space_for(self.agent_ids[0])
        self.n_agents = n
        self.num_actions = int(act_space.n)
        obs_dim = int(np.prod(obs_space.shape)) + n  # + agent one-hot
        state_fn = getattr(self.env, "global_state", None)
        self._state_dim = (len(state_fn()) if state_fn is not None
                           else obs_dim * n)
        self.recurrent = bool(cfg.get("recurrent", True))
        self.learner = QMixLearner(
            n, obs_dim, self._state_dim, self.num_actions, cfg,
            device=None if learner_gpus(cfg) else "cpu")
        self._replay: deque = deque(
            maxlen=int(cfg.get("replay_buffer_capacity", 10_000)))
        self._np_rng = np.random.default_rng(int(cfg.get("seed", 0) or 0))
        self._since_target = 0
        self._pending_returns: List[float] = []
        self._pending_lens: List[int] = []

    def get_policy(self, policy_id: Optional[str] = None) -> QMixLearner:
        return self.learner

    # -- sampling -------------------------------------------------------
    def _stack_obs(self, obs: Dict[Any, np.ndarray]) -> np.ndarray:
        """[n, obs_dim + n] with agent one-hot appended."""
        rows = []
        for i, aid in enumerate(self.agent_ids):
            one_hot = np.zeros(self.n_agents, np.float32)
            one_hot[i] = 1.0
            rows.append(np.concatenate(
                [np.asarray(obs[aid], np.float32).ravel(), one_hot]))
        return np.stack(rows)

    def _global_state(self, stacked_obs: np.ndarray) -> np.ndarray:
        fn = getattr(self.env, "global_state", None)
        if fn is not None:
            return np.asarray(fn(), np.float32)
        return stacked_obs.ravel()

    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._timesteps_total
                   / float(cfg.get("epsilon_timesteps", 5_000)))
        e0 = float(cfg.get("epsilon_initial", 1.0))
        e1 = float(cfg.get("epsilon_final", 0.05))
        return e0 + frac * (e1 - e0)

    def _choose(self, q: np.ndarray, explore: bool) -> np.ndarray:
        actions = q.argmax(axis=-1)
        if explore:
            eps = self._epsilon()
            mask = self._np_rng.random(self.n_agents) < eps
            rand = self._np_rng.integers(0, self.num_actions,
                                         self.n_agents)
            actions = np.where(mask, rand, actions)
        return actions

    def _run_episode(self, explore: bool = True) -> Tuple[float, int]:
        obs, _ = self.env.reset()
        total, steps = 0.0, 0
        if self.recurrent:
            carry = self.learner.initial_carry()
            ep_obs, ep_state, ep_act, ep_rew, ep_done = [], [], [], [], []
            while True:
                stacked = self._stack_obs(obs)
                state = self._global_state(stacked)
                carry, q = self.learner.agent_step(carry, stacked[None])
                actions = self._choose(q[0], explore)
                action_dict = {aid: int(a) for aid, a in
                               zip(self.agent_ids, actions)}
                obs, rews, terms, truncs, _ = self.env.step(action_dict)
                rew = float(sum(rews.values()))
                done = bool(terms.get("__all__") or truncs.get("__all__"))
                ep_obs.append(stacked)
                ep_state.append(state)
                ep_act.append(actions.astype(np.int64))
                ep_rew.append(rew)
                ep_done.append(float(done))
                total += rew
                steps += 1
                self._timesteps_total += 1
                self._since_target += 1
                if done:
                    final = self._stack_obs(obs)
                    ep_obs.append(final)
                    ep_state.append(self._global_state(final))
                    self._replay.append({
                        "obs_seq": np.stack(ep_obs),      # [T+1, n, D]
                        "state_seq": np.stack(ep_state),  # [T+1, S]
                        "actions": np.stack(ep_act),      # [T, n]
                        "rewards": np.asarray(ep_rew, np.float32),
                        "dones": np.asarray(ep_done, np.float32),
                    })
                    return total, steps
        while True:
            stacked = self._stack_obs(obs)
            state = self._global_state(stacked)
            q = self.learner.agent_qs(stacked[None])[0]  # [n, A]
            actions = self._choose(q, explore)
            action_dict = {aid: int(a) for aid, a in
                           zip(self.agent_ids, actions)}
            obs, rews, terms, truncs, _ = self.env.step(action_dict)
            rew = float(sum(rews.values()))
            done = bool(terms.get("__all__") or truncs.get("__all__"))
            next_stacked = self._stack_obs(obs)
            self._replay.append(
                (stacked, state, actions.astype(np.int64), rew,
                 next_stacked, self._global_state(next_stacked),
                 float(done)))
            total += rew
            steps += 1
            self._timesteps_total += 1
            self._since_target += 1
            if done:
                return total, steps

    # -- training -------------------------------------------------------
    def _learn(self, batch: Dict[str, np.ndarray],
               stats: Dict[str, Any]) -> None:
        loss, td_abs = self.learner.update(batch)
        stats["loss"] = float(loss)
        stats["td_error_abs"] = float(td_abs)
        if self._since_target >= int(
                self.config.get("target_network_update_freq", 200)):
            self.learner.sync_target()
            self._since_target = 0

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        for _ in range(int(cfg.get("rollout_episodes_per_step", 8))):
            ret, length = self._run_episode()
            self._pending_returns.append(ret)
            self._pending_lens.append(length)
        stats: Dict[str, Any] = {"replay_size": len(self._replay)}
        warmup = int(cfg.get("num_steps_sampled_before_learning_starts",
                             200))
        bs = int(cfg.get("train_batch_size", 32))
        if self.recurrent:
            if len(self._replay) >= bs and \
                    self._timesteps_total >= warmup:
                idx = self._np_rng.integers(0, len(self._replay), bs)
                episodes = [self._replay[i] for i in idx]
                self._learn(self._pad_episode_batch(episodes), stats)
            return stats
        if len(self._replay) >= max(warmup, bs):
            idx = self._np_rng.integers(0, len(self._replay), bs)
            rows = [self._replay[i] for i in idx]
            self._learn({
                "obs": np.stack([r[0] for r in rows]),
                "state": np.stack([r[1] for r in rows]),
                "actions": np.stack([r[2] for r in rows]),
                "rewards": np.asarray([r[3] for r in rows], np.float32),
                "next_obs": np.stack([r[4] for r in rows]),
                "next_state": np.stack([r[5] for r in rows]),
                "dones": np.asarray([r[6] for r in rows], np.float32),
            }, stats)
        return stats

    def _pad_episode_batch(self, episodes: List[Dict[str, np.ndarray]]
                           ) -> Dict[str, np.ndarray]:
        """Zero-pad variable-length episodes to a power-of-two horizon
        (the JAX package's bound on recompiles, kept for equal batches)
        with a validity mask over real steps."""
        max_t = max(ep["rewards"].shape[0] for ep in episodes)
        pad_t = 1 << (max_t - 1).bit_length() if max_t > 1 else 1
        B = len(episodes)
        n = self.n_agents
        d = episodes[0]["obs_seq"].shape[-1]
        s = episodes[0]["state_seq"].shape[-1]
        obs = np.zeros((B, pad_t + 1, n, d), np.float32)
        state = np.zeros((B, pad_t + 1, s), np.float32)
        acts = np.zeros((B, pad_t, n), np.int64)
        rews = np.zeros((B, pad_t), np.float32)
        dones = np.ones((B, pad_t), np.float32)  # padding counts "done"
        mask = np.zeros((B, pad_t), np.float32)
        for i, ep in enumerate(episodes):
            t = ep["rewards"].shape[0]
            obs[i, :t + 1] = ep["obs_seq"]
            state[i, :t + 1] = ep["state_seq"]
            acts[i, :t] = ep["actions"]
            rews[i, :t] = ep["rewards"]
            dones[i, :t] = ep["dones"]
            mask[i, :t] = 1.0
        return {"obs_seq": obs, "state_seq": state, "actions": acts,
                "rewards": rews, "dones": dones, "mask": mask}

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
                "params": _to_numpy(self.learner.model.state_dict()),
                "target_params": _to_numpy(
                    self.learner.target_model.state_dict()),
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
