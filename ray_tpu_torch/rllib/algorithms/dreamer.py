"""Dreamer: model-based RL — learn a latent world model, train the
policy in imagination.

Parity: reference ``rllib/algorithms/dreamer/`` (DreamerV1): an RSSM
world model (deterministic GRU path + stochastic latent) trained on
replayed sequences with reconstruction, reward, and KL losses; an actor
and a value function trained on imagined latent rollouts with
lambda-returns.  Vector observations take dense heads, images (rank-3
observations) a convolutional encoder and a transposed-convolution
decoder.

The world model, actor, critic and their three Adams live on the
learner's device (the card unless ``num_gpus_per_learner=0``).  The
JAX package's ``lax.scan`` s are loops here: the posterior walk over a
replayed sequence, the imagination over the horizon, and the λ-return,
a reverse scan.  Every random draw of the device code (the latents'
normal noise, the actions' Gumbel noise) comes from one method,
:meth:`DreamerLearner._draws`.  Acting is one posterior filter step and
one actor sample on the device per env step, and one copy of the action
to the host.
"""

from __future__ import annotations

import os
import pickle
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ray_tpu_torch import _port
from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.conv import conv2d_same, lecun_normal_
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import (AlgorithmConfig,
                                                  learner_gpus)
from ray_tpu_torch.rllib.env import Discrete, make_env
from ray_tpu_torch.rllib.models import GRUCell, _dense, _generator
from ray_tpu_torch.rllib.policy import Adam, _to_numpy, _to_tensors


class DreamerConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.model_lr = 3e-4
        self.actor_lr = 8e-5
        self.critic_lr = 8e-5
        self.gamma = 0.99
        self.lambda_ = 0.95
        self.deter_size = 64
        self.stoch_size = 16
        self.hidden_size = 64
        self.batch_size = 16
        self.batch_length = 20
        self.imagine_horizon = 10
        self.free_nats = 1.0
        self.kl_scale = 1.0
        self.replay_buffer_capacity = 500  # episodes
        self.prefill_episodes = 5
        self.rollout_episodes_per_step = 1
        self.train_iters_per_step = 20
        self.explore_noise = 0.3  # epsilon for discrete actions

    @property
    def algo_class(self):
        return Dreamer


class _Conv(nn.Module):
    """flax ``nn.Conv`` (SAME, with bias) or ``nn.ConvTranspose`` (SAME,
    with bias) of a 4x4 kernel at stride 2 on NCHW; ``weight [out, in,
    4, 4]`` for the convolution, ``[in, out, 4, 4]`` for the transposed
    one, which holds flax's kernel flipped in both spatial axes
    (``lax.conv_transpose`` does not flip it, ``conv_transpose2d``
    does)."""

    def __init__(self, n_in: int, n_out: int, gen: torch.Generator,
                 transpose: bool = False):
        super().__init__()
        self.transpose = transpose
        shape = (n_in, n_out, 4, 4) if transpose else (n_out, n_in, 4, 4)
        self.weight = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.zeros(n_out))
        lecun_normal_(self.weight, n_in * 16, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.transpose:
            # SAME: twice the input's size
            y = F.conv_transpose2d(x, self.weight, stride=2, padding=1)
        else:
            y = conv2d_same(x, self.weight, 2, x.dtype)
        return y + self.bias[:, None, None]


class _ConvEncoder(nn.Module):
    """Pixel observation embed (DreamerV1's conv stack, scaled to tiny
    grids): flat NHWC pixels -> [*, hidden]."""

    def __init__(self, image_shape: Tuple[int, int, int], hidden: int,
                 gen: torch.Generator):
        super().__init__()
        h, w, c = self.image_shape = tuple(image_shape)
        self.hidden = hidden
        self.conv1 = _Conv(c, 16, gen)
        self.conv2 = _Conv(16, 32, gen)
        self.fc = _dense(h // 4 * (w // 4) * 32, hidden, gen)

    def forward(self, obs_flat: torch.Tensor) -> torch.Tensor:
        lead = obs_flat.shape[:-1]
        x = obs_flat.reshape((-1,) + self.image_shape).permute(0, 3, 1, 2)
        x = torch.relu(self.conv2(torch.relu(self.conv1(x))))
        # flatten as flax does, channels last
        x = x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)
        return F.elu(self.fc(x)).reshape(lead + (self.hidden,))


class _ConvDecoder(nn.Module):
    """Latent features -> flat NHWC pixel reconstruction (transposed
    convs)."""

    def __init__(self, image_shape: Tuple[int, int, int], feat_dim: int,
                 gen: torch.Generator):
        super().__init__()
        h, w, c = self.image_shape = tuple(image_shape)
        self.fc = _dense(feat_dim, h // 4 * (w // 4) * 32, gen)
        self.deconv1 = _Conv(32, 16, gen, transpose=True)
        self.deconv2 = _Conv(16, c, gen, transpose=True)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        h, w, c = self.image_shape
        lead = feat.shape[:-1]
        x = F.elu(self.fc(feat.reshape(-1, feat.shape[-1])))
        x = x.reshape(-1, h // 4, w // 4, 32).permute(0, 3, 1, 2)
        x = self.deconv2(torch.relu(self.deconv1(x)))
        return x.permute(0, 2, 3, 1).reshape(lead + (h * w * c,))


class _MLPHead(nn.Module):
    """flax ``nn.Sequential([Dense(hidden), elu, Dense(out)])``: its
    Denses are ``layers_0`` and ``layers_2``."""

    def __init__(self, n_in: int, hidden: int, n_out: int,
                 gen: torch.Generator):
        super().__init__()
        self.layers_0 = _dense(n_in, hidden, gen)
        self.layers_2 = _dense(hidden, n_out, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers_2(F.elu(self.layers_0(x)))


class _RSSM(nn.Module):
    """Recurrent state-space model: deter (GRU) + stoch (gaussian).

    ``image_shape`` switches the observation heads to the conv
    encoder/decoder pair (reference DreamerV1's pixel path); vector
    envs keep the dense heads."""

    def __init__(self, deter_size: int, stoch_size: int, hidden_size: int,
                 obs_dim: int, num_actions: int,
                 image_shape: Optional[Tuple[int, int, int]] = None,
                 seed: int = 0):
        super().__init__()
        gen = _generator(seed)
        self.deter_size, self.stoch_size = deter_size, stoch_size
        feat = deter_size + stoch_size
        self.gru = GRUCell(hidden_size, deter_size, gen)
        self.pre_gru = _dense(stoch_size + num_actions, hidden_size, gen)
        self.prior = _dense(deter_size, 2 * stoch_size, gen)
        self.post = _dense(deter_size + hidden_size, 2 * stoch_size, gen)
        if image_shape is not None:
            self.obs_embed = _ConvEncoder(image_shape, hidden_size, gen)
            self.decoder = _ConvDecoder(image_shape, feat, gen)
        else:
            self.obs_embed = _dense(obs_dim, hidden_size, gen)
            self.decoder = _MLPHead(feat, hidden_size, obs_dim, gen)
        self.reward_head = _MLPHead(feat, hidden_size, 1, gen)
        self.cont_head = _MLPHead(feat, hidden_size, 1, gen)

    @staticmethod
    def _split(stats: torch.Tensor):
        mean, std = torch.chunk(stats, 2, dim=-1)
        return mean, F.softplus(std) + 0.1

    def prior_step(self, deter, stoch, action):
        """(h, z, a) -> next h and the prior's (mean, std); the prior's
        latent is ``mean + std * noise``."""
        x = F.elu(self.pre_gru(torch.cat([stoch, action], dim=-1)))
        deter = self.gru(deter, x)
        return deter, self._split(self.prior(deter))

    def embed(self, obs: torch.Tensor) -> torch.Tensor:
        """The posterior's observation embedding (elu after the
        embedding net, the conv encoder's own elu included)."""
        return F.elu(self.obs_embed(obs))

    def posterior(self, deter, emb):
        return self._split(self.post(torch.cat([deter, emb], dim=-1)))

    def reward(self, feat):
        return self.reward_head(feat)[..., 0]

    def cont(self, feat):
        return self.cont_head(feat)[..., 0]


class _Head(nn.Module):
    """flax's ``_Head``: ``Dense_0``, ``Dense_1`` with elu, ``Dense_2``."""

    def __init__(self, n_in: int, out: int, hidden: int,
                 gen: torch.Generator):
        super().__init__()
        self.Dense_0 = _dense(n_in, hidden, gen)
        self.Dense_1 = _dense(hidden, hidden, gen)
        self.Dense_2 = _dense(hidden, out, gen)

    def forward(self, x):
        x = F.elu(self.Dense_0(x))
        x = F.elu(self.Dense_1(x))
        return self.Dense_2(x)


def _gumbel(shape, gen: torch.Generator, device) -> torch.Tensor:
    """``-log(-log(u))`` of a uniform on ``[tiny, 1)``, as
    ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(
        torch.clamp(u, min=torch.finfo(torch.float32).tiny)))


class DreamerLearner:
    """The world model, actor, critic, their Adams and both updates on
    one device."""

    def __init__(self, obs_dim: int, num_actions: int,
                 image_shape: Optional[Tuple[int, int, int]],
                 config: Dict[str, Any], device=None):
        self.config = config
        self.device = resolve_device(device)
        seed = int(config.get("seed", 0) or 0)
        deter = int(config.get("deter_size", 64))
        stoch = int(config.get("stoch_size", 16))
        hidden = int(config.get("hidden_size", 64))
        self.num_actions = num_actions
        self.wm = _RSSM(deter, stoch, hidden, obs_dim, num_actions,
                        image_shape, seed).to(self.device)
        gen = _generator(seed + 1)
        self.actor = _Head(deter + stoch, num_actions, hidden,
                           gen).to(self.device)
        self.critic = _Head(deter + stoch, 1, hidden, gen).to(self.device)
        self.wm_opt = Adam(self.wm.parameters(),
                           lr=float(config.get("model_lr", 3e-4)))
        self.actor_opt = Adam(self.actor.parameters(),
                              lr=float(config.get("actor_lr", 8e-5)))
        self.critic_opt = Adam(self.critic.parameters(),
                               lr=float(config.get("critic_lr", 8e-5)))
        self.gamma = float(config.get("gamma", 0.99))
        self.lam = float(config.get("lambda_", 0.95))
        self.horizon = int(config.get("imagine_horizon", 10))
        self.free_nats = float(config.get("free_nats", 1.0))
        self.kl_scale = float(config.get("kl_scale", 1.0))
        self._gen = torch.Generator(device=self.device).manual_seed(seed)

    def _draws(self, kind: str, rows: int, steps: int
               ) -> Dict[str, torch.Tensor]:
        """Every random draw of one call, by use: ``"observe"`` (the
        world-model update's posterior walk): one standard normal ``[steps,
        rows, stoch]``, shared by the prior and posterior of a step, as
        the JAX package's one key a step gives them; ``"imagine"`` (the
        behavior update): Gumbel noise ``[steps, rows, A]`` for the
        actions and normals ``[steps, rows, stoch]`` for the prior
        latents; ``"act"`` (one acting step, ``steps`` 1): a normal
        ``[rows, stoch]`` and Gumbel noise ``[rows, A]``."""
        s, a = self.wm.stoch_size, self.num_actions
        if kind == "observe":
            return {"normal": torch.randn((steps, rows, s),
                                          generator=self._gen,
                                          device=self.device)}
        lead = (steps, rows) if kind == "imagine" else (rows,)
        return {"gumbel": _gumbel(lead + (a,), self._gen, self.device),
                "normal": torch.randn(lead + (s,), generator=self._gen,
                                      device=self.device)}

    def tensors(self, batch: Dict[str, np.ndarray]
                ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    # -- world model ----------------------------------------------------
    def _observe(self, obs_seq, act_seq, normal):
        """The posterior walk over [B, T, ...]: deter, stoch and both
        distributions' stats, each [B, T, ...]."""
        wm = self.wm
        batch, steps = obs_seq.shape[:2]
        emb = wm.embed(obs_seq)
        deter = obs_seq.new_zeros((batch, wm.deter_size))
        stoch = obs_seq.new_zeros((batch, wm.stoch_size))
        outs = []
        for t in range(steps):
            deter, (pm, ps) = wm.prior_step(deter, stoch, act_seq[:, t])
            qm, qs = wm.posterior(deter, emb[:, t])
            stoch = qm + qs * normal[t]
            outs.append((deter, stoch, pm, ps, qm, qs))
        return [torch.stack(o, dim=1) for o in zip(*outs)]

    def _wm_update(self, batch: Dict[str, torch.Tensor],
                   draws: Dict[str, torch.Tensor]):
        mask = batch["mask"]  # [B, T] — zero-padded steps carry no loss
        denom = torch.clamp(mask.sum(), min=1.0)

        def masked_mean(x):
            if x.ndim == 3:
                x = x.mean(-1)
            return (x * mask).sum() / denom

        # actions_onehot[t] is a_{t-1} (zero at sequence start)
        deter, stoch, pm, ps, qm, qs = self._observe(
            batch["obs"], batch["actions_onehot"], draws["normal"])
        feat = torch.cat([deter, stoch], dim=-1)
        recon = self.wm.decoder(feat)
        recon_loss = masked_mean((recon - batch["obs"]) ** 2)
        reward_loss = masked_mean((self.wm.reward(feat)
                                   - batch["rewards"]) ** 2)
        cont, label = self.wm.cont(feat), 1.0 - batch["dones"]
        # optax's sigmoid_binary_cross_entropy
        cont_loss = masked_mean(-label * F.logsigmoid(cont)
                                - (1.0 - label) * F.logsigmoid(-cont))
        kl = (torch.log(ps / qs) + (qs ** 2 + (qm - pm) ** 2)
              / (2 * ps ** 2) - 0.5).sum(-1)
        kl_loss = (torch.clamp(kl, min=self.free_nats) * mask).sum() / denom
        total = recon_loss + reward_loss + cont_loss \
            + self.kl_scale * kl_loss
        self.wm_opt.zero_grad(set_to_none=False)
        total.backward()
        self.wm_opt.step()
        return (total.detach(), recon_loss.detach(), reward_loss.detach(),
                kl_loss.detach(), deter.detach(), stoch.detach())

    def wm_update(self, batch: Dict[str, np.ndarray]):
        """One world-model Adam step on a batch of sequences (numpy):
        (total, recon, reward and KL losses, and the posterior deter and
        stoch of the forward before the step), all on the device."""
        t = self.tensors(batch)
        b, steps = t["mask"].shape
        return self._wm_update(t, self._draws("observe", b, steps))

    # -- behavior -------------------------------------------------------
    def _behavior_update(self, deter, stoch, start_mask, draws):
        """Imagine from (valid) posterior states; train actor+critic.

        Index scheme: s_t := from_feats[t] (t = 0..H-1) is the state
        action a_t is taken FROM; r_t / c_t are the reward/continue
        heads at the arrived state feats[t]; λ-returns G_t sit at s_t
        and bootstrap through V(s_{t+1}) = critic(feats[t])."""
        wm, actor, critic = self.wm, self.actor, self.critic
        horizon = self.horizon
        b, t = deter.shape[0], deter.shape[1]
        weight = start_mask.reshape(b * t)  # padded starts train nothing
        w_denom = torch.clamp(weight.sum() * horizon, min=1.0)
        with torch.no_grad():
            deter_ = deter.reshape(b * t, -1)
            stoch_ = stoch.reshape(b * t, -1)
            in_feats = torch.cat([deter_, stoch_], dim=-1)
            feats, acts = [], []
            for h in range(horizon):
                logits = actor(torch.cat([deter_, stoch_], dim=-1))
                act = torch.argmax(logits + draws["gumbel"][h], dim=-1)
                onehot = F.one_hot(act, self.num_actions).to(deter_.dtype)
                deter_, (mean, std) = wm.prior_step(deter_, stoch_, onehot)
                stoch_ = mean + std * draws["normal"][h]
                feats.append(torch.cat([deter_, stoch_], dim=-1))
                acts.append(act)
            feats = torch.stack(feats)  # [H, BT, F]
            acts = torch.stack(acts)
            from_feats = torch.cat([in_feats[None], feats[:-1]], dim=0)
            rewards = wm.reward(feats)
            conts = torch.sigmoid(wm.cont(feats))
            v_next = critic(feats)[..., 0]  # V(s_{t+1})
            # λ-returns at s_t, bootstrapped through V(s_{t+1}): the
            # JAX package's reverse scan
            nxt, returns = v_next[-1], [None] * horizon
            for h in reversed(range(horizon)):
                nxt = rewards[h] + self.gamma * conts[h] * (
                    (1 - self.lam) * v_next[h] + self.lam * nxt)
                returns[h] = nxt
            returns = torch.stack(returns)  # [H, BT]
        # the critic's values at s_t: its loss's input, and (before its
        # step) the actor's PRE-action baseline V(s_t)
        v = critic(from_feats)[..., 0]
        adv = returns - v.detach()
        # REINFORCE over the imagined trajectory; the logits are computed
        # again on the detached states
        logits = actor(from_feats)
        logp_all = F.log_softmax(logits, dim=-1)
        logp = torch.gather(logp_all, -1, acts[..., None])[..., 0]
        ent = -(F.softmax(logits, dim=-1) * logp_all).sum(-1)
        per_step = -(logp * adv) - 1e-3 * ent
        a_loss = (per_step * weight[None, :]).sum() / w_denom
        c_loss = (((v - returns) ** 2) * weight[None, :]).sum() / w_denom
        self.actor_opt.zero_grad(set_to_none=False)
        self.critic_opt.zero_grad(set_to_none=False)
        a_loss.backward()
        c_loss.backward()
        self.actor_opt.step()
        self.critic_opt.step()
        return a_loss.detach(), c_loss.detach()

    def behavior_update(self, deter: torch.Tensor, stoch: torch.Tensor,
                        start_mask: np.ndarray):
        """One actor and one critic Adam step on imagined rollouts from
        the posterior states ``deter``/``stoch`` [B, T, ...] (on the
        device); returns both losses, on the device."""
        mask = torch.as_tensor(start_mask, device=self.device)
        rows = deter.shape[0] * deter.shape[1]
        return self._behavior_update(
            deter, stoch, mask, self._draws("imagine", rows, self.horizon))

    # -- acting ---------------------------------------------------------
    def initial_state(self):
        """Zero deter, stoch and previous action, on the device."""
        z = lambda n: torch.zeros((1, n), device=self.device)  # noqa: E731
        return z(self.wm.deter_size), z(self.wm.stoch_size), \
            z(self.num_actions)

    def _policy_step(self, deter, stoch, action_onehot, obs, draws):
        """Online acting: posterior filter + actor sample."""
        with torch.no_grad():
            deter, _ = self.wm.prior_step(deter, stoch, action_onehot)
            qm, qs = self.wm.posterior(deter, self.wm.embed(obs))
            stoch = qm + qs * draws["normal"]
            logits = self.actor(torch.cat([deter, stoch], dim=-1))
            action = torch.argmax(logits + draws["gumbel"], dim=-1)
        return deter, stoch, action

    def policy_step(self, deter, stoch, action_onehot, obs: np.ndarray):
        """One acting step on a flat observation ``obs`` [1, D] (numpy):
        the new deter and stoch (on the device) and the action [1]."""
        obs = torch.as_tensor(obs, device=self.device)
        return self._policy_step(deter, stoch, action_onehot, obs,
                                 self._draws("act", 1, 1))

    def get_state(self) -> Dict[str, Any]:
        return {name: _to_numpy(getattr(self, name).state_dict())
                for name in ("wm", "actor", "critic", "wm_opt",
                             "actor_opt", "critic_opt")}

    def set_state(self, state: Dict[str, Any]) -> None:
        for name, value in state.items():
            getattr(self, name).load_state_dict(_to_tensors(value))


class Dreamer(Algorithm):
    def setup(self) -> None:
        cfg = self.config
        _port.reject_tpu_options("Dreamer", cfg)
        self.env = make_env(cfg["env"], dict(cfg.get("env_config", {})))
        if not isinstance(self.env.action_space, Discrete):
            raise ValueError("this Dreamer supports Discrete actions")
        self.num_actions = int(self.env.action_space.n)
        obs_shape = tuple(self.env.observation_space.shape)
        self.obs_dim = int(np.prod(obs_shape))
        # rank-3 observations are images: conv encoder/decoder heads
        # (reference DreamerV1's pixel path); H and W must tile the
        # stride-2x2 conv stack
        image_shape = obs_shape if len(obs_shape) == 3 else None
        if image_shape is not None and (
                image_shape[0] % 4 or image_shape[1] % 4):
            raise ValueError(
                f"image observations need H, W divisible by 4, "
                f"got {image_shape}")
        self.learner = DreamerLearner(
            self.obs_dim, self.num_actions, image_shape, cfg,
            device=None if learner_gpus(cfg) else "cpu")
        self._episodes: deque = deque(
            maxlen=int(cfg.get("replay_buffer_capacity", 500)))
        self._np_rng = np.random.default_rng(int(cfg.get("seed", 0) or 0))
        self._eye = np.eye(self.num_actions, dtype=np.float32)
        self._pending_returns: List[float] = []
        self._pending_lens: List[int] = []

    def get_policy(self, policy_id: Optional[str] = None) -> DreamerLearner:
        return self.learner

    # -- environment interaction ---------------------------------------
    def _run_episode(self, explore: bool = True) -> Tuple[float, int]:
        cfg = self.config
        learner = self.learner
        obs, _ = self.env.reset()
        deter, stoch, prev_onehot = learner.initial_state()
        o_l, a_l, r_l, d_l = [], [], [], []
        total, steps, done = 0.0, 0, False
        while not done and steps < 1000:
            # obs travel FLAT everywhere (replay, RSSM); the conv encoder
            # reshapes to the image internally
            flat = np.asarray(obs, np.float32).ravel()
            deter, stoch, action = learner.policy_step(
                deter, stoch, prev_onehot, flat[None])
            act = int(action.cpu()[0])  # the step's one host sync
            if explore and self._np_rng.random() < float(
                    cfg.get("explore_noise", 0.3)):
                act = int(self._np_rng.integers(self.num_actions))
            nobs, rew, term, trunc, _ = self.env.step(act)
            o_l.append(flat)
            a_l.append(act)
            r_l.append(float(rew))
            d_l.append(bool(term))
            prev_onehot = torch.as_tensor(self._eye[act][None],
                                          device=learner.device)
            obs = nobs
            total += float(rew)
            steps += 1
            self._timesteps_total += 1
            done = bool(term or trunc)
        # terminal observation completes the arrival-aligned sequence
        o_l.append(np.asarray(obs, np.float32).ravel())
        self._episodes.append({
            "obs": np.stack(o_l),  # [T+1, D]
            "actions": np.asarray(a_l, np.int64),    # a_t from obs_t
            "rewards": np.asarray(r_l, np.float32),  # r_t arrives at t+1
            "dones": np.asarray(d_l, np.float32)})
        return total, steps

    def _sample_sequences(self, bs: int, length: int) -> Dict[str, Any]:
        """ARRIVAL-aligned windows (the Dreamer data convention): row t
        holds obs_t, the action that LED to it (a_{t-1}, zero at episode
        start), and the reward/termination that arrived WITH it
        (r_{t-1}/done_{t-1}).  The reward head then predicts a quantity
        its features can actually determine — training it against the
        yet-untaken a_t's reward is unlearnable by construction."""
        obs = np.zeros((bs, length, self.obs_dim), np.float32)
        act = np.zeros((bs, length, self.num_actions), np.float32)
        rew = np.zeros((bs, length), np.float32)
        done = np.zeros((bs, length), np.float32)
        mask = np.zeros((bs, length), np.float32)
        eye = self._eye
        for b in range(bs):
            ep = self._episodes[self._np_rng.integers(len(self._episodes))]
            L = len(ep["obs"])  # T+1 arrival rows
            prev_act = np.concatenate(
                [np.zeros((1, self.num_actions), np.float32),
                 eye[ep["actions"]]])
            arr_rew = np.concatenate([[0.0], ep["rewards"]])
            arr_done = np.concatenate([[0.0], ep["dones"]])
            if L <= length:
                start, n = 0, L
            else:
                start = int(self._np_rng.integers(0, L - length + 1))
                n = length
            seg = slice(start, start + n)
            obs[b, :n] = ep["obs"][seg]
            act[b, :n] = prev_act[seg]
            rew[b, :n] = arr_rew[seg]
            done[b, :n] = arr_done[seg]
            mask[b, :n] = 1.0
        return {"obs": obs, "actions_onehot": act, "rewards": rew,
                "dones": done, "mask": mask}

    # -- training -------------------------------------------------------
    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        while len(self._episodes) < int(cfg.get("prefill_episodes", 5)):
            ret, length = self._run_episode()
            self._pending_returns.append(ret)
            self._pending_lens.append(length)
        for _ in range(int(cfg.get("rollout_episodes_per_step", 1))):
            ret, length = self._run_episode()
            self._pending_returns.append(ret)
            self._pending_lens.append(length)
        stats: Dict[str, Any] = {"episodes_in_buffer": len(self._episodes)}
        learner = self.learner
        for _ in range(int(cfg.get("train_iters_per_step", 20))):
            batch = self._sample_sequences(
                int(cfg.get("batch_size", 16)),
                int(cfg.get("batch_length", 20)))
            wm_loss, recon, rloss, kl, deter, stoch = \
                learner.wm_update(batch)
            a_loss, c_loss = learner.behavior_update(deter, stoch,
                                                     batch["mask"])
        stats.update({"world_model_loss": float(wm_loss),
                      "recon_loss": float(recon),
                      "reward_loss": float(rloss),
                      "kl_loss": float(kl),
                      "actor_loss": float(a_loss),
                      "critic_loss": float(c_loss)})
        return stats

    # -- Algorithm plumbing without a worker fleet ----------------------
    def _collect_metrics(self):
        out = [{"episode_returns": list(self._pending_returns),
                "episode_lens": list(self._pending_lens)}]
        self._pending_returns.clear()
        self._pending_lens.clear()
        return out

    def evaluate(self) -> Dict[str, Any]:
        returns = [self._run_episode(explore=False)[0] for _ in range(
            int(self.config.get("evaluation_duration", 5)))]
        return {"episode_reward_mean": float(np.mean(returns)),
                "episode_reward_min": float(np.min(returns)),
                "episode_reward_max": float(np.max(returns))}

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        learner = self.learner
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "wb") as f:
            pickle.dump({
                "wm": _to_numpy(learner.wm.state_dict()),
                "actor": _to_numpy(learner.actor.state_dict()),
                "critic": _to_numpy(learner.critic.state_dict()),
                "iteration": self.iteration,
                "timesteps_total": self._timesteps_total,
            }, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        for name in ("wm", "actor", "critic"):
            getattr(self.learner, name).load_state_dict(
                _to_tensors(state[name]))
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]

    def stop(self) -> None:
        pass
