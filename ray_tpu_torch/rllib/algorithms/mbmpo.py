"""MBMPO — Model-Based Meta-Policy Optimization.

Parity: reference ``rllib/algorithms/mbmpo/mbmpo.py`` — an ensemble of
learned dynamics models (``model_ensemble.py``), each ensemble member
treated as one MAML task; the policy is meta-trained on imagined
rollouts inside the models, and real env data periodically refreshes
the ensemble (``mbmpo.py:260-330`` inner/outer loop).

The reference steps its learned models as python "model envs" on CPU
workers.  Here the dynamics ensemble is one module whose parameters
carry a leading ensemble axis ``[K]`` (the members' products batched),
trained by one Adam over the stacked tensors; imagined rollouts step
the policy inside one member for ``horizon`` steps, and the whole
meta-step — imagine a pre-batch, adapt, imagine a post-batch with the
adapted weights, PPO meta-loss differentiated through the adaptation —
runs on the learner's device (the card unless
``num_gpus_per_learner=0``).  Every random draw of a model step or a
meta-step comes from :meth:`MBMPOPolicy._update_noise`.

As in the JAX package, an imagined batch's ``action_logp`` is not
detached: the meta-loss's ratio is differentiated through both its
terms, which cancel, so with discrete actions the policy's own tensors
take only the entropy's gradient through the adaptation; at the default
``entropy_coeff`` 0 their gradient is rounding (1e-10 to 1e-8 against
the value branch's 0.2 to 1.2 in the JAX package, CPU, small config).
ROADMAP.md keeps this as a fault of both packages.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.func import functional_call

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.maml import MetaPolicy
from ray_tpu_torch.rllib.env import Box
from ray_tpu_torch.rllib.execution import synchronous_parallel_sample
from ray_tpu_torch.rllib.models import DiagGaussian, _generator, \
    _lecun_normal_
from ray_tpu_torch.rllib.policy import Adam, _to_numpy, _to_tensors
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class MBMPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3                  # outer (meta) Adam lr
        self.inner_lr = 0.1
        self.inner_adaptation_steps = 1
        self.maml_optimizer_steps = 5
        self.ensemble_size = 3
        self.model_hiddens = (128, 128)
        self.model_lr = 1e-3
        self.model_train_iters = 40     # minibatch steps per refresh
        self.model_batch_size = 256
        self.horizon = 32               # imagined rollout length
        self.num_imagined_envs = 32     # parallel imagined rollouts/model
        self.rollout_fragment_length = 200  # real steps per iteration
        self.replay_buffer_capacity = 20_000
        self.clip_param = 0.3
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0
        self.gamma = 0.99
        self.lambda_ = 0.95

    @property
    def algo_class(self):
        return MBMPO


class _StackedDense(nn.Module):
    """K Dense layers: ``weight [K, out, in]``, ``bias [K, out]``, each
    member LeCun-normal with a zero bias, as flax's vmapped init."""

    def __init__(self, k: int, n_in: int, n_out: int,
                 gen: torch.Generator):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(k, n_out, n_in))
        self.bias = nn.Parameter(torch.zeros(k, n_out))
        for member in self.weight:
            _lecun_normal_(member, gen)

    def forward(self, x: torch.Tensor, k=None) -> torch.Tensor:
        """``x [K, B, in]`` through every member, or ``x [B, in]``
        through member ``k``."""
        if k is None:
            return torch.baddbmm(self.bias[:, None], x,
                                 self.weight.transpose(1, 2))
        return F.linear(x, self.weight[k], self.bias[k])


class _DynamicsEnsemble(nn.Module):
    """K MLP dynamics models: (obs, act) -> (delta_obs, reward)."""

    def __init__(self, k: int, obs_dim: int, act_dim: int,
                 hiddens=(128, 128), seed: int = 0):
        super().__init__()
        gen = _generator(seed)
        self.hiddens = tuple(int(h) for h in hiddens)
        sizes = (obs_dim + act_dim,) + self.hiddens
        for i in range(len(self.hiddens)):
            self.add_module(f"fc_{i}", _StackedDense(k, sizes[i],
                                                     sizes[i + 1], gen))
        self.delta = _StackedDense(k, sizes[-1], obs_dim, gen)
        self.reward = _StackedDense(k, sizes[-1], 1, gen)

    def forward(self, obs: torch.Tensor, act: torch.Tensor, k=None):
        x = torch.cat([obs, act], dim=-1)
        for i in range(len(self.hiddens)):
            x = F.relu(getattr(self, f"fc_{i}")(x, k))
        return self.delta(x, k), self.reward(x, k)[..., 0]


class MBMPOPolicy(MetaPolicy):
    """Policy + dynamics ensemble + the imagination and meta-update
    steps."""

    def __init__(self, observation_space, action_space, config):
        super().__init__(observation_space, action_space, config)
        cfg = config
        self._continuous = isinstance(action_space, Box)
        obs_dim = int(np.prod(observation_space.shape))
        self._act_dim = (int(np.prod(action_space.shape))
                         if self._continuous else int(action_space.n))
        self.ensemble_size = int(cfg.get("ensemble_size", 3))
        self.dyn = _DynamicsEnsemble(
            self.ensemble_size, obs_dim, self._act_dim,
            hiddens=tuple(cfg.get("model_hiddens", (128, 128))),
            seed=int(cfg.get("seed", 0) or 0) + 1).to(self.device)
        self.dyn_opt = Adam(self.dyn.parameters(),
                            lr=float(cfg.get("model_lr", 1e-3)))

    def _adv(self, batch) -> torch.Tensor:
        """Imagined advantages come standardised (:meth:`_gae`)."""
        return batch[SampleBatch.ADVANTAGES]

    # -- random draws ----------------------------------------------------
    def _update_noise(self, kind: str, n: int) -> Dict[str, torch.Tensor]:
        """Every random draw of one step, by use.  ``"models"``: each
        member's bootstrap minibatch, ``idx [K, model_batch_size]`` rows
        of ``n``.  ``"meta"``: the action noise of each member's pre- and
        post-adaptation rollouts of ``n`` imagined envs, ``[K, horizon,
        n, A]`` — Gumbel draws for discrete actions (the JAX package's
        ``categorical``), standard normals for continuous ones."""
        K = self.ensemble_size
        if kind == "models":
            bs = int(self.config.get("model_batch_size", 256))
            return {"idx": torch.randint(0, n, (K, bs), generator=self._gen,
                                         device=self.device)}
        shape = (K, int(self.config.get("horizon", 32)), n, self._act_dim)

        def draw():
            if self._continuous:
                return torch.randn(shape, generator=self._gen,
                                   device=self.device)
            u = torch.rand(shape, generator=self._gen, device=self.device)
            return -torch.log(-torch.log(u.clamp_min(
                torch.finfo(u.dtype).tiny)))
        return {"pre": draw(), "post": draw()}

    def _env_action(self, act: torch.Tensor) -> torch.Tensor:
        """Action as fed to the dynamics net (one-hot discrete)."""
        if self._continuous:
            return act
        return F.one_hot(act.long(), self._act_dim).to(torch.float32)

    # -- ensemble training -----------------------------------------------
    def _train_models(self, obs, act, nobs, rew, idx) -> torch.Tensor:
        """One minibatch step for every member, member k on rows
        ``idx[k]``; returns the members' mean loss."""
        o, no = obs[idx], nobs[idx]
        delta, pred_rew = self.dyn(o, self._env_action(act[idx]))
        losses = (torch.mean((delta - (no - o)) ** 2, dim=(1, 2))
                  + torch.mean((pred_rew - rew[idx]) ** 2, dim=1))
        self.dyn_opt.zero_grad(set_to_none=False)
        losses.sum().backward()
        self.dyn_opt.step()
        return torch.mean(losses.detach())

    def train_models(self, obs, act, nobs, rew) -> torch.Tensor:
        """:meth:`_train_models` on device tensors with this step's
        bootstrap draws; the loss stays on the device."""
        noise = self._update_noise("models", obs.shape[0])
        return self._train_models(obs, act, nobs, rew, noise["idx"])

    # -- imagination ------------------------------------------------------
    def _sample(self, dist_inputs: torch.Tensor, noise: torch.Tensor):
        if self._continuous:
            mean, log_std = DiagGaussian._split(dist_inputs)
            return mean + torch.exp(log_std) * noise
        return torch.argmax(dist_inputs + noise, dim=-1)

    def _gae(self, rew: torch.Tensor, vf: torch.Tensor):
        """[T, B] rewards and values -> standardised advantages and value
        targets; the last step bootstraps from its own value."""
        gamma = float(self.config.get("gamma", 0.99))
        lam = float(self.config.get("lambda_", 0.95))
        vf_next = torch.cat([vf[1:], vf[-1:]], dim=0)
        carry = torch.zeros_like(vf[0])
        adv = [None] * len(rew)
        for t in reversed(range(len(rew))):
            delta = rew[t] + gamma * vf_next[t] - vf[t]
            carry = delta + gamma * lam * carry
            adv[t] = carry
        adv = torch.stack(adv)
        targets = adv + vf
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        return adv, targets

    def _rollout(self, params, dyn_params, k: int, obs0: torch.Tensor,
                 noise: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Roll the policy ``params`` inside member ``k`` for ``horizon``
        steps from ``obs0 [B, obs_dim]`` with action noise ``noise [T, B,
        A]``; the flattened ``[T * B]`` batch."""
        obs = obs0
        steps = []
        for t in range(noise.shape[0]):
            dist_inputs, vf = self._forward(params, obs)
            act = self._sample(dist_inputs, noise[t])
            logp = self.dist.logp(dist_inputs, act)
            delta, rew = functional_call(
                self.dyn, dyn_params, (obs, self._env_action(act)),
                {"k": k})
            steps.append((obs, act, logp, rew, vf))
            obs = obs + delta
        obs, act, logp, rew, vf = (torch.stack(c) for c in zip(*steps))
        adv, targets = self._gae(rew, vf.detach())
        flat = lambda x: x.reshape((-1,) + x.shape[2:])  # noqa: E731
        return {SampleBatch.OBS: flat(obs),
                SampleBatch.ACTIONS: flat(act),
                SampleBatch.ACTION_LOGP: flat(logp),
                SampleBatch.ADVANTAGES: flat(adv),
                SampleBatch.VALUE_TARGETS: flat(targets),
                SampleBatch.REWARDS: flat(rew)}

    def _dyn_constants(self):
        """The ensemble's parameters as constants of the meta-loss."""
        return {n: p.detach() for n, p in self.dyn.named_parameters()}

    def _meta_step(self, obs0: torch.Tensor, noise):
        """The full MAML step inside the model ensemble: each member is a
        task; pre-imagine -> adapt -> post-imagine -> PPO meta-loss,
        differentiated through the adaptation.  Returns (loss, mean
        imagined reward)."""
        theta, dyn_params = self._theta(), self._dyn_constants()
        losses, rews = [], []
        for k in range(self.ensemble_size):
            pre = self._rollout(theta, dyn_params, k, obs0, noise["pre"][k])
            adapted = self._adapt_params(theta, pre, create_graph=True)
            post = self._rollout(adapted, dyn_params, k, obs0,
                                 noise["post"][k])
            losses.append(self._ppo_loss(adapted, post))
            rews.append(torch.mean(post[SampleBatch.REWARDS]).detach())
        loss = torch.mean(torch.stack(losses))
        self._meta_apply(loss)
        return loss.detach(), torch.mean(torch.stack(rews))

    def meta_step(self, obs0: torch.Tensor):
        """:meth:`_meta_step` with this step's action draws."""
        return self._meta_step(obs0, self._update_noise("meta",
                                                        obs0.shape[0]))

    # -- state -----------------------------------------------------------
    def get_state(self) -> Dict[str, Any]:
        state = super().get_state()
        state["dyn_params"] = _to_numpy(self.dyn.state_dict())
        state["dyn_opt_state"] = _to_numpy(self.dyn_opt.state_dict())
        return state

    def set_state(self, state: Dict[str, Any]) -> None:
        super().set_state(state)
        if "dyn_params" in state:
            self.dyn.load_state_dict(_to_tensors(state["dyn_params"]))
            self.dyn_opt.load_state_dict(
                _to_tensors(state["dyn_opt_state"]))


class MBMPO(Algorithm):
    policy_class = MBMPOPolicy

    def setup(self) -> None:
        super().setup()
        cfg = self.config
        self.replay = ReplayBuffer(
            int(cfg.get("replay_buffer_capacity", 20_000)),
            seed=cfg.get("seed"))

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        policy: MBMPOPolicy = self.workers.local_worker.policy

        # 1. real-env data with the current (post-meta) policy
        fragment = int(cfg.get("rollout_fragment_length", 200)) \
            * max(1, int(cfg.get("num_envs_per_worker", 1)))
        batch = synchronous_parallel_sample(self.workers,
                                            max_env_steps=fragment)
        self.replay.add(batch)
        self._timesteps_total += len(batch)

        # 2. refresh the dynamics ensemble on everything seen so far
        data = self.replay.sample(len(self.replay))
        obs = np.asarray(data[SampleBatch.OBS], np.float32)
        nobs = np.asarray(data[SampleBatch.NEXT_OBS], np.float32)
        act = np.asarray(data[SampleBatch.ACTIONS])
        if policy._continuous:
            act = act.astype(np.float32).reshape(len(obs), -1)
        rew = np.asarray(data[SampleBatch.REWARDS], np.float32)
        stats: Dict[str, Any] = {"replay_size": len(self.replay)}
        dev = lambda x: torch.as_tensor(x, device=policy.device)  # noqa
        o, a, no, r = dev(obs), dev(act), dev(nobs), dev(rew)
        model_loss = None
        for _ in range(int(cfg.get("model_train_iters", 40))):
            model_loss = policy.train_models(o, a, no, r)
        stats["model_loss"] = float(model_loss)

        # 3. MAML inside the ensemble: start imagined rollouts from real
        # visited states
        n_img = int(cfg.get("num_imagined_envs", 32))
        start_idx = np.random.default_rng(
            int(self.iteration)).integers(0, len(obs), size=n_img)
        obs0 = dev(obs[start_idx])
        loss = imag_rew = None
        for _ in range(int(cfg.get("maml_optimizer_steps", 5))):
            loss, imag_rew = policy.meta_step(obs0)
        stats["meta_loss"] = float(loss)
        stats["imagined_reward_mean"] = float(imag_rew)

        self.workers.sync_weights()
        return stats
