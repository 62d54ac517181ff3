"""MAML — Model-Agnostic Meta-Learning for RL.

Parity: reference ``rllib/algorithms/maml/maml.py`` (workers each hold a
sampled task from a ``TaskSettableEnv``; inner policy-gradient
adaptation on pre-batches, post-adaptation sampling, and a meta-update
that differentiates through the adaptation — ``maml.py:79-170``,
``maml_torch_policy.py:63`` higher-order grads).

Adaptation is a function of the parameters, ``adapt(theta, pre)``: inner
SGD steps whose gradients are taken with ``create_graph=True``, applied
through ``torch.func.functional_call``, so the meta-gradient is taken
through them — exact second-order MAML.  The tasks run one after
another on the learner's device (the card unless
``num_gpus_per_learner=0``); the meta-loss is their mean, as the JAX
package's ``vmap`` gives it.  Advantages are standardised per task with
the population standard deviation (``jnp.std``'s).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch
from torch.func import functional_call

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.env import make_env
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.sample_batch import SampleBatch

_META_KEYS = (SampleBatch.OBS, SampleBatch.ACTIONS,
              SampleBatch.ACTION_LOGP, SampleBatch.ADVANTAGES,
              SampleBatch.VALUE_TARGETS)

Params = Dict[str, torch.Tensor]


class MAMLConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3                  # outer (meta) Adam lr
        self.inner_lr = 0.1             # inner SGD step size
        self.inner_adaptation_steps = 1
        self.maml_optimizer_steps = 5   # outer steps per meta-batch
        self.num_rollout_workers = 2    # == tasks per meta-batch
        self.rollout_fragment_length = 200
        self.clip_param = 0.3
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.0

    @property
    def algo_class(self):
        return MAML


def norm_adv(adv: torch.Tensor) -> torch.Tensor:
    """Per-task standardisation (reference maml postprocessing) with the
    population std, as ``jnp.std``: raw GAE advantages on dense-reward
    envs reach the tens, and one inner SGD step at that scale destroys
    the policy."""
    return (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)


class MetaPolicy(TorchPolicy):
    """The inner policy-gradient step and the outer clipped-PPO loss on a
    parameter dict, shared by MAML and MBMPO."""

    def _adv(self, batch) -> torch.Tensor:
        """The advantages the losses weigh: standardised per task."""
        return norm_adv(batch[SampleBatch.ADVANTAGES])

    def _forward(self, params: Params, obs: torch.Tensor):
        return functional_call(self.model, params, (obs,))

    def _pg_loss(self, params: Params, batch) -> torch.Tensor:
        """Inner objective: vanilla policy gradient + value error (the
        adaptation signal; reference maml_torch_policy inner loss)."""
        dist_inputs, vf = self._forward(params, batch[SampleBatch.OBS])
        logp = self.dist.logp(dist_inputs, batch[SampleBatch.ACTIONS])
        pg = -torch.mean(logp * self._adv(batch))
        verr = torch.mean((vf - batch[SampleBatch.VALUE_TARGETS]) ** 2)
        return pg + float(self.config.get("vf_loss_coeff", 0.5)) * verr

    def _adapt_params(self, theta: Params, pre, create_graph: bool
                      ) -> Params:
        """``inner_adaptation_steps`` SGD steps of :meth:`_pg_loss` from
        ``theta``; with ``create_graph`` the result stays differentiable
        in ``theta`` (second order).  Each step's gradient is taken with
        respect to a fresh view of the parameters, so a ``pre`` batch
        that was itself computed from ``theta`` (MBMPO's imagined one)
        is a constant of the inner gradient, as in ``jax.grad``, and
        enters only the outer one."""
        inner_lr = float(self.config.get("inner_lr", 0.1))
        adapted = theta
        for _ in range(int(self.config.get("inner_adaptation_steps", 1))):
            adapted = {n: t.view_as(t) for n, t in adapted.items()}
            names = list(adapted)
            grads = torch.autograd.grad(
                self._pg_loss(adapted, pre), [adapted[n] for n in names],
                create_graph=create_graph, allow_unused=True)
            adapted = {n: adapted[n] - inner_lr * (
                torch.zeros_like(adapted[n]) if g is None else g)
                for n, g in zip(names, grads)}
        return adapted

    def _ppo_loss(self, params: Params, batch) -> torch.Tensor:
        """Outer objective: clipped PPO surrogate on post-adaptation
        data."""
        cfg = self.config
        clip = float(cfg.get("clip_param", 0.3))
        dist_inputs, vf = self._forward(params, batch[SampleBatch.OBS])
        logp = self.dist.logp(dist_inputs, batch[SampleBatch.ACTIONS])
        ratio = torch.exp(logp - batch[SampleBatch.ACTION_LOGP])
        adv = self._adv(batch)
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)
        verr = torch.mean((vf - batch[SampleBatch.VALUE_TARGETS]) ** 2)
        entropy = torch.mean(self.dist.entropy(dist_inputs))
        return (-torch.mean(surrogate)
                + float(cfg.get("vf_loss_coeff", 0.5)) * verr
                - float(cfg.get("entropy_coeff", 0.0)) * entropy)

    def _theta(self) -> Params:
        return dict(self.model.named_parameters())

    def _meta_apply(self, loss: torch.Tensor) -> None:
        """One Adam step (behind the config's clip) on the meta-loss's
        gradient."""
        self.opt.zero_grad(set_to_none=False)
        loss.backward()
        params = self._params()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._clip_gradients([p.grad for p in params])
        self.opt.step()


class MAMLPolicy(MetaPolicy):
    """The adaptation and the meta-update; acting and GAE
    postprocessing come from TorchPolicy."""

    def _adapt(self, pre) -> Params:
        """The adapted parameters for one task's pre-batch (tensors)."""
        theta = {n: p.detach().requires_grad_()
                 for n, p in self.model.named_parameters()}
        return {n: t.detach() for n, t in
                self._adapt_params(theta, pre, create_graph=False).items()}

    def _meta_update(self, pre, post) -> torch.Tensor:
        """One outer step: the mean over tasks of the PPO loss at the
        adapted parameters, differentiated through the adaptation.
        ``pre`` and ``post`` hold each column stacked ``[tasks, n, ...]``."""
        theta = self._theta()
        losses = [self._ppo_loss(
            self._adapt_params(theta, _task(pre, k), create_graph=True),
            _task(post, k)) for k in range(len(pre[SampleBatch.OBS]))]
        loss = torch.mean(torch.stack(losses))
        self._meta_apply(loss)
        return loss.detach()

    def meta_update(self, pre, post) -> torch.Tensor:
        """:meth:`_meta_update` on numpy columns; the loss stays on the
        device."""
        return self._meta_update(self._device_batch(pre),
                                 self._device_batch(post))

    def adapt(self, pre) -> Dict[str, np.ndarray]:
        """One task's adapted weights (numpy, for a sampler)."""
        adapted = self._adapt(self._device_batch(pre))
        return {k: v.cpu().numpy() for k, v in adapted.items()}


def _task(batch, k: int):
    return {key: col[k] for key, col in batch.items()}


class MAML(Algorithm):
    policy_class = MAMLPolicy

    def setup(self) -> None:
        # checked before the sampler fleet starts
        if not int(self.config.get("num_rollout_workers", 0)):
            raise ValueError("MAML needs num_rollout_workers >= 1 "
                             "(one worker per sampled task)")
        env = make_env(self.config["env"],
                       dict(self.config.get("env_config", {})))
        if not hasattr(env, "sample_tasks"):
            raise ValueError(
                f"MAML needs a TaskSettableEnv (sample_tasks/set_task); "
                f"got {type(env).__name__}")
        super().setup()

    @staticmethod
    def _stack(batches: List[SampleBatch]) -> Dict[str, np.ndarray]:
        n = min(len(b) for b in batches)
        return {k: np.stack([np.asarray(b[k][:n]) for b in batches])
                for k in _META_KEYS}

    def training_step(self) -> Dict[str, Any]:
        import ray_tpu_torch

        cfg = self.config
        policy: MAMLPolicy = self.workers.local_worker.policy
        workers = self.workers.remote_workers

        # 1. sample a task per worker
        tasks = self.workers.local_worker.envs[0].sample_tasks(
            len(workers))
        ray_tpu_torch.get([w.apply.remote(
            lambda wk, t=t: [e.set_task(t) for e in wk.envs])
            for w, t in zip(workers, tasks)], timeout=60)

        # 2. pre-adaptation rollouts under theta
        self.workers.sync_weights()
        pre = ray_tpu_torch.get([w.sample.remote() for w in workers],
                                timeout=300)

        # 3. per-task inner adaptation; post-adaptation rollouts under
        #    the adapted weights
        pre_stack = self._stack(pre)
        adapted = [policy.adapt(_task(pre_stack, i))
                   for i in range(len(workers))]
        ray_tpu_torch.get([w.set_weights.remote(a)
                           for w, a in zip(workers, adapted)], timeout=60)
        post = ray_tpu_torch.get([w.sample.remote() for w in workers],
                                 timeout=300)
        post_stack = self._stack(post)

        # 4. meta-update: differentiate through the adaptation
        loss = None
        for _ in range(int(cfg.get("maml_optimizer_steps", 5))):
            loss = policy.meta_update(pre_stack, post_stack)
        loss = float(loss)

        self._timesteps_total += sum(len(b) for b in pre) + sum(
            len(b) for b in post)

        def mean_episode_return(batches):
            """Mean return over COMPLETED episodes only — fragment-
            boundary truncations would deflate the metric (and skew
            adaptation_delta when adaptation changes episode length)."""
            returns = []
            for b in batches:
                rew = np.asarray(b[SampleBatch.REWARDS])
                done = (np.asarray(b[SampleBatch.TERMINATEDS])
                        | np.asarray(b[SampleBatch.TRUNCATEDS]))
                start = 0
                for i in np.flatnonzero(done):
                    returns.append(float(rew[start:i + 1].sum()))
                    start = i + 1
            if not returns:  # no episode completed within the fragment
                return float(np.mean(
                    [np.asarray(b[SampleBatch.REWARDS]).sum()
                     for b in batches]))
            return float(np.mean(returns))

        pre_rew = mean_episode_return(pre)
        post_rew = mean_episode_return(post)
        return {"meta_loss": loss,
                "pre_adaptation_reward": pre_rew,
                "post_adaptation_reward": post_rew,
                "adaptation_delta": post_rew - pre_rew}
