"""Policy-gradient family: PG (REINFORCE), A2C, A3C.

Parity: reference ``rllib/algorithms/pg/`` (vanilla policy gradient on
Monte-Carlo returns), ``rllib/algorithms/a2c/`` (synchronous advantage
actor-critic: one fused actor+critic SGD step per sampled batch, with
optional microbatch gradient accumulation) and ``rllib/algorithms/a3c/``
(asynchronous gradients: workers compute grads on their own fragments
and the learner applies them as they arrive, then ships weights back).
Each policy's loss, gradients and Adam step run on the learner's
device; A3C's gradients are computed on the host samplers by
``TorchPolicy.compute_gradients`` and applied by the learner's
``apply_gradients``.
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.execution import (standardize_advantages,
                                           synchronous_parallel_sample,
                                           train_one_step)
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.sample_batch import SampleBatch


# ---------------------------------------------------------------------------
# PG
# ---------------------------------------------------------------------------

class PGConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 4e-4
        self.train_batch_size = 2000
        # REINFORCE uses plain discounted returns, no GAE bootstrap
        self.use_gae = False
        self.lambda_ = 1.0

    @property
    def algo_class(self):
        return PG


class PGPolicy(TorchPolicy):
    """-E[logp(a|s) * R] on Monte-Carlo returns."""

    def loss(self, batch):
        dist_inputs, _ = self.model(batch[SampleBatch.OBS])
        logp = self.dist.logp(dist_inputs, batch[SampleBatch.ACTIONS])
        adv = batch[SampleBatch.ADVANTAGES]
        pg_loss = -torch.mean(logp * adv)
        return pg_loss, {
            "policy_loss": pg_loss.detach(),
            "entropy": torch.mean(self.dist.entropy(dist_inputs)).detach()}


class PG(Algorithm):
    policy_class = PGPolicy

    def training_step(self) -> Dict[str, Any]:
        batch = synchronous_parallel_sample(
            self.workers,
            max_env_steps=int(self.config.get("train_batch_size", 2000)))
        self._timesteps_total += len(batch)
        batch = standardize_advantages(batch)
        stats = train_one_step(self, batch)
        self.workers.sync_weights()
        return stats


# ---------------------------------------------------------------------------
# A2C
# ---------------------------------------------------------------------------

class A2CConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.train_batch_size = 500
        self.rollout_fragment_length = 20
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.microbatch_size: Any = None  # grad-accumulate if set

    @property
    def algo_class(self):
        return A2C


class A2CPolicy(TorchPolicy):
    def loss(self, batch):
        cfg = self.config
        dist_inputs, vf = self.model(batch[SampleBatch.OBS])
        logp = self.dist.logp(dist_inputs, batch[SampleBatch.ACTIONS])
        adv = batch[SampleBatch.ADVANTAGES]
        pg_loss = -torch.mean(logp * adv)
        vf_loss = torch.mean(
            (vf - batch[SampleBatch.VALUE_TARGETS]) ** 2)
        entropy = torch.mean(self.dist.entropy(dist_inputs))
        total = (pg_loss
                 + float(cfg.get("vf_loss_coeff", 0.5)) * vf_loss
                 - float(cfg.get("entropy_coeff", 0.01)) * entropy)
        return total, {"policy_loss": pg_loss.detach(),
                       "vf_loss": vf_loss.detach(),
                       "entropy": entropy.detach()}


class A2C(Algorithm):
    policy_class = A2CPolicy

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        batch = synchronous_parallel_sample(
            self.workers,
            max_env_steps=int(cfg.get("train_batch_size", 500)))
        self._timesteps_total += len(batch)
        batch = standardize_advantages(batch)
        policy = self.workers.local_worker.policy
        micro = cfg.get("microbatch_size")
        if micro:
            # gradient accumulation over microbatches (reference
            # ``a2c.py`` microbatch path); per-microbatch mean grads are
            # re-weighted by sample count so a short final slice doesn't
            # over-weight its samples vs the full-batch gradient
            acc = None
            stats: Dict[str, float] = {}
            total = len(batch)
            for start in np.arange(0, total, int(micro)):
                mb = batch.slice(int(start),
                                 int(min(start + int(micro), total)))
                grads, stats = policy.compute_gradients(mb)
                weighted = _tree_scale(grads, len(mb) / total)
                acc = weighted if acc is None else _tree_add(acc, weighted)
            policy.apply_gradients(acc)
        else:
            stats = policy.learn_on_batch(batch)
        self.workers.sync_weights()
        return stats


def _tree_add(a: List[np.ndarray], b: List[np.ndarray]
              ) -> List[np.ndarray]:
    """Two gradient lists (one array per parameter) added."""
    return [np.add(x, y) for x, y in zip(a, b)]


def _tree_scale(a: List[np.ndarray], s: float) -> List[np.ndarray]:
    return [x * s for x in a]


# ---------------------------------------------------------------------------
# A3C
# ---------------------------------------------------------------------------

class A3CConfig(A2CConfig):
    def __init__(self):
        super().__init__()
        self.num_rollout_workers = 2
        self.grads_per_step = 8  # async grad applications per train()

    @property
    def algo_class(self):
        return A3C


def _worker_grads(worker):
    """Runs on the rollout actor: sample a fragment, compute grads with
    the worker's own (slightly stale) weights."""
    batch = worker.sample()
    batch = standardize_advantages(batch)
    grads, stats = worker.policy.compute_gradients(batch)
    stats["batch_len"] = len(batch)
    return grads, stats


class A3C(Algorithm):
    """Asynchronous advantage actor-critic: HogWild-style gradient
    application (reference ``a3c.py`` ``training_step`` — async grad
    requests against the worker fleet, apply-then-resync per worker)."""

    policy_class = A2CPolicy

    def training_step(self) -> Dict[str, Any]:
        workers = self.workers.remote_workers
        if not workers:
            # degenerate single-process mode == A2C
            batch = synchronous_parallel_sample(
                self.workers,
                max_env_steps=int(self.config.get("train_batch_size", 500)))
            self._timesteps_total += len(batch)
            return train_one_step(self,
                                  standardize_advantages(batch))
        policy = self.workers.local_worker.policy
        pending = {w.apply.remote(_worker_grads): w for w in workers}
        stats: Dict[str, Any] = {}
        applied = 0
        want = int(self.config.get("grads_per_step", 8))
        while applied < want:
            done, _ = ray_tpu_torch.wait(list(pending), num_returns=1)
            ref = done[0]
            worker = pending.pop(ref)
            grads, stats = ray_tpu_torch.get(ref)
            self._timesteps_total += int(stats.pop("batch_len", 0))
            policy.apply_gradients(grads)
            applied += 1
            # ship fresh weights only to the worker that just reported
            worker.set_weights.remote(policy.get_weights())
            if applied < want:
                pending[worker.apply.remote(_worker_grads)] = worker
        stats["num_async_grads_applied"] = applied
        return stats
