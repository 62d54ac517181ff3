"""DDPPO: Decentralized Distributed PPO.

Parity: reference ``rllib/algorithms/ddppo/ddppo.py`` — config contract
(:91 — learner-side training is forbidden; rollout workers train
themselves) and the decentralized update loop (:252-327 — each worker
samples its own fragment, runs the PPO epoch/minibatch schedule locally,
and ALL-REDUCES GRADIENTS with its peers; there is no central learner
and the driver never broadcasts weights).

The remote workers are the learners.  Unless ``num_gpus_per_learner=0``
names the CPU, each is leased ``1 / num_rollout_workers`` of the card
(the raylet hands out fractional GPUs to cold-spawned workers) and keeps
its policy there.  Each minibatch's gradients are concatenated into one
flat tensor on the worker's device, copied to the host once, averaged
across the gang through ``ray_tpu_torch.util.collective`` over the
shared-memory object plane (numpy, in rank order, so every rank gets the
same bytes), copied back once and applied identically on every rank, so
parameters stay bit-identical without any weight sync.
"""

from __future__ import annotations

import uuid
from itertools import islice
from typing import Any, Dict

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm_config import learner_gpus
from ray_tpu_torch.rllib.algorithms.ppo import PPO, PPOConfig


class DDPPOConfig(PPOConfig):
    def __init__(self):
        super().__init__()
        self.num_rollout_workers = 2
        self.num_sgd_iter = 10
        self.sgd_minibatch_size = 128
        # how often (iterations) the driver refreshes its local worker's
        # weights from rank 0 — only for evaluate()/checkpointing; the
        # training path never moves weights (reference keeps the local
        # worker stale between checkpoints for the same reason)
        self.local_weights_sync_freq = 1

    @property
    def algo_class(self):
        return DDPPO


def _init_group(worker, world_size: int, rank: int, group_name: str):
    from ray_tpu_torch.util.collective import collective
    collective.init_collective_group(world_size, rank,
                                     backend="object_store",
                                     group_name=group_name)
    return True


def _destroy_group(worker, group_name: str):
    from ray_tpu_torch.util.collective import collective
    collective.destroy_collective_group(group_name)
    return True


def allreduce_gradients(policy, grads, group_name: str, world: int):
    """The gang's mean of ``grads`` (one tensor per trainable parameter,
    on the policy's device): one flat tensor, one copy to the host, one
    allreduce, one copy back; returns views of it, one per parameter."""
    import torch

    from ray_tpu_torch.util.collective import collective

    flat = torch.cat([g.reshape(-1) for g in grads])
    # the collective crosses process boundaries on host memory; one
    # flat vector -> ONE allreduce per minibatch
    mean = collective.allreduce(flat.cpu().numpy(), group_name) / world
    mean = torch.from_numpy(mean).to(policy.device)
    return [m.view_as(g) for m, g in
            zip(torch.split(mean, [g.numel() for g in grads]), grads)]


def _train_once(worker, group_name: str) -> Dict[str, Any]:
    """One decentralized PPO iteration, executed INSIDE a rollout worker.

    Lockstep contract: every rank must issue the same number of
    allreduces — enforced by reducing the common batch length with MIN
    and iterating exactly ``common_n // mb_size`` minibatches per epoch.
    """
    from ray_tpu_torch.rllib.execution import standardize_advantages
    from ray_tpu_torch.util.collective import collective
    from ray_tpu_torch.util.collective.collective import ReduceOp

    policy = worker.policy
    cfg = policy.config
    world = collective.get_collective_group_size(group_name)

    batch = standardize_advantages(worker.sample())
    n = len(batch)
    common_n = int(collective.allreduce(
        np.array([n], np.int64), group_name, op=ReduceOp.MIN)[0])
    if common_n < n:
        batch = batch.slice(0, common_n)

    mb_size = min(int(cfg.get("sgd_minibatch_size", 128)), common_n)
    epochs = int(cfg.get("num_sgd_iter", 10))
    n_mb = max(1, common_n // mb_size)

    last_stats: Dict[str, float] = {}
    kls = []
    for _ in range(epochs):
        for mb in islice(policy._iter_minibatches(batch, mb_size), n_mb):
            dev = policy._device_batch(mb)
            # the coefficient in f32, as the JAX package passes it
            dev["kl_coeff"] = float(np.float32(policy.kl_coeff))
            grads, stats = policy._grads(dev)
            policy.apply_gradients(
                allreduce_gradients(policy, grads, group_name, world))
            last_stats = {k: float(v) for k, v in stats.items()}
            kls.append(last_stats.get("kl", 0.0))
    # adaptive KL: reduce the mean KL so every rank adjusts kl_coeff
    # identically (divergent coefficients would desynchronize gradients);
    # the schedule itself is PPO's (_finish_learn), not a re-derivation
    mean_kl = float(collective.allreduce(
        np.array([np.mean(kls) if kls else 0.0]), group_name)[0]) / world
    last_stats = policy._finish_learn(last_stats, mean_kl)
    return {"stats": last_stats, "env_steps": n}


class DDPPO(PPO):
    policy_class = PPO.policy_class
    supports_multi_agent = False

    def setup(self) -> None:
        n = int(self.config.get("num_rollout_workers", 0))
        if n < 2:
            raise ValueError(
                "DDPPO is decentralized data-parallel training: it needs "
                "num_rollout_workers >= 2 (reference ddppo.py:91 forbids "
                "learner-side training)")
        if self.config.get("policies"):
            raise ValueError("DDPPO does not support multi-agent")
        if learner_gpus(self.config):
            # the workers are the learners: each takes a share of the card
            self.config["_num_gpus_per_worker"] = 1.0 / n
        super().setup()  # builds the fleet + one-time initial weight sync
        workers = self.workers.remote_workers
        self._group = f"ddppo-{uuid.uuid4().hex[:8]}"
        ray_tpu_torch.get([
            w.apply.remote(_init_group, len(workers), rank, self._group)
            for rank, w in enumerate(workers)])

    def training_step(self) -> Dict[str, Any]:
        workers = self.workers.remote_workers
        results = ray_tpu_torch.get([
            w.apply.remote(_train_once, self._group) for w in workers])
        steps = sum(r["env_steps"] for r in results)
        self._timesteps_total += steps
        stats: Dict[str, Any] = {}
        for key in results[0]["stats"]:
            stats[key] = float(np.mean([r["stats"][key] for r in results]))
        freq = int(self.config.get("local_weights_sync_freq", 1))
        if freq and self.iteration % freq == 0:
            # rank0 -> local ONLY (evaluate()/checkpoint read it); never
            # broadcast back out to the fleet
            self.workers.local_worker.set_weights(
                ray_tpu_torch.get(workers[0].get_weights.remote()))
        stats["num_env_steps_sampled_this_iter"] = steps
        return stats

    def stop(self) -> None:
        try:
            workers = self.workers.remote_workers
            if workers:
                ray_tpu_torch.get(
                    workers[0].apply.remote(_destroy_group, self._group),
                    timeout=10)
        except Exception:  # noqa: BLE001 — teardown is best-effort
            pass
        super().stop()
