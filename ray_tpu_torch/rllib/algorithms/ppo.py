"""Proximal Policy Optimization.

Parity: reference ``rllib/algorithms/ppo/ppo.py`` (``PPO.training_step``
:319) and ``ppo_torch_policy.py`` loss — clipped surrogate objective,
value-function clipping, entropy bonus, adaptive KL penalty, multi-epoch
minibatch SGD.  Each minibatch update (loss, gradients, Adam) runs on
the learner's device; the minibatch order comes from numpy's
``default_rng(seed)``, as the JAX package draws it.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.execution import (standardize_advantages,
                                           synchronous_parallel_sample)
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class PPOConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-5
        self.clip_param = 0.3
        self.vf_clip_param = 10.0
        self.vf_loss_coeff = 1.0
        self.entropy_coeff = 0.0
        self.kl_coeff = 0.2
        self.kl_target = 0.01
        self.num_sgd_iter = 30
        self.sgd_minibatch_size = 128
        self.shuffle_sequences = True

    @property
    def algo_class(self):
        return PPO


class PPOPolicy(TorchPolicy):
    def __init__(self, observation_space, action_space, config):
        super().__init__(observation_space, action_space, config)
        self.kl_coeff = float(config.get("kl_coeff", 0.2))

    def loss(self, batch):
        cfg = self.config
        if "seq_mask" in batch:
            # recurrent: [S, L, ...] padded sequences, unrolled from the
            # sampled initial carry; padded steps carry zero weight
            mask = batch["seq_mask"]
            carry = (batch["state_in_c"], batch["state_in_h"])
            dist_inputs, vf, _ = self.model(batch[SampleBatch.OBS], carry)
            denom = torch.clamp(mask.sum(), min=1.0)

            def mmean(x):
                return torch.sum(x * mask) / denom
        else:
            dist_inputs, vf = self.model(batch[SampleBatch.OBS])
            mmean = torch.mean
        logp = self.dist.logp(dist_inputs, batch[SampleBatch.ACTIONS])
        old_logp = batch[SampleBatch.ACTION_LOGP]
        adv = batch[SampleBatch.ADVANTAGES]
        ratio = torch.exp(logp - old_logp)
        clip = float(cfg.get("clip_param", 0.3))
        surrogate = torch.minimum(
            ratio * adv, torch.clamp(ratio, 1 - clip, 1 + clip) * adv)

        targets = batch[SampleBatch.VALUE_TARGETS]
        vf_err = torch.square(vf - targets)
        vf_clip = float(cfg.get("vf_clip_param", 10.0))
        vf_loss = torch.clamp(vf_err, 0.0, vf_clip ** 2)

        entropy = self.dist.entropy(dist_inputs)
        # approximate KL(old || new) from logp ratios (Schulman estimator;
        # exact per-distribution KL needs old dist inputs in the batch)
        safe_ratio = torch.where(ratio <= 0, torch.ones_like(ratio), ratio)
        kl = mmean((safe_ratio - 1.0) - torch.log(safe_ratio))

        total = (mmean(-surrogate)
                 + float(cfg.get("vf_loss_coeff", 1.0)) * mmean(vf_loss)
                 - float(cfg.get("entropy_coeff", 0.0)) * mmean(entropy)
                 ) + batch["kl_coeff"] * kl
        stats = {
            "policy_loss": mmean(-surrogate),
            "vf_loss": mmean(vf_loss),
            "entropy": mmean(entropy),
            "kl": kl,
        }
        return total, {k: v.detach() for k, v in stats.items()}

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        cfg = self.config
        mb_size = int(cfg.get("sgd_minibatch_size", 128))
        epochs = int(cfg.get("num_sgd_iter", 30))
        last_stats: Dict[str, float] = {}
        kls = []
        for _ in range(epochs):
            for mb in self._iter_minibatches(batch, mb_size):
                dev = self._device_batch(mb)
                # the coefficient in f32, as the JAX package passes it
                dev["kl_coeff"] = float(np.float32(self.kl_coeff))
                stats = self._update(dev)
                last_stats = {k: float(v) for k, v in stats.items()}
                kls.append(last_stats.get("kl", 0.0))
        # adaptive KL penalty (reference ``PPO.update_kl``)
        mean_kl = float(np.mean(kls)) if kls else 0.0
        return self._finish_learn(last_stats, mean_kl)

    def _iter_minibatches(self, batch: SampleBatch, mb_size: int):
        if not self.recurrent:
            yield from batch.minibatches(mb_size, self._np_rng)
            return
        # recurrent: shuffle and minibatch over SEQUENCES so carries
        # stay aligned with their unrolls (reference rnn_sequencing)
        from ray_tpu_torch.rllib.sample_batch import build_sequences

        max_len = int(self.config.get("model", {})
                      .get("max_seq_len", 16))
        seq = build_sequences(batch, max_len)
        S = seq["seq_mask"].shape[0]
        per_mb = max(1, mb_size // max_len)
        perm = self._np_rng.permutation(S)
        for start in range(0, S - S % per_mb or S, per_mb):
            idx = perm[start:start + per_mb]
            if len(idx):
                yield {k: v[idx] for k, v in seq.items()}

    def _finish_learn(self, last_stats, mean_kl):
        cfg = self.config
        target = float(cfg.get("kl_target", 0.01))
        if mean_kl > 2.0 * target:
            self.kl_coeff *= 1.5
        elif mean_kl < 0.5 * target:
            self.kl_coeff *= 0.5
        last_stats["kl_coeff"] = self.kl_coeff
        last_stats["mean_kl"] = mean_kl
        return last_stats


class PPO(Algorithm):
    policy_class = PPOPolicy
    supports_multi_agent = True

    def setup(self) -> None:
        # decoupled (Podracer/Sebulba) pipeline: vectorized env actors +
        # centralized batched inference (docs/rl_pipeline.md).  The
        # WorkerSet keeps only the local learner worker; the acting
        # plane is the pipeline's.
        self._pipeline = None
        if self._wants_decoupled():
            n = int(self.config.get("num_env_actors")
                    or self.config.get("num_rollout_workers") or 0)
            self.config["num_env_actors"] = n
            self.config["num_rollout_workers"] = 0
        super().setup()
        if self._wants_decoupled():
            from ray_tpu_torch.rllib.execution import DecoupledPipeline

            self._pipeline = DecoupledPipeline(
                self.config["env"], self.policy_class, self.config)
            # align the acting policy with the learner's init exactly
            # (same-seed init already matches; restore()/custom weights
            # must too)
            self._pipeline.publish_weights(
                self.workers.local_worker.get_weights())
        # overlapped-sampling pipeline (config.rollouts(sample_async=True)
        # — the reference LearnerThread shape brought to PPO): one
        # fragment stays in flight per worker THROUGH learn_on_batch, so
        # the fleet samples while the learner updates instead of idling.
        # Cost: fragments are at most one update stale — the clipped
        # surrogate is exactly the guard for that.
        self._inflight: Dict[Any, Any] = {}
        self._pending_metrics: list = []
        self._suspect_workers: set = set()
        if self._sample_async():
            for w in self.workers.remote_workers:
                self._inflight[w.sample_with_metrics.remote()] = w

    def _wants_decoupled(self) -> bool:
        """The decoupled pipeline serves the single-policy feedforward
        case; multi-agent, recurrent, connector and external-input
        configs keep the classic per-worker-policy paths."""
        model = self.config.get("model") or {}
        return bool(self.config.get("decoupled")) \
            and int(self.config.get("num_env_actors")
                    or self.config.get("num_rollout_workers") or 0) > 0 \
            and not self.config.get("policies") \
            and not callable(self.config.get("input_")) \
            and not self.config.get("obs_connectors") \
            and not self.config.get("action_connectors") \
            and not model.get("use_lstm") \
            and not model.get("use_attention")

    def _sample_async(self) -> bool:
        # multi-agent batches need the per-policy concat/learn of the
        # sync path; the overlap pipeline is single-policy only
        return bool(self.config.get("sample_async")) \
            and bool(self.workers.remote_workers) \
            and not self.config.get("policies")

    def _async_sample(self, target_steps: int):
        import ray_tpu_torch
        from ray_tpu_torch.rllib.sample_batch import concat_samples

        # reconcile with the live fleet: drop refs from removed workers,
        # dispatch to new ones, and skip handles already seen failing
        # (re-dispatching to a dead handle burns a submit+error round
        # trip per train() until probe_and_recreate replaces it — the
        # replacement is a NEW handle object, clearing the suspicion)
        live = {id(w) for w in self.workers.remote_workers}
        self._suspect_workers &= live
        self._inflight = {ref: w for ref, w in self._inflight.items()
                          if id(w) in live}
        have = {id(w) for w in self._inflight.values()}
        for w in self.workers.remote_workers:
            if id(w) not in have and id(w) not in self._suspect_workers:
                self._inflight[w.sample_with_metrics.remote()] = w
        batches = []
        steps = 0
        deadline = time.monotonic() + 300.0
        while steps < target_steps and self._inflight \
                and time.monotonic() < deadline:
            ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                    timeout=30)
            if not ready:
                continue  # wedged fleet: bounded by the deadline above
            for ref in ready:
                worker = self._inflight.pop(ref)
                try:
                    fragment, metrics = ray_tpu_torch.get(ref)
                except Exception:  # noqa: BLE001 — dead worker: drop its
                    self._suspect_workers.add(id(worker))
                    continue       # ref; probe_and_recreate restores it
                # re-dispatch FIRST: the worker samples its next fragment
                # while this one is learned on
                self._inflight[worker.sample_with_metrics.remote()] = \
                    worker
                batches.append(fragment)
                self._pending_metrics.append(metrics)
                steps += len(fragment)
        if not batches:
            # whole fleet died mid-iteration: sample locally so the
            # learner sees a real batch while the next train()'s probe
            # rebuilds the workers
            batches = [self.workers.local_worker.sample()]
        return concat_samples(batches)

    def _broadcast_weights_async(self) -> None:
        """Non-blocking weight push: set_weights queues behind each
        worker's in-flight sample (ordered actor queue), so waiting on it
        would re-serialize the pipeline."""
        self.workers.sync_weights()

    def _collect_metrics(self):
        out = [self.workers.local_worker.metrics()]
        if self._pipeline is not None:
            out.extend(self._pipeline.drain_metrics())
        if self._sample_async():
            out.extend(self._pending_metrics)
            self._pending_metrics = []
        elif self.workers.remote_workers:
            # bounded gather: the streamed sampler leaves one sample()
            # in flight per worker, and metrics() queues behind it
            # (max_concurrency=1) — a blocking full-set get here would
            # hand the straggler stall right back to the learner.
            # Unanswered refs stay pending (stats accumulate worker-
            # side and arrive with a later iteration).
            import ray_tpu_torch
            pending = getattr(self, "_metrics_inflight", {})
            live = {id(w) for w in self.workers.remote_workers}
            pending = {ref: w for ref, w in pending.items()
                       if id(w) in live}
            have = {id(w) for w in pending.values()}
            for w in self.workers.remote_workers:
                if id(w) not in have:
                    pending[w.metrics.remote()] = w
            ready, _ = ray_tpu_torch.wait(list(pending),
                                    num_returns=len(pending), timeout=2)
            for ref in ready:
                pending.pop(ref)
                try:
                    out.append(ray_tpu_torch.get(ref))
                except Exception:  # noqa: BLE001 — dead worker: its
                    pass           # stats died with it
            self._metrics_inflight = pending
        return out

    def restore(self, checkpoint_dir: str) -> None:
        super().restore(checkpoint_dir)
        if self._pipeline is not None:
            self._pipeline.publish_weights(
                self.workers.local_worker.get_weights())

    def stop(self) -> None:
        self._inflight.clear()
        if self._pipeline is not None:
            self._pipeline.stop()
            self._pipeline = None
        super().stop()

    def training_step(self) -> Dict[str, Any]:
        from ray_tpu_torch.rllib.sample_batch import MultiAgentBatch

        target = int(self.config.get("train_batch_size", 4000))
        if self._pipeline is not None:
            # async learner loop: env actors keep collecting (through
            # the inference actors' current weights) WHILE the fused
            # PPO update runs; the staleness bound caps how old an
            # admitted fragment's policy may be
            batch = self._pipeline.collect(target)
            batch = standardize_advantages(batch)
            self._timesteps_total += len(batch)
            stats = self.workers.local_worker.policy.learn_on_batch(batch)
            self._pipeline.publish_weights(
                self.workers.local_worker.get_weights())
            stats["num_env_steps_sampled_this_iter"] = len(batch)
            stats["rl_weights_version"] = self._pipeline.version
            stats["rl_fragments_dropped_stale"] = \
                self._pipeline.stale_dropped
            return stats
        if self._sample_async():
            batch = self._async_sample(target)
            batch = standardize_advantages(batch)
            self._timesteps_total += len(batch)
            stats = self.workers.local_worker.policy.learn_on_batch(batch)
            self._broadcast_weights_async()
            stats["num_env_steps_sampled_this_iter"] = len(batch)
            return stats
        batch = synchronous_parallel_sample(
            self.workers,
            max_env_steps=int(self.config.get("train_batch_size", 4000)))
        if isinstance(batch, MultiAgentBatch):
            # learn each trainable policy on its own sub-batch
            worker = self.workers.local_worker
            to_train = self.config.get("policies_to_train") \
                or list(worker.policy_map)
            self._timesteps_total += batch.env_steps()
            stats: Dict[str, Any] = {}
            for pid in to_train:
                if pid not in batch or not len(batch[pid]):
                    continue
                sub = standardize_advantages(batch[pid])
                for k, v in worker.policy_map[pid].learn_on_batch(
                        sub).items():
                    stats[f"{pid}/{k}"] = v
            self.workers.sync_weights()
            stats["num_env_steps_sampled_this_iter"] = batch.env_steps()
            stats["num_agent_steps_sampled_this_iter"] = batch.count
            return stats
        batch = standardize_advantages(batch)
        self._timesteps_total += len(batch)
        stats = self.workers.local_worker.policy.learn_on_batch(batch)
        self.workers.sync_weights()
        stats["num_env_steps_sampled_this_iter"] = len(batch)
        return stats
