"""IMPALA and APPO: async off-policy actor-critic with V-trace.

Parity: reference ``rllib/algorithms/impala/impala.py`` (:528 async
sampling + learner) and ``rllib/algorithms/appo/`` — actors sample
fixed-length unrolls continuously with (slightly) stale weights; the
learner consumes whichever fragments are ready, corrects off-policyness
with V-trace (Espeholt et al. 2018), and broadcasts fresh weights.

The learner's update runs on its device over a ``[B, T]`` unroll block
(B unrolls of ``rollout_fragment_length``).  V-trace's reverse-time
recursion is a loop over T of ``[B]`` tensor ops in the JAX package's
order of operations (``acc = delta_t + cut_t * c_t * acc``, f32), not a
closed form, which would sum in another order.  The reference's
LearnerThread/minibatch buffer machinery collapses into async actor
futures: overlap comes from re-dispatching ``sample`` before learning
on the collected block.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

import ray_tpu_torch
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.sample_batch import SampleBatch, concat_samples


class ImpalaConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 5e-4
        self.rollout_fragment_length = 50
        self.vtrace_clip_rho_threshold = 1.0
        self.vtrace_clip_c_threshold = 1.0
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.num_aggregation_fragments = 1  # ready sample() results per step

    @property
    def algo_class(self):
        return IMPALA


class ImpalaPolicy(TorchPolicy):
    """V-trace actor-critic over [B, T] unrolls."""

    def _vtrace(self, vf, v_next, rewards, gamma_boot, gamma_cut, done,
                rhos):
        """vs and pg advantages (Espeholt et al. eq. 1); all [B, T],
        computed without gradient (the JAX package's ``stop_gradient``).

        ``v_next`` is V(next_obs_t) from a full second forward — exact
        even at truncation boundaries inside the unroll (where
        vf[t+1] would be the value of the *reset* state).  ``gamma_boot``
        zeroes only at true terminations (bootstrap through time limits);
        ``gamma_cut`` zeroes at any episode boundary so the correction
        recursion never crosses episodes.
        """
        cfg = self.config
        rho_bar = float(cfg.get("vtrace_clip_rho_threshold", 1.0))
        c_bar = float(cfg.get("vtrace_clip_c_threshold", 1.0))
        with torch.no_grad():
            clipped_rho = torch.clamp(rhos, max=rho_bar)
            cs = torch.clamp(rhos, max=c_bar)
            deltas = clipped_rho * (rewards + gamma_boot * v_next - vf)
            # reverse loop over time, one [B] step each
            acc = torch.zeros_like(vf[:, 0])
            vs_minus_v = torch.empty_like(vf)
            for t in range(vf.shape[1] - 1, -1, -1):
                acc = deltas[:, t] + gamma_cut[:, t] * cs[:, t] * acc
                vs_minus_v[:, t] = acc
            vs = vf + vs_minus_v
            # vs_{t+1}: the corrected value of the successor state — at an
            # episode boundary the successor is v_next itself (no
            # correction propagates across episodes)
            vs_shift = torch.cat([vs[:, 1:], v_next[:, -1:]], dim=1)
            vs_next = torch.where(done > 0, v_next, vs_shift)
            pg_adv = clipped_rho * (rewards + gamma_boot * vs_next - vf)
        return vs, pg_adv

    def _forward_unrolls(self, batch):
        obs = batch[SampleBatch.OBS]
        next_obs = batch[SampleBatch.NEXT_OBS]
        B, T = obs.shape[0], obs.shape[1]
        dist_inputs, vf = self.model(obs.reshape((B * T,) + obs.shape[2:]))
        dist_inputs = dist_inputs.reshape((B, T) + dist_inputs.shape[1:])
        vf = vf.reshape(B, T)
        _, v_next = self.model(
            next_obs.reshape((B * T,) + next_obs.shape[2:]))
        v_next = v_next.reshape(B, T)
        target_logp = self.dist.logp(dist_inputs,
                                     batch[SampleBatch.ACTIONS])
        return dist_inputs, vf, v_next, target_logp

    def _policy_loss(self, rhos, target_logp, pg_adv):
        return -torch.mean(target_logp * pg_adv)

    def loss(self, batch):
        cfg = self.config
        gamma = float(cfg.get("gamma", 0.99))
        dist_inputs, vf, v_next, target_logp = self._forward_unrolls(batch)
        rhos = torch.exp(target_logp - batch[SampleBatch.ACTION_LOGP])
        term = batch[SampleBatch.TERMINATEDS].float()
        done = torch.logical_or(batch[SampleBatch.TERMINATEDS],
                                batch[SampleBatch.TRUNCATEDS]).float()
        vs, pg_adv = self._vtrace(vf, v_next, batch[SampleBatch.REWARDS],
                                  gamma * (1.0 - term),
                                  gamma * (1.0 - done), done,
                                  rhos.detach())
        policy_loss = self._policy_loss(rhos, target_logp, pg_adv)
        vf_loss = 0.5 * torch.mean(torch.square(vs - vf))
        entropy = torch.mean(self.dist.entropy(dist_inputs))
        total = policy_loss \
            + float(cfg.get("vf_loss_coeff", 0.5)) * vf_loss \
            - float(cfg.get("entropy_coeff", 0.01)) * entropy
        stats = {"policy_loss": policy_loss, "vf_loss": vf_loss,
                 "entropy": entropy, "mean_rho": torch.mean(rhos)}
        return total, {k: v.detach() for k, v in stats.items()}

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        """One update on the batch as ``[B, T]`` unrolls; the ``n - B*T``
        tail rows are dropped."""
        T = int(self.config.get("rollout_fragment_length", 50))
        n = len(batch)
        B = n // T
        if B == 0:
            return {}
        unrolls = {k: v[:B * T].reshape((B, T) + v.shape[1:])
                   for k, v in batch.items() if v.dtype != object}
        stats = self._update(self._device_batch(unrolls))
        return {k: float(v) for k, v in stats.items()}


class APPOPolicy(ImpalaPolicy):
    """PPO-clipped surrogate on V-trace advantages (reference
    ``appo_torch_policy.py``); everything else inherits from IMPALA."""

    def _policy_loss(self, rhos, target_logp, pg_adv):
        clip = float(self.config.get("clip_param", 0.3))
        surrogate = torch.minimum(
            rhos * pg_adv, torch.clamp(rhos, 1 - clip, 1 + clip) * pg_adv)
        return -torch.mean(surrogate)


class IMPALA(Algorithm):
    policy_class = ImpalaPolicy

    def setup(self) -> None:
        self.config["_raw_fragments"] = True
        super().setup()
        # seed the async pipeline: every remote worker starts sampling
        self._inflight: Dict[Any, Any] = {}
        self._pending_metrics: List[Dict[str, Any]] = []
        for w in self.workers.remote_workers:
            self._inflight[w.sample_with_metrics.remote()] = w

    def training_step(self) -> Dict[str, Any]:
        if not self.workers.remote_workers:
            batch = self.workers.local_worker.sample()
        else:
            # reconcile the pipeline with the current fleet: workers
            # replaced by probe_and_recreate (or not yet dispatched) get a
            # sample() in flight; refs from removed workers are dropped
            live = set(id(w) for w in self.workers.remote_workers)
            inflight_ids = set(id(w) for w in self._inflight.values())
            self._inflight = {ref: w for ref, w in self._inflight.items()
                              if id(w) in live}
            for w in self.workers.remote_workers:
                if id(w) not in inflight_ids:
                    self._inflight[w.sample_with_metrics.remote()] = w
            want = int(self.config.get("num_aggregation_fragments", 1))
            ready, _ = ray_tpu_torch.wait(
                list(self._inflight),
                num_returns=min(want, len(self._inflight)), timeout=300)
            batches: List[SampleBatch] = []
            # the learner's weights come off its device once, as numpy
            weights_ref = ray_tpu_torch.put(
                self.workers.local_worker.get_weights())
            for ref in ready:
                w = self._inflight.pop(ref)
                try:
                    fragment, metrics = ray_tpu_torch.get(ref)
                except Exception:  # noqa: BLE001 — dead worker: drop its
                    # fragment; the next train()'s probe_and_recreate /
                    # reconcile restores throughput
                    continue
                batches.append(fragment)
                self._pending_metrics.append(metrics)
                # fresh weights, then immediately resume sampling (the
                # actor queue preserves order: set_weights -> sample)
                w.set_weights.remote(weights_ref)
                self._inflight[w.sample_with_metrics.remote()] = w
            batch = concat_samples(batches)
        self._timesteps_total += len(batch)
        stats = self.workers.local_worker.policy.learn_on_batch(batch)
        stats["num_env_steps_sampled_this_iter"] = len(batch)
        return stats

    def _collect_metrics(self):
        out = [self.workers.local_worker.metrics()]
        out.extend(self._pending_metrics)
        self._pending_metrics = []
        return out

    def stop(self) -> None:
        self._inflight.clear()
        super().stop()


class APPOConfig(ImpalaConfig):
    def __init__(self):
        super().__init__()
        self.clip_param = 0.3

    @property
    def algo_class(self):
        return APPO


class APPO(IMPALA):
    policy_class = APPOPolicy
