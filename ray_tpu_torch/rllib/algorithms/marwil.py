"""MARWIL and BC (offline imitation / advantage-weighted imitation).

Parity: reference ``rllib/algorithms/marwil/`` (exponentially
advantage-weighted behavior cloning with a learned value baseline and a
running advantage-norm estimate) and ``rllib/algorithms/bc/`` (MARWIL
with beta=0, i.e. plain behavior cloning, no value learning).  Training
reads batches from offline JSON data (``rllib/offline``) instead of env
sampling; evaluation still rolls real episodes.  The discounted returns
and the running advantage norm are kept on the host; the update runs on
the learner's device.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.offline import JsonReader
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.sample_batch import SampleBatch, concat_samples


class MARWILConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.beta = 1.0           # advantage-weight temperature; 0 == BC
        self.vf_coeff = 1.0
        self.train_batch_size = 2000
        self.input_: Optional[str] = None  # offline data path (required)
        self.moving_average_sqd_adv_norm_update_rate = 1e-8
        self.use_gae = False
        self.lambda_ = 1.0

    def offline_data(self, *, input_: Optional[str] = None
                     ) -> "MARWILConfig":
        if input_ is not None:
            self.input_ = input_
        return self

    @property
    def algo_class(self):
        return MARWIL


class BCConfig(MARWILConfig):
    def __init__(self):
        super().__init__()
        self.beta = 0.0

    @property
    def algo_class(self):
        return BC


class MARWILPolicy(TorchPolicy):
    def __init__(self, observation_space, action_space, config):
        super().__init__(observation_space, action_space, config)
        # running estimate of E[A^2] for the advantage normalizer
        self._ma_sqd_adv_norm = 100.0

    def loss(self, batch):
        cfg = self.config
        beta = float(cfg.get("beta", 1.0))
        dist_inputs, vf = self.model(batch[SampleBatch.OBS])
        logp = self.dist.logp(dist_inputs, batch[SampleBatch.ACTIONS])
        entropy = torch.mean(self.dist.entropy(dist_inputs)).detach()
        if beta == 0.0:
            # plain behavior cloning
            total = -torch.mean(logp)
            return total, {"policy_loss": total.detach(),
                           "entropy": entropy}
        # advantage against the learned baseline, normalized by the
        # running sqrt(E[A^2]) estimate and clipped (reference
        # ``marwil_torch_policy.py``)
        adv = batch["_returns"] - vf
        vf_loss = torch.mean(adv ** 2)
        norm = torch.sqrt(batch["_ma_sqd_adv_norm"])
        weights = torch.clamp(
            torch.exp(beta * torch.clamp(adv / norm, -10.0, 10.0)),
            max=20.0)
        pg_loss = -torch.mean(weights.detach() * logp)
        total = pg_loss + float(cfg.get("vf_coeff", 1.0)) * vf_loss
        return total, {"policy_loss": pg_loss.detach(),
                       "vf_loss": vf_loss.detach(),
                       "mean_adv": torch.mean(adv).detach(),
                       "entropy": entropy}

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        # discounted returns as the regression target: one backward sweep
        # over the (episode-sorted) batch, episode boundaries reset the
        # accumulator
        gamma = float(self.config.get("gamma", 0.99))
        returns = np.zeros(len(batch), np.float32)
        rew = np.asarray(batch[SampleBatch.REWARDS], np.float32)
        eps = np.asarray(batch.get(SampleBatch.EPS_ID,
                                   np.zeros(len(batch))))
        acc = 0.0
        for i in range(len(batch) - 1, -1, -1):
            if i + 1 < len(batch) and eps[i] != eps[i + 1]:
                acc = 0.0
            acc = rew[i] + gamma * acc
            returns[i] = acc
        dev = dict(batch)
        dev["_returns"] = returns
        dev["_ma_sqd_adv_norm"] = np.float32(self._ma_sqd_adv_norm)
        out = super().learn_on_batch(SampleBatch(dev))
        # update the running advantage norm from this batch's adv estimate
        if float(self.config.get("beta", 1.0)) != 0.0:
            adv = returns - self.compute_values(
                np.asarray(batch[SampleBatch.OBS]))
            rate = float(self.config.get(
                "moving_average_sqd_adv_norm_update_rate", 1e-8))
            self._ma_sqd_adv_norm += rate * (
                float(np.mean(adv ** 2)) - self._ma_sqd_adv_norm)
        return out

    def postprocess_trajectory(self, batch, last_obs=None, truncated=False):
        return batch


class MARWIL(Algorithm):
    policy_class = MARWILPolicy

    def setup(self) -> None:
        if not self.config.get("input_"):
            raise ValueError("MARWIL/BC require offline data: "
                             "config.offline_data(input_=path)")
        super().setup()
        self.reader = JsonReader(self.config["input_"])

    def training_step(self) -> Dict[str, Any]:
        policy: MARWILPolicy = self.workers.local_worker.policy
        size = int(self.config.get("train_batch_size", 2000))
        batches, steps = [], 0
        while steps < size:
            b = self.reader.next()
            batches.append(b)
            steps += len(b)
        batch = concat_samples(batches)
        self._timesteps_total += len(batch)
        stats = policy.learn_on_batch(batch)
        self.workers.sync_weights()
        return stats

    def _collect_metrics(self):
        return []  # offline: no env episodes to report


class BC(MARWIL):
    policy_class = MARWILPolicy
