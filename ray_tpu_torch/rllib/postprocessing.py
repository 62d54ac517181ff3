"""Advantage estimation.

Parity: reference ``rllib/evaluation/postprocessing.py`` —
``compute_advantages`` with GAE(lambda) over a (possibly truncated)
trajectory, bootstrapping the value of the final state when the episode
did not terminate.
"""

from __future__ import annotations

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


def compute_gae(batch: SampleBatch, last_value: float, *,
                gamma: float = 0.99, lambda_: float = 0.95,
                use_gae: bool = True) -> SampleBatch:
    """Append ADVANTAGES and VALUE_TARGETS columns to one episode chunk.

    ``last_value`` bootstraps truncated rollouts (0.0 for terminated).
    """
    rewards = batch[SampleBatch.REWARDS].astype(np.float64)
    n = len(rewards)
    if use_gae:
        vf = np.append(batch[SampleBatch.VF_PREDS].astype(np.float64),
                       float(last_value))
        deltas = rewards + gamma * vf[1:] - vf[:-1]
        adv = np.zeros(n, dtype=np.float64)
        acc = 0.0
        for t in reversed(range(n)):
            acc = deltas[t] + gamma * lambda_ * acc
            adv[t] = acc
        targets = adv + vf[:-1]
    else:
        ret = np.zeros(n, dtype=np.float64)
        acc = float(last_value)
        for t in reversed(range(n)):
            acc = rewards[t] + gamma * acc
            ret[t] = acc
        targets = ret
        adv = ret - batch[SampleBatch.VF_PREDS].astype(np.float64)
    batch[SampleBatch.ADVANTAGES] = adv.astype(np.float32)
    batch[SampleBatch.VALUE_TARGETS] = targets.astype(np.float32)
    return batch
