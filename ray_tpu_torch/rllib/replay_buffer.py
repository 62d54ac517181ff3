"""Replay buffers.

Parity: reference ``rllib/utils/replay_buffers/`` — uniform
``ReplayBuffer`` and proportional ``PrioritizedReplayBuffer`` (sum-tree
semantics implemented with vectorized numpy; capacities here are modest
host-RAM sizes, so O(n) weighted sampling beats tree bookkeeping).
Columnar storage: one preallocated numpy ring per SampleBatch key, so
sampling a minibatch is a single fancy-index per column (one H2D per
learn call downstream).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch


class ReplayBuffer:
    def __init__(self, capacity: int = 100_000,
                 seed: Optional[int] = None):
        self.capacity = int(capacity)
        self._cols: Dict[str, np.ndarray] = {}
        self._next = 0
        self._size = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return self._size

    def add(self, batch: SampleBatch) -> None:
        n = len(batch)
        if n == 0:
            return
        if not self._cols:
            for k, v in batch.items():
                self._cols[k] = np.zeros((self.capacity,) + v.shape[1:],
                                         dtype=v.dtype)
        # ring write, possibly wrapping
        idx = (self._next + np.arange(n)) % self.capacity
        for k, v in batch.items():
            self._cols[k][idx] = v
        self._next = int((self._next + n) % self.capacity)
        self._size = int(min(self._size + n, self.capacity))
        self._on_added(idx)

    def _on_added(self, idx: np.ndarray) -> None:
        pass

    def sample(self, num_items: int) -> SampleBatch:
        idx = self._rng.integers(0, self._size, size=num_items)
        return self._take(idx)

    def _take(self, idx: np.ndarray) -> SampleBatch:
        out = SampleBatch({k: v[idx] for k, v in self._cols.items()})
        out["batch_indexes"] = idx
        return out


class PrioritizedReplayBuffer(ReplayBuffer):
    """Proportional prioritized experience replay (Schaul et al.):
    P(i) ∝ p_i^alpha, importance weights w_i = (N·P(i))^-beta scaled by
    max w."""

    def __init__(self, capacity: int = 100_000, *, alpha: float = 0.6,
                 beta: float = 0.4, seed: Optional[int] = None):
        super().__init__(capacity, seed)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self._priorities = np.zeros(self.capacity, dtype=np.float64)
        self._max_priority = 1.0

    def _on_added(self, idx: np.ndarray) -> None:
        self._priorities[idx] = self._max_priority ** self.alpha

    def sample(self, num_items: int) -> SampleBatch:
        p = self._priorities[:self._size]
        probs = p / p.sum()
        idx = self._rng.choice(self._size, size=num_items, p=probs)
        batch = self._take(idx)
        weights = (self._size * probs[idx]) ** (-self.beta)
        batch["weights"] = (weights / weights.max()).astype(np.float32)
        return batch

    def update_priorities(self, idx: np.ndarray,
                          priorities: np.ndarray) -> None:
        priorities = np.abs(priorities) + 1e-6
        self._priorities[idx] = priorities ** self.alpha
        self._max_priority = max(self._max_priority,
                                 float(priorities.max()))
