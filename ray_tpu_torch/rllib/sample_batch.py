"""Columnar experience batches.

Parity: reference ``rllib/policy/sample_batch.py`` — ``SampleBatch``
(:125) is a dict of parallel numpy columns with standard keys, plus
``concat_samples``, slicing, shuffling, and minibatch iteration.
Columns stay numpy on the host; policies move them to device in one
transfer per minibatch (one H2D copy per column, not one per step).
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Sequence

import numpy as np


class SampleBatch(dict):
    OBS = "obs"
    NEXT_OBS = "new_obs"
    ACTIONS = "actions"
    REWARDS = "rewards"
    TERMINATEDS = "terminateds"
    TRUNCATEDS = "truncateds"
    ACTION_LOGP = "action_logp"
    VF_PREDS = "vf_preds"
    ADVANTAGES = "advantages"
    VALUE_TARGETS = "value_targets"
    EPS_ID = "eps_id"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            if not isinstance(v, np.ndarray):
                self[k] = np.asarray(v)

    def __len__(self) -> int:
        for v in self.values():
            return int(v.shape[0])
        return 0

    @property
    def count(self) -> int:
        return len(self)

    def slice(self, start: int, end: int) -> "SampleBatch":
        return SampleBatch({k: v[start:end] for k, v in self.items()})

    def shuffle(self, rng: np.random.Generator) -> "SampleBatch":
        perm = rng.permutation(len(self))
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def minibatches(self, size: int, rng: np.random.Generator
                    ) -> Iterator["SampleBatch"]:
        shuffled = self.shuffle(rng)
        n = len(self)
        for start in range(0, n - n % size or n, size):
            mb = shuffled.slice(start, min(start + size, n))
            if len(mb):
                yield mb

    def split_by_episode(self) -> List["SampleBatch"]:
        if self.EPS_ID not in self:
            return [self]
        ids = self[self.EPS_ID]
        out, start = [], 0
        for i in range(1, len(self)):
            if ids[i] != ids[start]:
                out.append(self.slice(start, i))
                start = i
        out.append(self.slice(start, len(self)))
        return out

    def copy(self) -> "SampleBatch":
        return SampleBatch({k: v.copy() for k, v in self.items()})


def concat_samples(batches: Sequence[SampleBatch]) -> SampleBatch:
    """Concatenate along time (reference ``SampleBatch.concat_samples``)."""
    batches = [b for b in batches if b is not None and len(b)]
    if not batches:
        return SampleBatch()
    keys = batches[0].keys()
    return SampleBatch(
        {k: np.concatenate([b[k] for b in batches], axis=0) for k in keys})


class MultiAgentBatch(dict):
    """policy_id -> SampleBatch (reference ``MultiAgentBatch``:1165).

    ``env_steps`` counts environment ticks (the reference's
    ``env_steps()``); ``count`` sums per-policy rows (agent steps)."""

    def __init__(self, *args, env_steps: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self._env_steps = int(env_steps)

    @property
    def count(self) -> int:
        return sum(len(b) for b in self.values())

    def env_steps(self) -> int:
        return self._env_steps or self.count

    def agent_steps(self) -> int:
        return self.count


def build_sequences(batch: SampleBatch, max_seq_len: int,
                    state_keys: Sequence[str] = ("state_in_c",
                                                 "state_in_h"),
                    ) -> Dict[str, np.ndarray]:
    """Chunk an episode-ordered batch into padded fixed-length sequences
    for recurrent training (reference ``policy/rnn_sequencing.py``).

    Returns a dict of [S, L, ...] arrays plus ``seq_mask`` [S, L]
    (1.0 on real steps) and the per-sequence initial state columns
    ([S, cell], taken from the first row of each chunk).
    """
    chunks: List[SampleBatch] = []
    for ep in batch.split_by_episode():
        for start in range(0, len(ep), max_seq_len):
            chunks.append(ep.slice(start, min(start + max_seq_len,
                                              len(ep))))
    out: Dict[str, np.ndarray] = {}
    S, L = len(chunks), max_seq_len
    for key in batch.keys():
        first = np.asarray(chunks[0][key])
        if key in state_keys:
            out[key] = np.stack([np.asarray(c[key])[0] for c in chunks])
            continue
        arr = np.zeros((S, L) + first.shape[1:], first.dtype)
        for i, c in enumerate(chunks):
            arr[i, :len(c)] = c[key]
        out[key] = arr
    mask = np.zeros((S, L), np.float32)
    for i, c in enumerate(chunks):
        mask[i, :len(c)] = 1.0
    out["seq_mask"] = mask
    return out
