"""Offline data IO and off-policy estimation.

Parity: reference ``rllib/offline/`` — ``JsonWriter``/``JsonReader``
(newline-delimited JSON episode files), the ``input_``/``output``
config plumbing, and the importance-sampling / weighted-importance-
sampling estimators (``offline/estimators/``).  Columns are stored
base64-free as plain lists (small RL batches; parquet-scale offline
datasets go through ray_tpu_torch.data instead).
"""

from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

from ray_tpu_torch.rllib.sample_batch import SampleBatch, concat_samples


class JsonWriter:
    """Append sampled batches to newline-delimited JSON files
    (reference ``offline/json_writer.py``)."""

    def __init__(self, path: str, *, max_file_size: int = 64 * 1024 * 1024):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._max = max_file_size
        self._index = 0
        self._file = None

    def _roll(self):
        if self._file is not None:
            self._file.close()
        name = os.path.join(self.path, f"output-{self._index:05d}.json")
        self._index += 1
        self._file = open(name, "w")

    def write(self, batch: SampleBatch) -> None:
        if self._file is None or self._file.tell() > self._max:
            self._roll()
        row = {k: np.asarray(v).tolist() for k, v in batch.items()}
        row["_dtypes"] = {k: str(np.asarray(v).dtype)
                          for k, v in batch.items()}
        self._file.write(json.dumps(row) + "\n")
        self._file.flush()

    def close(self) -> None:
        if self._file is not None:
            self._file.close()
            self._file = None


class JsonReader:
    """Read batches written by :class:`JsonWriter` (reference
    ``offline/json_reader.py``); ``next()`` cycles forever like the
    reference's sampler-facing reader."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            self.files = sorted(glob.glob(os.path.join(path, "*.json")))
        else:
            self.files = sorted(glob.glob(path))
        if not self.files:
            raise FileNotFoundError(f"no offline data at {path!r}")
        self._batches = list(self.read_all_batches())
        self._i = 0

    def read_all_batches(self) -> Iterator[SampleBatch]:
        for f in self.files:
            with open(f) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    row = json.loads(line)
                    dtypes = row.pop("_dtypes", {})
                    yield SampleBatch(
                        {k: np.asarray(v, dtype=dtypes.get(k))
                         for k, v in row.items()})

    def next(self) -> SampleBatch:
        b = self._batches[self._i % len(self._batches)]
        self._i += 1
        return b

    def read(self) -> SampleBatch:
        """The whole dataset as one batch."""
        return concat_samples(self._batches)


# ---------------------------------------------------------------------------
# Off-policy estimators
# ---------------------------------------------------------------------------

class ImportanceSampling:
    """Ordinary importance sampling of V_target from behavior data
    (reference ``offline/estimators/importance_sampling.py``)."""

    weighted = False

    def __init__(self, policy, gamma: float = 0.99):
        self.policy = policy
        self.gamma = gamma

    def _new_logp(self, batch: SampleBatch) -> np.ndarray:
        """log pi(a|s) under the target policy — ONE batched forward
        under ``no_grad`` over the whole dataset (per-episode forwards
        would dispatch thousands of tiny ops)."""
        import torch

        policy = self.policy
        obs = torch.as_tensor(np.asarray(batch[SampleBatch.OBS]),
                              dtype=torch.float32, device=policy.device)
        acts = np.asarray(batch[SampleBatch.ACTIONS])
        if acts.dtype == np.float64:
            acts = acts.astype(np.float32)
        acts = torch.as_tensor(acts, device=policy.device)
        with torch.no_grad():
            dist_inputs, _ = policy.model(obs)
            return policy.dist.logp(dist_inputs, acts).cpu().numpy()

    def estimate(self, batch: SampleBatch) -> Dict[str, float]:
        log_diff = self._new_logp(batch) \
            - np.asarray(batch[SampleBatch.ACTION_LOGP])
        episodes = batch.split_by_episode()
        ratios = []
        start = 0
        for ep in episodes:
            # cumulative p_t = prod_{t'<=t} pi/mu within the episode
            ratios.append(np.exp(np.cumsum(
                log_diff[start:start + len(ep)])))
            start += len(ep)
        if self.weighted:
            # WIS: normalize p_t by its mean across episodes at the same
            # timestep (reference ``weighted_importance_sampling.py`` —
            # per-timestep cross-episode normalization, NOT within-episode)
            max_t = max(len(r) for r in ratios)
            sums = np.zeros(max_t)
            counts = np.zeros(max_t)
            for r in ratios:
                sums[:len(r)] += r
                counts[:len(r)] += 1
            w_bar = sums / np.maximum(counts, 1)
            ratios = [r / np.maximum(w_bar[:len(r)], 1e-8) for r in ratios]
        v_b_list: List[float] = []
        v_t_list: List[float] = []
        for ep, rho in zip(episodes, ratios):
            gammas = self.gamma ** np.arange(len(ep))
            rew = ep[SampleBatch.REWARDS]
            v_b_list.append(float(np.sum(gammas * rew)))
            v_t_list.append(float(np.sum(gammas * rho * rew)))
        v_b = float(np.mean(v_b_list))
        v_t = float(np.mean(v_t_list))
        return {"v_behavior": v_b, "v_target": v_t,
                "v_gain": v_t / max(abs(v_b), 1e-8)}


class WeightedImportanceSampling(ImportanceSampling):
    """WIS: self-normalized ratios — lower variance, small bias
    (reference ``offline/estimators/weighted_importance_sampling.py``)."""

    weighted = True


def collect_offline_dataset(env_spec: Any, path: str, *,
                            num_steps: int = 2000,
                            policy: Optional[Any] = None,
                            seed: int = 0) -> str:
    """Roll a (random or given) behavior policy and persist the episodes
    — the test/demo helper mirroring the reference's
    ``rllib/examples/offline_rl`` data-generation step."""
    from ray_tpu_torch.rllib.env import make_env

    env = make_env(env_spec, {"seed": seed})
    rng = np.random.default_rng(seed)
    writer = JsonWriter(path)
    obs, _ = env.reset()
    rows: List[Dict[str, Any]] = []
    eps_id = 0
    space = env.action_space
    if hasattr(space, "n"):
        uniform_logp = -float(np.log(space.n))
    else:  # Box: uniform density = 1/volume
        uniform_logp = -float(np.sum(np.log(
            np.asarray(space.high, np.float64)
            - np.asarray(space.low, np.float64))))
    for _ in range(num_steps):
        if policy is None:
            act = space.sample(rng)
            logp = uniform_logp
        else:
            a, extras = policy.compute_actions(obs[None])
            act = np.asarray(a)[0]
            logp = float(extras[SampleBatch.ACTION_LOGP][0])
        obs2, rew, term, trunc, _ = env.step(act)
        rows.append({SampleBatch.OBS: obs, SampleBatch.NEXT_OBS: obs2,
                     SampleBatch.ACTIONS: act, SampleBatch.REWARDS: rew,
                     SampleBatch.TERMINATEDS: term,
                     SampleBatch.TRUNCATEDS: trunc,
                     SampleBatch.ACTION_LOGP: logp,
                     SampleBatch.EPS_ID: eps_id})
        obs = obs2
        if term or trunc:
            writer.write(SampleBatch(
                {k: np.stack([np.asarray(r[k]) for r in rows])
                 for k in rows[0]}))
            rows = []
            eps_id += 1
            obs, _ = env.reset()
    if rows:
        writer.write(SampleBatch(
            {k: np.stack([np.asarray(r[k]) for r in rows])
             for k in rows[0]}))
    writer.close()
    return path
