"""ES and ARS — black-box evolution strategies.

Parity: reference ``rllib/algorithms/es/`` (OpenAI-ES: antithetic
Gaussian perturbations of the flat parameter vector, centered-rank
fitness shaping, shared-noise table) and ``rllib/algorithms/ars/``
(Augmented Random Search: top-k directions weighted by reward std).
Distributed pattern preserved: the algorithm broadcasts the flat params,
rollout-worker actors evaluate perturbed policies as plain remote
calls — pure task parallelism on the runtime, no gradients.  The
search itself is host numpy; the local worker's policy acts on the
learner's device (the card unless ``num_gpus_per_learner=0``), remote
samplers on the host.

The flat vector is laid out as the JAX package's pytree leaves: modules
in sorted name order, each module's ``bias`` before its ``kernel``, and
kernels ``[in, out]`` (the transpose of ``nn.Linear.weight``), so the
same generator draws give the same candidates in both packages.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.policy import TorchPolicy


class ESConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.episodes_per_batch = 16   # perturbation pairs per iteration
        self.noise_stdev = 0.05
        self.stepsize = 0.02
        self.l2_coeff = 0.005
        self.eval_prob = 0.0

    @property
    def algo_class(self):
        return ES


class ARSConfig(ESConfig):
    def __init__(self):
        super().__init__()
        self.num_top_directions = 8    # use best k of the sampled pairs
        self.noise_stdev = 0.03
        self.stepsize = 0.02

    @property
    def algo_class(self):
        return ARS


#: the JAX package's leaf names for a ``state_dict`` entry
_LEAF = {"bias": "bias", "weight": "kernel"}


def _flax_order(weights: Dict[str, np.ndarray]) -> List[str]:
    """``state_dict`` keys in flax's leaf order: by module path, then by
    leaf name (``bias`` < ``kernel``)."""
    def key(name):
        module, leaf = name.rsplit(".", 1)
        return tuple(module.split(".")), _LEAF[leaf]
    return sorted(weights, key=key)


def _flatten(weights: Dict[str, np.ndarray]) -> Tuple[np.ndarray, Any]:
    """A policy's weights (its ``get_weights()``) as one f64 vector in the
    JAX package's leaf order and layout, and the spec to undo it."""
    spec, parts = [], []
    for name in _flax_order(weights):
        w = np.asarray(weights[name])
        transposed = w.ndim == 2
        parts.append((w.T if transposed else w).ravel())
        spec.append((name, w.shape, transposed))
    return np.concatenate(parts).astype(np.float64), spec


def _unflatten(flat: np.ndarray, spec) -> Dict[str, np.ndarray]:
    """The inverse of :func:`_flatten`: f32 weights for ``set_weights``."""
    weights, i = {}, 0
    for name, shape, transposed in spec:
        n = int(np.prod(shape)) if shape else 1
        leaf = np.asarray(flat[i:i + n], np.float32)
        weights[name] = (np.ascontiguousarray(leaf.reshape(shape[::-1]).T)
                         if transposed else leaf.reshape(shape))
        i += n
    return weights


def _rollout_return(worker, flat: np.ndarray, spec) -> Tuple[float, int]:
    """Runs on the rollout actor: set perturbed weights, play one
    episode greedily, return (episode reward, episode length)."""
    worker.policy.set_weights(_unflatten(flat, spec))
    env = worker.envs[0]
    obs, _ = env.reset()
    done, total, steps = False, 0.0, 0
    while not done and steps < 1000:
        a, _ = worker.policy.compute_actions(obs[None], explore=False)
        obs, rew, term, trunc, _ = env.step(np.asarray(a)[0])
        total += float(rew)
        steps += 1
        done = term or trunc
    return total, steps


def _centered_ranks(x: np.ndarray) -> np.ndarray:
    """Fitness shaping (reference ``es/utils.py`` compute_centered_ranks)."""
    ranks = np.empty(len(x), dtype=np.float64)
    ranks[x.argsort()] = np.arange(len(x))
    return ranks / (len(x) - 1) - 0.5


class ES(Algorithm):
    policy_class = TorchPolicy

    def setup(self) -> None:
        # ES acts greedily with a plain policy head; TorchPolicy's loss is
        # never called
        super().setup()
        self._theta, self._spec = _flatten(
            self.workers.local_worker.policy.get_weights())
        self._np_rng = np.random.default_rng(
            int(self.config.get("seed", 0) or 0))

    def _evaluate_population(self, perturbations: List[np.ndarray]
                             ) -> np.ndarray:
        """Evaluate each candidate vector; fan out over remote workers
        round-robin, or run locally without a fleet."""
        workers = self.workers.remote_workers
        spec = self._spec
        if workers:
            import ray_tpu_torch
            refs = [workers[i % len(workers)].apply.remote(
                        _rollout_return, p, spec)
                    for i, p in enumerate(perturbations)]
            results = ray_tpu_torch.get(refs)
        else:
            local = self.workers.local_worker
            results = [_rollout_return(local, p, spec)
                       for p in perturbations]
        rewards = np.asarray([r for r, _ in results], np.float64)
        # candidate episodes ARE the episode stats for ES
        self._episode_returns.extend(rewards.tolist())
        self._episode_lens.extend(int(s) for _, s in results)
        self._timesteps_total += int(sum(s for _, s in results))
        return rewards

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n = int(cfg.get("episodes_per_batch", 16))
        sigma = float(cfg.get("noise_stdev", 0.05))
        lr = float(cfg.get("stepsize", 0.02))
        l2 = float(cfg.get("l2_coeff", 0.005))
        eps = self._np_rng.standard_normal((n, len(self._theta)))
        # antithetic pairs
        cands = [self._theta + sigma * e for e in eps] \
            + [self._theta - sigma * e for e in eps]
        rewards = self._evaluate_population(cands)
        shaped = _centered_ranks(rewards)
        g = (shaped[:n] - shaped[n:]) @ eps / (2 * n * sigma)
        self._theta = self._theta + lr * (g - l2 * self._theta)
        self._push_weights()
        return {"episode_reward_mean": float(np.mean(rewards)),
                "episode_reward_max": float(np.max(rewards)),
                "update_norm": float(np.linalg.norm(lr * g))}

    def _push_weights(self) -> None:
        weights = _unflatten(self._theta, self._spec)
        self.workers.local_worker.policy.set_weights(weights)
        for w in self.workers.remote_workers:
            w.set_weights.remote(weights)

    def _collect_metrics(self):
        return []  # rewards reported directly from evaluations


class ARS(ES):
    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n = int(cfg.get("episodes_per_batch", 16))
        k = min(int(cfg.get("num_top_directions", 8)), n)
        sigma = float(cfg.get("noise_stdev", 0.03))
        lr = float(cfg.get("stepsize", 0.02))
        eps = self._np_rng.standard_normal((n, len(self._theta)))
        cands = [self._theta + sigma * e for e in eps] \
            + [self._theta - sigma * e for e in eps]
        rewards = self._evaluate_population(cands)
        r_pos, r_neg = rewards[:n], rewards[n:]
        # keep the top-k directions by max(r+, r-)
        scores = np.maximum(r_pos, r_neg)
        top = np.argsort(-scores)[:k]
        r_std = float(np.std(np.concatenate([r_pos[top], r_neg[top]])))
        g = (r_pos[top] - r_neg[top]) @ eps[top] / (k * max(r_std, 1e-8))
        self._theta = self._theta + lr * g
        self._push_weights()
        return {"episode_reward_mean": float(np.mean(rewards)),
                "episode_reward_max": float(np.max(rewards)),
                "reward_std_topk": r_std}
