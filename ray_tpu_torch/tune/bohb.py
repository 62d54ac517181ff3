"""BOHB: Bayesian-Optimization HyperBand.

Parity: reference ``tune/schedulers/hb_bohb.py`` + ``search/bohb.py``
(Falkner et al. 2018) — HyperBand's bracket-based early stopping with a
model-based sampler instead of random search: per budget (rung), a
TPE-style density ratio over the best/worst observed configs steers new
suggestions toward the good region, always modeling on the HIGHEST
budget that has enough observations (the BOHB rule).

Two cooperating pieces, same as the reference:

- :class:`BOHBSearcher` — suggests configs; consumes (config, budget,
  score) observations, including mid-training rung reports.
- :class:`HyperBandForBOHB` — the HyperBand scheduler variant that
  reports each rung's results back to the searcher before promoting.

Both plug into the existing ``tune.run`` machinery (the ``Searcher`` /
``TrialScheduler`` protocols of this package); the domain encoding is
inherited from :class:`BayesOptSearch`.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.tune.schedulers import HyperBandScheduler
from ray_tpu_torch.tune.search import BayesOptSearch


class BOHBSearcher(BayesOptSearch):
    def __init__(self, space: Dict[str, Any], *,
                 metric: Optional[str] = None, mode: str = "max",
                 min_points_in_model: Optional[int] = None,
                 top_fraction: float = 0.25, n_candidates: int = 64,
                 random_fraction: float = 0.2,
                 seed: Optional[int] = None):
        super().__init__(space, metric=metric, mode=mode, seed=seed)
        self.min_points = min_points_in_model or (len(self.space) + 2)
        self.top_fraction = top_fraction
        self.n_candidates = n_candidates
        self.random_fraction = random_fraction
        #: budget -> [(unit_vector, signed_score)]
        self._obs: Dict[float, List[Tuple[List[float], float]]] = \
            defaultdict(list)
        #: trial_id -> unit vector (kept across rung reports; _pending
        #: pops on completion)
        self._unit_of: Dict[str, List[float]] = {}

    # -- suggestions ----------------------------------------------------
    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        import numpy as np

        dims = len(self.space)
        budget = self._model_budget()
        if (dims == 0 or budget is None
                or self._rng.random() < self.random_fraction):
            x = [self._rng.random() for _ in range(dims)]
        else:
            rows = sorted(self._obs[budget], key=lambda r: -r[1])
            n_top = max(2, int(len(rows) * self.top_fraction))
            top = np.asarray([r[0] for r in rows[:n_top]])
            rest = np.asarray([r[0] for r in rows[n_top:]]
                              or [r[0] for r in rows[:n_top]])
            bw_top = np.maximum(top.std(axis=0), 1e-3) \
                * len(top) ** (-1.0 / (dims + 4))
            bw_rest = np.maximum(rest.std(axis=0), 1e-3) \
                * len(rest) ** (-1.0 / (dims + 4))

            def log_kde(cands, pts, bw):
                d = (cands[:, None, :] - pts[None, :, :]) / bw
                log_k = -0.5 * (d ** 2).sum(-1) \
                    - np.log(bw).sum() - 0.5 * dims * np.log(2 * np.pi)
                m = log_k.max(axis=1)
                return m + np.log(
                    np.exp(log_k - m[:, None]).mean(axis=1))

            # sample candidates from the good-region KDE, rank by l/g
            centers = top[self._np_rng.integers(0, len(top),
                                                self.n_candidates)]
            cands = np.clip(
                centers + self._np_rng.normal(size=centers.shape) * bw_top,
                0.0, 1.0)
            ratio = log_kde(cands, top, bw_top) \
                - log_kde(cands, rest, bw_rest)
            x = list(map(float, cands[int(np.argmax(ratio))]))
        self._pending[trial_id] = x
        self._unit_of[trial_id] = x
        return self._decode(x)

    def _model_budget(self) -> Optional[float]:
        eligible = [b for b, rows in self._obs.items()
                    if len(rows) >= self.min_points]
        return max(eligible) if eligible else None

    # -- observations ---------------------------------------------------
    def observe(self, trial_id: str, score: float,
                budget: float = 1.0) -> None:
        x = self._unit_of.get(trial_id)
        if x is None:
            return
        sign = 1.0 if self.mode == "max" else -1.0
        self._obs[float(budget)].append((x, sign * float(score)))

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None) -> None:
        if result is not None and self.metric in result:
            self.observe(trial_id, result[self.metric],
                         budget=float(result.get("training_iteration", 1)))
        self._pending.pop(trial_id, None)
        self._unit_of.pop(trial_id, None)


class HyperBandForBOHB(HyperBandScheduler):
    """HyperBand that feeds every rung result to the BOHB searcher so
    model-based sampling sharpens as brackets progress (parity:
    ``HyperBandForBOHB`` hb_bohb.py)."""

    def __init__(self, searcher: BOHBSearcher, **kwargs):
        super().__init__(**kwargs)
        self._searcher = searcher

    def on_trial_result(self, runner, trial, result) -> str:
        decision = super().on_trial_result(runner, trial, result)
        metric = result.get(self.metric)
        if metric is not None:
            self._searcher.observe(
                getattr(trial, "searcher_id", trial.trial_id), metric,
                budget=float(result.get(self.time_attr, 1)))
        return decision
