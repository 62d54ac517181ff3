"""Trial schedulers (parity: reference ``python/ray/tune/schedulers/`` —
FIFO, AsyncHyperBand/ASHA ``async_hyperband.py``, MedianStoppingRule,
PopulationBasedTraining ``pbt.py``)."""

from __future__ import annotations

import math
import random
from typing import Any, Callable, Dict, List, Optional, TYPE_CHECKING

if TYPE_CHECKING:
    from ray_tpu_torch.tune.trial import Trial

CONTINUE = "CONTINUE"
STOP = "STOP"
PAUSE = "PAUSE"


class TrialScheduler:
    def on_trial_result(self, runner, trial: "Trial",
                        result: Dict[str, Any]) -> str:
        return CONTINUE

    def on_trial_complete(self, runner, trial: "Trial",
                          result: Optional[Dict[str, Any]]) -> None:
        pass

    def on_trial_paused(self, runner, trial: "Trial") -> None:
        pass


class FIFOScheduler(TrialScheduler):
    pass


class AsyncHyperBandScheduler(TrialScheduler):
    """ASHA (parity: ``tune/schedulers/async_hyperband.py``): successive
    halving with asynchronous promotion — a trial reaching a rung is
    stopped unless it is in the top 1/reduction_factor of completed
    results at that rung."""

    def __init__(self, *, metric: Optional[str] = None, mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 4, time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.grace_period = grace_period
        self.rf = reduction_factor
        self.time_attr = time_attr
        # rung milestone -> list of recorded metric values
        self.rungs: Dict[int, List[float]] = {}
        milestone = grace_period
        self._milestones = []
        while milestone < max_t:
            self._milestones.append(milestone)
            milestone = int(milestone * reduction_factor)

    def on_trial_result(self, runner, trial, result) -> str:
        t = result.get(self.time_attr, 0)
        metric = result.get(self.metric)
        if metric is None:
            return CONTINUE
        value = metric if self.mode == "max" else -metric
        for milestone in self._milestones:
            if t == milestone:
                recorded = self.rungs.setdefault(milestone, [])
                recorded.append(value)
                k = max(1, int(len(recorded) / self.rf))
                top_k = sorted(recorded, reverse=True)[:k]
                if value < top_k[-1]:
                    return STOP
        if t >= self.max_t:
            return STOP
        return CONTINUE


class MedianStoppingRule(TrialScheduler):
    """Stop a trial whose best result so far is worse than the median of
    other trials' running averages (parity: ``median_stopping_rule.py``)."""

    def __init__(self, *, metric: Optional[str] = None, mode: str = "max",
                 grace_period: int = 1, min_samples_required: int = 3,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.grace_period = grace_period
        self.min_samples = min_samples_required
        self.time_attr = time_attr
        self._history: Dict[str, List[float]] = {}

    def on_trial_result(self, runner, trial, result) -> str:
        metric = result.get(self.metric)
        if metric is None:
            return CONTINUE
        value = metric if self.mode == "max" else -metric
        hist = self._history.setdefault(trial.trial_id, [])
        hist.append(value)
        if result.get(self.time_attr, 0) < self.grace_period:
            return CONTINUE
        others = [sum(h) / len(h) for tid, h in self._history.items()
                  if tid != trial.trial_id and h]
        if len(others) < self.min_samples:
            return CONTINUE
        median = sorted(others)[len(others) // 2]
        if max(hist) < median:
            return STOP
        return CONTINUE


class PopulationBasedTraining(TrialScheduler):
    """PBT (parity: ``tune/schedulers/pbt.py``): at each perturbation
    interval, bottom-quantile trials exploit (copy weights+config of) a
    top-quantile trial and explore (mutate hyperparams)."""

    def __init__(self, *, metric: Optional[str] = None, mode: str = "max",
                 perturbation_interval: int = 5,
                 hyperparam_mutations: Optional[Dict[str, Any]] = None,
                 quantile_fraction: float = 0.25,
                 resample_probability: float = 0.25,
                 time_attr: str = "training_iteration",
                 seed: Optional[int] = None):
        self.metric = metric
        self.mode = mode
        self.interval = perturbation_interval
        self.mutations = hyperparam_mutations or {}
        self.quantile = quantile_fraction
        self.resample_prob = resample_probability
        self.time_attr = time_attr
        self._rng = random.Random(seed)
        self._last_perturb: Dict[str, int] = {}
        self._scores: Dict[str, float] = {}

    def on_trial_result(self, runner, trial, result) -> str:
        metric = result.get(self.metric)
        if metric is None:
            return CONTINUE
        self._scores[trial.trial_id] = (metric if self.mode == "max"
                                        else -metric)
        t = result.get(self.time_attr, 0)
        last = self._last_perturb.get(trial.trial_id, 0)
        if t - last < self.interval:
            return CONTINUE
        self._last_perturb[trial.trial_id] = t
        scores = sorted(self._scores.items(), key=lambda kv: kv[1])
        n = len(scores)
        if n < 2:
            return CONTINUE
        k = max(1, int(n * self.quantile))
        bottom = [tid for tid, _ in scores[:k]]
        top = [tid for tid, _ in scores[-k:]]
        if trial.trial_id in bottom and top:
            donor_id = self._rng.choice(top)
            donor = runner.get_trial(donor_id)
            if donor is not None and donor.trial_id != trial.trial_id:
                new_config = self._explore(dict(donor.config))
                runner.exploit_trial(trial, donor, new_config)
                return PAUSE  # will restart from donor checkpoint
        return CONTINUE

    def _explore(self, config: Dict[str, Any]) -> Dict[str, Any]:
        from ray_tpu_torch.tune.search import Domain

        for key, spec in self.mutations.items():
            if self._rng.random() < self.resample_prob or key not in config:
                if isinstance(spec, Domain):
                    config[key] = spec.sample(self._rng)
                elif isinstance(spec, list):
                    config[key] = self._rng.choice(spec)
                elif callable(spec):
                    config[key] = spec()
            else:
                factor = self._rng.choice([0.8, 1.2])
                if isinstance(config[key], (int, float)):
                    config[key] = type(config[key])(config[key] * factor)
        return config


class HyperBandScheduler(TrialScheduler):
    """Synchronous successive halving (parity: reference
    ``tune/schedulers/hyperband.py``, single-bracket model): every trial
    reaching a rung milestone PAUSES; once the whole rung population has
    reported, the top 1/eta are promoted (requeued from checkpoint) and
    the rest terminated.  Differs from ASHA by never promoting on
    partial information — the trade is stragglers gate each rung."""

    def __init__(self, *, metric: Optional[str] = None, mode: str = "max",
                 max_t: int = 100, grace_period: int = 1,
                 reduction_factor: float = 3,
                 time_attr: str = "training_iteration"):
        self.metric = metric
        self.mode = mode
        self.max_t = max_t
        self.rf = reduction_factor
        self.time_attr = time_attr
        self._milestones: List[int] = []
        milestone = grace_period
        while milestone < max_t:
            self._milestones.append(milestone)
            milestone = int(milestone * reduction_factor)
        # rung index -> {trial_id: metric at rung}
        self._rung_results: Dict[int, Dict[str, float]] = {}
        # rung index -> population size expected to report there
        self._rung_population: Dict[int, int] = {}
        self._started = False
        self._trial_rung: Dict[str, int] = {}  # next milestone index

    def _value(self, result) -> Optional[float]:
        v = result.get(self.metric)
        if v is None:
            return None
        return float(v) if self.mode == "max" else -float(v)

    def _ensure_started(self, runner) -> None:
        if not self._started:
            self._started = True
            self._rung_population[0] = len(runner.trials)
            for t in runner.trials:
                self._trial_rung[t.trial_id] = 0

    def on_trial_result(self, runner, trial, result) -> str:
        self._ensure_started(runner)
        rung = self._trial_rung.get(trial.trial_id, 0)
        if rung >= len(self._milestones):
            if result.get(self.time_attr, 0) >= self.max_t:
                return STOP
            return CONTINUE
        if result.get(self.time_attr, 0) < self._milestones[rung]:
            return CONTINUE
        v = self._value(result)
        if v is None:
            return CONTINUE
        self._rung_results.setdefault(rung, {})[trial.trial_id] = v
        return PAUSE

    def on_trial_paused(self, runner, trial) -> None:
        self._maybe_promote(runner, self._trial_rung.get(trial.trial_id, 0))

    def on_trial_complete(self, runner, trial, result) -> None:
        # a trial finishing early still counts toward its rung quorum
        rung = self._trial_rung.pop(trial.trial_id, None)
        if rung is None or rung >= len(self._milestones):
            return
        v = self._value(result or trial.last_result or {})
        self._rung_results.setdefault(rung, {}) \
            .setdefault(trial.trial_id, v if v is not None else float("-inf"))
        self._maybe_promote(runner, rung)

    def _maybe_promote(self, runner, rung: int) -> None:
        results = self._rung_results.get(rung, {})
        expected = self._rung_population.get(rung, 0)
        if len(results) < expected or expected == 0:
            return  # rung not complete yet
        keep = max(1, int(math.floor(len(results) / self.rf)))
        ranked = sorted(results.items(), key=lambda kv: kv[1], reverse=True)
        promoted = {tid for tid, _ in ranked[:keep]}
        self._rung_population[rung + 1] = 0
        from ray_tpu_torch.tune.trial import PAUSED, TERMINATED

        for tid, _ in ranked:
            trial = runner.get_trial(tid)
            if trial is None or trial.status != PAUSED:
                # finished/errored trials cannot be promoted
                continue
            if tid in promoted and rung + 1 <= len(self._milestones):
                self._trial_rung[tid] = rung + 1
                self._rung_population[rung + 1] += 1
                runner.requeue_trial(trial)
            else:
                trial.status = TERMINATED
        self._rung_results[rung] = dict(results)  # freeze
        self._rung_population[rung] = 0  # promotion done
