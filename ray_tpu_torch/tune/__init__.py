"""ray_tpu_torch.tune — distributed hyperparameter search.

Parity: reference ``python/ray/tune`` — ``Tuner``/``tune.run`` (tune.py:131),
trial actors over the core runtime, ASHA/PBT/median-stopping schedulers,
grid/random search spaces, checkpointed fault-tolerant trials.

The port's copy of the JAX package's Tune: the searchers,
schedulers and stoppers take the same decisions from the same seeds and
results.  Trials lease ``{"GPU": x}`` (a ``"TPU"`` key raises
``TypeError``); a trial holding a GPU lease runs its trainable with that
GPU as the current device.  Importing the package imports no torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch import _port
from ray_tpu_torch.train.config import CheckpointConfig, FailureConfig, RunConfig
from ray_tpu_torch.tune import schedulers  # noqa: F401
from ray_tpu_torch.tune.bohb import BOHBSearcher, HyperBandForBOHB  # noqa: F401
from ray_tpu_torch.tune.callback import (Callback, CSVLoggerCallback,  # noqa: F401
                                   JsonLoggerCallback, TBXLoggerCallback)
from ray_tpu_torch.tune.execution import TrialRunner
from ray_tpu_torch.tune.progress_reporter import CLIReporter  # noqa: F401
from ray_tpu_torch.tune.stopper import (CombinedStopper,  # noqa: F401
                                  ExperimentPlateauStopper,
                                  FunctionStopper,
                                  MaximumIterationStopper, Stopper,
                                  TimeoutStopper, TrialPlateauStopper)
from ray_tpu_torch.tune.schedulers import (AsyncHyperBandScheduler,  # noqa: F401
                                     FIFOScheduler, HyperBandScheduler,
                                     MedianStoppingRule,
                                     PopulationBasedTraining, TrialScheduler)
from ray_tpu_torch.tune.search import (BasicVariantGenerator, BayesOptSearch,  # noqa: F401
                                 HyperOptSearch, OptunaSearch, Searcher,
                                 TPESearch, choice, grid_search, loguniform,
                                 quniform, randint, sample_from, uniform)
from ray_tpu_torch.tune.trial import (ERROR, PENDING, TERMINATED, Trial,  # noqa: F401
                                get_checkpoint, report)


@dataclass
class TuneConfig:
    """Parity: reference ``tune/tune_config.py``."""

    metric: Optional[str] = None
    #: None = unset; resolved to "max" where needed so an explicitly
    #: configured searcher's mode is never silently overridden
    mode: Optional[str] = None
    num_samples: int = 1
    max_concurrent_trials: int = 0
    scheduler: Optional[TrialScheduler] = None
    #: sequential suggester (e.g. BayesOptSearch); when set, param_space
    #: sampling is delegated to it, fed back trial results
    search_alg: Optional[Searcher] = None
    search_seed: Optional[int] = None


class Result:
    """Parity: reference ``air/result.py``."""

    def __init__(self, trial: Trial):
        self.config = trial.config
        self.metrics = trial.last_result
        self.checkpoint = trial.checkpoint
        self.error = trial.error
        self.metrics_history = trial.results
        self.trial_id = trial.trial_id

    def __repr__(self) -> str:
        return f"Result(trial={self.trial_id}, metrics={self.metrics})"


class ResultGrid:
    """Parity: reference ``tune/result_grid.py``."""

    def __init__(self, trials: List[Trial], metric: Optional[str],
                 mode: str):
        self._trials = trials
        self._metric = metric
        self._mode = mode

    def __len__(self) -> int:
        return len(self._trials)

    def __getitem__(self, i: int) -> Result:
        return Result(self._trials[i])

    @property
    def errors(self) -> List[str]:
        return [t.error for t in self._trials if t.error]

    def get_best_result(self, metric: Optional[str] = None,
                        mode: Optional[str] = None) -> Result:
        metric = metric or self._metric
        mode = mode or self._mode
        if metric is None:
            raise ValueError("metric required")
        sign = 1 if mode == "max" else -1
        best = None
        best_v = None
        for t in self._trials:
            v = t.last_result.get(metric)
            # fall back to the best intermediate result (early-stopped trials)
            for r in t.results:
                rv = r.get(metric)
                if rv is not None and (v is None or sign * rv > sign * v):
                    v = rv
            if v is None:
                continue
            if best_v is None or sign * v > sign * best_v:
                best, best_v = t, v
        if best is None:
            raise RuntimeError("no trial reported the metric " + str(metric))
        return Result(best)

    def get_dataframe(self):
        import pandas as pd

        return pd.DataFrame([{**t.last_result,
                              **{f"config/{k}": v for k, v in t.config.items()},
                              "trial_id": t.trial_id, "status": t.status}
                             for t in self._trials])


class Tuner:
    """Parity: reference ``tune/tuner.py`` Tuner / ``tune.run``."""

    def __init__(self, trainable: Callable[[Dict[str, Any]], Any], *,
                 param_space: Optional[Dict[str, Any]] = None,
                 tune_config: Optional[TuneConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 resources_per_trial: Optional[Dict[str, float]] = None):
        _port.reject_tpu_resources("resources_per_trial", resources_per_trial)
        self.trainable = trainable
        self.param_space = param_space or {}
        self.tune_config = tune_config or TuneConfig()
        self.run_config = run_config or RunConfig()
        self.resources_per_trial = resources_per_trial
        self._restored_trials: Optional[List[Trial]] = None

    @classmethod
    def restore(cls, path: str, trainable: Callable[[Dict[str, Any]], Any],
                *, resume_errored: bool = True,
                resources_per_trial: Optional[Dict[str, float]] = None
                ) -> "Tuner":
        """Resume an experiment from its durable storage URI.

        Parity: reference ``Tuner.restore(path, trainable)`` — rebuild
        every trial from the synced experiment state; finished trials
        keep their results, unfinished (and, with ``resume_errored``,
        failed) trials restart FROM THEIR LAST SYNCED CHECKPOINT on a
        completely fresh cluster.  ``path`` is the experiment URI
        (``<storage_path>/<name>``).  The search algorithm is not
        resumed — remaining trials run as recorded (reference restores
        searcher state; noted limitation).
        """
        import tempfile

        from ray_tpu_torch.air import storage
        from ray_tpu_torch.train.checkpoint import Checkpoint
        from ray_tpu_torch.tune.execution import ExperimentSync

        state = ExperimentSync.load(path)
        meta = state.get("meta", {})
        root, _, name = path.rstrip("/").rpartition("/")
        run_config = RunConfig(name=name or None, storage_path=root or ".")
        tuner = cls(trainable,
                    tune_config=TuneConfig(
                        metric=meta.get("metric"), mode=meta.get("mode")),
                    run_config=run_config,
                    resources_per_trial=resources_per_trial)
        trials: List[Trial] = []
        for ts in state["trials"]:
            t = Trial(config=ts["config"], trial_id=ts["trial_id"])
            t.last_result = ts.get("last_result") or {}
            t.results = ts.get("results") or []
            t.error = ts.get("error")
            t.num_failures = int(ts.get("num_failures", 0))
            t.checkpoint_uri = ts.get("checkpoint_uri")
            if t.checkpoint_uri and storage.exists(t.checkpoint_uri):
                local = tempfile.mkdtemp(prefix=f"rtpu_restore_{t.trial_id}_")
                storage.download_dir(t.checkpoint_uri, local)
                # dict-backed: the checkpoint must survive pickling to a
                # trial actor on ANOTHER host — a directory-backed object
                # would ship only this driver's local tempdir path
                t.checkpoint = Checkpoint.from_dict(
                    Checkpoint.from_directory(local).to_dict())
            status = ts.get("status")
            if status == TERMINATED:
                t.status = TERMINATED
            elif status == ERROR and not resume_errored:
                t.status = ERROR
            else:  # PENDING/RUNNING/PAUSED (+ ERROR when resuming them)
                t.status = PENDING
                t.error = None
            trials.append(t)
        tuner._restored_trials = trials
        return tuner

    def fit(self) -> ResultGrid:
        # a trainer that defines as_trainable() runs as its trainable
        trainable = self.trainable
        if hasattr(trainable, "as_trainable"):
            trainable = trainable.as_trainable()
        if self._restored_trials is None:
            search_alg = self.tune_config.search_alg
            if search_alg is not None:
                return self._fit_with_searcher(trainable, search_alg)
            gen = BasicVariantGenerator(seed=self.tune_config.search_seed)
            configs = gen.generate(self.param_space,
                                   self.tune_config.num_samples)
            trials = [Trial(config=c) for c in configs]
        else:
            # resumed experiment: the recorded trial table IS the plan —
            # finished trials keep results, pending ones run (from their
            # restored checkpoints via TrialActor.run)
            trials = self._restored_trials
        scheduler = self.tune_config.scheduler
        if scheduler is not None:
            # propagate metric/mode if the scheduler was built without them
            if getattr(scheduler, "metric", None) is None:
                scheduler.metric = self.tune_config.metric
                scheduler.mode = self.tune_config.mode or "max"
        runner = TrialRunner(
            trainable, trials, scheduler=scheduler,
            max_concurrent=self.tune_config.max_concurrent_trials,
            resources_per_trial=self.resources_per_trial,
            run_config=self.run_config,
            sync_meta={"metric": self.tune_config.metric,
                       "mode": self.tune_config.mode})
        runner.run()
        return ResultGrid(trials, self.tune_config.metric,
                          self.tune_config.mode or "max")


    def _fit_with_searcher(self, trainable, search_alg) -> ResultGrid:
        """Sequential suggest -> run -> feed-back loop (parity:
        SearchGenerator driving the reference TrialRunner); concurrency
        within a wave = max_concurrent_trials."""
        if search_alg.metric is None:
            search_alg.metric = self.tune_config.metric
        if self.tune_config.mode is not None:
            # explicit run-level direction wins; when the run didn't set
            # one, the searcher's own mode stands
            search_alg.mode = self.tune_config.mode
        # non-Domain param_space entries are constants merged into every
        # suggestion (suggestions win on conflicts)
        from ray_tpu_torch.tune.search import Domain, _is_grid
        constants = {k: v for k, v in self.param_space.items()
                     if not isinstance(v, Domain) and not _is_grid(v)}
        scheduler = self.tune_config.scheduler
        if scheduler is not None and \
                getattr(scheduler, "metric", None) is None:
            scheduler.metric = self.tune_config.metric
            scheduler.mode = self.tune_config.mode or "max"
        wave = max(1, self.tune_config.max_concurrent_trials or 1)
        all_trials: List[Trial] = []
        remaining = self.tune_config.num_samples
        i = 0
        while remaining > 0:
            batch = []
            for _ in range(min(wave, remaining)):
                cfg = search_alg.suggest(f"sugg_{i}")
                if cfg is None:
                    remaining = 0
                    break
                trial = Trial(config={**constants, **cfg})
                # schedulers report mid-run observations to the searcher
                # under this id (see HyperBandForBOHB)
                trial.searcher_id = f"sugg_{i}"
                batch.append((f"sugg_{i}", trial))
                i += 1
            if not batch:
                break
            remaining -= len(batch)
            runner = TrialRunner(
                trainable, [t for _, t in batch],
                scheduler=scheduler,
                max_concurrent=len(batch),
                resources_per_trial=self.resources_per_trial,
                run_config=self.run_config)
            runner.run()
            for sid, trial in batch:
                search_alg.on_trial_complete(sid, trial.last_result)
                all_trials.append(trial)
        return ResultGrid(all_trials, self.tune_config.metric,
                          self.tune_config.mode or "max")


def run(trainable: Callable, *, config: Optional[Dict[str, Any]] = None,
        num_samples: int = 1, metric: Optional[str] = None,
        mode: Optional[str] = None,
        scheduler: Optional[TrialScheduler] = None,
        search_alg: Optional[Searcher] = None,
        resources_per_trial: Optional[Dict[str, float]] = None,
        max_concurrent_trials: int = 0, **_ignored) -> ResultGrid:
    """Functional entry point (parity: ``tune.run`` tune.py:131)."""
    tuner = Tuner(
        trainable, param_space=config,
        tune_config=TuneConfig(metric=metric, mode=mode,
                               num_samples=num_samples, scheduler=scheduler,
                               search_alg=search_alg,
                               max_concurrent_trials=max_concurrent_trials),
        resources_per_trial=resources_per_trial)
    return tuner.fit()
