"""Experiment/trial stoppers (parity: reference ``tune/stopper/``).

A stopper is called per result: ``stopper(trial_id, result) -> bool``
stops that trial; ``stopper.stop_all() -> bool`` ends the experiment.
``RunConfig.stop`` accepts a Stopper, a plain callable, or a dict of
``{metric: threshold}`` (stop when result[metric] >= threshold — the
reference's dict shorthand).
"""

from __future__ import annotations

import time
from collections import defaultdict, deque
from typing import Any, Callable, Dict, Optional


class Stopper:
    def __call__(self, trial_id: str, result: Dict[str, Any]) -> bool:
        raise NotImplementedError

    def stop_all(self) -> bool:
        return False


class MaximumIterationStopper(Stopper):
    """Stop each trial after ``max_iter`` results (reference
    ``stopper/maximum_iteration.py``)."""

    def __init__(self, max_iter: int):
        self._max_iter = int(max_iter)
        self._count: Dict[str, int] = defaultdict(int)

    def __call__(self, trial_id, result) -> bool:
        self._count[trial_id] += 1
        return self._count[trial_id] >= self._max_iter


class TimeoutStopper(Stopper):
    """End the whole experiment after a wall-clock budget (reference
    ``stopper/timeout.py``).  The clock starts at the FIRST check, not
    at construction — a RunConfig built minutes before ``fit()`` must
    not burn its budget during setup."""

    def __init__(self, timeout_s: float):
        self._timeout_s = float(timeout_s)
        self._deadline: Optional[float] = None

    def _arm(self) -> float:
        if self._deadline is None:
            self._deadline = time.monotonic() + self._timeout_s
        return self._deadline

    def __call__(self, trial_id, result) -> bool:
        self._arm()
        return False

    def stop_all(self) -> bool:
        return time.monotonic() >= self._arm()


class FunctionStopper(Stopper):
    """Wraps ``fn(trial_id, result) -> bool`` (reference
    ``stopper/function_stopper.py``)."""

    def __init__(self, fn: Callable[[str, Dict[str, Any]], bool]):
        self._fn = fn

    def __call__(self, trial_id, result) -> bool:
        return bool(self._fn(trial_id, result))


class TrialPlateauStopper(Stopper):
    """Stop a trial whose metric stopped moving: std of the last
    ``num_results`` values <= ``std`` after ``grace_period`` results
    (reference ``stopper/trial_plateau.py``)."""

    def __init__(self, metric: str, *, std: float = 0.01,
                 num_results: int = 4, grace_period: int = 4,
                 mode: Optional[str] = None):
        self._metric = metric
        self._std = float(std)
        self._num_results = int(num_results)
        self._grace = int(grace_period)
        self._window: Dict[str, deque] = defaultdict(
            lambda: deque(maxlen=self._num_results))
        self._count: Dict[str, int] = defaultdict(int)

    def __call__(self, trial_id, result) -> bool:
        val = result.get(self._metric)
        if val is None or val != val:
            return False
        self._count[trial_id] += 1
        window = self._window[trial_id]
        window.append(float(val))
        if self._count[trial_id] < self._grace \
                or len(window) < self._num_results:
            return False
        mean = sum(window) / len(window)
        var = sum((x - mean) ** 2 for x in window) / len(window)
        return var ** 0.5 <= self._std


class ExperimentPlateauStopper(Stopper):
    """End the experiment when the ``top``-N best values of ``metric``
    have converged: their std stays <= ``std`` for ``patience``
    consecutive results (reference ``stopper/experiment_plateau.py``
    semantics — tolerance-based, so metric noise below ``std`` cannot
    keep the experiment alive forever)."""

    def __init__(self, metric: str, *, mode: str = "min",
                 patience: int = 0, top: int = 10, std: float = 0.001):
        self._metric = metric
        self._mode = mode
        self._patience = int(patience)
        self._top = int(top)
        self._std = float(std)
        self._values: list = []
        self._stale = 0
        self._plateaued = False

    def __call__(self, trial_id, result) -> bool:
        val = result.get(self._metric)
        if val is None or val != val:
            return False
        self._values.append(float(val))
        best = sorted(self._values, reverse=(self._mode == "max"))
        top = best[:self._top]
        if len(top) < self._top:
            self._stale = 0
            self._plateaued = False
            return False
        mean = sum(top) / len(top)
        var = sum((x - mean) ** 2 for x in top) / len(top)
        self._plateaued = var ** 0.5 <= self._std
        if self._plateaued:
            self._stale += 1
        else:
            self._stale = 0
        return False

    def stop_all(self) -> bool:
        # patience=0 stops on the FIRST plateau (reference semantics);
        # patience=k demands k consecutive plateaued results
        return self._plateaued and self._stale >= self._patience


class CombinedStopper(Stopper):
    """OR-combination (reference ``stopper/stopper.py``)."""

    def __init__(self, *stoppers: Stopper):
        self._stoppers = stoppers

    def __call__(self, trial_id, result) -> bool:
        return any(s(trial_id, result) for s in self._stoppers)

    def stop_all(self) -> bool:
        return any(s.stop_all() for s in self._stoppers)


class _DictStopper(Stopper):
    """{metric: threshold} shorthand: stop a trial when any metric
    reaches its threshold (``training_iteration`` counts results)."""

    def __init__(self, spec: Dict[str, float]):
        self._spec = dict(spec)
        self._count: Dict[str, int] = defaultdict(int)

    def __call__(self, trial_id, result) -> bool:
        self._count[trial_id] += 1
        for metric, threshold in self._spec.items():
            if metric == "training_iteration":
                # prefer the REPORTED iteration (a trainable reporting
                # every k-th iteration must still stop at the budget);
                # fall back to the result count when unreported
                it = result.get("training_iteration",
                                self._count[trial_id])
                if it is not None and it >= threshold:
                    return True
                continue
            val = result.get(metric)
            if val is not None and val == val and val >= threshold:
                return True
        return False


def resolve_stopper(stop: Any) -> Optional[Stopper]:
    """RunConfig.stop -> Stopper (dict / callable / Stopper accepted)."""
    if stop is None:
        return None
    if isinstance(stop, Stopper):
        return stop
    if isinstance(stop, dict):
        return _DictStopper(stop)
    if callable(stop):
        return FunctionStopper(stop)
    raise ValueError(f"unsupported stop spec {type(stop).__name__}")
