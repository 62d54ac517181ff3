"""Search spaces and suggestion algorithms.

Parity: reference ``python/ray/tune/search/`` — sample-space primitives
(``tune.uniform`` … ``tune.grid_search``, sample.py), the
``BasicVariantGenerator`` grid/random resolver (basic_variant.py), plus
native model-based searchers: ``BayesOptSearch`` (GP expected
improvement) and ``TPESearch`` below; external Optuna/HyperOpt adapters
are gated behind soft imports."""

from __future__ import annotations

import itertools
import random
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional


class Domain:
    def sample(self, rng: random.Random) -> Any:
        raise NotImplementedError


@dataclass
class Uniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        return rng.uniform(self.low, self.high)


@dataclass
class LogUniform(Domain):
    low: float
    high: float

    def sample(self, rng):
        import math

        return math.exp(rng.uniform(math.log(self.low), math.log(self.high)))


@dataclass
class RandInt(Domain):
    low: int
    high: int

    def sample(self, rng):
        return rng.randrange(self.low, self.high)


@dataclass
class Choice(Domain):
    categories: List[Any]

    def sample(self, rng):
        return rng.choice(self.categories)


@dataclass
class Quantized(Domain):
    base: Domain
    q: float

    def sample(self, rng):
        v = self.base.sample(rng)
        return round(v / self.q) * self.q


@dataclass
class GridSearch:
    values: List[Any]


def uniform(low: float, high: float) -> Uniform:
    return Uniform(low, high)


def loguniform(low: float, high: float) -> LogUniform:
    return LogUniform(low, high)


def randint(low: int, high: int) -> RandInt:
    return RandInt(low, high)


def choice(categories: List[Any]) -> Choice:
    return Choice(list(categories))


def quniform(low: float, high: float, q: float) -> Quantized:
    return Quantized(Uniform(low, high), q)


def grid_search(values: List[Any]) -> Dict[str, Any]:
    return {"grid_search": list(values)}


def sample_from(fn: Callable[[Dict[str, Any]], Any]) -> "Function":
    return Function(fn)


@dataclass
class Function(Domain):
    fn: Callable

    def sample(self, rng):
        return self.fn(None)


def _is_grid(v) -> bool:
    return isinstance(v, dict) and set(v.keys()) == {"grid_search"}


class BasicVariantGenerator:
    """Resolves a param_space into trial configs: cartesian product over
    grid_search values × num_samples random draws of Domain params.
    Parity: reference ``tune/search/basic_variant.py``."""

    def __init__(self, seed: Optional[int] = None):
        self._rng = random.Random(seed)

    def generate(self, param_space: Dict[str, Any], num_samples: int
                 ) -> List[Dict[str, Any]]:
        grid_keys = [k for k, v in param_space.items() if _is_grid(v)]
        grid_values = [param_space[k]["grid_search"] for k in grid_keys]
        configs: List[Dict[str, Any]] = []
        grids = list(itertools.product(*grid_values)) if grid_keys else [()]
        for _ in range(num_samples):
            for combo in grids:
                cfg = {}
                for k, v in param_space.items():
                    if k in grid_keys:
                        cfg[k] = combo[grid_keys.index(k)]
                    elif isinstance(v, Domain):
                        cfg[k] = v.sample(self._rng)
                    elif isinstance(v, dict) and not _is_grid(v):
                        cfg[k] = self._resolve_nested(v)
                    else:
                        cfg[k] = v
                configs.append(cfg)
        return configs

    def _resolve_nested(self, space: Dict[str, Any]) -> Dict[str, Any]:
        out = {}
        for k, v in space.items():
            if isinstance(v, Domain):
                out[k] = v.sample(self._rng)
            elif isinstance(v, dict) and _is_grid(v):
                out[k] = self._rng.choice(v["grid_search"])
            elif isinstance(v, dict):
                out[k] = self._resolve_nested(v)
            else:
                out[k] = v
        return out


class Searcher:
    """Pluggable suggestion interface (parity: tune/search/searcher.py).
    Subclasses implement ``suggest``/``on_trial_complete``."""

    def __init__(self, metric: Optional[str] = None, mode: str = "max"):
        self.metric = metric
        self.mode = mode

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None) -> None:
        pass


class BayesOptSearch(Searcher):
    """Gaussian-process Bayesian optimization (parity role: reference
    ``tune/search/bayesopt`` — that wraps the external bayesian-
    optimization package; here the GP comes from scikit-learn, which is
    part of this image, so the capability is native).

    Numeric domains (Uniform/LogUniform/RandInt/Quantized) are encoded
    to [0,1]; Choice is one-hot-free ordinal (fine at these dims).
    Suggestions maximize UCB (kappa-weighted) over random candidates —
    after ``n_initial_points`` random draws.
    """

    def __init__(self, space: Dict[str, Any], *,
                 metric: Optional[str] = None, mode: str = "max",
                 n_initial_points: int = 5, kappa: float = 2.5,
                 seed: Optional[int] = None):
        super().__init__(metric, mode)
        grids = [k for k, v in space.items() if _is_grid(v)]
        if grids:
            raise ValueError(
                f"grid_search entries {grids} are incompatible with a "
                f"sequential searcher; enumerate them as Choice domains "
                f"or use BasicVariantGenerator")
        self.space = {k: v for k, v in space.items()
                      if isinstance(v, Domain)}
        self.constants = {k: v for k, v in space.items()
                          if not isinstance(v, Domain)}
        self.n_initial = n_initial_points
        self.kappa = kappa
        self._rng = random.Random(seed)
        self._np_rng = __import__("numpy").random.default_rng(seed)
        self._X: List[List[float]] = []
        self._y: List[float] = []
        self._pending: Dict[str, List[float]] = {}

    # -- decode from the unit cube -------------------------------------
    def _decode(self, x: List[float]) -> Dict[str, Any]:
        import math
        out = dict(self.constants)
        for u, (key, dom) in zip(x, sorted(self.space.items())):
            u = min(1.0, max(0.0, u))
            if isinstance(dom, Uniform):
                out[key] = dom.low + u * (dom.high - dom.low)
            elif isinstance(dom, LogUniform):
                out[key] = math.exp(
                    math.log(dom.low)
                    + u * (math.log(dom.high) - math.log(dom.low)))
            elif isinstance(dom, RandInt):
                # exclusive high, matching RandInt.sample's randrange
                out[key] = min(dom.high - 1,
                               int(dom.low + u * (dom.high - dom.low)))
            elif isinstance(dom, Quantized):
                base = dom.base
                raw = base.low + u * (base.high - base.low)
                out[key] = round(raw / dom.q) * dom.q
            elif isinstance(dom, Choice):
                idx = int(round(u * (len(dom.categories) - 1)))
                out[key] = dom.categories[idx]
            else:
                out[key] = dom.sample(self._rng)
        return out

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        import numpy as np
        dims = len(self.space)
        if len(self._X) < self.n_initial or dims == 0:
            x = [self._rng.random() for _ in range(dims)]
        else:
            from sklearn.gaussian_process import GaussianProcessRegressor
            from sklearn.gaussian_process.kernels import Matern

            gp = GaussianProcessRegressor(
                kernel=Matern(nu=2.5), alpha=1e-6, normalize_y=True)
            y = np.asarray(self._y)
            if self.mode == "min":
                y = -y
            gp.fit(np.asarray(self._X), y)
            cands = self._np_rng.random((256, dims))
            mu, sigma = gp.predict(cands, return_std=True)
            x = list(map(float, cands[int(np.argmax(
                mu + self.kappa * sigma))]))
        self._pending[trial_id] = x
        return self._decode(x)

    def on_trial_complete(self, trial_id: str,
                          result: Optional[Dict[str, Any]] = None) -> None:
        x = self._pending.pop(trial_id, None)
        if x is None or result is None or self.metric not in result:
            return
        self._X.append(x)
        self._y.append(float(result[self.metric]))


class TPESearch(BayesOptSearch):
    """Tree-structured Parzen Estimator (the algorithm behind the
    reference's Optuna/HyperOpt integrations, ``tune/search/optuna`` /
    ``tune/search/hyperopt`` — implemented natively so the capability
    needs no external package).

    Observations in the unit cube are split at the gamma-quantile into
    good/bad sets; candidates are drawn from a Parzen (Gaussian-kernel)
    density over the good set and ranked by the density ratio l(x)/g(x).
    Shares the domain encoding/decoding with :class:`BayesOptSearch`.
    """

    def __init__(self, space: Dict[str, Any], *,
                 metric: Optional[str] = None, mode: str = "max",
                 n_initial_points: int = 8, gamma: float = 0.25,
                 n_candidates: int = 64, seed: Optional[int] = None):
        super().__init__(space, metric=metric, mode=mode,
                         n_initial_points=n_initial_points, seed=seed)
        self.gamma = gamma
        self.n_candidates = n_candidates

    def suggest(self, trial_id: str) -> Optional[Dict[str, Any]]:
        import numpy as np

        dims = len(self.space)
        if len(self._X) < self.n_initial or dims == 0:
            x = [self._rng.random() for _ in range(dims)]
            self._pending[trial_id] = x
            return self._decode(x)
        X = np.asarray(self._X)
        y = np.asarray(self._y)
        if self.mode == "min":
            y = -y
        # split: top-gamma fraction are "good"
        n_good = max(1, int(np.ceil(self.gamma * len(y))))
        order = np.argsort(-y)
        good, bad = X[order[:n_good]], X[order[n_good:]]
        if len(bad) == 0:
            bad = X
        # Parzen bandwidth per Scott's rule, floored for tiny samples
        bw = max(0.1, len(good) ** (-1.0 / (dims + 4)) * 0.5)

        def log_density(points, data):
            # [C, N] squared distances -> log mean kernel
            d2 = ((points[:, None, :] - data[None, :, :]) ** 2).sum(-1)
            log_k = -0.5 * d2 / bw ** 2
            m = log_k.max(axis=1, keepdims=True)
            return (m[:, 0] + np.log(
                np.exp(log_k - m).sum(axis=1) / data.shape[0]))

        # sample candidates around good points (the l(x) mixture)
        centers = good[self._np_rng.integers(0, len(good),
                                             self.n_candidates)]
        cands = np.clip(
            centers + self._np_rng.normal(0, bw, centers.shape), 0.0, 1.0)
        score = log_density(cands, good) - log_density(cands, bad)
        x = list(map(float, cands[int(np.argmax(score))]))
        self._pending[trial_id] = x
        return self._decode(x)


def _gated_external_searcher(name: str, package: str):
    class _Gated(Searcher):
        def __init__(self, *args, **kwargs):
            raise ImportError(
                f"{name} wraps the optional package {package!r}, which "
                f"is not bundled with ray_tpu_torch (pip install {package}); "
                f"TPESearch provides the same algorithm natively")

    _Gated.__name__ = name
    _Gated.__qualname__ = name
    return _Gated


# The reference integrates external suggestion libraries; this image
# does not bundle them, and TPESearch covers the algorithm natively.
OptunaSearch = _gated_external_searcher("OptunaSearch", "optuna")
HyperOptSearch = _gated_external_searcher("HyperOptSearch", "hyperopt")
