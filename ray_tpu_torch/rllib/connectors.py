"""Connectors: composable obs/action transformation pipelines.

Parity: reference ``rllib/connectors/`` — small, stateless-or-stateful
transforms between env and policy: agent-side (observation) connectors
run before ``compute_actions``; action connectors run on the way back
to the env.  Pipelines serialize with the policy so a restored policy
reproduces exactly the preprocessing it was trained with.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np


class Connector:
    """One transform; subclasses override ``__call__``."""

    def __call__(self, x: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def to_state(self) -> Dict[str, Any]:
        return {"type": type(self).__name__}

    # registry-based round trip
    @staticmethod
    def from_state(state: Dict[str, Any]) -> "Connector":
        cls = _REGISTRY[state["type"]]
        kwargs = {k: v for k, v in state.items() if k != "type"}
        return cls(**kwargs)


class FlattenObs(Connector):
    """[..., *obs_shape] -> [..., prod(obs_shape)]."""

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return np.asarray(x).reshape(x.shape[0], -1)


class ClipObs(Connector):
    def __init__(self, low: float = -10.0, high: float = 10.0):
        self.low, self.high = float(low), float(high)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return np.clip(x, self.low, self.high)

    def to_state(self):
        return {"type": "ClipObs", "low": self.low, "high": self.high}


class NormalizeObs(Connector):
    """Running mean/std normalization (reference
    ``MeanStdObservationFilterAgentConnector``); stateful — the running
    moments travel in the connector state."""

    def __init__(self, shape: Any = None, mean=None, var=None,
                 count: float = 1e-4, update: bool = True):
        self.mean = np.zeros(shape, np.float64) if mean is None \
            else np.asarray(mean, np.float64)
        self.var = np.ones(shape, np.float64) if var is None \
            else np.asarray(var, np.float64)
        self.count = float(count)
        self.update = update

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if self.update:
            batch_mean = x.mean(axis=0)
            batch_var = x.var(axis=0)
            n = x.shape[0]
            delta = batch_mean - self.mean
            tot = self.count + n
            self.mean = self.mean + delta * n / tot
            m_a = self.var * self.count
            m_b = batch_var * n
            self.var = (m_a + m_b + delta ** 2 * self.count * n / tot) / tot
            self.count = tot
        return ((x - self.mean)
                / np.sqrt(self.var + 1e-8)).astype(np.float32)

    def to_state(self):
        return {"type": "NormalizeObs", "shape": None,
                "mean": self.mean.tolist(), "var": self.var.tolist(),
                "count": self.count, "update": self.update}


class ClipActions(Connector):
    """Clip continuous actions into the env bounds (reference
    ``ClipActionsConnector``)."""

    def __init__(self, low: Any = -1.0, high: Any = 1.0):
        self.low, self.high = low, high

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return np.clip(x, self.low, self.high)

    def to_state(self):
        return {"type": "ClipActions",
                "low": np.asarray(self.low).tolist(),
                "high": np.asarray(self.high).tolist()}


_REGISTRY = {c.__name__: c for c in
             (FlattenObs, ClipObs, NormalizeObs, ClipActions)}


def register_connector(cls: type) -> type:
    _REGISTRY[cls.__name__] = cls
    return cls


class ConnectorPipeline:
    """Ordered connector list (reference ``ConnectorPipeline``)."""

    def __init__(self, connectors: Optional[List[Connector]] = None):
        self.connectors: List[Connector] = list(connectors or [])

    def __call__(self, x: np.ndarray) -> np.ndarray:
        for c in self.connectors:
            x = c(x)
        return x

    def append(self, connector: Connector) -> "ConnectorPipeline":
        self.connectors.append(connector)
        return self

    def to_state(self) -> List[Dict[str, Any]]:
        return [c.to_state() for c in self.connectors]

    @classmethod
    def from_state(cls, state: List[Dict[str, Any]]) -> "ConnectorPipeline":
        return cls([Connector.from_state(s) for s in state])
