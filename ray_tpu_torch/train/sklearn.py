"""SklearnTrainer: fit a scikit-learn estimator on a Dataset.

Parity: reference ``python/ray/train/sklearn/sklearn_trainer.py`` — the
fit runs remotely as one task (sklearn is single-node; parallelism
within the estimator comes from joblib; the JAX package's joblib
backend, ``util/joblib``, is ROADMAP.md queue 1 item 7.7), and the fitted
estimator lands in an AIR checkpoint consumable by
``SklearnPredictor``/``BatchPredictor``.  scikit-learn is a CPU library:
the fit runs on the host in both packages.
"""

from __future__ import annotations

import pickle
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint


@ray_tpu_torch.remote
def _fit_task(estimator_pkl: bytes, blocks: List[Dict[str, np.ndarray]],
              label_column: str, feature_columns: Optional[List[str]],
              fit_params: Dict[str, Any]):
    import numpy as np

    est = pickle.loads(estimator_pkl)
    cols = feature_columns
    # block refs arrive nested (unresolved) — fetch zero-copy here
    blocks = ray_tpu_torch.get(list(blocks))
    X_parts, y_parts = [], []
    for block in blocks:
        if cols is None:
            cols = [c for c in block.keys() if c != label_column]
        X_parts.append(np.column_stack([block[c] for c in cols]))
        y_parts.append(block[label_column])
    X = np.concatenate(X_parts)
    y = np.concatenate(y_parts)
    est.fit(X, y, **fit_params)
    score = float(est.score(X, y))
    return pickle.dumps(est), score, cols


class SklearnTrainer:
    def __init__(self, *, estimator: Any, datasets: Dict[str, Any],
                 label_column: str,
                 feature_columns: Optional[List[str]] = None,
                 fit_params: Optional[Dict[str, Any]] = None):
        self.estimator = estimator
        self.datasets = datasets
        self.label_column = label_column
        self.feature_columns = feature_columns
        self.fit_params = fit_params or {}

    def fit(self):
        # air.Result; imported here — ray_tpu_torch.air re-exports train
        # modules, so a module-level import would be circular
        from ray_tpu_torch.air import Result

        train_ds = self.datasets["train"]
        blocks = train_ds.get_internal_block_refs()
        fitted_pkl, train_score, cols = ray_tpu_torch.get(
            _fit_task.remote(pickle.dumps(self.estimator), blocks,
                             self.label_column, self.feature_columns,
                             self.fit_params), timeout=3600)
        checkpoint = Checkpoint.from_dict({
            "estimator_pkl": fitted_pkl,
            "feature_columns": cols,
        })
        metrics = {"train_score": train_score}
        if "valid" in self.datasets:
            from ray_tpu_torch.train.predictor import SklearnPredictor

            pred = SklearnPredictor.from_checkpoint(checkpoint)
            est = pred._est
            vals = [ray_tpu_torch.get(b) for b in
                    self.datasets["valid"].get_internal_block_refs()]
            X = np.concatenate([
                np.column_stack([b[c] for c in cols]) for b in vals])
            y = np.concatenate([b[self.label_column] for b in vals])
            metrics["valid_score"] = float(est.score(X, y))
        return Result(metrics=metrics, checkpoint=checkpoint)
