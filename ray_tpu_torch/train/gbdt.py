"""XGBoost / LightGBM trainers.

Parity: reference ``train/gbdt_trainer.py`` + ``train/xgboost/`` /
``train/lightgbm/`` — tree boosting fitted from Dataset blocks with the
fit running as a cluster task, metrics per boosting round, and the
booster persisted in an AIR checkpoint for ``BatchPredictor``.  The
libraries are optional (not baked into this image): constructing a
trainer without the library raises ImportError with install guidance,
mirroring the reference's soft-dependency pattern.  Neither library is
installed beside the port, which keeps the JAX package's gate.
"""

from __future__ import annotations

import importlib.util
import pickle
from typing import Any, Dict, List, Optional

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.train.checkpoint import Checkpoint


def _blocks_to_xy(blocks: List[Dict[str, np.ndarray]], label_column: str,
                  feature_columns: Optional[List[str]]):
    cols = feature_columns
    X_parts, y_parts = [], []
    for block in blocks:
        if cols is None:
            cols = [c for c in block.keys() if c != label_column]
        X_parts.append(np.column_stack([block[c] for c in cols]))
        y_parts.append(block[label_column])
    return np.concatenate(X_parts), np.concatenate(y_parts), cols


@ray_tpu_torch.remote
def _xgboost_fit_task(params: Dict[str, Any], num_boost_round: int,
                      blocks, label_column: str,
                      feature_columns: Optional[List[str]]):
    import xgboost as xgb

    blocks = ray_tpu_torch.get(list(blocks))
    X, y, cols = _blocks_to_xy(blocks, label_column, feature_columns)
    dtrain = xgb.DMatrix(X, label=y)
    evals_result: Dict[str, Any] = {}
    booster = xgb.train(params, dtrain, num_boost_round=num_boost_round,
                        evals=[(dtrain, "train")],
                        evals_result=evals_result, verbose_eval=False)
    return booster.save_raw(), evals_result, cols


@ray_tpu_torch.remote
def _lightgbm_fit_task(params: Dict[str, Any], num_boost_round: int,
                       blocks, label_column: str,
                       feature_columns: Optional[List[str]]):
    import lightgbm as lgb

    blocks = ray_tpu_torch.get(list(blocks))
    X, y, cols = _blocks_to_xy(blocks, label_column, feature_columns)
    dtrain = lgb.Dataset(X, label=y)
    evals_result: Dict[str, Any] = {}
    booster = lgb.train(params, dtrain, num_boost_round=num_boost_round,
                        valid_sets=[dtrain], valid_names=["train"],
                        callbacks=[lgb.record_evaluation(evals_result)])
    return booster.model_to_string(), evals_result, cols


class _GBDTTrainer:
    _module: str = ""
    _fit_task = None
    _model_key: str = ""

    def __init__(self, *, params: Dict[str, Any],
                 datasets: Dict[str, Any], label_column: str,
                 num_boost_round: int = 10,
                 feature_columns: Optional[List[str]] = None):
        if importlib.util.find_spec(self._module) is None:
            raise ImportError(
                f"{type(self).__name__} requires the optional dependency "
                f"{self._module!r} (pip install {self._module}); it is "
                f"not bundled with ray_tpu_torch")
        self.params = dict(params)
        self.datasets = datasets
        self.label_column = label_column
        self.num_boost_round = int(num_boost_round)
        self.feature_columns = feature_columns

    def fit(self):
        from ray_tpu_torch.air import Result

        blocks = self.datasets["train"].get_internal_block_refs()
        model_blob, evals_result, cols = ray_tpu_torch.get(
            self._fit_task.remote(self.params, self.num_boost_round,
                                  blocks, self.label_column,
                                  self.feature_columns),
            timeout=3600)
        checkpoint = Checkpoint.from_dict({
            self._model_key: model_blob,
            "feature_columns": cols,
        })
        metrics = {
            f"train-{metric}": values[-1]
            for metric, values in evals_result.get("train", {}).items()}
        return Result(metrics=metrics, checkpoint=checkpoint)


class XGBoostTrainer(_GBDTTrainer):
    _module = "xgboost"
    _fit_task = _xgboost_fit_task
    _model_key = "xgboost_model_raw"


class LightGBMTrainer(_GBDTTrainer):
    _module = "lightgbm"
    _fit_task = _lightgbm_fit_task
    _model_key = "lightgbm_model_str"
