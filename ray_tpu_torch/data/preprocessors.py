"""Preprocessors (parity: reference ``python/ray/data/preprocessors/`` —
scalers, encoders, batch mapper, concatenator, chain).  fit computes
statistics with dataset aggregations; transform is a lazy map_batches."""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.data.dataset import Dataset


class Preprocessor:
    """Base class (parity: ``data/preprocessor.py``): fit() computes state,
    transform() applies it lazily; fit_transform chains both."""

    _is_fitted = False

    def fit(self, ds: Dataset) -> "Preprocessor":
        self._fit(ds)
        self._is_fitted = True
        return self

    def transform(self, ds: Dataset) -> Dataset:
        if not self._is_fitted and self._needs_fit():
            raise RuntimeError(f"{type(self).__name__} must be fit first")
        return ds.map_batches(self._transform_numpy, batch_format="numpy")

    def fit_transform(self, ds: Dataset) -> Dataset:
        return self.fit(ds).transform(ds)

    def transform_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self._transform_numpy(dict(batch))

    def _needs_fit(self) -> bool:
        return True

    def _fit(self, ds: Dataset) -> None:
        pass

    def _transform_numpy(self, batch):
        raise NotImplementedError


class StandardScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, Any] = {}

    def _fit(self, ds: Dataset) -> None:
        for c in self.columns:
            self.stats_[c] = (ds.mean(c), ds.std(c) or 1.0)

    def _transform_numpy(self, batch):
        for c in self.columns:
            mean, std = self.stats_[c]
            batch[c] = (batch[c] - mean) / (std if std else 1.0)
        return batch


class MinMaxScaler(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, Any] = {}

    def _fit(self, ds: Dataset) -> None:
        for c in self.columns:
            self.stats_[c] = (ds.min(c), ds.max(c))

    def _transform_numpy(self, batch):
        for c in self.columns:
            lo, hi = self.stats_[c]
            rng = (hi - lo) or 1.0
            batch[c] = (batch[c] - lo) / rng
        return batch


class LabelEncoder(Preprocessor):
    def __init__(self, label_column: str):
        self.label_column = label_column
        self.stats_: Dict[Any, int] = {}

    def _fit(self, ds: Dataset) -> None:
        import ray_tpu_torch

        blocks = ray_tpu_torch.get(ds.get_internal_block_refs())
        vals = sorted(set(
            v.item() if hasattr(v, "item") else v
            for b in blocks
            for v in np.unique(np.asarray(b[self.label_column]))))
        self.stats_ = {v: i for i, v in enumerate(vals)}

    def _transform_numpy(self, batch):
        col = batch[self.label_column]
        batch[self.label_column] = np.asarray(
            [self.stats_[v.item() if hasattr(v, "item") else v] for v in col])
        return batch


class OneHotEncoder(Preprocessor):
    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, List[Any]] = {}

    def _fit(self, ds: Dataset) -> None:
        import ray_tpu_torch

        blocks = ray_tpu_torch.get(ds.get_internal_block_refs())
        for c in self.columns:
            vals = sorted(set(
                v.item() if hasattr(v, "item") else v
                for b in blocks for v in np.unique(np.asarray(b[c]))))
            self.stats_[c] = vals

    def _transform_numpy(self, batch):
        for c in self.columns:
            vals = self.stats_[c]
            col = batch.pop(c)
            for v in vals:
                batch[f"{c}_{v}"] = (col == v).astype(np.int64)
        return batch


class Concatenator(Preprocessor):
    """Concatenate feature columns into one matrix column — the form a torch
    training loop consumes directly."""

    def __init__(self, output_column_name: str = "concat_out",
                 include: Optional[List[str]] = None,
                 exclude: Optional[List[str]] = None, dtype=np.float32):
        self.output_column_name = output_column_name
        self.include = include
        self.exclude = set(exclude or [])
        self.dtype = dtype

    def _needs_fit(self) -> bool:
        return False

    def _transform_numpy(self, batch):
        cols = self.include or [k for k in batch if k not in self.exclude]
        mats = []
        for c in cols:
            v = np.asarray(batch.pop(c))
            mats.append(v.reshape(len(v), -1).astype(self.dtype))
        batch[self.output_column_name] = np.concatenate(mats, axis=1)
        return batch


class BatchMapper(Preprocessor):
    def __init__(self, fn: Callable[[Any], Any], batch_format: str = "numpy"):
        self.fn = fn

    def _needs_fit(self) -> bool:
        return False

    def _transform_numpy(self, batch):
        return self.fn(batch)


class Chain(Preprocessor):
    def __init__(self, *preprocessors: Preprocessor):
        self.preprocessors = preprocessors

    def fit(self, ds: Dataset) -> "Preprocessor":
        for p in self.preprocessors:
            ds = p.fit_transform(ds).materialize()
        self._is_fitted = True
        return self

    def transform(self, ds: Dataset) -> Dataset:
        for p in self.preprocessors:
            ds = p.transform(ds)
        return ds

    def transform_batch(self, batch):
        for p in self.preprocessors:
            batch = p.transform_batch(batch)
        return batch


class MaxAbsScaler(Preprocessor):
    """x / max|x| per column (reference ``MaxAbsScaler``)."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, float] = {}

    def _fit(self, ds: Dataset) -> None:
        for c in self.columns:
            lo, hi = ds.min(c), ds.max(c)
            self.stats_[c] = max(abs(lo), abs(hi)) or 1.0

    def _transform_numpy(self, batch):
        for c in self.columns:
            batch[c] = batch[c] / self.stats_[c]
        return batch


class RobustScaler(Preprocessor):
    """(x - median) / IQR per column (reference ``RobustScaler``);
    quantiles computed from a materialized column pull."""

    def __init__(self, columns: List[str], *,
                 quantile_range: tuple = (0.25, 0.75)):
        self.columns = columns
        self.quantile_range = quantile_range
        self.stats_: Dict[str, Any] = {}

    def _fit(self, ds: Dataset) -> None:
        lo_q, hi_q = self.quantile_range
        for c in self.columns:
            values = np.concatenate(
                [np.asarray(b[c]) for b in
                 ds.iter_batches(batch_size=None, batch_format="numpy")])
            lo, med, hi = np.quantile(values, [lo_q, 0.5, hi_q])
            self.stats_[c] = (med, (hi - lo) or 1.0)

    def _transform_numpy(self, batch):
        for c in self.columns:
            med, iqr = self.stats_[c]
            batch[c] = (batch[c] - med) / iqr
        return batch


class Normalizer(Preprocessor):
    """Row-wise Lp normalization across ``columns`` (reference
    ``Normalizer``); stateless."""

    def __init__(self, columns: List[str], norm: str = "l2"):
        self.columns = columns
        self.norm = norm

    def _needs_fit(self) -> bool:
        return False

    def _transform_numpy(self, batch):
        stack = np.column_stack([batch[c] for c in self.columns])
        if self.norm == "l2":
            denom = np.sqrt((stack ** 2).sum(axis=1))
        elif self.norm == "l1":
            denom = np.abs(stack).sum(axis=1)
        else:  # max
            denom = np.abs(stack).max(axis=1)
        denom = np.where(denom == 0, 1.0, denom)
        for i, c in enumerate(self.columns):
            batch[c] = stack[:, i] / denom
        return batch


class SimpleImputer(Preprocessor):
    """Fill NaNs with the column mean / a constant (reference
    ``SimpleImputer``)."""

    def __init__(self, columns: List[str], *, strategy: str = "mean",
                 fill_value: Optional[float] = None):
        self.columns = columns
        self.strategy = strategy
        self.fill_value = fill_value
        self.stats_: Dict[str, float] = {}

    def _fit(self, ds: Dataset) -> None:
        for c in self.columns:
            if self.strategy == "constant":
                self.stats_[c] = float(self.fill_value or 0.0)
            else:
                values = np.concatenate(
                    [np.asarray(b[c], np.float64) for b in
                     ds.iter_batches(batch_size=None,
                                     batch_format="numpy")])
                if self.strategy == "median":
                    self.stats_[c] = float(np.nanmedian(values))
                else:
                    self.stats_[c] = float(np.nanmean(values))

    def _transform_numpy(self, batch):
        for c in self.columns:
            col = np.asarray(batch[c], np.float64)
            batch[c] = np.where(np.isnan(col), self.stats_[c], col)
        return batch


class OrdinalEncoder(Preprocessor):
    """Category -> integer rank (reference ``OrdinalEncoder``)."""

    def __init__(self, columns: List[str]):
        self.columns = columns
        self.stats_: Dict[str, Dict[Any, int]] = {}

    def _fit(self, ds: Dataset) -> None:
        for c in self.columns:
            values = sorted({v for b in
                             ds.iter_batches(batch_size=None,
                                             batch_format="numpy")
                             for v in np.asarray(b[c]).tolist()})
            self.stats_[c] = {v: i for i, v in enumerate(values)}

    def _transform_numpy(self, batch):
        for c in self.columns:
            table = self.stats_[c]
            batch[c] = np.asarray(
                [table.get(v, -1) for v in np.asarray(batch[c]).tolist()],
                np.int64)
        return batch


class Tokenizer(Preprocessor):
    """Split text columns into token lists (reference ``Tokenizer``);
    stateless."""

    def __init__(self, columns: List[str],
                 tokenization_fn: Optional[Callable[[str], List[str]]]
                 = None):
        self.columns = columns
        self.fn = tokenization_fn or (lambda s: s.split())

    def _needs_fit(self) -> bool:
        return False

    def _transform_numpy(self, batch):
        for c in self.columns:
            batch[c] = np.asarray(
                [self.fn(str(v)) for v in np.asarray(batch[c]).tolist()],
                dtype=object)
        return batch


class CountVectorizer(Preprocessor):
    """Token counts against a fitted vocabulary (reference
    ``CountVectorizer``); emits one ``{col}_{token}`` column per
    vocabulary entry."""

    def __init__(self, columns: List[str], *, max_features: int = 100,
                 tokenization_fn: Optional[Callable[[str], List[str]]]
                 = None):
        self.columns = columns
        self.max_features = max_features
        self.fn = tokenization_fn or (lambda s: s.split())
        self.stats_: Dict[str, List[str]] = {}

    def _fit(self, ds: Dataset) -> None:
        from collections import Counter
        for c in self.columns:
            counts: Counter = Counter()
            for b in ds.iter_batches(batch_size=None,
                                     batch_format="numpy"):
                for v in np.asarray(b[c]).tolist():
                    counts.update(self.fn(str(v)))
            self.stats_[c] = [t for t, _ in
                              counts.most_common(self.max_features)]

    def _transform_numpy(self, batch):
        for c in self.columns:
            vocab = self.stats_[c]
            docs = [self.fn(str(v))
                    for v in np.asarray(batch[c]).tolist()]
            for token in vocab:
                batch[f"{c}_{token}"] = np.asarray(
                    [d.count(token) for d in docs], np.int64)
            del batch[c]
        return batch


class FeatureHasher(Preprocessor):
    """Hash token lists into a fixed-width count vector (reference
    ``FeatureHasher``); stateless, vocabulary-free."""

    def __init__(self, columns: List[str], num_features: int = 64):
        self.columns = columns
        self.num_features = num_features

    def _needs_fit(self) -> bool:
        return False

    def _transform_numpy(self, batch):
        import hashlib
        for c in self.columns:
            out = np.zeros((len(batch[c]), self.num_features), np.int64)
            for i, v in enumerate(np.asarray(batch[c]).tolist()):
                tokens = v if isinstance(v, (list, np.ndarray)) \
                    else str(v).split()
                for t in tokens:
                    h = int(hashlib.md5(str(t).encode()).hexdigest(), 16)
                    out[i, h % self.num_features] += 1
            batch[f"{c}_hashed"] = out
            del batch[c]
        return batch
