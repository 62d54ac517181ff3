"""Predictors + batch inference.

Parity: reference ``python/ray/train/predictor.py`` (``Predictor``),
``batch_predictor.py`` (``BatchPredictor`` — checkpoint + predictor
class mapped over a Dataset with task or actor-pool compute) and the
per-framework ``*_predictor.py`` files: here ``TorchPredictor`` (a
module's weights from a checkpoint, the counterpart of the JAX package's
``JaxPredictor``), ``SklearnPredictor`` and ``HuggingFacePredictor``.
The torch predictors run on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Type

import numpy as np

from ray_tpu_torch.train.checkpoint import Checkpoint


class Predictor:
    """Base: build from a checkpoint, predict on numpy batches."""

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs
                        ) -> "Predictor":
        raise NotImplementedError

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        raise NotImplementedError


class TorchPredictor(Predictor):
    """Inference with a torch module whose weights come from a
    checkpoint: the counterpart of the JAX package's ``JaxPredictor``,
    which jits a flax apply over a param pytree (PyTorch runs eagerly,
    so there is nothing to compile).  The module stays on its device in
    eval mode and predicts under ``torch.inference_mode()``: on the card
    unless it is given ``device="cpu"``.  Predictions come back as
    numpy."""

    def __init__(self, model: Any, input_column: str = "data", *,
                 device: Any = None):
        from ray_tpu_torch._device import resolve_device

        self._device = resolve_device(device)
        self._model = model.to(self._device).eval()
        self._col = input_column

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *, model: Any,
                        key: Optional[str] = "model",
                        input_column: str = "data",
                        device: Any = None) -> "TorchPredictor":
        """``model``: a module of the trained architecture, whose weights
        the checkpoint's replace; ``key``: where the tree saved by
        ``Checkpoint.from_pytree`` holds its ``state_dict`` (None: the
        tree is the ``state_dict``)."""
        from ray_tpu_torch._device import resolve_device
        from ray_tpu_torch.train.checkpoint import _restore_like

        model = model.to(resolve_device(device))
        saved = checkpoint._saved_pytree()
        if key is not None:
            saved = saved[key]
        model.load_state_dict(_restore_like(model.state_dict(), saved, key
                                            or ""))
        return cls(model, input_column, device=device)

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        import torch

        x = torch.as_tensor(np.asarray(batch[self._col]),
                            device=self._device)
        with torch.inference_mode():
            out = self._model(x)
        return {"predictions": out.float().cpu().numpy()}


class SklearnPredictor(Predictor):
    def __init__(self, estimator: Any, feature_columns=None):
        self._est = estimator
        self._cols = feature_columns

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, **kwargs
                        ) -> "SklearnPredictor":
        data = checkpoint.to_dict()
        import pickle

        return cls(pickle.loads(data["estimator_pkl"]),
                   data.get("feature_columns"))

    def _features(self, batch: Dict[str, np.ndarray]) -> np.ndarray:
        cols = self._cols or [c for c in batch.keys()
                              if c not in ("label", "target")]
        return np.column_stack([batch[c] for c in cols])

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return {"predictions": self._est.predict(self._features(batch))}


class HuggingFacePredictor(Predictor):
    """Inference from a HuggingFaceTrainer checkpoint (reference
    ``train/huggingface/huggingface_predictor.py``): the checkpoint
    directory is a ``from_pretrained``-loadable model.  The model runs on
    the card unless it is given ``device="cpu"`` (the JAX package's runs
    on the CPU); logits come back as numpy."""

    def __init__(self, model: Any, tokenizer: Any = None, *,
                 device: Any = None):
        from ray_tpu_torch._device import resolve_device

        self._device = resolve_device(device)
        self._model = model.to(self._device)
        self._tokenizer = tokenizer

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint, *,
                        model_cls: Any = None,
                        tokenizer_cls: Any = None, device: Any = None,
                        **kwargs) -> "HuggingFacePredictor":
        import transformers

        model_cls = model_cls or transformers.AutoModel
        with checkpoint.as_directory() as d:
            model = model_cls.from_pretrained(d, **kwargs)
            tokenizer = None
            if tokenizer_cls is not None:
                tokenizer = tokenizer_cls.from_pretrained(d)
        model.eval()
        return cls(model, tokenizer, device=device)

    def predict(self, batch: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        import torch

        with torch.no_grad():
            tensors = {k: torch.as_tensor(np.asarray(v), device=self._device)
                       for k, v in batch.items()}
            out = self._model(**tensors)
        logits = out.logits if hasattr(out, "logits") else out[0]
        return {"predictions": logits.cpu().numpy()}


class BatchPredictor:
    """Checkpoint + predictor class -> Dataset map (reference
    ``batch_predictor.py``).  Uses actor-pool compute so each worker
    builds the predictor (loads weights / compiles) once."""

    def __init__(self, checkpoint: Checkpoint,
                 predictor_cls: Type[Predictor], **predictor_kwargs):
        self._checkpoint = checkpoint
        self._cls = predictor_cls
        self._kwargs = predictor_kwargs

    @classmethod
    def from_checkpoint(cls, checkpoint: Checkpoint,
                        predictor_cls: Type[Predictor],
                        **predictor_kwargs) -> "BatchPredictor":
        return cls(checkpoint, predictor_cls, **predictor_kwargs)

    def predict(self, dataset, *, batch_size: int = 256,
                num_workers: int = 2):
        from ray_tpu_torch.data.dataset import ActorPoolStrategy

        ckpt = self._checkpoint
        pred_cls = self._cls
        kwargs = self._kwargs

        class _Infer:  # one predictor per pool actor (weights load once)
            def __init__(self):
                self._p = pred_cls.from_checkpoint(ckpt, **kwargs)

            def __call__(self, batch):
                return self._p.predict(batch)

        return dataset.map_batches(
            _Infer, batch_size=batch_size, batch_format="numpy",
            compute=ActorPoolStrategy(size=num_workers))
