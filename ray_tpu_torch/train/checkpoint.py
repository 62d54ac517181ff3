"""Checkpoints: interconvertible dict / directory / object-store forms.

Parity: reference ``python/ray/air/checkpoint.py`` — a ``Checkpoint`` can
be created from an in-memory dict (small states), a directory (orbax /
msgpack artifacts), or an ObjectRef, and converted between forms.  The
manager implements keep-K + score-attribute retention
(``CheckpointConfig``, reference ``air/config.py:513``).

A pytree of torch tensors (a model's ``state_dict``, an optimizer's,
nested dicts, lists and tuples of them) is ``torch.save``d into bytes
with every tensor on the CPU, and restored with
``torch.load(weights_only=True)`` onto the device and dtype of a target
of the same structure: the counterpart of the JAX package's flax
msgpack (``Checkpoint.from_pytree`` / ``to_pytree``).
"""

from __future__ import annotations

import io
import json
import os
import pickle
import re
import shutil
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.train.config import CheckpointConfig


class Checkpoint:
    def __init__(self, *, data: Optional[Dict[str, Any]] = None,
                 directory: Optional[str] = None):
        if (data is None) == (directory is None):
            raise ValueError("exactly one of data/directory required")
        self._data = data
        self._dir = directory

    # -- constructors -----------------------------------------------------
    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "Checkpoint":
        return cls(data=dict(data))

    @classmethod
    def from_directory(cls, directory: str) -> "Checkpoint":
        return cls(directory=directory)

    @classmethod
    def from_pytree(cls, pytree: Any,
                    metrics: Optional[Dict[str, Any]] = None) -> "Checkpoint":
        """A checkpoint of a pytree of tensors, such as ``{"model":
        model.state_dict(), "optim": opt.state_dict()}``: ``torch.save``
        into bytes, every tensor moved to the CPU first, so that no
        device is pickled and the bytes load anywhere."""
        import torch

        buf = io.BytesIO()
        torch.save(_to_cpu(pytree), buf)
        return cls(data={"pytree_torch": buf.getvalue(),
                         "metrics": metrics or {}})

    # -- accessors --------------------------------------------------------
    _MANIFEST = ".pickled_keys.json"

    def to_dict(self) -> Dict[str, Any]:
        if self._data is not None:
            return self._data
        pickled: List[str] = []
        manifest = os.path.join(self._dir, self._MANIFEST)
        if os.path.exists(manifest):
            with open(manifest) as f:
                pickled = json.load(f)
        out: Dict[str, Any] = {}
        for name in os.listdir(self._dir):
            if name == self._MANIFEST:
                continue
            with open(os.path.join(self._dir, name), "rb") as f:
                blob = f.read()
            # non-bytes values were pickled on the way to disk
            # (to_directory); un-pickle them so dict -> dir -> dict round
            # trips preserve types across process/host boundaries
            out[name] = pickle.loads(blob) if name in pickled else blob
        return out

    def to_directory(self, path: Optional[str] = None) -> str:
        if self._dir is not None:
            if path is None or \
                    os.path.abspath(path) == os.path.abspath(self._dir):
                return self._dir
            shutil.copytree(self._dir, path, dirs_exist_ok=True)
            return path
        path = path or tempfile.mkdtemp(prefix="rtpu_ckpt_")
        os.makedirs(path, exist_ok=True)
        pickled: List[str] = []
        for key, value in self._data.items():
            if isinstance(value, bytes):
                blob = value
            else:
                blob = pickle.dumps(value)
                pickled.append(key)
            with open(os.path.join(path, key), "wb") as f:
                f.write(blob)
        with open(os.path.join(path, self._MANIFEST), "w") as f:
            json.dump(pickled, f)
        return path

    def as_directory(self):
        """Context manager yielding a directory view (reference
        ``Checkpoint.as_directory``); temp dirs for dict-backed
        checkpoints are cleaned up on exit."""
        import contextlib

        @contextlib.contextmanager
        def _cm():
            if self._dir is not None:
                yield self._dir
                return
            path = self.to_directory()
            try:
                yield path
            finally:
                shutil.rmtree(path, ignore_errors=True)

        return _cm()

    def to_pytree(self, target: Any) -> Any:
        """Restore a pytree saved by ``from_pytree``: ``target`` supplies
        the structure, and each tensor lands on the device and dtype of
        its counterpart there.  Raises ``ValueError`` where the two
        structures differ (keys, lengths, a tensor's shape), as flax's
        ``from_bytes`` does; an empty dict in ``target`` (the state of
        an optimizer that has not stepped yet) takes the saved entries
        as they are, on the CPU."""
        return _restore_like(target, self._saved_pytree(), "")

    def _saved_pytree(self) -> Any:
        """The tree ``from_pytree`` saved, as saved: tensors on the
        CPU."""
        import torch

        blob = self.to_dict()["pytree_torch"]
        if not isinstance(blob, bytes):
            blob = pickle.loads(blob)
        return torch.load(io.BytesIO(blob), weights_only=True)

    @property
    def metrics(self) -> Dict[str, Any]:
        data = self._data or {}
        m = data.get("metrics", {})
        return m if isinstance(m, dict) else pickle.loads(m)

    def __repr__(self) -> str:
        kind = "dict" if self._data is not None else f"dir:{self._dir}"
        return f"Checkpoint({kind})"


def _to_cpu(tree: Any) -> Any:
    """``tree`` with every tensor detached on the CPU, copied where it
    is a view of a larger storage (``torch.save`` writes whole
    storages)."""
    import torch

    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        if t.untyped_storage().nbytes() != t.numel() * t.element_size():
            t = t.clone()
        return t
    if isinstance(tree, dict):
        return type(tree)((k, _to_cpu(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree


def _restore_like(target: Any, saved: Any, path: str) -> Any:
    """``saved`` in ``target``'s structure, tensors on its devices and
    dtypes."""
    import torch

    where = path or "<root>"
    if isinstance(target, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != target.shape:
            got = (tuple(saved.shape) if isinstance(saved, torch.Tensor)
                   else type(saved).__name__)
            raise ValueError(f"checkpoint at {where}: {got}, target "
                             f"{tuple(target.shape)}")
        return saved.to(device=target.device, dtype=target.dtype)
    if isinstance(target, dict):
        if not isinstance(saved, dict):
            raise ValueError(f"checkpoint at {where}: "
                             f"{type(saved).__name__}, target a dict")
        if not target:
            return saved
        if set(saved) != set(target):
            raise ValueError(
                f"checkpoint at {where}: keys {sorted(map(str, saved))} "
                f"do not match the target's {sorted(map(str, target))}")
        return type(target)((k, _restore_like(v, saved[k], f"{path}/{k}"))
                            for k, v in target.items())
    if isinstance(target, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(target):
            raise ValueError(f"checkpoint at {where}: {saved!r:.60}, target "
                             f"of {len(target)} entries")
        return type(target)(_restore_like(t, s, f"{path}/{i}")
                            for i, (t, s) in enumerate(zip(target, saved)))
    return saved


class CheckpointManager:
    """Keep-K checkpoint retention with optional score ordering.

    With ``storage_uri`` set, every registered checkpoint is mirrored to
    durable storage (``ray_tpu_torch.air.storage``) and retention prunes the
    mirror too — a lost host loses nothing (parity: the reference's
    checkpoint upload through ``RunConfig.storage_path``).
    """

    def __init__(self, directory: str,
                 config: Optional[CheckpointConfig] = None,
                 storage_uri: Optional[str] = None):
        self.directory = directory
        self.config = config or CheckpointConfig()
        self.storage_uri = storage_uri
        os.makedirs(directory, exist_ok=True)
        self._entries: List[Tuple[float, str, Dict[str, Any]]] = []
        # Resume numbering after any checkpoints already present locally
        # or at the mirror — a restored run that restarted at 1 would
        # overwrite the earlier mirror files, and a later restore's
        # max(names) would then pick a STALE checkpoint.
        self._counter = self._existing_max_index()

    _NAME_RE = re.compile(r"^checkpoint_(\d{6})$")

    @classmethod
    def checkpoint_index(cls, name: str) -> Optional[int]:
        """Index of a well-formed checkpoint dir name (None for residue
        like ``checkpoint_000003.old`` / ``.tmp``)."""
        m = cls._NAME_RE.match(name)
        return int(m.group(1)) if m else None

    def _existing_max_index(self) -> int:
        names = list(os.listdir(self.directory))
        if self.storage_uri:
            try:
                from ray_tpu_torch.air import storage
                backend, path = storage.get_storage(self.storage_uri)
                names += backend.listdir(path)
            except Exception:  # noqa: BLE001 — mirror scan is best-effort
                pass
        return max((self.checkpoint_index(n) or 0 for n in names),
                   default=0)

    def register(self, checkpoint: Checkpoint,
                 metrics: Optional[Dict[str, Any]] = None) -> str:
        self._counter += 1
        path = os.path.join(self.directory, f"checkpoint_{self._counter:06d}")
        checkpoint.to_directory(path)
        metrics = dict(metrics or checkpoint.metrics)
        with open(os.path.join(path, ".metrics.json"), "w") as f:
            json.dump({k: v for k, v in metrics.items()
                       if isinstance(v, (int, float, str, bool))}, f)
        if self.storage_uri:
            from ray_tpu_torch.air import storage
            storage.upload_dir(path, storage.join(
                self.storage_uri, os.path.basename(path)))
        score = self._score(metrics)
        self._entries.append((score, path, metrics))
        self._enforce_retention()
        return path

    def _score(self, metrics: Dict[str, Any]) -> float:
        attr = self.config.checkpoint_score_attribute
        if attr is None:
            return float(self._counter)  # recency
        value = float(metrics.get(attr, float("-inf")))
        return value if self.config.checkpoint_score_order == "max" else -value

    def _enforce_retention(self) -> None:
        keep = self.config.num_to_keep
        if keep is None or len(self._entries) <= keep:
            return
        self._entries.sort(key=lambda e: e[0], reverse=True)
        for _, path, _ in self._entries[keep:]:
            shutil.rmtree(path, ignore_errors=True)
            if self.storage_uri:
                from ray_tpu_torch.air import storage
                try:
                    backend, spath = storage.get_storage(storage.join(
                        self.storage_uri, os.path.basename(path)))
                    backend.delete(spath)
                except Exception:  # noqa: BLE001 — prune is best-effort
                    pass
        self._entries = self._entries[:keep]

    def best_checkpoint(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        best = max(self._entries, key=lambda e: e[0])
        return Checkpoint.from_directory(best[1])

    def latest_checkpoint(self) -> Optional[Checkpoint]:
        if not self._entries:
            return None
        latest = max(self._entries, key=lambda e: e[1])
        return Checkpoint.from_directory(latest[1])
