"""Saving a training loop's state to a directory with ``torch.save``.

The counterpart of the JAX package's ``train/orbax.py``, which bridges
orbax's save/restore of jax pytrees to the AIR ``Checkpoint`` /
``CheckpointManager`` vocabulary.  Here a pytree is a nest of dicts,
lists and tuples of torch tensors (``{"model": model.state_dict(),
"optim": opt.state_dict()}``), written with ``torch.save`` (every tensor
on the CPU) to ``<path>/pytree.pt`` and read back with
``torch.load(weights_only=True)``; a ``target`` places each tensor on the
device and dtype of its counterpart, as orbax's restore with a target
places arrays with its shardings.  Saves are synchronous.

Usage inside a train loop::

    from ray_tpu_torch.train.pytree_io import save_pytree, restore_pytree

    save_pytree(path, {"model": model.state_dict(),
                       "optim": opt.state_dict()})
    state = restore_pytree(path)          # as saved, on the CPU
    state = restore_pytree(path, target)  # on target's devices and dtypes
"""

from __future__ import annotations

import os
from typing import Any, Optional

from ray_tpu_torch.train.checkpoint import (Checkpoint, _restore_like,
                                            _to_cpu)

_FILE = "pytree.pt"


def save_pytree(path: str, tree: Any, *, wait: bool = True) -> str:
    """Save a pytree (model and optimizer state, ...) under ``path``."""
    import torch

    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(_to_cpu(tree), tmp)
    os.replace(tmp, os.path.join(path, _FILE))  # a reader sees all or none
    return path


def wait_all() -> None:
    """Compatibility no-op: saves are synchronous."""


def restore_pytree(path: str, target: Optional[Any] = None) -> Any:
    """Restore a pytree; with ``target`` (a pytree of like-shaped
    tensors), each tensor lands on its counterpart's device and dtype,
    and a structure that differs raises ``ValueError``."""
    import torch

    tree = torch.load(os.path.join(os.path.abspath(path), _FILE),
                      weights_only=True)
    return tree if target is None else _restore_like(target, tree, "")


def to_air_checkpoint(path: str, **extra_metadata: Any) -> Checkpoint:
    """Wrap a :func:`save_pytree` directory as an AIR Checkpoint
    (dir-backed), so the keep-K/score CheckpointManager and Tune trial
    restore manage it."""
    ckpt = Checkpoint.from_directory(path)
    if extra_metadata:
        ckpt.metadata = dict(getattr(ckpt, "metadata", {}) or {},
                             **extra_metadata)
    return ckpt


def from_air_checkpoint(checkpoint: Checkpoint,
                        target: Optional[Any] = None) -> Any:
    """Restore the pytree inside an AIR Checkpoint produced by
    :func:`to_air_checkpoint`."""
    directory = checkpoint.to_directory()
    return restore_pytree(directory, target=target)
