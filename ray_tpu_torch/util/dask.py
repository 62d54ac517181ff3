"""Dask-on-ray_tpu_torch scheduler shim.

Parity: reference ``python/ray/util/dask/`` (``ray_dask_get``) — a dask
scheduler that executes task graphs as ray_tpu_torch tasks so ``dask.compute
(..., scheduler=ray_tpu_dask_get)`` distributes over the cluster.  The
graph walker below implements the dask graph protocol directly (a dict
of key -> task tuple / literal / key alias), so the scheduler itself
has no import-time dask dependency; ``enable_dask_on_ray_tpu`` needs
the real package and raises with guidance when it is absent.
"""

from __future__ import annotations

from typing import Any, Dict, Hashable, List, Sequence, Union

import ray_tpu_torch


def _is_task(x: Any) -> bool:
    """Dask convention: a task is a tuple whose head is callable."""
    return isinstance(x, tuple) and len(x) > 0 and callable(x[0])


def _execute_structure(struct: Any, resolved: Dict[Hashable, Any]):
    """Materialize a task argument: keys -> resolved refs, nested
    lists/tuples walked, literal values passed through."""
    if _is_task(struct):
        fn, *args = struct
        args = [_execute_structure(a, resolved) for a in args]
        return _apply.remote(fn, *args)
    if isinstance(struct, list):
        return [_execute_structure(x, resolved) for x in struct]
    try:
        if struct in resolved:
            return resolved[struct]
    except TypeError:
        pass  # unhashable literal
    return struct


@ray_tpu_torch.remote
def _apply(fn, *args):
    args = [ray_tpu_torch.get(a)
            if isinstance(a, ray_tpu_torch.ObjectRef) else a for a in args]
    # nested structures may hold refs produced by inline sub-tasks
    def deref(x):
        if isinstance(x, ray_tpu_torch.ObjectRef):
            return ray_tpu_torch.get(x)
        if isinstance(x, list):
            return [deref(v) for v in x]
        if isinstance(x, tuple):
            return tuple(deref(v) for v in x)
        return x

    return fn(*[deref(a) for a in args])


def ray_tpu_dask_get(dsk: Dict[Hashable, Any], keys: Union[Hashable,
                     Sequence[Any]], **kwargs) -> Any:
    """Dask scheduler entry point: execute graph ``dsk``, return the
    values for ``keys`` (which may be nested lists, per dask)."""
    resolved: Dict[Hashable, Any] = {}

    # resolve in dependency order (graphs are DAGs; iterate to fixpoint)
    pending = dict(dsk)
    while pending:
        progressed = False
        for key in list(pending):
            task = pending[key]
            if _ready(task, resolved, pending):
                resolved[key] = _execute_structure(task, resolved)
                del pending[key]
                progressed = True
        if not progressed:
            raise ValueError(
                f"dask graph has unresolvable keys (cycle or missing "
                f"dependency): {sorted(map(str, pending))[:5]}")

    def collect(k):
        if isinstance(k, list):
            return [collect(x) for x in k]
        v = resolved[k]
        if isinstance(v, ray_tpu_torch.ObjectRef):
            return ray_tpu_torch.get(v)
        return v

    if isinstance(keys, list):
        return [collect(k) for k in keys]
    return collect(keys)


def _deps(struct: Any, dsk_keys) -> List[Hashable]:
    out: List[Hashable] = []
    if _is_task(struct):
        for a in struct[1:]:
            out.extend(_deps(a, dsk_keys))
        return out
    if isinstance(struct, list):
        for x in struct:
            out.extend(_deps(x, dsk_keys))
        return out
    try:
        if struct in dsk_keys:
            return [struct]
    except TypeError:
        pass
    return []


def _ready(task: Any, resolved: Dict, pending: Dict) -> bool:
    return all(d in resolved for d in _deps(task, pending.keys() |
                                            resolved.keys()))


def enable_dask_on_ray_tpu() -> None:
    """Set ``ray_tpu_dask_get`` as dask's default scheduler (reference
    ``enable_dask_on_ray``)."""
    try:
        import dask
    except ImportError as e:
        raise ImportError(
            "enable_dask_on_ray_tpu requires the optional package "
            "'dask' (pip install dask); the scheduler function "
            "ray_tpu_dask_get itself works on raw dask-protocol graphs "
            "without it") from e
    dask.config.set(scheduler=ray_tpu_dask_get)
