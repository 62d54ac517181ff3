"""Serialization debugging: find WHICH member of an object fails to
pickle (parity: reference ``python/ray/util/check_serialize.py``
``inspect_serializability`` — the tool users reach for first when a
task argument won't go over the wire).
"""

from __future__ import annotations

import inspect
from typing import Any, Optional, Set, Tuple

__all__ = ["inspect_serializability"]

_BAR = "=" * 60


def _try_pickle(obj: Any) -> Optional[Exception]:
    from ray_tpu_torch.core.serialization import cloudpickle
    try:
        cloudpickle.dumps(obj)
        return None
    except Exception as e:  # noqa: BLE001 — the failure IS the answer
        return e


def _inspect(obj: Any, name: str, depth: int, seen: Set[int],
             failures: list, printer) -> bool:
    """Returns True when ``obj`` pickles.  On failure, recurses into
    closures / attributes / members to find the leaf culprit."""
    err = _try_pickle(obj)
    if err is None:
        return True
    printer(f"{'  ' * depth}FAIL {name} ({type(obj).__name__}): "
            f"{type(err).__name__}: {str(err)[:120]}")
    if id(obj) in seen or depth > 4:
        return False
    seen.add(id(obj))
    found_deeper = False
    # closures capture the usual offenders (locks, sockets, clients)
    if inspect.isfunction(obj):
        closure = inspect.getclosurevars(obj)
        for label, mapping in (("nonlocal", closure.nonlocals),
                               ("global", closure.globals)):
            for var, val in mapping.items():
                if not _inspect(val, f"{name}.<{label} {var!r}>",
                                depth + 1, seen, failures, printer):
                    found_deeper = True
    else:
        attrs = getattr(obj, "__dict__", None)
        if isinstance(attrs, dict):
            for attr, val in attrs.items():
                if not _inspect(val, f"{name}.{attr}", depth + 1, seen,
                                failures, printer):
                    found_deeper = True
        elif isinstance(obj, (list, tuple, set)):
            for i, val in enumerate(obj):
                if not _inspect(val, f"{name}[{i}]", depth + 1, seen,
                                failures, printer):
                    found_deeper = True
        elif isinstance(obj, dict):
            for k, val in obj.items():
                if not _inspect(val, f"{name}[{k!r}]", depth + 1, seen,
                                failures, printer):
                    found_deeper = True
    if not found_deeper:
        # this object itself is the leaf culprit
        failures.append((name, obj, err))
    return False


def inspect_serializability(obj: Any, name: Optional[str] = None,
                            print_file=None) -> Tuple[bool, Set[str]]:
    """Check whether ``obj`` pickles; on failure print a tree that
    descends into closures/attributes/containers and names the leaf
    members that cannot serialize.

    Returns ``(serializable, {culprit descriptions})`` — same shape as
    the reference API.
    """
    import sys

    out = print_file or sys.stdout

    def printer(line: str) -> None:
        print(line, file=out)

    name = name or getattr(obj, "__qualname__",
                           getattr(obj, "__name__", repr(obj)[:40]))
    printer(_BAR)
    printer(f"Checking serializability of {name!r}")
    printer(_BAR)
    failures: list = []
    ok = _inspect(obj, name, 0, set(), failures, printer)
    if ok:
        printer(f"{name!r} is serializable.")
        return True, set()
    culprits = {f"{path}: {type(val).__name__}" for path, val, _ in failures}
    printer(_BAR)
    printer(f"Found {len(failures)} unserializable leaf member(s):")
    for path, val, err in failures:
        printer(f"  * {path} = {repr(val)[:80]}")
        printer(f"      -> {type(err).__name__}: {str(err)[:120]}")
    printer("Fixes: pass the offending member explicitly (e.g. create "
            "it inside the task), hold it in an actor instead, or mark "
            "it with __reduce__.")
    printer(_BAR)
    return False, culprits
