"""Usage telemetry (local-only).

Parity: reference ``python/ray/_private/usage/usage_lib.py`` — the
reference records cluster/library usage and (opt-in) reports it; here
the same record structure is collected but ONLY written to the session
directory (no network egress), with the same opt-out semantics:
``RAY_TPU_TORCH_USAGE_STATS_ENABLED=0`` disables collection entirely
(the port's name for the JAX package's variable, so that neither
runtime reads the other's).
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, List

_RECORDS: List[Dict[str, Any]] = []


def usage_stats_enabled() -> bool:
    return os.environ.get("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "1") != "0"


def record_library_usage(library: str) -> None:
    """Called by library entry points (train/tune/serve/...)."""
    if not usage_stats_enabled():
        return
    _RECORDS.append({"kind": "library", "name": library,
                     "time": time.time()})


def record_extra_usage_tag(key: str, value: str) -> None:
    if not usage_stats_enabled():
        return
    _RECORDS.append({"kind": "tag", "key": key, "value": value,
                     "time": time.time()})


def usage_report() -> Dict[str, Any]:
    import ray_tpu_torch

    return {
        "ray_tpu_version": ray_tpu_torch.__version__,
        "libraries": sorted({r["name"] for r in _RECORDS
                             if r["kind"] == "library"}),
        "tags": {r["key"]: r["value"] for r in _RECORDS
                 if r["kind"] == "tag"},
        "num_records": len(_RECORDS),
    }


def flush_to_session_dir(session_dir: str) -> str:
    path = os.path.join(session_dir, "usage_stats.json")
    with open(path, "w") as f:
        json.dump(usage_report(), f)
    return path
