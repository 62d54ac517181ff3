"""Programmatic autoscaler requests (reference
``python/ray/autoscaler/sdk/sdk.py:206`` ``request_resources``).

``request_resources`` records a STANDING capacity request: the
autoscaler treats the bundles like queued demand on every reconcile
tick, so the cluster scales up until they would fit — and stays there,
because the request persists until replaced.  It is not a reservation:
nothing is held for the caller, and bundles the live cluster already
covers launch nothing.  Call with no arguments to clear.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

from ray_tpu_torch.core.gcs import RESOURCE_REQUEST_KV_KEY


def request_resources(num_cpus: Optional[int] = None,
                      bundles: Optional[List[Dict[str, float]]] = None
                      ) -> None:
    """Ask the autoscaler to scale so the given resources would fit.

    ``num_cpus`` is shorthand for ``num_cpus`` 1-CPU bundles; ``bundles``
    is an explicit resource-shape list (e.g. ``[{"CPU": 4, "GPU": 1}]``).
    Each call REPLACES the previous standing request; with neither
    argument the request is cleared.
    """
    from ray_tpu_torch.experimental.internal_kv import (_internal_kv_del,
                                                  _internal_kv_put)

    demand: List[Dict[str, float]] = []
    if num_cpus:
        demand.extend({"CPU": 1.0} for _ in range(int(num_cpus)))
    for b in bundles or []:
        if not isinstance(b, dict):
            raise TypeError(f"bundles must be dicts, got {type(b).__name__}")
        demand.append({str(k): float(v) for k, v in b.items()})

    if demand:
        _internal_kv_put(RESOURCE_REQUEST_KV_KEY, json.dumps(demand),
                         overwrite=True)
    else:
        _internal_kv_del(RESOURCE_REQUEST_KV_KEY)
