"""Autoscaler (reference ``python/ray/autoscaler/``): the two modules
the runtime reaches.

``fair_queue`` is the raylet's and the GCS's per-job fair lease queue;
``sdk.request_resources`` is the serve controller's standing capacity
request.  The autoscaler itself (monitor, policy, node providers) is not
ported yet (ROADMAP.md, queue 1, item 7.6).

Exports resolve lazily (PEP 562): the core GCS imports the pure
``fair_queue`` state machine from this package, and an eager package
init would close an import cycle through ``sdk`` -> ``core.gcs``.
"""

_EXPORTS = {
    "request_resources": "ray_tpu_torch.autoscaler.sdk",
    "FairQueue": "ray_tpu_torch.autoscaler.fair_queue",
    "JobQuota": "ray_tpu_torch.autoscaler.fair_queue",
    "QuotaExceeded": "ray_tpu_torch.autoscaler.fair_queue",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    target = _EXPORTS.get(name)
    if target is None:
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(target), name)
