"""Autoscaler (reference ``python/ray/autoscaler/``).

The demand packer (``resource_demand_scheduler``), its control loop
(``autoscaler``), the signal-driven policy (``policy``) and the monitor
that drives both from the GCS (``monitor``), the node providers
(``node_provider``: a mock and a fake multi-node one over
``cluster_utils.Cluster``; ``gcp``: GPU VMs) and the cluster launcher
(``launcher``, the CLI's ``up`` / ``down``).  ``fair_queue`` is the
raylet's and the GCS's per-job fair lease queue; ``sdk.request_resources``
the standing capacity request.

Exports resolve lazily (PEP 562): the core GCS imports the pure
``fair_queue`` state machine from this package, and an eager package
init would close an import cycle through ``sdk`` -> ``core.gcs``.
"""

_EXPORTS = {
    "LoadMetrics": "ray_tpu_torch.autoscaler.autoscaler",
    "StandardAutoscaler": "ray_tpu_torch.autoscaler.autoscaler",
    "Monitor": "ray_tpu_torch.autoscaler.monitor",
    "AutoscalerMonitor": "ray_tpu_torch.autoscaler.monitor",
    "ScalingPolicy": "ray_tpu_torch.autoscaler.policy",
    "FakeMultiNodeProvider": "ray_tpu_torch.autoscaler.node_provider",
    "MockProvider": "ray_tpu_torch.autoscaler.node_provider",
    "NodeProvider": "ray_tpu_torch.autoscaler.node_provider",
    "NodeTypeConfig": "ray_tpu_torch.autoscaler.resource_demand_scheduler",
    "ResourceDemandScheduler":
        "ray_tpu_torch.autoscaler.resource_demand_scheduler",
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
