"""What the port says where it parts from the JAX package's runtime:
options, resources and cloud providers that name the TPU, and features
of later slices."""

from __future__ import annotations

from typing import Any, Mapping, Optional


# the JAX package's TPU keywords and the port's GPU ones in their place
_TPU_OPTIONS = {"num_tpus": "num_gpus", "tpus_per_worker": "gpus_per_worker",
                "num_tpus_per_learner": "num_gpus_per_learner"}


def reject_tpu_options(where: str, options: Mapping[str, Any]) -> None:
    """Raise if ``options`` asks for TPUs: the port schedules GPUs."""
    for tpu, gpu in _TPU_OPTIONS.items():
        if tpu in options:
            raise TypeError(
                f"{where}: {tpu}= is the JAX package's option; "
                f"ray_tpu_torch schedules GPUs: pass {gpu}=")


def reject_tpu_resources(where: str,
                         resources: Optional[Mapping[str, Any]]) -> None:
    """Raise if a resources dict asks for ``"TPU"``: no node of the port
    has that resource, so a lease for it would wait forever."""
    if resources and "TPU" in resources:
        raise TypeError(
            f"{where}: \"TPU\" is the JAX package's resource; "
            f"ray_tpu_torch schedules GPUs: ask for \"GPU\"")


#: the JAX package's provider types of TPU VMs (its launcher's ``gcp``,
#: its provider module's ``gcp_tpu``) and the port's GPU one
_TPU_PROVIDERS = ("gcp", "gcp_tpu")


def reject_tpu_provider(where: str, provider_type: str) -> None:
    """Raise if a cluster config's provider creates TPU VMs: the port's
    cloud provider creates GPU VMs (``type: gcp_gpu``)."""
    if provider_type in _TPU_PROVIDERS:
        raise TypeError(
            f"{where}: provider type {provider_type!r} creates the JAX "
            f"package's TPU VMs; ray_tpu_torch creates GPU VMs: use "
            f"type: gcp_gpu")


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a call into a part of the JAX package that no slice of
    the port has brought yet raises; ``item`` names the ROADMAP.md
    queue item that brings it."""
    return NotImplementedError(
        f"{what} is not ported to ray_tpu_torch yet (ROADMAP.md, "
        f"{item})")
