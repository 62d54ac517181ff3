"""What the port says where it parts from the JAX package's runtime:
options that name the TPU, and features of later slices."""

from __future__ import annotations

from typing import Any, Mapping


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


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a call into a part of the JAX package that no slice of
    the port has brought yet raises; ``item`` names the ROADMAP.md
    queue item that brings it."""
    return NotImplementedError(
        f"{what} is not ported to ray_tpu_torch yet (ROADMAP.md, "
        f"{item})")
