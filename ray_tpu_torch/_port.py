"""What the port says where it parts from the JAX package's runtime:
options that name the TPU, and features of later slices."""

from __future__ import annotations

from typing import Any, Mapping


def reject_tpu_options(where: str, options: Mapping[str, Any]) -> None:
    """Raise if ``options`` asks for TPUs: the port schedules GPUs."""
    if "num_tpus" in options:
        raise TypeError(
            f"{where}: num_tpus= is the JAX package's option; "
            "ray_tpu_torch schedules GPUs: pass num_gpus=")


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error a call into a part of the JAX package that no slice of
    the port has brought yet raises; ``item`` names the ROADMAP.md
    queue item that brings it."""
    return NotImplementedError(
        f"{what} is not ported to ray_tpu_torch yet (ROADMAP.md, "
        f"{item})")
