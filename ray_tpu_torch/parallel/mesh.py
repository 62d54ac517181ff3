"""The declarative mesh vocabulary of the JAX package's
``parallel/mesh.py``: ``MeshConfig``, ``AXIS_ORDER`` and
``mesh_shape_for``, which ``train.config.ScalingConfig`` names.

Axis vocabulary (outermost first):

- ``dp``   — pure data parallelism (gradient allreduce)
- ``fsdp`` — data parallelism with sharded parameters/optimizer state
            (reduce-scatter + all-gather)
- ``pp``   — pipeline stages
- ``sp``   — sequence/context parallelism (ring attention / Ulysses)
- ``tp``   — tensor parallelism (megatron-style sharded matmuls)
- ``ep``   — expert parallelism (MoE all-to-all), usually aliasing dp/fsdp

Axes listed in ``dcn_axes`` cross host boundaries; the rest stay inside
a host.  Building a device mesh from a config (``build_mesh``, the
global mesh, ``shard_map``) comes with the port's parallel layer on
torch ``DeviceMesh`` (ROADMAP.md, queue 1, item 5); those names raise
until then.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

from ray_tpu_torch import _port

AXIS_ORDER = ("dp", "fsdp", "pp", "sp", "tp", "ep")
_LATER = "queue 1, item 5"


@dataclass
class MeshConfig:
    """Declarative parallelism layout (the ScalingConfig analog for
    intra-program parallelism)."""

    dp: int = 1
    fsdp: int = 1
    pp: int = 1
    sp: int = 1
    tp: int = 1
    ep: int = 1
    #: axes that cross slice/host boundaries (DCN); outermost in layout
    dcn_axes: Tuple[str, ...] = ("dp", "pp")
    #: -1 in any field means "absorb remaining devices"

    def axis_sizes(self) -> Dict[str, int]:
        return {"dp": self.dp, "fsdp": self.fsdp, "pp": self.pp,
                "sp": self.sp, "tp": self.tp, "ep": self.ep}

    def resolved(self, n_devices: int) -> "MeshConfig":
        sizes = self.axis_sizes()
        wildcard = [k for k, v in sizes.items() if v == -1]
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if len(wildcard) > 1:
            raise ValueError("at most one mesh axis may be -1")
        if wildcard:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes {fixed}")
            sizes[wildcard[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} needs {fixed} devices, have {n_devices}")
        return MeshConfig(**sizes, dcn_axes=self.dcn_axes)

    @property
    def num_devices(self) -> int:
        return math.prod(self.axis_sizes().values())


def mesh_shape_for(n_devices: int, *, tp: int = 1, sp: int = 1,
                   pp: int = 1, fsdp: bool = True) -> MeshConfig:
    """Convenience: fill the data axis with whatever devices remain."""
    cfg = MeshConfig(dp=1 if fsdp else -1, fsdp=-1 if fsdp else 1,
                     pp=pp, sp=sp, tp=tp)
    return cfg.resolved(n_devices)


def build_mesh(config=None, devices=None):
    raise _port.not_ported("build_mesh", _LATER)


def set_global_mesh(mesh) -> None:
    raise _port.not_ported("set_global_mesh", _LATER)


class use_mesh:
    def __init__(self, mesh):
        raise _port.not_ported("use_mesh", _LATER)


def shard_map(f, *, mesh, in_specs, out_specs, **kwargs):
    raise _port.not_ported("shard_map", _LATER)
