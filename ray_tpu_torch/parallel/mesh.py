"""Device mesh construction: the JAX package's ``parallel/mesh.py`` on a
``torch.distributed`` ``DeviceMesh``.

The JAX package declares parallelism as named axes of a
``jax.sharding.Mesh`` over the devices of one program, and XLA compiles
the collectives.  Here every rank is a process with one device, and the
mesh is a ``DeviceMesh`` over the ranks of the default process group with
the same six named axes, each axis a process group for the collectives
of the port's per-rank functions (ring attention's sends, Ulysses'
all-to-all, the gradients' all-reduce).

Axis vocabulary (outermost first):

- ``dp``   — pure data parallelism (gradient allreduce)
- ``fsdp`` — data parallelism with sharded parameters/optimizer state
            (reduce-scatter + all-gather)
- ``pp``   — pipeline stages
- ``sp``   — sequence/context parallelism (ring attention / Ulysses)
- ``tp``   — tensor parallelism (megatron-style sharded matmuls)
- ``ep``   — expert parallelism (MoE all-to-all), usually aliasing dp/fsdp

Axes listed in ``dcn_axes`` cross host boundaries; the rest stay inside
a host.

``shard_map`` has no counterpart: the JAX package maps a per-device
function over a global array with it, and the port's functions are
per-rank already (each rank passes its own shard and names the axis its
collectives run over), so it raises with a message that says so.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Dict, Optional, Sequence, Tuple

if TYPE_CHECKING:  # torch is imported where a mesh is built: the
    # vocabulary below serves Train's config, which loads no torch
    from torch.distributed.device_mesh import DeviceMesh

AXIS_ORDER = ("dp", "fsdp", "pp", "sp", "tp", "ep")


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


def build_mesh(config: Optional[MeshConfig] = None,
               devices: Optional[Sequence[int]] = None, *,
               device: str = "cuda") -> DeviceMesh:
    """A ``DeviceMesh`` with all six named axes over the ranks of the
    default process group, or over ``devices`` (global ranks, each
    process's one device), laid out in ``AXIS_ORDER``: the innermost
    axes (tp, sp) over neighbouring ranks.  Every rank calls it with the
    same arguments; it makes one process group per axis.  ``device`` is
    ``"cuda"`` (NCCL) unless the caller asks for the CPU (``"cpu"``, a
    gloo group).

    Needs ``torch.distributed`` initialised: nothing tells a program of
    its cluster, so the caller gives ``init_process_group`` its address,
    world size and rank."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if not dist.is_initialized():
        raise RuntimeError(
            "build_mesh needs torch.distributed initialised: call "
            "init_process_group(backend, init_method='tcp://host:port', "
            "world_size=..., rank=...) on every rank first")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"build_mesh: device 'cuda' or 'cpu', got "
                         f"{device!r}")
    ranks = list(range(dist.get_world_size()) if devices is None
                 else devices)
    config = (config or MeshConfig(dp=-1)).resolved(len(ranks))
    sizes = config.axis_sizes()
    shape = tuple(sizes[a] for a in AXIS_ORDER)
    return DeviceMesh(device, torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=AXIS_ORDER)


def mesh_axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_group(mesh: Optional[DeviceMesh], axis: str):
    """The process group of ``axis`` on ``mesh``, or None where the
    axis has one rank (or there is no mesh, or the mesh lacks the axis:
    ``sharding.active_mesh`` drops the axes of one rank): its
    collectives are then the identity and need no group."""
    if mesh is None or axis not in (mesh.mesh_dim_names or ()) or \
            mesh_axis_size(mesh, axis) == 1:
        return None
    return mesh.get_group(axis)


_global_mesh: Optional[DeviceMesh] = None


def set_global_mesh(mesh: Optional[DeviceMesh]) -> None:
    """Install the process-wide mesh the model's sequence-parallel
    attention reads (GPT-2's ``attn_impl="ring" | "ulysses"``)."""
    global _global_mesh
    _global_mesh = mesh


def get_global_mesh() -> Optional[DeviceMesh]:
    return _global_mesh


class use_mesh:
    """Context manager form of :func:`set_global_mesh`."""

    def __init__(self, mesh: DeviceMesh):
        self.mesh = mesh
        self._prev: Optional[DeviceMesh] = None

    def __enter__(self) -> DeviceMesh:
        self._prev = get_global_mesh()
        set_global_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc) -> None:
        set_global_mesh(self._prev)


def local_mesh_summary(mesh: DeviceMesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def shard_map(f, *, mesh, in_specs, out_specs, **kwargs):
    raise NotImplementedError(
        "shard_map has no ray_tpu_torch counterpart: the port's functions "
        "are per-rank already; call them on each rank's shard with the "
        "mesh and the axis name (ring_attention(q, k, v, mesh=mesh, "
        "axis_name='sp'))")
