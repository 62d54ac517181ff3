"""Parallelism library: mesh building, the sharding presets, and
sequence, pipeline and expert parallelism, on ``torch.distributed``, as
the JAX package's parallel layer.  Parameters and batches placed by the
presets (``parallel.sharding``) are DTensors over the port's
``DeviceMesh``; ``pipeline_apply`` runs one stage a rank of the pp axis.

Importing the package loads no torch (Train's config names
``MeshConfig``, and a CPU worker pays no torch import for it):
``ring_attention``, ``ulysses_attention`` and ``pipeline_apply`` are
loaded at first use.  As in the JAX package,
``ray_tpu_torch.parallel.ring_attention`` is the function; its module is
``sys.modules["ray_tpu_torch.parallel.ring_attention"]``.
"""

import importlib
import sys
import types

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    MeshConfig,
    build_mesh,
    get_global_mesh,
    local_mesh_summary,
    mesh_axis_size,
    mesh_shape_for,
    set_global_mesh,
    use_mesh,
)
from ray_tpu_torch.parallel.sharding import (  # noqa: F401
    ShardingRules,
    logical_to_mesh,
    shard_params,
    with_sharding_constraint,
)

# name -> the module that defines it, imported at first use
_LAZY = {"ring_attention": "ray_tpu_torch.parallel.ring_attention",
         "ulysses_attention": "ray_tpu_torch.parallel.ulysses",
         "pipeline_apply": "ray_tpu_torch.parallel.pipeline"}


def __getattr__(name):
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    fn = getattr(importlib.import_module(_LAZY[name]), name)
    setattr(sys.modules[__name__], name, fn)
    return fn


class _Package(types.ModuleType):
    """The import system binds a loaded submodule on its package; here
    the name ``ring_attention`` stays the function, whichever import
    loads the module first."""

    def __setattr__(self, name, value):
        if name in _LAZY and isinstance(value, types.ModuleType):
            return
        super().__setattr__(name, value)


sys.modules[__name__].__class__ = _Package
