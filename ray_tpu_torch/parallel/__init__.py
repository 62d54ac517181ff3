"""Parallelism library: mesh building and sequence parallelism (ring
attention, Ulysses) on ``torch.distributed``, as the JAX package's
parallel layer.  The sharding presets (``ShardingRules`` and the
rest of ``parallel/sharding.py``) and ``pipeline_apply`` come with the
next slice of the parallel layer (ROADMAP.md, queue 1, item 5) and raise
until then.

Importing the package loads no torch (Train's config names
``MeshConfig``, and a CPU worker pays no torch import for it):
``ring_attention`` and ``ulysses_attention`` are loaded at first use.
As in the JAX package, ``ray_tpu_torch.parallel.ring_attention`` is the
function; its module is ``sys.modules["ray_tpu_torch.parallel.
ring_attention"]``.
"""

import importlib
import sys
import types

from ray_tpu_torch import _port
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

_LATER = "queue 1, item 5"
# name -> the module that defines it, imported at first use
_LAZY = {"ring_attention": "ray_tpu_torch.parallel.ring_attention",
         "ulysses_attention": "ray_tpu_torch.parallel.ulysses"}


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


class ShardingRules:
    def __init__(self, *args, **kwargs):
        raise _port.not_ported("ShardingRules", _LATER)


def logical_to_mesh(*args, **kwargs):
    raise _port.not_ported("logical_to_mesh", _LATER)


def shard_params(*args, **kwargs):
    raise _port.not_ported("shard_params", _LATER)


def with_sharding_constraint(*args, **kwargs):
    raise _port.not_ported("with_sharding_constraint", _LATER)


def pipeline_apply(*args, **kwargs):
    raise _port.not_ported("pipeline_apply", _LATER)
