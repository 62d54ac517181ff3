"""Parallelism library.  Only the mesh vocabulary is here
(:class:`MeshConfig`, ``mesh_shape_for``); building a mesh, sharding
presets and sequence / pipeline / expert parallelism come with the
parallel layer (ROADMAP.md, queue 1, item 5) and raise until then."""

from ray_tpu_torch.parallel.mesh import (  # noqa: F401
    AXIS_ORDER,
    MeshConfig,
    build_mesh,
    mesh_shape_for,
)
