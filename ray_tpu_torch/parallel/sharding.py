"""Logical-axis sharding rules and their presets, on DTensor.

Counterpart of ``ray_tpu/parallel/sharding.py``.  Model code names each
parameter's dims with *logical* axes ("batch", "seq", "embed", "mlp",
"heads", "kv", "vocab", "layers", "expert"; each model's
``logical_axes()`` table); a :class:`ShardingRules` table maps them to
the axes of the port's ``DeviceMesh`` (``parallel.mesh.AXIS_ORDER``) per
parallelism style, as the JAX package maps them to a ``jax.sharding.Mesh``.

Where the JAX package hands a ``PartitionSpec`` to GSPMD, the port makes
the tensor a ``torch.distributed.tensor.DTensor``: a logical axis becomes
``Shard(dim)`` on each mesh axis its rule names and ``Replicate()`` on
every other, and DTensor's sharding propagation inserts the collectives
as XLA does.  A tuple rule (``"batch": ("dp", "fsdp")``) shards one
tensor dim over several mesh axes, major first, as a ``PartitionSpec``
does; DTensor shards in mesh order, so the axes of a tuple must come in
``AXIS_ORDER``.  A dim that does not divide by its axes' size is split as
``torch.chunk`` splits it: the leading shards one row longer (GPT-2's
50257-row vocabulary over tp = 2 is 25129 + 25128 rows); XLA pads the
last shard instead, which no result depends on.

Nothing here imports torch until a mesh is touched: Train's config
loads ``ray_tpu_torch.parallel``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, NamedTuple, Optional, Tuple, Union

from ray_tpu_torch.parallel.mesh import AXIS_ORDER

MeshAxis = Union[None, str, Tuple[str, ...]]


class ShardSpec(dict):
    """The port's placement spec: mesh axis -> the tensor dim it shards
    (mesh axes that are absent replicate).  Equal to a plain dict of the
    same items, so ``TP_RULES.spec("embed", "mlp") == {"fsdp": 0,
    "tp": 1}``."""

    def placements(self, mesh) -> list:
        """One ``Shard`` or ``Replicate`` per dim of ``mesh``; the spec's
        axes that ``mesh`` lacks are taken to be of one rank
        (:func:`active_mesh` drops only those)."""
        from torch.distributed.tensor import Replicate, Shard
        return [Shard(self[a]) if a in self else Replicate()
                for a in mesh.mesh_dim_names]


def _spec(per_dim: list) -> ShardSpec:
    """The spec of a tensor whose dim ``i`` is split over the mesh axes
    ``per_dim[i]`` names (None, an axis, or a tuple of axes, major
    first)."""
    out = ShardSpec()
    for dim, rule in enumerate(per_dim):
        axes = () if rule is None else \
            (rule,) if isinstance(rule, str) else tuple(rule)
        order = [AXIS_ORDER.index(a) if a in AXIS_ORDER else -1
                 for a in axes]
        if order != sorted(order):
            raise ValueError(
                f"dim {dim} over {axes}: DTensor shards a dim over mesh "
                f"axes in mesh order; list them as {AXIS_ORDER} does")
        for a in axes:
            if a in out:
                raise ValueError(f"mesh axis {a!r} shards dims {out[a]} "
                                 f"and {dim} of one tensor")
            out[a] = dim
    return out


@dataclass
class ShardingRules:
    """logical axis -> mesh axis (or tuple of axes, or None=replicated)."""

    rules: Dict[str, MeshAxis] = field(default_factory=dict)

    def spec(self, *logical_axes: Optional[str]) -> ShardSpec:
        """The :class:`ShardSpec` of a tensor whose dims carry
        ``logical_axes`` (None for a dim that no rule shards)."""
        return _spec([self.rules.get(a) if a is not None else None
                      for a in logical_axes])

    def merged(self, **updates: MeshAxis) -> "ShardingRules":
        out = dict(self.rules)
        out.update(updates)
        return ShardingRules(out)


#: Fully-replicated parameters, batch split over data axes (DP).
DP_RULES = ShardingRules({
    "batch": ("dp", "fsdp"),
    "seq": None, "embed": None, "mlp": None, "heads": None,
    "kv": None, "vocab": None, "layers": None, "expert": None,
})

#: FSDP: parameters sharded over the fsdp axis on their largest dim.
FSDP_RULES = ShardingRules({
    "batch": ("dp", "fsdp"),
    "embed": "fsdp",
    "seq": None, "mlp": None, "heads": None, "kv": None,
    "vocab": None, "layers": None, "expert": None,
})

#: Megatron-style TP on top of (F)SDP: hidden/heads over tp.
TP_RULES = ShardingRules({
    "batch": ("dp", "fsdp"),
    "embed": "fsdp",
    "mlp": "tp",
    "heads": "tp",
    "kv": "tp",
    "vocab": "tp",
    "seq": None, "layers": None, "expert": None,
})

#: Sequence/context parallelism: activations split on seq over sp.
SP_RULES = TP_RULES.merged(seq="sp")

#: Expert parallelism: experts over ep (usually aliased with fsdp).
EP_RULES = TP_RULES.merged(expert="ep")

PRESETS: Dict[str, ShardingRules] = {
    "dp": DP_RULES,
    "fsdp": FSDP_RULES,
    "tp": TP_RULES,
    "sp": SP_RULES,
    "ep": EP_RULES,
}


def active_mesh(mesh):
    """The sub-mesh of ``mesh``'s axes of more than one rank (its first
    axis where every axis has one): where tensors are placed.  Sharding
    over an axis of one rank is the identity, and DTensor enumerates its
    strategies over every dim of a mesh, which over ``build_mesh``'s six
    axes costs seconds an operation."""
    names = mesh.mesh_dim_names
    if names is None or len(names) == 1:
        return mesh
    keep = tuple(a for a, n in zip(names, mesh.shape) if n > 1) \
        or names[:1]
    return mesh if keep == tuple(names) else mesh[keep]


def _tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples that are
    not logical-axes tuples (those are leaves of ``tree``)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def logical_to_mesh(rules: ShardingRules, logical_specs: Any) -> Any:
    """Map a tree (nested dicts) of logical-axis tuples to
    :class:`ShardSpec` s; a leaf that is no tuple or list is replicated
    (an empty spec)."""
    return _tree_map(lambda axes: rules.spec(*axes)
                     if isinstance(axes, (tuple, list)) else ShardSpec(),
                     logical_specs)


def _place(x, spec: ShardSpec, mesh):
    from torch.distributed.tensor import distribute_tensor
    if max(spec.values(), default=-1) >= x.dim():
        raise ValueError(f"spec {dict(spec)} does not fit a tensor of "
                         f"shape {tuple(x.shape)}")
    mesh = active_mesh(mesh)
    return distribute_tensor(x.detach(), mesh, spec.placements(mesh))


def shard_params(params: Any, logical_specs: Any, rules: ShardingRules,
                 mesh) -> Any:
    """Place a tree (nested dicts) of tensors on ``mesh`` according to
    logical specs: each leaf becomes a DTensor on :func:`active_mesh`
    (``distribute_tensor``: every rank passes the same values, rank 0's
    are scattered).  Every rank calls it with the same arguments."""
    specs = logical_to_mesh(rules, logical_specs)
    return _tree_map(lambda x, s: _place(x, s, mesh), params, specs)


def shard_tensor(x, rules: ShardingRules, mesh,
                 *logical_axes: Optional[str]):
    """One tensor placed as ``rules`` place ``logical_axes`` (a batch of
    tokens: ``shard_tensor(tokens, rules, mesh, "batch", None)``), the
    ``jax.device_put(x, NamedSharding(mesh, rules.spec(...)))`` of the
    JAX package."""
    return _place(x, rules.spec(*logical_axes), mesh)


def with_sharding_constraint(x: Any, rules: ShardingRules,
                             *logical_axes: Optional[str]) -> Any:
    """Activation sharding hint: a DTensor is redistributed to the
    placements of ``logical_axes``; any other tensor is returned as it
    is, as the JAX version is a no-op outside a mesh context."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    return x.redistribute(mesh, rules.spec(*logical_axes).placements(mesh))


class NamedSharding(NamedTuple):
    """A mesh and a spec over its axes (``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: ShardSpec

    @property
    def placements(self) -> list:
        return self.spec.placements(self.mesh)


def named_sharding(mesh, *axes: MeshAxis) -> NamedSharding:
    """``NamedSharding(mesh, P(*axes))``: tensor dim ``i`` split over the
    mesh axes ``axes[i]`` names."""
    return NamedSharding(mesh, _spec(list(axes)))


def module_sharding(module, rules: ShardingRules
                    ) -> Tuple[Dict[str, Any], Dict[str, ShardSpec]]:
    """``flax_sharding`` for a module: its named parameters and their
    :class:`ShardSpec` s under ``rules``, from the module's
    ``logical_axes()`` table (a module without one, or a parameter the
    table lacks, is replicated: ResNet names none, as in the JAX
    package)."""
    table = module.logical_axes() if hasattr(module, "logical_axes") \
        else {}
    params = dict(module.named_parameters())
    unknown = set(table) - set(params)
    if unknown:
        raise ValueError(f"logical_axes() names {sorted(unknown)}, which "
                         f"are no parameters of {type(module).__name__}")
    return params, {n: rules.spec(*table.get(n, ())) for n in params}


def place_module_params(module, rules: ShardingRules, mesh
                        ) -> Tuple[Any, Dict[str, ShardSpec]]:
    """``place_flax_params`` for a module: every parameter replaced, in
    place, by a DTensor parameter on ``mesh`` under ``rules``; returns
    (the module, the spec of each parameter).  Build the optimizer after
    this, over the new parameters."""
    import torch
    params, specs = module_sharding(module, rules)
    for name, p in params.items():
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        setattr(sub, leaf, torch.nn.Parameter(
            _place(p, specs[name], mesh), requires_grad=p.requires_grad))
    return module, specs


def place_gradients(module) -> None:
    """Give each DTensor parameter's gradient the parameter's placement:
    autograd leaves it a partial sum over the ranks that split the batch,
    and the reduction (an all-reduce, or a reduce-scatter for a split
    parameter) happens here, as GSPMD returns gradients placed as their
    parameters.  Call it between the backward and the optimizer step."""
    from torch.distributed.tensor import DTensor
    for p in module.parameters():
        g = p.grad
        if isinstance(g, DTensor) and \
                tuple(g.placements) != tuple(p.placements):
            p.grad = g.redistribute(p.device_mesh, p.placements)
