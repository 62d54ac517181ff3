"""Pipeline parallelism over the ``pp`` mesh axis.

Counterpart of ``ray_tpu/parallel/pipeline.py``: GPipe-style microbatch
pipelining.  Rank *i* of the axis holds stage *i*'s parameters; at
schedule tick *t* it applies its stage to the activation that arrived
from stage *i - 1* (stage 0 ingests microbatch *t*) and sends the result
on.  The schedule runs ``n_micro + n_stages - 1`` ticks (fill and
drain); a stage is idle at the ticks outside ``[i, i + n_micro)``, where
the JAX version computes and masks to zero; the last stage records each
finished microbatch, and the outputs are summed over the axis (only the
last stage's are nonzero), so every rank holds them.

Where the JAX version is one ``shard_map`` + ``lax.scan`` that XLA
differentiates, each stage here is a process and autograd does not cross
ranks: :func:`pipeline_apply` is a ``torch.autograd.Function`` whose
forward keeps each microbatch's graph of its stage and sends activations
by ``isend`` / ``irecv`` over the pp group, and whose backward runs the
reverse schedule, each stage sending each microbatch's cotangent to the
stage before it.  The last stage takes the outputs' cotangent as every
rank holds it (the outputs are replicated); the microbatches' cotangent,
stage 0's, is summed over the axis in turn.

:func:`simulate_pipeline` runs the same schedule with every stage in one
process (one card, or the CPU), as ``simulate_ring`` does for the ring,
and plain autograd differentiates it.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from ray_tpu_torch.parallel.mesh import get_global_mesh, mesh_axis_size


def _stage_leaves(leaves: List[torch.Tensor], idx: int,
                  axis_name: str) -> List[torch.Tensor]:
    """This rank's stage of each stacked leaf: a DTensor split over the
    axis holds it as its local ``[1, ...]``; a plain ``[n_stages, ...]``
    tensor gives its row ``idx``."""
    from ray_tpu_torch.ops._build import is_dtensor
    out = []
    for x in leaves:
        if is_dtensor(x):
            names = x.device_mesh.mesh_dim_names
            dims = [names[i] for i, p in enumerate(x.placements)
                    if p.is_shard(0)]
            if dims != [axis_name] or x.to_local().shape[0] != 1:
                raise ValueError(
                    f"pipeline_apply: a DTensor stage parameter must be "
                    f"split over {axis_name!r} alone, one stage a rank; "
                    f"got {tuple(x.placements)} on {names}")
            out.append(x.to_local()[0])
        else:
            out.append(x[idx])
    return out


class _Pipeline(torch.autograd.Function):
    """The pipeline on one rank of the pp group: ``forward(ctx, plan,
    microbatches, *leaves)``, where ``plan`` holds the stage function,
    the parameters' tree and the group; returns the outputs, the same on
    every rank."""

    @staticmethod
    def forward(ctx, plan, microbatches, *leaves):
        n_micro = microbatches.shape[0]
        ctx.plan, ctx.saved = plan, []
        prev, nxt = plan.peer(-1), plan.peer(1)
        outputs = torch.zeros_like(microbatches)
        sends = []
        recv = None
        if prev is not None:  # posted a microbatch ahead of its use
            recv = plan.irecv(microbatches[0], prev)
        for m in range(n_micro):
            if prev is None:
                x = microbatches[m]
            else:
                buf, req = recv
                req.wait()
                x = buf
                if m + 1 < n_micro:
                    recv = plan.irecv(microbatches[m + 1], prev)
            with torch.enable_grad():
                # a later stage always returns a cotangent to the one
                # before it
                x_ = x.detach().requires_grad_(
                    prev is not None or microbatches.requires_grad)
                params = [p.detach().requires_grad_(p.requires_grad)
                          for p in leaves]
                y = plan.stage_fn(pytree.tree_unflatten(params, plan.tree),
                                  x_)
            if tuple(y.shape) != tuple(x.shape) or y.dtype != x.dtype:
                raise ValueError(
                    f"pipeline_apply: a stage maps {tuple(x.shape)} "
                    f"{x.dtype} to {tuple(y.shape)} {y.dtype}; stages "
                    "must keep the activation's shape and dtype")
            ctx.saved.append((x_, params, y))
            if nxt is None:
                outputs[m] = y.detach()
            else:
                sends.append(plan.isend(y.detach().contiguous(), nxt))
        for req in sends:
            req.wait()
        plan.all_reduce(outputs)
        return outputs

    @staticmethod
    def backward(ctx, g_out):
        plan = ctx.plan
        prev, nxt = plan.peer(-1), plan.peer(1)
        n_micro = len(ctx.saved)
        grads: List[Optional[torch.Tensor]] = [None] * len(
            ctx.saved[0][1])
        d_micro = torch.zeros_like(g_out)
        sends = []
        for m in reversed(range(n_micro)):
            x_, params, y = ctx.saved[m]
            if nxt is None:
                gy = g_out[m]
            else:
                buf, req = plan.irecv(g_out[m], nxt)
                req.wait()
                gy = buf
            wants = [t for t in (x_, *params) if t.requires_grad]
            got = iter(torch.autograd.grad(y, wants, gy,
                                           allow_unused=True)
                       if wants else ())
            dx = next(got) if x_.requires_grad else None
            for i, p in enumerate(params):
                if p.requires_grad:
                    g = next(got)
                    if g is not None:
                        grads[i] = g if grads[i] is None else grads[i] + g
            if dx is None:
                dx = torch.zeros_like(x_)
            if prev is None:
                d_micro[m] = dx
            else:
                sends.append(plan.isend(dx.contiguous(), prev))
        for req in sends:
            req.wait()
        ctx.saved = None
        plan.all_reduce(d_micro)
        return (None, d_micro, *grads)


class _Plan:
    """A rank's place in the pipeline: its stage, the group's peers, and
    the point-to-point and reduction calls over the pp group."""

    def __init__(self, stage_fn, tree, group, idx, n_stages):
        self.stage_fn, self.tree = stage_fn, tree
        self.group, self.idx, self.n_stages = group, idx, n_stages

    def peer(self, step: int) -> Optional[int]:
        """The global rank of the stage ``step`` away, or None past an
        end of the pipeline."""
        j = self.idx + step
        if not 0 <= j < self.n_stages:
            return None
        return dist.get_global_rank(self.group, j)

    def isend(self, x, dst):
        return dist.isend(x, dst, group=self.group)

    def irecv(self, like, src):
        buf = torch.empty_like(like, memory_format=torch.contiguous_format)
        return buf, dist.irecv(buf, src, group=self.group)

    def all_reduce(self, x):
        if self.n_stages > 1:
            dist.all_reduce(x, group=self.group)


def pipeline_apply(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                   stage_params: Any, microbatches: torch.Tensor, *,
                   axis_name: str = "pp", mesh=None) -> torch.Tensor:
    """Run ``stage_fn(params, x)`` as a pipeline over the mesh axis
    ``axis_name`` (of ``mesh``, or of the global mesh), one stage a rank.

    - ``stage_params``: a tree (dicts, lists, tuples) whose leaves have a
      leading ``[n_stages]`` dim (:func:`stack_block_params`): plain
      tensors, of which rank *i* of the axis takes row *i*, or DTensors
      split over the axis (``Shard(0)``), of which it takes its shard.
    - ``microbatches``: ``[n_micro, micro_batch, ...]`` activations fed
      to stage 0, the same on every rank; a stage keeps their shape and
      dtype.  Returns ``[n_micro, ...]``, the last stage's, on every rank.

    Every rank of the axis calls it with the same ``microbatches``;
    gradients reach this rank's stage of ``stage_params`` and, summed
    over the axis, the microbatches."""
    mesh = mesh if mesh is not None else get_global_mesh()
    if mesh is None:
        raise ValueError(
            "pipeline_apply needs a mesh with the axis "
            f"{axis_name!r} (mesh=, or parallel.use_mesh); "
            "simulate_pipeline runs every stage in one process")
    n_stages = mesh_axis_size(mesh, axis_name)
    group = mesh.get_group(axis_name)
    idx = dist.get_rank(group)
    leaves, tree = pytree.tree_flatten(stage_params)
    for x in leaves:
        if x.shape[0] != n_stages:
            raise ValueError(f"pipeline_apply: a stage parameter of "
                             f"shape {tuple(x.shape)} for {n_stages} "
                             "stages")
    mine = _stage_leaves(leaves, idx, axis_name)
    plan = _Plan(stage_fn, tree, group, idx, n_stages)
    return _Pipeline.apply(plan, microbatches, *mine)


def simulate_pipeline(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                      stage_params: Any,
                      microbatches: torch.Tensor) -> torch.Tensor:
    """:func:`pipeline_apply`'s schedule with every stage in this
    process: at tick *t*, stage *i* applies its parameters (row *i* of
    each leaf) to microbatch *t - i*, as it arrived from stage *i - 1*,
    and the last stage records it.  Differentiable by plain autograd;
    the result is the blocks run in sequence on each microbatch, in the
    pipeline's order of work."""
    leaves, tree = pytree.tree_flatten(stage_params)
    n_stages = leaves[0].shape[0]
    if any(x.shape[0] != n_stages for x in leaves):
        raise ValueError("simulate_pipeline: stage parameters disagree on "
                         "the number of stages")
    stages = [pytree.tree_unflatten([x[i] for x in leaves], tree)
              for i in range(n_stages)]
    n_micro = microbatches.shape[0]
    arriving: List[Optional[torch.Tensor]] = [None] * n_stages
    outputs: List[Optional[torch.Tensor]] = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        sent: List[Optional[torch.Tensor]] = [None] * n_stages
        for i in range(n_stages):
            m = t - i
            if not 0 <= m < n_micro:
                continue
            x = microbatches[m] if i == 0 else arriving[i]
            y = stage_fn(stages[i], x)
            if i == n_stages - 1:
                outputs[m] = y
            else:
                sent[i + 1] = y
        arriving = sent
    return torch.stack(outputs)


def stack_block_params(per_block_params: list) -> Any:
    """Stack N structurally identical parameter trees (dicts of tensors,
    such as ``dict(block.named_parameters())``) into one tree with a
    leading ``[N]`` dim, the layout :func:`pipeline_apply` gives one row
    a stage.  The stack is differentiable: gradients of the stacked
    tensors reach the blocks' own parameters."""
    flat = [pytree.tree_flatten(p) for p in per_block_params]
    tree = flat[0][1]
    if any(t != tree for _, t in flat):
        raise ValueError("stack_block_params: the trees differ")
    return pytree.tree_unflatten(
        [torch.stack(xs) for xs in zip(*(leaves for leaves, _ in flat))],
        tree)
