"""Ulysses-style sequence parallelism: all-to-all head resharding.

Counterpart of ``ray_tpu/parallel/ulysses.py``.  Complement to ring
attention: instead of passing K/V around, one all-to-all
(``dist.all_to_all_single`` on the ``sp`` axis' process group, where the
JAX package uses ``lax.all_to_all``) turns this rank's sequence chunk of
every head into the whole sequence of ``heads / sp`` heads; each rank
then runs ordinary attention (the flash kernels, in their usual bf16
mode), and a second all-to-all turns the result back.  Heads must divide
by the axis size.  The functions are per-rank, as ring attention's are;
with one rank on the axis, or no mesh, the all-to-alls are the identity.
"""

from __future__ import annotations

import functools
from typing import Callable, List, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.flash_attention import flash_attention
from ray_tpu_torch.parallel.mesh import axis_group


def all_to_all(x: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, split_axis=split_dim, concat_axis=concat_dim,
    tiled=True)`` over ``group``: ``x`` cut into ``n`` pieces along
    ``split_dim``, piece ``j`` sent to rank ``j``, the pieces received
    joined along ``concat_dim`` in rank order.  The identity without a
    group."""
    n = 1 if group is None else dist.get_world_size(group)
    if n == 1:
        return x
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    got = torch.empty_like(send)
    dist.all_to_all_single(got, send, group=group)
    return torch.cat(got.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all` under autograd: the gradient takes the
    all-to-all back (the two dimensions swapped)."""

    @staticmethod
    def forward(ctx, x, group, split_dim, concat_dim):
        ctx.args = group, concat_dim, split_dim
        return all_to_all(x, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g.contiguous(), *ctx.args), None, None, None


def _local_attn(q, k, v, causal: bool, scale: float):
    """Post-all-to-all local attention: the port's ``flash_attention``
    (the kernels on CUDA tensors, their plain versions on the CPU).  The
    JAX call's ``block_q`` / ``block_k`` / ``interpret`` and its
    ``kernel_block_for`` gate are TPU tiling matters the CUDA kernels do
    not have."""
    return flash_attention(q, k, v, causal=causal, scale=scale)


def _ulysses_sharded(q, k, v, group, causal: bool, scale: float,
                     attn_fn: Optional[Callable]):
    # [B, T/n, H, D] -> all-to-all -> [B, T, H/n, D]
    def seq_to_heads(x):
        return _AllToAll.apply(x, group, 2, 1)

    def heads_to_seq(x):
        return _AllToAll.apply(x, group, 1, 2)

    qh, kh, vh = seq_to_heads(q), seq_to_heads(k), seq_to_heads(v)
    fn = attn_fn or functools.partial(_local_attn, causal=causal,
                                      scale=scale)
    return heads_to_seq(fn(qh, kh, vh))


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      axis_name: str = "sp", causal: bool = True,
                      scale: Optional[float] = None,
                      attn_fn: Optional[Callable] = None,
                      mesh=None) -> torch.Tensor:
    """All-to-all sequence-parallel attention over ``axis_name`` of
    ``mesh``: ``q``, ``k``, ``v`` are this rank's sequence chunk
    ``[batch, seq / sp, heads, head_dim]`` and the result is its chunk of
    the output.  The local attention after resharding is the port's
    ``flash_attention``; ``attn_fn(q, k, v)`` overrides it.  Heads must
    be divisible by the axis size."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    group = axis_group(mesh, axis_name)
    n = 1 if group is None else dist.get_world_size(group)
    if q.shape[2] % n:
        raise ValueError(f"ulysses_attention: {q.shape[2]} heads do not "
                         f"divide by the {axis_name!r} axis' {n} ranks")
    return _ulysses_sharded(q, k, v, group, causal, scale, attn_fn)


def simulate_ulysses(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     world: int, *, causal: bool = True,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Ulysses over ``world`` ranks in one process, differentiable: the
    global ``[B, T, H, D]`` q, k, v cut into ``world`` sequence chunks,
    the all-to-all done by hand (rank ``j`` receives head group ``j`` of
    every rank's chunk, joined in rank order), :func:`_local_attn` on
    each rank's heads, and the way back.  Returns the output, the chunks
    joined again."""
    if scale is None:
        scale = q.shape[-1] ** -0.5

    def exchange(chunks: List[torch.Tensor], split_dim, concat_dim):
        pieces = [x.chunk(world, dim=split_dim) for x in chunks]
        return [torch.cat([pieces[r][j] for r in range(world)],
                          dim=concat_dim).contiguous()
                for j in range(world)]

    qh, kh, vh = (exchange(list(x.chunk(world, dim=1)), 2, 1)
                  for x in (q, k, v))
    outs = [_local_attn(a, b, c, causal, scale)
            for a, b, c in zip(qh, kh, vh)]
    return torch.cat(exchange(outs, 1, 2), dim=1)
