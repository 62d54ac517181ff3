"""Ring attention: exact attention over sequence shards, with K/V chunks
passed around a ring of ranks.

Counterpart of ``ray_tpu/parallel/ring_attention.py``.  Each rank on the
``sp`` axis of the mesh holds a contiguous chunk of the sequence's Q, K
and V (rank ``r`` positions ``r * T_local ...``).  Over ``sp``-many steps
every rank computes attention of its Q chunk against the K/V chunk it
holds, then passes K/V on to the next rank (``dist.batch_isend_irecv``
on the axis' process group, where the JAX package uses ``lax.ppermute``);
at step ``s`` rank ``r`` holds the chunk of rank ``(r - s) mod sp``.  The
functions are per-rank: each rank calls them on its own chunk (the JAX
package's ``shard_map`` has no counterpart here).  With one rank on the
axis, or no mesh, the ring sends nothing and needs no process group.

Two implementations, as in the JAX package:

* ``"reference"``: the plain online-softmax ring (``_block_attn``), every
  chunk pair masked per element in f32, differentiable by autograd (the
  K/V sends are an autograd Function whose backward sends the other
  way);
* ``"kernel"``: each chunk pair through the flash kernels in their chunk
  mode (``ops.flash_attention._flash_chunk_fwd``: bf16 in, f32 out and
  the chunk's LSE), the normalised partials merged in f32 by the
  log-sum-exp identity (``_merge_partials``).  Causality becomes chunk
  classification: a K/V chunk is the diagonal (causal kernel), in the
  past (the kernel without the mask) or in the future, which is skipped.
  The backward (``_RingFlash``, the JAX ``custom_vjp``) rides the ring a
  second time: ``delta`` is computed once from the final O, each step
  adds ``_flash_chunk_bwd`` of the chunk it holds (against the global
  LSE and delta) to dQ and to the f32 dK/dV accumulators, which travel
  with their K/V chunk and arrive home after ``sp`` hops.  In both
  passes a step posts the send of the K/V chunk it holds (and the
  receive of the next) before its chunk kernel and waits for them after
  it (:func:`ring_shift_start`, :func:`ring_shift_wait`), so the
  transfer overlaps the kernel, as the JAX ring's ``ppermute``, which
  does not depend on the step's chunk, lets XLA overlap it.

Each step's body (:func:`ring_fwd_step`, :func:`ring_bwd_step`) is a
function of its own, as the JAX ``step`` closures are, so that
:func:`simulate_ring` can drive the steps of P ranks in one process, as
the JAX tests drive 8 virtual devices in one process.  The accumulators
are updated in place, which saves a copy of each per step.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.flash_attention import (_flash_chunk_bwd,
                                               _flash_chunk_fwd)
from ray_tpu_torch.parallel.mesh import axis_group

NEG_INF = -1e30


def _size_rank(group) -> Tuple[int, int]:
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def ring_shift_start(xs, group, shift: int = 1):
    """Post, in one batch, the sends of the tensors ``xs`` to rank
    ``+shift`` on the ring of ``group`` and the receives of their
    counterparts from rank ``-shift``; return ``(receive buffers,
    requests)`` for :func:`ring_shift_wait`.  Until then ``xs`` must not
    be written (reading them is fine).  Without a group the buffers are
    ``xs`` themselves and there is nothing to wait for."""
    n, me = _size_rank(group)
    if n == 1:
        return list(xs), []
    xs = [x.contiguous() for x in xs]
    got = [torch.empty_like(x) for x in xs]
    dst = dist.get_global_rank(group, (me + shift) % n)
    src = dist.get_global_rank(group, (me - shift) % n)
    ops = []
    for x, y in zip(xs, got):
        ops += [dist.P2POp(dist.isend, x, dst, group),
                dist.P2POp(dist.irecv, y, src, group)]
    return got, dist.batch_isend_irecv(ops)


def ring_shift_wait(pending) -> List[torch.Tensor]:
    """Wait for a :func:`ring_shift_start`'s transfers; return the
    received tensors."""
    got, reqs = pending
    for req in reqs:
        req.wait()
    return got


def ring_shift(x: torch.Tensor, group, shift: int = 1) -> torch.Tensor:
    """The tensor of the rank ``shift`` places before this one on the
    ring of ``group``: each rank sends ``x`` to rank ``+shift`` and
    receives from rank ``-shift`` (``lax.ppermute`` with the permutation
    ``i -> i + shift``).  The identity without a group."""
    return ring_shift_wait(ring_shift_start((x,), group, shift))[0]


class _Shift(torch.autograd.Function):
    """:func:`ring_shift` under autograd: the gradient goes back the
    other way round the ring."""

    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return ring_shift(x, group, shift)

    @staticmethod
    def backward(ctx, g):
        return ring_shift(g, ctx.group, -ctx.shift), None, None


def _block_attn(q, k, v, m, l, o, q_offset, k_offset, causal, scale):
    """One blockwise online-softmax update.

    q: [B, Tq, H, D]; k, v: [B, Tk, H, D]
    m, l: [B, H, Tq] running max / normalizer; o: [B, Tq, H, D]
    """
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        q_pos = q_offset + torch.arange(tq, device=q.device)[:, None]
        k_pos = k_offset + torch.arange(tk, device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m, s.amax(dim=-1))
    # guard fully-masked rows (m_new == NEG_INF) against NaNs
    safe_m = torch.where(m_new <= NEG_INF / 2, 0.0, m_new)
    p = torch.exp(s - safe_m[..., None])
    p = torch.where(torch.isfinite(s), p, 0.0)
    correction = torch.exp(torch.where(m <= NEG_INF / 2, NEG_INF, m)
                           - safe_m)
    correction = torch.where(m <= NEG_INF / 2, 0.0, correction)
    l_new = l * correction + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    o_new = o * correction.transpose(1, 2)[..., None] + pv
    return m_new, l_new, o_new


def _ring_attention_sharded(q, k, v, group, causal: bool, scale: float):
    """The plain ring (differentiable by autograd): the CPU's path."""
    n, me = _size_rank(group)
    batch, tq, heads, dim = q.shape
    m = torch.full((batch, heads, tq), NEG_INF, device=q.device)
    l = torch.zeros((batch, heads, tq), device=q.device)
    o = torch.zeros((batch, tq, heads, dim), device=q.device)
    k_cur, v_cur = k, v
    for s in range(n):
        # the K/V chunk at ring step s came from rank (me - s) mod n
        k_idx = (me - s) % n
        m, l, o = _block_attn(q, k_cur, v_cur, m, l, o, me * tq,
                              k_idx * k_cur.shape[1], causal, scale)
        if s < n - 1:  # the last step's chunk goes nowhere
            k_cur = _Shift.apply(k_cur, group, 1)
            v_cur = _Shift.apply(v_cur, group, 1)
    l = torch.where(l == 0.0, 1.0, l)  # fully-masked rows -> zeros
    out = o / l.transpose(1, 2)[..., None]
    return out.to(q.dtype)


def _merge_partials(out_a, lse_a, out_b, lse_b):
    """Merge two normalised partial-attention results ([B,T,H,D] f32,
    [B,T,H] f32 log-sum-exp); fully-masked partials carry lse=-1e30 and
    drop out via the guards."""
    m = torch.maximum(lse_a, lse_b)
    safe_m = torch.where(m <= NEG_INF / 2, 0.0, m)
    wa = torch.where(lse_a <= NEG_INF / 2, 0.0, torch.exp(lse_a - safe_m))
    wb = torch.where(lse_b <= NEG_INF / 2, 0.0, torch.exp(lse_b - safe_m))
    tot = wa + wb
    tot_safe = torch.where(tot == 0.0, 1.0, tot)
    out = (out_a * wa[..., None] + out_b * wb[..., None]) \
        / tot_safe[..., None]
    lse = torch.where(tot == 0.0, NEG_INF, safe_m + torch.log(tot_safe))
    return out, lse


def _chunk_case(my_idx: int, k_idx: int, causal: bool) -> Optional[bool]:
    """The chunk kernel's ``causal`` for the K/V chunk of rank ``k_idx``
    seen from the Q chunk of rank ``my_idx``: True on the diagonal, False
    for a past chunk (and every chunk without ``causal``), None for a
    future one, which is skipped."""
    if not causal:
        return False
    if k_idx == my_idx:
        return True
    return False if k_idx < my_idx else None


def ring_fwd_step(q, k_cur, v_cur, out, lse, my_idx: int, k_idx: int,
                  causal: bool, scale: float):
    """One forward step of the kernel ring on rank ``my_idx``, holding
    the K/V chunk of rank ``k_idx``: the chunk kernel, then the merge
    into ``(out [B,T,H,D] f32, lse [B,T,H] f32)``, which it returns."""
    case = _chunk_case(my_idx, k_idx, causal)
    if case is None:  # a future chunk adds nothing
        return out, lse
    o_s, lse_s = _flash_chunk_fwd(q, k_cur, v_cur, case, scale)
    return _merge_partials(out, lse, o_s, lse_s)


def ring_bwd_step(q, k_cur, v_cur, out, lse, g, delta, dq, dk, dv,
                  my_idx: int, k_idx: int, causal: bool, scale: float):
    """One backward step of the kernel ring on rank ``my_idx``, holding
    the K/V chunk of rank ``k_idx`` and its f32 dK/dV accumulators: the
    chunk's backward against the global ``lse`` and ``delta`` ([B,T,H]),
    added in place to ``dq``, ``dk`` and ``dv``."""
    case = _chunk_case(my_idx, k_idx, causal)
    if case is None:
        return
    dq_c, dk_c, dv_c = _flash_chunk_bwd(q, k_cur, v_cur, out, lse, g, case,
                                        scale, delta=delta)
    dq.add_(dq_c)
    dk.add_(dk_c)
    dv.add_(dv_c)


def _ring_flash_fwd_pass(q, k, v, group, causal, scale):
    n, me = _size_rank(group)
    batch, tq, heads, dim = q.shape
    out = torch.zeros((batch, tq, heads, dim), device=q.device)
    lse = torch.full((batch, tq, heads), NEG_INF, device=q.device)
    k_cur, v_cur = k, v
    for s in range(n):
        # the next chunk travels while this one's kernel runs; the send
        # only reads k_cur and v_cur
        pending = (ring_shift_start((k_cur, v_cur), group) if s < n - 1
                   else None)
        out, lse = ring_fwd_step(q, k_cur, v_cur, out, lse, me,
                                 (me - s) % n, causal, scale)
        if pending is not None:
            k_cur, v_cur = ring_shift_wait(pending)
    # f32 across the ring; one rounding to the input dtype at the end
    return out.to(q.dtype), lse


def _ring_delta(out, g):
    """``rowsum(g * out)`` in f32, ``[B, T, H]``: loop-invariant, so the
    backward computes it once from the final output."""
    return (g.float() * out.float()).sum(-1)


def _ring_flash_bwd_pass(q, k, v, out, lse, g, group, causal, scale):
    n, me = _size_rank(group)
    delta = _ring_delta(out, g)
    dq = torch.zeros(q.shape, device=q.device)
    dk = torch.zeros(k.shape, device=k.device)
    dv = torch.zeros(v.shape, device=v.device)
    k_cur, v_cur = k, v
    for s in range(n):
        pending = (ring_shift_start((k_cur, v_cur), group) if s < n - 1
                   else None)
        ring_bwd_step(q, k_cur, v_cur, out, lse, g, delta, dq, dk, dv, me,
                      (me - s) % n, causal, scale)
        if pending is not None:
            k_cur, v_cur = ring_shift_wait(pending)
        # the accumulators travel WITH their chunk, after this step's
        # share is on board; after n hops the packet is home with every
        # rank's contribution
        dk, dv = ring_shift_wait(ring_shift_start((dk, dv), group))
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    """The JAX ``_ring_flash`` custom VJP: the forward ring saves q, k,
    v, the output and the global LSE; the backward runs the backward
    ring."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        out, lse = _ring_flash_fwd_pass(q, k, v, group, causal, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        grads = _ring_flash_bwd_pass(q, k, v, out, lse, g.contiguous(),
                                     ctx.group, ctx.causal, ctx.scale)
        return (*grads, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   axis_name: str = "sp", causal: bool = True,
                   scale: Optional[float] = None, mesh=None,
                   impl: str = "auto") -> torch.Tensor:
    """Exact (flash-equivalent) attention over the sequence shards of
    ``axis_name`` of ``mesh`` (a ``DeviceMesh`` from ``build_mesh``).

    ``q``, ``k``, ``v`` are this rank's chunk ``[batch, seq / sp, heads,
    head_dim]``, the chunks in rank order along the axis; the result is
    this rank's chunk of the output.  Without a mesh the chunk is the
    whole sequence.

    ``impl``: "kernel" runs each chunk pair through the flash kernels'
    chunk mode and merges log-sum-exp partials (future chunks skipped;
    the backward is the ring's own); "reference" is the plain
    online-softmax ring (differentiable by autograd); "auto" picks
    "kernel" on CUDA tensors and "reference" on the CPU, as the JAX
    package picks the kernel ring on its accelerator.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "auto":
        impl = "kernel" if q.is_cuda else "reference"
    group = axis_group(mesh, axis_name)
    if impl == "kernel":
        return _RingFlash.apply(q, k, v, group, causal, scale)
    if impl == "reference":
        return _ring_attention_sharded(q, k, v, group, causal, scale)
    raise ValueError(f"impl must be auto|kernel|reference, got {impl!r}")


def simulate_ring(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  g: torch.Tensor, world: int, *, causal: bool = True,
                  scale: Optional[float] = None
                  ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """The kernel ring of ``world`` ranks driven in one process: the
    global ``[B, T, H, D]`` q, k, v and output cotangent ``g`` are cut
    into ``world`` sequence chunks, and every rank's forward and
    backward steps run in the ring's order (at step ``s`` rank ``r``
    holds the chunk of rank ``(r - s) mod world``, with that chunk's
    dK/dV accumulators), exactly as the ranks would run them.  Returns
    ``(out, [dq, dk, dv])``, the chunks joined again."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs, ks, vs, gs = ([c.contiguous() for c in x.chunk(world, dim=1)]
                      for x in (q, k, v, g))
    outs, lses = [], []
    for r in range(world):
        o = torch.zeros(qs[r].shape, device=q.device)
        lse = torch.full(qs[r].shape[:3], NEG_INF, device=q.device)
        for s in range(world):
            c = (r - s) % world
            o, lse = ring_fwd_step(qs[r], ks[c], vs[c], o, lse, r, c,
                                   causal, scale)
        outs.append(o.to(q.dtype))
        lses.append(lse)
    dqs = [torch.zeros(x.shape, device=q.device) for x in qs]
    dks = [torch.zeros(x.shape, device=q.device) for x in ks]
    dvs = [torch.zeros(x.shape, device=q.device) for x in vs]
    deltas = [_ring_delta(o, gr) for o, gr in zip(outs, gs)]
    for s in range(world):
        for r in range(world):
            c = (r - s) % world
            ring_bwd_step(qs[r], ks[c], vs[c], outs[r], lses[r], gs[r],
                          deltas[r], dqs[r], dks[c], dvs[c], r, c, causal,
                          scale)
    return torch.cat(outs, dim=1), [
        torch.cat(x, dim=1).to(q.dtype) for x in (dqs, dks, dvs)]
