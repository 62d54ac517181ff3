"""The model operations that DTensor's sharding propagation has no rule
for, as per-rank code.

Where the JAX package lets GSPMD shard everything, the port's sharded
path (``parallel.sharding``) lets DTensor propagate placements through
the plain torch ops, and does these itself:

* :func:`on_local_shards`: the kernels' wrappers take raw pointers, so
  attention runs on each rank's local batch rows and heads (and, for
  ring attention and Ulysses, its sequence chunk: :func:`on_sequence_chunks`)
  and is rewrapped;
* :func:`embedding`: a lookup in a table split over its rows (the
  ``"vocab"`` axis), each rank looking up the rows it holds and the
  results summed over the vocabulary's ranks (DTensor's own rule for it
  fails when the indices are split over the batch as well);
* :class:`LossParts` (``ops.fused.chunked_lm_loss``): the softmax over
  a vocabulary split over ranks, the max, the sum of exponentials and the
  label's logit each reduced over the vocabulary's ranks.

Cross-rank sums go through ``DTensor.from_local(..., Partial())`` and a
redistribution, whose backward hands every rank the cotangent once, as
the gradient of one global program does.  Uneven row splits (50257 rows
over two ranks) follow ``torch.chunk``, as DTensor's ``Shard`` does: each
rank reads its rows' offset from DTensor's own layout.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset


def _dims_sharding(x: DTensor, dim: int) -> List[int]:
    """The mesh dims over which ``x`` splits its tensor dim ``dim``."""
    return [i for i, p in enumerate(x.placements)
            if isinstance(p, Shard) and p.dim == dim]


def on_local_shards(fn: Callable, *xs: DTensor,
                    dims: Sequence[int] = (0, 2)) -> DTensor:
    """``fn(*locals)`` on each rank's shards of ``xs`` (DTensors of one
    mesh and one placement, each split only over ``dims`` or replicated),
    its result rewrapped with the same placements and the first input's
    global shape.  Differentiable: to_local / from_local carry the
    gradients."""
    first = xs[0]
    if not all(isinstance(x, DTensor) for x in xs):
        raise TypeError("on_local_shards: every input must be a DTensor")
    placements = tuple(first.placements)
    for x in xs:
        if tuple(x.placements) != placements or \
                x.device_mesh != first.device_mesh:
            raise ValueError(f"on_local_shards: inputs placed "
                             f"{[tuple(x.placements) for x in xs]}; they "
                             "must share one placement on one mesh")
    for p in placements:
        if not (isinstance(p, Replicate)
                or (isinstance(p, Shard) and p.dim in dims)):
            raise ValueError(
                f"on_local_shards: placement {p} of {placements}; this "
                f"function runs on shards of dims {tuple(dims)} only")
    out = fn(*(x.to_local() for x in xs)).contiguous()
    return DTensor.from_local(out, first.device_mesh, placements,
                              run_check=False, shape=first.shape,
                              stride=_contiguous(first.shape))


def on_rows(fn: Callable, x, *params, dims: Sequence[int] = (0,)
            ) -> DTensor:
    """``fn(rows, *params)`` on each rank's rows of ``x`` (its split over
    ``dims`` kept, gathered elsewhere) with every parameter whole, the
    result rewrapped split as the rows are: the per-rank path of a
    kernel that reads a whole row (RMSNorm over the last dim) or of an
    op DTensor has no rule for (the ViT's patch convolution).  Where the
    rows are split, each rank's gradient of a parameter is a partial
    sum.  ``fn`` must keep the extent of each dim in ``dims``."""
    mesh = next(t.device_mesh for t in (x, *params)
                if isinstance(t, DTensor))
    x = as_dtensor(x, mesh)
    rows = [p if isinstance(p, Shard) and p.dim in dims else Replicate()
            for p in x.placements]
    x = x.redistribute(mesh, rows)
    grads = [Partial() if isinstance(p, Shard) else Replicate()
             for p in rows]
    whole = [w.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
                 grad_placements=grads) if isinstance(w, DTensor) else w
             for w in params]
    out = fn(x.to_local(), *whole).contiguous()
    shape = list(out.shape)
    for p in rows:
        if isinstance(p, Shard):
            shape[p.dim] = x.shape[p.dim]
    return DTensor.from_local(out, mesh, rows, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous(shape))


def heads_like(x: DTensor, weight: DTensor, heads_dim: int = 2) -> DTensor:
    """``x [B, T, H, D]`` with its heads split over the mesh dims on which
    ``weight``'s output dim (0, the flax kernel's ``"heads"``) is split,
    its other placements kept: under TP_RULES q, k and v reach the
    kernels on each rank's heads.  Where x is replicated over those dims
    this is a local slice, no collective."""
    placements = list(x.placements)
    for i in _dims_sharding(weight, 0):
        placements[i] = Shard(heads_dim)
    return x.redistribute(x.device_mesh, placements)


def _contiguous(shape) -> Tuple[int, ...]:
    stride, out = 1, []
    for n in reversed(shape):
        out.append(stride)
        stride *= n
    return tuple(reversed(out))


def on_sequence_chunks(fn: Callable, q: DTensor, k: DTensor, v: DTensor,
                       axis: str) -> DTensor:
    """Sequence-parallel attention (``fn``: ring attention or Ulysses
    over the mesh axis ``axis``) on each rank's chunk: q, k and v are
    split over the sequence (dim 1) along ``axis`` (a local slice where
    they are whole there), as the JAX ring's ``shard_map`` splits its
    inputs, and the output comes back placed as q came in.

    The sequence is split for attention alone: every dense product
    flattens ``[B, T]``, and DTensor before torch 2.13 (the card's 2.11)
    has no rule to flatten a split ``T``, so the activations stay split
    over the batch only (``embedding`` and ``LossParts`` gather a split
    sequence)."""
    mesh = q.device_mesh
    names = mesh.mesh_dim_names
    placements = [Replicate() if isinstance(p, Shard) and p.dim == 1
                  else p for p in q.placements]
    if axis in names:
        placements[names.index(axis)] = Shard(1)
    back = q.placements
    q, k, v = (x.redistribute(mesh, placements) for x in (q, k, v))
    out = on_local_shards(fn, q, k, v, dims=(0, 1, 2))
    return out.redistribute(mesh, back)


def _offset(x: DTensor, placements, dim: int) -> int:
    return compute_local_shape_and_global_offset(
        x.shape, x.device_mesh, placements)[1][dim]


def as_dtensor(x, mesh) -> DTensor:
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _rows_split(table: DTensor) -> Tuple[List[int], list]:
    """The mesh dims over which ``table [V, E]`` splits its rows, and
    the placements that keep that split and gather the rest."""
    vocab = _dims_sharding(table, 0)
    return vocab, [Shard(0) if i in vocab else Replicate()
                   for i in range(table.device_mesh.ndim)]


def _local_rows(x: DTensor, vocab: List[int]) -> Tuple[torch.Tensor, list]:
    """``x``'s local rows: split over the batch (dim 0) as it was, whole
    over ``vocab``'s mesh dims and in its other dims (a split sequence
    is gathered: :func:`on_sequence_chunks` says why); and their
    placements.  Each rank of a ``vocab`` dim meets them with its own
    rows of the table, so their gradient is a partial sum there."""
    placements = [p if (isinstance(p, Shard) and p.dim == 0
                        and i not in vocab) else Replicate()
                  for i, p in enumerate(x.placements)]
    grads = [Partial() if i in vocab else p
             for i, p in enumerate(placements)]
    return x.redistribute(x.device_mesh, placements).to_local(
        grad_placements=grads), placements


def _local_table(table: DTensor, vocab: List[int], tplace: list,
                 rows_place: list) -> torch.Tensor:
    """``table``'s rows on this rank (``tplace``: split over ``vocab``,
    whole elsewhere), looked up by rows placed ``rows_place``: where
    those are split over the batch, each rank's gradient of the table is
    a partial sum."""
    grads = [Shard(0) if i in vocab else
             (Partial() if isinstance(p, Shard) else Replicate())
             for i, p in enumerate(rows_place)]
    return table.redistribute(table.device_mesh, tplace).to_local(
        grad_placements=grads)


def embedding(tokens, table: DTensor) -> DTensor:
    """``F.embedding(tokens, table)`` for a DTensor table: the table's
    other dims gathered, its row split kept; each rank looks up the rows
    it holds (zeros for the others) and the result is a partial sum over
    the row split's mesh dims, split over the batch as ``tokens`` is."""
    mesh = table.device_mesh
    tokens = as_dtensor(tokens, mesh)
    vocab, tplace = _rows_split(table)
    local_tok, tok_place = _local_rows(tokens, vocab)
    local_table = _local_table(table, vocab, tplace, tok_place)
    lo = _offset(table, tplace, 0)
    inside = (local_tok >= lo) & (local_tok < lo + local_table.shape[0])
    rows = F.embedding(torch.where(inside, local_tok - lo, 0), local_table)
    rows = rows * inside[..., None].to(rows.dtype)
    out_place = [Partial() if i in vocab else p
                 for i, p in enumerate(tok_place)]
    shape = (*tokens.shape, table.shape[1])
    return DTensor.from_local(rows, mesh, out_place, run_check=False,
                              shape=shape, stride=_contiguous(shape))


class LossParts:
    """What :func:`ops.fused.chunked_lm_loss` needs of DTensor inputs:
    each rank's rows of hidden states and labels (split over the batch as
    the hidden states are, whole elsewhere), its rows of the table, and
    the reductions over the table's row split."""

    def __init__(self, hidden: DTensor, emb: DTensor, labels):
        mesh = self.mesh = emb.device_mesh
        hidden = as_dtensor(hidden, mesh)
        self.vocab, tplace = _rows_split(emb)
        self.lo = _offset(emb, tplace, 0)
        self.hidden, self.place = _local_rows(hidden, self.vocab)
        self.emb = _local_table(emb, self.vocab, tplace, self.place)
        self.labels = as_dtensor(labels, mesh).redistribute(
            mesh, self.place).to_local()
        self.count = hidden.shape[0] * hidden.shape[1]
        groups = [mesh.get_group(i) for i in self.vocab]
        self.vocab_groups = [g for g in groups if dist.get_world_size(g) > 1]

    def max(self, x: torch.Tensor) -> torch.Tensor:
        """The row max over the whole vocabulary (no gradient)."""
        x = x.detach().clone()
        for g in self.vocab_groups:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)
        return x

    def vocab_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the vocabulary's ranks (differentiable)."""
        if not self.vocab:
            return x
        place = [Partial() if i in self.vocab else Replicate()
                 for i in range(self.mesh.ndim)]
        return DTensor.from_local(x, self.mesh, place, run_check=False) \
            .redistribute(self.mesh, [Replicate()] * self.mesh.ndim) \
            .to_local()

    def label_logit(self, logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
        """Each row's logit at its label, from the rank holding it."""
        inside = (labels >= self.lo) & \
            (labels < self.lo + logits.shape[-1])
        got = logits.gather(-1, torch.where(inside, labels - self.lo,
                                            0)[:, None])[:, 0]
        return self.vocab_sum(got * inside.to(got.dtype))

    def total(self, local_sum: torch.Tensor) -> torch.Tensor:
        """The global sum of every rank's ``local_sum`` (its batch rows'),
        as a plain tensor on every rank."""
        place = [Partial() if isinstance(p, Shard) else Replicate()
                 for p in self.place]
        return DTensor.from_local(local_sum, self.mesh, place,
                                  run_check=False).full_tensor()


