"""Small fused ops: RMSNorm (the CUDA kernel ``csrc/rmsnorm.cu`` beside
its plain version) and the softmax cross-entropy of the LM head.

Counterpart of ``ray_tpu/ops/fused.py``: ``_rmsnorm_ref``, the Pallas
``_rmsnorm_kernel`` with its recompute backward, and the plain-jnp
``fused_softmax_cross_entropy`` and ``chunked_lm_loss`` (no kernel in
the JAX package either: XLA fuses them).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops import _build


def rmsnorm_reference(x: torch.Tensor, weight: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """Plain PyTorch RMSNorm: f32 math, output in ``x``'s dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def fused_rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
                  eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm over the last dim of ``x``.

    A CPU tensor takes :func:`rmsnorm_reference`; a CUDA tensor launches
    the kernel or raises.  The kernel reads an f32 weight: one of another
    dtype is cast to f32 first, as the JAX kernel casts it.  Gradients
    recompute through :func:`rmsnorm_reference`, as the JAX package's
    ``_rmsnorm_bwd`` does, so the weight's comes back in its own dtype.
    """
    return _RMSNorm.apply(x, weight, eps)


class _RMSNorm(torch.autograd.Function):
    """The ``custom_vjp`` of ``_rmsnorm``: forward on the kernel, backward
    by autograd through the plain version."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        ctx.save_for_backward(x, weight)
        ctx.eps = eps
        return _rmsnorm_forward(x, weight, eps)

    @staticmethod
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        with torch.enable_grad():
            x_, w_ = (t.detach().requires_grad_() for t in (x, weight))
            y = rmsnorm_reference(x_, w_, ctx.eps)
            dx, dw = torch.autograd.grad(y, (x_, w_), g)
        return dx, dw, None


def _kernel_weight(weight: torch.Tensor, cols: int) -> torch.Tensor:
    """The weight as the kernel reads it: ``cols`` contiguous f32 values
    (``_rmsnorm_kernel`` casts its weight to f32 the same way)."""
    if weight.shape != (cols,):
        raise ValueError(f"fused_rmsnorm: weight must have shape ({cols},), "
                         f"got {tuple(weight.shape)}")
    return weight.float().contiguous()


def _rmsnorm_forward(x: torch.Tensor, weight: torch.Tensor,
                     eps: float) -> torch.Tensor:
    if x.device.type == "cpu":
        return rmsnorm_reference(x, weight, eps)
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(
            f"fused_rmsnorm: x on {x.device} and weight on {weight.device}; "
            "both must be on the same CUDA device")
    weight = _kernel_weight(weight, x.shape[-1])
    if not x.is_contiguous():
        raise ValueError("fused_rmsnorm: x must be contiguous")
    code = _build.dtype_code(x.dtype)
    cols = x.shape[-1]
    rows = x.numel() // cols
    out = torch.empty_like(x)
    if rows == 0:
        return out
    lib = _build.load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.rtt_rmsnorm_fwd(
            x.data_ptr(), weight.data_ptr(), out.data_ptr(), rows, cols,
            eps, code, stream), "rmsnorm kernel")
    fused_rmsnorm.launches += 1
    return out


fused_rmsnorm.launches = 0


def fused_softmax_cross_entropy(logits: torch.Tensor,
                                labels: torch.Tensor) -> torch.Tensor:
    """Per-token cross entropy in f32, the max subtracted without a
    gradient (``stop_gradient``), as the JAX version computes it."""
    logits = logits.float()
    shifted = logits - logits.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    label_logit = shifted.gather(-1, labels.long()[..., None])[..., 0]
    return lse - label_logit


def _chunk_loss(h: torch.Tensor, y: torch.Tensor, m: torch.Tensor,
                emb: torch.Tensor, compute_dtype: Optional[torch.dtype],
                logits_dtype: Optional[torch.dtype]) -> torch.Tensor:
    """Summed masked cross entropy of one ``[chunk, E]`` slice of hidden
    states against the tied embedding ``emb [V, E]`` (f32)."""
    if compute_dtype is not None:
        # bf16 operands, logits in ``logits_dtype or f32`` (the JAX
        # version's preferred_element_type).  A bf16 product in torch
        # rounds its output to bf16; for an f32 output the bf16 operands
        # are upcast, which keeps every product exact and sums in f32
        # (torch.mm's out_dtype has no derivative).
        out = logits_dtype or torch.float32
        logits = h.to(compute_dtype).to(out) @ emb.to(compute_dtype).to(out).T
    else:
        logits = h @ emb.T
    mx = logits.max(dim=-1, keepdim=True).values.detach()
    shifted = (logits - mx).float()
    lse = torch.log(torch.exp(shifted).sum(dim=-1))
    label_logit = shifted.gather(-1, y[:, None])[:, 0]
    return ((lse - label_logit) * m).sum()


def chunked_lm_loss(hidden: torch.Tensor, emb: torch.Tensor,
                    labels: torch.Tensor, *, chunk: int = 8192,
                    compute_dtype: Optional[torch.dtype] = None,
                    logits_dtype: Optional[torch.dtype] = None
                    ) -> torch.Tensor:
    """Mean next-token cross entropy with a chunked LM head.

    ``hidden [B,T,E]`` (f32), ``emb [V,E]`` (the tied embedding),
    ``labels [B,T]``.  Tokens go ``chunk`` at a time, each chunk under
    ``torch.utils.checkpoint`` (the counterpart of ``jax.checkpoint``
    inside ``scan``): its ``[chunk, V]`` logits live only while that
    chunk runs and are recomputed in the backward, so memory never holds
    ``[B*T, V]``.  The tokens are padded to a multiple of ``chunk`` and
    the padded rows masked out of the sum.
    """
    batch, seq, dim = hidden.shape
    flat_h = hidden.reshape(batch * seq, dim).float()
    flat_y = labels.reshape(batch * seq).long()
    n = flat_h.shape[0]
    pad = (-n) % chunk
    if pad:
        flat_h = torch.nn.functional.pad(flat_h, (0, 0, 0, pad))
        flat_y = torch.nn.functional.pad(flat_y, (0, pad))
    mask = (torch.arange(n + pad, device=hidden.device) < n).float()
    emb_f32 = emb.float()
    total = hidden.new_zeros((), dtype=torch.float32)
    for lo in range(0, n + pad, chunk):
        total = total + checkpoint(
            _chunk_loss, flat_h[lo:lo + chunk], flat_y[lo:lo + chunk],
            mask[lo:lo + chunk], emb_f32, compute_dtype, logits_dtype,
            use_reentrant=False)
    return total / n
