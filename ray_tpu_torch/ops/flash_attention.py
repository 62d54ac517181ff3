"""Flash attention forward: the CUDA kernel ``csrc/flash_fwd.cu`` and its
plain version.

Counterpart of ``ray_tpu/ops/flash_attention.py`` (the native-layout
forward ``_fa_nl_kernel`` and ``_attention_reference``).  Shapes are
``[batch, seq, heads, head_dim]`` in and out, as in the JAX package.

The causal mask is aligned top-left (key ``k`` visible to query ``q`` iff
``k <= q``), as every TPU kernel aligns it.  ``_attention_reference``
aligns it bottom-right; the two agree only when ``Tq == Tk``, so causal
calls with other lengths raise here instead of picking one.

Forward only: the backward kernels come with the training slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (64, 128)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention: ``(out [B,Tq,H,D] in q's dtype,
    lse [B,H,Tq] f32)``.  Products take f32 operands, as the JAX
    reference's ``preferred_element_type=f32`` does (a bf16 x bf16
    product is exact in f32)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(q.dtype), lse


def fit_block(seq: int, block: int) -> int:
    """Largest divisor of ``seq`` that is <= ``block``."""
    for d in range(min(block, seq), 0, -1):
        if seq % d == 0:
            return d
    return 1


def kernel_block_for(seq: int, block: int = 1024):
    """Fitted block size when ``seq`` divides into sublane-aligned tiles
    big enough for the flash kernels to pay off, else ``None`` — the
    eligibility test the sequence-parallel layer gates on."""
    fit = fit_block(seq, block)
    return fit if fit >= 128 and fit % 8 == 0 else None


def _validate(q, k, v, causal):
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise NotImplementedError(
            "flash_attention is forward-only in this port; the backward "
            "kernels come with the training slice")
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes [batch, seq, heads, "
                         "head_dim] tensors")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2:] != k.shape[2:]:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} must share batch, heads and head_dim")
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"causal flash_attention needs Tq == Tk (top-left alignment); "
            f"got Tq={q.shape[1]}, Tk={k.shape[1]}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: mixed dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(out [B,Tq,H,D] in the input dtype, lse [B,H,Tq] f32)``.

    CPU tensors take :func:`attention_reference`; CUDA tensors launch the
    kernel (head_dim 64 or 128, f32 or bf16, contiguous) or raise.
    """
    _validate(q, k, v, causal)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal, scale)
    if q.device.type != "cuda" or k.device != q.device \
            or v.device != q.device:
        raise ValueError(f"flash_attention: q, k, v on {q.device}, "
                         f"{k.device}, {v.device}; need one CUDA device")
    batch, seq_q, heads, dim = q.shape
    seq_k = k.shape[1]
    if dim not in HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {dim}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention: q, k, v must be contiguous")
    if batch * heads > 65535:
        raise ValueError(f"flash kernel grid: batch*heads={batch * heads} "
                         "exceeds 65535")
    if q.numel() == 0 or seq_k == 0:
        raise ValueError("flash_attention: empty input")
    code = _build.dtype_code(q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty(batch, heads, seq_q, dtype=torch.float32,
                      device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.rtt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), batch, seq_q, seq_k, heads, dim, float(scale),
            int(causal), code, stream), "flash_fwd kernel")
    flash_attention_fwd.launches += 1
    return out, lse


flash_attention_fwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Fused attention over ``[batch, seq, heads, head_dim]``; returns the
    output in the input dtype (see :func:`flash_attention_fwd`)."""
    return flash_attention_fwd(q, k, v, causal=causal, scale=scale)[0]

