"""Flash attention: the CUDA kernels ``csrc/flash_fwd.cu`` (forward) and
``csrc/flash_bwd.cu`` (dK/dV and dQ), behind the JAX package's two kernel
families, each beside its plain version.

Counterpart of ``ray_tpu/ops/flash_attention.py``:

* the native-layout ("NL") family: the forward ``_fa_nl_kernel``, the
  backward ``_flash_nl_backward`` with ``_fa_nl_bwd_dkdv_kernel`` and
  ``_fa_nl_bwd_dq_kernel``, and their ``custom_vjp`` ``_flash_nl`` (here
  :func:`flash_attention_fwd`, :func:`flash_attention_bwd` and a
  ``torch.autograd.Function``); head_dim 64 or 128.
* the head-major ("HM") family: ``_flash_forward`` with ``_fa_kernel``,
  ``_flash_backward`` with ``_fa_bwd_dkdv_kernel`` and
  ``_fa_bwd_dq_kernel``, and ``_flash`` (here
  :func:`flash_attention_hm_fwd`, :func:`flash_attention_hm_bwd` and the
  same Function); head_dim 32, 64 or 128.  The JAX wrappers transpose
  to ``[B, H, T, D]`` for the TPU's tiles; the CUDA kernels read
  ``[B, T, H, D]`` by strides, so both families launch them on the
  caller's tensors and count their launches apart.
* the dispatch between the two, ``_nl_eligible`` and ``_resolve_native``
  (with its ``RAY_TPU_FLASH_NATIVE`` switch), and
  ``_attention_reference``.

Every public function takes and returns ``[batch, seq, heads,
head_dim]``, as in the JAX package.

The causal mask is aligned top-left (key ``k`` visible to query ``q`` iff
``k <= q``), as every TPU kernel aligns it.  ``_attention_reference``
aligns it bottom-right; the two agree only when ``Tq == Tk``, so causal
calls with other lengths raise here, in the kernels' wrappers and in the
plain versions alike, instead of picking one.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops import _build

NEG_INF = -1e30
NL_HEAD_DIMS = (64, 128)  # the JAX package's _nl_eligible
HM_HEAD_DIMS = (32, 64, 128)


def _check_causal(q, k, causal):
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(
            f"causal flash_attention needs Tq == Tk (top-left alignment); "
            f"got Tq={q.shape[1]}, Tk={k.shape[1]}")


def _scores(q, k, causal, scale):
    """f32 scores ``[B,H,Tq,Tk]``, masked top-left when causal."""
    _check_causal(q, k, causal)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        tq, tk = q.shape[1], k.shape[1]
        keep = torch.ones(tq, tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention: ``(out [B,Tq,H,D] in q's dtype,
    lse [B,H,Tq] f32)``.  Products take f32 operands, as the JAX
    reference's ``preferred_element_type=f32`` does (a bf16 x bf16
    product is exact in f32).  Causal needs ``Tq == Tk``."""
    s = _scores(q, k, causal, scale)
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


def attention_backward_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, out: torch.Tensor,
                                 lse: torch.Tensor, do: torch.Tensor,
                                 causal: bool, scale: float
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Plain PyTorch backward, step by step as the kernels compute it:
    ``(dq, dk, dv)`` in the input dtype from the forward's ``out`` and
    ``lse [B,H,Tq]`` and the cotangent ``do``.  P is recomputed from the
    LSE (clamped to 0 where a row saw no key), rounded to ``do``'s dtype
    for dV; dS is rounded to the input dtype for dK and dQ; every product
    takes f32 operands."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = _scores(q, k, causal, scale)
    lse = torch.where(lse <= NEG_INF / 2, torch.zeros_like(lse), lse)
    p = torch.exp(s - lse[..., None])
    delta = attention_delta(out, do)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in f32, ``[B, H, T]`` like the LSE."""
    return (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()


def _nl_eligible(q, k, v) -> bool:
    """The native-layout kernels take head_dim 64 or 128 with the head
    count a multiple of the TPU's per-slab packing factor (the JAX
    package's rule, kept so that both packages pick the same family)."""
    dim = q.shape[-1]
    if dim not in NL_HEAD_DIMS:
        return False
    pack = 128 // dim
    return q.shape[2] % pack == 0 and k.shape[2] % pack == 0


def _validate(q, k, v, causal):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("flash_attention takes [batch, seq, heads, "
                         "head_dim] tensors")
    if k.shape != v.shape or q.shape[0] != k.shape[0] \
            or q.shape[2:] != k.shape[2:]:
        raise ValueError(
            f"flash_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} must share batch, heads and head_dim")
    _check_causal(q, k, causal)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"flash_attention: mixed dtypes {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")


def _validate_bwd(q, k, v, out, lse, do, causal):
    _validate(q, k, v, causal)
    if out.shape != q.shape or do.shape != q.shape \
            or lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(
            f"flash attention backward: out {tuple(out.shape)}, do "
            f"{tuple(do.shape)}, lse {tuple(lse.shape)} do not fit q "
            f"{tuple(q.shape)}")
    if out.dtype != q.dtype or do.dtype != q.dtype \
            or lse.dtype != torch.float32:
        raise TypeError(f"flash attention backward: out {out.dtype}, do "
                        f"{do.dtype}, lse {lse.dtype} (need q's dtype "
                        f"{q.dtype} and f32)")


def _check_kernel_inputs(head_dims, *tensors):
    """What the CUDA kernels take: one CUDA device, contiguous 16-byte
    aligned tensors, a head_dim in ``head_dims``, no empty input."""
    q, k = tensors[0], tensors[1]
    if q.device.type != "cuda" or any(x.device != q.device
                                      for x in tensors):
        raise ValueError("flash_attention: inputs on "
                         f"{[str(x.device) for x in tensors]}; need one "
                         "CUDA device")
    dim = q.shape[-1]
    if dim not in head_dims:
        raise ValueError(f"flash kernel takes head_dim in {head_dims}, "
                         f"got {dim}")
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0
               for x in tensors):
        raise ValueError("flash_attention: inputs must be contiguous and "
                         "16-byte aligned")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError("flash_attention: empty input")


def _launch_fwd(q, k, v, causal, scale, hm=False):
    """The forward kernel on checked CUDA inputs, counted as #1 (native
    layout) or, with ``hm``, #5 (head-major): ``(out like q, lse
    [B,H,Tq] f32)``."""
    batch, seq_q, heads, dim = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(batch, heads, seq_q, dtype=torch.float32,
                      device=q.device)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.rtt_flash_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), batch, seq_q, k.shape[1], heads, dim,
            float(scale), int(causal), _build.dtype_code(q.dtype), stream),
            "flash_fwd kernel")
    (flash_attention_hm_fwd if hm else flash_attention_fwd).launches += 1
    return out, lse


def _forward(q, k, v, causal, scale, hm):
    _validate(q, k, v, causal)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal, scale)
    _check_kernel_inputs(HM_HEAD_DIMS if hm else NL_HEAD_DIMS, q, k, v)
    return _launch_fwd(q, k, v, causal, scale, hm)


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        scale: Optional[float] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Native-layout family (``_flash_nl_forward``): ``(out [B,Tq,H,D] in
    the input dtype, lse [B,H,Tq] f32)``.

    CPU tensors take :func:`attention_reference`; CUDA tensors launch
    kernel #1 (head_dim 64 or 128, f32 or bf16, contiguous) or raise.
    """
    return _forward(q, k, v, causal, scale, hm=False)


flash_attention_fwd.launches = 0


def flash_attention_hm_fwd(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, causal: bool = True,
                           scale: Optional[float] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head-major family (``_flash_forward``): as
    :func:`flash_attention_fwd`, launching kernel #5 (head_dim 32, 64 or
    128) on the caller's ``[B,T,H,D]`` tensors, or raising."""
    return _forward(q, k, v, causal, scale, hm=True)


flash_attention_hm_fwd.launches = 0


def _bwd_args(q, k, v, do, lse, delta, causal, scale):
    batch, seq_q, heads, dim = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr()), (
        batch, seq_q, k.shape[1], heads, dim, float(scale), int(causal),
        _build.dtype_code(q.dtype))


def _launch_dkdv(q, k, v, do, lse, delta, causal, scale, hm=False):
    """The dK/dV kernel on checked CUDA inputs, counted as #3 (native
    layout) or, with ``hm``, #6 (head-major): ``(dk, dv)``."""
    ins, dims = _bwd_args(q, k, v, do, lse, delta, causal, scale)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.rtt_flash_bwd_dkdv(*ins, dk.data_ptr(),
                                            dv.data_ptr(), *dims, stream),
                     "flash_bwd_dkdv kernel")
    (flash_attention_hm_bwd if hm else flash_attention_bwd).launches_dkdv += 1
    return dk, dv


def _launch_dq(q, k, v, do, lse, delta, causal, scale, hm=False):
    """The dQ kernel on checked CUDA inputs, counted as #4 (native layout)
    or, with ``hm``, #7 (head-major): ``dq``."""
    ins, dims = _bwd_args(q, k, v, do, lse, delta, causal, scale)
    dq = torch.empty_like(q)
    lib = _build.load_library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(lib.rtt_flash_bwd_dq(*ins, dq.data_ptr(), *dims, stream),
                     "flash_bwd_dq kernel")
    (flash_attention_hm_bwd if hm else flash_attention_bwd).launches_dq += 1
    return dq


def _backward(q, k, v, out, lse, do, causal, scale, hm):
    _validate_bwd(q, k, v, out, lse, do, causal)
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, out, lse, do, causal,
                                            scale)
    _check_kernel_inputs(HM_HEAD_DIMS if hm else NL_HEAD_DIMS,
                         q, k, v, out, lse, do)
    delta = attention_delta(out, do)
    dk, dv = _launch_dkdv(q, k, v, do, lse, delta, causal, scale, hm)
    return _launch_dq(q, k, v, do, lse, delta, causal, scale, hm), dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        do: torch.Tensor, *, causal: bool, scale: float
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Native-layout family (``_flash_nl_backward``): ``(dq, dk, dv)`` in
    the input dtype, from the forward's ``out`` and ``lse [B,H,Tq]`` and
    the cotangent ``do`` (like ``out``).

    CPU tensors take :func:`attention_backward_reference`; CUDA tensors
    compute ``delta`` with plain torch (as the JAX package computes it
    outside its kernels), then launch kernels #3 (dK/dV) and #4 (dQ), or
    raise.
    """
    return _backward(q, k, v, out, lse, do, causal, scale, hm=False)


flash_attention_bwd.launches_dkdv = 0
flash_attention_bwd.launches_dq = 0


def flash_attention_hm_bwd(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, out: torch.Tensor,
                           lse: torch.Tensor, do: torch.Tensor, *,
                           causal: bool, scale: float
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Head-major family (``_flash_backward``): as
    :func:`flash_attention_bwd`, launching kernels #6 (dK/dV) and #7
    (dQ) (head_dim 32, 64 or 128), or raising."""
    return _backward(q, k, v, out, lse, do, causal, scale, hm=True)


flash_attention_hm_bwd.launches_dkdv = 0
flash_attention_hm_bwd.launches_dq = 0


class _FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of ``_flash_nl`` or, with ``hm``, of ``_flash``:
    the forward kernel saves q, k, v, out and the LSE; the backward runs
    the two backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, hm):
        fwd = flash_attention_hm_fwd if hm else flash_attention_fwd
        out, lse = fwd(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.hm = causal, scale, hm
        return out

    @staticmethod
    def backward(ctx, do):
        bwd = flash_attention_hm_bwd if ctx.hm else flash_attention_bwd
        dq, dk, dv = bwd(*ctx.saved_tensors, do.contiguous(),
                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None


def _resolve_native(q, k, v, native: Optional[bool]) -> bool:
    """The JAX package's ``_resolve_native``: an explicit ``native`` wins;
    otherwise the native-layout family where ``_nl_eligible`` allows it,
    unless ``RAY_TPU_FLASH_NATIVE`` is ``0``, ``false`` or ``off``, which
    forces the head-major family (its A/B switch).  The port has no XLA
    backward, so ``bwd_impl`` does not enter."""
    if native is not None:
        return native
    env = os.environ.get("RAY_TPU_FLASH_NATIVE", "").lower()
    return env not in ("0", "false", "off") and _nl_eligible(q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    native: Optional[bool] = None) -> torch.Tensor:
    """Fused attention over ``[batch, seq, heads, head_dim]``; returns the
    output in the input dtype and carries gradients through the backward
    kernels.

    The kernel family is the JAX package's pick (``_resolve_native``):
    ``native=True`` the native-layout kernels (head_dim 64 or 128, the
    head count divisible by ``128 // head_dim``; any other shape raises,
    on the CPU too), ``native=False`` the head-major ones (head_dim 32, 64
    or 128 on the card); ``None`` the native-layout ones where eligible
    unless ``RAY_TPU_FLASH_NATIVE=0``.
    """
    if native and not _nl_eligible(q, k, v):
        raise ValueError(
            f"native-layout flash attention needs head_dim in (64, 128) "
            f"and heads divisible by 128//head_dim; got {tuple(q.shape)}")
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, scale,
                                 not _resolve_native(q, k, v, native))
