"""Flash attention: the CUDA kernels ``csrc/flash_fwd.cu`` (forward),
``csrc/flash_bwd.cu`` (dK/dV and dQ) and, above head_dim 128,
``csrc/flash_wide.cu`` (the bf16 forward, dK/dV and dQ up to 256),
``csrc/flash_xwide.cu`` (the bf16 forward from 257 to 1024),
``csrc/flash_xwide_bwd.cu`` (the bf16 dK/dV and dQ from 257 to 1024),
``csrc/flash_fma.cu`` (the f32 forward) and ``csrc/flash_fma_bwd.cu``
(the f32 dK/dV and dQ), behind the JAX package's two kernel families,
each beside its plain version.

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
  same Function); on the card any head_dim from 1 to 1024 (the Pallas
  kernels span the full head_dim, whatever it is).  :func:`_hm_route`
  picks the kernels: a multiple of 8 up to 128 runs on the Hopper
  kernels' 32/64/128 builds (``csrc/flash_common.cuh``'s
  ``by_head_dim``); another size below 128 on the same kernels, its
  inputs zero-padded to the next multiple of 8; with bf16 inputs up to
  256 the forward, dK/dV and dQ on ``csrc/flash_wide.cu``'s 192/256
  builds, from 257 to 512 the forward on ``csrc/flash_xwide.cu``'s
  384/512 builds and from 513 to 1024 on its 768/1024 builds (O's columns
  in two groups across the grid; padded the same way), dK/dV and dQ from
  257 to 1024 on ``csrc/flash_xwide_bwd.cu`` (the outputs' column groups
  as a thread block cluster); with f32 inputs above 128 the forward on
  ``csrc/flash_fma.cu`` and dK/dV and dQ on ``csrc/flash_fma_bwd.cu`` (the
  FMA units, the column groups a cluster; a size that is no multiple of 4
  padded to the next).  The JAX wrappers transpose
  to ``[B, H, T, D]`` for the TPU's tiles; the CUDA kernels read
  ``[B, T, H, D]`` by strides, so both families launch them on the
  caller's tensors and count their launches apart.
* the dispatch between the two, ``_nl_eligible`` and ``_resolve_native``
  (with its ``RAY_TPU_FLASH_NATIVE`` switch), and
  ``_attention_reference``.
* the chunk entry points of ring attention, ``_flash_chunk_fwd`` and
  ``_flash_chunk_bwd``: the same kernels, dispatched the same way, with
  bf16 inputs and f32 outputs (O; dQ, dK, dV), the backward from the
  caller's LSE and delta, each with its own launch counters.

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
HM_BUILT_MAX = 128  # the largest head_dim of flash_fwd.cu / flash_bwd.cu
WIDE_MAX = 256  # the largest of flash_wide.cu (bf16 forward, dK/dV, dQ)
XWIDE_MAX = 512  # the largest of flash_xwide.cu's 384/512 builds
PARTS = ("fwd", "dkdv", "dq")
# the widest head of the head-major family on the card: flash_xwide.cu's
# and flash_xwide_bwd.cu's 1024 builds, flash_fma.cuh's kFmaMaxDim
HM_MAX_HEAD_DIM = 1024


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
                        causal: bool, scale: float,
                        out_dtype: Optional[torch.dtype] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch attention: ``(out [B,Tq,H,D] in out_dtype (q's by
    default), lse [B,H,Tq] f32)``.  Products take f32 operands, as the
    JAX reference's ``preferred_element_type=f32`` does (a bf16 x bf16
    product is exact in f32).  Causal needs ``Tq == Tk``."""
    s = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.float())
    return out.to(out_dtype or q.dtype), lse


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
                                 causal: bool, scale: float,
                                 delta: Optional[torch.Tensor] = None,
                                 grad_dtype: Optional[torch.dtype] = None
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """Plain PyTorch backward, step by step as the kernels compute it:
    ``(dq, dk, dv)`` in ``grad_dtype`` (the input dtype by default) from
    the forward's ``out`` and ``lse [B,H,Tq]`` and the cotangent ``do``;
    ``delta [B,H,Tq]`` where given, else :func:`attention_delta` of
    ``out`` and ``do``.  P is recomputed from the LSE (clamped to 0 where
    a row saw no key), rounded to ``do``'s dtype for dV; dS is rounded to
    the input dtype for dK and dQ; every product takes f32 operands."""
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = _scores(q, k, causal, scale)
    lse = torch.where(lse <= NEG_INF / 2, torch.zeros_like(lse), lse)
    p = torch.exp(s - lse[..., None])
    if delta is None:
        delta = attention_delta(out, do)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype).float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf)
    return tuple(g.to(grad_dtype or x.dtype)
                 for g, x in ((dq, q), (dk, k), (dv, v)))


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


def _check_head_dim(dim: int, hm: bool) -> None:
    """Raise unless the kernels of the family take ``dim``: the
    native-layout ones 64 or 128, the head-major ones 1 to
    ``HM_MAX_HEAD_DIM`` (:func:`_hm_route` says on which kernels).  The
    head-major wrappers hold their limit on every device, CPU tensors
    included."""
    if hm and not 1 <= dim <= HM_MAX_HEAD_DIM:
        raise ValueError(f"head-major flash attention takes head_dim 1 to "
                         f"{HM_MAX_HEAD_DIM}, got {dim}")
    if not hm and dim not in NL_HEAD_DIMS:
        raise ValueError(f"flash kernel takes head_dim one of "
                         f"{NL_HEAD_DIMS}, got {dim}")


def _hm_route(head_dim: int, dtype=torch.bfloat16,
              part: str = "fwd") -> Tuple[str, int]:
    """Where the head-major family runs ``part`` (``"fwd"``, ``"dkdv"``
    or ``"dq"``) at ``head_dim`` for inputs of ``dtype`` on the card:
    ``(kernel selector, width)``.

    * ``"hm"``: up to 128, kernels #5-#7 (their 32/64/128 builds);
    * ``"wide"``: from 129 to 256 with bf16 inputs, the forward, dK/dV
      and dQ of ``csrc/flash_wide.cu`` (192/256 builds);
    * ``"xwide"``: from 257 to 512 with bf16 inputs, the forward of
      ``csrc/flash_xwide.cu`` (384/512 builds); from 257 to 1024 with bf16
      inputs, dK/dV and dQ of ``csrc/flash_xwide_bwd.cu`` (384, 512, 768
      and 1024 builds, the outputs' columns in 192- or 256-wide groups, a
      thread block cluster);
    * ``"xxwide"``: from 513 to 1024 with bf16 inputs, the forward of
      ``csrc/flash_xwide.cu`` (768/1024 builds, O's columns in two groups
      across the grid);
    * ``"fma"``: above 128 with f32 inputs, the forward of
      ``csrc/flash_fma.cu`` and dK/dV and dQ of ``csrc/flash_fma_bwd.cu``
      (the FMA units, the outputs' columns in 64-, 128- or 256-wide
      groups, a thread block cluster).

    The width is ``head_dim`` padded with zero columns to the next
    multiple of 8 up to 128 and, with bf16 inputs, up to 1024 (a padded
    bf16 row then spans a multiple of 16 bytes, the stride TMA takes), or
    to the next multiple of 4 above 128 with f32 inputs (a padded f32 row
    then spans whole 16-byte granules, which the cp.async copies of
    ``flash_fma.cu`` and ``flash_fma_bwd.cu`` take; the alternative,
    4-byte copies, would quarter their loads): q, k, v (and dO)
    zero-padded to it, with the true ``head_dim ** -0.5`` as the scale.
    Zero columns add nothing to ``Q K^T`` or to ``dO V^T``, and the
    outputs' extra columns are sliced off.  The width does not depend on
    the part, so the backward pads once for dK/dV and dQ.  A width runs on
    the next build at or above it, its columns past ``head_dim`` zeros
    inside the kernel.

    Raises above ``HM_MAX_HEAD_DIM``, as :func:`_check_head_dim` does."""
    _check_head_dim(head_dim, hm=True)
    if part not in PARTS:
        raise ValueError(f"part is one of {PARTS}, got {part!r}")
    bf16 = dtype == torch.bfloat16
    align = 8 if bf16 or head_dim <= HM_BUILT_MAX else 4
    width = head_dim + (-head_dim) % align
    if head_dim <= HM_BUILT_MAX:
        return "hm", width
    if bf16 and head_dim <= WIDE_MAX:
        return "wide", width
    if not bf16:
        return "fma", width
    if part != "fwd" or head_dim <= XWIDE_MAX:
        return "xwide", width
    return "xxwide", width


def _kernel_for(q, hm, part="fwd") -> Tuple[str, int]:
    """The kernel selector for ``part`` of ``q``'s family, head_dim and
    dtype, and the head_dim the kernel runs at: ``"nl"`` (#1/#3/#4, as
    it is) or :func:`_hm_route`'s."""
    if not hm:
        return "nl", q.shape[-1]
    return _hm_route(q.shape[-1], q.dtype, part)


def _pad_cols(d, *xs):
    """``xs`` with zero columns up to head_dim ``d`` (contiguous copies;
    ``xs`` themselves where they are ``d`` wide)."""
    return tuple(x if x.shape[-1] == d
                 else torch.nn.functional.pad(x, (0, d - x.shape[-1]))
                 for x in xs)


def _unpad(x, dim):
    return x if x.shape[-1] == dim else x[..., :dim].contiguous()


def _check_kernel_inputs(hm, *tensors):
    """What the CUDA kernels take: one CUDA device, contiguous 16-byte
    aligned tensors, a head_dim of the family (:func:`_check_head_dim`),
    no empty input."""
    q, k = tensors[0], tensors[1]
    if q.device.type != "cuda" or any(x.device != q.device
                                      for x in tensors):
        raise ValueError("flash_attention: inputs on "
                         f"{[str(x.device) for x in tensors]}; need one "
                         "CUDA device")
    _check_head_dim(q.shape[-1], hm)
    if not all(x.is_contiguous() and x.data_ptr() % 16 == 0
               for x in tensors):
        raise ValueError("flash_attention: inputs must be contiguous and "
                         "16-byte aligned")
    if q.numel() == 0 or k.numel() == 0:
        raise ValueError("flash_attention: empty input")


def _entry(kind, part):
    """Kernel ``part`` (``fwd``, ``bwd_dkdv`` or ``bwd_dq``) of ``kind``:
    its library entry and the name its errors carry ("xxwide" is
    flash_xwide.cu's forward above 512, on the same entry as "xwide";
    "xwide"'s backward parts are flash_xwide_bwd.cu's)."""
    name = f"flash_{'' if kind in ('nl', 'hm') else kind + '_'}{part}"
    entry = name.replace("xxwide", "xwide")
    return getattr(_build.load_library(), f"rtt_{entry}"), f"{name} kernel"


def _count(kind, part, chunk=False):
    """One launch of ``part`` ("", "_dkdv" or "_dq") on ``kind``: #1/#3/#4
    on the native-layout wrappers' counters, #5-#7, flash_wide.cu,
    flash_xwide.cu, flash_xwide_bwd.cu, flash_fma.cu and flash_fma_bwd.cu
    on the head-major ones' (``launches``, ``launches_wide*``,
    ``launches_xwide``, ``launches_xwide_*``, ``launches_xxwide``,
    ``launches_fma``, ``launches_fma_*``); with ``chunk`` (f32 outputs
    from bf16 inputs) on :func:`_flash_chunk_fwd`'s and
    :func:`_flash_chunk_bwd`'s (``launches``, ``launches_hm``,
    ``launches_wide``, ``launches_xwide``, ``launches_xxwide``, each with
    the part; flash_fma.cu and flash_fma_bwd.cu take f32 inputs, so they
    have no chunk counter)."""
    if chunk:
        fn = (_flash_chunk_fwd, _flash_chunk_bwd)[bool(part)]
        attr = "launches" + ("" if kind == "nl" else "_" + kind) + part
    else:
        fns = ((flash_attention_fwd, flash_attention_bwd) if kind == "nl"
               else (flash_attention_hm_fwd, flash_attention_hm_bwd))
        fn = fns[bool(part)]
        attr = "launches" + ("" if kind in ("nl", "hm") else "_" + kind) \
            + part
    setattr(fn, attr, getattr(fn, attr) + 1)


def _codes(dtype, out_dtype):
    """The C entry points' (dtype, out_dtype) codes for inputs of
    ``dtype`` and outputs of ``out_dtype`` (None: the inputs')."""
    return (_build.dtype_code(dtype),
            _build.dtype_code(out_dtype or dtype))


def _kernel_fwd(q, k, v, causal, scale, kind, out_dtype=None):
    """The forward kernel ``kind`` (:func:`_kernel_for`) on checked CUDA
    inputs at its width: ``(out like q in out_dtype (q's by default),
    lse [B,H,Tq] f32)``; f32 ``out_dtype`` from bf16 inputs is the chunk
    mode, counted as such."""
    batch, seq_q, heads, dim = q.shape
    out = torch.empty_like(q, dtype=out_dtype or q.dtype)
    lse = torch.empty(batch, heads, seq_q, dtype=torch.float32,
                      device=q.device)
    entry, what = _entry(kind, "fwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr(), batch, seq_q, k.shape[1], heads, dim,
            float(scale), int(causal), *_codes(q.dtype, out_dtype), stream),
            what)
    _count(kind, "", chunk=out.dtype != q.dtype)
    return out, lse


def _launch_fwd(q, k, v, causal, scale, hm=False):
    """The family's forward on checked CUDA inputs, on the kernel
    :func:`_kernel_for` picks: q, k and v padded to its width, O sliced
    back."""
    kind, d = _kernel_for(q, hm)
    out, lse = _kernel_fwd(*_pad_cols(d, q, k, v), causal, scale, kind)
    return _unpad(out, q.shape[-1]), lse


def _forward(q, k, v, causal, scale, hm):
    _build.reject_dtensor("flash_attention forward", q, k, v)
    _validate(q, k, v, causal)
    if hm:
        _check_head_dim(q.shape[-1], hm)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return attention_reference(q, k, v, causal, scale)
    _check_kernel_inputs(hm, q, k, v)
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
    :func:`flash_attention_fwd`, for head_dim 1 to ``HM_MAX_HEAD_DIM`` on
    every device; on the card it launches kernel #5 on the caller's
    ``[B,T,H,D]`` tensors (on zero-padded copies for a head_dim that is
    no multiple of 8) or, above 128, ``flash_wide.cu``'s forward (bf16
    up to 256, counted in ``launches_wide``), ``flash_xwide.cu``'s (bf16
    from 257 to 512, counted in ``launches_xwide``, and from 513 to 1024,
    counted in ``launches_xxwide``) or ``flash_fma.cu``'s (f32, counted in
    ``launches_fma``), as :func:`_hm_route` says, or raises."""
    return _forward(q, k, v, causal, scale, hm=True)


flash_attention_hm_fwd.launches = 0
flash_attention_hm_fwd.launches_wide = 0
flash_attention_hm_fwd.launches_xwide = 0
flash_attention_hm_fwd.launches_xxwide = 0
flash_attention_hm_fwd.launches_fma = 0


def _bwd_inputs(q, k, v, do, lse, delta, causal, scale, hm=False):
    """The arguments of the dK/dV and of the dQ kernel for checked CUDA
    inputs: q, k, v and dO padded once to the width :func:`_kernel_for`
    gives (the same for both parts), each with its part's kernel
    selector.  ``delta`` comes from the unpadded O and dO: on the pad
    route their zero columns would add nothing to it."""
    kind_dkdv, d = _kernel_for(q, hm, "dkdv")
    args = (*_pad_cols(d, q, k, v, do), lse, delta, causal, scale)
    return args + (kind_dkdv,), args + (_kernel_for(q, hm, "dq")[0],)


def _bwd_args(q, k, v, do, lse, delta, causal, scale, out_dtype):
    batch, seq_q, heads, dim = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr()), (
        batch, seq_q, k.shape[1], heads, dim, float(scale), int(causal),
        *_codes(q.dtype, out_dtype))


def _kernel_dkdv(q, k, v, do, lse, delta, causal, scale, kind,
                 out_dtype=None):
    """The dK/dV kernel ``kind`` on :func:`_bwd_inputs`: ``(dk, dv)`` at
    its width, in ``out_dtype`` (the inputs' by default; f32 from bf16 is
    the chunk mode, counted as such)."""
    ins, dims = _bwd_args(q, k, v, do, lse, delta, causal, scale, out_dtype)
    dk = torch.empty_like(k, dtype=out_dtype or k.dtype)
    dv = torch.empty_like(v, dtype=out_dtype or v.dtype)
    entry, what = _entry(kind, "bwd_dkdv")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(entry(*ins, dk.data_ptr(), dv.data_ptr(), *dims, stream),
                     what)
    _count(kind, "_dkdv", chunk=dk.dtype != k.dtype)
    return dk, dv


def _kernel_dq(q, k, v, do, lse, delta, causal, scale, kind,
               out_dtype=None):
    """The dQ kernel ``kind`` on :func:`_bwd_inputs`: ``dq`` at its
    width, in ``out_dtype`` as :func:`_kernel_dkdv`."""
    ins, dims = _bwd_args(q, k, v, do, lse, delta, causal, scale, out_dtype)
    dq = torch.empty_like(q, dtype=out_dtype or q.dtype)
    entry, what = _entry(kind, "bwd_dq")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        _build.check(entry(*ins, dq.data_ptr(), *dims, stream), what)
    _count(kind, "_dq", chunk=dq.dtype != q.dtype)
    return dq


def _launch_bwd(q, k, v, out, lse, do, causal, scale, hm=False):
    """The family's dK/dV and dQ on checked CUDA inputs, each on the
    kernel :func:`_kernel_for` picks for its part (one padding for both):
    ``(dq, dk, dv)``."""
    dkdv_args, dq_args = _bwd_inputs(q, k, v, do, lse,
                                     attention_delta(out, do), causal,
                                     scale, hm)
    dk, dv = _kernel_dkdv(*dkdv_args)
    return tuple(_unpad(g, q.shape[-1])
                 for g in (_kernel_dq(*dq_args), dk, dv))


def _backward(q, k, v, out, lse, do, causal, scale, hm):
    _build.reject_dtensor("flash_attention backward", q, k, v, out, lse, do)
    _validate_bwd(q, k, v, out, lse, do, causal)
    if hm:
        _check_head_dim(q.shape[-1], hm)
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, out, lse, do, causal,
                                            scale)
    _check_kernel_inputs(hm, q, k, v, out, lse, do)
    return _launch_bwd(q, k, v, out, lse, do, causal, scale, hm)


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
    :func:`flash_attention_bwd`, for head_dim 1 to ``HM_MAX_HEAD_DIM``,
    launching kernels #6 (dK/dV) and #7 (dQ), or above 128
    ``flash_wide.cu``'s (bf16 up to 256, counted in
    ``launches_wide_dkdv`` and ``launches_wide_dq``),
    ``flash_xwide_bwd.cu``'s (bf16 from 257 to 1024, counted in
    ``launches_xwide_dkdv`` and ``launches_xwide_dq``) or
    ``flash_fma_bwd.cu``'s (f32, counted in ``launches_fma_dkdv`` and
    ``launches_fma_dq``), each part routed by :func:`_hm_route`, or
    raising."""
    return _backward(q, k, v, out, lse, do, causal, scale, hm=True)


flash_attention_hm_bwd.launches_dkdv = 0
flash_attention_hm_bwd.launches_dq = 0
flash_attention_hm_bwd.launches_wide_dkdv = 0
flash_attention_hm_bwd.launches_wide_dq = 0
flash_attention_hm_bwd.launches_xwide_dkdv = 0
flash_attention_hm_bwd.launches_xwide_dq = 0
flash_attention_hm_bwd.launches_fma_dkdv = 0
flash_attention_hm_bwd.launches_fma_dq = 0


class _FlashAttention(torch.autograd.Function):
    """The ``custom_vjp`` of ``_flash_nl`` or, with ``hm``, of ``_flash``:
    the forward kernel saves q, k, v, out and the LSE; the backward runs
    the two backward kernels.  With a ``bwd_impl`` other than
    ``"pallas"`` (head-major only, as ``_flash_fwd`` / ``_flash_bwd``)
    the forward saves q, k and v alone, and the backward recomputes the
    attention through :func:`attention_reference` under autograd."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, hm, bwd_impl="pallas"):
        fwd = flash_attention_hm_fwd if hm else flash_attention_fwd
        out, lse = fwd(q, k, v, causal=causal, scale=scale)
        if bwd_impl == "pallas":
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.scale, ctx.hm = causal, scale, hm
        ctx.bwd_impl = bwd_impl
        return out

    @staticmethod
    def backward(ctx, do):
        if ctx.bwd_impl != "pallas":
            dq, dk, dv = _recompute_backward(*ctx.saved_tensors, do,
                                             ctx.causal, ctx.scale)
            return dq, dk, dv, None, None, None, None
        bwd = flash_attention_hm_bwd if ctx.hm else flash_attention_bwd
        dq, dk, dv = bwd(*ctx.saved_tensors, do.contiguous(),
                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


def _recompute_backward(q, k, v, do, causal, scale):
    """``_flash_bwd``'s XLA branch: the vjp of the plain attention
    (``_attention_reference``) at q, k and v, on any device."""
    with torch.enable_grad():
        q_, k_, v_ = (x.detach().requires_grad_() for x in (q, k, v))
        out, _ = attention_reference(q_, k_, v_, causal, scale)
        return torch.autograd.grad(out, (q_, k_, v_), do)


def _resolve_native(q, k, v, native: Optional[bool],
                    bwd_impl: str = "pallas") -> bool:
    """The JAX package's ``_resolve_native``: an explicit ``native`` wins;
    otherwise the native-layout family where ``_nl_eligible`` allows it,
    unless ``RAY_TPU_FLASH_NATIVE`` is ``0``, ``false`` or ``off``, which
    forces the head-major family (its A/B switch), or a ``bwd_impl``
    other than ``"pallas"`` asks for the backward only the head-major
    family has."""
    if native is not None:
        return native
    env = os.environ.get("RAY_TPU_FLASH_NATIVE", "").lower()
    return (env not in ("0", "false", "off")
            and bwd_impl == "pallas" and _nl_eligible(q, k, v))


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: Optional[float] = None,
                    bwd_impl: str = "pallas",
                    native: Optional[bool] = None) -> torch.Tensor:
    """Fused attention over ``[batch, seq, heads, head_dim]``; returns the
    output in the input dtype and carries gradients through the backward
    kernels.

    The kernel family is the JAX package's pick (``_resolve_native``):
    ``native=True`` the native-layout kernels (head_dim 64 or 128, the
    head count divisible by ``128 // head_dim``; any other shape raises,
    on the CPU too), ``native=False`` the head-major ones (head_dim 1 to
    ``HM_MAX_HEAD_DIM``; :func:`_hm_route`); ``None`` the native-layout
    ones where eligible unless ``RAY_TPU_FLASH_NATIVE=0``.

    ``bwd_impl`` is the JAX package's A/B switch for the backward, with
    its values and rules: ``"pallas"`` (the default) runs the backward
    kernels; any other value (``"xla"``) keeps the forward kernel but
    saves only q, k and v and computes the gradients by recomputing the
    plain attention under autograd.  Only the head-major family takes
    it: ``native=True`` with another ``bwd_impl`` raises ``ValueError``,
    and ``native=None`` then picks the head-major family.  It is the
    caller's explicit choice, not a fallback, and not the port of a
    kernel: every caller in the port keeps the default.

    DTensors (``parallel.sharding``'s placements: split over the batch
    and the heads, or replicated) run on each rank's local batch rows and
    heads, and the output comes back as a DTensor of the same placement;
    the kernels never see a DTensor.
    """
    if _build.is_dtensor(q, k, v):
        from ray_tpu_torch.parallel._dtensor import on_local_shards
        return on_local_shards(
            lambda q_, k_, v_: flash_attention(q_, k_, v_, causal=causal,
                                               scale=scale,
                                               bwd_impl=bwd_impl,
                                               native=native),
            q, k, v, dims=(0, 2))
    if native and not _nl_eligible(q, k, v):
        raise ValueError(
            f"native-layout flash attention needs head_dim in (64, 128) "
            f"and heads divisible by 128//head_dim; got {tuple(q.shape)}")
    if native and bwd_impl != "pallas":
        raise ValueError(
            "the native-layout kernels have a pallas backward only; "
            "bwd_impl=%r requires native=False" % (bwd_impl,))
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return _FlashAttention.apply(q, k, v, causal, scale,
                                 not _resolve_native(q, k, v, native,
                                                     bwd_impl), bwd_impl)


# ---------------------------------------------------------------------------
# Chunk entry points: ring attention's per-(Q-chunk, KV-chunk) calls.


def _chunk_family(q, k, v):
    """``hm`` for a chunk call: the family ``flash_attention`` would pick
    with no ``native`` (the JAX chunk functions dispatch the same way),
    its head_dim held as that family holds it."""
    hm = not _resolve_native(q, k, v, None)
    if hm:
        _check_head_dim(q.shape[-1], hm)
    return hm


def _flash_chunk_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     causal: bool, scale: float
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward-only chunk attention (the JAX package's
    ``_flash_chunk_fwd``): ``(out, lse)`` with ``out [B,Tq,H,D]`` the f32
    chunk-normalised output and ``lse [B,Tq,H]`` f32 the chunk's
    log-sum-exp, the pair ring attention merges across chunks.  No
    autograd: the ring builds the backward from :func:`_flash_chunk_bwd`.

    CPU tensors take :func:`attention_reference` with f32 out; CUDA
    tensors launch the forward kernel of the family ``flash_attention``
    picks (#1, #5, or above head_dim 128 flash_wide.cu up to 256 and
    flash_xwide.cu beyond) with f32 O (from bf16 inputs, counted in
    ``_flash_chunk_fwd.launches``, ``.launches_hm``, ``.launches_wide``,
    ``.launches_xwide``, ``.launches_xxwide``), or raise; f32 inputs take
    the f32 kernels, counted as the head-major wrappers count them."""
    _build.reject_dtensor("_flash_chunk_fwd", q, k, v)
    _validate(q, k, v, causal)
    hm = _chunk_family(q, k, v)
    if q.device.type == "cpu":
        out, lse = attention_reference(q, k, v, causal, scale,
                                       out_dtype=torch.float32)
    else:
        _check_kernel_inputs(hm, q, k, v)
        kind, d = _kernel_for(q, hm)
        out, lse = _kernel_fwd(*_pad_cols(d, q, k, v), causal, scale, kind,
                               out_dtype=torch.float32)
        out = _unpad(out, q.shape[-1])
    return out, lse.transpose(1, 2).contiguous()


_flash_chunk_fwd.launches = 0
_flash_chunk_fwd.launches_hm = 0
_flash_chunk_fwd.launches_wide = 0
_flash_chunk_fwd.launches_xwide = 0
_flash_chunk_fwd.launches_xxwide = 0


def _flash_chunk_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     out: torch.Tensor, lse: torch.Tensor, g: torch.Tensor,
                     causal: bool, scale: float,
                     delta: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Backward of one (Q-chunk, KV-chunk) pair given the GLOBAL row
    statistics (the JAX package's ``_flash_chunk_bwd``): ``lse [B,Tq,H]``
    is the final merged log-sum-exp, ``out`` and ``g`` the final output
    and its cotangent for the Q chunk, ``delta [B,Tq,H]`` their rowsum
    product (computed from them when absent).  The LSE is never
    recomputed: that is what makes the chunks' gradients sum to the
    global one.  Returns f32 ``(dq, dk, dv)``.

    CPU tensors take :func:`attention_backward_reference` with f32
    gradients; CUDA tensors launch the dK/dV and dQ kernels of the
    family :func:`_flash_chunk_fwd` picks with f32 outputs, each part
    routed by :func:`_hm_route` (counted in
    ``_flash_chunk_bwd.launches_dkdv``, ``.launches_dq`` and their
    ``_hm``, ``_wide`` and ``_xwide`` forms), or raise."""
    _build.reject_dtensor("_flash_chunk_bwd", q, k, v, out, lse, g, delta)
    _validate(q, k, v, causal)
    hm = _chunk_family(q, k, v)
    rows = (q.shape[0], q.shape[1], q.shape[2])
    if out.shape != q.shape or g.shape != q.shape or lse.shape != rows \
            or (delta is not None and delta.shape != rows):
        raise ValueError(
            f"_flash_chunk_bwd: out {tuple(out.shape)}, g "
            f"{tuple(g.shape)}, lse {tuple(lse.shape)}, delta "
            f"{None if delta is None else tuple(delta.shape)} do not fit "
            f"q {tuple(q.shape)}")
    if g.dtype != q.dtype:
        raise TypeError(f"_flash_chunk_bwd: g {g.dtype}, need q's dtype "
                        f"{q.dtype}")
    lse_h = lse.float().transpose(1, 2).contiguous()  # the kernels' [B,H,T]
    delta_h = (attention_delta(out, g) if delta is None
               else delta.float().transpose(1, 2).contiguous())
    if q.device.type == "cpu":
        return attention_backward_reference(q, k, v, out, lse_h, g, causal,
                                            scale, delta=delta_h,
                                            grad_dtype=torch.float32)
    _check_kernel_inputs(hm, q, k, v, g, lse_h, delta_h)
    dkdv_args, dq_args = _bwd_inputs(q, k, v, g, lse_h, delta_h, causal,
                                     scale, hm)
    dk, dv = _kernel_dkdv(*dkdv_args, out_dtype=torch.float32)
    dq = _kernel_dq(*dq_args, out_dtype=torch.float32)
    return tuple(_unpad(x, q.shape[-1]) for x in (dq, dk, dv))


_flash_chunk_bwd.launches_dkdv = 0
_flash_chunk_bwd.launches_dq = 0
_flash_chunk_bwd.launches_hm_dkdv = 0
_flash_chunk_bwd.launches_hm_dq = 0
_flash_chunk_bwd.launches_wide_dkdv = 0
_flash_chunk_bwd.launches_wide_dq = 0
_flash_chunk_bwd.launches_xwide_dkdv = 0
_flash_chunk_bwd.launches_xwide_dq = 0
