"""RMSNorm: the CUDA kernel ``csrc/rmsnorm.cu`` and its plain version.

Counterpart of ``ray_tpu/ops/fused.py`` (``_rmsnorm_ref`` and the Pallas
``_rmsnorm_kernel``).  ``fused_softmax_cross_entropy`` and
``chunked_lm_loss`` belong to training and come with the training slice.
"""

from __future__ import annotations

import torch

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
    """RMSNorm over the last dim of ``x`` with an f32 ``weight``.

    A CPU tensor takes :func:`rmsnorm_reference`; a CUDA tensor launches
    the kernel or raises.  Forward only: gradients come with the
    training slice.
    """
    if x.requires_grad or weight.requires_grad:
        raise NotImplementedError(
            "fused_rmsnorm is forward-only in this port; its backward "
            "comes with the training slice")
    if x.device.type == "cpu":
        return rmsnorm_reference(x, weight, eps)
    if x.device.type != "cuda" or weight.device != x.device:
        raise ValueError(
            f"fused_rmsnorm: x on {x.device} and weight on {weight.device}; "
            "both must be on the same CUDA device")
    if weight.dtype != torch.float32 or weight.shape != (x.shape[-1],):
        raise ValueError(
            f"fused_rmsnorm: weight must be f32 of shape ({x.shape[-1]},), "
            f"got {weight.dtype} {tuple(weight.shape)}")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("fused_rmsnorm: x and weight must be contiguous")
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
