"""flax's ``nn.Conv`` in PyTorch, the convolution ViT's patch embedding
and ResNet share.

flax pads SAME as XLA does: ``ceil(size / stride)`` outputs, the padding
split with the odd element after.  At stride 2 on an even size that is
(0, 1), not torch's symmetric (1, 1) (:func:`same_padding`).  The
convolution casts its input and kernel to the compute dtype and adds an
optional bias in it.  Kernels are f32 masters ``[out, in, kh, kw]``
(flax's ``[kh, kw, in, out]`` permuted), drawn as flax draws them:
LeCun-normal (:func:`lecun_normal_`), zero biases.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

# images are RGB (flax infers the channels from the first batch; the
# JAX ViT's init_params builds 3)
IN_CHANNELS = 3


def same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """flax/XLA SAME padding of one spatial dim: ``ceil(size / stride)``
    outputs, the padding split with the odd element after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(x: torch.Tensor, weight: torch.Tensor, stride: int,
                dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.Conv(padding="SAME", dtype=dtype)`` without bias on an
    ``[B, C, H, W]`` input: input and ``weight [out, in, kh, kw]`` cast
    to ``dtype``, the padding of :func:`same_padding` (given to the
    convolution where it is symmetric, padded first where not)."""
    (top, bottom), (left, right) = (
        same_padding(x.shape[2 + i], weight.shape[2 + i], stride)
        for i in range(2))
    x = x.to(dtype)
    if (top, left) == (bottom, right):
        padding = (top, left)
    else:
        x = F.pad(x, (left, right, top, bottom))
        padding = 0
    return F.conv2d(x, weight.to(dtype), stride=stride, padding=padding)


@torch.no_grad()
def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> None:
    """flax's default kernel init: a normal truncated at two standard
    deviations, scaled to variance ``1 / fan_in``."""
    # the std of a unit normal truncated to [-2, 2]
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std,
                          generator=generator)


class Conv(nn.Module):
    """flax ``nn.Conv`` over an f32 master kernel ``[out, in, kh, kw]``,
    SAME padding, an optional bias added in the compute dtype."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int,
                 stride: int = 1, *, bias: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.stride = stride
        # values come from reset_parameters
        self.weight = nn.Parameter(torch.empty(
            out_channels, in_channels, kernel, kernel, dtype=dtype,
            device=device))
        self.bias = nn.Parameter(torch.zeros(
            out_channels, dtype=dtype, device=device)) if bias else None

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        y = conv2d_same(x, self.weight, self.stride, dtype)
        if self.bias is not None:
            y = y + self.bias.to(dtype)[:, None, None]
        return y

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """flax's defaults: LeCun-normal kernel, zero bias."""
        lecun_normal_(self.weight, self.weight[0].numel(), generator)
        if self.bias is not None:
            self.bias.zero_()
