"""ResNet (ResNet-18 for CIFAR-10 and its presets) in PyTorch.

Counterpart of ``ray_tpu/models/resnet.py``, ``BASELINE.json``'s
"ResNet-18 CIFAR-10": a 3x3 stem without pooling, stages of
:class:`BasicBlock`, global average pooling and one Dense.  Same
configuration fields and presets; the parameter names map from flax's
automatic ones (``stem``, ``BatchNorm_0``, ``BasicBlock_{i}/Conv_{j}``,
``Dense_0``) through ``ray_tpu_torch.models.convert``.  No Pallas kernel
runs in the JAX model: the convolutions are cuDNN here, as the JAX
package leaves them to XLA.

Images come in NHWC ``[B, H, W, C]``, as in the JAX model; inside, each
activation is an ``[B, C, H, W]`` view of channels-last memory (the
permuted input), the layout cuDNN's NHWC convolutions take.

Numerics follow the flax model:

* a convolution casts its input and kernel to ``cfg.dtype`` and pads
  SAME as flax does: at stride 2 on an even size that is (0, 1), not
  torch's symmetric (1, 1) (``ray_tpu_torch.models.conv``);
* BatchNorm runs in f32 and emits f32 (``dtype=jnp.float32``): in
  training, the batch's mean and its *biased* variance as
  ``E[x^2] - E[x]^2`` clipped at 0 (flax's fast variance), and the
  running averages move as ``0.9 * running + 0.1 * batch`` with that
  biased variance (``torch.nn.BatchNorm2d`` would store the unbiased
  one); in evaluation, the running averages; eps 1e-5;
* so the activations between convolutions are f32 and each convolution
  takes them cast to ``cfg.dtype``; the pooled features and the head are
  f32.

f32 convolutions on the card run in TF32 unless
``torch.backends.cudnn.allow_tf32`` is False (PyTorch's default is True);
this module leaves the flag as it is.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.distributed.nn.functional import all_reduce

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.conv import IN_CHANNELS, Conv, lecun_normal_
from ray_tpu_torch.models.gpt2 import Dense
from ray_tpu_torch.parallel.mesh import get_global_mesh

BN_MOMENTUM = 0.9  # flax's: running = momentum * running + (1 - m) * batch
BN_EPS = 1e-5


@dataclasses.dataclass(frozen=True)
class ResNetConfig:
    stage_sizes: Tuple[int, ...] = (2, 2, 2, 2)  # resnet-18
    num_classes: int = 10
    num_filters: int = 64
    dtype: torch.dtype = torch.bfloat16

    @classmethod
    def resnet18(cls, num_classes: int = 10, **kw) -> "ResNetConfig":
        return cls(stage_sizes=(2, 2, 2, 2), num_classes=num_classes, **kw)

    @classmethod
    def resnet50(cls, num_classes: int = 1000, **kw) -> "ResNetConfig":
        return cls(stage_sizes=(3, 4, 6, 3), num_classes=num_classes, **kw)


def _axis_group(axis_name: str):
    """The process group of the global mesh's axis ``axis_name`` (one
    rank's group too: its all-reduce then runs, and is the identity)."""
    mesh = get_global_mesh()
    if mesh is None or axis_name not in (mesh.mesh_dim_names or ()):
        raise ValueError(
            f"cross-replica BatchNorm over {axis_name!r} needs a global "
            "mesh with that axis (parallel.use_mesh(build_mesh(...)))")
    return mesh.get_group(axis_name)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, dtype=jnp.float32)`` over the
    channels of ``[B, C, H, W]``: f32 statistics and output, running
    averages of the mean and the biased variance (buffers, updated in
    place by a training-mode call).

    With ``axis_name`` (flax's cross-replica statistics), training takes
    the mean and the mean of squares over every rank of that axis of the
    global mesh: each rank's two are averaged by one all-reduce, as
    flax's ``lax.pmean`` of both does, and the variance and the running
    averages come from the averaged values.  The all-reduce is
    differentiable (its backward sums the cotangents over the axis, as
    ``psum``'s transpose does)."""

    def __init__(self, channels: int, *, device=None,
                 axis_name: Optional[str] = None):
        super().__init__()
        self.axis_name = axis_name
        self.weight = nn.Parameter(torch.ones(channels, device=device))
        self.bias = nn.Parameter(torch.zeros(channels, device=device))
        self.register_buffer("running_mean",
                             torch.zeros(channels, device=device))
        self.register_buffer("running_var",
                             torch.ones(channels, device=device))

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        x = x.float()
        if train:
            mean, mean2 = x.mean((0, 2, 3)), x.square().mean((0, 2, 3))
            if self.axis_name is not None:
                group = _axis_group(self.axis_name)
                stats = all_reduce(torch.stack([mean, mean2]), group=group)
                mean, mean2 = stats / dist.get_world_size(group)
            var = (mean2 - mean.square()).clamp_min(0)
            with torch.no_grad():
                self.running_mean.mul_(BN_MOMENTUM).add_(
                    mean, alpha=1 - BN_MOMENTUM)
                self.running_var.mul_(BN_MOMENTUM).add_(
                    var, alpha=1 - BN_MOMENTUM)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + BN_EPS) * self.weight
        return (x - mean[:, None, None]) * mul[:, None, None] + \
            self.bias[:, None, None]


class BasicBlock(nn.Module):
    """Two 3x3 convolutions, the first with ``strides``, each followed by
    BatchNorm (the second zero-initialised, so a new block passes its
    input through), and a 1x1 projection of the input with its own
    BatchNorm where the shape changes."""

    def __init__(self, in_channels: int, filters: int, strides: int,
                 dtype: torch.dtype, *, device=None,
                 axis_name: Optional[str] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv(in_channels, filters, 3, strides, device=device)
        self.bn1 = BatchNorm(filters, device=device, axis_name=axis_name)
        self.conv2 = Conv(filters, filters, 3, device=device)
        self.bn2 = BatchNorm(filters, device=device, axis_name=axis_name)
        self.proj = self.proj_bn = None
        if strides != 1 or in_channels != filters:
            self.proj = Conv(in_channels, filters, 1, strides, device=device)
            self.proj_bn = BatchNorm(filters, device=device,
                                     axis_name=axis_name)

    def forward(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x, self.dtype), train))
        y = self.bn2(self.conv2(y, self.dtype), train)
        if self.proj is not None:
            x = self.proj_bn(self.proj(x, self.dtype), train)
        return F.relu(x + y)


class ResNet(nn.Module):
    """``forward(images [B, H, W, C], train=True)`` returns f32 logits
    ``[B, num_classes]``; with ``train`` BatchNorm uses the batch's
    statistics and updates its running ones, without it the running
    ones.

    Parameters are f32 on ``device`` (CUDA unless ``device="cpu"``),
    drawn as flax draws them — LeCun-normal kernels, zero biases, ones
    for BatchNorm scales but zeros for each block's last — from
    ``generator`` (a fresh one seeded 0 on that device when omitted).
    With ``axis_name`` (a data-parallel axis of the global mesh, set by
    ``parallel.use_mesh``), every BatchNorm takes its training statistics
    over the axis's ranks, each rank passing its own images
    (:class:`BatchNorm`); the parameters name no logical axes and stay
    replicated, as in the JAX package.
    """

    def __init__(self, config: ResNetConfig, *, device=None,
                 generator: Optional[torch.Generator] = None,
                 axis_name: Optional[str] = None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config
        self.axis_name = axis_name
        self.stem = Conv(IN_CHANNELS, cfg.num_filters, 3, device=device)
        self.stem_bn = BatchNorm(cfg.num_filters, device=device,
                                 axis_name=axis_name)
        blocks, channels = [], cfg.num_filters
        for stage, size in enumerate(cfg.stage_sizes):
            for block in range(size):
                filters = cfg.num_filters * 2 ** stage
                strides = 2 if stage > 0 and block == 0 else 1
                blocks.append(BasicBlock(channels, filters, strides,
                                         cfg.dtype, device=device,
                                         axis_name=axis_name))
                channels = filters
        self.blocks = nn.ModuleList(blocks)
        self.head = Dense(channels, cfg.num_classes, dtype=torch.float32,
                          device=device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for module in self.modules():
            if isinstance(module, Conv):
                module.reset_parameters(generator)
            elif isinstance(module, BatchNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
                module.running_mean.zero_()
                module.running_var.fill_(1.0)
        for block in self.blocks:
            block.bn2.weight.zero_()
        lecun_normal_(self.head.weight, self.head.weight.shape[1], generator)
        self.head.bias.zero_()

    def forward(self, images: torch.Tensor,
                train: bool = True) -> torch.Tensor:
        dt = self.config.dtype
        x = self.stem(images.permute(0, 3, 1, 2), dt)
        x = F.relu(self.stem_bn(x, train))
        for block in self.blocks:
            x = block(x, train)
        return self.head(x.mean((2, 3)), torch.float32)
