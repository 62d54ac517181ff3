"""Vision Transformer (ViT-B/16 and its presets) in PyTorch.

Counterpart of ``ray_tpu/models/vit.py``: same configuration fields and
presets, same parameter tree (``h{i}`` becomes ``h.{i}``, a Dense
``kernel [in, out]`` becomes ``weight [out, in]``, the patch embedding's
conv kernel ``[kh, kw, in, out]`` becomes ``weight [out, in, kh, kw]``;
see ``ray_tpu_torch.models.convert``) and the same loss.

Images come in NHWC ``[B, H, W, C]``, as in the JAX model.  The patch
embedding is a convolution with flax's SAME padding (none at 224 / 16);
the encoder runs *non-causal* flash attention (``ops.flash_attention``)
over the patches and the CLS token: at B/16 and L/16 (head_dim 64, 12 or
16 heads) the native-layout kernels at T = 197, at ``tiny`` (head_dim
32) the head-major ones.  LayerNorm, GELU, the convolution and the dense
products are plain torch, as the JAX package left them to XLA.

Numerics follow the flax model: f32 masters cast to ``cfg.dtype`` inside
``forward``; the patch embedding and every Dense cast input, kernel and
bias to ``cfg.dtype`` and add the bias in it; LayerNorm takes f32
statistics with eps 1e-6; GELU is the tanh form; the residual stream
stays in ``cfg.dtype``; ``ln_f`` runs on the CLS token alone and the head
returns f32 logits from a Dense in ``cfg.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.conv import IN_CHANNELS, Conv
from ray_tpu_torch.models.gpt2 import Dense, LayerNorm, dense_axes
from ray_tpu_torch.ops.flash_attention import (attention_reference,
                                               flash_attention)


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    image_size: int = 224
    patch_size: int = 16
    num_classes: int = 1000
    num_layers: int = 12
    num_heads: int = 12
    embed_dim: int = 768
    mlp_ratio: int = 4
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    #: "flash" | "reference"
    attn_impl: str = "flash"

    @classmethod
    def base(cls, **kw) -> "ViTConfig":  # ViT-B/16
        return cls(**kw)

    @classmethod
    def large(cls, **kw) -> "ViTConfig":  # ViT-L/16
        return cls(num_layers=24, num_heads=16, embed_dim=1024, **kw)

    @classmethod
    def tiny(cls, **kw) -> "ViTConfig":  # for tests
        defaults = dict(image_size=32, patch_size=8, num_classes=10,
                        num_layers=2, num_heads=2, embed_dim=64)
        defaults.update(kw)
        return cls(**defaults)

    @property
    def num_patches(self) -> int:
        return (self.image_size // self.patch_size) ** 2


class EncoderBlock(nn.Module):
    def __init__(self, config: ViTConfig, *, device=None):
        super().__init__()
        cfg = self.config = config
        e, m, pd = config.embed_dim, config.mlp_ratio * config.embed_dim, \
            config.param_dtype
        self.ln_1 = LayerNorm(e, dtype=pd, device=device)
        self.attn_qkv = Dense(e, 3 * e, dtype=pd, device=device)
        self.attn_proj = Dense(e, e, dtype=pd, device=device)
        self.ln_2 = LayerNorm(e, dtype=pd, device=device)
        self.mlp_up = Dense(e, m, dtype=pd, device=device)
        self.mlp_down = Dense(m, e, dtype=pd, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dt = cfg.dtype
        batch, seq = x.shape[:2]
        head_dim = cfg.embed_dim // cfg.num_heads
        # the flax norms emit f32 and the Dense after each casts it to
        # cfg.dtype: the same values as emitting cfg.dtype here
        qkv = self.attn_qkv(self.ln_1(x, dt), dt)
        q, k, v = (t.reshape(batch, seq, cfg.num_heads, head_dim)
                   .contiguous() for t in qkv.split(cfg.embed_dim, dim=-1))
        if cfg.attn_impl == "reference":
            attn = attention_reference(q, k, v, False, head_dim ** -0.5)[0]
        else:
            attn = flash_attention(q, k, v, causal=False)
        x = x + self.attn_proj(attn.reshape(batch, seq, cfg.embed_dim), dt)
        h = self.mlp_up(self.ln_2(x, dt), dt)
        return x + self.mlp_down(F.gelu(h, approximate="tanh"), dt)


class ViT(nn.Module):
    """``forward(images [B, H, W, C])`` returns f32 class logits
    ``[B, num_classes]``.

    Parameters are f32 masters on ``device`` (CUDA unless
    ``device="cpu"``), drawn as the flax initializers draw them —
    normal(0.02) for the patch kernel, ``pos_embed`` and dense weights,
    zeros for ``cls`` and every bias, ones for norm scales — from
    ``generator`` (a fresh one seeded 0 on that device when omitted).
    """

    def __init__(self, config: ViTConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.attn_impl not in ("flash", "reference"):
            raise ValueError(f"unknown attn_impl {config.attn_impl!r}")
        device = resolve_device(device)
        self.config = cfg = config
        e, p, pd = cfg.embed_dim, cfg.patch_size, cfg.param_dtype
        self.patch_embed = Conv(IN_CHANNELS, e, p, p, bias=True, dtype=pd,
                                device=device)
        self.cls = nn.Parameter(torch.empty(1, 1, e, dtype=pd, device=device))
        self.pos_embed = nn.Parameter(torch.empty(
            1, cfg.num_patches + 1, e, dtype=pd, device=device))
        self.h = nn.ModuleList(EncoderBlock(cfg, device=device)
                               for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(e, dtype=pd, device=device)
        self.head = Dense(e, cfg.num_classes, dtype=pd, device=device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)

    def logical_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """Every parameter's logical axes, by name, in the port's layout
        (``parallel.sharding``): the flax model's ``nn.with_partitioning``
        names, a Dense's two swapped and the patch embedding's conv
        kernel ``[kh, kw, in, out]`` permuted to ``[out, in, kh, kw]``;
        the LayerNorms and the patch embedding's bias, which the flax
        model leaves unnamed, replicate."""
        axes = {"patch_embed.weight": ("embed", None, None, None),
                "cls": (None, None, "embed"),
                "pos_embed": (None, None, "embed"),
                **dense_axes("head", ("embed", "vocab"))}
        for i in range(self.config.num_layers):
            for name, kernel in (("attn_qkv", ("embed", "heads")),
                                 ("attn_proj", ("heads", "embed")),
                                 ("mlp_up", ("embed", "mlp")),
                                 ("mlp_down", ("mlp", "embed"))):
                axes.update(dense_axes(f"h.{i}.{name}", kernel))
        return axes

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        for w in (self.patch_embed.weight, self.pos_embed):
            w.normal_(0.0, 0.02, generator=generator)
        self.patch_embed.bias.zero_()
        self.cls.zero_()
        for block in self.h:
            for dense in (block.attn_qkv, block.attn_proj, block.mlp_up,
                          block.mlp_down):
                dense.weight.normal_(0.0, 0.02, generator=generator)
                dense.bias.zero_()
            for norm in (block.ln_1, block.ln_2):
                norm.weight.fill_(1.0)
                norm.bias.zero_()
        self.ln_f.weight.fill_(1.0)
        self.ln_f.bias.zero_()
        self.head.weight.normal_(0.0, 0.02, generator=generator)
        self.head.bias.zero_()

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        dt = cfg.dtype
        # NHWC in, as the JAX model takes it: the permuted view is the
        # conv's channels-last input, no copy
        x = self.patch_embed(images.permute(0, 3, 1, 2), dt)
        batch = x.shape[0]
        # [B, patches, D], patches in row-major order as JAX's reshape
        x = x.permute(0, 2, 3, 1).reshape(batch, -1, cfg.embed_dim)
        x = torch.cat([self.cls.to(dt).expand(batch, 1, cfg.embed_dim), x],
                      dim=1) + self.pos_embed.to(dt)
        for block in self.h:
            x = block(x)
        x = self.ln_f(x[:, 0], torch.float32)
        return self.head(x, dt).float()


def loss_fn(model: ViT, images: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross entropy of the f32 logits against ``labels``."""
    logp = torch.log_softmax(model(images), dim=-1)
    return -logp.gather(-1, labels.long()[:, None]).mean()
