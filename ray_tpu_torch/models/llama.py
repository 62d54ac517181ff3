"""Llama-family decoder (RMSNorm, SwiGLU, RoPE, GQA) in PyTorch.

Counterpart of ``ray_tpu/models/llama.py``, the JAX package's serving
flagship (Llama-2-7B inference).  Same configuration fields and presets,
same parameter names (``layer{i}`` becomes ``layers.{i}``; see
``ray_tpu_torch.models.convert``), same two call paths:

* no cache: attention is the flash kernel (``ops.flash_attention``);
* with ``kv_caches``: prefill and decode both go through
  :func:`decode_attention`, plain tensor code over the whole padded cache,
  and return new cache tensors (see :class:`Llama`).

RMSNorm is the ``ops.fused_rmsnorm`` kernel.  The dense products, the
logits product and ``decode_attention``'s einsums are plain
``torch.matmul``/``einsum``, as the JAX package left them to XLA.

Numerics follow the JAX model: the residual stream is in ``cfg.dtype``
(the embedding is cast before the lookup), dense weights are stored in
``cfg.dtype`` (flax ``Dense(dtype=bf16)`` casts its f32 kernel before the
product), norm scales and the embedding stay f32, RoPE is split-half in
f32, and the logits are f32 against the f32 embedding.  f32 products
rely on ``torch.backends.cuda.matmul.allow_tf32`` being False (PyTorch's
default), which this module leaves as it is.

Inference only: the module's parameters do not require grad (the
training flagship is ``models/gpt2.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops._build import is_dtensor
from ray_tpu_torch.ops.flash_attention import NEG_INF, flash_attention
from ray_tpu_torch.ops.fused import fused_rmsnorm

KVCache = Tuple[torch.Tensor, torch.Tensor, int]


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    max_seq_len: int = 4096
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 32
    embed_dim: int = 4096
    mlp_dim: int = 11008
    rope_theta: float = 10000.0
    rms_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32

    @classmethod
    def llama2_7b(cls, **kw) -> "LlamaConfig":
        return cls(**kw)

    @classmethod
    def llama2_13b(cls, **kw) -> "LlamaConfig":
        return cls(num_layers=40, num_heads=40, embed_dim=5120,
                   mlp_dim=13824, **kw)

    @classmethod
    def tiny(cls, **kw) -> "LlamaConfig":
        defaults = dict(vocab_size=256, max_seq_len=128, num_layers=2,
                        num_heads=4, num_kv_heads=2, embed_dim=64,
                        mlp_dim=128)
        defaults.update(kw)
        return cls(**defaults)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary position embedding, split-half convention, in f32.
    x: [B, T, H, D]; positions: [B, T]."""
    dim = x.shape[-1]
    exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=x.device) / dim
    freqs = 1.0 / (theta ** exponent)
    angles = positions[:, :, None].float() * freqs[None, None]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    if is_dtensor(x) and not is_dtensor(cos):
        # the same angles on every rank, met by its rows and heads of x
        from ray_tpu_torch.parallel._dtensor import as_dtensor
        cos, sin = (as_dtensor(t, x.device_mesh) for t in (cos, sin))
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     positions: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Attention against a (padded) KV cache: key slot ``t`` is visible
    iff ``t <= `` the query's position (cache slots are
    position-indexed).  Products take f32 operands, as the JAX version's
    ``preferred_element_type=f32``; the result is in q's dtype."""
    scale = head_dim ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    kv_pos = torch.arange(k.shape[1], device=q.device)[None, None, None, :]
    q_pos = positions[:, None, :, None]
    s = s.masked_fill(kv_pos > q_pos, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


class RMSNorm(nn.Module):
    """RMSNorm with an f32 scale (``weight``), on the fused kernel."""

    def __init__(self, dim: int, eps: float = 1e-5, *, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(
            torch.ones(dim, dtype=torch.float32, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if is_dtensor(x, self.weight):  # the kernel on each rank's rows
            from ray_tpu_torch.parallel._dtensor import on_rows
            return on_rows(lambda x_, w_: fused_rmsnorm(x_, w_, eps=self.eps),
                           x, self.weight, dims=range(x.dim() - 1))
        return fused_rmsnorm(x, self.weight, eps=self.eps)


class LlamaBlock(nn.Module):
    def __init__(self, config: LlamaConfig, *, device=None):
        super().__init__()
        cfg = config
        self.config = cfg
        hd = cfg.embed_dim // cfg.num_heads

        def dense(fan_in, fan_out):
            # weights are set by Llama.reset_parameters; skip torch's init
            return nn.utils.skip_init(nn.Linear, fan_in, fan_out, bias=False,
                                      device=device, dtype=cfg.dtype)

        self.attn_norm = RMSNorm(cfg.embed_dim, cfg.rms_eps, device=device)
        self.wq = dense(cfg.embed_dim, cfg.num_heads * hd)
        self.wk = dense(cfg.embed_dim, cfg.num_kv_heads * hd)
        self.wv = dense(cfg.embed_dim, cfg.num_kv_heads * hd)
        self.wo = dense(cfg.num_heads * hd, cfg.embed_dim)
        self.mlp_norm = RMSNorm(cfg.embed_dim, cfg.rms_eps, device=device)
        self.w_gate = dense(cfg.embed_dim, cfg.mlp_dim)
        self.w_up = dense(cfg.embed_dim, cfg.mlp_dim)
        self.w_down = dense(cfg.mlp_dim, cfg.embed_dim)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                kv_cache: Optional[KVCache] = None):
        cfg = self.config
        hd = cfg.embed_dim // cfg.num_heads
        batch, seq = x.shape[:2]

        h = self.attn_norm(x)
        q = self.wq(h).view(batch, seq, cfg.num_heads, hd)
        k = self.wk(h).view(batch, seq, cfg.num_kv_heads, hd)
        v = self.wv(h).view(batch, seq, cfg.num_kv_heads, hd)
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

        new_cache = None
        if kv_cache is not None:
            # new tensors with the step's keys and values at cache_len, as
            # jax.lax.dynamic_update_slice returns them: the caller's
            # cache is left as it was.  An overrun raises where JAX would
            # clamp the start and overwrite earlier slots.
            k_cache, v_cache, cache_len = kv_cache
            end = cache_len + seq
            if end > k_cache.shape[1]:
                raise ValueError(
                    f"KV cache of {k_cache.shape[1]} slots cannot take "
                    f"{seq} tokens at position {cache_len}")
            k = torch.slice_scatter(k_cache, k.to(k_cache.dtype), dim=1,
                                    start=cache_len, end=end)
            v = torch.slice_scatter(v_cache, v.to(v_cache.dtype), dim=1,
                                    start=cache_len, end=end)
            new_cache = (k, v, end)

        repeat = cfg.num_heads // cfg.num_kv_heads
        if repeat > 1:
            # jnp.repeat(axis=2): each KV head serves `repeat` adjacent
            # query heads (not Tensor.repeat, which tiles)
            k = k.repeat_interleave(repeat, dim=2)
            v = v.repeat_interleave(repeat, dim=2)

        if kv_cache is not None:
            attn = decode_attention(q, k, v, positions, hd)
        else:
            attn = flash_attention(q, k, v, causal=True)
        x = x + self.wo(attn.reshape(batch, seq, cfg.num_heads * hd))

        h = self.mlp_norm(x)
        h = F.silu(self.w_gate(h)) * self.w_up(h)
        x = x + self.w_down(h)
        return x, new_cache


class Llama(nn.Module):
    """Llama decoder.  ``forward(tokens, positions=None, kv_caches=None)``
    returns f32 logits ``[B, T, vocab]``, and with ``kv_caches`` also the
    updated caches.

    The updated caches are new tensors, as in the JAX model: the caller's
    ``kv_caches`` are not written, so a kept cache (a retried prefill, a
    shared prefix) stays valid; each call copies the whole cache once.
    The one difference from the JAX model: tokens that would run past the
    cache's last slot raise ``ValueError``, where ``dynamic_update_slice``
    clamps the write position and silently overwrites earlier slots.

    Parameters are made on ``device`` (CUDA unless ``device="cpu"``) with
    the flax initializers — normal(0.02) for dense kernels and the
    embedding, ones for norm scales — drawn from ``generator`` (a fresh
    one seeded 0 on that device when omitted).
    """

    def __init__(self, config: LlamaConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.embedding = nn.Parameter(torch.empty(
            config.vocab_size, config.embed_dim, dtype=config.param_dtype,
            device=device))
        self.layers = nn.ModuleList(
            LlamaBlock(config, device=device)
            for _ in range(config.num_layers))
        self.final_norm = RMSNorm(config.embed_dim, config.rms_eps,
                                  device=device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)
        self.requires_grad_(False)

    def logical_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """Every parameter's logical axes, by name, in the port's layout
        (``parallel.sharding``): the flax model's ``nn.with_partitioning``
        names, with each projection's two swapped (a flax kernel ``[in,
        out]`` is a ``weight [out, in]`` here)."""
        axes = {"embedding": ("vocab", "embed"),
                "final_norm.weight": ("embed",)}
        for i in range(self.config.num_layers):
            for name, kernel in (("wq", ("embed", "heads")),
                                 ("wk", ("embed", "kv")),
                                 ("wv", ("embed", "kv")),
                                 ("wo", ("heads", "embed")),
                                 ("w_gate", ("embed", "mlp")),
                                 ("w_up", ("embed", "mlp")),
                                 ("w_down", ("mlp", "embed"))):
                axes[f"layers.{i}.{name}.weight"] = kernel[::-1]
            axes[f"layers.{i}.attn_norm.weight"] = ("embed",)
            axes[f"layers.{i}.mlp_norm.weight"] = ("embed",)
        return axes

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.embedding.normal_(0.0, 0.02, generator=generator)
        for name, p in self.named_parameters():
            if name.endswith("norm.weight"):
                p.fill_(1.0)
            elif p is not self.embedding:
                p.normal_(0.0, 0.02, generator=generator)

    def forward(self, tokens: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                kv_caches: Optional[List[KVCache]] = None):
        cfg = self.config
        if positions is None:
            positions = torch.arange(
                tokens.shape[1], device=tokens.device)[None].expand(
                    tokens.shape)
        # the gather commutes with the cast: same values as casting the
        # whole table first (emb.astype(dtype)[tokens] in JAX)
        if is_dtensor(self.embedding):
            from ray_tpu_torch.parallel._dtensor import embedding
            x = embedding(tokens, self.embedding).to(cfg.dtype)
        else:
            x = F.embedding(tokens, self.embedding).to(cfg.dtype)
        new_caches = []
        for i, layer in enumerate(self.layers):
            cache = kv_caches[i] if kv_caches is not None else None
            x, new_cache = layer(x, positions, cache)
            new_caches.append(new_cache)
        x = self.final_norm(x)
        logits = x.float() @ self.embedding.float().T
        if kv_caches is not None:
            return logits, new_caches
        return logits

    def init_kv_caches(self, batch: int, max_len: int) -> List[KVCache]:
        cfg = self.config
        head_dim = cfg.embed_dim // cfg.num_heads
        shape = (batch, max_len, cfg.num_kv_heads, head_dim)
        dev = self.embedding.device
        return [(torch.zeros(shape, dtype=cfg.dtype, device=dev),
                 torch.zeros(shape, dtype=cfg.dtype, device=dev), 0)
                for _ in range(cfg.num_layers)]
