"""GPT-2 in PyTorch, and its training step.

Counterpart of ``ray_tpu/models/gpt2.py``, the JAX package's training
flagship (GPT-2 124M, the step ``bench.py`` times): same configuration
fields and presets, same parameter tree (``h{i}`` becomes ``h.{i}``, a
Dense ``kernel [in, out]`` becomes ``weight [out, in]``; see
``ray_tpu_torch.models.convert``), the same loss through the chunked LM
head, and ``optax.adamw`` as ``torch.optim.AdamW``.

Attention is the flash kernels (``ops.flash_attention``: forward, and the
dK/dV and dQ kernels in the backward), of the family the JAX package
picks for the shape: the native-layout kernels where the head count
allows them (GPT-2 small, medium, large: 12, 16, 20 heads of 64), the
head-major ones otherwise (GPT-2 XL: 25 heads of 64; ``tiny``: head_dim
32).  LayerNorm, GELU, the dense products and the LM head are plain
torch, as the JAX package left them to XLA.

Sequence parallelism (``attn_impl="ring" | "ulysses"``) runs attention
through ``parallel.ring_attention`` or ``parallel.ulysses_attention``
over the ``sp_axis`` of the global mesh (``parallel.use_mesh``).  Under
GSPMD the JAX model sees the global sequence; here each rank of that
axis holds its contiguous chunk of it, so the model does three things
itself: positions start at the rank's offset (``wpe``), the label of a
chunk's last position is the next rank's first token, and
:func:`loss_fn` divides by the global count of predicted tokens;
:func:`train_step` then sums the parameters' gradients over ``sp`` and
``dp``.  With one rank on those axes (or no mesh) all of this is the
single-device step.

Numerics follow the flax model:

* parameters are f32 masters (``param_dtype``), cast to ``cfg.dtype``
  inside ``forward``, so their gradients are f32;
* a Dense layer casts input, kernel and bias to ``cfg.dtype`` and adds
  the bias in that dtype (flax ``Dense(dtype=...)``);
* LayerNorm takes its statistics in f32 with flax's eps 1e-6 (torch's
  default is 1e-5); the block norms emit ``cfg.dtype``, ``ln_f`` f32;
* GELU is the tanh form (flax ``nn.gelu``);
* the embedding is ``wte.astype(dtype)[tokens] + wpe.astype(dtype)[:T]``
  and the head is tied to the f32 ``wte``.

f32 products rely on ``torch.backends.cuda.matmul.allow_tf32`` being
False (PyTorch's default), which this module leaves as it is.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.ops._build import is_dtensor
from ray_tpu_torch.ops.flash_attention import (attention_reference,
                                               flash_attention)
from ray_tpu_torch.ops.fused import chunked_lm_loss
from ray_tpu_torch.parallel.mesh import axis_group, get_global_mesh
from ray_tpu_torch.parallel.ring_attention import ring_attention, ring_shift
from ray_tpu_torch.parallel.ulysses import ulysses_attention

LN_EPS = 1e-6  # flax nn.LayerNorm's default

# remat="dots": save the outputs of matrix products and recompute the
# rest in the backward (jax.checkpoint_policies.dots_saveable).
_DOT_OPS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default]


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    max_seq_len: int = 1024
    num_layers: int = 12
    num_heads: int = 12
    embed_dim: int = 768
    mlp_ratio: int = 4
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    #: "flash" | "ring" | "ulysses" | "reference"
    attn_impl: str = "flash"
    #: mesh axis name for ring/ulysses attention (sequence-parallel impls)
    sp_axis: str = "sp"
    #: activation rematerialization per block: "" (store activations),
    #: "full" (recompute everything in backward), or "dots" (save
    #: matmul outputs, recompute the rest)
    remat: str = ""

    @classmethod
    def gpt2_small(cls, **kw) -> "GPT2Config":  # 124M
        return cls(num_layers=12, num_heads=12, embed_dim=768, **kw)

    @classmethod
    def gpt2_medium(cls, **kw) -> "GPT2Config":  # 350M
        return cls(num_layers=24, num_heads=16, embed_dim=1024, **kw)

    @classmethod
    def gpt2_large(cls, **kw) -> "GPT2Config":  # 774M
        return cls(num_layers=36, num_heads=20, embed_dim=1280, **kw)

    @classmethod
    def gpt2_xl(cls, **kw) -> "GPT2Config":  # 1.5B
        return cls(num_layers=48, num_heads=25, embed_dim=1600, **kw)

    @classmethod
    def tiny(cls, **kw) -> "GPT2Config":  # for tests
        defaults = dict(vocab_size=256, max_seq_len=128, num_layers=2,
                        num_heads=2, embed_dim=64)
        defaults.update(kw)
        return cls(**defaults)

    def num_params(self) -> int:
        e, v, l = self.embed_dim, self.vocab_size, self.num_layers
        per_layer = 12 * e * e + 13 * e  # qkv/proj/mlp + biases + lns
        return v * e + self.max_seq_len * e + l * per_layer + 2 * e

    def flops_per_token(self) -> float:
        """Training FLOPs per token, the MFU convention of the JAX
        package (PaLM / nanoGPT): 6 N over all parameters plus the
        attention term 12 L E T."""
        attn = 12 * self.num_layers * self.embed_dim * self.max_seq_len
        return 6.0 * self.num_params() + attn


def dense_axes(name: str, kernel_axes: Tuple[Optional[str], Optional[str]]
               ) -> Dict[str, Tuple[Optional[str], ...]]:
    """The logical axes of a Dense ``name`` whose flax kernel ``[in,
    out]`` carries ``kernel_axes``: its ``weight [out, in]`` takes them
    swapped, its bias the output's."""
    return {f"{name}.weight": tuple(reversed(kernel_axes)),
            f"{name}.bias": (kernel_axes[-1],)}


def norm_axes(name: str, axes=("embed",)) -> Dict[str, Tuple]:
    """A LayerNorm's scale (``weight``) and bias."""
    return {f"{name}.weight": axes, f"{name}.bias": axes}


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm``: f32 statistics, eps 1e-6, f32 scale and
    bias; the caller names the output dtype."""

    def __init__(self, dim: int, *, dtype: torch.dtype, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype,
                                              device=device))
        self.bias = nn.Parameter(torch.zeros(dim, dtype=dtype,
                                             device=device))

    def forward(self, x: torch.Tensor,
                out_dtype: torch.dtype) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.weight.shape, self.weight.float(),
                         self.bias.float(), LN_EPS)
        return y.to(out_dtype)


class Dense(nn.Module):
    """flax ``nn.Dense(dtype=...)`` over f32 masters: input, weight and
    bias are cast to ``dtype`` and the bias is added in it."""

    def __init__(self, fan_in: int, fan_out: int, *, dtype: torch.dtype,
                 device=None):
        super().__init__()
        # values come from GPT2.reset_parameters
        self.weight = nn.Parameter(torch.empty(fan_out, fan_in, dtype=dtype,
                                               device=device))
        self.bias = nn.Parameter(torch.zeros(fan_out, dtype=dtype,
                                             device=device))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        return F.linear(x.to(dtype), self.weight.to(dtype)) + \
            self.bias.to(dtype)


class Block(nn.Module):
    def __init__(self, config: GPT2Config, *, device=None):
        super().__init__()
        cfg = self.config = config
        e, pd = cfg.embed_dim, cfg.param_dtype
        self.ln_1 = LayerNorm(e, dtype=pd, device=device)
        self.attn_qkv = Dense(e, 3 * e, dtype=pd, device=device)
        self.attn_proj = Dense(e, e, dtype=pd, device=device)
        self.ln_2 = LayerNorm(e, dtype=pd, device=device)
        self.mlp_up = Dense(e, cfg.mlp_ratio * e, dtype=pd, device=device)
        self.mlp_down = Dense(cfg.mlp_ratio * e, e, dtype=pd, device=device)

    def forward(self, x: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        cfg = self.config
        dt = cfg.dtype
        batch, seq = x.shape[:2]
        head_dim = cfg.embed_dim // cfg.num_heads

        qkv = self.attn_qkv(self.ln_1(x, dt), dt)
        # jnp.split gives views; the flash kernels take contiguous q, k, v
        q, k, v = (t.reshape(batch, seq, cfg.num_heads, head_dim)
                   .contiguous() for t in qkv.split(cfg.embed_dim, dim=-1))
        sharded = is_dtensor(q)
        if sharded:  # on each rank's heads where the weight splits them
            from ray_tpu_torch.parallel._dtensor import (heads_like,
                                                         on_sequence_chunks)
            q, k, v = (heads_like(t, self.attn_qkv.weight)
                       for t in (q, k, v))
        if cfg.attn_impl in ("ring", "ulysses"):
            # this rank's chunk of the sequence, over the global mesh's
            # sp axis (the whole sequence without one)
            fn = ring_attention if cfg.attn_impl == "ring" \
                else ulysses_attention
            mesh = q.device_mesh if sharded else get_global_mesh()

            def attend(q_, k_, v_):
                return fn(q_, k_, v_, axis_name=cfg.sp_axis, causal=True,
                          mesh=mesh)

            attn = (on_sequence_chunks(attend, q, k, v, cfg.sp_axis)
                    if sharded else attend(q, k, v))
        elif cfg.attn_impl == "reference":
            attn = attention_reference(q, k, v, True, head_dim ** -0.5)[0]
        else:
            attn = flash_attention(q, k, v, causal=True)
        x = x + self.attn_proj(attn.reshape(batch, seq, cfg.embed_dim), dt)

        h = self.mlp_up(self.ln_2(x, dt), dt)
        h = self.mlp_down(F.gelu(h, approximate="tanh"), dt)
        if cfg.dropout > 0 and not deterministic:
            h = F.dropout(h, cfg.dropout, training=True)
        return x + h


class GPT2(nn.Module):
    """GPT-2 decoder.  ``forward(tokens)`` returns f32 logits
    ``[B, T, vocab]``; ``hidden(tokens)`` returns the f32 hidden states
    after ``ln_f`` and the tied embedding, which :func:`loss_fn` feeds to
    the chunked LM head.

    Parameters are f32 masters on ``device`` (CUDA unless
    ``device="cpu"``), drawn as the flax initializers draw them —
    normal(0.02) for ``wte`` and dense weights, normal(0.01) for ``wpe``,
    zeros for biases, ones for norm scales — from ``generator`` (a fresh
    one seeded 0 on that device when omitted).
    """

    def __init__(self, config: GPT2Config, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.attn_impl not in ("flash", "ring", "ulysses",
                                    "reference"):
            raise ValueError(f"unknown attn_impl {config.attn_impl!r}")
        if config.remat not in ("", "full", "dots"):
            raise ValueError(f"unknown remat {config.remat!r}")
        device = resolve_device(device)
        self.config = config
        pd = config.param_dtype
        self.wte = nn.Parameter(torch.empty(
            config.vocab_size, config.embed_dim, dtype=pd, device=device))
        self.wpe = nn.Parameter(torch.empty(
            config.max_seq_len, config.embed_dim, dtype=pd, device=device))
        self.h = nn.ModuleList(Block(config, device=device)
                               for _ in range(config.num_layers))
        self.ln_f = LayerNorm(config.embed_dim, dtype=pd, device=device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.wte.normal_(0.0, 0.02, generator=generator)
        self.wpe.normal_(0.0, 0.01, generator=generator)
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

    def logical_axes(self) -> Dict[str, Tuple[Optional[str], ...]]:
        """Every parameter's logical axes, by name, in the port's layout:
        the flax model's ``nn.with_partitioning`` names with each Dense's
        two swapped (``parallel.sharding`` maps them to the mesh)."""
        axes = {"wte": ("vocab", "embed"), "wpe": (None, "embed"),
                **norm_axes("ln_f")}
        for i in range(self.config.num_layers):
            for name, kernel in (("attn_qkv", ("embed", "heads")),
                                 ("attn_proj", ("heads", "embed")),
                                 ("mlp_up", ("embed", "mlp")),
                                 ("mlp_down", ("mlp", "embed"))):
                axes.update(dense_axes(f"h.{i}.{name}", kernel))
            axes.update(norm_axes(f"h.{i}.ln_1"))
            axes.update(norm_axes(f"h.{i}.ln_2"))
        return axes

    def _block(self, block: Block, x: torch.Tensor,
               deterministic: bool) -> torch.Tensor:
        remat = self.config.remat
        if remat == "full":
            return checkpoint(block, x, deterministic, use_reentrant=False)
        if remat == "dots":
            return checkpoint(
                block, x, deterministic, use_reentrant=False,
                context_fn=functools.partial(
                    create_selective_checkpoint_contexts, _DOT_OPS))
        return block(x, deterministic)

    def hidden(self, tokens: torch.Tensor, deterministic: bool = True
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``tokens`` is this rank's chunk of the sequence under sequence
        parallelism (:func:`sp_place`), the whole sequence otherwise."""
        cfg = self.config
        seq = tokens.shape[1]
        # placed parameters see the global batch, as GSPMD does
        size, rank = (1, 0) if is_dtensor(self.wte) else sp_place(cfg)
        if seq * size > cfg.max_seq_len:
            raise ValueError(f"{seq * size} tokens exceed max_seq_len "
                             f"{cfg.max_seq_len}")
        # the gather commutes with the cast: the same values as casting
        # the whole table first (wte.astype(dtype)[tokens] in JAX)
        x = embed(tokens.long(), self.wte).to(cfg.dtype) + \
            self.wpe[rank * seq:(rank + 1) * seq].to(cfg.dtype)
        for block in self.h:
            x = self._block(block, x, deterministic)
        return self.ln_f(x, torch.float32), self.wte

    def forward(self, tokens: torch.Tensor,
                deterministic: bool = True) -> torch.Tensor:
        x, wte = self.hidden(tokens, deterministic)
        return x @ wte.float().T


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``F.embedding``; a DTensor table through the port's per-rank
    lookup (``parallel._dtensor.embedding``)."""
    if not is_dtensor(table):
        return F.embedding(tokens, table)
    from ray_tpu_torch.parallel._dtensor import embedding
    return embedding(tokens, table)


def _sp_groups(config: GPT2Config):
    """The process groups of the global mesh's sp and dp axes (None for
    an axis of one rank, or without a mesh)."""
    if config.attn_impl not in ("ring", "ulysses"):
        return None, None
    mesh = get_global_mesh()
    return axis_group(mesh, config.sp_axis), axis_group(mesh, "dp")


def sp_place(config: GPT2Config) -> Tuple[int, int]:
    """(ranks, this rank) on the global mesh's ``sp_axis`` for a
    sequence-parallel ``config`` (``attn_impl`` "ring" or "ulysses");
    (1, 0) for any other, or without a mesh."""
    group = _sp_groups(config)[0]
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def loss_fn(model: GPT2, tokens: torch.Tensor, head_chunk: int = 8192,
            head_logits_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Next-token cross entropy (labels = tokens shifted left) through
    the chunked LM head; a bf16 model runs the head's products on bf16
    operands, with logits in ``head_logits_dtype`` (f32 by default).

    Under sequence parallelism ``tokens`` is this rank's chunk: the label
    of its last position is the next rank's first token (the last rank's
    last position predicts nothing), and the mean is over the predicted
    tokens of the whole sequence and every ``dp`` rank (batches of equal
    size).  The value returned is that global loss; its gradient is this
    rank's share, which :func:`train_step` sums over the ranks."""
    x, wte = model.hidden(tokens)
    compute = torch.bfloat16 if model.config.dtype == torch.bfloat16 \
        else None
    sp, dp = _sp_groups(model.config)
    if (sp is None and dp is None) or is_dtensor(wte):
        return chunked_lm_loss(x[:, :-1], wte, tokens[:, 1:],
                               chunk=head_chunk, compute_dtype=compute,
                               logits_dtype=head_logits_dtype)
    size, rank = sp_place(model.config)
    batch, seq = tokens.shape
    after = ring_shift(tokens[:, :1], sp, -1)  # the next rank's first
    if rank < size - 1:
        labels = torch.cat([tokens[:, 1:], after], dim=1)
    else:
        x, labels = x[:, :-1], tokens[:, 1:]
    n_dp = 1 if dp is None else dist.get_world_size(dp)
    count = batch * (seq * size - 1) * n_dp  # predicted tokens, globally
    local = chunked_lm_loss(x, wte, labels, chunk=head_chunk,
                            compute_dtype=compute,
                            logits_dtype=head_logits_dtype) \
        * (labels.numel() / count)
    total = local.detach().clone()
    for group in (sp, dp):
        if group is not None:
            dist.all_reduce(total, group=group)
    return local + (total - local.detach())


def reduce_gradients(model: GPT2) -> None:
    """Sum the parameters' gradients over the global mesh's ``sp`` and
    ``dp`` ranks (a sequence-parallel config; nothing otherwise): each
    rank's backward gives its share of the global loss's gradient.
    DTensor parameters take ``parallel.sharding.place_gradients``
    instead."""
    if is_dtensor(model.wte):
        from ray_tpu_torch.parallel.sharding import place_gradients
        place_gradients(model)
        return
    for group in _sp_groups(model.config):
        if group is None:
            continue
        for p in model.parameters():
            if p.grad is not None:
                dist.all_reduce(p.grad, group=group)


def adamw(params, lr: float = 3e-4,
          weight_decay: float = 0.01) -> torch.optim.AdamW:
    """``optax.adamw(lr, weight_decay=...)``: betas 0.9/0.999, eps 1e-8,
    decay on every parameter.  torch decays the old parameter before the
    Adam step, which is the same update as optax's ``-lr * (adam +
    wd * p)``."""
    return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def train_step(model: GPT2, optimizer: torch.optim.Optimizer,
               tokens: torch.Tensor, **loss_kw) -> torch.Tensor:
    """One step of ``bench.py``'s ``step``: the loss, its gradient and
    one optimizer update.  Returns the loss (a device scalar: reading it
    waits for the card)."""
    optimizer.zero_grad(set_to_none=True)
    loss = loss_fn(model, tokens, **loss_kw)
    loss.backward()
    reduce_gradients(model)
    optimizer.step()
    return loss.detach()

