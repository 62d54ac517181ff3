"""Sparse Mixture-of-Experts transformer (GShard/Switch style) in PyTorch.

Counterpart of ``ray_tpu/models/moe.py``: same configuration fields and
presets, same parameter tree (``h{i}`` becomes ``h.{i}``; a Dense
``kernel [in, out]`` becomes ``weight [out, in]``; the stacked experts
``up [E, D, M]`` and ``down [E, M, D]`` keep their layout; see
``ray_tpu_torch.models.convert``) and the same loss.  Each block is
GPT-2's (``gpt2.Dense``, ``gpt2.LayerNorm``, causal flash attention on
``ops.flash_attention``: the native-layout kernels at the default 8
heads of 64, the head-major ones at ``tiny``) with the MLP replaced by
:class:`SparseMoEMLP`: top-k softmax routing with a fixed expert
capacity, and dispatch and combine as one-hot einsums over
``[G, K, E, C]``, as the reference computes them.  The Switch aux loss,
which the JAX model sows under ``intermediates``, is returned.

Numerics follow what the JAX model computes, not what its comments say:

* the MoE layer gets ``ln_2``'s f32 output, so ``dispatch`` and
  ``combine`` are f32;
* the router is a Dense in ``cfg.dtype`` with a bias, so in the bf16
  config its logits are bf16 (softmax then runs in f32);
* ``einsum(dispatch f32, tokens bf16)`` promotes to f32 in JAX: the
  experts' buffers hold bf16-rounded tokens in f32, and the experts'
  products run in f32 on bf16-rounded weights (``torch.einsum`` does not
  promote, so the casts are written out);
* the MoE output is f32, so ``x + moe(h)`` turns the residual stream f32
  from the first block on;
* ``jax.lax.top_k`` puts the lower expert first on ties (bf16 logits tie
  often); here a stable descending sort does the same.
"""

from __future__ import annotations

import dataclasses
from typing import List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.models.gpt2 import Dense, LayerNorm
from ray_tpu_torch.ops.flash_attention import (attention_reference,
                                               flash_attention)
from ray_tpu_torch.ops.fused import chunked_lm_loss


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    vocab_size: int = 32000
    max_seq_len: int = 1024
    num_layers: int = 8
    num_heads: int = 8
    embed_dim: int = 512
    mlp_ratio: int = 4
    num_experts: int = 8
    top_k: int = 2
    #: buffer slots per expert = capacity_factor * tokens * top_k / E
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    #: "flash" | "reference"
    attn_impl: str = "flash"

    @classmethod
    def tiny(cls, **kw) -> "MoEConfig":
        defaults = dict(vocab_size=256, max_seq_len=128, num_layers=2,
                        num_heads=2, embed_dim=64, num_experts=4, top_k=2)
        defaults.update(kw)
        return cls(**defaults)

    def num_params(self) -> int:
        e = self.embed_dim
        m = self.mlp_ratio * e
        per_layer = 4 * e * e + self.num_experts * (2 * e * m) \
            + e * self.num_experts
        return self.vocab_size * e + self.max_seq_len * e \
            + self.num_layers * per_layer

    def active_params_per_token(self) -> int:
        """Parameters touched per token (top-k experts, not all)."""
        e = self.embed_dim
        m = self.mlp_ratio * e
        per_layer = 4 * e * e + self.top_k * (2 * e * m)
        return self.vocab_size * e + self.num_layers * per_layer

    def capacity(self, tokens: int) -> int:
        """Buffer slots per expert for ``tokens`` routed together."""
        return max(1, int(self.capacity_factor * tokens * self.top_k
                          / self.num_experts))


class Routing(NamedTuple):
    """What the router decided for ``G`` tokens: ``probs [G, E]`` (f32
    softmax), ``gates [G, K]`` (the top-k probabilities renormalised),
    ``experts [G, K]`` (expert indices, best first), ``slots [G, K]``
    (each choice's position in its expert's buffer; a choice at or past
    the capacity is dropped) and ``aux`` (the Switch load-balancing
    loss, scaled by ``router_aux_coef``)."""
    probs: torch.Tensor
    gates: torch.Tensor
    experts: torch.Tensor
    slots: torch.Tensor
    aux: torch.Tensor


def route(router_logits: torch.Tensor, top_k: int,
          aux_coef: float) -> Routing:
    """Top-k routing of ``router_logits [G, E]``, as the JAX layer
    computes it (moe.py:93-110)."""
    num_experts = router_logits.shape[-1]
    probs = torch.softmax(router_logits.float(), dim=-1)
    # jax.lax.top_k: largest first, the lower index first on ties
    experts = torch.sort(probs, dim=-1, descending=True,
                         stable=True).indices[:, :top_k]
    gates = probs.gather(-1, experts)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    # Switch eq. 4: the share routed to each expert (top-1 choices only)
    # against its mean probability
    density = F.one_hot(experts[:, 0], num_experts).float().mean(0)
    aux = (density * probs.mean(0)).sum() * num_experts * aux_coef
    # position of each (token, k) in its expert's buffer: an exclusive
    # cumsum over the [G * K, E] one-hot, tokens in order, k within them
    onehot = F.one_hot(experts, num_experts)  # [G, K, E]
    flat = onehot.reshape(-1, num_experts)
    before = (flat.cumsum(0) - flat).reshape(onehot.shape)
    slots = (before * onehot).sum(-1)
    return Routing(probs, gates, experts, slots, aux)


class SparseMoEMLP(nn.Module):
    """Top-k routed expert MLP with a static capacity ``C`` per expert:
    tokens ``[G, D]`` go to expert buffers ``[E, C, D]`` through a
    one-hot dispatch tensor ``[G, K, E, C]`` (einsum, no scatter), the
    experts run as one batched product over the stacked ``up`` and
    ``down``, and a combine tensor (dispatch times the gates) brings
    their outputs back to token order.  ``forward(x)`` returns ``(out,
    Routing)``, ``out`` in the promotion of x's dtype and ``cfg.dtype``.

    Parameters are f32 masters on ``device`` (CUDA unless
    ``device="cpu"``), drawn as the flax layer draws them — normal(0.02)
    for the router weight, ``up`` and ``down``, a zero router bias —
    from ``generator`` (a fresh one seeded 0 on that device when
    omitted).
    """

    def __init__(self, config: MoEConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        device = resolve_device(device)
        self.config = cfg = config
        e, m, pd = cfg.embed_dim, cfg.mlp_ratio * cfg.embed_dim, \
            cfg.param_dtype
        self.router = Dense(e, cfg.num_experts, dtype=pd, device=device)
        self.up = nn.Parameter(torch.empty(cfg.num_experts, e, m, dtype=pd,
                                           device=device))
        self.down = nn.Parameter(torch.empty(cfg.num_experts, m, e,
                                             dtype=pd, device=device))
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.router.weight.normal_(0.0, 0.02, generator=generator)
        self.router.bias.zero_()
        self.up.normal_(0.0, 0.02, generator=generator)
        self.down.normal_(0.0, 0.02, generator=generator)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Routing]:
        cfg = self.config
        batch, seq, dim = x.shape
        tokens = x.reshape(batch * seq, dim)
        capacity = cfg.capacity(tokens.shape[0])
        r = route(self.router(tokens.float(), cfg.dtype), cfg.top_k,
                  cfg.router_aux_coef)
        kept = (r.slots < capacity).to(x.dtype)
        experts = F.one_hot(r.experts, cfg.num_experts).to(x.dtype)
        slots = (r.slots[..., None] == torch.arange(
            capacity, device=x.device)).to(x.dtype)  # zeros past C
        dispatch = (kept[..., None] * experts)[..., None] * \
            slots[:, :, None, :]  # [G, K, E, C]
        combine = dispatch * r.gates.to(x.dtype)[:, :, None, None]
        # JAX promotes x's dtype against cfg.dtype: f32 buffers of
        # cfg.dtype-rounded tokens, f32 products of cfg.dtype-rounded
        # expert weights
        work = torch.promote_types(x.dtype, cfg.dtype)
        expert_in = torch.einsum("gkec,gd->ecd", dispatch.to(work),
                                 tokens.to(cfg.dtype).to(work))
        h = torch.einsum("ecd,edm->ecm", expert_in,
                         self.up.to(cfg.dtype).to(work))
        h = F.gelu(h, approximate="tanh")
        expert_out = torch.einsum("ecm,emd->ecd", h,
                                  self.down.to(cfg.dtype).to(work))
        out = torch.einsum("gkec,ecd->gd", combine.to(work), expert_out)
        return out.reshape(batch, seq, dim), r


class MoEBlock(nn.Module):
    def __init__(self, config: MoEConfig, *, device=None):
        super().__init__()
        cfg = self.config = config
        e, pd = cfg.embed_dim, cfg.param_dtype
        self.ln_1 = LayerNorm(e, dtype=pd, device=device)
        self.attn_qkv = Dense(e, 3 * e, dtype=pd, device=device)
        self.attn_proj = Dense(e, e, dtype=pd, device=device)
        self.ln_2 = LayerNorm(e, dtype=pd, device=device)
        self.moe = SparseMoEMLP(cfg, device=device)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Routing]:
        cfg = self.config
        dt = cfg.dtype
        batch, seq = x.shape[:2]
        head_dim = cfg.embed_dim // cfg.num_heads
        # ln_1 emits f32 in flax and attn_qkv casts it to cfg.dtype: the
        # same values as emitting cfg.dtype here
        qkv = self.attn_qkv(self.ln_1(x, dt), dt)
        q, k, v = (t.reshape(batch, seq, cfg.num_heads, head_dim)
                   .contiguous() for t in qkv.split(cfg.embed_dim, dim=-1))
        if cfg.attn_impl == "reference":
            attn = attention_reference(q, k, v, True, head_dim ** -0.5)[0]
        else:
            attn = flash_attention(q, k, v, causal=True)
        x = x + self.attn_proj(attn.reshape(batch, seq, cfg.embed_dim), dt)
        out, routing = self.moe(self.ln_2(x, torch.float32))
        return x + out, routing


class MoETransformer(nn.Module):
    """Decoder-only sparse-MoE LM with tied embeddings.  ``forward(tokens)``
    returns f32 logits ``[B, T, vocab]``; ``hidden(tokens)`` returns the
    f32 hidden states after ``ln_f``, the tied embedding and each layer's
    :class:`Routing` (its ``aux`` is what the JAX model sows), which
    :func:`loss_fn` feeds to the chunked LM head.

    Parameters are f32 masters on ``device`` (CUDA unless
    ``device="cpu"``), drawn as the flax initializers draw them —
    normal(0.02) for ``wte``, dense weights and experts, normal(0.01)
    for ``wpe``, zeros for biases, ones for norm scales — from
    ``generator`` (a fresh one seeded 0 on that device when omitted).
    """

    def __init__(self, config: MoEConfig, *, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if config.attn_impl not in ("flash", "reference"):
            raise ValueError(f"unknown attn_impl {config.attn_impl!r}")
        device = resolve_device(device)
        self.config = cfg = config
        pd = cfg.param_dtype
        self.wte = nn.Parameter(torch.empty(
            cfg.vocab_size, cfg.embed_dim, dtype=pd, device=device))
        self.wpe = nn.Parameter(torch.empty(
            cfg.max_seq_len, cfg.embed_dim, dtype=pd, device=device))
        self.h = nn.ModuleList(MoEBlock(cfg, device=device)
                               for _ in range(cfg.num_layers))
        self.ln_f = LayerNorm(cfg.embed_dim, dtype=pd, device=device)
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        self.wte.normal_(0.0, 0.02, generator=generator)
        self.wpe.normal_(0.0, 0.01, generator=generator)
        for block in self.h:
            for dense in (block.attn_qkv, block.attn_proj):
                dense.weight.normal_(0.0, 0.02, generator=generator)
                dense.bias.zero_()
            block.moe.reset_parameters(generator)
            for norm in (block.ln_1, block.ln_2):
                norm.weight.fill_(1.0)
                norm.bias.zero_()
        self.ln_f.weight.fill_(1.0)
        self.ln_f.bias.zero_()

    def hidden(self, tokens: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, List[Routing]]:
        cfg = self.config
        seq = tokens.shape[1]
        if seq > cfg.max_seq_len:
            raise ValueError(f"{seq} tokens exceed max_seq_len "
                             f"{cfg.max_seq_len}")
        # the gather commutes with the cast (wte.astype(dtype)[tokens])
        x = F.embedding(tokens.long(), self.wte).to(cfg.dtype) + \
            self.wpe[:seq].to(cfg.dtype)
        routings = []
        for block in self.h:
            x, routing = block(x)
            routings.append(routing)
        return self.ln_f(x, torch.float32), self.wte, routings

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        x, wte, _ = self.hidden(tokens)
        return x @ wte.float().T


def loss_fn(model: MoETransformer, tokens: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy through the chunked LM head (bf16
    operands and f32 logits in the bf16 config) plus every layer's
    router aux loss."""
    x, wte, routings = model.hidden(tokens)
    compute = torch.bfloat16 if model.config.dtype == torch.bfloat16 \
        else None
    lm = chunked_lm_loss(x[:, :-1].float(), wte.float(), tokens[:, 1:],
                         compute_dtype=compute)
    return lm + sum(r.aux for r in routings)
