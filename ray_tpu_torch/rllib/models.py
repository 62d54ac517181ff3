"""Policy/value networks.

Parity: reference ``rllib/models/catalog.py`` + ``models/torch/fcnet.py``
— a fully-connected torso producing action-distribution inputs and a
value head.  One forward gives (dist_inputs, value); the distributions
are plain tensor functions shared by the samplers and the losses, and
sample from an explicit ``torch.Generator`` on the tensors' device.

Parameters start as flax's do, so a model learns like the JAX
package's: every Dense is LeCun-normal (a normal truncated at two
standard deviations, fan-in scaled) with a zero bias, the policy head
``orthogonal(0.01)`` and the separate value head ``orthogonal(1.0)``;
LayerNorms take flax's epsilon, 1e-6.  Modules keep flax's parameter
names (``fc_0``, ``vf_out``, ``block_0.attn`` ...), so
``ray_tpu_torch.models.convert`` maps a flax tree name by name.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

#: flax's LayerNorm epsilon (torch's default is 1e-5)
LN_EPS = 1e-6

_ACTIVATIONS = {"tanh": torch.tanh, "relu": F.relu, "swish": F.silu}

Carry = Tuple[torch.Tensor, torch.Tensor]


def _lecun_normal_(weight: torch.Tensor, gen: torch.Generator) -> None:
    """flax ``lecun_normal``: variance 1 / fan_in from a normal truncated
    at +-2 standard deviations (whose own std is 0.8796...)."""
    std = math.sqrt(1.0 / weight.shape[1]) / .87962566103423978
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2 * std, b=2 * std,
                              generator=gen)


def _dense(n_in: int, n_out: int, gen: torch.Generator,
           orthogonal: Optional[float] = None, bias: bool = True
           ) -> nn.Linear:
    layer = nn.Linear(n_in, n_out, bias=bias)
    if orthogonal is None:
        _lecun_normal_(layer.weight, gen)
    else:
        with torch.no_grad():
            nn.init.orthogonal_(layer.weight, gain=orthogonal,
                                generator=gen)
    if bias:
        nn.init.zeros_(layer.bias)
    return layer


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


class FCNet(nn.Module):
    """Shared-torso MLP: obs -> (dist_inputs, value)."""

    def __init__(self, num_inputs: int, num_outputs: int,
                 hiddens: Sequence[int] = (64, 64),
                 activation: str = "tanh", vf_share_layers: bool = False,
                 seed: int = 0):
        super().__init__()
        gen = _generator(seed)
        self.act = _ACTIVATIONS[activation]
        self.hiddens = tuple(int(h) for h in hiddens)
        #: separate value branch (reference vf_share_layers=False default)
        self.vf_share_layers = bool(vf_share_layers)
        sizes = (num_inputs,) + self.hiddens
        for i in range(len(self.hiddens)):
            self.add_module(f"fc_{i}", _dense(sizes[i], sizes[i + 1], gen))
        self.out = _dense(sizes[-1], num_outputs, gen, orthogonal=0.01)
        if self.vf_share_layers:
            self.vf_out = _dense(sizes[-1], 1, gen)
        else:
            for i in range(len(self.hiddens)):
                self.add_module(f"vf_{i}",
                                _dense(sizes[i], sizes[i + 1], gen))
            self.vf_out = _dense(sizes[-1], 1, gen, orthogonal=1.0)

    def forward(self, obs: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        x = obs
        for i in range(len(self.hiddens)):
            x = self.act(getattr(self, f"fc_{i}")(x))
        logits = self.out(x)
        if self.vf_share_layers:
            v = self.vf_out(x)
        else:
            y = obs
            for i in range(len(self.hiddens)):
                y = self.act(getattr(self, f"vf_{i}")(y))
            v = self.vf_out(y)
        return logits, v.squeeze(-1)


class Categorical:
    """Discrete action distribution over logits."""

    @staticmethod
    def sample(logits: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        # Gumbel-max, as jax.random.categorical draws
        u = torch.rand(logits.shape, generator=gen, device=logits.device,
                       dtype=logits.dtype)
        tiny = torch.finfo(logits.dtype).tiny
        gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
        return torch.argmax(logits + gumbel, dim=-1)

    @staticmethod
    def logp(logits: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        logp_all = F.log_softmax(logits, dim=-1)
        return torch.gather(logp_all, -1,
                            actions.long().unsqueeze(-1)).squeeze(-1)

    @staticmethod
    def entropy(logits: torch.Tensor) -> torch.Tensor:
        logp = F.log_softmax(logits, dim=-1)
        return -torch.sum(torch.exp(logp) * logp, dim=-1)

    @staticmethod
    def kl(logits_p: torch.Tensor, logits_q: torch.Tensor) -> torch.Tensor:
        logp = F.log_softmax(logits_p, dim=-1)
        logq = F.log_softmax(logits_q, dim=-1)
        return torch.sum(torch.exp(logp) * (logp - logq), dim=-1)


class DiagGaussian:
    """Continuous actions: dist_inputs = [mean, log_std] concatenated."""

    @staticmethod
    def _split(inputs: torch.Tensor):
        mean, log_std = torch.chunk(inputs, 2, dim=-1)
        return mean, torch.clamp(log_std, -20.0, 2.0)

    @staticmethod
    def sample(inputs: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
        mean, log_std = DiagGaussian._split(inputs)
        noise = torch.randn(mean.shape, generator=gen, device=mean.device,
                            dtype=mean.dtype)
        return mean + torch.exp(log_std) * noise

    @staticmethod
    def logp(inputs: torch.Tensor, actions: torch.Tensor) -> torch.Tensor:
        mean, log_std = DiagGaussian._split(inputs)
        var = torch.exp(2 * log_std)
        return torch.sum(
            -0.5 * ((actions - mean) ** 2 / var)
            - log_std - 0.5 * math.log(2 * math.pi), dim=-1)

    @staticmethod
    def entropy(inputs: torch.Tensor) -> torch.Tensor:
        _, log_std = DiagGaussian._split(inputs)
        return torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e),
                         dim=-1)

    @staticmethod
    def kl(inputs_p: torch.Tensor, inputs_q: torch.Tensor) -> torch.Tensor:
        mp, lsp = DiagGaussian._split(inputs_p)
        mq, lsq = DiagGaussian._split(inputs_q)
        return torch.sum(
            lsq - lsp + (torch.exp(2 * lsp) + (mp - mq) ** 2)
            / (2 * torch.exp(2 * lsq)) - 0.5, dim=-1)


class TwinQNetwork(nn.Module):
    """Q(s, a) MLP critic; ``twin=True`` adds the second head for
    clipped double-Q (SAC/TD3 — both heads share nothing but the input,
    as in the reference's ``SACTorchModel`` twin_q)."""

    def __init__(self, obs_dim: int, act_dim: int, twin: bool = True,
                 hiddens: Tuple[int, ...] = (256, 256), seed: int = 0):
        super().__init__()
        gen = _generator(seed)
        self.twin = bool(twin)
        self.hiddens = tuple(int(h) for h in hiddens)
        sizes = (obs_dim + act_dim,) + self.hiddens
        for name in ("q1", "q2") if self.twin else ("q1",):
            for i in range(len(self.hiddens)):
                self.add_module(f"{name}_fc_{i}",
                                _dense(sizes[i], sizes[i + 1], gen))
            self.add_module(f"{name}_out", _dense(sizes[-1], 1, gen))

    def _q(self, name: str, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.hiddens)):
            x = F.relu(getattr(self, f"{name}_fc_{i}")(x))
        return getattr(self, f"{name}_out")(x)[..., 0]

    def forward(self, obs: torch.Tensor, act: torch.Tensor):
        x = torch.cat([obs, act], dim=-1)
        q1 = self._q("q1", x)
        return (q1, self._q("q2", x)) if self.twin else (q1, q1)


class LSTMNet(nn.Module):
    """Recurrent torso (reference ``models/torch/recurrent_net.py`` /
    model-config ``use_lstm``): obs -> Dense embed -> LSTM -> policy +
    value heads.  Operates on sequences: training unrolls the whole
    sequence, single-step acting passes T=1 sequences with the carry
    threaded by the sampler.

    The cell is flax's ``OptimizedLSTMCell``: input projections without
    bias (``ii``, ``if``, ``ig``, ``io``, here one ``lstm.ih`` in gate
    order i, f, g, o), hidden projections with bias (``lstm.hh``), and
    the carry ``(c, h)``."""

    def __init__(self, num_inputs: int, num_outputs: int,
                 cell_size: int = 64, embed_size: int = 64,
                 activation: str = "tanh", seed: int = 0):
        super().__init__()
        gen = _generator(seed)
        self.cell_size = int(cell_size)
        self.act = _ACTIVATIONS[activation]
        self.embed = _dense(num_inputs, embed_size, gen)
        self.lstm = nn.Module()
        self.lstm.ih = nn.Linear(embed_size, 4 * cell_size, bias=False)
        self.lstm.hh = nn.Linear(cell_size, 4 * cell_size)
        with torch.no_grad():
            for g in range(4):  # per gate, as flax initialises each Dense
                rows = slice(g * cell_size, (g + 1) * cell_size)
                _lecun_normal_(self.lstm.ih.weight[rows], gen)
                nn.init.orthogonal_(self.lstm.hh.weight[rows],
                                    generator=gen)
            nn.init.zeros_(self.lstm.hh.bias)
        self.out = _dense(cell_size, num_outputs, gen, orthogonal=0.01)
        self.vf_out = _dense(cell_size, 1, gen, orthogonal=1.0)

    def forward(self, obs_seq: torch.Tensor, carry: Carry):
        """obs_seq [B, T, obs_dim]; carry (c, h) each [B, cell_size].
        Returns (dist_inputs [B,T,num_outputs], values [B,T], carry)."""
        x = self.act(self.embed(obs_seq))
        gates_in = self.lstm.ih(x)            # [B, T, 4 * cell]
        c, h = carry
        outs = []
        for t in range(obs_seq.shape[1]):
            gates = gates_in[:, t] + self.lstm.hh(h)
            i, f, g, o = torch.chunk(gates, 4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            outs.append(h)
        outs = torch.stack(outs, dim=1)
        logits = self.out(outs)
        v = self.vf_out(outs)
        return logits, v.squeeze(-1), (c, h)

    def initial_carry(self, batch: int, device=None) -> Carry:
        zeros = torch.zeros((batch, self.cell_size), device=device)
        return (zeros, zeros.clone())


class GRUCell(nn.Module):
    """flax's ``GRUCell`` (QMIX's agents, Dreamer's RSSM): the input
    projections with bias (``ir``, ``iz``, ``in``; here one ``ih`` in
    gate order r, z, n), the hidden ones without (``hr``, ``hz``, ``hn``;
    one ``hh``) but for n's bias (``hn_bias``), so that ``n = tanh(in(x)
    + r * (hn(h) + b))`` and the new carry is ``(1 - z) n + z h``.
    ``torch.nn.GRUCell`` computes the same map with r's and z's hidden
    biases at zero, but would train them."""

    def __init__(self, n_in: int, hidden: int, gen: torch.Generator):
        super().__init__()
        self.ih = nn.Linear(n_in, 3 * hidden)
        self.hh = nn.Linear(hidden, 3 * hidden, bias=False)
        self.hn_bias = nn.Parameter(torch.zeros(hidden))
        with torch.no_grad():
            for g in range(3):  # per gate, as flax initialises each Dense
                rows = slice(g * hidden, (g + 1) * hidden)
                _lecun_normal_(self.ih.weight[rows], gen)
                nn.init.orthogonal_(self.hh.weight[rows], generator=gen)
            nn.init.zeros_(self.ih.bias)

    def forward(self, h: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """One step: carry ``h`` [..., hidden], input ``x`` -> new carry
        (flax returns it twice, as carry and output)."""
        ir, iz, i_n = torch.chunk(self.ih(x), 3, dim=-1)
        hr, hz, hn = torch.chunk(self.hh(h), 3, dim=-1)
        r = torch.sigmoid(ir + hr)
        z = torch.sigmoid(iz + hz)
        n = torch.tanh(i_n + r * (hn + self.hn_bias))
        return (1.0 - z) * n + z * h


class _MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention``: per-head q/k/v projections
    with biases (flax kernels ``[D, H, D/H]``, here ``[H*D/H, D]``
    weights), the query scaled by 1/sqrt(D/H), masked logits set to the
    dtype's lowest value, and an output projection over all heads."""

    def __init__(self, dim: int, heads: int, gen: torch.Generator):
        super().__init__()
        self.heads = heads
        self.head_dim = dim // heads
        for name in ("query", "key", "value"):
            layer = nn.Linear(dim, dim)
            _lecun_normal_(layer.weight, gen)  # fan-in D, as flax's
            nn.init.zeros_(layer.bias)
            self.add_module(name, layer)
        self.out = nn.Linear(dim, dim)
        _lecun_normal_(self.out.weight, gen)   # fan-in H * D/H
        nn.init.zeros_(self.out.bias)

    def forward(self, x: torch.Tensor, kv: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
        """x [B,T,D], kv [B,S,D], mask [B,T,S] bool -> [B,T,D]."""
        b, t, _ = x.shape
        s = kv.shape[1]
        q = self.query(x).view(b, t, self.heads, self.head_dim)
        k = self.key(kv).view(b, s, self.heads, self.head_dim)
        v = self.value(kv).view(b, s, self.heads, self.head_dim)
        q = q / math.sqrt(self.head_dim)
        logits = torch.einsum("bqhd,bkhd->bhqk", q, k)
        logits = torch.where(mask[:, None], logits,
                             torch.finfo(logits.dtype).min)
        weights = torch.softmax(logits, dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v)
        return self.out(out.reshape(b, t, self.heads * self.head_dim))


class _GatedTransformerBlock(nn.Module):
    """One GTrXL block: memory-augmented causal self-attention and a
    position-wise MLP, each behind a GRU-style sigmoid gate (reference
    ``models/torch/attention_net.py`` GTrXLNet blocks)."""

    def __init__(self, dim: int, heads: int, gen: torch.Generator):
        super().__init__()
        self.ln_attn = nn.LayerNorm(dim, eps=LN_EPS)
        self.ln_kv = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = _MultiHeadAttention(dim, heads, gen)
        self.gate_attn = _dense(2 * dim, dim, gen)
        self.ln_ff = nn.LayerNorm(dim, eps=LN_EPS)
        self.ff_in = _dense(dim, 2 * dim, gen)
        self.ff_out = _dense(2 * dim, dim, gen)
        self.gate_ff = _dense(2 * dim, dim, gen)

    def forward(self, x, mem, mem_mask):
        """x [B,T,D] layer input; mem [B,M,D] cached inputs from earlier
        timesteps; mem_mask [B,M] validity.  Returns [B,T,D]."""
        batch, t, _ = x.shape
        m = mem.shape[1]
        kv = torch.cat([mem, x], dim=1)  # [B, M+T, D]
        causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                       device=x.device))
        mask = torch.cat(
            [mem_mask[:, None, :].expand(batch, t, m),
             causal[None].expand(batch, t, t)], dim=-1)
        attn = self.attn(self.ln_attn(x), self.ln_kv(kv), mask)
        gate = torch.sigmoid(self.gate_attn(torch.cat([x, attn], dim=-1)))
        x = x + gate * attn
        z = self.ln_ff(x)
        ff = self.ff_out(F.relu(self.ff_in(z)))
        gate2 = torch.sigmoid(self.gate_ff(torch.cat([x, ff], dim=-1)))
        return x + gate2 * ff


class AttentionNet(nn.Module):
    """GTrXL-style attention torso with sliding window memory (reference
    ``models/torch/attention_net.py`` — model config ``use_attention``).

    Same carry interface as :class:`LSTMNet` so samplers/losses thread it
    identically: carry is two per-env arrays —
    ``mem_flat [B, layers*memory_len*dim]`` (cached layer inputs,
    detached like Transformer-XL's) and ``count [B, 1]`` (how many memory
    slots are valid).
    """

    def __init__(self, num_inputs: int, num_outputs: int, dim: int = 64,
                 num_layers: int = 2, memory_len: int = 16,
                 heads: int = 4, seed: int = 0):
        super().__init__()
        gen = _generator(seed)
        self.dim = int(dim)
        self.num_layers = int(num_layers)
        self.memory_len = int(memory_len)
        self.embed = _dense(num_inputs, dim, gen)
        for layer in range(self.num_layers):
            self.add_module(f"block_{layer}",
                            _GatedTransformerBlock(dim, heads, gen))
        self.out = _dense(dim, num_outputs, gen, orthogonal=0.01)
        self.vf_out = _dense(dim, 1, gen, orthogonal=1.0)

    def forward(self, obs_seq: torch.Tensor, carry: Carry):
        mem_flat, count = carry
        batch, t, _ = obs_seq.shape
        mems = mem_flat.reshape(batch, self.num_layers, self.memory_len,
                                self.dim)
        # slot m is valid iff it is within the last `count` positions
        idx = torch.arange(self.memory_len, device=obs_seq.device)[None, :]
        mem_mask = idx >= (self.memory_len - count)  # [B, M] bool
        x = self.embed(obs_seq)
        new_mems = []
        for layer in range(self.num_layers):
            new_mems.append(torch.cat([mems[:, layer], x],
                                      dim=1)[:, -self.memory_len:].detach())
            x = getattr(self, f"block_{layer}")(x, mems[:, layer],
                                                 mem_mask)
        logits = self.out(x)
        v = self.vf_out(x)
        new_count = torch.clamp(count + t, max=self.memory_len)
        new_carry = (torch.stack(new_mems, dim=1).reshape(batch, -1),
                     new_count.to(count.dtype))
        return logits, v.squeeze(-1), new_carry

    def initial_carry(self, batch: int, device=None) -> Carry:
        return (torch.zeros(
            (batch, self.num_layers * self.memory_len * self.dim),
            device=device), torch.zeros((batch, 1), device=device))
