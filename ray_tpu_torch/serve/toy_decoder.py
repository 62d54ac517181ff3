"""Reference engine for the continuous batcher: a toy autoregressive
decoder in torch, on an explicit device.

Counterpart of ``ray_tpu/serve/toy_decoder.py``.  The model is
deliberately tiny but *real* for serving purposes: one embedding gather
and a small MLP mixed over the causal prefix, a fixed-shape step whose
input shapes change only with the padding bucket.  Its outputs are a
deterministic function of the prompt, so tests can assert that
continuous batching never leaks state across the requests sharing a
batch.  The JAX engine jit-compiles the step once per bucket; eager
torch compiles nothing, and ``trace_count`` counts what jit would
compile: the step signatures (shapes and dtypes) this engine has not
seen since its weights were installed.

The weights are drawn from ``np.random.default_rng(seed)`` in the JAX
engine's order, so ``export_weights()`` equals the JAX engine's exactly,
and the step is plain torch in f32 (the JAX package computes these small
products outside any Pallas kernel): greedy tokens equal the JAX
engine's wherever no two logits are near a tie.

Engines run on CUDA unless built with ``device="cpu"``, and raise
without CUDA.  ``step`` returns a tensor on that device without waiting
for it, so the batcher's device-time bracket (``device_done``) holds
the step's real device time.

``step_delay_s`` adds a host-side sleep per decode step to emulate a
model whose step cost dwarfs dispatch overhead.  Because the sleep is
paid once per *step* — not once per request — 8 co-scheduled requests
share each step's cost.
"""

from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch.core import device_telemetry as _dt

__all__ = ["ToyDecoder", "ToyDecoderShard", "make_prompt"]


def _signature(*xs) -> tuple:
    """What jit keys a call on: each argument's shape and dtype."""
    return tuple((tuple(x.shape), str(x.dtype)) for x in xs)


class ToyDecoder:
    """Duck-typed continuous-batching engine (see serve/batching.py).

    Payload: ``{"prompt": [int, ...], "max_new_tokens": int}`` (or a
    bare list of ints).  Result: ``{"prompt_len", "tokens", "text"}``
    where ``tokens`` are the generated ids.

    ``prefill_delay_per_token_s`` emulates the prompt pass of a real
    model (prefill cost scales with prompt length, decode cost with
    step count): in a unified deployment that cost lands on the decode
    loop at admission time — exactly the stall prefill/decode
    disaggregation removes.
    """

    vocab_size = 64
    eos_token = 1
    pad_token = 0

    def __init__(self, dim: int = 32, step_delay_s: float = 0.0,
                 seed: int = 0, prefill_delay_per_token_s: float = 0.0,
                 device=None):
        import numpy as np

        from ray_tpu_torch._device import resolve_device

        self.device = resolve_device(device)
        self.dim = dim
        self.step_delay_s = float(step_delay_s)
        self.prefill_delay_per_token_s = float(prefill_delay_per_token_s)
        rng = np.random.default_rng(seed)
        self.trace_count = 0  # new step signatures since construction
        self._install_weights(
            rng.normal(size=(self.vocab_size, dim)).astype("float32"),
            rng.normal(size=(dim, dim)).astype("float32") / dim ** 0.5,
            rng.normal(size=(dim, self.vocab_size)).astype("float32")
            / dim ** 0.5)

    def _install_weights(self, embed, w1, w2) -> None:
        """(Re)bind the weights (host arrays) and start a fresh
        signature set, as the JAX engine re-jits on a weight swap: the
        first step of each shape after a swap counts again."""
        import numpy as np
        import torch

        # private writable copies: the caller's arrays may be read-only
        # views of the object store, and the engine's may not alias them
        self._host = {k: np.array(x, dtype=np.float32) for k, x in
                      (("embed", embed), ("w1", w1), ("w2", w2))}
        self._embed, self._w1, self._w2 = (
            torch.from_numpy(self._host[k]).to(self.device, copy=True)
            for k in ("embed", "w1", "w2"))
        seen: set = set()

        def _step(tokens, lengths, active):
            sig = _signature(tokens, lengths, active)
            if sig not in seen:
                seen.add(sig)
                self.trace_count += 1
            tokens, lengths, active = self._to_device(tokens, lengths,
                                                      active)
            pooled = self._pooled(tokens, lengths, self._embed)
            h = torch.tanh(pooled @ self._w1)
            return self._pick(h @ self._w2, active)

        # the compile-accounting wrapper is rebuilt WITH the step, so its
        # seen-signature set tracks this engine's own (a weight swap
        # counts as a fresh "first")
        self._jstep = _dt.instrument_step(_step, name="toy_decoder.step")

    # -- the step's parts ----------------------------------------------------
    def _to_device(self, *xs):
        """Step inputs (host arrays, possibly read-only views of the
        object store, or tensors) as tensors on the engine's device."""
        import numpy as np
        import torch

        return tuple((x if isinstance(x, torch.Tensor)
                      else torch.from_numpy(np.array(x))).to(self.device)
                     for x in xs)

    @staticmethod
    def _pooled(tokens, lengths, embed):
        """Masked mean of the prompt's embeddings: ``[B, dim]``."""
        import torch

        emb = embed[tokens.long()]                         # [B, L, D]
        pos = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
        mask = (pos < lengths[:, None]).to(emb.dtype)
        return (emb * mask[..., None]).sum(dim=1) \
            / lengths[:, None].to(emb.dtype).clamp_min(1.0)

    def _pick(self, logits, active):
        """Greedy next tokens, never pad (eos stays reachable, so
        sequences can end early); inactive slots get pad.  torch's
        argmax takes the first of equal maxima, as ``jnp.argmax``."""
        import torch

        logits[:, self.pad_token] = -1e9
        nxt = logits.argmax(dim=-1).to(torch.int32)
        return torch.where(active, nxt,
                           torch.full_like(nxt, self.pad_token))

    # -- model-multiplexing hooks (serve/multiplex.py) ---------------------
    def export_weights(self) -> Dict[str, Any]:
        """Snapshot the full weight set as host arrays — what the
        multiplexer seals into the arena so an evicted model reloads by
        ref instead of re-initializing."""
        return dict(self._host)

    def load_weights(self, weights: Dict[str, Any]) -> None:
        self._install_weights(weights["embed"], weights["w1"],
                              weights["w2"])

    # -- engine protocol ---------------------------------------------------
    def begin_request(self, payload: Any) -> Dict[str, Any]:
        if isinstance(payload, dict):
            prompt = list(payload.get("prompt") or [2])
            max_new = int(payload.get("max_new_tokens", 16))
        else:
            prompt = list(payload)
            max_new = 16
        prompt = [int(t) % self.vocab_size for t in prompt] or [2]
        return {"tokens": prompt, "prompt_len": len(prompt),
                "max_new_tokens": max_new}

    def prefill(self, state: Dict[str, Any]) -> Dict[str, Any]:
        """The prompt pass.  The toy model recomputes from tokens so
        there is no tensor state to build — only the COST is modeled
        (per prompt token), which is what the disaggregation and
        prefix-cache benches measure.  ``state["prefix_len"]`` (set by
        the batcher after a prefix-chain match) is the number of prompt
        tokens whose KV pages were adopted from the cache — their
        prefill cost is skipped."""
        if self.prefill_delay_per_token_s > 0:
            skip = int(state.get("prefix_len") or 0)
            charged = max(0, len(state.get("tokens") or ()) - skip)
            time.sleep(self.prefill_delay_per_token_s * charged)
        return state

    def kv_page_payload(self, tokens: List[int]):
        """Per-token KV payload for one page (kv_cache.py hook): the
        embedding rows of the page's tokens, stacked [n, 2, dim] as a
        stand-in for K and V blocks, as host arrays.  Deterministic in
        the tokens — which is why toy requests survive replica
        migration: any replica rebuilds identical pages."""
        import numpy as np

        emb = self._host["embed"][
            np.asarray(tokens, dtype=np.int32) % self.vocab_size]
        return np.stack([emb, emb], axis=1)

    def step(self, tokens, lengths, active):
        if self.step_delay_s > 0:
            time.sleep(self.step_delay_s)
        return self._jstep(tokens, lengths, active)

    def finish_request(self, state: Dict[str, Any]) -> Dict[str, Any]:
        plen = state["prompt_len"]
        gen = state["tokens"][plen:]
        return {"prompt_len": plen, "tokens": gen,
                "text": " ".join(str(t) for t in gen)}

    @staticmethod
    def _batch_rows(batch):
        """Rows of one warmup batch: numpy batch format is
        ``{column -> array}``; bare arrays/lists pass through."""
        import numpy as np

        if isinstance(batch, dict):
            batch = next(iter(batch.values()))
        rows = np.asarray(batch)
        return rows[None, :] if rows.ndim <= 1 else rows

    def warmup_batch(self, batch) -> int:
        """Serve-warmup hook (serve.warmup): one representative decode
        per corpus batch warms the padding buckets without decoding
        every row."""
        import numpy as np

        rows = self._batch_rows(batch)
        prompt = [int(t) % self.vocab_size
                  for t in np.ravel(rows[0])[:8].tolist()] or [2]
        self.generate_unbatched({"prompt": prompt, "max_new_tokens": 2})
        return len(rows)

    # -- convenience -------------------------------------------------------
    def generate_unbatched(self, payload: Any) -> Dict[str, Any]:
        """Request-at-a-time decode through the SAME step (batch dim 1
        pool) — the baseline the batched path is held against."""
        import numpy as np

        state = self.begin_request(payload)
        buckets = [8, 16, 32, 64, 128, 256]
        while True:
            seq = state["tokens"]
            bucket = next((b for b in buckets if len(seq) + 1 <= b),
                          buckets[-1])
            tokens = np.full((1, bucket), self.pad_token, dtype=np.int32)
            tokens[0, :len(seq)] = seq
            lengths = np.asarray([len(seq)], dtype=np.int32)
            active = np.asarray([True])
            nxt = int(self.step(tokens, lengths, active)[0])
            seq.append(nxt)
            done = nxt == self.eos_token \
                or len(seq) - state["prompt_len"] \
                >= state["max_new_tokens"] or len(seq) >= buckets[-1]
            if done:
                return self.finish_request(state)


class ToyDecoderShard(ToyDecoder):
    """Tensor-parallel shard of the toy decoder (the gang-replica
    reference engine; see serve/sharded.py).

    The MLP's hidden dimension is column-sharded megatron-style: rank
    ``r`` of ``world`` holds ``w1[:, r*cols:(r+1)*cols]`` and computes
    its slice of the hidden activations — each output element is the
    same dot product the unsharded engine computes, so the gang's
    generated tokens match the single-device engine exactly.  Every rank
    derives identical weights from the shared seed (no weight
    broadcast needed); rank 0 additionally keeps the full ``w2`` to
    combine gathered hidden slices into logits.

    The JAX engine runs each rank's partial product as ``shard_map``
    over the process-local device mesh, which degenerates to plain jit
    on a one-device mesh; here each rank computes its own column block
    on its device.

    Gang protocol (duck-typed; serve/sharded.py drives it):

    ``shard_step(tokens, lengths, active) -> h_part [B, cols]``
        This rank's hidden-slice for one decode step, as a host array.
    ``combine(parts, active) -> next_tokens``  (rank 0 only)
        Concatenate rank-ordered hidden slices, project to logits,
        greedy-pick next tokens.
    """

    def __init__(self, dim: int = 32, step_delay_s: float = 0.0,
                 seed: int = 0, prefill_delay_per_token_s: float = 0.0,
                 rank: int = 0, world: int = 1, device=None):
        super().__init__(dim, step_delay_s=step_delay_s, seed=seed,
                         prefill_delay_per_token_s=prefill_delay_per_token_s,
                         device=device)
        import torch

        self.rank = int(rank)
        self.world = int(world)
        if self.world < 1 or dim % self.world:
            raise ValueError(f"dim {dim} not divisible by world {world}")
        cols = dim // self.world
        lo = self.rank * cols
        self._w1_local = self._w1[:, lo:lo + cols]
        self.shard_trace_count = 0
        shard_seen: set = set()

        def _shard_step(tokens, lengths):
            sig = _signature(tokens, lengths)
            if sig not in shard_seen:
                shard_seen.add(sig)
                self.shard_trace_count += 1
            tokens, lengths = self._to_device(tokens, lengths)
            pooled = self._pooled(tokens, lengths, self._embed)
            return torch.tanh(pooled @ self._w1_local)

        self._jshard = _dt.instrument_step(_shard_step,
                                           name="toy_decoder.shard_step")

        def _combine(h, active):
            h, active = self._to_device(h, active)
            return self._pick(h @ self._w2, active)

        self._jcombine = _dt.instrument_step(_combine,
                                             name="toy_decoder.combine")

    # -- gang protocol -----------------------------------------------------
    def shard_step(self, tokens, lengths, active):
        """One rank's decode-step slice, as a host array (it travels to
        rank 0 through the object store).  ``step_delay_s`` is paid here
        (per shard, concurrently) — each device's step cost, not a
        serial sum over the gang."""
        import numpy as np

        if self.step_delay_s > 0:
            time.sleep(self.step_delay_s)
        del active  # inactive slots are masked at combine time
        return self._jshard(np.asarray(tokens),
                            np.asarray(lengths)).cpu().numpy()

    def combine(self, parts, active):
        import numpy as np

        h = np.concatenate([np.asarray(p) for p in parts], axis=1)
        return self._jcombine(h, np.asarray(active))

    def warmup_batch(self, batch) -> int:
        """Gang-aware warmup: rank 0 cannot run a full decode alone
        (world > 1), so warm THIS rank's shard step across the standard
        buckets instead."""
        import numpy as np

        rows = self._batch_rows(batch)
        for bucket in (8, 16):
            tokens = np.full((1, bucket), self.pad_token, dtype=np.int32)
            self._jshard(tokens, np.asarray([1], dtype=np.int32))
        return len(rows)

    def step(self, tokens, lengths, active):
        """Single-process reference: run every rank's slice locally
        (world=1 makes this the unsharded engine).  The gang path never
        calls this — serve/sharded.py fans ``shard_step`` out instead."""
        if self.world == 1:
            if self.step_delay_s > 0:
                time.sleep(self.step_delay_s)
            return self._jcombine(self._jshard(tokens, lengths), active)
        raise RuntimeError(
            "a ToyDecoderShard with world > 1 only serves through a "
            "gang (serve/sharded.py)")


def make_prompt(i: int, length: Optional[int] = None) -> List[int]:
    """Deterministic per-request prompt (bench/test helper)."""
    n = length if length is not None else 3 + (i % 5)
    return [2 + ((i * 7 + j) % 60) for j in range(n)]
