"""The port's Llama against the JAX package's, on the CPU.

Same weights (the flax init, converted), same tokens (numpy, seeded).
Off-TPU the JAX model's flash_attention and fused_rmsnorm take their jnp
references, so this holds the model's math; the kernels are held against
the Pallas kernels in test_torch_ops.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import llama as jllama
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models.convert import llama_state_dict_from_jax

_SHAPE = dict(embed_dim=128, num_heads=2, num_kv_heads=1, num_layers=2)
_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}
# f32: the two frameworks differ only in summation order.
# bf16: the residual stream, q/k/v, the attention output and every dense
# product round to bf16 (8 significant bits) at different points in the
# two frameworks, so logits of magnitude ~1 differ by a few bf16 ulps
# (2**-8 ~ 0.004 each).  Measured on this config (CPU, jax 0.9, torch
# 2.13): max |diff| 0.0036 at logits up to 1.6, both paths; 2e-2 is
# ~5 ulps, room for another platform's summation order.
_TOL = {"f32": dict(atol=1e-4, rtol=1e-4),
        "bf16": dict(atol=2e-2, rtol=2e-2)}


def _unbox(tree):
    return jax.tree.map(lambda x: x.unbox() if hasattr(x, "unbox") else x,
                        tree, is_leaf=lambda x: hasattr(x, "unbox"))


def _models(dtype_name, batch=2, seq=8):
    jdt, tdt = _DTYPES[dtype_name]
    jcfg = jllama.LlamaConfig.tiny(dtype=jdt, **_SHAPE)
    tcfg = tllama.LlamaConfig.tiny(dtype=tdt, **_SHAPE)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (batch, seq), dtype=np.int32)
    jmodel = jllama.Llama(jcfg)
    params = _unbox(jmodel.init(jax.random.PRNGKey(0),
                                jnp.asarray(tokens))["params"])
    tmodel = tllama.Llama(tcfg, device="cpu")
    tmodel.load_state_dict(llama_state_dict_from_jax(
        jax.tree.map(np.asarray, params)))
    return jmodel, params, tmodel, tokens


def _close(a, b, name):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), **_TOL[name])


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_full_sequence_logits_match_jax(dtype_name):
    jmodel, params, tmodel, tokens = _models(dtype_name)
    ref = jmodel.apply({"params": params}, jnp.asarray(tokens))
    out = tmodel(torch.from_numpy(tokens).long())
    assert out.dtype == torch.float32 and out.shape == ref.shape
    _close(out.numpy(), ref, dtype_name)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_prefill_and_decode_match_jax(dtype_name):
    """Prefill 4 tokens, then decode 4 one at a time, on both sides."""
    jmodel, params, tmodel, tokens = _models(dtype_name, batch=1)
    jcaches = jmodel.init_kv_caches(batch=1, max_len=16)
    tcaches = tmodel.init_kv_caches(batch=1, max_len=16)
    tt = torch.from_numpy(tokens).long()
    steps = [(0, 4)] + [(t, t + 1) for t in range(4, 8)]
    for lo, hi in steps:
        pos = np.arange(lo, hi)[None]
        jlog, jcaches = jmodel.apply({"params": params},
                                     jnp.asarray(tokens[:, lo:hi]),
                                     jnp.asarray(pos), jcaches)
        tlog, tcaches = tmodel(tt[:, lo:hi], torch.from_numpy(pos),
                               tcaches)
        _close(tlog.numpy(), jlog, dtype_name)
        assert tcaches[0][2] == hi
        _close(tcaches[0][0][:, :hi].float().numpy(),
               jcaches[0][0][:, :hi], dtype_name)


def test_forward_leaves_the_callers_kv_cache_unchanged():
    """A prefill and a decode step return new caches, as JAX's
    dynamic_update_slice does; the tensors passed in stay bit-identical,
    so a kept cache can be used again and gives the same logits."""
    *_, tmodel, tokens = _models("f32", batch=1)
    tt = torch.from_numpy(tokens).long()
    caches = tmodel.init_kv_caches(batch=1, max_len=16)
    kept = [(k.clone(), v.clone(), n) for k, v, n in caches]
    logits, after = tmodel(tt[:, :4], torch.arange(4)[None], caches)
    for (k, v, n), (k0, v0, n0) in zip(caches, kept):
        assert n == n0 == 0
        assert torch.equal(k, k0) and torch.equal(v, v0)
    assert all(a[0] is not c[0] and a[2] == 4
               for a, c in zip(after, caches))
    assert after[0][0][:, :4].abs().sum() > 0
    _, after2 = tmodel(tt[:, 4:5], torch.tensor([[4]]), after)
    assert torch.equal(after[0][0][:, 4], torch.zeros_like(
        after[0][0][:, 4]))  # the step wrote its own copy
    again, _ = tmodel(tt[:, :4], torch.arange(4)[None], caches)
    assert torch.equal(again, logits)


def test_kv_cache_overrun_raises():
    """The port's one deliberate difference from the JAX model: a write
    past the cache's last slot raises, where dynamic_update_slice clamps
    the start (slot 14 of 16 for 4 tokens at 15) and overwrites earlier
    slots."""
    jmodel, params, tmodel, tokens = _models("f32", batch=1)
    pos = np.arange(15, 19)[None]
    jcaches = jmodel.init_kv_caches(batch=1, max_len=16)
    jcaches = [(k, v, 15) for k, v, _ in jcaches]
    _, jout = jmodel.apply({"params": params}, jnp.asarray(tokens[:, :4]),
                           jnp.asarray(pos), jcaches)
    assert np.abs(np.asarray(jout[0][0])[:, 12]).sum() > 0  # clamped
    tcaches = [(k, v, 15) for k, v, _ in
               tmodel.init_kv_caches(batch=1, max_len=16)]
    with pytest.raises(ValueError, match="cannot take 4 tokens at "
                                         "position 15"):
        tmodel(torch.from_numpy(tokens[:, :4]).long(),
               torch.from_numpy(pos), tcaches)


def test_rope_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 3, 64)).astype(np.float32)
    pos = rng.integers(0, 512, (2, 8))
    ref = jllama._rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    out = tllama.rope(torch.from_numpy(x), torch.from_numpy(pos), 10000.0)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-4,
                               rtol=1e-4)


def test_decode_attention_matches_jax():
    """Position-masked attention over a padded cache, GQA-expanded."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 3, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 16, 4, 64)).astype(np.float32)
    v = rng.standard_normal((2, 16, 4, 64)).astype(np.float32)
    pos = np.array([[5, 6, 7], [9, 10, 11]])
    ref = jllama._decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(pos), 64)
    out = tllama.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v),
                                  torch.from_numpy(pos), 64)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5,
                               rtol=2e-5)


def test_gqa_repeat_is_interleaved():
    """jnp.repeat(axis=2) == repeat_interleave, not Tensor.repeat."""
    k = np.arange(2 * 3 * 2 * 4, dtype=np.float32).reshape(2, 3, 2, 4)
    ref = np.asarray(jnp.repeat(jnp.asarray(k), 2, axis=2))
    out = torch.from_numpy(k).repeat_interleave(2, dim=2).numpy()
    np.testing.assert_array_equal(out, ref)


def test_presets_match_jax():
    for preset in ("llama2_7b", "llama2_13b", "tiny"):
        j = getattr(jllama.LlamaConfig, preset)()
        t = getattr(tllama.LlamaConfig, preset)()
        for f in ("vocab_size", "max_seq_len", "num_layers", "num_heads",
                  "num_kv_heads", "embed_dim", "mlp_dim", "rope_theta",
                  "rms_eps"):
            assert getattr(j, f) == getattr(t, f), (preset, f)
    assert tllama.LlamaConfig().dtype == torch.bfloat16
    assert tllama.LlamaConfig().param_dtype == torch.float32


def test_state_dict_names_and_dtypes():
    cfg = tllama.LlamaConfig.tiny(**_SHAPE)  # bf16 compute
    model = tllama.Llama(cfg, device="cpu")
    sd = model.state_dict()
    assert sd["embedding"].dtype == torch.float32
    assert sd["layers.0.attn_norm.weight"].dtype == torch.float32
    assert sd["layers.1.wq.weight"].dtype == torch.bfloat16
    assert sd["layers.0.w_down.weight"].shape == (cfg.embed_dim,
                                                   cfg.mlp_dim)
    assert not any(p.requires_grad for p in model.parameters())
    # the flax init: normal(0.02) kernels and embedding, unit norm scales
    assert torch.all(sd["final_norm.weight"] == 1)
    std = sd["layers.0.w_up.weight"].float().std().item()
    assert 0.015 < std < 0.025
