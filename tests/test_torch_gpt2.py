"""The port's GPT-2 training path against the JAX package's, on the CPU.

Same weights (the flax init, converted), same tokens (numpy, seeded).
Off-TPU the JAX model's flash_attention takes its jnp reference, so this
holds the model, the loss and the optimizer; the attention kernels'
backward is held against the Pallas kernels in test_torch_ops.py.

Configs (``_SHAPES``), each routed to a kernel family as the JAX
package routes it (``_resolve_native``): ``tiny(embed_dim=128,
num_heads=2)``, head_dim 64 on the native-layout kernels; the plain
``tiny()``, head_dim 32 on the head-major ones; ``tiny(embed_dim=192,
num_heads=3)``, head_dim 64 with an odd head count on the head-major
ones, GPT-2 XL's routing (25 heads of 64) in miniature.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import gpt2_state_dict_from_jax

_SHAPES = {"h2d64": dict(embed_dim=128, num_heads=2),
           "h2d32": {},
           "h3d64": dict(embed_dim=192, num_heads=3)}
_SHAPE = _SHAPES["h2d64"]
_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}
# 2 x 40 tokens: the loss sees 2 x 39 = 78 positions, which head_chunk=64
# splits into one full chunk and one padded one.
_BATCH, _SEQ, _CHUNK = 2, 40, 64
_LR = 3e-4


def _unbox(tree):
    return jax.tree.map(lambda x: x.unbox() if hasattr(x, "unbox") else x,
                        tree, is_leaf=lambda x: hasattr(x, "unbox"))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _models(dtype_name, shape=_SHAPE, **torch_kw):
    jdt, tdt = _DTYPES[dtype_name]
    jcfg = jgpt2.GPT2Config.tiny(dtype=jdt, **shape)
    tcfg = tgpt2.GPT2Config.tiny(dtype=tdt, **shape, **torch_kw)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (_BATCH, _SEQ),
                          dtype=np.int32)
    jmodel = jgpt2.GPT2(jcfg)
    params = _unbox(jmodel.init_params(jax.random.PRNGKey(0), batch=1,
                                       seq=_SEQ))
    tmodel = tgpt2.GPT2(tcfg, device="cpu")
    tmodel.load_state_dict(gpt2_state_dict_from_jax(_np_tree(params)))
    return jmodel, params, tmodel, tokens


def _jax_loss_and_grads(jmodel, params, tokens):
    return jax.value_and_grad(lambda p: jgpt2.loss_fn(
        jmodel, p, jnp.asarray(tokens), head_chunk=_CHUNK))(params)


def _torch_grads(tmodel, tokens):
    tmodel.zero_grad(set_to_none=True)
    loss = tgpt2.loss_fn(tmodel, torch.from_numpy(tokens),
                         head_chunk=_CHUNK)
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in tmodel.named_parameters()}


# f32: the two frameworks differ in summation order only (measured on
# CPU, jax 0.9, torch 2.13: logits 6.9e-7 apart at up to 1.05).
# bf16: activations, dense products and biases round to bf16 at other
# points in the two frameworks: logits 0.0062 apart at up to 1.05, a
# few bf16 ulps; 2e-2 leaves ~3x.
_LOGIT_TOL = {"f32": dict(atol=1e-4, rtol=1e-4),
              "bf16": dict(atol=2e-2, rtol=2e-2)}


@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_logits_match_jax(dtype_name, shape):
    jmodel, params, tmodel, tokens = _models(dtype_name, _SHAPES[shape])
    ref = jmodel.apply({"params": params}, jnp.asarray(tokens))
    out = tmodel(torch.from_numpy(tokens))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               **_LOGIT_TOL[dtype_name])


@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_loss_and_every_gradient_match_jax(dtype_name, shape):
    jmodel, params, tmodel, tokens = _models(dtype_name, _SHAPES[shape])
    ref_loss, ref_grads = _jax_loss_and_grads(jmodel, params, tokens)
    ref = gpt2_state_dict_from_jax(_np_tree(ref_grads))
    loss, grads = _torch_grads(tmodel, tokens)
    assert set(grads) == set(ref)
    assert all(g.dtype == torch.float32 for g in grads.values())
    if dtype_name == "f32":
        # summation order only: loss equal to the last bit here, the
        # worst gradient 4.1e-8 apart (1.1e-6 of its tensor's largest)
        np.testing.assert_allclose(loss, float(ref_loss), rtol=1e-6)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                       atol=1e-6, rtol=1e-4, err_msg=name)
    else:
        # bf16: the loss 1.2e-4 apart at 5.58; every gradient that flows
        # through a bf16 activation is bf16-rounded on both sides, the
        # worst (a bias) 1.4% of its tensor's largest element apart
        np.testing.assert_allclose(loss, float(ref_loss), atol=1e-3)
        for name, g in grads.items():
            scale = ref[name].abs().max().item()
            np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                       atol=3e-2 * scale, rtol=0,
                                       err_msg=name)


def _adamw_updates(dtype_name, shape, steps=2):
    """Parameter change after ``steps`` AdamW steps on both sides, as
    {name: (torch, jax)} numpy arrays."""
    jmodel, params, tmodel, tokens = _models(dtype_name, shape)
    tx = optax.adamw(_LR, weight_decay=0.01)
    state, p = tx.init(params), params
    opt = tgpt2.adamw(tmodel.parameters(), lr=_LR, weight_decay=0.01)
    for _ in range(steps):
        _, g = _jax_loss_and_grads(jmodel, p, tokens)
        updates, state = tx.update(g, state, p)
        p = optax.apply_updates(p, updates)
        loss = tgpt2.train_step(tmodel, opt, torch.from_numpy(tokens),
                                head_chunk=_CHUNK)
        assert torch.isfinite(loss)
    before = gpt2_state_dict_from_jax(_np_tree(params))
    after = gpt2_state_dict_from_jax(_np_tree(p))
    return {n: ((t.detach() - before[n]).numpy(),
                (after[n] - before[n]).numpy())
            for n, t in tmodel.named_parameters()}


def _cos(a, b):
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


@pytest.mark.parametrize("shape", _SHAPES)
def test_adamw_steps_match_optax_f32(shape):
    """Two steps of adamw(3e-4, weight_decay=0.01) against optax's.

    Adam divides each element by its own gradient's size, so an element
    whose gradient is near eps (1e-8) magnifies the frameworks'
    summation-order noise: the key third of ``attn_qkv.bias``, whose
    exact gradient is 0 (a key bias shifts every score of a query
    alike), and the rows of ``wpe`` the 40 tokens barely reach.
    Measured: at most 2.9e-5 (h2d64), 2.7e-6 (h2d32) and 1.1e-4 (h3d64)
    apart in a parameter change of 6e-4, and every parameter's change
    within cosine 0.99999 of optax's.  The h3d64 reading is one element
    of ``h.0.attn_proj.weight`` whose gradient is 6.4e-10, below eps."""
    atol = {"h2d64": 1e-4, "h2d32": 1e-4, "h3d64": 3e-4}[shape]
    for name, (t, j) in _adamw_updates("f32", _SHAPES[shape]).items():
        np.testing.assert_allclose(t, j, atol=atol, rtol=0, err_msg=name)
        assert _cos(t, j) > 0.9999, name


@pytest.mark.parametrize("shape", _SHAPES)
def test_adamw_steps_match_optax_bf16(shape):
    """As the f32 test, in bf16.  A gradient that is bf16 noise (the key
    bias above) makes Adam step either way, up to 2 * lr per step apart;
    elsewhere bf16-rounded gradients move the normalised step a little.
    Measured: all changes together at cosine 0.998 with optax's, mean
    |diff| 0.64% of the mean change; the key bias aside, every
    parameter's change at cosine >= 0.994."""
    ups = _adamw_updates("bf16", _SHAPES[shape])
    t_all = np.concatenate([t.ravel() for t, _ in ups.values()])
    j_all = np.concatenate([j.ravel() for _, j in ups.values()])
    assert _cos(t_all, j_all) > 0.99
    assert np.abs(t_all - j_all).mean() < 0.02 * np.abs(j_all).mean()
    assert np.abs(t_all - j_all).max() <= 2 * 2 * _LR * 1.01
    e = tgpt2.GPT2Config.tiny(**_SHAPES[shape]).embed_dim
    for name, (t, j) in ups.items():
        if name.endswith("attn_qkv.bias"):
            t, j = np.delete(t, np.s_[e:2 * e]), np.delete(j, np.s_[e:2 * e])
        assert _cos(t, j) > 0.98, name


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_keeps_gradients(remat):
    """Recomputing in the backward (all of a block, or all but its
    matrix products) gives the gradients of storing everything."""
    *_, tmodel, tokens = _models("f32")
    loss, ref = _torch_grads(tmodel, tokens)
    *_, tremat, _ = _models("f32", remat=remat)
    loss_r, grads = _torch_grads(tremat, tokens)
    assert loss_r == loss
    for name, g in grads.items():
        torch.testing.assert_close(g, ref[name], atol=0, rtol=0, msg=name)


def test_reference_attention_matches_flash_path():
    """attn_impl="reference" (autograd through plain attention) against
    the default flash path (the kernels' plain backward on the CPU)."""
    *_, tflash, tokens = _models("f32")
    loss, ref = _torch_grads(tflash, tokens)
    *_, tplain, _ = _models("f32", attn_impl="reference")
    loss_p, grads = _torch_grads(tplain, tokens)
    np.testing.assert_allclose(loss_p, loss, rtol=1e-6)
    for name, g in grads.items():
        torch.testing.assert_close(g, ref[name], atol=1e-6, rtol=1e-4,
                                   msg=name)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sequence_parallel_attention_raises(impl):
    cfg = tgpt2.GPT2Config.tiny(attn_impl=impl, **_SHAPE)
    with pytest.raises(NotImplementedError, match="slice 5"):
        tgpt2.GPT2(cfg, device="cpu")


@pytest.mark.parametrize("preset", ["gpt2_small", "gpt2_medium",
                                    "gpt2_large", "gpt2_xl", "tiny"])
def test_config_presets_match_jax(preset):
    jcfg = getattr(jgpt2.GPT2Config, preset)()
    tcfg = getattr(tgpt2.GPT2Config, preset)()
    for field in dataclasses.fields(jcfg):
        if field.name not in ("dtype", "param_dtype"):
            assert getattr(tcfg, field.name) == getattr(jcfg, field.name)
    assert (tcfg.dtype, tcfg.param_dtype) == (torch.bfloat16,
                                              torch.float32)
    assert tcfg.num_params() == jcfg.num_params()
    assert tcfg.flops_per_token() == jcfg.flops_per_token()


def test_state_dict_does_not_depend_on_head_count():
    """convert.gpt2_state_dict_from_jax needs nothing of the head count:
    at width 192, 3 heads (head-major kernels) and 4 heads (native
    layout) give the same parameter names and shapes, and each loads
    strictly into the model of its own head count."""
    trees = []
    for heads in (3, 4):
        jcfg = jgpt2.GPT2Config.tiny(embed_dim=192, num_heads=heads)
        params = _unbox(jgpt2.GPT2(jcfg).init_params(
            jax.random.PRNGKey(0), batch=1, seq=8))
        state = gpt2_state_dict_from_jax(_np_tree(params))
        tmodel = tgpt2.GPT2(tgpt2.GPT2Config.tiny(embed_dim=192,
                                                  num_heads=heads),
                            device="cpu")
        tmodel.load_state_dict(state)
        trees.append({n: tuple(t.shape) for n, t in state.items()})
    assert trees[0] == trees[1]


def test_parameter_count_and_init_scales():
    cfg = tgpt2.GPT2Config.tiny(vocab_size=4096, **_SHAPE)
    model = tgpt2.GPT2(cfg, device="cpu",
                       generator=torch.Generator().manual_seed(1))
    assert sum(p.numel() for p in model.parameters()) == cfg.num_params()
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert abs(model.wte.std().item() - 0.02) < 1e-3
    assert abs(model.wpe.std().item() - 0.01) < 1e-3
    assert abs(model.h[0].mlp_up.weight.std().item() - 0.02) < 1e-3
    assert model.h[0].ln_1.weight.eq(1).all()
    assert model.h[0].attn_qkv.bias.eq(0).all()
