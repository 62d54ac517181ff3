"""The port's ViT against the JAX package's, on the CPU.

Same weights (the flax init, every parameter then perturbed with seeded
numpy noise so that the zero CLS token and zero biases cannot hide a
fault, converted by ``vit_state_dict_from_jax``), same NHWC images and
labels (numpy, seeded).  Off-TPU the JAX model's flash_attention takes
its jnp reference, so this holds the model, the loss and the optimizer;
the kernels at ViT's attention shapes are held against the Pallas
kernels in test_torch_ops.py.

Configs (``_SHAPES``), each routed to the kernel family the JAX package
picks: ``tiny()``, 2 heads of 32 over 16 patches + CLS, head-major;
``tiny(embed_dim=128)``, 2 heads of 64, native layout.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import vit as jvit
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.models.convert import vit_state_dict_from_jax
from ray_tpu_torch.models.gpt2 import adamw

_SHAPES = {"h2d32": {}, "h2d64": dict(embed_dim=128)}
_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}
_BATCH = 3
_LR = 3e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: under the
    suite's ``-n 6`` six pools of a thread per core on the same cores
    spend the time waiting for each other on these tiny shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unbox(tree):
    return jax.tree.map(lambda x: x.unbox() if hasattr(x, "unbox") else x,
                        tree, is_leaf=lambda x: hasattr(x, "unbox"))


def _perturb(tree, seed=1, scale=0.05):
    """Every leaf plus seeded normal noise: no parameter keeps its init
    value (zeros for CLS and biases, ones for norm scales)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(
        np.asarray(x) + scale * rng.standard_normal(x.shape), x.dtype), tree)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _jax_side(dtype_name, shape):
    """The JAX model's perturbed parameters, inputs, logits, loss and
    gradients for one config (jitted, computed once per config)."""
    jcfg = jvit.ViTConfig.tiny(dtype=_DTYPES[dtype_name][0],
                               **_SHAPES[shape])
    rng = np.random.default_rng(0)
    images = rng.standard_normal(
        (_BATCH, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    labels = rng.integers(0, jcfg.num_classes, _BATCH).astype(np.int32)
    jmodel = jvit.ViT(jcfg)
    params = _perturb(_unbox(jax.jit(jmodel.init_params)(
        jax.random.PRNGKey(0))))
    logits = jax.jit(lambda p: jmodel.apply({"params": p}, images))(params)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: jvit.loss_fn(
        jmodel, p, images, labels)))(params)
    return dict(params=params, images=images, labels=labels,
                logits=np.asarray(logits), loss=float(loss), grads=grads)


def _models(dtype_name, shape, **torch_kw):
    """The JAX side of one config and a fresh port model with its
    weights."""
    jside = _jax_side(dtype_name, shape)
    tcfg = tvit.ViTConfig.tiny(dtype=_DTYPES[dtype_name][1],
                               **_SHAPES[shape], **torch_kw)
    tmodel = tvit.ViT(tcfg, device="cpu")
    tmodel.load_state_dict(vit_state_dict_from_jax(
        _np_tree(jside["params"])))
    return jside, tmodel


def _torch_grads(tmodel, images, labels):
    tmodel.zero_grad(set_to_none=True)
    loss = tvit.loss_fn(tmodel, torch.from_numpy(images),
                        torch.from_numpy(labels))
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in tmodel.named_parameters()}


# f32: summation order only (measured on CPU, jax 0.9, torch 2.13: logits
# at most 1.0e-6 apart at up to 1.48).  bf16: the residual stream, every
# Dense output and the patch embedding round to bf16 at other points in
# the two frameworks; measured at most 0.0112 apart at logits up to 1.48,
# under two bf16 ulps; 3e-2 leaves ~3x.
_LOGIT_TOL = {"f32": dict(atol=1e-4, rtol=1e-4),
              "bf16": dict(atol=3e-2, rtol=3e-2)}


@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_logits_match_jax(dtype_name, shape):
    jside, tmodel = _models(dtype_name, shape)
    out = tmodel(torch.from_numpy(jside["images"]))
    ref = jside["logits"]
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), ref,
                               **_LOGIT_TOL[dtype_name])


@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_loss_and_every_gradient_match_jax(dtype_name, shape):
    jside, tmodel = _models(dtype_name, shape)
    ref_loss = jside["loss"]
    ref = vit_state_dict_from_jax(_np_tree(jside["grads"]))
    loss, grads = _torch_grads(tmodel, jside["images"], jside["labels"])
    assert set(grads) == set(ref)
    assert all(g.dtype == torch.float32 for g in grads.values())
    if dtype_name == "f32":
        # summation order only: measured loss 2.4e-7 apart, the worst
        # gradient 1.6e-6 of its tensor's largest element apart
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                       atol=1e-6, rtol=1e-4, err_msg=name)
    else:
        # bf16: gradients through bf16 activations are bf16-rounded on
        # both sides.  The JAX side's bias gradients are the furthest
        # from the f32 ones: measured h.0.attn_proj.bias 4.3% of its
        # largest element from the f32 gradient on the JAX side, 1.1% on
        # the port's, 4.4% apart; the loss 1.6e-3 apart at 2.13
        np.testing.assert_allclose(loss, ref_loss, atol=2e-2)
        for name, g in grads.items():
            scale = ref[name].abs().max().item()
            np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                       atol=8e-2 * scale, rtol=0,
                                       err_msg=name)


def _cos(a, b):
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_adamw_step_matches_optax(dtype_name):
    """One step of adamw(3e-4, weight_decay=0.01) on both sides.  Adam
    divides each element by its own gradient's size, so an element whose
    gradient is near eps (1e-8) magnifies the frameworks' rounding: the
    key third of ``attn_qkv.bias``, whose exact gradient is 0 (a key bias
    shifts every score of a query alike), is left out of the direction
    checks.  f32 is held element by element at 1e-4 of a change of
    ~3e-4, and every parameter's change by direction; bf16, whose
    gradients are bf16-rounded, by direction over all changes and per
    parameter."""
    jside, tmodel = _models(dtype_name, "h2d32")
    params = jside["params"]
    tx = optax.adamw(_LR, weight_decay=0.01)
    updates, _ = tx.update(jside["grads"], tx.init(params), params)
    after = vit_state_dict_from_jax(_np_tree(
        optax.apply_updates(params, updates)))
    before = vit_state_dict_from_jax(_np_tree(params))
    opt = adamw(tmodel.parameters(), lr=_LR, weight_decay=0.01)
    _torch_grads(tmodel, jside["images"], jside["labels"])
    opt.step()
    e = tmodel.config.embed_dim
    ups = {}
    for name, p in tmodel.named_parameters():
        t, j = (p.detach() - before[name]).numpy(), \
            (after[name] - before[name]).numpy()
        if dtype_name == "f32":
            np.testing.assert_allclose(t, j, atol=1e-4, rtol=0,
                                       err_msg=name)
        if name.endswith("attn_qkv.bias"):
            t, j = np.delete(t, np.s_[e:2 * e]), np.delete(j, np.s_[e:2 * e])
        assert _cos(t, j) > (0.9999 if dtype_name == "f32" else 0.95), name
        ups[name] = (t, j)
    t_all = np.concatenate([t.ravel() for t, _ in ups.values()])
    j_all = np.concatenate([j.ravel() for _, j in ups.values()])
    assert _cos(t_all, j_all) > 0.99


def test_reference_attention_matches_flash_path():
    """attn_impl="reference" (autograd through plain attention) against
    the default flash path (the kernels' plain backward on the CPU)."""
    jside, tflash = _models("f32", "h2d64")
    images, labels = jside["images"], jside["labels"]
    loss, ref = _torch_grads(tflash, images, labels)
    _, tplain = _models("f32", "h2d64", attn_impl="reference")
    loss_p, grads = _torch_grads(tplain, images, labels)
    np.testing.assert_allclose(loss_p, loss, rtol=1e-6)
    for name, g in grads.items():
        torch.testing.assert_close(g, ref[name], atol=1e-6, rtol=1e-4,
                                   msg=name)


@pytest.mark.parametrize("preset", ["base", "large", "tiny"])
def test_config_presets_match_jax(preset):
    jcfg = getattr(jvit.ViTConfig, preset)()
    tcfg = getattr(tvit.ViTConfig, preset)()
    for field in dataclasses.fields(jcfg):
        if field.name not in ("dtype", "param_dtype"):
            assert getattr(tcfg, field.name) == getattr(jcfg, field.name)
    assert (tcfg.dtype, tcfg.param_dtype) == (torch.bfloat16,
                                              torch.float32)
    assert tcfg.num_patches == jcfg.num_patches


def test_parameters_match_flax_init():
    """Same names, shapes and counts as the flax tree; the flax init's
    scales (normal(0.02) kernels and position embedding, zero CLS and
    biases, unit norm scales), all in f32."""
    jcfg = jvit.ViTConfig.tiny(embed_dim=128)
    params = _unbox(jvit.ViT(jcfg).init_params(jax.random.PRNGKey(0)))
    ref = vit_state_dict_from_jax(_np_tree(params))
    model = tvit.ViT(tvit.ViTConfig.tiny(embed_dim=128), device="cpu",
                     generator=torch.Generator().manual_seed(1))
    got = dict(model.named_parameters())
    assert {n: tuple(p.shape) for n, p in got.items()} == \
        {n: tuple(t.shape) for n, t in ref.items()}
    assert all(p.dtype == torch.float32 for p in got.values())
    assert got["cls"].eq(0).all() and got["h.0.attn_qkv.bias"].eq(0).all()
    assert got["h.1.ln_2.weight"].eq(1).all()
    for name in ("h.0.mlp_up.weight", "pos_embed", "patch_embed.weight"):
        assert abs(got[name].std().item() - 0.02) < 2e-3, name
