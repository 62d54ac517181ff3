"""The port's ResNet against the JAX package's, on the CPU.

ResNet-18 (``ResNetConfig.resnet18()``, 10 classes) on 2 NHWC images of
32 x 32 x 3, as in CIFAR-10: the stride-2 stages see even sizes, where
flax's SAME padding is (0, 1).  Same weights (the flax init, then every
parameter and BatchNorm statistic perturbed with seeded numpy noise, so
that the zero-initialised last scale of each block cannot hide its
branch, converted by ``resnet_state_dict_from_jax``), same images and
labels (numpy, seeded).  The JAX package has no ResNet loss; both sides
take the mean softmax cross entropy of the logits.  The JAX model runs
no Pallas kernel, and the port none of its own.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from ray_tpu.models import resnet as jresnet
from ray_tpu_torch.models import conv as tconv
from ray_tpu_torch.models import resnet as tresnet
from ray_tpu_torch.models.convert import resnet_state_dict_from_jax
from ray_tpu_torch.models.gpt2 import adamw

_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}
_BATCH, _SIZE = 2, 32
_LR = 3e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(variables, seed=1):
    """Every parameter plus normal noise (std 0.05); running means plus
    noise (std 0.1) and running variances scaled by a factor in
    [0.5, 1.5], so that eval mode reads statistics of its own."""
    rng = np.random.default_rng(seed)
    params = jax.tree.map(lambda x: jnp.asarray(
        np.asarray(x) + 0.05 * rng.standard_normal(x.shape), x.dtype),
        variables["params"])

    def stat(path, x):
        x = np.asarray(x)
        if path[-1].key == "var":
            return jnp.asarray(x * rng.uniform(0.5, 1.5, x.shape), x.dtype)
        return jnp.asarray(x + 0.1 * rng.standard_normal(x.shape), x.dtype)

    return params, jax.tree_util.tree_map_with_path(
        stat, variables["batch_stats"])


def _jax_loss(logits, labels):
    return optax.softmax_cross_entropy_with_integer_labels(
        logits, labels).mean()


@functools.lru_cache(maxsize=None)
def _jax_side(dtype_name):
    """The JAX model's perturbed variables, inputs, and for one training
    step and one evaluation: logits, loss, gradients and the updated
    batch statistics (jitted, computed once per dtype)."""
    cfg = jresnet.ResNetConfig.resnet18(dtype=_DTYPES[dtype_name][0])
    rng = np.random.default_rng(0)
    images = rng.standard_normal((_BATCH, _SIZE, _SIZE, 3)).astype(
        np.float32)
    labels = rng.integers(0, cfg.num_classes, _BATCH).astype(np.int32)
    model = jresnet.ResNet(cfg)
    params, stats = _perturb(jax.jit(
        lambda key: model.init(key, images, train=False))(
            jax.random.PRNGKey(0)))

    @jax.jit
    def train_loss(p):
        logits, new = model.apply(
            {"params": p, "batch_stats": stats}, images, train=True,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=True)
        return _jax_loss(logits, labels), (logits, new)

    (loss, (logits, new)), grads = jax.value_and_grad(
        train_loss, has_aux=True)(params)
    eval_logits = jax.jit(lambda p: model.apply(
        {"params": p, "batch_stats": stats}, images, train=False))(params)
    return dict(params=params, stats=stats, images=images, labels=labels,
                loss=float(loss), logits=np.asarray(logits), grads=grads,
                new_stats=new["batch_stats"],
                relu_inputs=_relu_inputs(new["intermediates"]),
                eval_logits=np.asarray(eval_logits))


def _relu_inputs(inter):
    """What each ReLU of the flax model's training step took, in the
    order the port applies them (the stem's, then each block's two), as
    [B, C, H, W] arrays: recomputed from the captured outputs of its
    BatchNorms and blocks with the same f32 adds."""
    def out(tree):
        return np.asarray(tree["__call__"][0])

    x = out(inter["BatchNorm_0"])
    pre = [x]
    x = np.maximum(x, 0)
    i = 0
    while f"BasicBlock_{i}" in inter:
        block = inter[f"BasicBlock_{i}"]
        pre.append(out(block["BatchNorm_0"]))
        residual = out(block["BatchNorm_2"]) if "BatchNorm_2" in block \
            else x
        pre.append(residual + out(block["BatchNorm_1"]))
        x = out(block)
        i += 1
    return [p.transpose(0, 3, 1, 2) for p in pre]


def _models(dtype_name):
    jside = _jax_side(dtype_name)
    tmodel = tresnet.ResNet(tresnet.ResNetConfig.resnet18(
        dtype=_DTYPES[dtype_name][1]), device="cpu")
    tmodel.load_state_dict(resnet_state_dict_from_jax(
        _np_tree(jside["params"]), _np_tree(jside["stats"])))
    return jside, tmodel


def _torch_train_step(tmodel, jside, monkeypatch):
    """Loss and gradients of one training-mode step (which also moves
    the running statistics), each ReLU taking the flax model's decision.

    ReLU's gradient jumps at 0, so a pre-activation within rounding of 0
    can fall either way, and every gradient before it then differs: in
    f32 one of the step's 0.8 M pre-activations, 3.9e-7 in the port
    against -6.1e-7 in flax (measured), moves the gradients of the first
    six blocks by up to 27% of their largest element.  So the port's
    ReLUs apply flax's masks, and each ReLU where the two disagree must
    be such a tie: its input within ``tie`` of 0 on both sides."""
    jax_pre = iter(jside["relu_inputs"])
    ties = []
    tie = 1e-5 if tmodel.config.dtype == torch.float32 else 5e-2

    def relu(x):
        ref = torch.from_numpy(np.array(next(jax_pre)))
        keep = ref > 0
        flips = keep != (x > 0)
        assert x.detach()[flips].abs().le(tie).all() and \
            ref[flips].abs().le(tie).all(), "a ReLU decision that is no tie"
        ties.append(int(flips.sum()))
        return x * keep

    monkeypatch.setattr(F, "relu", relu)
    tmodel.zero_grad(set_to_none=True)
    logits = tmodel(torch.from_numpy(jside["images"]), train=True)
    loss = torch.nn.functional.cross_entropy(
        logits, torch.from_numpy(jside["labels"]).long())
    loss.backward()
    monkeypatch.undo()
    assert next(jax_pre, None) is None and len(ties) == 17
    return logits.detach(), loss.item(), {
        n: p.grad.clone() for n, p in tmodel.named_parameters()}


def _buffers(tmodel):
    return {n: b.clone() for n, b in tmodel.named_buffers()}


# f32: summation order only (measured logits 6.6e-7 apart at up to 1.27
# in training, 3.6e-7 at up to 1.72 in evaluation).  bf16: every
# convolution rounds its input, kernel and output to bf16 on both sides,
# after f32 sums taken in other orders: measured 0.0041 and 0.0032.
_TOL = {"f32": dict(atol=1e-4, rtol=1e-4), "bf16": dict(atol=2e-2, rtol=0)}


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_train_step_matches_flax(dtype_name, monkeypatch):
    """Training mode: logits from the batch's statistics, the loss,
    every gradient (every kernel, BatchNorm scale and bias, the head),
    and every running mean and variance after the step's update
    (0.9 * running + 0.1 * the batch's, with its biased variance)."""
    jside, tmodel = _models(dtype_name)
    logits, loss, grads = _torch_train_step(tmodel, jside, monkeypatch)
    np.testing.assert_allclose(logits.numpy(), jside["logits"],
                               **_TOL[dtype_name])
    ref = resnet_state_dict_from_jax(_np_tree(jside["grads"]),
                                     _np_tree(jside["new_stats"]))
    assert set(grads) | set(_buffers(tmodel)) == set(ref)
    if dtype_name == "f32":
        # summation order only: measured the loss 2.4e-7 apart, the
        # worst gradient 4.3e-6 of its tensor's largest element, the
        # worst running statistic 1.7e-6 apart
        np.testing.assert_allclose(loss, jside["loss"], rtol=1e-6)
        grad_tol, stat_tol = 1e-5, dict(atol=1e-6, rtol=1e-5)
    else:
        # bf16 convolutions: measured the loss 3.0e-4 apart, the worst
        # gradient 2.0% of its tensor's largest element, the worst
        # running statistic 5.8e-3 apart (ReLU ties, below, up to 151 of
        # a layer's inputs, all within 0.032 of 0)
        np.testing.assert_allclose(loss, jside["loss"], atol=2e-2)
        grad_tol, stat_tol = 5e-2, dict(atol=1e-2, rtol=1e-2)
    for name, g in grads.items():
        scale = ref[name].abs().max().item()
        np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                   atol=grad_tol * scale, rtol=0,
                                   err_msg=name)
    for name, b in _buffers(tmodel).items():
        np.testing.assert_allclose(b.numpy(), ref[name].numpy(),
                                   err_msg=name, **stat_tol)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_eval_matches_flax(dtype_name):
    """Evaluation mode normalises with the (perturbed) running statistics
    and leaves them as they were."""
    jside, tmodel = _models(dtype_name)
    before = _buffers(tmodel)
    with torch.no_grad():
        logits = tmodel(torch.from_numpy(jside["images"]), train=False)
    np.testing.assert_allclose(logits.numpy(), jside["eval_logits"],
                               **_TOL[dtype_name])
    for name, b in _buffers(tmodel).items():
        assert torch.equal(b, before[name]), name


@pytest.mark.parametrize("size,kernel,stride", [
    (32, 3, 1), (32, 3, 2), (7, 3, 2), (32, 1, 2), (224, 16, 16),
    (32, 8, 8), (30, 16, 16), (5, 4, 1)])
def test_same_padding_matches_lax(size, kernel, stride):
    assert tconv.same_padding(size, kernel, stride) == tuple(
        jax.lax.padtype_to_pads((size,), (kernel,), (stride,), "SAME")[0])


def test_stride2_convolution_pads_as_flax():
    """At stride 2 on an even input flax pads (0, 1): output (0, 1) reads
    input column 2 with its top-left tap, not column 1 as torch's
    padding=1 would (which shifts a whole stage by one pixel)."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 8, 8, 3)).astype(np.float32)
    w = rng.standard_normal((3, 3, 3, 4)).astype(np.float32)
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    wt = torch.from_numpy(w).permute(3, 2, 0, 1)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = tconv.conv2d_same(xt, wt, 2, torch.float32).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5,
                               rtol=1e-5)
    torch_pad = F.conv2d(xt, wt, stride=2, padding=1).permute(0, 2, 3, 1)
    assert not np.allclose(torch_pad.numpy(), np.asarray(ref), atol=1e-2)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_adamw_step_matches_optax(dtype_name, monkeypatch):
    """One step of adamw(3e-4, weight_decay=0.01) on ResNet-18 at 2 x 32
    x 32.  Adam moves each element by about lr times its gradient's
    sign, so an element whose gradient is near eps (1e-8) magnifies the
    frameworks' rounding, up to 2 lr for a sign.  f32, measured: every
    change within 1.05e-4 of optax's (one element of
    blocks.1.conv1.weight; the rest within 2e-5), every parameter's
    change at cosine >= 0.999998; held at 2e-4 and 0.9999.  bf16:
    gradients rounded to bf16 on both sides; measured all changes
    together at cosine 0.993 with optax's, mean |diff| 0.79% of the mean
    change, the worst parameter a 64-wide BatchNorm bias at cosine 0.84;
    held at 0.99, 2%, 2 lr and 0.8."""
    jside, tmodel = _models(dtype_name)
    params = jside["params"]
    tx = optax.adamw(_LR, weight_decay=0.01)
    updates, _ = tx.update(jside["grads"], tx.init(params), params)
    after = resnet_state_dict_from_jax(
        _np_tree(optax.apply_updates(params, updates)),
        _np_tree(jside["stats"]))
    before = resnet_state_dict_from_jax(_np_tree(params),
                                        _np_tree(jside["stats"]))
    opt = adamw(tmodel.parameters(), lr=_LR, weight_decay=0.01)
    _torch_train_step(tmodel, jside, monkeypatch)
    opt.step()
    t_all, j_all = [], []
    for name, p in tmodel.named_parameters():
        t = (p.detach() - before[name]).numpy().ravel()
        j = (after[name] - before[name]).numpy().ravel()
        if dtype_name == "f32":
            np.testing.assert_allclose(t, j, atol=2e-4, rtol=0,
                                       err_msg=name)
        cos = float(t @ j / np.sqrt((t @ t) * (j @ j)))
        assert cos > (0.9999 if dtype_name == "f32" else 0.8), (name, cos)
        t_all.append(t)
        j_all.append(j)
    t_all, j_all = np.concatenate(t_all), np.concatenate(j_all)
    assert float(t_all @ j_all / np.sqrt((t_all @ t_all)
                                         * (j_all @ j_all))) > 0.99
    assert np.abs(t_all - j_all).mean() < 0.02 * np.abs(j_all).mean()
    assert np.abs(t_all - j_all).max() <= 2 * _LR * 1.01


@pytest.mark.parametrize("preset", ["resnet18", "resnet50"])
def test_config_presets_match_jax(preset):
    jcfg = getattr(jresnet.ResNetConfig, preset)()
    tcfg = getattr(tresnet.ResNetConfig, preset)()
    for field in dataclasses.fields(jcfg):
        if field.name != "dtype":
            assert getattr(tcfg, field.name) == getattr(jcfg, field.name)
    assert tcfg.dtype == torch.bfloat16


def test_parameters_match_flax_init():
    """Same names and shapes as flax's params and batch_stats, f32; the
    flax init: zero last scale in every block, unit other scales, zero
    biases, unit running variances, LeCun-normal kernels."""
    jside = _jax_side("f32")
    ref = resnet_state_dict_from_jax(_np_tree(jside["params"]),
                                     _np_tree(jside["stats"]))
    model = tresnet.ResNet(tresnet.ResNetConfig.resnet18(), device="cpu",
                           generator=torch.Generator().manual_seed(1))
    got = dict(model.state_dict())
    assert {n: tuple(t.shape) for n, t in got.items()} == \
        {n: tuple(t.shape) for n, t in ref.items()}
    assert all(t.dtype == torch.float32 for t in got.values())
    assert got["blocks.0.bn2.weight"].eq(0).all()
    assert got["blocks.0.bn1.weight"].eq(1).all()
    assert got["blocks.2.proj_bn.running_var"].eq(1).all()
    assert "blocks.1.proj.weight" not in got  # same shape: no projection
    w = got["blocks.2.conv1.weight"]  # fan_in 64 * 9
    assert abs(w.std().item() - (64 * 9) ** -0.5) < 2e-3
    assert w.abs().max().item() <= 2 * (64 * 9) ** -0.5 / 0.8796 + 1e-6


def test_cross_replica_batchnorm_raises():
    with pytest.raises(NotImplementedError, match="parallel layer"):
        tresnet.ResNet(tresnet.ResNetConfig.resnet18(), device="cpu",
                       axis_name="dp")
