"""The port's sparse-MoE transformer against the JAX package's, on the CPU.

Same weights (the flax init, every parameter then perturbed with seeded
numpy noise so that zero biases cannot hide a fault, converted by
``moe_state_dict_from_jax``), same tokens (numpy, seeded).  Off-TPU the
JAX model's flash_attention takes its jnp reference, so this holds the
model, its routing, the loss with the router aux loss and the optimizer;
the kernels at the tiny MoE's attention shape are held against the
Pallas kernels in test_torch_ops.py.

Configs (``_SHAPES``): ``tiny()``, 2 heads of 32 (head-major kernels), 4
experts top-2; ``tiny(embed_dim=128)``, 2 heads of 64 (native layout);
``tiny(capacity_factor=0.5)``, where most choices overflow their
expert's buffer and are dropped.  2 x 16 tokens: G = 32 routed together,
64 choices a layer, capacity 20 (8 at factor 0.5).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.models import moe as jmoe
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models.convert import moe_state_dict_from_jax
from ray_tpu_torch.models.gpt2 import adamw

_SHAPES = {"h2d32": {}, "h2d64": dict(embed_dim=128),
           "drops": dict(capacity_factor=0.5)}
_DTYPES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16)}
_BATCH, _SEQ = 2, 16
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
    value (zeros for biases, ones for norm scales)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(
        np.asarray(x) + scale * rng.standard_normal(x.shape), x.dtype), tree)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_routing(logits, top_k):
    """The JAX layer's routing (moe.py:94-110) from its router's logits,
    with the same jax ops: expert indices and buffer positions."""
    probs = jax.nn.softmax(logits.astype(jnp.float32), axis=-1)
    _, idx = jax.lax.top_k(probs, top_k)
    g, e = logits.shape
    onehot = jax.nn.one_hot(idx, e, dtype=jnp.int32)
    flat = onehot.reshape(g * top_k, e)
    pos = (jnp.cumsum(flat, axis=0) - flat).reshape(g, top_k, e)
    return np.asarray(idx), np.asarray(jnp.sum(pos * onehot, axis=-1))


@functools.lru_cache(maxsize=None)
def _jax_side(dtype_name, shape):
    """The JAX model's perturbed parameters, tokens, logits, loss,
    gradients, each layer's sown aux loss and routing, for one config
    (jitted, computed once per config)."""
    jcfg = jmoe.MoEConfig.tiny(dtype=_DTYPES[dtype_name][0],
                               **_SHAPES[shape])
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (_BATCH, _SEQ),
                          dtype=np.int32)
    jmodel = jmoe.MoETransformer(jcfg)
    params = _perturb(_unbox(jax.jit(
        lambda key: jmodel.init_params(key, batch=1, seq=_SEQ))(
            jax.random.PRNGKey(0))))

    @jax.jit
    def hidden(p):
        return jmodel.apply(
            {"params": p}, tokens, method=jmoe.MoETransformer.hidden,
            mutable=["intermediates"],
            capture_intermediates=lambda mdl, _: mdl.name == "router")

    _, state = hidden(params)
    layers = state["intermediates"]
    aux = [float(layers[f"h{i}"]["moe"]["aux_loss"][0])
           for i in range(jcfg.num_layers)]
    routing = [_jax_routing(layers[f"h{i}"]["moe"]["router"]["__call__"][0],
                            jcfg.top_k) for i in range(jcfg.num_layers)]
    logits = jax.jit(lambda p: jmodel.apply({"params": p}, tokens))(params)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: jmoe.loss_fn(jmodel, p, tokens)))(params)
    return dict(params=params, tokens=tokens, logits=np.asarray(logits),
                loss=float(loss), grads=grads, aux=aux, routing=routing)


def _models(dtype_name, shape, **torch_kw):
    """The JAX side of one config and a fresh port model with its
    weights."""
    jside = _jax_side(dtype_name, shape)
    tcfg = tmoe.MoEConfig.tiny(dtype=_DTYPES[dtype_name][1],
                               **_SHAPES[shape], **torch_kw)
    tmodel = tmoe.MoETransformer(tcfg, device="cpu")
    tmodel.load_state_dict(moe_state_dict_from_jax(
        _np_tree(jside["params"])))
    return jside, tmodel


def _torch_grads(tmodel, tokens):
    tmodel.zero_grad(set_to_none=True)
    loss = tmoe.loss_fn(tmodel, torch.from_numpy(tokens))
    loss.backward()
    return loss.item(), {n: p.grad.clone()
                         for n, p in tmodel.named_parameters()}


def _port_routing(tmodel, tokens):
    with torch.no_grad():
        return tmodel.hidden(torch.from_numpy(tokens))[2]


def _routed_alike(routings, jside):
    """[G] bool: tokens whose experts and buffer positions are the JAX
    layer's in every layer."""
    alike = np.ones(_BATCH * _SEQ, bool)
    for r, (idx, slots) in zip(routings, jside["routing"]):
        alike &= (r.experts.numpy() == idx).all(1)
        alike &= (r.slots.numpy() == slots).all(1)
    return alike


@pytest.mark.parametrize("shape", _SHAPES)
def test_routing_matches_jax_exactly_f32(shape):
    """f32: every layer's expert indices and buffer positions equal the
    JAX layer's, and the choices past capacity are dropped alike (every
    config drops some: measured 17, 25 and 76 of the two layers' 128).
    The aux loss is held to three f32 ulps: the two frameworks' softmax
    and mean sum in other orders (measured equal in 3 of 6 layers, one
    or two ulps, at most 1.6e-7 relative, apart in the others)."""
    jside, tmodel = _models("f32", shape)
    routings = _port_routing(tmodel, jside["tokens"])
    assert _routed_alike(routings, jside).all()
    capacity = tmodel.config.capacity(_BATCH * _SEQ)
    dropped = 0
    for r, aux in zip(routings, jside["aux"]):
        np.testing.assert_allclose(r.aux.item(), aux, rtol=2.4e-7, atol=0)
        dropped += int((r.slots >= capacity).sum())
    assert dropped > 0


@pytest.mark.parametrize("shape", _SHAPES)
def test_routing_share_bf16(shape):
    """bf16: the router's logits are bf16 on both sides and its input
    (ln_2's f32 output) differs by bf16 rounding upstream, so a token
    whose top probabilities nearly tie can go the other way, and the
    positions of later tokens in that expert's buffer move.  Measured:
    every token of h2d32 and drops routed alike; in h2d64, one token of
    32 (layer 1, its second and third choices 0.2105 and 0.2085 apart,
    one bf16 ulp of their logits).  At least 90% is required, and the
    aux losses within 1%."""
    jside, tmodel = _models("bf16", shape)
    routings = _port_routing(tmodel, jside["tokens"])
    assert _routed_alike(routings, jside).mean() >= 0.9
    for r, aux in zip(routings, jside["aux"]):
        np.testing.assert_allclose(r.aux.item(), aux, rtol=1e-2)


# f32: summation order only (measured at most 1.5e-6 apart at logits up
# to 2.9).  bf16: activations, dense products and the router's logits
# round to bf16 at other points in the two frameworks (measured at most
# 0.0144 apart, two bf16 ulps at 2.9), and a token routed otherwise
# (above) has other logits altogether: its rows are left out.
_LOGIT_TOL = {"f32": dict(atol=1e-4, rtol=1e-4),
              "bf16": dict(atol=3e-2, rtol=3e-2)}


@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_logits_match_jax(dtype_name, shape):
    jside, tmodel = _models(dtype_name, shape)
    with torch.no_grad():
        out = tmodel(torch.from_numpy(jside["tokens"]))
    ref = jside["logits"]
    assert out.dtype == torch.float32 and out.shape == ref.shape
    alike = _routed_alike(_port_routing(tmodel, jside["tokens"]),
                          jside).reshape(_BATCH, _SEQ)
    if dtype_name == "f32":
        assert alike.all()
    np.testing.assert_allclose(out.numpy()[alike], ref[alike],
                               **_LOGIT_TOL[dtype_name])


@pytest.mark.parametrize("shape", _SHAPES)
@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_loss_and_every_gradient_match_jax(dtype_name, shape):
    """The loss with every layer's aux loss, and the gradient of every
    parameter, the router's and the stacked experts' included."""
    jside, tmodel = _models(dtype_name, shape)
    ref = moe_state_dict_from_jax(_np_tree(jside["grads"]))
    loss, grads = _torch_grads(tmodel, jside["tokens"])
    assert set(grads) == set(ref)
    assert all(g.dtype == torch.float32 for g in grads.values())
    if dtype_name == "f32":
        # summation order only: measured the loss 1.4e-6 apart at 5.6
        # (under two f32 ulps), the worst gradient 1.1e-6 of its
        # tensor's largest element
        np.testing.assert_allclose(loss, jside["loss"], rtol=1e-6)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                       atol=1e-6, rtol=1e-4, err_msg=name)
    else:
        # bf16, held as the ViT test holds it: measured the loss 5.7e-4
        # apart, the worst gradient 3.2% of its tensor's largest element
        # (the router's bias, with h2d64's one token routed otherwise)
        np.testing.assert_allclose(loss, jside["loss"], atol=2e-2)
        for name, g in grads.items():
            scale = ref[name].abs().max().item()
            np.testing.assert_allclose(g.numpy(), ref[name].numpy(),
                                       atol=8e-2 * scale, rtol=0,
                                       err_msg=name)


def _cos(a, b):
    return float((a * b).sum() / np.sqrt((a * a).sum() * (b * b).sum()))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
def test_adamw_step_matches_optax(dtype_name):
    """One step of adamw(3e-4, weight_decay=0.01) on both sides, held as
    the ViT test holds it: f32 element by element at 1e-4 of a change of
    ~3e-4, and by direction per parameter (the key third of
    ``attn_qkv.bias``, whose exact gradient is 0, left out); bf16 by
    direction."""
    jside, tmodel = _models(dtype_name, "h2d32")
    params = jside["params"]
    tx = optax.adamw(_LR, weight_decay=0.01)
    updates, _ = tx.update(jside["grads"], tx.init(params), params)
    after = moe_state_dict_from_jax(_np_tree(
        optax.apply_updates(params, updates)))
    before = moe_state_dict_from_jax(_np_tree(params))
    opt = adamw(tmodel.parameters(), lr=_LR, weight_decay=0.01)
    _torch_grads(tmodel, jside["tokens"])
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


def test_top_k_ties_take_the_lower_expert_first():
    """jax.lax.top_k puts the lower index first on ties; so does route(),
    whatever order torch's sort kernel would otherwise give."""
    logits = torch.tensor([[1.0, 3.0, 3.0, 3.0], [2.0, 2.0, 2.0, 2.0],
                           [0.5, 0.5, 1.0, 0.5]]).to(torch.bfloat16)
    r = tmoe.route(logits, 2, 0.01)
    _, idx = jax.lax.top_k(jax.nn.softmax(
        jnp.asarray(logits.float().numpy())), 2)
    np.testing.assert_array_equal(r.experts.numpy(), np.asarray(idx))
    assert r.experts.tolist() == [[1, 2], [0, 1], [2, 0]]


def test_reference_attention_matches_flash_path():
    """attn_impl="reference" (autograd through plain attention) against
    the default flash path (the kernels' plain backward on the CPU)."""
    jside, tflash = _models("f32", "h2d64")
    loss, ref = _torch_grads(tflash, jside["tokens"])
    _, tplain = _models("f32", "h2d64", attn_impl="reference")
    loss_p, grads = _torch_grads(tplain, jside["tokens"])
    np.testing.assert_allclose(loss_p, loss, rtol=1e-6)
    for name, g in grads.items():
        torch.testing.assert_close(g, ref[name], atol=1e-6, rtol=1e-4,
                                   msg=name)


@pytest.mark.parametrize("preset", ["default", "tiny"])
def test_config_presets_match_jax(preset):
    jcfg = jmoe.MoEConfig() if preset == "default" else jmoe.MoEConfig.tiny()
    tcfg = tmoe.MoEConfig() if preset == "default" else tmoe.MoEConfig.tiny()
    for field in dataclasses.fields(jcfg):
        if field.name not in ("dtype", "param_dtype"):
            assert getattr(tcfg, field.name) == getattr(jcfg, field.name)
    assert (tcfg.dtype, tcfg.param_dtype) == (torch.bfloat16,
                                              torch.float32)
    assert tcfg.num_params() == jcfg.num_params()
    assert tcfg.active_params_per_token() == jcfg.active_params_per_token()
    # the layer's own capacity arithmetic at the chip run's 8 x 1024
    assert tcfg.capacity(8 * 1024) == max(
        1, int(jcfg.capacity_factor * 8 * 1024 * jcfg.top_k
               / jcfg.num_experts))


def test_parameters_match_flax_init():
    """Same names and shapes as the flax tree; the flax init's scales,
    all in f32."""
    jcfg = jmoe.MoEConfig.tiny()
    params = _unbox(jmoe.MoETransformer(jcfg).init_params(
        jax.random.PRNGKey(0), batch=1, seq=8))
    ref = moe_state_dict_from_jax(_np_tree(params))
    model = tmoe.MoETransformer(tmoe.MoEConfig.tiny(vocab_size=4096),
                                device="cpu",
                                generator=torch.Generator().manual_seed(1))
    got = dict(model.named_parameters())
    assert set(got) == set(ref)
    assert all(tuple(got[n].shape) == tuple(ref[n].shape)
               for n in got if n != "wte")
    assert all(p.dtype == torch.float32 for p in got.values())
    assert abs(got["wte"].std().item() - 0.02) < 1e-3
    assert abs(got["wpe"].std().item() - 0.01) < 1e-3
    assert abs(got["h.0.moe.up"].std().item() - 0.02) < 1e-3
    assert got["h.0.moe.router.bias"].eq(0).all()
    assert got["h.1.ln_2.weight"].eq(1).all()


def test_standalone_layer_draws_the_flax_init_and_matches_it():
    """``SparseMoEMLP`` on its own, as ``ray_tpu_torch.models`` exports
    it: its parameters are drawn as the flax layer draws them
    (normal(0.02), a zero router bias) with no transformer around it,
    and on the flax layer's perturbed weights it computes that layer's
    output and aux loss, in f32."""
    jcfg = jmoe.MoEConfig.tiny(dtype=jnp.float32, embed_dim=128)
    tcfg = tmoe.MoEConfig.tiny(dtype=torch.float32, embed_dim=128)
    layer = tmoe.SparseMoEMLP(tcfg, device="cpu")
    again = tmoe.SparseMoEMLP(tcfg, device="cpu",
                              generator=torch.Generator().manual_seed(0))
    for (name, p), q in zip(layer.named_parameters(), again.parameters()):
        assert p.dtype == torch.float32 and torch.equal(p, q), name
    assert layer.router.bias.eq(0).all()
    for p in (layer.router.weight, layer.up, layer.down):
        assert abs(p.mean().item()) < 2e-3
        assert abs(p.std().item() - 0.02) < 2e-3

    x = np.random.default_rng(3).standard_normal(
        (_BATCH, _SEQ, jcfg.embed_dim)).astype(np.float32)
    jlayer = jmoe.SparseMoEMLP(jcfg)
    params = _perturb(_unbox(jlayer.init(jax.random.PRNGKey(0),
                                         x)["params"]))
    ref, state = jlayer.apply({"params": params}, x,
                              mutable=["intermediates"])
    p = _np_tree(params)
    layer.load_state_dict({
        "router.weight": torch.tensor(p["router"]["kernel"].T),
        "router.bias": torch.tensor(p["router"]["bias"]),
        "up": torch.tensor(p["up"]), "down": torch.tensor(p["down"])})
    with torch.no_grad():
        out, routing = layer(torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-4,
                               rtol=1e-4)
    assert routing.aux.item() == pytest.approx(
        float(state["intermediates"]["aux_loss"][0]), rel=1e-6)
