"""The port's sharding presets on DTensor (``ray_tpu_torch.parallel.
sharding``) against the JAX package's, on the CPU.

The rules and each parameter's spec are compared directly: for GPT-2,
Llama, ViT and the MoE, every parameter's spec under each of the five
presets against the ``PartitionSpec`` the JAX model's
``nn.with_partitioning`` names give, with the port's layout applied (a
flax Dense ``kernel [in, out]`` is ``weight [out, in]``, a conv kernel
``[kh, kw, in, out]`` is ``[out, in, kh, kw]``).

The sharded programs run as 4 gloo processes, one rank each
(``_gloo_worker``, once per module), against the JAX package on 4 of the
virtual CPU devices: GPT-2 tiny at fsdp = 2 x tp = 2 (each preset, and
SP_RULES with the ring at sp = 2 x tp = 2), the MoE at ep = 4,
cross-replica BatchNorm at dp = 4, flash attention on head-split
DTensors against the Pallas kernels in interpret mode (``native=`` for
each family), Llama's and ViT's forward on parameters placed under each
of the five presets at fsdp = 2 x tp = 2 (RMSNorm's kernel and the patch
convolution on each rank's rows), and the kernel entry points refusing a
DTensor.  The JAX
models' flash attention takes its jnp reference off the TPU, as in
tests/test_torch_gpt2.py; the port's takes its plain version on the CPU.

Inputs are made with numpy from seeds.  Tolerances are
tests/test_parallel.py's: 2e-5 for outputs and losses, 2e-4 for
gradients (f32; the two differ in summation order only).
"""

import dataclasses
import functools
import importlib
import os
import re
import socket
import traceback

import flax
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.multiprocessing as mp
import torch.nn.functional as F
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.models import llama as jllama
from ray_tpu.models import moe as jmoe
from ray_tpu.models import resnet as jresnet
from ray_tpu.models import vit as jvit
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import build_mesh as jbuild_mesh
from ray_tpu.parallel import sharding as jsharding
from ray_tpu.parallel.mesh import use_mesh as juse_mesh
from ray_tpu_torch import parallel as tparallel
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models import llama as tllama
from ray_tpu_torch.models import moe as tmoe
from ray_tpu_torch.models import resnet as tresnet
from ray_tpu_torch.models import vit as tvit
from ray_tpu_torch.models.convert import (gpt2_state_dict_from_jax,
                                          llama_state_dict_from_jax,
                                          moe_state_dict_from_jax,
                                          resnet_state_dict_from_jax,
                                          vit_state_dict_from_jax)
from ray_tpu_torch.parallel import sharding as tsharding

jax_fa = importlib.import_module("ray_tpu.ops.flash_attention")
torch_fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

RANKS = 4
OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
# GPT-2 tiny in f32 on 4 x 16 tokens; head_chunk 16 splits the 60
# predicted positions into 3 full chunks and one padded one
GPT2_TOKENS, GPT2_CHUNK = (4, 16), 16
# the same at sp = 2 with the ring: 2 x 32 tokens
SP_TOKENS = (2, 32)
# 255 rows over tp = 2 split unevenly (128 + 127)
UNEVEN_VOCAB = 255
MOE_TOKENS = (4, 16)
# ResNet: 2 images of 8 x 8 a rank, a narrow two-stage net
RESNET_KW = dict(stage_sizes=(1, 1), num_filters=8, num_classes=10,
                 dtype=jnp.float32)
RESNET_PER_RANK, RESNET_SIZE = 2, 8
# flash attention on DTensors: batch over fsdp, heads over tp; the
# native-layout family at head_dim 64 and the head-major one at 32
FLASH_SHAPES = {"nl": ((2, 128, 4, 64), True), "hm": ((2, 128, 4, 32),
                                                      False)}
TP_MESH = dict(fsdp=2, tp=2)
PLACED_BATCH = 4  # Llama's tokens [4, 16], ViT's images [4, 32, 32, 3]
#: XLA's LLVM backend at -O0 for the JAX references: the programs are
#: tiny, and compiling them is most of their time; the HLO, and so the
#: arithmetic, is the same
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _fast(fn):
    return jax.jit(fn, compiler_options=FAST_COMPILE)
SP_MESH = dict(sp=2, tp=2)


def _unbox(tree):
    return jax.tree.map(lambda x: x.unbox() if hasattr(x, "unbox") else x,
                        tree, is_leaf=lambda x: hasattr(x, "unbox"))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(params, seed):
    """Every parameter plus seeded noise, so that zero biases and unit
    norm scales hide nothing."""
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree.unflatten(tree, [
        x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
        for x in leaves])


def _jmesh(**axes):
    return jbuild_mesh(JMeshConfig(**axes), devices=jax.devices()[:RANKS])


def _pspec_to_port(spec, perm):
    """A PartitionSpec of a flax parameter as the port's spec of the
    same parameter, whose dim ``i`` is the flax dim ``perm[i]``."""
    out = {}
    for jdim, axes in enumerate(spec):
        for a in (() if axes is None else
                  (axes,) if isinstance(axes, str) else axes):
            out[a] = perm.index(jdim)
    return out


def _port_name(path):
    """The port's name of a flax parameter path (``h0/attn_qkv/kernel``
    is ``h.0.attn_qkv.weight``; ``layer0`` is ``layers.0``)."""
    parts = []
    for key in path:
        m = re.fullmatch(r"(h|layer)(\d+)", key)
        if m:
            parts += ["h" if m.group(1) == "h" else "layers", m.group(2)]
        else:
            parts.append("weight" if key in ("kernel", "scale") else key)
    return ".".join(parts)


def _perm(path, ndim):
    if path[-1] == "kernel":
        return (1, 0) if ndim == 2 else (3, 2, 0, 1)
    return tuple(range(ndim))


def _place(params, specs, mesh):
    flat = flax.traverse_util.flatten_dict(params)
    flat_specs = flax.traverse_util.flatten_dict(specs)
    return flax.traverse_util.unflatten_dict({
        k: jax.device_put(v, NamedSharding(mesh, flat_specs.get(k, P())))
        for k, v in flat.items()})


def _logical(abstract):
    return jax.tree.map(lambda x: tuple(x.names) if hasattr(x, "names")
                        else (), abstract,
                        is_leaf=lambda x: hasattr(x, "names"))


# ------------------------------------------------------- rules and specs --

def test_sharding_rules():
    got = tsharding.logical_to_mesh(tsharding.TP_RULES,
                                    {"w": ("embed", "mlp"),
                                     "b": ("mlp",)})
    want = jsharding.logical_to_mesh(jsharding.TP_RULES,
                                     {"w": ("embed", "mlp"),
                                      "b": ("mlp",)})
    assert got == {"w": {"fsdp": 0, "tp": 1}, "b": {"tp": 0}}
    for name in got:
        assert got[name] == _pspec_to_port(want[name],
                                           tuple(range(len(want[name]))))
    # a tuple rule shards one dim over two mesh axes, major first
    assert tsharding.DP_RULES.spec("batch", None) == {"dp": 0, "fsdp": 0}
    # "seq" under SP_RULES, "expert" under EP_RULES
    assert tsharding.SP_RULES.spec("batch", "seq") == {
        "dp": 0, "fsdp": 0, "sp": 1}
    assert tsharding.EP_RULES.spec("expert", "embed", "mlp") == {
        "ep": 0, "fsdp": 1, "tp": 2}
    assert tsharding.TP_RULES.merged(mlp=None).spec("mlp") == {}


@pytest.mark.parametrize("name", sorted(jsharding.PRESETS))
def test_presets_are_the_jax_presets(name):
    assert tsharding.PRESETS[name].rules == jsharding.PRESETS[name].rules


def test_spec_refuses_what_dtensor_cannot_place():
    with pytest.raises(ValueError, match="mesh order"):
        tsharding.ShardingRules({"batch": ("fsdp", "dp")}).spec("batch")
    with pytest.raises(ValueError, match="shards dims"):
        tsharding.TP_RULES.spec("embed", "embed")


def test_with_sharding_constraint_leaves_a_plain_tensor():
    x = torch.ones(2, 3)
    assert tsharding.with_sharding_constraint(
        x, tsharding.TP_RULES, "batch", "embed") is x


def _jax_model(name):
    """(flax model, init inputs, port model) of each family, tiny."""
    if name == "gpt2":
        return (jgpt2.GPT2(jgpt2.GPT2Config.tiny()),
                jnp.zeros((1, 16), jnp.int32),
                tgpt2.GPT2(tgpt2.GPT2Config.tiny(), device="cpu"))
    if name == "llama":
        return (jllama.Llama(jllama.LlamaConfig.tiny()),
                jnp.zeros((1, 16), jnp.int32),
                tllama.Llama(tllama.LlamaConfig.tiny(), device="cpu"))
    if name == "vit":
        cfg = jvit.ViTConfig.tiny()
        return (jvit.ViT(cfg),
                jnp.zeros((1, cfg.image_size, cfg.image_size, 3)),
                tvit.ViT(tvit.ViTConfig.tiny(), device="cpu"))
    return (jmoe.MoETransformer(jmoe.MoEConfig.tiny()),
            jnp.zeros((1, 16), jnp.int32),
            tmoe.MoETransformer(tmoe.MoEConfig.tiny(), device="cpu"))


@functools.lru_cache(maxsize=None)
def _abstract(name):
    jmodel, inputs, tmodel = _jax_model(name)
    abstract = jax.eval_shape(
        lambda: jmodel.init(jax.random.PRNGKey(0), inputs)["params"])
    return _logical(abstract), tmodel


@pytest.mark.parametrize("preset", sorted(jsharding.PRESETS))
@pytest.mark.parametrize("model", ["gpt2", "llama", "vit", "moe"])
def test_every_placement_is_the_jax_spec(model, preset):
    """Each parameter's spec from the model's ``logical_axes()`` equals
    the JAX model's PartitionSpec of it, transposed as the port lays the
    parameter out; the tables name every parameter the flax model
    names, and no other."""
    logical, tmodel = _abstract(model)
    jspecs = flax.traverse_util.flatten_dict(
        jsharding.logical_to_mesh(jsharding.PRESETS[preset], logical))
    _, tspecs = tsharding.module_sharding(tmodel, tsharding.PRESETS[preset])
    params = dict(tmodel.named_parameters())
    assert {_port_name(k) for k in jspecs} == set(params)
    for path, spec in jspecs.items():
        name = _port_name(path)
        want = _pspec_to_port(spec, _perm(path, params[name].dim()))
        assert tspecs[name] == want, (name, spec)
    named = {_port_name(k) for k, v in flax.traverse_util.flatten_dict(
        logical).items() if v}
    assert set(tmodel.logical_axes()) == named


# ------------------------------------------------- the JAX references --

def _gpt2_tokens(shape, vocab, seed=3):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


def _gpt2_reference(cfg, tokens, rules=None, mesh_axes=None,
                    batch_spec=None):
    """Perturbed flax weights (converted) and the JAX loss and gradients
    of the tiny GPT-2, jitted on params placed under ``rules`` on 4
    devices (unplaced without rules)."""
    model = jgpt2.GPT2(cfg)
    # the same tree from the flash model: the ring's init needs a mesh
    flash = jgpt2.GPT2(dataclasses.replace(cfg, attn_impl="flash"))
    boxed = _fast(flash.init)(
        jax.random.PRNGKey(0),
        jnp.zeros((1, tokens.shape[1]), jnp.int32))["params"]
    params = _perturb(_unbox(boxed), 4)
    state = gpt2_state_dict_from_jax(_np_tree(params))
    toks = jnp.asarray(tokens)

    def grads(p, t):
        return jax.value_and_grad(lambda q: jgpt2.loss_fn(
            model, q, t, head_chunk=GPT2_CHUNK))(p)

    if rules is None:
        loss, g = _fast(grads)(params, toks)
    else:
        mesh = _jmesh(**mesh_axes)
        specs = jsharding.logical_to_mesh(rules, _logical(boxed))
        params = _place(params, specs, mesh)
        toks = jax.device_put(toks, NamedSharding(mesh, batch_spec))
        with juse_mesh(mesh):
            loss, g = _fast(grads)(params, toks)
    return state, float(loss), gpt2_state_dict_from_jax(_np_tree(g))


def _moe_reference():
    """The JAX MoE at dp = 1 x ep = 4 under test_models.py's
    EP rules: perturbed weights, loss and gradients."""
    rules = jsharding.EP_RULES.merged(batch=("dp",), embed=None, mlp=None,
                                      heads=None, kv=None, vocab=None)
    cfg = jmoe.MoEConfig.tiny(dtype=jnp.float32, num_experts=4)
    model = jmoe.MoETransformer(cfg)
    boxed = _fast(model.init)(
        jax.random.PRNGKey(1),
        jnp.zeros((1, MOE_TOKENS[1]), jnp.int32))["params"]
    params = _perturb(_unbox(boxed), 5)
    state = moe_state_dict_from_jax(_np_tree(params))
    mesh = _jmesh(ep=4)
    placed = _place(params, jsharding.logical_to_mesh(rules,
                                                      _logical(boxed)),
                    mesh)
    assert placed["h0"]["moe"]["up"].sharding.spec == P("ep", None, None)
    tokens = _gpt2_tokens(MOE_TOKENS, cfg.vocab_size, seed=6)
    toks = jax.device_put(jnp.asarray(tokens),
                          NamedSharding(mesh, P(("dp",), None)))
    loss, g = _fast(jax.value_and_grad(
        lambda p: jmoe.loss_fn(model, p, toks)))(placed)
    return state, tokens, float(loss), moe_state_dict_from_jax(_np_tree(g))


def _resnet_reference():
    """The JAX ResNet with ``axis_name="dp"`` over 4 devices
    (shard_map): each device's logits, loss gradients and updated batch
    statistics, from 2 images a device."""
    cfg = jresnet.ResNetConfig(**RESNET_KW)
    rng = np.random.default_rng(7)
    images = rng.standard_normal(
        (RANKS * RESNET_PER_RANK, RESNET_SIZE, RESNET_SIZE, 3)).astype(
            np.float32)
    labels = rng.integers(0, cfg.num_classes,
                          RANKS * RESNET_PER_RANK).astype(np.int32)
    variables = _fast(functools.partial(jresnet.ResNet(cfg).init,
                                        train=False))(
        jax.random.PRNGKey(2), images[:2])
    params = _perturb(variables["params"], 8)
    stats = jax.tree.map(lambda x: x + 0.1, variables["batch_stats"])
    model = jresnet.ResNet(cfg, axis_name="dp")
    mesh = _jmesh(dp=RANKS)

    def per_device(p, s, x, y):
        def loss(q):
            logits, new = model.apply({"params": q, "batch_stats": s}, x,
                                      train=True, mutable=["batch_stats"])
            return optax.softmax_cross_entropy_with_integer_labels(
                logits, y).mean(), (logits, new["batch_stats"])
        (_, (logits, new)), g = jax.value_and_grad(loss, has_aux=True)(p)
        stack = functools.partial(jax.tree.map, lambda t: t[None])
        return logits, stack(g), stack(new)

    fn = jax.shard_map(per_device, mesh=mesh,
                       in_specs=(P(), P(), P("dp"), P("dp")),
                       out_specs=(P("dp"), P("dp"), P("dp")),
                       check_vma=False)
    logits, grads, new = _fast(fn)(params, stats, jnp.asarray(images),
                                   jnp.asarray(labels))
    per_rank = []
    for r in range(RANKS):
        g = jax.tree.map(lambda t: np.asarray(t)[r], grads)
        st = jax.tree.map(lambda t: np.asarray(t)[r], new)
        per_rank.append({
            "logits": np.asarray(logits)[r * RESNET_PER_RANK:
                                         (r + 1) * RESNET_PER_RANK],
            "grads": resnet_state_dict_from_jax(g, st)})
    state = resnet_state_dict_from_jax(_np_tree(params), _np_tree(stats))
    return state, images, labels, per_rank


def _flash_reference(name):
    """q, k, v, the cotangent, and the Pallas kernels' output and
    gradients in interpret mode (``native`` per family)."""
    shape, native = FLASH_SHAPES[name]
    rng = np.random.default_rng(11)
    q, k, v, g = (rng.standard_normal(shape).astype(np.float32)
                  for _ in range(4))

    def f(q_, k_, v_):
        return jax_fa.flash_attention(q_, k_, v_, causal=True,
                                      interpret=True, native=native,
                                      block_q=128, block_k=128)

    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    grads = vjp(jnp.asarray(g))
    return (q, k, v, g), [np.asarray(x) for x in (out, *grads)]


def _placed_reference(name):
    """The converted perturbed weights, the inputs and, for each preset,
    the JAX model's f32 logits with its parameters placed by the flax
    partition names under that preset on fsdp = 2 x tp = 2 (the batch
    split over dp and fsdp), for Llama or ViT."""
    if name == "llama":
        cfg = jllama.LlamaConfig.tiny(dtype=jnp.float32)
        model, convert = jllama.Llama(cfg), llama_state_dict_from_jax
        x = _gpt2_tokens((PLACED_BATCH, 16), cfg.vocab_size)
    else:
        cfg = jvit.ViTConfig.tiny(dtype=jnp.float32)
        model, convert = jvit.ViT(cfg), vit_state_dict_from_jax
        x = np.random.default_rng(6).standard_normal(
            (PLACED_BATCH, cfg.image_size, cfg.image_size, 3)
        ).astype(np.float32)
    boxed = _fast(model.init)(jax.random.PRNGKey(2),
                              jnp.asarray(x))["params"]
    params = _perturb(_unbox(boxed), 7)
    mesh = _jmesh(**TP_MESH)
    batch = NamedSharding(mesh, P(("dp", "fsdp")))
    forward = _fast(lambda p, x_: model.apply({"params": p}, x_))
    logits = {}
    for preset, rules in jsharding.PRESETS.items():
        placed = _place(params, jsharding.logical_to_mesh(
            rules, _logical(boxed)), mesh)
        with juse_mesh(mesh):
            logits[preset] = np.asarray(
                forward(placed, jax.device_put(jnp.asarray(x), batch)))
    return convert(_np_tree(params)), x, logits


@pytest.fixture(scope="module")
def jax_refs():
    refs = {}
    cfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    tokens = _gpt2_tokens(GPT2_TOKENS, cfg.vocab_size)
    refs["gpt2"] = (tokens, *_gpt2_reference(
        cfg, tokens, jsharding.TP_RULES, TP_MESH, P(("dp", "fsdp"), None)))
    # JAX does not place a dim that its axes do not divide: the uneven
    # vocabulary's reference runs unplaced (the value is the same)
    ucfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32,
                                 vocab_size=UNEVEN_VOCAB)
    utokens = _gpt2_tokens(GPT2_TOKENS, UNEVEN_VOCAB)
    refs["gpt2_uneven"] = (utokens, *_gpt2_reference(ucfg, utokens))
    scfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32, attn_impl="ring",
                                 max_seq_len=SP_TOKENS[1])
    stokens = _gpt2_tokens(SP_TOKENS, scfg.vocab_size)
    refs["gpt2_sp"] = (stokens, *_gpt2_reference(
        scfg, stokens, jsharding.SP_RULES, SP_MESH,
        P(("dp", "fsdp"), "sp")))
    refs["moe"] = _moe_reference()
    refs["resnet"] = _resnet_reference()
    for name in FLASH_SHAPES:
        refs[f"flash_{name}"] = _flash_reference(name)
    for name in ("llama", "vit"):
        refs[f"placed_{name}"] = _placed_reference(name)
    return refs


# ---------------------------------------------------------- gloo ranks --

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh(**axes):
    return tparallel.build_mesh(tparallel.MeshConfig(**axes), device="cpu")


def _placed_ok(model, rules):
    """Every parameter, and its gradient after place_gradients, placed as
    its spec says on the active mesh."""
    _, specs = tsharding.module_sharding(model, rules)
    for name, p in model.named_parameters():
        want = tuple(specs[name].placements(p.device_mesh))
        if tuple(p.placements) != want or \
                tuple(p.grad.placements) != want:
            return name
    return None


def _rank_gpt2(ref, rules, mesh_axes, cfg_kw, axes):
    tokens, state = ref[0], ref[1]
    mesh = _mesh(**mesh_axes)
    cfg = tgpt2.GPT2Config.tiny(dtype=torch.float32, **cfg_kw)
    model = tgpt2.GPT2(cfg, device="cpu")
    model.load_state_dict(state)
    tsharding.place_module_params(model, rules, mesh)
    toks = tsharding.shard_tensor(torch.from_numpy(tokens).long(), rules,
                                  mesh, *axes)
    loss = tgpt2.loss_fn(model, toks, head_chunk=GPT2_CHUNK)
    loss.backward()
    tsharding.place_gradients(model)
    return {"loss": loss.item(), "misplaced": _placed_ok(model, rules),
            "grads": {n: p.grad.full_tensor()
                      for n, p in model.named_parameters()},
            "wte_local": tuple(model.wte.to_local().shape)}


def _rank_moe(ref):
    state, tokens = ref[0], ref[1]
    rules = tsharding.EP_RULES.merged(batch=("dp",), embed=None, mlp=None,
                                      heads=None, kv=None, vocab=None)
    mesh = _mesh(ep=4)
    model = tmoe.MoETransformer(tmoe.MoEConfig.tiny(
        dtype=torch.float32, num_experts=4), device="cpu")
    model.load_state_dict(state)
    tsharding.place_module_params(model, rules, mesh)
    toks = tsharding.shard_tensor(torch.from_numpy(tokens).long(), rules,
                                  mesh, "batch", None)
    loss = tmoe.loss_fn(model, toks)
    loss.backward()
    tsharding.place_gradients(model)
    up = model.h[0].moe.up
    return {"loss": loss.item(), "misplaced": _placed_ok(model, rules),
            "up": (str(tuple(up.placements)),
                   tuple(up.to_local().shape)),
            "grads": {n: p.grad.full_tensor()
                      for n, p in model.named_parameters()}}


def _rank_resnet(ref, rank):
    state, images, labels = ref[0], ref[1], ref[2]
    mesh = _mesh(dp=RANKS)
    cfg = tresnet.ResNetConfig(**{**RESNET_KW, "dtype": torch.float32})
    model = tresnet.ResNet(cfg, device="cpu", axis_name="dp")
    model.load_state_dict(state)
    mine = slice(rank * RESNET_PER_RANK, (rank + 1) * RESNET_PER_RANK)
    with tparallel.use_mesh(mesh):
        logits = model(torch.from_numpy(images[mine]), train=True)
        F.cross_entropy(logits, torch.from_numpy(labels[mine]).long()
                        ).backward()
    grads = {n: p.grad for n, p in model.named_parameters()}
    grads.update({n: b.clone() for n, b in model.named_buffers()})
    return {"logits": logits.detach(), "grads": grads}


def _rank_flash(ref, name):
    (q, k, v, g), _ = ref
    mesh = _mesh(**TP_MESH)
    native = FLASH_SHAPES[name][1]
    axes = ("batch", None, "heads", None)
    xs = [tsharding.shard_tensor(torch.from_numpy(x), tsharding.TP_RULES,
                                 mesh, *axes).requires_grad_()
          for x in (q, k, v)]
    out = torch_fa.flash_attention(*xs, causal=True, native=native)
    (out * tsharding.shard_tensor(torch.from_numpy(g), tsharding.TP_RULES,
                                  mesh, *axes)).sum().backward()
    return {"placements": str(tuple(out.placements)),
            "local": tuple(out.to_local().shape),
            "out": out.full_tensor().detach(),
            "grads": [x.grad.full_tensor() for x in xs]}


def _rank_placed(ref, name):
    """Llama's or ViT's f32 logits (gathered) on parameters placed under
    each preset, and whether each preset placed a parameter at all."""
    state, x = ref[0], ref[1]
    mesh = _mesh(**TP_MESH)
    out = {}
    for preset, rules in sorted(tsharding.PRESETS.items()):
        if name == "llama":
            model = tllama.Llama(tllama.LlamaConfig.tiny(
                dtype=torch.float32), device="cpu")
            inputs = torch.from_numpy(x).long()
            axes = ("batch", None)
        else:
            model = tvit.ViT(tvit.ViTConfig.tiny(dtype=torch.float32),
                             device="cpu")
            inputs = torch.from_numpy(x)
            axes = ("batch", None, None, None)
        model.load_state_dict(state)
        tsharding.place_module_params(model, rules, mesh)
        with torch.no_grad():
            logits = model(tsharding.shard_tensor(inputs, rules, mesh,
                                                  *axes))
        split = sorted(n for n, p in model.named_parameters()
                       if p.to_local().shape != p.shape)
        out[preset] = {"logits": logits.full_tensor(), "split": split}
    return out


def _rank_refusals():
    """What each kernel entry point says to a DTensor."""
    mesh = _mesh(**TP_MESH)
    x = tsharding.shard_tensor(torch.zeros(2, 8, 2, 64),
                               tsharding.TP_RULES, mesh, "batch", None,
                               "heads", None)
    lse = torch.zeros(2, 2, 8)
    calls = {
        "fwd": lambda: torch_fa.flash_attention_fwd(x, x, x),
        "hm_fwd": lambda: torch_fa.flash_attention_hm_fwd(x, x, x),
        "bwd": lambda: torch_fa.flash_attention_bwd(
            x, x, x, x, lse, x, causal=True, scale=0.125),
        "chunk_fwd": lambda: torch_fa._flash_chunk_fwd(x, x, x, True,
                                                       0.125),
        "rmsnorm": lambda: importlib.import_module(
            "ray_tpu_torch.ops.fused").fused_rmsnorm(
                x, torch.ones(64))}
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except TypeError as e:
            out[name] = str(e)
    return out


def _gloo_worker(rank, port, out_dir, refs):
    # one intra-op thread a rank: four ranks of each of the gloo files,
    # run side by side, would otherwise each start a thread per core
    torch.set_num_threads(1)
    import torch.distributed as dist
    try:
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=RANKS, rank=rank)
        res = {}
        mesh = _mesh(fsdp=4)
        placed = tsharding.shard_params(
            {"w": torch.ones(16, 32), "b": torch.zeros(32)},
            {"w": ("embed", "mlp"), "b": ("mlp",)}, tsharding.TP_RULES,
            mesh)
        res["shard_params"] = {k: (str(tuple(v.placements)),
                                   tuple(v.to_local().shape))
                               for k, v in placed.items()}
        for preset in ("dp", "fsdp", "tp"):
            res[f"gpt2_{preset}"] = _rank_gpt2(
                refs["gpt2"], tsharding.PRESETS[preset], TP_MESH, {},
                ("batch", None))
        res["gpt2_uneven"] = _rank_gpt2(
            refs["gpt2_uneven"], tsharding.TP_RULES, TP_MESH,
            {"vocab_size": UNEVEN_VOCAB}, ("batch", None))
        res["gpt2_sp"] = _rank_gpt2(
            refs["gpt2_sp"], tsharding.SP_RULES, SP_MESH,
            {"attn_impl": "ring", "max_seq_len": SP_TOKENS[1]},
            ("batch", "seq"))
        res["moe"] = _rank_moe(refs["moe"])
        res["resnet"] = _rank_resnet(refs["resnet"], rank)
        for name in FLASH_SHAPES:
            res[f"flash_{name}"] = _rank_flash(refs[f"flash_{name}"], name)
        for name in ("llama", "vit"):
            res[f"placed_{name}"] = _rank_placed(refs[f"placed_{name}"],
                                                 name)
        res["refusals"] = _rank_refusals()
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise


@pytest.fixture(scope="module")
def gloo_ranks(jax_refs, tmp_path_factory):
    """Every rank's results, from one run of 4 gloo processes."""
    out_dir = str(tmp_path_factory.mktemp("gloo"))
    refs = {k: v for k, v in jax_refs.items()}
    # the ranks need the inputs and weights, not the JAX results
    refs["resnet"] = refs["resnet"][:3]
    for name in ("llama", "vit"):
        refs[f"placed_{name}"] = refs[f"placed_{name}"][:2]
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_gloo_worker,
                         args=(r, port, out_dir, refs))
             for r in range(RANKS)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)  # bounded; generous for a loaded host
    assert [p.exitcode for p in procs] == [0] * RANKS, \
        [p.exitcode for p in procs]
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(RANKS)]


def test_shard_params_places_on_mesh(gloo_ranks):
    """test_parallel.py's case at fsdp = 4: ``w`` split on its rows over
    fsdp, ``b`` (mlp over tp, a mesh axis of one rank) whole."""
    for res in gloo_ranks:
        assert res["shard_params"] == {
            "w": ("(Shard(dim=0),)", (4, 32)),
            "b": ("(Replicate(),)", (32,))}


def _hold_grads(got, want):
    assert set(got) == set(want)
    for name, g in want.items():
        torch.testing.assert_close(got[name], g, **GRAD_TOL, msg=name)


@pytest.mark.parametrize("preset", ["dp", "fsdp", "tp"])
def test_gpt2_sharded_step_matches_jax(gloo_ranks, jax_refs, preset):
    """GPT-2 tiny at fsdp = 2 x tp = 2 under each preset: the loss and
    every gradient (gathered) against the JAX step on params placed
    under TP_RULES (test_models.py's sharded step), every parameter and
    gradient placed as its spec says."""
    _, _, loss, grads = jax_refs["gpt2"]
    for res in gloo_ranks:
        got = res[f"gpt2_{preset}"]
        assert got["misplaced"] is None, got["misplaced"]
        assert got["loss"] == pytest.approx(loss, **_approx(OUT_TOL))
        _hold_grads(got["grads"], grads)


def _approx(tol):
    return dict(abs=tol["atol"], rel=tol["rtol"])


def test_gpt2_uneven_vocabulary_over_tp(gloo_ranks, jax_refs):
    """255 vocabulary rows over tp = 2: the leading rank holds 128 rows
    and the other 127 (fsdp splits the 64 columns), and the lookup and
    the LM head's softmax over the split rows give the unplaced JAX
    step's loss and gradients."""
    _, _, loss, grads = jax_refs["gpt2_uneven"]
    rows = sorted({res["gpt2_uneven"]["wte_local"] for res in gloo_ranks})
    assert rows == [(127, 32), (128, 32)]
    for res in gloo_ranks:
        got = res["gpt2_uneven"]
        assert got["misplaced"] is None, got["misplaced"]
        assert got["loss"] == pytest.approx(loss, **_approx(OUT_TOL))
        _hold_grads(got["grads"], grads)


def test_gpt2_ring_under_sp_rules_matches_jax(gloo_ranks, jax_refs):
    """SP_RULES at sp = 2 x tp = 2 with attn_impl="ring": tokens split
    over the sequence, each rank's heads of its chunk through the ring,
    against the JAX ring step on the same mesh."""
    _, _, loss, grads = jax_refs["gpt2_sp"]
    for res in gloo_ranks:
        got = res["gpt2_sp"]
        assert got["misplaced"] is None, got["misplaced"]
        assert got["loss"] == pytest.approx(loss, **_approx(OUT_TOL))
        _hold_grads(got["grads"], grads)


def test_moe_expert_parallel_matches_jax(gloo_ranks, jax_refs):
    """The MoE at dp = 1 x ep = 4 (test_models.py's layout, 4 experts):
    ``up`` split one expert a rank, the loss and every gradient against
    the JAX sharded step."""
    _, _, loss, grads = jax_refs["moe"]
    for res in gloo_ranks:
        got = res["moe"]
        assert got["up"] == ("(Shard(dim=0),)", (1, 64, 256))
        assert got["misplaced"] is None, got["misplaced"]
        assert got["loss"] == pytest.approx(loss, **_approx(OUT_TOL))
        _hold_grads(got["grads"], grads)


def test_cross_replica_batchnorm_matches_jax(gloo_ranks, jax_refs):
    """ResNet with axis_name="dp" at dp = 4, 2 images a rank: each
    rank's logits, gradients and updated running statistics against the
    JAX ResNet's on each of 4 devices (shard_map), which take their
    batch statistics over all 8 images."""
    per_device = jax_refs["resnet"][3]
    for rank, res in enumerate(gloo_ranks):
        want = per_device[rank]
        got = res["resnet"]
        torch.testing.assert_close(got["logits"],
                                   torch.tensor(want["logits"]),
                                   **OUT_TOL)
        stats = {n: t for n, t in want["grads"].items()
                 if n.endswith(("running_mean", "running_var"))}
        assert stats
        for name, t in stats.items():
            torch.testing.assert_close(got["grads"][name], t, **OUT_TOL,
                                       msg=name)
        _hold_grads({n: g for n, g in got["grads"].items()
                     if n not in stats},
                    {n: g for n, g in want["grads"].items()
                     if n not in stats})
    # the statistics are the axis's: every rank holds the same
    for res in gloo_ranks[1:]:
        torch.testing.assert_close(
            res["resnet"]["grads"]["stem_bn.running_mean"],
            gloo_ranks[0]["resnet"]["grads"]["stem_bn.running_mean"])


@pytest.mark.parametrize("name", sorted(FLASH_SHAPES))
def test_flash_attention_on_head_split_dtensors(gloo_ranks, jax_refs,
                                                name):
    """flash_attention on q, k, v split over the batch (fsdp) and the
    heads (tp): each rank runs its own rows and heads, and the gathered
    output and gradients equal the Pallas kernels' (interpret mode) on
    the whole arrays."""
    _, want = jax_refs[f"flash_{name}"]
    shape = FLASH_SHAPES[name][0]
    for res in gloo_ranks:
        got = res[f"flash_{name}"]
        assert got["placements"] == "(Shard(dim=0), Shard(dim=2))"
        assert got["local"] == (shape[0] // 2, shape[1], shape[2] // 2,
                                shape[3])
        torch.testing.assert_close(got["out"], torch.from_numpy(want[0]),
                                   **OUT_TOL)
        for g, w in zip(got["grads"], want[1:]):
            torch.testing.assert_close(g, torch.from_numpy(w), **GRAD_TOL)


@pytest.mark.parametrize("model", ["llama", "vit"])
def test_forward_on_placed_parameters_matches_jax(gloo_ranks, jax_refs,
                                                  model):
    """Llama and ViT on parameters placed under each of the five presets
    at fsdp = 2 x tp = 2, the batch split over dp and fsdp: the logits
    (gathered) against the JAX model's on parameters placed by the same
    presets on 4 devices, within OUT_TOL (2e-5, the GPT-2 placed step's
    tolerance).  The fsdp and tp presets split parameters here."""
    want = jax_refs[f"placed_{model}"][2]
    for res in gloo_ranks:
        got = res[f"placed_{model}"]
        assert sorted(got) == sorted(want)
        for preset, logits in want.items():
            torch.testing.assert_close(got[preset]["logits"],
                                       torch.from_numpy(logits), **OUT_TOL,
                                       msg=preset)
        assert got["fsdp"]["split"] and got["tp"]["split"]


def test_a_dtensor_at_a_kernel_entry_point_raises(gloo_ranks):
    """The wrappers that launch kernels refuse a DTensor, on the CPU as
    on the card: no gather, no plain version."""
    for res in gloo_ranks:
        for name, msg in res["refusals"].items():
            assert msg is not None and "DTensor reached a kernel" in msg, \
                (name, msg)
