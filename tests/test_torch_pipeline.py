"""The port's pipeline parallelism (``ray_tpu_torch.parallel.pipeline``)
against the JAX package's ``pipeline_apply``, on the CPU.

Two stage functions, as tests/test_parallel.py runs them: the toy
``tanh(x @ w)`` stages, and GPT-2 tiny blocks (f32, 4 layers, one a
stage; the flax blocks' weights converted).  The JAX side runs
``pipeline_apply`` over pp = 4 on 4 of the virtual CPU devices and
differentiates it.  The port's side runs as 4 gloo processes, one stage
a rank (``_gloo_worker``, once per module: activations and cotangents
by isend / irecv; the stages stacked on every rank, or one a rank as a
DTensor split over pp), and through ``simulate_pipeline``, every stage
in one process; both are held against the JAX outputs and the
gradients of the stage parameters and of the microbatches, for one
seeded cotangent.

Inputs are made with numpy from seeds.  Tolerances are
tests/test_parallel.py's: 2e-5 for outputs, 2e-4 for gradients (f32;
the two differ in summation order only).
"""

import functools
import os
import socket
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from torch.func import functional_call

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import build_mesh as jbuild_mesh
from ray_tpu.parallel import pipeline_apply as jpipeline_apply
from ray_tpu.parallel.pipeline import \
    stack_block_params as jstack_block_params
from ray_tpu_torch import parallel as tparallel
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import gpt2_state_dict_from_jax
from ray_tpu_torch.parallel.pipeline import (simulate_pipeline,
                                             stack_block_params)
from ray_tpu_torch.parallel.sharding import ShardingRules, shard_tensor

STAGES = 4
OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
# test_parallel.py's shapes: 8 microbatches of 2 x 16 (toy), of 2 x 16
# tokens x 64 wide (GPT-2 tiny blocks)
TOY = dict(n_micro=8, mb=2, dim=16)
BLOCKS = dict(n_micro=8, mb=2, seq=16)


def _toy_stage_jax(w, x):
    return jnp.tanh(x @ w)


def _toy_stage(w, x):
    return torch.tanh(x @ w)


def _block_cfg(jax_side):
    if jax_side:
        return jgpt2.GPT2Config.tiny(dtype=jnp.float32, num_layers=STAGES,
                                     attn_impl="reference")
    return tgpt2.GPT2Config.tiny(dtype=torch.float32, num_layers=STAGES)


@functools.lru_cache(maxsize=None)
def _jax_toy():
    rng = np.random.default_rng(2)
    ws = (rng.standard_normal((STAGES, TOY["dim"], TOY["dim"]))
          * 0.1).astype(np.float32)
    xs = rng.standard_normal((TOY["n_micro"], TOY["mb"],
                              TOY["dim"])).astype(np.float32)
    g = rng.standard_normal(xs.shape).astype(np.float32)
    mesh = jbuild_mesh(JMeshConfig(pp=STAGES),
                       devices=jax.devices()[:STAGES])
    out, vjp = jax.vjp(lambda w, x: jpipeline_apply(
        _toy_stage_jax, w, x, mesh=mesh), jnp.asarray(ws), jnp.asarray(xs))
    dw, dx = vjp(jnp.asarray(g))
    return (ws, xs, g), [np.asarray(t) for t in (out, dw, dx)]


@functools.lru_cache(maxsize=None)
def _jax_blocks():
    """Per-block flax weights (perturbed), converted to the port's names,
    and the JAX pipeline's output and gradients over pp = 4."""
    cfg = _block_cfg(True)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((BLOCKS["n_micro"], BLOCKS["mb"],
                             BLOCKS["seq"], cfg.embed_dim)).astype(
                                 np.float32)
    g = rng.standard_normal(x.shape).astype(np.float32)
    block = jgpt2.Block(cfg)
    per_layer = []
    for i in range(STAGES):
        p = block.init(jax.random.PRNGKey(i), jnp.asarray(x[0]))["params"]
        p = jax.tree.map(lambda v: v.unbox() if hasattr(v, "unbox") else v,
                         p, is_leaf=lambda v: hasattr(v, "unbox"))
        leaves, tree = jax.tree.flatten(p)
        noise = np.random.default_rng(20 + i)
        per_layer.append(jax.tree.unflatten(tree, [
            v + 0.05 * noise.standard_normal(v.shape).astype(np.float32)
            for v in leaves]))
    stacked = jstack_block_params(per_layer)
    mesh = jbuild_mesh(JMeshConfig(pp=STAGES),
                       devices=jax.devices()[:STAGES])
    out, vjp = jax.vjp(lambda p, a: jpipeline_apply(
        lambda q, act: block.apply({"params": q}, act), p, a, mesh=mesh),
        stacked, jnp.asarray(x))
    dp, dx = vjp(jnp.asarray(g))
    states = [_block_state(p) for p in per_layer]
    grads = [_block_state(jax.tree.map(lambda t: t[i], dp))
             for i in range(STAGES)]
    return (states, x, g), (np.asarray(out), grads, np.asarray(dx))


def _block_state(params):
    """One flax block's tree as a port Block's state dict (through the
    GPT-2 converter, as the block ``h0`` of a model)."""
    e = np.asarray(params["ln_1"]["scale"]).shape[0]
    tree = {"wte": np.zeros((1, e), np.float32),
            "wpe": np.zeros((1, e), np.float32),
            "ln_f": {"scale": np.zeros(e, np.float32),
                     "bias": np.zeros(e, np.float32)},
            "h0": jax.tree.map(np.asarray, params)}
    return {k[len("h.0."):]: v
            for k, v in gpt2_state_dict_from_jax(tree).items()
            if k.startswith("h.0.")}


def _port_blocks(states):
    blocks = []
    for state in states:
        block = tgpt2.Block(_block_cfg(False), device="cpu")
        block.load_state_dict(state)
        blocks.append(block)
    return blocks


def _block_stage(block):
    """The stage function of a stacked block tree: one block's forward
    with the stage's parameters."""
    return lambda params, x: functional_call(block, params, (x,))


# --------------------------------------------------- in one process --

def test_simulate_pipeline_toy_matches_jax():
    (ws, xs, g), (out, dw, dx) = _jax_toy()
    w = torch.from_numpy(ws).requires_grad_()
    x = torch.from_numpy(xs).requires_grad_()
    got = simulate_pipeline(_toy_stage, w, x)
    got.backward(torch.from_numpy(g))
    torch.testing.assert_close(got.detach(), torch.from_numpy(out),
                               **OUT_TOL)
    torch.testing.assert_close(w.grad, torch.from_numpy(dw), **GRAD_TOL)
    torch.testing.assert_close(x.grad, torch.from_numpy(dx), **GRAD_TOL)


def test_simulate_pipeline_gpt2_blocks_match_jax_and_sequence():
    """GPT-2 tiny blocks, one a stage: the output against the JAX
    pipeline and against the blocks run in sequence; the blocks' own
    gradients (through stack_block_params) against the JAX ones."""
    (states, xs, g), (out, grads, dx) = _jax_blocks()
    blocks = _port_blocks(states)
    stacked = stack_block_params([dict(b.named_parameters())
                                  for b in blocks])
    assert stacked["attn_qkv.weight"].shape[0] == STAGES
    x = torch.from_numpy(xs).requires_grad_()
    got = simulate_pipeline(_block_stage(blocks[0]), stacked, x)
    got.backward(torch.from_numpy(g))
    torch.testing.assert_close(got.detach(), torch.from_numpy(out),
                               **OUT_TOL)
    with torch.no_grad():
        seq = torch.stack([functools.reduce(lambda a, b: b(a), blocks,
                                            x[m]) for m in range(len(x))])
    torch.testing.assert_close(got.detach(), seq, **OUT_TOL)
    torch.testing.assert_close(x.grad, torch.from_numpy(dx), **GRAD_TOL)
    for block, want in zip(blocks, grads):
        for name, p in block.named_parameters():
            torch.testing.assert_close(p.grad, want[name], **GRAD_TOL,
                                       msg=name)


def test_stack_block_params_refuses_different_trees():
    with pytest.raises(ValueError, match="differ"):
        stack_block_params([{"a": torch.zeros(2)}, {"b": torch.zeros(2)}])


def test_pipeline_apply_needs_a_mesh():
    with pytest.raises(ValueError, match="simulate_pipeline"):
        tparallel.pipeline_apply(_toy_stage, torch.zeros(1, 2, 2),
                                 torch.zeros(1, 2, 2))


# ---------------------------------------------------------- gloo ranks --

def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _gloo_worker(rank, port, out_dir, toy, blocks):
    # one intra-op thread a rank: four ranks of each of the gloo files,
    # run side by side, would otherwise each start a thread per core
    torch.set_num_threads(1)
    import torch.distributed as dist
    try:
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=STAGES, rank=rank)
        mesh = tparallel.build_mesh(tparallel.MeshConfig(pp=STAGES),
                                    device="cpu")
        res = {}
        ws, xs, g = toy
        w = torch.from_numpy(ws).requires_grad_()
        x = torch.from_numpy(xs).requires_grad_()
        out = tparallel.pipeline_apply(_toy_stage, w, x, mesh=mesh)
        out.backward(torch.from_numpy(g))
        res["toy"] = {"out": out.detach(), "dw": w.grad, "dx": x.grad}
        # the stages placed one a rank: a DTensor split over pp
        w = shard_tensor(torch.from_numpy(ws), ShardingRules(
            {"layers": "pp"}), mesh, "layers", None, None).requires_grad_()
        out = tparallel.pipeline_apply(_toy_stage, w,
                                       torch.from_numpy(xs), mesh=mesh)
        out.backward(torch.from_numpy(g))
        res["toy_placed"] = {"out": out.detach(),
                             "local": tuple(w.to_local().shape),
                             "dw": w.grad.full_tensor()}
        states, xs, g = blocks
        port = _port_blocks(states)
        stacked = stack_block_params([dict(b.named_parameters())
                                      for b in port])
        x = torch.from_numpy(xs).requires_grad_()
        with tparallel.use_mesh(mesh):  # the global mesh's pp axis
            out = tparallel.pipeline_apply(_block_stage(port[0]), stacked,
                                           x)
        out.backward(torch.from_numpy(g))
        res["blocks"] = {
            "out": out.detach(), "dx": x.grad,
            "grads": [{n: p.grad for n, p in b.named_parameters()}
                      for b in port]}
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise


@pytest.fixture(scope="module")
def gloo_ranks(tmp_path_factory):
    """Every rank's results, from one run of 4 gloo processes."""
    out_dir = str(tmp_path_factory.mktemp("gloo"))
    toy = _jax_toy()[0]
    blocks = _jax_blocks()[0]
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_gloo_worker,
                         args=(r, port, out_dir, toy, blocks))
             for r in range(STAGES)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(600)  # bounded; generous for a loaded host
    assert [p.exitcode for p in procs] == [0] * STAGES, \
        [p.exitcode for p in procs]
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(STAGES)]


def test_pipeline_apply_toy_matches_jax(gloo_ranks):
    """pp = 4 with the toy stages: every rank holds the outputs; rank
    *i*'s gradient is its stage's row of the JAX gradient (the others
    zero); the microbatches' gradient, summed over the axis, is on every
    rank."""
    _, (out, dw, dx) = _jax_toy()
    for rank, res in enumerate(gloo_ranks):
        got = res["toy"]
        torch.testing.assert_close(got["out"], torch.from_numpy(out),
                                   **OUT_TOL)
        want = torch.zeros_like(got["dw"])
        want[rank] = torch.from_numpy(dw[rank])
        torch.testing.assert_close(got["dw"], want, **GRAD_TOL)
        torch.testing.assert_close(got["dx"], torch.from_numpy(dx),
                                   **GRAD_TOL)


def test_pipeline_apply_takes_stages_placed_over_pp(gloo_ranks):
    """The toy stages as a DTensor split over pp (each rank holds its
    own stage): the outputs, and the gradient gathered whole, against
    the JAX pipeline's."""
    _, (out, dw, _) = _jax_toy()
    for res in gloo_ranks:
        got = res["toy_placed"]
        assert got["local"] == (1, TOY["dim"], TOY["dim"])
        torch.testing.assert_close(got["out"], torch.from_numpy(out),
                                   **OUT_TOL)
        torch.testing.assert_close(got["dw"], torch.from_numpy(dw),
                                   **GRAD_TOL)


def test_pipeline_apply_gpt2_blocks_match_jax(gloo_ranks):
    """pp = 4 over GPT-2 tiny blocks: the outputs on every rank, the
    microbatches' gradient, and on rank *i* block *i*'s gradients (and
    none for the others) against the JAX pipeline's."""
    _, (out, grads, dx) = _jax_blocks()
    for rank, res in enumerate(gloo_ranks):
        got = res["blocks"]
        torch.testing.assert_close(got["out"], torch.from_numpy(out),
                                   **OUT_TOL)
        torch.testing.assert_close(got["dx"], torch.from_numpy(dx),
                                   **GRAD_TOL)
        for i, (block_grads, want) in enumerate(zip(got["grads"], grads)):
            for name, g in block_grads.items():
                if i == rank:
                    torch.testing.assert_close(g, want[name], **GRAD_TOL,
                                               msg=name)
                else:
                    assert g is None or not g.any(), (rank, i, name)
