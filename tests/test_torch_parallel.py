"""The port's parallel layer (mesh, ring attention, Ulysses) and
sequence-parallel GPT-2 against the JAX package's, on the CPU.

The JAX side runs on the virtual 8-device CPU mesh (4 of its devices for
sp = 4), its Pallas kernels in interpret mode.  The port's side runs two
ways: as 4 gloo processes, one rank each (``_gloo_worker``, once per
module: every rank writes its chunk of each result to a file), and as
the in-process drivers ``simulate_ring`` / ``simulate_ulysses``, which
run the ranks' steps one after another.  On the CPU the port's chunk
kernels and flash attention take their plain versions.

Inputs are made with numpy from seeds.  Tolerances are
tests/test_parallel.py's: 2e-5 for outputs, 2e-4 for gradients (f32;
the two differ in summation order only).
"""

import dataclasses
import functools
import importlib
import os
import socket
import traceback

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.parallel import MeshConfig as JMeshConfig
from ray_tpu.parallel import build_mesh as jbuild_mesh
from ray_tpu.parallel import ring_attention as jring
from ray_tpu.parallel import ulysses_attention as julysses
from ray_tpu.parallel.mesh import use_mesh as juse_mesh
from ray_tpu.parallel.ring_attention import _merge_partials as j_merge
from ray_tpu_torch import parallel as tparallel
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.models.convert import gpt2_state_dict_from_jax
from ray_tpu_torch.parallel import mesh as tmesh
from ray_tpu_torch.parallel.ring_attention import (_merge_partials,
                                                   simulate_ring)
from ray_tpu_torch.parallel.ulysses import simulate_ulysses

jax_fa = importlib.import_module("ray_tpu.ops.flash_attention")
torch_fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")

SP = 4
OUT_TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_TOL = dict(atol=2e-4, rtol=2e-4)
# the chunk functions: both families, as the JAX chunk functions
# dispatch them (2 heads of 64: native layout; 3 heads: head-major; 2
# heads of 384: head-major, on the card flash_xwide.cu's forward and
# flash_xwide_bwd.cu's backward)
CHUNK_SHAPES = {"nl": (1, 256, 2, 64), "hm": (1, 256, 3, 64),
                "hm384": (1, 64, 2, 384)}
# the attention cases both sides run at sp = 4: name -> (shape, seed,
# ring impl or "ulysses", causal).  tests/test_parallel.py's shapes: the
# plain ring's and Ulysses' small ones, and 256 positions of 64-wide
# heads for the kernel paths (64 per rank)
ATTN_CASES = {
    f"{impl}-{'causal' if causal else 'full'}": (shape, seed, impl, causal)
    for impl, shape, seed in (("reference", (2, 64, 4, 16), 0),
                              ("kernel", (1, 256, 2, 64), 5),
                              ("ulysses", (2, 32, 8, 16), 1),
                              ("ulysses_kernel", (1, 256, 4, 64), 7))
    for causal in (False, True)}
# GPT-2 at sp = 4, following examples/long_context_sp.py: tiny, f32, 4
# heads (Ulysses needs sp | heads), a 64-token sequence of 2 rows; the
# port's ranks as sp = 4 and as dp = 2 x sp = 2
GPT2_KW = dict(dtype=jnp.float32, num_heads=4, max_seq_len=64)
GPT2_TOKENS = (2, 64)
GPT2_CHUNK = 64
GPT2_MESHES = {"sp4": dict(sp=4), "dp2sp2": dict(dp=2, sp=2)}


def _arrays(shape, seed, n=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _jmesh():
    return jbuild_mesh(JMeshConfig(sp=SP), devices=jax.devices()[:SP])


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]  # writable copies


# ------------------------------------------------------------ chunk ops --


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("family", sorted(CHUNK_SHAPES))
def test_chunk_fwd_matches_jax(family, causal):
    shape = CHUNK_SHAPES[family]
    q, k, v = _arrays(shape, seed=11, n=3)
    d = shape[-1]
    jout, jlse = jax_fa._flash_chunk_fwd(*map(jnp.asarray, (q, k, v)),
                                         causal, d ** -0.5, interpret=True)
    out, lse = torch_fa._flash_chunk_fwd(*_t(q, k, v), causal, d ** -0.5)
    assert out.dtype == torch.float32 and lse.shape == shape[:3]
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **OUT_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), **OUT_TOL)


@pytest.mark.parametrize("given_delta", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("family", sorted(CHUNK_SHAPES))
def test_chunk_bwd_matches_jax(family, causal, given_delta):
    """The chunk backward from a given LSE (here another chunk's, as a
    ring passes the global one) and a given delta (any [B,T,H]), or
    delta recomputed from out and g."""
    shape = CHUNK_SHAPES[family]
    q, k, v, g = _arrays(shape, seed=13)
    d = shape[-1]
    other = _arrays(shape, seed=14, n=1)[0]
    out, lse = jax_fa._flash_chunk_fwd(*map(jnp.asarray, (q, other, v)),
                                       causal, d ** -0.5, interpret=True)
    delta = (np.random.default_rng(15).standard_normal(shape[:3])
             .astype(np.float32) if given_delta else None)
    ref = jax_fa._flash_chunk_bwd(
        *map(jnp.asarray, (q, k, v)), out, lse, jnp.asarray(g), causal,
        d ** -0.5, interpret=True,
        delta=None if delta is None else jnp.asarray(delta))
    got = torch_fa._flash_chunk_bwd(
        *_t(q, k, v, np.asarray(out), np.asarray(lse), g), causal,
        d ** -0.5, delta=None if delta is None else _t(delta)[0])
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.float32, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_kernel_ring_posts_shifts_before_each_chunk(direction, monkeypatch):
    """The kernel ring's order at every step of both passes, as the JAX
    ring's dependence graph allows: the K/V chunk a rank holds is posted
    (its send and the next chunk's receive, one batch) before the step's
    chunk kernel and waited for after it, and the next step runs on what
    the wait returned; in the backward the dK/dV accumulators leave after
    the step's share is added.  Stand-ins record the shifts and the
    steps on a ring of SP ranks whose shifts hand back copies."""
    ra = importlib.import_module("ray_tpu_torch.parallel.ring_attention")
    me, events, keep = 1, [], []

    def start(xs, group, shift=1):
        assert shift == 1
        events.append(("start", [id(x) for x in xs]))
        return list(xs)

    def wait(sent):
        got = [x.clone() for x in sent]
        keep.extend(got)  # no id is reused while the test runs
        events.append(("wait", [id(x) for x in sent], [id(x) for x in got]))
        return got

    def fwd_step(q, k_cur, v_cur, out, lse, my_idx, k_idx, causal, scale):
        events.append(("chunk", [id(k_cur), id(v_cur)], k_idx, None))
        return out, lse

    def bwd_step(q, k_cur, v_cur, out, lse, g, delta, dq, dk, dv, my_idx,
                 k_idx, causal, scale):
        events.append(("chunk", [id(k_cur), id(v_cur)], k_idx,
                       [id(dk), id(dv)]))

    monkeypatch.setattr(ra, "_size_rank", lambda group: (SP, me))
    monkeypatch.setattr(ra, "ring_shift_start", start)
    monkeypatch.setattr(ra, "ring_shift_wait", wait)
    monkeypatch.setattr(ra, "ring_fwd_step", fwd_step)
    monkeypatch.setattr(ra, "ring_bwd_step", bwd_step)
    q, k, v, g = _t(*_arrays((1, 8, 2, 16), seed=3))
    bwd = direction == "bwd"
    if bwd:
        ra._ring_flash_bwd_pass(q, k, v, q, torch.zeros(1, 8, 2), g,
                                "group", True, 0.25)
    else:
        ra._ring_flash_fwd_pass(q, k, v, "group", True, 0.25)
    dkdv = ["start", "wait"] if bwd else []
    assert [e[0] for e in events] == (
        (["start", "chunk", "wait"] + dkdv) * (SP - 1) + ["chunk"] + dkdv)
    kv = [id(k), id(v)]
    steps = iter(events)
    for s in range(SP):
        if s < SP - 1:
            _, posted = next(steps)
        _, used, k_idx, acc = next(steps)
        assert used == kv and k_idx == (me - s) % SP
        if s < SP - 1:
            # the chunk the step ran on was the one in flight; the next
            # step runs on what arrived
            _, sent, kv = next(steps)
            assert posted == sent == used
        if bwd:
            _, sent_acc = next(steps)
            _, sent, _ = next(steps)
            assert sent_acc == sent == acc


def test_merge_partials_matches_jax():
    """Rows where either partial, or both, saw no key (lse = -1e30)."""
    b, t, h, d = 2, 16, 3, 8
    oa, ob = _arrays((b, t, h, d), seed=21, n=2)
    la, lb = (3 * x for x in _arrays((b, t, h), seed=22, n=2))
    la[:, :4] = -1e30
    lb[:, 2:6] = -1e30
    ref_o, ref_l = j_merge(*map(jnp.asarray, (oa, la, ob, lb)))
    out, lse = _merge_partials(*_t(oa, la, ob, lb))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_o), **OUT_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_l), **OUT_TOL)
    assert (lse[:, 2:4] == -1e30).all() and (out[:, 2:4] == 0).all()


# ---------------------------------------------- JAX side of the rings --


@functools.lru_cache(maxsize=None)
def _jax_attention(name):
    """The JAX function on the sp = 4 mesh: (out, (dq, dk, dv)) of
    sum(out * g); computed once per case (the gloo ranks and the
    in-process driver are held to the same)."""
    shape, seed, impl, causal = ATTN_CASES[name]
    q, k, v, g = map(jnp.asarray, _arrays(shape, seed))
    mesh = _jmesh()
    if impl.startswith("ulysses"):
        kw = dict(interpret=impl == "ulysses_kernel")

        def fn(q_, k_, v_):
            return julysses(q_, k_, v_, causal=causal, mesh=mesh, **kw)
    else:
        def fn(q_, k_, v_):
            return jring(q_, k_, v_, causal=causal, mesh=mesh, impl=impl,
                         interpret=impl == "kernel")
    out, vjp = jax.vjp(fn, q, k, v)
    return np.asarray(out), [np.asarray(x) for x in vjp(g)]


# ------------------------------------------------ the port's 4 ranks --


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_attention(name, rank, mesh):
    """This rank's chunk of the case's output and of its gradients."""
    shape, seed, impl, causal = ATTN_CASES[name]
    chunk = shape[1] // SP
    sl = slice(rank * chunk, (rank + 1) * chunk)
    q, k, v, g = (torch.from_numpy(x[:, sl].copy())
                  for x in _arrays(shape, seed))
    q, k, v = (x.requires_grad_() for x in (q, k, v))
    if impl.startswith("ulysses"):
        out = tparallel.ulysses_attention(q, k, v, causal=causal, mesh=mesh)
    else:
        out = tparallel.ring_attention(q, k, v, causal=causal, mesh=mesh,
                                       impl=impl)
    grads = torch.autograd.grad(out, (q, k, v), g)
    return [x.detach() for x in (out, *grads)]


def _rank_gpt2(impl, mesh_kw, rank, state):
    """One sequence-parallel training step's loss and (reduced)
    gradients of the tiny GPT-2 on this rank's tokens."""
    mesh = tparallel.build_mesh(tparallel.MeshConfig(**mesh_kw),
                                device="cpu")
    dp = tparallel.mesh_axis_size(mesh, "dp")
    sp = tparallel.mesh_axis_size(mesh, "sp")
    dp_i, sp_i = rank // sp, rank % sp  # AXIS_ORDER: dp outermost
    cfg = tgpt2.GPT2Config.tiny(**{**GPT2_KW, "dtype": torch.float32},
                                attn_impl=impl)
    model = tgpt2.GPT2(cfg, device="cpu")
    model.load_state_dict(state)
    tokens = torch.from_numpy(_gpt2_tokens())
    rows, seq = tokens.shape[0] // dp, tokens.shape[1] // sp
    mine = tokens[dp_i * rows:(dp_i + 1) * rows,
                  sp_i * seq:(sp_i + 1) * seq].contiguous()
    with tparallel.use_mesh(mesh):
        loss = tgpt2.loss_fn(model, mine, head_chunk=GPT2_CHUNK)
        loss.backward()
        tgpt2.reduce_gradients(model)
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def _gloo_worker(rank, port, out_dir, state):
    # one intra-op thread a rank: four ranks of each of the gloo files,
    # run side by side, would otherwise each start a thread per core
    torch.set_num_threads(1)
    import torch.distributed as dist
    try:
        dist.init_process_group("gloo",
                                init_method=f"tcp://127.0.0.1:{port}",
                                world_size=SP, rank=rank)
        mesh = tparallel.build_mesh(tparallel.MeshConfig(sp=SP),
                                    device="cpu")
        res = {"summary": tmesh.local_mesh_summary(mesh),
               "sp": tparallel.mesh_axis_size(mesh, "sp")}
        with tparallel.use_mesh(mesh) as m:
            res["global_mesh"] = tparallel.get_global_mesh() is m
        res["after"] = tparallel.get_global_mesh() is None
        try:  # 3 heads over 4 ranks
            tparallel.ulysses_attention(*_t(*_arrays((1, 8, 3, 8), 0, n=3)),
                                        mesh=mesh)
        except ValueError as e:
            res["ulysses_heads"] = str(e)
        for name in ATTN_CASES:
            res[name] = _rank_attention(name, rank, mesh)
        for impl in ("ring", "ulysses"):
            for mname, kw in GPT2_MESHES.items():
                res[f"gpt2-{impl}-{mname}"] = _rank_gpt2(impl, kw, rank,
                                                         state)
        torch.save(res, os.path.join(out_dir, f"rank{rank}.pt"))
        dist.destroy_process_group()
    except BaseException:
        traceback.print_exc()
        raise


def _gpt2_tokens():
    return np.random.default_rng(3).integers(
        0, 256, GPT2_TOKENS, dtype=np.int32)


def _unbox(tree):
    return jax.tree.map(lambda x: x.unbox() if hasattr(x, "unbox") else x,
                        tree, is_leaf=lambda x: hasattr(x, "unbox"))


@pytest.fixture(scope="module")
def gpt2_jax():
    """The tiny GPT-2's converted weights and, per attn_impl, the JAX
    model's loss and gradients at sp = 4 (the global sequence under
    GSPMD, attention through the impl on the mesh)."""
    base = jgpt2.GPT2(jgpt2.GPT2Config.tiny(**GPT2_KW))
    params = _unbox(base.init_params(jax.random.PRNGKey(0), batch=1,
                                     seq=GPT2_TOKENS[1]))
    # perturbed, so that zero biases and unit norm scales hide nothing
    leaves, tree = jax.tree.flatten(params)
    rng = np.random.default_rng(4)
    params = jax.tree.unflatten(tree, [
        x + 0.05 * rng.standard_normal(x.shape).astype(np.float32)
        for x in leaves])
    state = gpt2_state_dict_from_jax(jax.tree.map(np.asarray, params))
    tokens = jnp.asarray(_gpt2_tokens())
    ref = {}
    for impl in ("ring", "ulysses"):
        model = jgpt2.GPT2(jgpt2.GPT2Config.tiny(**GPT2_KW, attn_impl=impl))
        with juse_mesh(_jmesh()):
            loss, grads = jax.jit(jax.value_and_grad(
                lambda p: jgpt2.loss_fn(model, p, tokens,
                                        head_chunk=GPT2_CHUNK)))(params)
        ref[impl] = (float(loss), gpt2_state_dict_from_jax(
            jax.tree.map(np.asarray, grads)))
    return state, ref


@pytest.fixture(scope="module")
def gloo_ranks(gpt2_jax, tmp_path_factory):
    """Every rank's results, from one run of 4 gloo processes."""
    out_dir = str(tmp_path_factory.mktemp("gloo"))
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=_gloo_worker,
                         args=(r, port, out_dir, gpt2_jax[0]))
             for r in range(SP)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    assert [p.exitcode for p in procs] == [0] * SP, \
        [p.exitcode for p in procs]
    return [torch.load(os.path.join(out_dir, f"rank{r}.pt"))
            for r in range(SP)]


def test_gloo_mesh(gloo_ranks):
    for res in gloo_ranks:
        assert res["sp"] == SP
        assert res["summary"] == {"dp": 1, "fsdp": 1, "pp": 1, "sp": SP,
                                  "tp": 1, "ep": 1}
        assert res["global_mesh"] and res["after"]
        assert "do not divide" in res["ulysses_heads"]


@pytest.mark.parametrize("name", sorted(ATTN_CASES))
def test_gloo_attention_matches_jax(gloo_ranks, name):
    """Each rank's chunk of the output and of dq, dk, dv, joined in rank
    order, against the JAX function on the global arrays."""
    ref_out, ref_grads = _jax_attention(name)
    out, *grads = (torch.cat(parts, dim=1).numpy()
                   for parts in zip(*(r[name] for r in gloo_ranks)))
    np.testing.assert_allclose(out, ref_out, **OUT_TOL)
    for label, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(a, b, **GRAD_TOL, err_msg=label)


@pytest.mark.parametrize("name", sorted(n for n in ATTN_CASES
                                        if n.startswith(("kernel",
                                                         "ulysses"))))
def test_in_process_driver_matches_jax(name):
    """simulate_ring (the kernel ring's steps, rank after rank) and
    simulate_ulysses against the JAX function at sp = 4."""
    shape, seed, impl, causal = ATTN_CASES[name]
    q, k, v, g = _t(*_arrays(shape, seed))
    ref_out, ref_grads = _jax_attention(name)
    if impl == "kernel":
        out, grads = simulate_ring(q, k, v, g, SP, causal=causal)
    else:
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        out = simulate_ulysses(q, k, v, SP, causal=causal)
        grads = torch.autograd.grad(out, (q, k, v), g)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, **OUT_TOL)
    for label, a, b in zip(("dq", "dk", "dv"), grads, ref_grads):
        np.testing.assert_allclose(a.numpy(), b, **GRAD_TOL, err_msg=label)


# ------------------------------------------------------------- GPT-2 --


@pytest.mark.parametrize("mesh_name", sorted(GPT2_MESHES))
@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_gpt2_sequence_parallel_matches_jax(gloo_ranks, gpt2_jax, impl,
                                            mesh_name):
    """GPT2Config.tiny(attn_impl=impl) over 4 gloo ranks (sp = 4, or
    dp = 2 x sp = 2): every rank's loss is the global one, and its
    gradients, summed over the ranks, are the JAX model's on the same
    converted weights.  f32, summation order only: the loss to 1e-6,
    each gradient to 1e-6 plus 1e-4 of itself (test_torch_gpt2.py's)."""
    ref_loss, ref_grads = gpt2_jax[1][impl]
    for res in gloo_ranks:
        loss, grads = res[f"gpt2-{impl}-{mesh_name}"]
        np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
        assert set(grads) == set(ref_grads)
        for name, g in grads.items():
            np.testing.assert_allclose(g.numpy(), ref_grads[name].numpy(),
                                       atol=1e-6, rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_gpt2_sequence_parallel_without_mesh_is_one_device(impl):
    """Without a mesh the sequence-parallel model is the single-device
    one: the loss and every gradient of attn_impl="flash"."""
    cfg = tgpt2.GPT2Config.tiny(dtype=torch.float32, num_heads=4)
    tokens = torch.from_numpy(_gpt2_tokens()[:, :40].copy())
    results = []
    for attn_impl in ("flash", impl):
        model = tgpt2.GPT2(dataclasses.replace(cfg, attn_impl=attn_impl),
                           device="cpu")
        loss = tgpt2.loss_fn(model, tokens, head_chunk=GPT2_CHUNK)
        loss.backward()
        results.append((loss.item(), {n: p.grad for n, p in
                                      model.named_parameters()}))
    (ref_loss, ref), (loss, grads) = results
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-6)
    for name, g in grads.items():
        torch.testing.assert_close(g, ref[name], atol=1e-6, rtol=1e-4,
                                   msg=name)


def test_build_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="init_process_group"):
        tparallel.build_mesh(tparallel.MeshConfig(sp=1), device="cpu")


def test_unported_names_raise():
    with pytest.raises(NotImplementedError, match="per-rank"):
        tmesh.shard_map(lambda x: x, mesh=None, in_specs=(), out_specs=())
