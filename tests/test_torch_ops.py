"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU the wrappers compute their plain PyTorch versions; the JAX
side runs the Pallas kernels in interpret mode, as tests/test_ops.py
does: its native-layout family (``native=True``) and its head-major one
(``native=False``).  The CUDA kernels themselves are held against the
same plain versions on the card by chip_smoke.py.
"""

import importlib

import jax
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ray_tpu.ops import fused_rmsnorm as jax_rmsnorm
from ray_tpu.ops import fused as jax_fused
from ray_tpu.ops.flash_attention import (_flash_backward, _flash_forward,
                                         _flash_nl_forward)
from ray_tpu.ops.flash_attention import fit_block as jax_fit_block
from ray_tpu.ops.flash_attention import flash_attention as jax_flash
from ray_tpu.ops.flash_attention import kernel_block_for as jax_kbf
from ray_tpu_torch.ops import (attention_backward_reference,
                               attention_reference, chunked_lm_loss,
                               fit_block, flash_attention,
                               flash_attention_fwd, flash_attention_hm_fwd,
                               fused_rmsnorm, fused_softmax_cross_entropy,
                               kernel_block_for)

# the modules (both packages re-export the function under the same name)
jax_fa = importlib.import_module("ray_tpu.ops.flash_attention")
torch_fa = importlib.import_module("ray_tpu_torch.ops.flash_attention")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: under the
    suite's ``-n 6`` six pools of a thread per core on the same cores
    spend the time waiting for each other on these tiny shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _qkv(shape, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for _ in range(3)]


def _jax_flash(q, k, v, causal, jdtype):
    """Native-layout Pallas forward (interpret mode): out [B,T,H,D] and
    lse reshaped from [B, H/pack, T, pack] to [B, H, T]."""
    b, t, h, d = q.shape
    out, lse = _flash_nl_forward(
        *(jnp.asarray(x, jdtype) for x in (q, k, v)), causal, d ** -0.5,
        128, 128, True)
    out = np.asarray(out.astype(jnp.float32)).reshape(b, t, h, d)
    lse = np.asarray(lse).transpose(0, 1, 3, 2).reshape(b, h, t)
    return out, lse


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 256, 4, 64), (1, 256, 3, 128)])
def test_flash_fwd_matches_pallas_f32(shape, causal):
    q, k, v = _qkv(shape, seed=shape[2])
    ref_out, ref_lse = _jax_flash(q, k, v, causal, jnp.float32)
    out, lse = flash_attention_fwd(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal)
    assert out.dtype == torch.float32
    assert lse.shape == (shape[0], shape[2], shape[1])
    assert lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref_out, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=2e-5, rtol=2e-5)


def test_flash_fwd_bf16_keeps_dtype():
    q, k, v = _qkv((1, 256, 2, 64), seed=7)
    ref_out, _ = _jax_flash(q, k, v, True, jnp.bfloat16)
    out = flash_attention(*(torch.from_numpy(x).bfloat16()
                            for x in (q, k, v)), causal=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(), ref_out, atol=3e-2,
                               rtol=3e-2)


# the CUDA kernel's edge widths (1000: no multiple of a 16-byte bf16
# vector; 5120 and 8192: four or eight warps a row) at an odd row count
@pytest.mark.parametrize("dtype,shape", [
    pytest.param(dt, shape, id=dt if shape == (4, 8, 256)
                 else f"{dt}-{'x'.join(map(str, shape))}")
    for shape in ((4, 8, 256), (3, 5, 1000), (3, 5, 5120), (3, 5, 8192))
    for dt in ("f32", "bf16")])
def test_rmsnorm_matches_pallas(dtype, shape):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    ref = jax_rmsnorm(jnp.asarray(x, jdt), jnp.asarray(w), eps=1e-5,
                      interpret=True)
    out = fused_rmsnorm(torch.from_numpy(x).to(tdt), torch.from_numpy(w),
                        eps=1e-5)
    assert out.dtype == tdt and out.shape == x.shape
    # bf16: both round the same f32 value; one ulp (2**-8 relative) of
    # slack covers a differently-rounded rsqrt
    tol = 1e-5 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               atol=tol, rtol=tol)


def test_rmsnorm_default_eps_matches_jax():
    """fused_rmsnorm's own default eps is 1e-6 in both packages."""
    x = np.full((2, 64), 1e-3, np.float32)
    w = np.ones(64, np.float32)
    ref = jax_rmsnorm(jnp.asarray(x), jnp.asarray(w), interpret=True)
    out = fused_rmsnorm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("seq,block", [(1024, 1024), (1000, 1024),
                                       (1000, 128), (97, 64), (256, 100),
                                       (12, 5), (7, 1), (384, 256),
                                       (120, 1024), (136, 128)])
def test_block_helpers_match_jax(seq, block):
    assert fit_block(seq, block) == jax_fit_block(seq, block)
    assert kernel_block_for(seq, block) == jax_kbf(seq, block)


def test_causal_unequal_lengths_raise():
    q = torch.zeros(1, 8, 2, 64)
    k = torch.zeros(1, 16, 2, 64)
    with pytest.raises(ValueError, match="Tq == Tk"):
        flash_attention(q, k, k, causal=True)
    out = flash_attention(q, k, k, causal=False)  # no mask: any lengths
    assert out.shape == q.shape


def test_plain_versions_refuse_causal_unequal_lengths():
    """The plain versions raise as the wrappers do: the JAX reference
    aligns a causal mask bottom-right when Tq != Tk, the kernels
    top-left, so neither alignment is picked silently."""
    q = torch.zeros(1, 8, 2, 64)
    k = torch.zeros(1, 16, 2, 64)
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="Tq == Tk"):
        attention_reference(q, k, k, True, 0.125)
    with pytest.raises(ValueError, match="Tq == Tk"):
        attention_backward_reference(q, k, k, q, lse, q, True, 0.125)
    out, _ = attention_reference(q, k, k, False, 0.125)
    assert out.shape == q.shape


def _jax_flash_grads(q, k, v, do, causal, jdtype, native=True, block=128):
    """``jax.vjp`` of the Pallas kernels (interpret mode): the backward
    runs _fa_nl_bwd_dkdv_kernel and _fa_nl_bwd_dq_kernel (``native``) or
    _fa_bwd_dkdv_kernel and _fa_bwd_dq_kernel (head-major); ``block``
    None takes the JAX package's default blocks."""
    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, causal=causal, interpret=True,
                         native=native, block_q=block, block_k=block)
    out, vjp = jax.vjp(f, *(jnp.asarray(x, jdtype) for x in (q, k, v)))
    grads = vjp(jnp.asarray(do, jdtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _torch_flash_grads(q, k, v, do, causal, tdtype, hm=None):
    """The vjp of flash_attention or, with ``hm`` set, of the Function of
    that kernel family (head-major if true) whatever the shape."""
    q, k, v = (torch.from_numpy(x).to(tdtype).requires_grad_()
               for x in (q, k, v))
    if hm is None:
        out = flash_attention(q, k, v, causal=causal)
    else:
        out = torch_fa._FlashAttention.apply(q, k, v, causal,
                                             q.shape[-1] ** -0.5, hm)
    out.backward(torch.from_numpy(do).to(tdtype))
    assert all(x.grad.dtype == tdtype for x in (q, k, v))
    return [x.detach().float().numpy() for x in (out, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [(2, 256, 4, 64), (1, 256, 3, 128)])
def test_flash_bwd_matches_pallas_f32(shape, causal):
    q, k, v, do = _qkv(shape, seed=shape[2]) + _qkv(shape, seed=9)[:1]
    ref = _jax_flash_grads(q, k, v, do, causal, jnp.float32)
    got = _torch_flash_grads(q, k, v, do, causal, torch.float32)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=2e-5,
                                   err_msg=name)


# the new models' attention shapes, through the family each routes to:
# ViT-B/16's ragged non-causal length (196 patches + CLS) in the native
# family (fit_block(197, 1024) = 197, one tile in the Pallas kernels),
# ViT tiny's (16 patches + CLS, head_dim 32) and the tiny MoE's causal
# one in the head-major family
@pytest.mark.parametrize("shape,causal,native", [
    pytest.param((1, 197, 2, 64), False, True, id="vit_b16-nl"),
    pytest.param((1, 17, 2, 32), False, False, id="vit_tiny-hm"),
    pytest.param((2, 16, 2, 32), True, False, id="moe_tiny-hm")])
def test_flash_at_model_shapes_matches_pallas_f32(shape, causal, native):
    q, k, v, do = _qkv(shape, seed=shape[1]) + _qkv(shape, seed=3)[:1]
    ref = _jax_flash_grads(q, k, v, do, causal, jnp.float32,
                           native=native, block=None)
    got = _torch_flash_grads(q, k, v, do, causal, torch.float32,
                             hm=not native)
    # summation order only (tests/test_ops.py's 2e-5 for O, 2e-4 for the
    # head-major gradients)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        tol = 2e-5 if name == "out" else 2e-4
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=name)


def test_flash_bwd_bf16_keeps_dtype():
    q, k, v, do = _qkv((1, 256, 2, 64), seed=5) + _qkv((1, 256, 2, 64),
                                                       seed=6)[:1]
    ref = _jax_flash_grads(q, k, v, do, True, jnp.bfloat16)
    got = _torch_flash_grads(q, k, v, do, True, torch.bfloat16)
    # Both round P and dS to bf16 before their products and store bf16
    # gradients; scores summed in another order can round a P or dS the
    # other way.  Measured on this case (CPU, jax 0.9, torch 2.13): max
    # |diff| 0.0078 against gradients up to 3.3 (0.33% of the largest,
    # one bf16 ulp for values in [1, 2)); 1% of the largest gradient
    # leaves room for another platform's summation order.  Causal rows
    # shrink with position, so each row is also held to its own size:
    # max |diff| over the row's RMS (floored at 1% of the tensor's RMS
    # for dQ's row 0, exactly 0) measured at most 0.046 (dq), limit 0.1.
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, b, atol=1e-2 * np.abs(b).max(),
                                   rtol=0, err_msg=name)
        rms = np.sqrt(np.square(b).mean(-1))
        rms = np.maximum(rms, 1e-2 * np.sqrt(np.square(b).mean()))
        assert (np.abs(a - b).max(-1) / rms).max() <= 0.1, name


# the head-major family: head_dim 32 (the tiny presets), odd heads at 64
# (GPT-2 XL's routing), and 128
_HM_SHAPES = [(2, 128, 4, 32), (1, 128, 3, 64), (1, 128, 2, 128)]


def _jax_flash_hm(q, k, v, causal, jdtype):
    """Head-major Pallas forward (_fa_kernel, interpret mode): out
    [B,T,H,D] and lse [B,H,T,1] reshaped to [B,H,T]."""
    out, lse = _flash_forward(*(jnp.asarray(x, jdtype) for x in (q, k, v)),
                              causal, q.shape[-1] ** -0.5, 128, 128, True)
    return np.asarray(out.astype(jnp.float32)), np.asarray(lse)[..., 0]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", _HM_SHAPES)
def test_flash_hm_fwd_matches_pallas_f32(shape, causal):
    q, k, v = _qkv(shape, seed=shape[2] + 20)
    ref_out, ref_lse = _jax_flash_hm(q, k, v, causal, jnp.float32)
    out, lse = flash_attention_hm_fwd(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal)
    assert out.dtype == torch.float32 and out.shape == q.shape
    assert lse.shape == (shape[0], shape[2], shape[1])
    np.testing.assert_allclose(out.numpy(), ref_out, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", _HM_SHAPES)
def test_flash_hm_bwd_matches_pallas_f32(shape, causal):
    """The vjp of the head-major family against the head-major Pallas
    kernels; gradients at tests/test_ops.py's 2e-4."""
    q, k, v, do = _qkv(shape, seed=shape[2] + 30) + _qkv(shape, seed=8)[:1]
    ref = _jax_flash_grads(q, k, v, do, causal, jnp.float32, native=False)
    got = _torch_flash_grads(q, k, v, do, causal, torch.float32, hm=True)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        tol = 2e-5 if name == "out" else 2e-4
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=name)


# head sizes between the CUDA kernels' built ones (32, 64, 128): the card
# runs them on the next built size with the extra columns zero; the
# Pallas kernels span any head_dim, so both sides take them as they are
_PADDED_HM_SHAPES = [(1, 128, 2, 16), (1, 128, 2, 48), (1, 128, 2, 80),
                     (1, 128, 2, 96)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", _PADDED_HM_SHAPES,
                         ids=lambda s: f"d{s[-1]}")
def test_flash_hm_padded_head_dims_match_pallas_f32(shape, causal):
    """Forward (O, LSE) and the vjp of the head-major family at head_dim
    16, 48, 80 and 96 against the head-major Pallas kernels (interpret
    mode), at the head-major tests' tolerances."""
    q, k, v, do = _qkv(shape, seed=shape[-1]) + _qkv(shape, seed=4)[:1]
    ref_out, ref_lse = _jax_flash_hm(q, k, v, causal, jnp.float32)
    out, lse = flash_attention_hm_fwd(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=2e-5, rtol=2e-5)
    ref = _jax_flash_grads(q, k, v, do, causal, jnp.float32, native=False)
    got = _torch_flash_grads(q, k, v, do, causal, torch.float32, hm=True)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        tol = 2e-5 if name == "out" else 2e-4
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("dim", [8, 16, 32, 48, 64, 80, 96, 128])
def test_kernel_head_dims_take_every_multiple_of_8(dim):
    """What the card takes (``_check_head_dim``, checked before any
    launch): the head-major kernels every multiple of 8 up to 128, the
    native-layout ones 64 and 128 only, as the JAX package's
    ``_nl_eligible`` picks them."""
    torch_fa._check_head_dim(dim, hm=True)
    if dim in (64, 128):
        torch_fa._check_head_dim(dim, hm=False)
    else:
        with pytest.raises(ValueError, match="one of"):
            torch_fa._check_head_dim(dim, hm=False)


@pytest.mark.parametrize("dim", [0, 1025, 1032, 1536, 2048, 4096])
def test_kernel_head_dims_still_refused(dim):
    """The head-major family takes head_dim 1 to 1024 (every size on the
    card since the pad route and the kernels above 128); a size outside
    raises before any launch, on CPU tensors as on the card."""
    with pytest.raises(ValueError, match="head_dim 1 to 1024"):
        torch_fa._check_head_dim(dim, hm=True)
    if dim:
        x = torch.zeros(1, 2, 1, dim)
        with pytest.raises(ValueError, match="head_dim 1 to 1024"):
            flash_attention_hm_fwd(x, x, x)
        with pytest.raises(ValueError, match="head_dim 1 to 1024"):
            flash_attention(x, x, x, native=False)


_BF16, _F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("dim,dtype,part,route", [
    (4, _BF16, "fwd", ("hm", 8)), (8, _BF16, "fwd", ("hm", 8)),
    (20, _BF16, "fwd", ("hm", 24)), (44, _F32, "dkdv", ("hm", 48)),
    (64, _F32, "dq", ("hm", 64)), (128, _BF16, "dq", ("hm", 128)),
    # bf16 forward, dK/dV and dQ from 129 to 256: flash_wide.cu (160 on
    # its 192 build as it is, 200 and 256 on the 256 one, 150 padded to
    # 152)
    (160, _BF16, "fwd", ("wide", 160)), (160, _BF16, "dkdv", ("wide", 160)),
    (200, _BF16, "fwd", ("wide", 200)), (256, _BF16, "fwd", ("wide", 256)),
    (256, _BF16, "dkdv", ("wide", 256)), (150, _BF16, "fwd", ("wide", 152)),
    (150, _BF16, "dkdv", ("wide", 152)),
    (150, _BF16, "dq", ("wide", 152)), (160, _BF16, "dq", ("wide", 160)),
    (256, _BF16, "dq", ("wide", 256)),
    # the bf16 forward from 257 to 512: flash_xwide.cu (264 on its 384
    # build, 300 padded to 304); dK/dV and dQ from 257 to 1024 on
    # flash_xwide_bwd.cu, at the width the forward pads to
    (264, _BF16, "fwd", ("xwide", 264)), (300, _BF16, "fwd", ("xwide", 304)),
    (300, _BF16, "dkdv", ("xwide", 304)),
    (300, _BF16, "dq", ("xwide", 304)), (512, _BF16, "fwd", ("xwide", 512)),
    (512, _BF16, "dkdv", ("xwide", 512)),
    (512, _BF16, "dq", ("xwide", 512)), (264, _BF16, "dq", ("xwide", 264)),
    # the bf16 forward from 513 to 1024: flash_xwide.cu's 768/1024 builds
    # (601 padded to 608); dK/dV and dQ on flash_xwide_bwd.cu
    (520, _BF16, "fwd", ("xxwide", 520)), (600, _BF16, "fwd", ("xxwide", 600)),
    (601, _BF16, "fwd", ("xxwide", 608)),
    (1000, _BF16, "fwd", ("xxwide", 1000)),
    (1024, _BF16, "fwd", ("xxwide", 1024)),
    (601, _BF16, "dkdv", ("xwide", 608)),
    (1000, _BF16, "dq", ("xwide", 1000)),
    (1024, _BF16, "dkdv", ("xwide", 1024)),
    # f32 above 128: the forward on flash_fma.cu (150 padded to 152), dK/dV
    # and dQ on flash_fma_bwd.cu at the same width
    (160, _F32, "fwd", ("fma", 160)), (256, _F32, "dkdv", ("fma", 256)),
    (150, _F32, "fwd", ("fma", 152)), (150, _F32, "dq", ("fma", 152)),
    (384, _F32, "fwd", ("fma", 384)), (1024, _F32, "fwd", ("fma", 1024)),
    (1024, _F32, "dkdv", ("fma", 1024))])
def test_hm_route(dim, dtype, part, route):
    """Where the head-major family runs each head_dim's part on the card,
    by input dtype: up to 128 on kernels #5-#7 (a size that is no
    multiple of 8 padded to the next one); from 129 to 256 the bf16
    forward, dK/dV and dQ on flash_wide.cu and from 257 to 1024 the bf16
    forward on flash_xwide.cu and dK/dV and dQ on flash_xwide_bwd.cu
    (padded the same way); the f32 forward, dK/dV and dQ above 128 on
    flash_fma.cu and flash_fma_bwd.cu (padded to a multiple of 4)."""
    assert torch_fa._hm_route(dim, dtype, part) == route


@pytest.mark.parametrize("chunk", [False, True], ids=["bf16out", "f32out"])
def test_every_route_counts_its_launches(chunk, monkeypatch):
    """Each kernel a route can pick has its own launch counter, on the
    head-major wrappers and (the chunk mode, f32 outputs) on the chunk
    functions: one launch of a part moves that counter alone, by one."""
    fns = (torch_fa.flash_attention_hm_fwd, torch_fa.flash_attention_hm_bwd,
           torch_fa._flash_chunk_fwd, torch_fa._flash_chunk_bwd)

    def counts():
        return {(fn.__name__, a): getattr(fn, a) for fn in fns
                for a in vars(fn) if a.startswith("launches")}

    for (name, attr), n in counts().items():  # restored at teardown
        monkeypatch.setattr(getattr(torch_fa, name), attr, n)
    seen = set()
    for dim in (20, 64, 150, 256, 300, 512, 520, 601, 1024):
        for dtype in (_F32, _BF16):
            for part, sfx in zip(torch_fa.PARTS, ("", "_dkdv", "_dq")):
                kind = torch_fa._hm_route(dim, dtype, part)[0]
                if chunk and kind == "fma":
                    # f32 inputs give f32 outputs: flash_fma.cu and
                    # flash_fma_bwd.cu have no chunk mode, so no chunk
                    # counter
                    assert not hasattr(
                        (torch_fa._flash_chunk_fwd,
                         torch_fa._flash_chunk_bwd)[part != "fwd"],
                        "launches_" + kind + sfx)
                    continue
                before = counts()
                torch_fa._count(kind, sfx, chunk=chunk)
                moved = {k: v - before[k] for k, v in counts().items()
                         if v != before[k]}
                assert list(moved.values()) == [1], (dim, dtype, part, moved)
                seen |= set(moved)
    # every head-major counter was moved (the chunk functions' plain
    # "launches*" count the native-layout kernels, which no route picks)
    native = ("launches", "launches_dkdv", "launches_dq") if chunk else ()
    assert seen == {(fn.__name__, a) for fn in fns[2 * chunk:2 * chunk + 2]
                    for a in vars(fn)
                    if a.startswith("launches") and a not in native}


def test_hm_route_takes_three_parts():
    with pytest.raises(ValueError, match="part is one of"):
        torch_fa._hm_route(160, _BF16, "bwd")


def _plain_kernels(monkeypatch, seen):
    """The three kernel launchers replaced by the plain versions on CPU
    tensors, recording (kernel, head_dim, selector) for each call: the
    wrappers' routing (padding, slicing, the kernel selector) then runs
    on the CPU."""
    def fwd(q, k, v, causal, scale, kind):
        seen.append(("fwd", q.shape[-1], kind))
        out, lse = attention_reference(q, k, v, causal, scale)
        return out.contiguous(), lse  # as the kernel's torch.empty_like

    def grads(q, k, v, do, lse, delta, causal, scale):
        out, _ = attention_reference(q, k, v, causal, scale)
        # delta comes from the unpadded O and dO: their zero columns add
        # nothing to it
        assert torch.allclose(delta, torch_fa.attention_delta(out, do),
                              atol=1e-6)
        return attention_backward_reference(q, k, v, out, lse, do, causal,
                                            scale)

    def dkdv(q, k, v, do, lse, delta, causal, scale, kind):
        seen.append(("dkdv", q.shape[-1], kind))
        return tuple(g.contiguous()
                     for g in grads(q, k, v, do, lse, delta, causal, scale)[1:])

    def dq(q, k, v, do, lse, delta, causal, scale, kind):
        seen.append(("dq", q.shape[-1], kind))
        return grads(q, k, v, do, lse, delta, causal, scale)[0].contiguous()

    monkeypatch.setattr(torch_fa, "_kernel_fwd", fwd)
    monkeypatch.setattr(torch_fa, "_kernel_dkdv", dkdv)
    monkeypatch.setattr(torch_fa, "_kernel_dq", dq)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dim", [20, 44, 150, 160, 256, 300, 512, 601, 1000])
def test_routes_pad_and_slice_exactly(dim, causal, monkeypatch):
    """The routes as the wrappers run them on the card, in f32 and bf16,
    with the plain versions in place of the launches: q, k, v and dO
    padded with zero columns where the route pads (20 and 44 to the next
    multiple of 8; 150 in bf16, whose three parts run on flash_wide.cu;
    300 and 601 in bf16, whose forward runs on flash_xwide.cu and whose
    dK/dV and dQ run on flash_xwide_bwd.cu at the same width; 150 in f32
    to the next multiple of 4, the forward on flash_fma.cu, dK/dV and dQ
    on flash_fma_bwd.cu) and run with the true scale, O, dQ, dK, dV sliced
    back; 160, 256, 512 and 1000 unpadded (bf16: the wide kernels, or the
    xwide forward and backward; f32: the fma forward and backward).  Zero
    columns add nothing to Q K^T or dO V^T, so the routed results equal
    the unpadded plain versions but for summation order (f32: to 1e-6;
    bf16: the outputs' rounding, 1e-2).  Above 512
    (601, 1000) in bf16 only: 150 holds the f32 pad, and an f32 sum over
    604 columns in another order than over 601 moves dQ by more than
    1e-6."""
    for dtype in (_F32, _BF16):
        if dtype == _F32 and dim > 512:
            continue
        seen = []
        _plain_kernels(monkeypatch, seen)
        q, k, v, do = (x.to(dtype) for x in map(
            torch.from_numpy, _qkv((2, 33, 3, dim), seed=dim)
            + _qkv((2, 33, 3, dim), seed=1)[:1]))
        tol = 1e-6 if dtype == _F32 else 1e-2
        scale = dim ** -0.5
        out, lse = torch_fa._launch_fwd(q, k, v, causal, scale, hm=True)
        ref_out, ref_lse = attention_reference(q, k, v, causal, scale)
        assert out.shape == q.shape and out.is_contiguous()
        assert out.dtype == dtype
        torch.testing.assert_close(out, ref_out, atol=tol, rtol=tol)
        torch.testing.assert_close(lse, ref_lse, atol=1e-6, rtol=1e-6)
        ref = attention_backward_reference(q, k, v, out, lse, do, causal,
                                           scale)
        got = torch_fa._launch_bwd(q, k, v, out, lse, do, causal, scale,
                                   hm=True)
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            assert a.shape == q.shape and a.is_contiguous(), name
            torch.testing.assert_close(a, r, atol=tol, rtol=tol, msg=name)
        # each part on its own kernel, at the one width of the route
        routes = [(part, torch_fa._hm_route(dim, dtype, part))
                  for part in torch_fa.PARTS]
        assert seen == [(part, width, kind)
                        for part, (kind, width) in routes], (dtype, seen)
        assert len({w for _, w, _ in seen}) == 1, seen


# head sizes no 32/64/128 build takes as they are: 20 (padded onto the 24
# build on the card), 160 and 256 (in f32 the forward on flash_fma.cu and
# dK/dV, dQ on flash_fma_bwd.cu, in bf16 flash_wide.cu), 384, 640 and 1024
# (in f32 as 160, in bf16 the forward on flash_xwide.cu and dK/dV, dQ on
# flash_xwide_bwd.cu); the Pallas kernels take them all as they are
_WIDEST_HM_SHAPES = [(1, 64, 2, 640), (1, 64, 2, 1024)]
# in bf16 also 264 and 512: flash_xwide_bwd.cu's 384 build (a box wholly
# past head_dim) and 512 build
_XWIDE_BF16_HM_SHAPES = [(1, 64, 2, 264), (1, 64, 2, 512)]
_ROUTED_HM_SHAPES = [(1, 128, 2, 20), (2, 128, 2, 160), (1, 128, 2, 256),
                     (1, 64, 2, 384)] + _WIDEST_HM_SHAPES


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", _ROUTED_HM_SHAPES,
                         ids=lambda s: f"d{s[-1]}")
def test_flash_hm_routed_head_dims_match_pallas_f32(shape, causal):
    """Forward (O, LSE) and the vjp of the head-major family at head_dim
    20, 160, 256, 384, 640 and 1024 against the head-major Pallas kernels
    (interpret mode, ``native=False``), at the head-major tests'
    tolerances."""
    q, k, v, do = _qkv(shape, seed=shape[-1] + 5) + _qkv(shape, seed=6)[:1]
    ref_out, ref_lse = _jax_flash_hm(q, k, v, causal, jnp.float32)
    out, lse = flash_attention_hm_fwd(*map(torch.from_numpy, (q, k, v)),
                                      causal=causal)
    np.testing.assert_allclose(out.numpy(), ref_out, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), ref_lse, atol=2e-5, rtol=2e-5)
    ref = _jax_flash_grads(q, k, v, do, causal, jnp.float32, native=False)
    got = _torch_flash_grads(q, k, v, do, causal, torch.float32, hm=True)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        tol = 2e-5 if name == "out" else 2e-4
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=name)


# flash_fma_bwd.cu's edges in f32 (on the card 3 column groups of 64 at
# head_dim 136, 5 of 128 at 520, the last 8 wide; 64 keys or queries a
# block, 64-row tiles, 32-row accumulation chunks): causal lengths on
# either side of a tile, and a ragged cross shape not causal.  The Pallas
# kernels take each length as one block.
_FMA_BWD_EDGES = [(1, 1, True), (65, 65, True), (129, 129, True),
                  (65, 191, False)]


@pytest.mark.parametrize("tq,tk,causal", _FMA_BWD_EDGES,
                         ids=lambda e: str(e))
@pytest.mark.parametrize("dim", [136, 520], ids=lambda d: f"d{d}")
def test_flash_hm_fma_bwd_edges_match_pallas_f32(dim, tq, tk, causal):
    """The head-major f32 forward against _flash_forward, then dQ, dK and
    dV on the Pallas forward's O and LSE against _flash_backward (both
    interpret mode), at the f32 tolerance test_flash_bwd_matches_pallas_f32
    holds the backward to (2e-5): the contract the card holds
    flash_fma_bwd.cu to.  Elementwise, not row by row: causal dQ at query
    0 is exactly 0, where row_scaled_err divides by its floor (1% of the
    tensor's RMS), and there the Pallas kernels' own rounding of dP -
    delta reads 3.2e-4 against float64 at head_dim 136, T = 65 (the plain
    version 1e-6)."""
    q, do = _qkv((2, tq, 3, dim), seed=dim + tq)[:2]
    k, v = _qkv((2, tk, 3, dim), seed=dim + tk + 1)[:2]
    scale = dim ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x) for x in (q, k, v, do))
    j_out, j_lse = _flash_forward(jq, jk, jv, causal, scale, 1024, 1024,
                                  True)
    ref = _flash_backward(jq, jk, jv, j_out, j_lse, jdo, causal, scale,
                          1024, 1024, True)
    j_out, j_lse = np.array(j_out), np.array(j_lse)[..., 0]
    tq_, tk_, tv_, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = flash_attention_hm_fwd(tq_, tk_, tv_, causal=causal)
    np.testing.assert_allclose(out.numpy(), j_out, atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(lse.numpy(), j_lse, atol=2e-5, rtol=2e-5)
    got = torch_fa.flash_attention_hm_bwd(
        tq_, tk_, tv_, torch.from_numpy(j_out), torch.from_numpy(j_lse),
        tdo, causal=causal, scale=scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.float32 and a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5,
                                   rtol=2e-5, err_msg=name)


def test_flash_hm_bf16_keeps_dtype():
    """bf16 through the head-major family at odd heads, held as
    test_flash_bwd_bf16_keeps_dtype holds the native family, at its
    length.  Measured (CPU): max |diff| at most 0.42% of the largest
    value, row-scaled at most 0.028 (dq).  The plain forward keeps P in
    f32 where the Pallas kernel rounds it to bf16, so the two O, and the
    delta = rowsum(dO * O) taken from them, differ by bf16 rounding; dQ's
    first rows, P (dP - delta) over two or three keys, cancel and magnify
    it: at 128 positions they read up to 0.26 row-scaled in either
    family."""
    shape = (1, 256, 3, 64)
    q, k, v, do = _qkv(shape, seed=15) + _qkv(shape, seed=16)[:1]
    ref = _jax_flash_grads(q, k, v, do, True, jnp.bfloat16, native=False)
    got = _torch_flash_grads(q, k, v, do, True, torch.bfloat16)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, b, atol=1e-2 * np.abs(b).max(),
                                   rtol=0, err_msg=name)
        rms = np.sqrt(np.square(b).mean(-1))
        rms = np.maximum(rms, 1e-2 * np.sqrt(np.square(b).mean()))
        assert (np.abs(a - b).max(-1) / rms).max() <= 0.1, name


def _bf16_close(a, b, name):
    """bf16 outputs held as test_flash_hm_bf16_keeps_dtype holds them: 1%
    of the largest value, 0.1 row-scaled."""
    np.testing.assert_allclose(a, b, atol=1e-2 * np.abs(b).max(), rtol=0,
                               err_msg=name)
    rms = np.sqrt(np.square(b).mean(-1))
    rms = np.maximum(rms, 1e-2 * np.sqrt(np.square(b).mean()))
    assert (np.abs(a - b).max(-1) / rms).max() <= 0.1, name


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", _XWIDE_BF16_HM_SHAPES,
                         ids=lambda s: f"d{s[-1]}")
def test_flash_hm_xwide_bwd_matches_pallas_bf16(shape, causal):
    """bf16 at head_dim 264 and 512 (on the card flash_xwide.cu's forward
    and flash_xwide_bwd.cu's dK/dV and dQ): the head-major forward against
    _flash_forward, then the head-major backward on the Pallas forward's O
    and LSE against _flash_backward (both interpret mode), each held as
    test_flash_hm_bf16_keeps_dtype holds head_dim 64.  The backward takes
    the Pallas O: the plain forward keeps P in f32 where the Pallas kernel
    rounds it to bf16, and the delta = rowsum(dO * O) taken from the other
    O moves causal dQ at position 1, whose two keys' dS cancel (the whole
    vjp at [1, 64, 2, 512] causal reads 0.48 row-scaled there)."""
    q, k, v, do = _qkv(shape, seed=shape[-1] + 7) + _qkv(shape, seed=3)[:1]
    scale = shape[-1] ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do))
    j_out, j_lse = _flash_forward(jq, jk, jv, causal, scale, 128, 128, True)
    ref = _flash_backward(jq, jk, jv, j_out, j_lse, jdo, causal, scale, 128,
                          128, True)
    tq, tk, tv, tdo = (torch.from_numpy(x).to(torch.bfloat16)
                       for x in (q, k, v, do))
    out, lse = flash_attention_hm_fwd(tq, tk, tv, causal=causal)
    assert out.dtype == torch.bfloat16
    _bf16_close(out.float().numpy(), np.asarray(j_out.astype(jnp.float32)),
                "out")
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse)[..., 0],
                               atol=1e-4, rtol=1e-5)
    got = torch_fa.flash_attention_hm_bwd(
        tq, tk, tv, torch.tensor(np.asarray(
            j_out.astype(jnp.float32))).to(torch.bfloat16),
        torch.tensor(np.asarray(j_lse)[..., 0]), tdo, causal=causal,
        scale=scale)
    for name, a, b in zip(("dq", "dk", "dv"), got, ref):
        assert a.dtype == torch.bfloat16, name
        _bf16_close(a.float().numpy(), np.asarray(b.astype(jnp.float32)),
                    name)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", _WIDEST_HM_SHAPES,
                         ids=lambda s: f"d{s[-1]}")
def test_flash_hm_widest_head_dims_match_pallas_bf16(shape, causal):
    """bf16 through the head-major family at head_dim 640 and 1024 (on the
    card flash_xwide.cu's forward and flash_xwide_bwd.cu's dK/dV and dQ)
    against the head-major Pallas kernels (interpret mode,
    ``native=False``), held as test_flash_hm_bf16_keeps_dtype holds head_dim
    64: 1% of the largest value, 0.1 row-scaled."""
    q, k, v, do = _qkv(shape, seed=shape[-1] + 7) + _qkv(shape, seed=3)[:1]
    ref = _jax_flash_grads(q, k, v, do, causal, jnp.bfloat16, native=False)
    got = _torch_flash_grads(q, k, v, do, causal, torch.bfloat16, hm=True)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, b, atol=1e-2 * np.abs(b).max(),
                                   rtol=0, err_msg=name)
        rms = np.sqrt(np.square(b).mean(-1))
        rms = np.maximum(rms, 1e-2 * np.sqrt(np.square(b).mean()))
        assert (np.abs(a - b).max(-1) / rms).max() <= 0.1, name


@pytest.mark.parametrize("dim", [32, 48, 64, 80, 128, 256])
def test_dispatch_matches_jax(dim, monkeypatch):
    """_nl_eligible and _resolve_native pick the family the JAX package
    picks, over head counts: with its environment switch unset, set to
    force the head-major family, and set to a value that forces
    nothing."""
    for env in (None, "0", "off", "FALSE", "1"):
        if env is None:
            monkeypatch.delenv("RAY_TPU_FLASH_NATIVE", raising=False)
        else:
            monkeypatch.setenv("RAY_TPU_FLASH_NATIVE", env)
        for heads in (1, 2, 3, 4, 5, 8, 12, 20, 25, 32):
            shape = (1, 8, heads, dim)
            x = np.zeros(shape, np.float32)
            t = torch.zeros(shape)
            assert torch_fa._nl_eligible(t, t, t) == \
                jax_fa._nl_eligible(x, x, x), shape
            for native in (None, True, False):
                assert torch_fa._resolve_native(t, t, t, native) == \
                    jax_fa._resolve_native(x, x, x, native), (shape, env,
                                                              native)


def _spy_families(monkeypatch):
    """Record, in order, which family's wrappers and plain versions the
    calls after this one go through."""
    calls = []
    for name in ("attention_reference", "flash_attention_fwd",
                 "flash_attention_bwd", "flash_attention_hm_fwd",
                 "flash_attention_hm_bwd", "attention_backward_reference"):
        real = getattr(torch_fa, name)

        def spy(*a, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*a, **kw)
        monkeypatch.setattr(torch_fa, name, spy)
    return calls


def _family_calls(family):
    hm = "_hm" if family == "hm" else ""
    return [f"flash_attention{hm}_fwd", "attention_reference",
            f"flash_attention{hm}_bwd", "attention_backward_reference"]


@pytest.mark.parametrize("shape,family", [((1, 16, 4, 64), "nl"),
                                          ((1, 16, 25, 64), "hm"),
                                          ((1, 16, 2, 32), "hm"),
                                          ((1, 16, 3, 128), "nl")])
def test_flash_attention_routes_by_shape(shape, family, monkeypatch):
    """flash_attention sends each shape to the family _nl_eligible names,
    forward and backward."""
    monkeypatch.delenv("RAY_TPU_FLASH_NATIVE", raising=False)
    calls = _spy_families(monkeypatch)
    q = torch.randn(shape, requires_grad=True)
    flash_attention(q, q, q).sum().backward()
    assert calls == _family_calls(family)


def test_flash_native_env_switch_moves_the_call(monkeypatch):
    """RAY_TPU_FLASH_NATIVE=0 moves a native-eligible call to the
    head-major family, forward and backward; unset, the call goes back;
    native=False forces the head-major family and native=True the
    native one, whatever the variable says."""
    calls = _spy_families(monkeypatch)
    q = torch.randn((1, 16, 4, 64), requires_grad=True)
    for env, native, family in (("0", None, "hm"), (None, None, "nl"),
                                ("off", True, "nl"), (None, False, "hm")):
        if env is None:
            monkeypatch.delenv("RAY_TPU_FLASH_NATIVE", raising=False)
        else:
            monkeypatch.setenv("RAY_TPU_FLASH_NATIVE", env)
        calls.clear()
        flash_attention(q, q, q, native=native).sum().backward()
        assert calls == _family_calls(family), (env, native)


@pytest.mark.parametrize("shape", [(1, 16, 2, 32), (1, 16, 3, 64),
                                   (1, 16, 2, 48)])
def test_native_true_on_an_ineligible_shape_raises(shape, monkeypatch):
    """native=True on a shape the native-layout kernels do not take
    raises before any kernel or plain version runs, as in the JAX
    package (on the CPU too)."""
    calls = _spy_families(monkeypatch)
    q = torch.randn(shape)
    x = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match="native-layout"):
        jax_flash(x, x, x, native=True)
    with pytest.raises(ValueError, match="native-layout"):
        flash_attention(q, q, q, native=True)
    assert calls == []


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", _HM_SHAPES)
def test_bwd_impl_xla_matches_pallas_f32(shape, causal):
    """flash_attention(native=False, bwd_impl="xla") against the JAX
    package's same call (its head-major Pallas forward in interpret mode,
    then the vjp of ``_attention_reference``): out at 2e-5, gradients at
    the file's backward tolerance, 2e-4."""
    q, k, v, do = _qkv(shape, seed=shape[2] + 40) + _qkv(shape, seed=7)[:1]

    def f(q_, k_, v_):
        return jax_flash(q_, k_, v_, causal=causal, interpret=True,
                         native=False, bwd_impl="xla", block_q=128,
                         block_k=128)
    out, vjp = jax.vjp(f, *(jnp.asarray(x) for x in (q, k, v)))
    ref = [np.asarray(x) for x in (out, *vjp(jnp.asarray(do)))]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    tout = flash_attention(tq, tk, tv, causal=causal, native=False,
                           bwd_impl="xla")
    tout.backward(torch.from_numpy(do))
    got = [x.detach().numpy() for x in (tout, tq.grad, tk.grad, tv.grad)]
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        tol = 2e-5 if name == "out" else 2e-4
        np.testing.assert_allclose(a, b, atol=tol, rtol=tol, err_msg=name)


def test_bwd_impl_xla_saves_qkv_and_recomputes(monkeypatch):
    """With bwd_impl="xla" the forward runs the head-major forward and
    saves q, k and v alone; the backward recomputes the plain attention
    and runs no backward wrapper.  The default keeps the kernels."""
    calls = _spy_families(monkeypatch)
    q = torch.randn((1, 16, 3, 64), requires_grad=True)
    out = flash_attention(q, q, q, native=False, bwd_impl="xla")
    assert len(out.grad_fn.saved_tensors) == 3
    out.sum().backward()
    assert calls == ["flash_attention_hm_fwd", "attention_reference",
                     "attention_reference"]
    calls.clear()
    out = flash_attention(q, q, q, native=False)
    assert len(out.grad_fn.saved_tensors) == 5
    out.sum().backward()
    assert calls == _family_calls("hm")


@pytest.mark.parametrize("shape", [(1, 16, 4, 64), (1, 16, 2, 128),
                                   (1, 16, 3, 64)])
def test_bwd_impl_dispatch_matches_jax(shape, monkeypatch):
    """bwd_impl's dispatch and errors are the JAX package's: with
    native=None a bwd_impl other than "pallas" picks the head-major
    family (under every RAY_TPU_FLASH_NATIVE setting); native=True with
    it raises ValueError in both packages, before any kernel or plain
    version runs."""
    x = np.zeros(shape, np.float32)
    t = torch.zeros(shape)
    for env in (None, "0", "1"):
        if env is None:
            monkeypatch.delenv("RAY_TPU_FLASH_NATIVE", raising=False)
        else:
            monkeypatch.setenv("RAY_TPU_FLASH_NATIVE", env)
        for impl in ("pallas", "xla"):
            for native in (None, False, True):
                assert torch_fa._resolve_native(t, t, t, native, impl) == \
                    jax_fa._resolve_native(x, x, x, native, impl), \
                    (env, impl, native)
    monkeypatch.delenv("RAY_TPU_FLASH_NATIVE", raising=False)
    calls = _spy_families(monkeypatch)
    q = torch.randn(shape, requires_grad=True)
    err = "native-layout" if shape[2] % (128 // shape[3]) else "bwd_impl"
    with pytest.raises(ValueError, match=err):
        jax_flash(x, x, x, native=True, bwd_impl="xla")
    with pytest.raises(ValueError, match=err):
        flash_attention(q, q, q, native=True, bwd_impl="xla")
    assert calls == []
    flash_attention(q, q, q, bwd_impl="xla").sum().backward()
    assert calls[0] == "flash_attention_hm_fwd"
    assert "flash_attention_hm_bwd" not in calls


def test_rmsnorm_bf16_weight_matches_f32_weight():
    """A bf16 weight gives the output of the same values in f32 (the
    kernel reads it cast to f32, as the JAX kernel casts it), and its
    gradient comes back in bf16."""
    from ray_tpu_torch.ops.fused import _kernel_weight
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((3, 5, 256)).astype(
        np.float32)).bfloat16()
    w16 = torch.from_numpy((1 + 0.1 * rng.standard_normal(256)).astype(
        np.float32)).bfloat16().requires_grad_()
    w32 = w16.detach().float().requires_grad_()
    out16, out32 = (fused_rmsnorm(x, w, eps=1e-5) for w in (w16, w32))
    assert torch.equal(out16, out32)
    out16.float().sum().backward()
    out32.float().sum().backward()
    assert w16.grad.dtype == torch.bfloat16
    # one bf16 rounding of the same f32 gradient
    torch.testing.assert_close(w16.grad.float(), w32.grad, atol=0,
                               rtol=2 ** -8)
    kw = _kernel_weight(w16.detach(), 256)
    assert kw.dtype == torch.float32 and kw.is_contiguous()
    assert torch.equal(kw, w32.detach())
    with pytest.raises(ValueError, match=r"shape \(128,\)"):
        _kernel_weight(w16.detach(), 128)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_grad_matches_pallas(dtype):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 8, 256)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
    g = rng.standard_normal((4, 8, 256)).astype(np.float32)
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    _, vjp = jax.vjp(lambda x_, w_: jax_rmsnorm(x_, w_, eps=1e-5,
                                                interpret=True),
                     jnp.asarray(x, jdt), jnp.asarray(w))
    ref_dx, ref_dw = vjp(jnp.asarray(g, jdt))
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    fused_rmsnorm(xt, wt, eps=1e-5).backward(torch.from_numpy(g).to(tdt))
    assert xt.grad.dtype == tdt and wt.grad.dtype == torch.float32
    # f32: summation order only.  bf16: dx is rounded to bf16 on both
    # sides (one ulp, 2**-8 relative); dw sums 32 rows of bf16-rounded
    # products in f32.
    tol = 1e-5 if dtype == "f32" else 1e-2
    np.testing.assert_allclose(xt.grad.float().numpy(),
                               np.asarray(ref_dx.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(ref_dw),
                               atol=tol * 10, rtol=tol)


def test_softmax_cross_entropy_matches_jax():
    rng = np.random.default_rng(11)
    logits = (3 * rng.standard_normal((5, 7, 33))).astype(np.float32)
    labels = rng.integers(0, 33, (5, 7)).astype(np.int32)
    ref, vjp = jax.vjp(
        lambda l_: jax_fused.fused_softmax_cross_entropy(
            l_, jnp.asarray(labels)), jnp.asarray(logits))
    g = rng.standard_normal((5, 7)).astype(np.float32)
    (ref_grad,) = vjp(jnp.asarray(g))
    lt = torch.from_numpy(logits).requires_grad_()
    out = fused_softmax_cross_entropy(lt, torch.from_numpy(labels))
    out.backward(torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(ref_grad),
                               atol=1e-6, rtol=1e-5)


@pytest.mark.parametrize("compute", ["f32", "bf16", "bf16_logits"])
def test_chunked_lm_loss_matches_jax(compute):
    """3 x 29 = 87 tokens in chunks of 32: the last chunk is padded."""
    rng = np.random.default_rng(12)
    hidden = rng.standard_normal((3, 29, 48)).astype(np.float32)
    emb = (0.3 * rng.standard_normal((97, 48))).astype(np.float32)
    labels = rng.integers(0, 97, (3, 29)).astype(np.int32)
    jkw, tkw = {
        "f32": ({}, {}),
        "bf16": ({"compute_dtype": jnp.bfloat16},
                 {"compute_dtype": torch.bfloat16}),
        "bf16_logits": ({"compute_dtype": jnp.bfloat16,
                         "logits_dtype": jnp.bfloat16},
                        {"compute_dtype": torch.bfloat16,
                         "logits_dtype": torch.bfloat16}),
    }[compute]
    ref, (ref_dh, ref_de) = jax.value_and_grad(
        lambda h_, e_: jax_fused.chunked_lm_loss(
            h_, e_, jnp.asarray(labels), chunk=32, **jkw),
        argnums=(0, 1))(jnp.asarray(hidden), jnp.asarray(emb))
    ht = torch.from_numpy(hidden).requires_grad_()
    et = torch.from_numpy(emb).requires_grad_()
    loss = chunked_lm_loss(ht, et, torch.from_numpy(labels), chunk=32,
                           **tkw)
    loss.backward()
    assert loss.dtype == torch.float32 and et.grad.dtype == torch.float32
    # f32 and bf16 operands with f32 logits: the products are exact on
    # both sides and only the summation order differs.  bf16 logits:
    # each logit (|x| up to 8.3) is rounded to bf16 on both sides after
    # sums taken in another order, so a logit can land one ulp (0.03 in
    # [4, 8)) apart.  Measured (CPU): loss 9.2e-4 apart at 6.44, hidden
    # gradients 5.2e-5 and embedding gradients 2.0e-4 apart.
    tol = {"f32": 1e-5, "bf16": 1e-5, "bf16_logits": 2e-3}[compute]
    np.testing.assert_allclose(loss.item(), float(ref), rtol=tol, atol=tol)
    gtol = {"f32": 1e-6, "bf16": 1e-5, "bf16_logits": 2e-3}[compute]
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(ref_dh),
                               atol=gtol, rtol=1e-3)
    np.testing.assert_allclose(et.grad.numpy(), np.asarray(ref_de),
                               atol=gtol, rtol=1e-3)
