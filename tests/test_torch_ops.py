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
from ray_tpu.ops.flash_attention import _flash_forward, _flash_nl_forward
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
    card since the pad route and csrc/flash_generic.cu); a size outside
    raises before any launch, on CPU tensors as on the card."""
    with pytest.raises(ValueError, match="head_dim 1 to 1024"):
        torch_fa._check_head_dim(dim, hm=True)
    if dim:
        x = torch.zeros(1, 2, 1, dim)
        with pytest.raises(ValueError, match="head_dim 1 to 1024"):
            flash_attention_hm_fwd(x, x, x)
        with pytest.raises(ValueError, match="head_dim 1 to 1024"):
            flash_attention(x, x, x, native=False)


@pytest.mark.parametrize("dim,route", [
    (4, ("pad", 8)), (8, ("kernel", 8)), (20, ("pad", 24)),
    (44, ("pad", 48)), (64, ("kernel", 64)), (128, ("kernel", 128)),
    (160, ("generic", 160)), (256, ("generic", 256)),
    (512, ("generic", 512))])
def test_hm_route(dim, route):
    """Where the head-major family runs each head_dim on the card: a
    multiple of 8 up to 128 on kernels #5-#7 as it is, another size below
    128 on them padded to the next multiple of 8, above 128 on
    flash_generic.cu."""
    assert torch_fa._hm_route(dim) == route


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
@pytest.mark.parametrize("dim", [20, 44, 160])
def test_routes_pad_and_slice_exactly(dim, causal, monkeypatch):
    """The routes as the wrappers run them on the card, with the plain
    versions in place of the launches: q, k, v and dO padded with zero
    columns to the next multiple of 8 (20, 44) and run with the true
    scale, O, dQ, dK, dV sliced back; 160 unpadded on the generic
    kernels.  Zero columns add nothing to Q K^T or dO V^T, so the routed
    results equal the unpadded plain versions to the last bit but for
    summation order (f32)."""
    seen = []
    _plain_kernels(monkeypatch, seen)
    q, k, v, do = map(torch.from_numpy,
                      _qkv((2, 33, 3, dim), seed=dim) + _qkv(
                          (2, 33, 3, dim), seed=1)[:1])
    scale = dim ** -0.5
    out, lse = torch_fa._launch_fwd(q, k, v, causal, scale, hm=True)
    ref_out, ref_lse = attention_reference(q, k, v, causal, scale)
    assert out.shape == q.shape and out.is_contiguous()
    torch.testing.assert_close(out, ref_out, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(lse, ref_lse, atol=1e-6, rtol=1e-6)
    ref = attention_backward_reference(q, k, v, out, lse, do, causal, scale)
    got = torch_fa._launch_bwd(q, k, v, out, lse, do, causal, scale,
                               hm=True)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        assert a.shape == q.shape and a.is_contiguous(), name
        torch.testing.assert_close(a, r, atol=1e-6, rtol=1e-6, msg=name)
    route, width = torch_fa._hm_route(dim)
    kind = "generic" if route == "generic" else "hm"
    assert {(w, s) for _, w, s in seen} == {(width, kind)}
    assert [part for part, _, _ in seen] == ["fwd", "dkdv", "dq"]


# head sizes no Hopper build takes as they are: 20 (padded onto the 24
# build on the card) and 160 (flash_generic.cu); the Pallas kernels take
# both as they are
_ROUTED_HM_SHAPES = [(1, 128, 2, 20), (2, 128, 2, 160)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", _ROUTED_HM_SHAPES,
                         ids=lambda s: f"d{s[-1]}")
def test_flash_hm_routed_head_dims_match_pallas_f32(shape, causal):
    """Forward (O, LSE) and the vjp of the head-major family at head_dim
    20 and 160 against the head-major Pallas kernels (interpret mode,
    ``native=False``), at the head-major tests' tolerances."""
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
