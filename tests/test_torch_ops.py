"""The port's kernel wrappers against the JAX package's Pallas kernels.

On the CPU the wrappers compute their plain PyTorch versions; the JAX
side runs the Pallas kernels in interpret mode, as tests/test_ops.py
does.  The CUDA kernels themselves are held against the same plain
versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ray_tpu.ops import fused_rmsnorm as jax_rmsnorm
from ray_tpu.ops.flash_attention import _flash_nl_forward
from ray_tpu.ops.flash_attention import fit_block as jax_fit_block
from ray_tpu.ops.flash_attention import kernel_block_for as jax_kbf
from ray_tpu_torch.ops import (fit_block, flash_attention,
                               flash_attention_fwd, fused_rmsnorm,
                               kernel_block_for)


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


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rmsnorm_matches_pallas(dtype):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 8, 256)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(256)).astype(np.float32)
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


def test_inputs_requiring_grad_raise():
    q = torch.zeros(1, 8, 2, 64, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        flash_attention(q, q.detach(), q.detach())
    x = torch.zeros(2, 64, requires_grad=True)
    with pytest.raises(NotImplementedError, match="training slice"):
        fused_rmsnorm(x, torch.ones(64))
