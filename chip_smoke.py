#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ray_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root

Needs one CUDA device and ``nvcc`` (``$CUDA_HOME`` or /usr/local/cuda);
no network.  Phases, one JSON line each:

1. ``build``: compile ray_tpu_torch/ops/csrc/*.cu for sm_90a into
   build/ray_tpu_torch/ and load the library.
2. ``kernels``: each CUDA kernel against its plain PyTorch version on the
   card, at the serving path's shapes, with its time (CUDA events, median
   of 30 launches after warm-up, L2 flushed before each), the plain
   version's, one library call's (SDPA, F.rms_norm; timed only, never
   used by the port) and the card's bound for the same work.
3. ``model_parity``: Llama-2-7B at full width, 2 layers, f32: the same
   weights on the card (kernels) and on the CPU (plain versions).
4. ``serve``: the full 32-layer Llama-2-7B, bf16, random weights from a
   seed: score 4 x 1024-token requests (flash + RMSNorm kernels), then
   generate through the KV cache (prefill + 64 greedy decode steps).
5. ``train_parity``: GPT-2 at full width (768, 12 heads, vocab 50257),
   2 layers, f32: one training step of the same weights on the card
   (flash forward and backward kernels) and on the CPU (plain versions):
   loss, every gradient, the parameters after one AdamW step.
6. ``train``: GPT-2 124M at bench.py's size and settings (32 x 1024
   tokens, 12 layers, bf16 compute, f32 masters, AdamW 3e-4 with decay
   0.01, bf16 head logits), random weights and one random batch from a
   seed: 1 warm-up and 10 timed steps, then one profiled step (device
   time by kind), one step traced for device activity only (idle share)
   and the LM head's cost by logits dtype.
7. ``train_parity_xl``: as ``train_parity``, for GPT-2 XL (1600 wide,
   25 heads of 64): its odd head count routes attention to the
   head-major kernels, as in the JAX package.
8. ``train_xl``: GPT-2 1.5B at full width and depth (48 layers) on 8 x
   1024 tokens, otherwise as ``train``: 1 warm-up and 5 timed steps on
   the head-major kernels, then the profiled and the traced step.
9. ``vit_parity``: ViT-B/16 at full width, 2 layers, f32, perturbed
   weights, card (flash kernels at T = 197, not causal; cuDNN with TF32
   off) against CPU: logits, loss, every gradient.
10. ``vit``: ViT-B/16 at full depth, bf16 compute, f32 masters, AdamW:
    classify 64 images, then 1 warm-up and 5 timed training steps on 128
    images, a profiled and a device-traced step.
11. ``moe_parity``: the default MoE at full width, 2 layers, f32,
    perturbed weights: routing (exactly), aux loss, logits, loss, every
    gradient.
12. ``moe``: the default MoE (8 layers, 8 experts top-2) on 8 x 1024
    tokens, bf16, AdamW: 1 warm-up and 5 timed steps, a profiled and a
    device-traced step.
13. ``resnet_parity``: ResNet-18 (CIFAR-10) on 8 images, f32, perturbed
    weights and statistics: one training step's logits, loss, every
    gradient and running statistic, then evaluation logits.
14. ``resnet``: ResNet-18 at batch 256, bf16 convolutions: an evaluation
    forward, 1 warm-up and 5 timed training steps (softmax cross entropy,
    AdamW), a profiled and a device-traced step.
15. ``tiny_parity``: the JAX package's ``LlamaConfig.tiny()`` (4 heads
    of 16, 2 KV heads), f32: logits and every gradient on the card (the
    head-major kernels at head_dim 16) against the CPU; then bf16,
    finite.
16. ``head_dims``: GPT-2 of 2 layers at head_dim 160 (csrc/
    flash_generic.cu) and 20 (the head-major kernels on zero-padded
    inputs), f32: one step's loss and every gradient on the card against
    the CPU, with each route's launches.
17. ``runtime``: the port's own cluster, ``init(num_cpus=4,
    num_gpus=1)`` with the object store in /dev/shm: a GPU task returns
    a seeded bf16 [8192, 8192] CUDA tensor (128 MiB) equal to the
    driver's; a CUDA tensor put by the driver is read by a GPU actor
    (round trip timed); the workers' GPU ids, device and modules (no
    JAX); ``shutdown``.
18. ``train_gang``: GPT-2 124M through ``TorchTrainer`` on the port's
    runtime (one GPU worker, streaming ingest from a dataset of seeded
    token rows, 8 steps of 32 x 1024 tokens), its worker killed once
    after a checkpoint at step 4 and resumed from it; every loss against
    the same steps run directly in this process, every batch's checksum,
    the worker's modules and launches (12 of #1/#3/#4 per step), and
    ``TorchPredictor`` on the final checkpoint against the direct model.
19. ``serve_batching``: a ContinuousBatcher deployment of the torch
    ToyDecoder on the card (a quarter of it), 64 concurrent requests of
    16 new tokens by handle, one over HTTP through ``start_proxy``, a
    two-shard gang and a deployment multiplexing two seeds, every
    answer equal to request-at-a-time decode on the card and on the
    CPU; requests/s, tokens/s, latency percentiles, batch steps,
    occupancy and the decode device share.

The ``kernels`` phase also holds the backward kernels (dK/dV and dQ) and
both kernel families (native layout and head-major; head-major at every
head_dim it takes a build for, 32, 64 and 128, and at 16, 48, 80 and 96,
at 20 and 44 on zero-padded inputs and at 160 to 1024 on
csrc/flash_generic.cu, odd head counts, ragged lengths, ViT's non-causal
197, more than 65535 heads in all) against their plain versions, RMSNorm with a bf16 weight
too, and times them at the training shapes (GPT-2 124M and XL, ViT-B/16,
the MoE) beside SDPA.  Each main path (``serve``, ``train``,
``train_xl``, ``vit``, ``moe``, ``resnet``, ``head_dims``, ``runtime``,
``train_gang``, whose worker counts its own, and ``serve_batching``) is
driven with the kernels' launch counts set to 0 just before it and read
just after; the native-layout paths launch no
head-major kernel, GPT-2 XL no native-layout one, and ResNet, the
runtime and the toy decoder's serve path none at all.

Then the kernels' summary line, the card's name and power limit, and,
last, ``{"ok": true, "device": {...}}``.  Any failure raises: no result
line, nonzero exit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
GPT2_SHAPE = (32, 1024, 12, 64)  # q/k/v of GPT-2 124M at bench.py's batch
XL_SHAPE = (8, 1024, 25, 64)  # q/k/v of GPT-2 1.5B at 8 x 1024 tokens
VIT_SHAPE = (128, 197, 12, 64)  # ViT-B/16 at 128 images: 196 patches + CLS
MOE_SHAPE = (8, 1024, 8, 64)  # the default MoE at 8 x 1024 tokens
PEAK_FLOPS = {torch.bfloat16: 989e12,  # dense tensor-core bf16
              torch.float32: 67e12}    # f32 outside the tensor cores
SEED = 0
# bf16 kernel cases at the tiles' edges: causal lengths, and (Tq, Tk) not
# causal
EDGE_LENGTHS = (1, 127, 129, 200, 1000)
CROSS_LENGTHS = (130, 257)
# and at the dQ kernel's own: a consumer's 64-query half of a 128-query
# item, and 64-key stages (at head_dim 128)
DQ_EDGE_LENGTHS = (63, 64, 65, 128)
DQ_CROSS_LENGTHS = (65, 191)
# head-major head sizes between the built ones (32, 64, 128): each runs on
# the next built kernel with its extra columns zeros (by_head_dim in
# csrc/flash_common.cuh); held at these lengths and timed beside the built
# sizes at HEAD_DIM_SHAPE's batch, length and heads
PADDED_HEAD_DIMS = (16, 48, 80, 96)
PADDED_LENGTHS = (1, 129, 1000)
HEAD_DIM_SHAPE = (8, 1024, 16)
# head-major head sizes no build takes as they are (flash_attention.
# _hm_route): 20 and 44 run on the 24 and 48 builds' kernels on
# zero-padded copies, 160 and up on csrc/flash_generic.cu (its blocks own
# 64 rows up to 256, 32 up to 512, 16 up to 1024); each held and timed at
# HEAD_DIM_SHAPE's batch, length and heads, causal and full, and in f32 at
# ROUTED_F32, then held at ragged lengths and at the generic kernels'
# limit
ROUTED_HEAD_DIMS = (20, 44, 160, 256)
ROUTED_WIDE = (2, 512, 4, 512)
ROUTED_F32 = (2, 256, 4)
ROUTED_RAGGED = ((2, 100, 3), (1, 1, 2), (2, 257, 3))
# RMSNorm cases held but not timed: widths (1000 is no multiple of a
# 16-byte vector of bf16, so it takes the one-element path; 1024 takes
# few warps a row; 5120 and 8192 four or eight) at an odd row count, and
# rows of 4096 at one row and at one past a multiple of every block's rows
RMSNORM_WIDTHS = (1000, 1024, 5120, 8192)
RMSNORM_DECODE = (4, 4096)  # a decode step's 4 streams, timed too
RMSNORM_ROWS = (1, 4097)
# flash kernels (O, dQ, dK, dV) against their plain version, row by row:
# the worst, over rows (one D-vector per batch, position and head), of
# max |diff| over the row's RMS in the reference (row_scaled_err).  A
# tensor's max is set by its first positions, where causal rows are
# largest; scaling each row by its own size holds the late rows, whose
# values are ~30x smaller, as tightly as the first ones.  f32: FMA
# kernels against f32 einsums, summation order only.  bf16: P and dS are
# rounded to bf16 on both sides; a score summed in another order rounds
# them the other way, and the output is rounded to bf16 (2**-9 of a value
# up to ~4 row RMS); the forward also rounds P to bf16 where its plain
# version does not.  Measured worst on an H100: f32 1.0e-5 (O), bf16
# 0.037 (O), 0.028 (dQ, dK, dV).  Limits: about twice those; kernels
# that lose one tile of the last 64 positions read 2-5 and fail them
# (scripts/check_flash_tolerance_torch.py).
ROW_TOL = {torch.float32: 2e-5, torch.bfloat16: 8e-2}
# train_parity: card against CPU, both f32 with TF32 off, so summation
# order only; gradients as max |diff| over their tensor's max |value|
TRAIN_PARITY_CHUNK = 512  # 2 x 255 loss positions: one padded chunk
TRAIN_GRAD_TOL = 1e-4
# train: the loss after 10 AdamW steps on one batch, below the first by
# at least this much (measured on an H100: 10.98 -> 9.15)
TRAIN_LOSS_DROP = 0.5
# train_xl: GPT-2 1.5B, 1 warm-up and XL_STEPS steps on one batch; the
# last loss below the first by at least XL_LOSS_DROP (measured on an
# H100: 11.14 -> 9.15)
XL_STEPS = 5
XL_LOSS_DROP = 1.0
# vit, moe, resnet: training steps timed after one warm-up step
MODEL_STEPS = 5
# the parity phases of the new models (vit_parity, moe_parity,
# resnet_parity): card against CPU, both f32 with TF32 off (cuDNN's flag
# too), so summation order only.  Logits within PARITY_LOGIT_TOL (atol
# and rtol), the loss within PARITY_LOSS_RTOL, each gradient within
# TRAIN_GRAD_TOL of its tensor's largest element, ResNet's running
# statistics within PARITY_STAT_TOL (atol and rtol).  A ReLU input within
# RELU_TIE of 0 can take either side on the two devices; resnet_parity
# runs the CPU with the card's ReLU decisions and holds every decision
# that differs to that tie.
PARITY_LOGIT_TOL = 1e-4
PARITY_LOSS_RTOL = 1e-5
PARITY_STAT_TOL = 1e-5
RELU_TIE = 1e-5
# serve phase: cache path against flash path (see the comment there)
SERVE_MAX_ABS = 1.0
SERVE_MEAN_ABS = 0.12
# tiny_parity, bf16: the card's logits against the CPU's, both bf16 (the
# kernels round P to bf16 where the plain forward keeps it in f32);
# measured 0.0036 against logits up to 1.5 on an H100, limit about ten
# times that
TINY_BF16_TOL = 0.04


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


class Timer:
    """Median kernel time in ms from CUDA events.  A 256 MB buffer is
    zeroed before every launch: the L2 (50 MB) starts cold, as it does
    for a layer's input in the model, and the card is busy while the
    host enqueues, so host overhead stays out of the window."""

    def __init__(self, iters: int = 30, warmup: int = 3):
        self.iters, self.warmup = iters, warmup
        self.flush = torch.empty(64 * 2**20, dtype=torch.float32,
                                 device="cuda")

    def __call__(self, fn) -> float:
        for _ in range(self.warmup):
            fn()
        events = []
        for _ in range(self.iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            events.append((start, end))
        torch.cuda.synchronize()
        return statistics.median(s.elapsed_time(e) for s, e in events)


def bound(flops: float, nbytes: float, dtype) -> tuple:
    t_ops = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_mem) * 1e3,
            "operations" if t_ops >= t_mem else "bytes")


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def row_scaled_err(got, ref) -> float:
    """Worst over the rows of the last dimension of max |got - ref| over
    the row's RMS in ``ref``, floored at a hundredth of the tensor's
    RMS.  The floor is for rows whose exact value is 0, where both sides
    hold rounding noise: causal dQ at position 0, whose one dS is
    P (dP - delta) = 0.  It also touches causal dK and dV of the last
    few keys, which see only the last few queries."""
    g, r = got.float(), ref.float()
    rms = r.square().mean(-1).sqrt()
    floor = max(0.01 * r.square().mean().sqrt().item(), 1e-30)
    return ((g - r).abs().amax(-1) / rms.clamp_min(floor)).max().item()


def held_err(name, got, ref, causal) -> float:
    """What a flash kernel's output ``name`` (O, dq, dk, dv) is held to:
    row_scaled_err, except where the exact value is 0 everywhere.  With
    causal and one position, each query sees one key: P = 1 and O = V, so
    dS = P (dP - delta) = 0 and dQ = dK = 0 exactly; both sides hold
    rounding noise, which has no row scale, and the kernel's max |value|
    is held to the same limit instead.  That check only catches garbage:
    dS is about 0 whatever the LSE, scale or mask, so it cannot tell a
    wrong one.  dV (= dO there, nonzero) is held row by row as
    everywhere, and the longer cases hold dQ and dK row by row."""
    if causal and ref.shape[1] == 1 and name in ("dq", "dk"):
        return got.float().abs().max().item()
    return row_scaled_err(got, ref)


def phase_build():
    from ray_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    lines = [ln.strip() for ln in _build.build_log().splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    # a kernel that spills is out of registers; ptxas names the kernel on
    # the "Compiling entry function" line before its counts
    spills, kernel = [], None
    for ln in lines:
        if "Compiling" in ln:
            kernel = ln.split("'")[1]
        elif "spill" in ln and "0 bytes spill stores, 0 bytes spill " \
                "loads" not in ln:
            spills.append((kernel, ln))
    assert not spills, spills
    usage = ptxas_usage(lines)
    emit({"phase": "build", "ok": True,
          "seconds": round(time.perf_counter() - t0, 3),
          "nvcc_seconds": _build.build_seconds,
          "library": str(_build.library_path().relative_to(
              os.path.dirname(os.path.abspath(__file__)))),
          "ptxas": lines})
    return usage


def ptxas_usage(lines):
    """{mangled kernel name: (registers, static shared bytes)} from the
    ptxas lines of the build log."""
    usage, kernel = {}, None
    for ln in lines:
        if "Compiling" in ln:
            kernel = ln.split("'")[1]
        elif kernel and (regs := re.search(r"Used (\d+) registers", ln)):
            smem = re.search(r"(\d+) bytes smem", ln)
            usage[kernel] = (int(regs.group(1)),
                             int(smem.group(1)) if smem else 0)
    return usage


def runtime_attrs(symbol, d):
    """(registers, static shared bytes, dynamic shared bytes) of a bf16
    flash kernel at head_dim ``d`` as the CUDA runtime holds them; the
    dynamic bytes are those its last launch set."""
    import ctypes
    from ray_tpu_torch.ops import _build
    lib = _build.load_library()
    out = (ctypes.c_int * 3)()
    if symbol == "flash_fwd_bf16_kernel":
        rc = lib.rtt_flash_fwd_attrs(d, out)
    else:
        rc = lib.rtt_flash_bwd_attrs(
            {"bwd_dkdv_bf16_kernel": 0, "bwd_dq_bf16_kernel": 1}[symbol], d,
            out)
    _build.check(rc, f"attributes of {symbol}")
    return tuple(out)


def _family(hm):
    """The native-layout or head-major wrappers: (forward, backward)."""
    from ray_tpu_torch.ops.flash_attention import (
        flash_attention_bwd, flash_attention_fwd, flash_attention_hm_bwd,
        flash_attention_hm_fwd)
    return ((flash_attention_hm_fwd, flash_attention_hm_bwd) if hm
            else (flash_attention_fwd, flash_attention_bwd))


def _heads_first(*xs):
    """Contiguous ``[B, H, T, D]`` copies, the layout SDPA takes."""
    return tuple(x.transpose(1, 2).contiguous() for x in xs)


def _case_kernel(hm, d, part):
    """A case's kernel name: the native-layout family's, the head-major
    family's, or flash_generic.cu's where _hm_route sends head_dim d."""
    from ray_tpu_torch.ops.flash_attention import _hm_route
    if not hm:
        return f"flash_{part}"
    return f"flash_{'generic' if _hm_route(d)[0] == 'generic' else 'hm'}_{part}"


def _launched(hm, d):
    """The launch counts a head-major or native-layout call at head_dim d
    moves: (forward, dK/dV, dQ) as (function, attribute)."""
    from ray_tpu_torch.ops.flash_attention import _hm_route
    fwd, bwd = _family(hm)
    if hm and _hm_route(d)[0] == "generic":
        return ((fwd, "launches_generic"), (bwd, "launches_generic_dkdv"),
                (bwd, "launches_generic_dq"))
    return ((fwd, "launches"), (bwd, "launches_dkdv"), (bwd, "launches_dq"))


def flash_case(timer, gen, shape, dtype, causal, timed, hm=False, tk=None):
    """The forward of one family (kernel #1, or #5 with ``hm``) against
    attention_reference; keys ``tk`` long if given (not causal).  Timed:
    the kernel alone."""
    import torch.nn.functional as F
    from ray_tpu_torch.ops.flash_attention import (_launch_fwd,
                                                   attention_reference)
    fwd = _family(hm)[0]
    b, t, h, d = shape
    kv_shape = shape if tk is None else (b, tk, h, d)
    q = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    k, v = (torch.randn(kv_shape, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    scale = d ** -0.5
    counter = _launched(hm, d)[0]
    before = getattr(*counter)
    out, lse = fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert getattr(*counter) == before + 1
    ref, ref_lse = attention_reference(q, k, v, causal, scale)
    # f32: the FMA kernel and the reference differ in summation order
    # only (tests/test_ops.py's 2e-5).  bf16: P is rounded to bf16 before
    # PV, as on the TPU, and O is stored in bf16 (test_ops.py's 3e-2).
    # LSE is f32 from exact bf16 products in both.
    tol = 2e-5 if dtype == torch.float32 else 3e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    row_err = row_scaled_err(out, ref)
    assert row_err <= ROW_TOL[dtype], ("O", row_err, ROW_TOL[dtype])
    res = {"kernel": _case_kernel(hm, d, "fwd"),
           "shape": list(shape), **({} if tk is None else {"tk": tk}),
           "dtype": str(dtype).replace("torch.", ""), "causal": causal,
           "max_abs_err": max_err(out, ref), "lse_max_abs_err":
           max_err(lse, ref_lse), "atol": tol, "row_scaled_err": row_err,
           "row_tol": ROW_TOL[dtype], "launches": 1}
    if timed:
        pairs = t * (t + 1) // 2 if causal else t * t
        flops = 4 * d * b * h * pairs
        nbytes = 4 * q.numel() * q.element_size() + lse.numel() * 4
        res["kernel_ms"] = timer(
            lambda: _launch_fwd(q, k, v, causal, scale, hm=hm))
        res["plain_ms"] = timer(
            lambda: attention_reference(q, k, v, causal, scale))
        qt, kt, vt = _heads_first(q, k, v)
        res["library_ms"] = timer(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes, dtype)
        res["bound_us"] = res["bound_ms"] * 1e3
    return res


def rmsnorm_case(timer, gen, shape, dtype, timed=True, misaligned=False,
                 weight_dtype=torch.float32):
    """The kernel against rmsnorm_reference; ``misaligned``: ``x`` is a
    contiguous view one element past a 16-byte boundary (the kernel's
    one-element path); ``weight_dtype``: the weight's (the wrapper casts
    one that is not f32 to f32 for the kernel)."""
    import torch.nn.functional as F
    from ray_tpu_torch.ops.fused import fused_rmsnorm, rmsnorm_reference
    rows, cols = shape
    eps = 1e-5
    x = torch.randn(rows * cols + misaligned, generator=gen,
                    device="cuda").to(dtype)[int(misaligned):].view(shape)
    w = (1 + 0.1 * torch.randn(cols, generator=gen, device="cuda")).to(
        weight_dtype)
    before = fused_rmsnorm.launches
    out = fused_rmsnorm(x, w, eps=eps)
    torch.cuda.synchronize()
    assert fused_rmsnorm.launches == before + 1
    ref = rmsnorm_reference(x, w, eps)
    # f32: rsqrtf and summation order; bf16: one bf16 ulp (2**-8
    # relative) for a value rounded the other way
    tol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
    res = {"kernel": "rmsnorm", "shape": list(shape),
           "dtype": str(dtype).replace("torch.", ""),
           **({"misaligned": True} if misaligned else {}),
           **({"weight_dtype": str(weight_dtype).replace("torch.", "")}
              if weight_dtype != torch.float32 else {}),
           "max_abs_err": max_err(out, ref), "atol": tol, "launches": 1}
    if timed:
        flops = 4 * rows * cols
        nbytes = 2 * x.numel() * x.element_size() + cols * 4
        w_lib = w.to(dtype)
        res["kernel_ms"] = timer(lambda: fused_rmsnorm(x, w, eps=eps))
        res["plain_ms"] = timer(lambda: rmsnorm_reference(x, w, eps))
        res["library_ms"] = (
            timer(lambda: F.rms_norm(x, (cols,), w_lib, eps))
            if hasattr(F, "rms_norm") else None)
        res["bound_ms"], res["bound_by"] = bound(flops, nbytes,
                                                 torch.float32)
        res["bound_us"] = res["bound_ms"] * 1e3
    return res


def _gradient_err(got, ref):
    """(max |diff|, max |diff| / max |ref|)."""
    err = max_err(got, ref)
    return err, err / max(ref.float().abs().max().item(), 1e-30)


def bwd_case(timer, gen, shape, dtype, causal, timed, hm=False, tk=None):
    """The backward of one family (kernels #3 and #4, or #6 and #7 with
    ``hm``) against attention_backward_reference; keys ``tk`` long if
    given (not causal).  Timed: each kernel alone."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from ray_tpu_torch.ops.flash_attention import (
        _bwd_inputs, _kernel_dkdv, _kernel_dq, _unpad,
        attention_backward_reference, attention_delta)
    fwd, bwd = _family(hm)
    b, t, h, d = shape
    kv_shape = shape if tk is None else (b, tk, h, d)
    q, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn(kv_shape, generator=gen, device="cuda").to(dtype)
            for _ in range(2))
    scale = d ** -0.5
    out, lse = fwd(q, k, v, causal=causal)
    counters = _launched(hm, d)[1:]
    before = [getattr(*c) for c in counters]
    grads = bwd(q, k, v, out, lse, do, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert [getattr(*c) for c in counters] == [n + 1 for n in before]
    ref = attention_backward_reference(q, k, v, out, lse, do, causal, scale)
    tol = ROW_TOL[dtype]
    res = {"kernel": _case_kernel(hm, d, "bwd"),
           "shape": list(shape), **({} if tk is None else {"tk": tk}),
           "dtype": str(dtype).replace("torch.", ""), "causal": causal,
           "row_tol": tol, "launches": 1}
    for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
        assert g.dtype == dtype and torch.isfinite(g).all(), name
        err, rel = _gradient_err(g, r)
        res[f"{name}_max_abs_err"], res[f"{name}_err_over_max"] = err, rel
        res[f"{name}_row_scaled_err"] = row_err = held_err(name, g, r,
                                                           causal)
        assert row_err <= tol, (name, row_err, tol)
    # each kernel's own outputs: dQ from one, dK and dV from the other
    res["max_abs_err_dq"] = res["dq_max_abs_err"]
    res["max_abs_err_dkdv"] = max(res["dk_max_abs_err"],
                                  res["dv_max_abs_err"])
    if timed:
        pairs = t * (t + 1) // 2 if causal else t * t
        one = q.numel() * q.element_size()  # one [B, T, H, D] tensor
        rows = 2 * b * h * t * 4            # lse and delta, f32
        args = (q, k, v, do, lse, attention_delta(out, do), causal, scale)
        # each kernel as the wrapper runs it: inputs padded to the route's
        # width, outputs sliced back (neither copies off the pad route)
        res["kernel_ms_dkdv"] = timer(lambda: [
            _unpad(g, d) for g in _kernel_dkdv(*_bwd_inputs(*args, hm))])
        res["kernel_ms_dq"] = timer(lambda: _unpad(
            _kernel_dq(*_bwd_inputs(*args, hm)), d))
        res["kernel_ms"] = res["kernel_ms_dkdv"] + res["kernel_ms_dq"]
        res["plain_ms"] = timer(lambda: attention_backward_reference(
            q, k, v, out, lse, do, causal, scale))
        # SDPA's backward alone: forward + backward less the forward
        qt, kt, vt, dot = _heads_first(q, k, v, do)
        qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt,
                                                  is_causal=causal)

        def sdpa_ms():
            return timer(sdpa), timer(lambda: torch.autograd.grad(
                sdpa(), (qt, kt, vt), dot))

        # bf16: SDPA's flash backend where it takes the shape; where it
        # refuses (head_dim above 256) and for f32, which it does not
        # take, PyTorch's own pick, as the forward's case times
        res["library_backend"] = "default"
        if dtype == torch.bfloat16:
            try:
                with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                    fwd_ms, both_ms = sdpa_ms()
                res["library_backend"] = "flash"
            except RuntimeError as e:
                if "No available kernel" not in str(e):
                    raise
        if res["library_backend"] == "default":
            fwd_ms, both_ms = sdpa_ms()
        res["library_ms"] = both_ms - fwd_ms
        res["library_fwd_bwd_ms"] = both_ms
        res["bound_ms_dkdv"], res["bound_by_dkdv"] = bound(
            8 * d * b * h * pairs, 6 * one + rows, dtype)
        res["bound_ms_dq"], res["bound_by_dq"] = bound(
            6 * d * b * h * pairs, 5 * one + rows, dtype)
        res["bound_ms"], res["bound_by"] = bound(
            14 * d * b * h * pairs, 7 * one + rows, dtype)
    return res


def phase_kernels():
    timer = Timer()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []

    def add(case):  # printed as it completes
        emit({"phase": "kernels", **case})
        cases.append(case)

    for dtype in (torch.float32, torch.bfloat16):
        for causal in (False, True):
            add(flash_case(timer, gen, (1, 512, 4, 64), dtype,
                           causal, timed=True))
        # ragged: 100 is no multiple of any tile
        add(flash_case(timer, gen, (1, 100, 2, 64), dtype, True,
                       timed=False))
        add(flash_case(timer, gen, (4, 1024, 32, 128), dtype,
                       True, timed=True))
        for shape in ((4096, 4096), RMSNORM_DECODE):
            add(rmsnorm_case(timer, gen, shape, dtype))
        for shape in ([(37, c) for c in RMSNORM_WIDTHS]
                      + [(r, 4096) for r in RMSNORM_ROWS]):
            add(rmsnorm_case(timer, gen, shape, dtype, timed=False))
        add(rmsnorm_case(timer, gen, (37, 4096), dtype, timed=False,
                         misaligned=True))
        add(rmsnorm_case(timer, gen, (37, 4096), dtype, timed=False,
                         weight_dtype=torch.bfloat16))
        # ViT-B/16's ragged self-attention, not causal: 196 patches + CLS
        vit_small = (2,) + VIT_SHAPE[1:]
        add(flash_case(timer, gen, vit_small, dtype, False, timed=False))
        add(bwd_case(timer, gen, vit_small, dtype, False, timed=False))
        for causal in (False, True):
            add(bwd_case(timer, gen, (1, 512, 4, 64), dtype,
                         causal, timed=False))
        for shape in ((1, 100, 2, 64), (1, 256, 3, 128)):
            add(bwd_case(timer, gen, shape, dtype, True,
                         timed=False))
    # the training path's shapes: GPT-2 124M, and a 128-wide head
    add(flash_case(timer, gen, GPT2_SHAPE, torch.bfloat16, True,
                   timed=True))
    for shape in (GPT2_SHAPE, (4, 1024, 32, 128)):
        add(bwd_case(timer, gen, shape, torch.bfloat16, True,
                     timed=True))
    # ViT-B/16's training shape (not causal) and the MoE's (causal)
    for shape, causal in ((VIT_SHAPE, False), (MOE_SHAPE, True)):
        add(flash_case(timer, gen, shape, torch.bfloat16, causal,
                       timed=True))
        add(bwd_case(timer, gen, shape, torch.bfloat16, causal, timed=True))
    # head-major: head_dim 32, 64 and 128, odd head counts, ragged ends
    for dtype in (torch.float32, torch.bfloat16):
        for shape in ((2, 256, 4, 32), (1, 256, 3, 64), (1, 256, 3, 128)):
            for causal in (False, True):
                add(flash_case(timer, gen, shape, dtype, causal,
                               timed=False, hm=True))
                add(bwd_case(timer, gen, shape, dtype, causal,
                             timed=False, hm=True))
        for shape in ((1, 100, 3, 64), (1, 100, 5, 32)):
            add(flash_case(timer, gen, shape, dtype, True,
                           timed=False, hm=True))
            add(bwd_case(timer, gen, shape, dtype, True,
                         timed=False, hm=True))
    # batch * heads above 65535, the old grid's limit, in both families
    for shape, hm in (((1100, 64, 64, 32), True), ((1100, 64, 64, 64), False)):
        add(flash_case(timer, gen, shape, torch.bfloat16, True,
                       timed=False, hm=hm))
        add(bwd_case(timer, gen, shape, torch.bfloat16, True,
                     timed=False, hm=hm))
    # the edges of the bf16 kernels' tiles (128 queries and 128 keys in
    # the forward, 128 keys and 64 queries in dK/dV, 128-query items of two
    # 64-query halves and 128 or 64 keys in dQ), two batches so a ragged
    # end borders the next batch's rows, in both families
    for hm, dims, heads in ((False, (64, 128), 2), (True, (32, 64, 128), 3)):
        for d in dims:
            for t in EDGE_LENGTHS:
                add(flash_case(timer, gen, (2, t, heads, d),
                               torch.bfloat16, True, timed=False,
                               hm=hm))
                add(bwd_case(timer, gen, (2, t, heads, d),
                             torch.bfloat16, True, timed=False,
                             hm=hm))
            for t in DQ_EDGE_LENGTHS:
                add(bwd_case(timer, gen, (2, t, heads, d),
                             torch.bfloat16, True, timed=False,
                             hm=hm))
            tq, tk = CROSS_LENGTHS
            add(flash_case(timer, gen, (2, tq, heads, d),
                           torch.bfloat16, False, timed=False,
                           hm=hm, tk=tk))
            for tq, tk in (CROSS_LENGTHS, DQ_CROSS_LENGTHS):
                add(bwd_case(timer, gen, (2, tq, heads, d),
                             torch.bfloat16, False, timed=False, hm=hm,
                             tk=tk))
    # head-major at the head sizes between the built ones, held like the
    # built ones, then timed beside them at one shape
    for d in PADDED_HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (False, True):
                add(flash_case(timer, gen, (2, 256, 3, d), dtype, causal,
                               timed=False, hm=True))
                add(bwd_case(timer, gen, (2, 256, 3, d), dtype, causal,
                             timed=False, hm=True))
            for t in PADDED_LENGTHS:
                add(flash_case(timer, gen, (2, t, 3, d), dtype, True,
                               timed=False, hm=True))
                add(bwd_case(timer, gen, (2, t, 3, d), dtype, True,
                             timed=False, hm=True))
    for d in sorted(PADDED_HEAD_DIMS + (24, 32, 64, 128)):
        add(flash_case(timer, gen, HEAD_DIM_SHAPE + (d,), torch.bfloat16,
                       True, timed=True, hm=True))
        add(bwd_case(timer, gen, HEAD_DIM_SHAPE + (d,), torch.bfloat16, True,
                     timed=True, hm=True))
    routed_head_dim_cases(timer, gen, add, cases)
    # GPT-2 XL's training shape
    add(flash_case(timer, gen, XL_SHAPE, torch.bfloat16, True,
                   timed=True, hm=True))
    add(bwd_case(timer, gen, XL_SHAPE, torch.bfloat16, True,
                 timed=True, hm=True))
    emit({"phase": "kernels", "ok": True, "cases": len(cases)})
    return cases


def routed_head_dim_cases(timer, gen, add, cases):
    """The head-major family at the head sizes _hm_route pads (20, 44)
    or sends to flash_generic.cu (160 and up), against the plain versions
    at ROW_TOL, forward and backward; then the pad route's cost beside
    its build's (d 20 against 24, 44 against 48), as one line."""
    for d in ROUTED_HEAD_DIMS:
        for causal in (False, True):
            add(flash_case(timer, gen, HEAD_DIM_SHAPE + (d,), torch.bfloat16,
                           causal, timed=True, hm=True))
            add(bwd_case(timer, gen, HEAD_DIM_SHAPE + (d,), torch.bfloat16,
                         causal, timed=True, hm=True))
    for causal in (False, True):
        add(flash_case(timer, gen, ROUTED_WIDE, torch.bfloat16, causal,
                       timed=True, hm=True))
        add(bwd_case(timer, gen, ROUTED_WIDE, torch.bfloat16, causal,
                     timed=True, hm=True))
    for d in ROUTED_HEAD_DIMS + (ROUTED_WIDE[-1],):
        for causal in (False, True):
            add(flash_case(timer, gen, ROUTED_F32 + (d,), torch.float32,
                           causal, timed=True, hm=True))
            add(bwd_case(timer, gen, ROUTED_F32 + (d,), torch.float32,
                         causal, timed=True, hm=True))
    # ragged ends of every route's tiles, one position, Tq != Tk, and the
    # generic kernels' widest head (16-row blocks)
    for d in ROUTED_HEAD_DIMS + (1000, 1024):
        for dtype in (torch.float32, torch.bfloat16):
            for shape in ROUTED_RAGGED:
                add(flash_case(timer, gen, shape + (d,), dtype, True,
                               timed=False, hm=True))
                add(bwd_case(timer, gen, shape + (d,), dtype, True,
                             timed=False, hm=True))
            add(flash_case(timer, gen, (2, 130, 3, d), dtype, False,
                           timed=False, hm=True, tk=257))
            add(bwd_case(timer, gen, (2, 130, 3, d), dtype, False,
                         timed=False, hm=True, tk=257))

    def timed(kind, d):
        return next(c for c in cases if c["kernel"].endswith(kind)
                    and c["shape"] == list(HEAD_DIM_SHAPE + (d,))
                    and c["causal"] and "plain_ms" in c)

    emit({"phase": "kernels", "pad_route_cost": [
        {"head_dim": d, "build": b,
         **{f"{part}_ms": timed(kind, d)[key] for part, kind, key in (
             ("fwd", "fwd", "kernel_ms"), ("dkdv", "bwd", "kernel_ms_dkdv"),
             ("dq", "bwd", "kernel_ms_dq"))},
         **{f"build_{part}_ms": timed(kind, b)[key] for part, kind, key in (
             ("fwd", "fwd", "kernel_ms"), ("dkdv", "bwd", "kernel_ms_dkdv"),
             ("dq", "bwd", "kernel_ms_dq"))}}
        for d, b in ((20, 24), (44, 48))]})


def phase_model_parity():
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.ops.fused import fused_rmsnorm
    cfg = LlamaConfig.llama2_7b(num_layers=2, dtype=torch.float32)
    t0 = time.perf_counter()
    model = Llama(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(SEED))
    tokens = torch.randint(0, cfg.vocab_size, (1, 256),
                           generator=torch.Generator().manual_seed(SEED + 1))
    cpu_logits = model(tokens)
    model.to("cuda")
    fa0, rms0 = flash_attention_fwd.launches, fused_rmsnorm.launches
    gpu_logits = model(tokens.cuda())
    torch.cuda.synchronize()
    fa, rms = (flash_attention_fwd.launches - fa0,
               fused_rmsnorm.launches - rms0)
    assert (fa, rms) == (2, 5), (fa, rms)
    assert torch.isfinite(gpu_logits).all()
    # f32 on both sides, TF32 off: the two differ in summation order
    # only, through two layers and a 4096-wide logits product
    err = max_err(gpu_logits.cpu(), cpu_logits)
    # which positions are off, if any: a fault in one attention row moves
    # all of its position's logits, one in the logits product a few
    per_pos = (gpu_logits.cpu() - cpu_logits).abs().amax(-1).flatten()
    off = {i: per_pos[i].item() for i in
           (per_pos > 1e-4).nonzero().flatten().tolist()[:16]}
    torch.testing.assert_close(
        gpu_logits.cpu(), cpu_logits, atol=1e-3, rtol=1e-3,
        msg=lambda m: f"{m}\npositions off by more than 1e-4: {off}")
    emit({"phase": "model_parity", "ok": True, "config":
          "llama2_7b(num_layers=2, dtype=float32)", "tokens": [1, 256],
          "max_abs_err": err, "max_abs_logit": cpu_logits.abs().max().item(),
          "atol": 1e-3, "flash_launches": fa, "rmsnorm_launches": rms,
          "seconds": round(time.perf_counter() - t0, 3)})
    del model


def _sync_time(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_serve(batch=4, prompt=1024, new_tokens=64):
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.ops.flash_attention import flash_attention_fwd
    from ray_tpu_torch.ops.fused import fused_rmsnorm
    cfg = LlamaConfig.llama2_7b()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model, init_s = _sync_time(lambda: Llama(cfg, device="cuda",
                                             generator=gen))
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                           generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    _zero_counts()
    per_call = (cfg.num_layers, 2 * cfg.num_layers + 1)

    # (a) score: the full-sequence path, twice (the first call warms up)
    for _ in range(2):
        fa0, rms0 = flash_attention_fwd.launches, fused_rmsnorm.launches
        score, score_s = _sync_time(lambda: model(tokens))
        assert (flash_attention_fwd.launches - fa0,
                fused_rmsnorm.launches - rms0) == per_call
    assert torch.isfinite(score).all()

    # (b) generate through the KV cache: prefill, then greedy decode
    caches = model.init_kv_caches(batch, prompt + new_tokens)
    positions = torch.arange(prompt, device="cuda")[None].expand(batch, -1)
    (prefill, caches), prefill_s = _sync_time(
        lambda: model(tokens, positions, caches))
    assert torch.isfinite(prefill).all()
    nxt = prefill[:, -1].argmax(-1, keepdim=True)
    generated, step_logits = [nxt], []

    def decode():
        nonlocal nxt, caches
        for i in range(new_tokens - 1):
            pos = torch.full((batch, 1), prompt + i, device="cuda")
            logits, caches = model(nxt, pos, caches)
            step_logits.append(logits)
            nxt = logits[:, -1].argmax(-1, keepdim=True)
            generated.append(nxt)

    _, decode_s = _sync_time(decode)
    steps = torch.cat(step_logits, dim=1)
    assert torch.isfinite(steps).all()
    launches = {"flash_fwd": flash_attention_fwd.launches,
                "rmsnorm": fused_rmsnorm.launches}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    # The cache path (decode_attention, f32 P) against the flash path
    # (bf16 P) on the same tokens: prompt positions against (a), decoded
    # positions against one full-sequence pass over prompt + generated.
    full = model(torch.cat([tokens, *generated[:-1]], dim=1))
    err_prompt = max_err(prefill, score)
    mean_prompt = (prefill - score).abs().mean().item()
    err_decode = max_err(steps, full[:, prompt:])
    agree = (prefill.argmax(-1) == score.argmax(-1)).float().mean().item()
    scale = score.abs().max().item()
    emit({"phase": "serve", "config": "llama2_7b (32 layers, bf16)",
          "batch": batch, "prompt": prompt, "new_tokens": new_tokens,
          "init_s": init_s, "score_s": score_s,
          "score_tokens_per_s": batch * prompt / score_s,
          "prefill_s": prefill_s,
          "prefill_tokens_per_s": batch * prompt / prefill_s,
          "decode_s": decode_s,
          "decode_tokens_per_s": batch * (new_tokens - 1) / decode_s,
          "peak_memory_gb": peak_gb, "launches": launches,
          "cache_vs_flash_max_abs_err_prompt": err_prompt,
          "cache_vs_flash_max_abs_err_decode": err_decode,
          "cache_vs_flash_mean_abs_err_prompt": mean_prompt,
          "argmax_agreement_prompt": agree, "max_abs_logit": scale,
          "card": card_line()})
    # The flash kernel rounds P to bf16 before PV (as the TPU kernel
    # does); decode_attention keeps P in f32.  Through 32 bf16 layers of
    # random weights that noise grows with depth: max |diff| 0.05 after 1
    # layer, 0.41 after 32, mean 0.053, against logits up to 7.2
    # (scripts/profile_llama_torch.py, H100 80GB HBM3, 700 W).  The
    # limits are about twice the measured values; a wrong mask, scale or
    # cache slot moves logits by whole units.
    assert max(err_prompt, err_decode) <= SERVE_MAX_ABS, (err_prompt,
                                                         err_decode)
    assert mean_prompt <= SERVE_MEAN_ABS, mean_prompt
    emit({"phase": "serve", "ok": True, "max_abs_limit": SERVE_MAX_ABS,
          "mean_abs_limit": SERVE_MEAN_ABS})
    return launches


FLASH_NL = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq")
FLASH_HM = ("flash_hm_fwd", "flash_hm_bwd_dkdv", "flash_hm_bwd_dq")
FLASH_GENERIC = ("flash_generic_fwd", "flash_generic_bwd_dkdv",
                 "flash_generic_bwd_dq")
FLASH_ALL = FLASH_NL + FLASH_HM + FLASH_GENERIC


def _flash_counts():
    nl_fwd, nl_bwd = _family(False)
    hm_fwd, hm_bwd = _family(True)
    return dict(zip(FLASH_ALL, (
        nl_fwd.launches, nl_bwd.launches_dkdv, nl_bwd.launches_dq,
        hm_fwd.launches, hm_bwd.launches_dkdv, hm_bwd.launches_dq,
        hm_fwd.launches_generic, hm_bwd.launches_generic_dkdv,
        hm_bwd.launches_generic_dq)))


def _flash_per(fwd, hm=False, bwd=None, generic=False):
    """Launches of one family's kernels (or, with ``generic``,
    flash_generic.cu's): ``fwd`` forwards and ``bwd`` of each backward
    kernel (default ``fwd``); none of the others."""
    bwd = fwd if bwd is None else bwd
    counts = dict.fromkeys(FLASH_ALL, 0)
    names = FLASH_GENERIC if generic else FLASH_HM if hm else FLASH_NL
    counts.update(zip(names, (fwd, bwd, bwd)))
    return counts


def _zero_counts():
    from ray_tpu_torch.ops.fused import fused_rmsnorm
    for fwd, bwd in (_family(False), _family(True)):
        fwd.launches = bwd.launches_dkdv = bwd.launches_dq = 0
    hm_fwd, hm_bwd = _family(True)
    hm_fwd.launches_generic = 0
    hm_bwd.launches_generic_dkdv = hm_bwd.launches_generic_dq = 0
    fused_rmsnorm.launches = 0


def _free():
    """Return the finished phase's memory before the next model."""
    import gc
    gc.collect()
    torch.cuda.empty_cache()


def _delta(before, after):
    return {k: after[k] - before[k] for k in after}


def phase_train_parity(preset="gpt2_small", hm=False,
                       phase="train_parity"):
    """One training step of a 2-layer, full-width GPT-2 ``preset`` in f32
    on the card (kernels of the family its shape routes to: native
    layout, or head-major with ``hm``) and on the CPU (plain versions)."""
    import copy
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config, adamw, train_step
    cfg = dataclasses.replace(
        getattr(GPT2Config, preset)(dtype=torch.float32), num_layers=2)
    lr = 3e-4
    t0 = time.perf_counter()
    cpu = GPT2(cfg, device="cpu",
               generator=torch.Generator().manual_seed(SEED))
    gpu = copy.deepcopy(cpu).to("cuda")
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    tokens = torch.randint(0, cfg.vocab_size, (2, 256),
                           generator=torch.Generator().manual_seed(SEED + 1))
    kw = dict(head_chunk=TRAIN_PARITY_CHUNK)
    c0 = _flash_counts()
    cpu_loss = train_step(cpu, adamw(cpu.parameters(), lr=lr), tokens,
                          **kw).item()
    c1 = _flash_counts()
    assert c1 == c0, ("CPU step launched kernels", c0, c1)
    gpu_loss = train_step(gpu, adamw(gpu.parameters(), lr=lr),
                          tokens.cuda(), **kw).item()
    torch.cuda.synchronize()
    launched = _delta(c1, _flash_counts())
    assert launched == _flash_per(2, hm), launched
    assert abs(gpu_loss - cpu_loss) <= 1e-5 * abs(cpu_loss), (gpu_loss,
                                                             cpu_loss)
    gpu_params = dict(gpu.named_parameters())
    worst_grad, worst_cos = (0.0, ""), (1.0, "")
    e = cfg.embed_dim
    for name, p in cpu.named_parameters():
        q = gpu_params[name]
        assert torch.isfinite(q.grad).all(), name
        _, rel = _gradient_err(q.grad.cpu(), p.grad)
        worst_grad = max(worst_grad, (rel, name))
        # One AdamW step moves each element by about lr * sign(g) plus
        # the decay, so the updates are compared by direction: a wrong
        # sign on a share s of a tensor's elements costs about 2s of
        # cosine.  An element whose gradient is below eps (1e-8) is
        # noise-driven: the key third of attn_qkv.bias, whose exact
        # gradient is 0 (a key bias shifts every score of a query
        # alike), is left out.  The sums are f64: a CPU f32 dot product
        # over GPT-2 XL's 80 M wte elements of ~lr^2 each loses most of
        # its terms and reads a cosine of 0.93 between two identical
        # updates.
        dc = (p.detach() - before[name]).flatten().double()
        dg = (q.detach().cpu() - before[name]).flatten().double()
        if name.endswith("attn_qkv.bias"):
            dc, dg = torch.cat([dc[:e], dc[2 * e:]]), torch.cat(
                [dg[:e], dg[2 * e:]])
        cos = (torch.dot(dc, dg) / (dc.norm() * dg.norm())).item()
        worst_cos = min(worst_cos, (cos, name))
    assert worst_grad[0] <= TRAIN_GRAD_TOL, worst_grad
    assert worst_cos[0] >= 0.999, worst_cos
    emit({"phase": phase, "ok": True, "config":
          f"{preset}(num_layers=2, dtype=float32)", "tokens": [2, 256],
          "head_chunk": TRAIN_PARITY_CHUNK, "loss_cpu": cpu_loss,
          "loss_gpu": gpu_loss, "worst_grad_err_over_max": worst_grad[0],
          "worst_grad_param": worst_grad[1],
          "grad_tol_err_over_max": TRAIN_GRAD_TOL,
          "worst_update_cosine": worst_cos[0],
          "worst_update_param": worst_cos[1], "launches": launched,
          "seconds": round(time.perf_counter() - t0, 3)})
    del cpu, gpu


MM_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
STEP_RANGE = "chip_smoke_train_step"


def _union_ms(intervals) -> float:
    """Total length of the union of (start, end) intervals in us, in ms."""
    total, end = 0.0, -math.inf
    for s, e in sorted(intervals):
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def profile_step(step, vocab=None):
    """One training step (``step()``) under torch.profiler: device ms by
    kind, and the step's own span.  The span is a host range opened before the step
    and closed after a final synchronize, so it holds all of the step's
    device work; busy is the union of its kernels' intervals, on the
    profiler's one clock.  The device's timestamps are mapped onto that
    clock, and once (GPT-2 XL on an H100) a kernel landed outside the
    range: the span is widened to cover every kernel, and how many fell
    outside, and by how many us, is reported.  Dense and LM-head products
    are told apart by the shapes of the matmul op that launched them (the
    head's carry the vocabulary size ``vocab``); convolutions (forward and
    backward) by their op; the flash kernels by name."""
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        with record_function(STEP_RANGE):
            step()
            torch.cuda.synchronize()
    kinds = dict.fromkeys(("dense", "lm_head", "conv", "flash_fwd",
                           "flash_bwd", "optimizer", "elementwise_other"),
                          0.0)
    kernel_sum, spans, host_range = 0.0, [], None
    for ev in prof.events():
        if ev.name == STEP_RANGE:  # the host range, and its device copy
            if ev.device_type == torch.autograd.DeviceType.CPU:
                host_range = ev
        elif ev.device_type == torch.autograd.DeviceType.CUDA:
            if getattr(ev, "is_user_annotation", False):
                # a host range's copy on the device timeline (that of
                # Optimizer.step) spans kernels counted on their own
                continue
            ms = ev.time_range.elapsed_us() / 1e3
            kernel_sum += ms
            spans.append((ev.time_range.start, ev.time_range.end, ev.name))
            if "flash_fwd" in ev.name:
                kinds["flash_fwd"] += ms
            elif "bwd_dkdv" in ev.name or "bwd_dq" in ev.name:
                kinds["flash_bwd"] += ms
        elif ev.kernels:
            ms = sum(k.duration for k in ev.kernels) / 1e3
            if ev.name in MM_OPS:
                head = any(vocab in shape for shape in ev.input_shapes)
                kinds["lm_head" if head else "dense"] += ms
            elif "convolution" in ev.name:  # cuDNN's, forward or backward
                kinds["conv"] += ms
            elif ev.name.startswith(("aten::_foreach", "aten::_fused_adam")):
                kinds["optimizer"] += ms
    kinds["elementwise_other"] = kernel_sum - sum(kinds.values())
    t0, t1 = host_range.time_range.start, host_range.time_range.end
    outside = [(name, s - t0, e - t1) for s, e, name in spans
               if s < t0 or e > t1]
    t0 = min([t0] + [s for s, _, _ in spans])
    t1 = max([t1] + [e for _, e, _ in spans])
    wall = (t1 - t0) / 1e3
    busy = _union_ms([(s, e) for s, e, _ in spans])
    return {"device_ms_by_kind": kinds, "kernels": len(spans),
            "kernel_ms_sum": kernel_sum, "busy_ms": busy, "wall_ms": wall,
            "idle_share": 1 - busy / wall, "outside_host_range":
            {"count": len(outside), "first": outside[:3]}}


def device_traced_step(step):
    """One training step (``step()``) traced for device activity only:
    the host does little more work than in an untraced step, which a step
    of many launches needs (with host ops and shapes traced, GPT-2 XL's
    profiled step stretches past its kernels).  Its wall time on the host
    clock, between two synchronizes, against the union of its kernels'
    intervals."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    spans = [(ev.time_range.start, ev.time_range.end)
             for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA
             and not getattr(ev, "is_user_annotation", False)]
    assert spans, "no kernel in the device-only trace"
    busy = _union_ms(spans)
    return {"kernels": len(spans), "busy_ms": busy, "wall_ms": wall,
            "idle_share": 1 - busy / wall}


def head_cost(model, tokens, timer):
    """The chunked LM head's forward + backward at the training shape,
    by logits dtype: bf16 logits (the bench's setting) against f32
    logits from bf16 operands, which the port takes by upcasting the
    operands to f32."""
    from ray_tpu_torch.ops.fused import chunked_lm_loss
    with torch.no_grad():
        x, _ = model.hidden(tokens)
    x = x[:, :-1].detach().requires_grad_()
    out = {}
    for name, dt in (("bf16_logits", torch.bfloat16),
                     ("f32_logits_upcast", None)):
        def run():
            loss = chunked_lm_loss(x, model.wte, tokens[:, 1:],
                                   compute_dtype=torch.bfloat16,
                                   logits_dtype=dt)
            torch.autograd.grad(loss, (x, model.wte))
        out[name] = timer(run)
    return out


def train_loop(step, steps, per_step, loss_drop=0.0):
    """One warm-up and ``steps`` timed calls of ``step()`` (which returns
    the loss), each launching ``per_step`` flash kernels; the last loss
    below the first by more than ``loss_drop``: (losses, warm-up s, timed
    s)."""
    losses = []

    def one():
        c0 = _flash_counts()
        losses.append(step())
        assert _delta(c0, _flash_counts()) == per_step

    _, warm_s = _sync_time(one)
    _, elapsed = _sync_time(lambda: [one() for _ in range(steps)])
    losses = [x.item() for x in losses]
    assert all(map(math.isfinite, losses)), losses
    assert losses[-1] < losses[0] - loss_drop, ("the loss did not fall",
                                                losses)
    return losses, warm_s, elapsed


def _rmsnorm_launches():
    from ray_tpu_torch.ops.fused import fused_rmsnorm
    return fused_rmsnorm.launches


def optimizer_step(model, opt, loss_fn, *args):
    """One training step: the loss, its gradient, one optimizer update."""
    opt.zero_grad(set_to_none=True)
    loss = loss_fn(model, *args)
    loss.backward()
    opt.step()
    return loss.detach()


def phase_model_train(phase, config, build, data, loss_fn, *, steps,
                      per_step, units, vocab=None, loss_drop=0.0,
                      infer=None, extra=None, **fields):
    """What every training phase measures, from random weights and one
    random batch.  ``build(gen)`` makes the model on the card (timed)
    and ``data(gen)`` its batch, a tuple, from one generator seeded
    ``SEED``; a step is :func:`optimizer_step` of ``loss_fn(model,
    *batch)`` under AdamW(3e-4, weight decay 0.01).  The launch counts
    are zeroed; ``infer(model, *batch)``, where given, runs without
    gradients and returns fields of the phase's line; then 1 warm-up and
    ``steps`` timed steps (:func:`train_loop`: ``per_step`` flash
    launches each, the loss falling by more than ``loss_drop``), after
    which no RMSNorm kernel may have run; the counts and the peak memory
    are read; one profiled step (LM-head products told apart by
    ``vocab``) and one device-traced step follow; last, ``extra(model,
    line, *batch)`` returns the phase's own fields, given the line so
    far.  ``units`` is (name, count per step), the rate ``{name}_per_s``;
    ``fields`` join the line.  Returns the launch counts."""
    from ray_tpu_torch.models.gpt2 import adamw
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model, init_s = _sync_time(lambda: build(gen))
    opt = adamw(model.parameters(), lr=3e-4, weight_decay=0.01)
    inputs = data(gen)
    line = {"phase": phase, "config": config,
            "num_params": sum(p.numel() for p in model.parameters()),
            **fields}
    _zero_counts()
    if infer is not None:
        with torch.no_grad():
            line.update(infer(model, *inputs))
    torch.cuda.reset_peak_memory_stats()
    step = lambda: optimizer_step(model, opt, loss_fn, *inputs)  # noqa: E731
    losses, warm_s, elapsed = train_loop(step, steps, per_step, loss_drop)
    launches = {**_flash_counts(), "rmsnorm": _rmsnorm_launches()}
    assert launches["rmsnorm"] == 0, launches
    name, count = units
    line.update({
        "steps": steps, "warmup_steps": 1, "init_s": init_s,
        "warmup_s": warm_s, "step_ms": elapsed / steps * 1e3,
        f"{name}_per_s": count * steps / elapsed,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "losses": losses, "loss_drop_min": loss_drop,
        "launches_per_step": per_step, "launches": launches,
        "profiled_step": profile_step(step, vocab),
        "device_traced_step": device_traced_step(step)})
    if extra is not None:
        line.update(extra(model, line, *inputs))
    line["card"] = card_line()
    emit(line)
    emit({"phase": phase, "ok": True})
    return launches


def phase_train(preset="gpt2_small", batch=32, seq=1024, steps=10,
                hm=False, loss_drop=TRAIN_LOSS_DROP, phase="train",
                with_head_cost=True):
    """Train GPT-2 ``preset`` at full width and depth
    (:func:`phase_model_train`) on ``batch`` x ``seq`` tokens with bf16
    LM-head logits, each step launching every flash kernel of its family
    (head-major with ``hm``) once per layer and none of the other family;
    then, ``with_head_cost``, the LM head's cost by logits dtype."""
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn
    cfg = getattr(GPT2Config, preset)(max_seq_len=seq)

    def extra(model, line, tokens):
        return {"mfu": line["tokens_per_s"] * cfg.flops_per_token()
                / PEAK_FLOPS[torch.bfloat16],
                "lm_head_fwd_bwd_ms": head_cost(
                    model, tokens, Timer(iters=5, warmup=1))
                if with_head_cost else None}

    return phase_model_train(
        phase, f"{preset} ({cfg.num_layers} layers, {cfg.embed_dim} wide, "
        f"{cfg.num_heads} heads, bf16 compute, f32 masters, "
        f"remat={cfg.remat!r})",
        lambda gen: GPT2(cfg, device="cuda", generator=gen),
        lambda gen: (torch.randint(0, cfg.vocab_size, (batch, seq),
                                   generator=gen, device="cuda"),),
        lambda model, tokens: loss_fn(model, tokens,
                                      head_logits_dtype=torch.bfloat16),
        steps=steps, per_step=_flash_per(cfg.num_layers, hm),
        units=("tokens", batch * seq), vocab=cfg.vocab_size,
        loss_drop=loss_drop, extra=extra, batch=batch, seq=seq,
        flops_per_token=cfg.flops_per_token())


@contextlib.contextmanager
def no_tf32():
    """f32 products and convolutions in full f32: cuDNN's TF32 flag is on
    by default in PyTorch (the matmul flag is off and stays off)."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        assert not torch.backends.cuda.matmul.allow_tf32
        assert not torch.backends.cudnn.allow_tf32
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def perturb_(model, seed):
    """Every parameter plus normal noise (std 0.05), so that no zero CLS
    token, bias or last BatchNorm scale hides its part of the model;
    BatchNorm running means plus noise (std 0.1) and running variances
    scaled by a factor in [0.5, 1.5]."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
        for name, b in model.named_buffers():
            if name.endswith("running_var"):
                b.mul_(0.5 + torch.rand(b.shape, generator=gen))
            else:
                b.add_(0.1 * torch.randn(b.shape, generator=gen))


def step_grads(model, loss_fn, *args):
    """The loss of ``loss_fn(model, *args)`` and every gradient."""
    model.zero_grad(set_to_none=True)
    loss = loss_fn(model, *args)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def hold_parity(phase, cpu_logits, gpu_logits, cpu_loss, gpu_loss,
                cpu_grads, gpu_grads):
    """Hold the card's logits, loss and every gradient to the CPU's at
    the f32 parity limits; return the readings."""
    err = max_err(gpu_logits.cpu(), cpu_logits)
    scale = cpu_logits.abs().max().item()
    torch.testing.assert_close(gpu_logits.cpu(), cpu_logits,
                               atol=PARITY_LOGIT_TOL, rtol=PARITY_LOGIT_TOL)
    assert abs(gpu_loss - cpu_loss) <= PARITY_LOSS_RTOL * abs(cpu_loss), \
        (phase, gpu_loss, cpu_loss)
    assert set(cpu_grads) == set(gpu_grads)
    worst = (0.0, "")
    for name, g in cpu_grads.items():
        assert torch.isfinite(gpu_grads[name]).all(), name
        worst = max(worst, (_gradient_err(gpu_grads[name].cpu(), g)[1],
                            name))
    assert worst[0] <= TRAIN_GRAD_TOL, (phase, worst)
    return {"logits_max_abs_err": err, "max_abs_logit": scale,
            "logits_tol": PARITY_LOGIT_TOL, "loss_cpu": cpu_loss,
            "loss_gpu": gpu_loss, "loss_rtol": PARITY_LOSS_RTOL,
            "worst_grad_err_over_max": worst[0],
            "worst_grad_param": worst[1],
            "grad_tol_err_over_max": TRAIN_GRAD_TOL,
            "params": len(cpu_grads)}


def phase_vit_parity(batch=4):
    """ViT-B/16 at full width, 2 layers, f32, perturbed weights: logits,
    the loss and every gradient on the card (flash kernels #1, #3, #4 at
    T = 197, not causal; cuDNN's patch embedding) against the CPU (plain
    versions)."""
    import copy
    from ray_tpu_torch.models.vit import ViT, ViTConfig, loss_fn
    cfg = ViTConfig.base(num_layers=2, dtype=torch.float32)
    t0 = time.perf_counter()
    cpu = ViT(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    perturb_(cpu, SEED + 2)
    gpu = copy.deepcopy(cpu).to("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    images = torch.randn(batch, cfg.image_size, cfg.image_size, 3,
                         generator=gen)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen)
    with torch.no_grad():
        cpu_logits = cpu(images)
    cpu_loss, cpu_grads = step_grads(cpu, loss_fn, images, labels)
    c0 = _flash_counts()
    with no_tf32():
        with torch.no_grad():
            gpu_logits = gpu(images.cuda())
        gpu_loss, gpu_grads = step_grads(gpu, loss_fn, images.cuda(),
                                         labels.cuda())
    torch.cuda.synchronize()
    launched = _delta(c0, _flash_counts())
    assert launched == _flash_per(2 * cfg.num_layers,
                                  bwd=cfg.num_layers), launched
    readings = hold_parity("vit_parity", cpu_logits, gpu_logits, cpu_loss,
                           gpu_loss, cpu_grads, gpu_grads)
    emit({"phase": "vit_parity", "ok": True, "config":
          "ViTConfig.base(num_layers=2, dtype=float32), perturbed",
          "images": [batch, cfg.image_size, cfg.image_size, 3], **readings,
          "launches": launched,
          "seconds": round(time.perf_counter() - t0, 3)})


def phase_moe_parity(batch=2, seq=256):
    """The default MoE at full width (512, 8 heads of 64, 8 experts top-2,
    vocab 32000), 2 layers, f32, perturbed weights: each layer's routing
    (expert indices and buffer positions, exactly), its aux loss, the
    logits, the loss and every gradient on the card against the CPU."""
    import copy
    from ray_tpu_torch.models.moe import MoEConfig, MoETransformer, loss_fn
    cfg = MoEConfig(num_layers=2, dtype=torch.float32)
    t0 = time.perf_counter()
    cpu = MoETransformer(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(SEED))
    perturb_(cpu, SEED + 2)
    gpu = copy.deepcopy(cpu).to("cuda")
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(SEED + 1))
    with torch.no_grad():
        cpu_logits = cpu(tokens)
        cpu_routing = cpu.hidden(tokens)[2]
    cpu_loss, cpu_grads = step_grads(cpu, loss_fn, tokens)
    c0 = _flash_counts()
    with no_tf32():
        with torch.no_grad():
            gpu_logits = gpu(tokens.cuda())
            gpu_routing = gpu.hidden(tokens.cuda())[2]
        gpu_loss, gpu_grads = step_grads(gpu, loss_fn, tokens.cuda())
    torch.cuda.synchronize()
    launched = _delta(c0, _flash_counts())
    assert launched == _flash_per(3 * cfg.num_layers,
                                  bwd=cfg.num_layers), launched
    # routing: the same experts and buffer positions for every token; the
    # smallest gap between a token's k-th and (k+1)-th probability says
    # how near a tie the data came
    capacity, margin, dropped, aux_err = cfg.capacity(batch * seq), 1.0, 0, 0
    for c, g in zip(cpu_routing, gpu_routing):
        assert torch.equal(g.experts.cpu(), c.experts), "expert indices"
        assert torch.equal(g.slots.cpu(), c.slots), "buffer positions"
        top = c.probs.sort(-1, descending=True).values
        margin = min(margin, (top[:, cfg.top_k - 1]
                              - top[:, cfg.top_k]).min().item())
        dropped += int((c.slots >= capacity).sum())
        aux_err = max(aux_err, abs(g.aux.item() - c.aux.item())
                      / c.aux.item())
    assert aux_err <= PARITY_LOSS_RTOL, aux_err
    readings = hold_parity("moe_parity", cpu_logits, gpu_logits, cpu_loss,
                           gpu_loss, cpu_grads, gpu_grads)
    emit({"phase": "moe_parity", "ok": True, "config":
          "MoEConfig(num_layers=2, dtype=float32), perturbed",
          "tokens": [batch, seq], "capacity": capacity,
          "routing_equal": True, "choices_dropped": dropped,
          "smallest_top_k_margin": margin, "aux_rel_err": aux_err,
          **readings, "launches": launched,
          "seconds": round(time.perf_counter() - t0, 3)})


@contextlib.contextmanager
def relu_inputs(record=None, replay=None):
    """Within the block, ``torch.nn.functional.relu`` either appends each
    input to ``record`` (CPU copies) or takes its decisions from the
    inputs in ``replay``, in call order, and holds every decision it
    changes to a tie (both inputs within RELU_TIE of 0).  Yields the list
    of flips per call."""
    import torch.nn.functional as F
    real, flips = F.relu, []
    recorded = iter(replay or ())

    def relu(x):
        if record is not None:
            record.append(x.detach().cpu())
            return real(x)
        other = next(recorded).to(x.device)
        keep = other > 0
        flip = keep != (x > 0)
        assert x.detach()[flip].abs().le(RELU_TIE).all() and \
            other[flip].abs().le(RELU_TIE).all(), "a ReLU flip beyond a tie"
        flips.append(int(flip.sum()))
        return x * keep

    F.relu = relu
    try:
        yield flips
    finally:
        F.relu = real


def _resnet_loss(model, images, labels):
    """Mean softmax cross entropy of a training-mode forward (the JAX
    package has no ResNet loss)."""
    import torch.nn.functional as F
    return F.cross_entropy(model(images, train=True), labels)


def phase_resnet_parity(batch=8):
    """The whole ResNet-18 (CIFAR-10: 32 x 32 x 3, 10 classes), f32,
    perturbed weights and BatchNorm statistics, one training-mode step on
    the card (cuDNN) and on the CPU: logits, the loss, every gradient and
    every running statistic after the update; then evaluation-mode
    logits.  ReLU's gradient jumps at 0, so the CPU step takes the card's
    ReLU decisions (relu_inputs), each one it changes held to a tie."""
    import copy
    from ray_tpu_torch.models.resnet import ResNet, ResNetConfig
    cfg = ResNetConfig.resnet18(dtype=torch.float32)
    t0 = time.perf_counter()
    cpu = ResNet(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(SEED))
    perturb_(cpu, SEED + 2)
    gpu = copy.deepcopy(cpu).to("cuda")
    gen = torch.Generator().manual_seed(SEED + 1)
    images = torch.randn(batch, 32, 32, 3, generator=gen)
    labels = torch.randint(0, cfg.num_classes, (batch,), generator=gen)
    c0 = {**_flash_counts(), "rmsnorm": _rmsnorm_launches()}
    card = []
    with no_tf32():
        with relu_inputs(record=card):
            gpu_logits = gpu(images.cuda(), train=True)
            gpu_loss, gpu_grads = step_grads(gpu, _resnet_loss,
                                             images.cuda(), labels.cuda())
        with torch.no_grad():
            gpu_eval = gpu(images.cuda(), train=False)
    torch.cuda.synchronize()
    assert {**_flash_counts(), "rmsnorm": _rmsnorm_launches()} == c0
    # the card ran two training-mode passes (logits, then the step), so
    # its running statistics moved twice: so do the CPU's
    with relu_inputs(replay=card) as flips:
        cpu_logits = cpu(images, train=True)
        cpu_loss, cpu_grads = step_grads(cpu, _resnet_loss, images, labels)
    readings = hold_parity("resnet_parity", cpu_logits.detach(),
                           gpu_logits.detach(), cpu_loss, gpu_loss,
                           cpu_grads, gpu_grads)
    stat_err = 0.0
    gpu_buffers = dict(gpu.named_buffers())
    for name, b in cpu.named_buffers():
        torch.testing.assert_close(gpu_buffers[name].cpu(), b,
                                   atol=PARITY_STAT_TOL,
                                   rtol=PARITY_STAT_TOL, msg=name)
        stat_err = max(stat_err, max_err(gpu_buffers[name].cpu(), b))
    with torch.no_grad():
        cpu_eval = cpu(images, train=False)
    torch.testing.assert_close(gpu_eval.cpu(), cpu_eval,
                               atol=PARITY_LOGIT_TOL, rtol=PARITY_LOGIT_TOL)
    emit({"phase": "resnet_parity", "ok": True, "config":
          "ResNetConfig.resnet18(dtype=float32), perturbed",
          "images": [batch, 32, 32, 3], **readings,
          "running_stats_max_abs_err": stat_err,
          "stat_tol": PARITY_STAT_TOL,
          "eval_logits_max_abs_err": max_err(gpu_eval.cpu(), cpu_eval),
          "relu_calls": len(flips), "relu_ties_flipped": sum(flips),
          "relu_tie": RELU_TIE, "flash_and_rmsnorm_launches": 0,
          "seconds": round(time.perf_counter() - t0, 3)})


def phase_vit(infer_batch=64, batch=128, steps=MODEL_STEPS):
    """ViT-B/16 at full width and depth (12 layers, 768 wide, 12 heads of
    64, 224 x 224 images, 1000 classes), bf16 compute, f32 masters:
    classify ``infer_batch`` images (a warm-up call, then a timed one,
    which launches the forward kernel once per layer and nothing else),
    then train on ``batch`` images (:func:`phase_model_train`)."""
    from ray_tpu_torch.models.vit import ViT, ViTConfig, loss_fn
    cfg = ViTConfig.base()
    per_forward = _flash_per(cfg.num_layers, bwd=0)

    def infer(model, images, labels):
        model(images[:infer_batch])
        c0 = _flash_counts()
        logits, infer_s = _sync_time(lambda: model(images[:infer_batch]))
        assert _delta(c0, _flash_counts()) == per_forward
        assert logits.shape == (infer_batch, cfg.num_classes)
        assert torch.isfinite(logits).all()
        return {"infer_batch": infer_batch, "infer_s": infer_s,
                "infer_images_per_s": infer_batch / infer_s,
                "launches_per_forward": per_forward}

    return phase_model_train(
        "vit", "ViTConfig.base() (ViT-B/16: 12 layers, 768 wide, 12 heads "
        "of 64, T = 197), bf16 compute, f32 masters",
        lambda gen: ViT(cfg, device="cuda", generator=gen),
        lambda gen: (torch.randn(batch, cfg.image_size, cfg.image_size, 3,
                                 generator=gen, device="cuda"),
                     torch.randint(0, cfg.num_classes, (batch,),
                                   generator=gen, device="cuda")),
        loss_fn, steps=steps, per_step=_flash_per(cfg.num_layers),
        units=("images", batch), infer=infer, batch=batch)


def phase_moe(batch=8, seq=1024, steps=MODEL_STEPS):
    """The default MoE transformer (MoEConfig(): 8 layers, 512 wide, 8
    heads of 64, 8 experts top-2, capacity factor 1.25, vocab 32000) on
    ``batch`` x ``seq`` tokens, bf16 compute, f32 masters
    (:func:`phase_model_train`); after it, each layer's aux loss (finite)
    and the choices past their expert's capacity, from one forward."""
    from ray_tpu_torch.models.moe import MoEConfig, MoETransformer, loss_fn
    cfg = MoEConfig()
    capacity = cfg.capacity(batch * seq)

    def extra(model, line, tokens):
        with torch.no_grad():
            routings = model.hidden(tokens)[2]
        aux = [r.aux.item() for r in routings]
        assert all(map(math.isfinite, aux)), aux
        return {"aux_losses": aux, "choices_dropped": sum(
            int((r.slots >= capacity).sum()) for r in routings),
            "choices": cfg.num_layers * batch * seq * cfg.top_k}

    return phase_model_train(
        "moe", "MoEConfig() (8 layers, 512 wide, 8 heads of 64, 8 experts "
        "top-2, capacity factor 1.25, vocab 32000), bf16 compute, f32 "
        "masters",
        lambda gen: MoETransformer(cfg, device="cuda", generator=gen),
        lambda gen: (torch.randint(0, cfg.vocab_size, (batch, seq),
                                   generator=gen, device="cuda"),),
        loss_fn, steps=steps, per_step=_flash_per(cfg.num_layers),
        units=("tokens", batch * seq), vocab=cfg.vocab_size, extra=extra,
        batch=batch, seq=seq, capacity=capacity)


def phase_resnet(batch=256, steps=MODEL_STEPS):
    """ResNet-18 for CIFAR-10 (32 x 32 x 3, 10 classes) at batch
    ``batch``, bf16 convolutions (cuDNN, channels-last), f32 BatchNorm,
    a mean softmax cross entropy: an evaluation-mode forward (a warm-up
    call, then a timed one), then training (:func:`phase_model_train`);
    no flash or RMSNorm kernel runs."""
    from ray_tpu_torch.models.resnet import ResNet, ResNetConfig
    cfg = ResNetConfig.resnet18()

    def infer(model, images, labels):
        model(images, train=False)
        logits, infer_s = _sync_time(lambda: model(images, train=False))
        assert torch.isfinite(logits).all()
        assert not any(_flash_counts().values())
        return {"infer_s": infer_s, "infer_images_per_s": batch / infer_s}

    return phase_model_train(
        "resnet", "ResNetConfig.resnet18() (CIFAR-10: 32 x 32 x 3, 10 "
        "classes), bf16 convolutions, f32 BatchNorm",
        lambda gen: ResNet(cfg, device="cuda", generator=gen),
        lambda gen: (torch.randn(batch, 32, 32, 3, generator=gen,
                                 device="cuda"),
                     torch.randint(0, cfg.num_classes, (batch,),
                                   generator=gen, device="cuda")),
        _resnet_loss, steps=steps, per_step=_flash_per(0),
        units=("images", batch), infer=infer, batch=batch)


def phase_tiny_parity(batch=2, seq=128):
    """The JAX package's ``LlamaConfig.tiny()`` (4 heads of 16, 2 KV
    heads) on the card against the port's CPU path, f32, TF32 off: the
    logits and every gradient of a loss over them.  Head_dim 16 takes the
    head-major kernels (#5, #6, #7) on their 32-column build, the columns
    past 16 zeros; then the same weights in bf16, the card's logits
    against the CPU's."""
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    from ray_tpu_torch.ops.fused import fused_rmsnorm
    cfg = LlamaConfig.tiny(dtype=torch.float32)
    model = Llama(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(SEED))
    model.requires_grad_(True)  # the model is built for inference
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(SEED + 1))

    def logits_and_grads(m, tok):
        m.zero_grad(set_to_none=True)
        logits = m(tok)
        logits.float().square().mean().backward()
        # copies: moving the module to the card moves its grads in place
        return logits.detach().to("cpu", copy=True), {
            n: p.grad.to("cpu", copy=True) for n, p in m.named_parameters()}

    cpu_logits, cpu_grads = logits_and_grads(model, tokens)
    model.to("cuda")
    with no_tf32():
        _zero_counts()
        gpu_logits, gpu_grads = logits_and_grads(model, tokens.cuda())
        torch.cuda.synchronize()
        launches = {**_flash_counts(), "rmsnorm": fused_rmsnorm.launches}
    assert launches == {**_flash_per(cfg.num_layers, hm=True),
                        "rmsnorm": 2 * cfg.num_layers + 1}, launches
    err = max_err(gpu_logits, cpu_logits)
    torch.testing.assert_close(gpu_logits, cpu_logits, atol=PARITY_LOGIT_TOL,
                               rtol=PARITY_LOGIT_TOL)
    grad_err = {n: _gradient_err(gpu_grads[n], g)[1]
                for n, g in cpu_grads.items()}
    worst = max(grad_err, key=grad_err.get)
    assert grad_err[worst] <= TRAIN_GRAD_TOL, (worst, grad_err[worst])
    # the preset's own compute dtype, bf16: the card (bf16 kernels)
    # against the CPU (plain versions) on the same bf16 weights.  Not
    # against the f32 model: torch 2.11 draws other values for a bf16
    # tensor's normal_ than for an f32 one from the same generator
    bf16 = Llama(LlamaConfig.tiny(), device="cpu",
                 generator=torch.Generator().manual_seed(SEED))
    bf16_cpu = bf16(tokens)
    bf16_logits = bf16.to("cuda")(tokens.cuda()).cpu()
    assert torch.isfinite(bf16_logits).all()
    bf16_err = max_err(bf16_logits, bf16_cpu)
    assert bf16_err <= TINY_BF16_TOL, (bf16_err, TINY_BF16_TOL)
    emit({"phase": "tiny_parity", "ok": True,
          "config": "LlamaConfig.tiny() (2 layers, 4 heads of 16, 2 KV heads)",
          "tokens": [batch, seq], "max_abs_err": err,
          "max_abs_logit": cpu_logits.abs().max().item(),
          "atol": PARITY_LOGIT_TOL, "worst_grad": worst,
          "worst_grad_err_over_max": grad_err[worst],
          "grad_tol": TRAIN_GRAD_TOL, "launches": launches,
          "bf16_max_abs_err": bf16_err, "bf16_atol": TINY_BF16_TOL})
    del model, bf16


# runtime: the object store lives in /dev/shm; the phase moves RUNTIME_MIB
# tensors and sizes the store at RUNTIME_STORE_MIB, refusing a smaller
# /dev/shm with a clear message
RUNTIME_MIB = 128
RUNTIME_STORE_MIB = 2048
# serve_batching: the toy decoder behind ContinuousBatcher on the card
SERVE_REQUESTS = 64
SERVE_NEW_TOKENS = 16
SERVE_BATCHING = {"max_batch_size": 8, "max_seq_len": 64}
SERVE_GPU_SHARE = 0.25  # of the one card, per replica or gang member


def phase_runtime():
    """The port's runtime on the card: ``init(num_cpus=4, num_gpus=1)``,
    a GPU task returning a CUDA tensor through the object store, a CUDA
    tensor put by the driver and read by a GPU actor, the workers'
    GPU ids and modules, ``shutdown``.  Returns the runtime's launch
    counts of the port's kernels (none: the runtime launches no kernel
    of the port)."""
    import ray_tpu_torch as rt

    st = os.statvfs("/dev/shm")
    shm = st.f_bavail * st.f_frsize
    need = RUNTIME_STORE_MIB * 2**20
    if shm < need:
        raise RuntimeError(
            f"/dev/shm has {shm / 2**20:.0f} MiB free; the runtime phase "
            f"sizes the object store at {RUNTIME_STORE_MIB} MiB there")
    n = int(math.isqrt(RUNTIME_MIB * 2**20 // 2))  # bf16 [n, n]
    nbytes = n * n * 2

    def seeded(seed):
        import torch
        gen = torch.Generator(device="cuda").manual_seed(seed)
        return torch.randn(n, n, generator=gen, device="cuda").to(
            torch.bfloat16)

    @rt.remote(num_gpus=1)
    def build_on_card(seed):
        import sys
        import torch
        t = seeded(seed)
        torch.cuda.synchronize()
        bad = sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "jaxlib", "flax", "optax", "ray_tpu"))
        return t, rt.get_gpu_ids(), torch.cuda.get_device_name(), bad

    @rt.remote(num_gpus=0.5)
    class Reader:
        def warm(self):
            import torch
            torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            return rt.get_gpu_ids()

        def checksum(self, t):
            import time as _time
            import torch
            t0 = _time.perf_counter()
            assert t.is_cuda
            total = t.view(torch.int16).to(torch.int64).sum().item()
            return total, _time.perf_counter() - t0

    _zero_counts()
    before = _flash_counts()
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1, object_store_memory=need)
    init_s = time.perf_counter() - t0
    try:
        assert rt.cluster_resources().get("GPU") == 1.0
        # (a) a GPU task builds the tensor on the card and returns it
        t0 = time.perf_counter()
        out, ids, name, bad = rt.get(build_on_card.remote(SEED), timeout=300)
        task_s = time.perf_counter() - t0
        want = seeded(SEED)
        assert out.is_cuda and out.dtype == torch.bfloat16
        assert torch.equal(out.view(torch.int16), want.view(torch.int16))
        assert ids == [0], ids
        assert name == torch.cuda.get_device_name(0), name
        assert not bad, bad
        # (b) the driver puts a CUDA tensor; a warm GPU actor reads it
        reader = Reader.remote()
        assert rt.get(reader.warm.remote(), timeout=300) == [0]
        x = seeded(SEED + 1)
        expect = x.view(torch.int16).to(torch.int64).sum().item()
        trips = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ref = rt.put(x)
            t_put = time.perf_counter() - t0
            total, t_sum = rt.get(reader.checksum.remote(ref), timeout=300)
            trips.append((time.perf_counter() - t0, t_put, t_sum))
            assert total == expect, (total, expect)
            del ref
        trip_s, put_s, sum_s = min(trips)
        launches = _delta(before, _flash_counts())
        rt.kill(reader)
    finally:
        t0 = time.perf_counter()
        rt.shutdown()
        shutdown_s = time.perf_counter() - t0
    emit({"phase": "runtime", "ok": True, "dev_shm_free_mib": shm / 2**20,
          "object_store_mib": RUNTIME_STORE_MIB, "init_s": init_s,
          "tensor": [n, n], "tensor_mib": nbytes / 2**20,
          "gpu_task_return_s": task_s, "worker_gpu_ids": ids,
          "worker_device": name, "put_s": put_s, "round_trip_s": trip_s,
          "round_trip_gb_per_s": nbytes / trip_s / 1e9,
          "actor_checksum_s": sum_s, "round_trips_s": [t[0] for t in trips],
          "shutdown_s": shutdown_s, "card": card_line()})
    return launches


# head_dims: GPT-2 of 2 layers (GPT2Config.tiny's vocabulary and length)
# at head sizes only the routes take: (heads, width) for head_dim 160
# (flash_generic.cu) and 20 (zero-padded onto the 24 build's kernels)
HEAD_DIM_MODELS = ((4, 640), (4, 80))


def phase_head_dim_parity(batch=2, seq=128):
    """The model path through the routed head-major kernels: one
    training step's loss and every gradient of each HEAD_DIM_MODELS
    GPT-2, f32, TF32 off, on the card against the CPU, with its launches
    (2 of each flash_generic.cu kernel for head_dim 160; 2 of #5, #6, #7
    for head_dim 20).  Returns the launch counts of both."""
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn
    from ray_tpu_torch.ops.flash_attention import _hm_route
    rows, total = [], dict.fromkeys(FLASH_ALL, 0)
    for heads, width in HEAD_DIM_MODELS:
        cfg = GPT2Config.tiny(dtype=torch.float32, num_heads=heads,
                              embed_dim=width, max_seq_len=seq)
        d = width // heads
        model = GPT2(cfg, device="cpu",
                     generator=torch.Generator().manual_seed(SEED))
        tokens = torch.randint(
            0, cfg.vocab_size, (batch, seq),
            generator=torch.Generator().manual_seed(SEED + 1))
        cpu_loss, cpu_grads = step_grads(model, loss_fn, tokens)
        cpu_grads = {n: g.clone() for n, g in cpu_grads.items()}
        model.to("cuda")
        with no_tf32():
            _zero_counts()
            gpu_loss, gpu_grads = step_grads(model, loss_fn, tokens.cuda())
            torch.cuda.synchronize()
            launches = _flash_counts()
        route = _hm_route(d)[0]
        assert launches == _flash_per(cfg.num_layers, hm=True,
                                      generic=route == "generic"), launches
        assert abs(gpu_loss - cpu_loss) <= PARITY_LOSS_RTOL * abs(cpu_loss), (
            gpu_loss, cpu_loss)
        grad_err = {n: _gradient_err(gpu_grads[n].cpu(), g)[1]
                    for n, g in cpu_grads.items()}
        worst = max(grad_err, key=grad_err.get)
        assert grad_err[worst] <= TRAIN_GRAD_TOL, (d, worst, grad_err[worst])
        rows.append({"head_dim": d, "route": route, "heads": heads,
                     "width": width, "loss_cpu": cpu_loss,
                     "loss_gpu": gpu_loss, "worst_grad": worst,
                     "worst_grad_err_over_max": grad_err[worst],
                     "launches": {k: v for k, v in launches.items() if v}})
        total = {k: total[k] + launches[k] for k in total}
        del model
    emit({"phase": "head_dims", "ok": True,
          "config": "GPT2Config.tiny(dtype=float32, num_heads, embed_dim)",
          "tokens": [batch, seq], "grad_tol_err_over_max": TRAIN_GRAD_TOL,
          "loss_rtol": PARITY_LOSS_RTOL, "models": rows})
    return total


# train_gang: GPT-2 124M through TorchTrainer on the port's runtime,
# GANG_STEPS steps of 32 x 1024 tokens; the loop reports a checkpoint
# (model and AdamW state) after GANG_KILL_AFTER steps and its process
# dies once, and FailureConfig(max_failures=1) resumes it from there.
# The object store carries the 1.5 GB checkpoint back to this process.
GANG_STEPS = 8
GANG_KILL_AFTER = 4
GANG_STORE_MIB = 4096
# losses through the trainer against the direct run's: the same weights,
# batches and kernels on one card give the same sums, so 0 is expected;
# rtol 1e-3 leaves room for a reduction whose order changes between runs
GANG_LOSS_RTOL = 1e-3
GANG_PROBE = (4, 64)  # predictor: sequences x tokens
GANG_WAIT_S = 600  # the loop's bounded wait for its checkpoint's registration


def gang_train_loop(config):
    """TorchTrainer's loop for train_gang, on the GPU worker: GPT-2 124M
    from ``config["seed"]``, AdamW(3e-4, 0.01), the dataset shard through
    ``to_torch``, each step between ``session.step_monitor()`` brackets,
    every step reported, checkpoints after ``kill_after`` steps and at
    the end.  The first attempt dies after its checkpoint is registered
    (``config["marker"]`` records that it did); a resumed attempt restores
    the model and optimizer and skips the batches it has done."""
    import hashlib
    import json as _json
    import os as _os
    import sys as _sys
    import time as _time
    import torch as _torch
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config, adamw, train_step
    from ray_tpu_torch.ops.flash_attention import (flash_attention_bwd,
                                                   flash_attention_fwd,
                                                   flash_attention_hm_bwd,
                                                   flash_attention_hm_fwd)
    from ray_tpu_torch.ops.fused import fused_rmsnorm
    from ray_tpu_torch.train import Checkpoint, session

    t_start = _time.time()
    counters = ((flash_attention_fwd, "launches"),
                (flash_attention_bwd, "launches_dkdv"),
                (flash_attention_bwd, "launches_dq"),
                (flash_attention_hm_fwd, "launches"),
                (flash_attention_hm_fwd, "launches_generic"),
                (flash_attention_hm_bwd, "launches_dkdv"),
                (flash_attention_hm_bwd, "launches_dq"),
                (flash_attention_hm_bwd, "launches_generic_dkdv"),
                (flash_attention_hm_bwd, "launches_generic_dq"),
                (fused_rmsnorm, "launches"))
    for fn, attr in counters:
        setattr(fn, attr, 0)

    def counts():
        names = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                 "flash_hm_fwd", "flash_generic_fwd", "flash_hm_bwd_dkdv",
                 "flash_hm_bwd_dq", "flash_generic_bwd_dkdv",
                 "flash_generic_bwd_dq", "rmsnorm")
        return {n: getattr(fn, a) for n, (fn, a) in zip(names, counters)}

    cfg = GPT2Config.gpt2_small(max_seq_len=config["seq"])
    model = GPT2(cfg, device="cuda", generator=_torch.Generator(
        device="cuda").manual_seed(config["seed"]))
    opt = adamw(model.parameters(), lr=3e-4, weight_decay=0.01)
    start, resumed = 0, session.get_checkpoint()
    t_restored = None
    if resumed is not None:
        tree = resumed.to_pytree({"model": model.state_dict(),
                                  "optim": opt.state_dict(), "step": 0})
        model.load_state_dict(tree["model"])
        opt.load_state_dict(tree["optim"])
        start = tree["step"]
        t_restored = _time.time()
    mon = session.step_monitor()
    mon.flops_per_token = cfg.flops_per_token()
    shard = session.get_dataset_shard("train")
    batches = iter(shard.to_torch(batch_size=config["batch"]))
    for step in range(1, config["steps"] + 1):
        t0 = _time.perf_counter()
        tokens = next(batches)["data"]
        wait = _time.perf_counter() - t0
        if step <= start:
            continue  # done before the restart
        before = counts()
        span = mon.step(data_wait_s=wait)
        t1 = _time.perf_counter()
        loss = train_step(model, opt, tokens,
                          head_logits_dtype=_torch.bfloat16)
        span.dispatched()
        span.device_done(loss)
        step_s = _time.perf_counter() - t1
        span.done(tokens=float(tokens.numel()))
        after = counts()
        metrics = {
            "step": step, "loss": loss.item(), "attempt": 2 if resumed else 1,
            "step_s": step_s, "data_wait_s": wait,
            "batch_sha1": hashlib.sha1(
                tokens.cpu().numpy().tobytes()).hexdigest(),
            "launches": {k: after[k] - before[k] for k in after},
            "device": mon.stats(), "t_loop_start": t_start,
            "t_restored": t_restored,
            "gpu": _torch.cuda.get_device_name(),
            "foreign_modules": sorted(
                {m.split(".")[0] for m in _sys.modules}
                & {"jax", "jaxlib", "flax", "optax", "ray_tpu"})}
        if _os.path.exists(config["marker"]):
            with open(config["marker"]) as f:
                metrics["killed"] = _json.load(f)
        ckpt = None
        if step in (config["kill_after"], config["steps"]):
            ckpt = Checkpoint.from_pytree(
                {"model": model.state_dict(), "optim": opt.state_dict(),
                 "step": step})
            metrics["ckpt_bytes"] = len(ckpt.to_dict()["pytree_torch"])
        t_report = _time.time()
        session.report(metrics, checkpoint=ckpt)
        if step == config["kill_after"] and not resumed \
                and not _os.path.exists(config["marker"]):
            # die once the trainer holds the checkpoint on disk
            registered = _os.path.join(config["storage"], "checkpoint_000001",
                                       ".metrics.json")
            deadline = _time.time() + config["wait_s"]
            while not _os.path.exists(registered):
                if _time.time() > deadline:
                    raise TimeoutError(f"{registered} never appeared")
                _time.sleep(0.05)
            with open(config["marker"], "w") as f:
                _json.dump({"t_kill": _time.time(),
                            "report_to_registered_s":
                            _time.time() - t_report,
                            "ckpt_bytes": metrics["ckpt_bytes"]}, f)
            _os._exit(1)


def phase_train_gang(steps=GANG_STEPS, kill_after=GANG_KILL_AFTER,
                     batch=32, seq=1024):
    """GPT-2 124M through ``TorchTrainer`` on the port's runtime (the
    path of the JAX package's examples/train_gpt2.py): the direct run of
    ``train_step`` on the same seed and batches first, then the trainer
    with streaming ingest over a dataset of the same token rows, one
    injected worker death and a resume from the checkpoint; every loss
    against the direct run's, every batch's checksum against this
    process's, the worker's modules and launches, and the final
    checkpoint through ``TorchPredictor`` against the direct model's
    logits.  Returns the worker's launch counts over both attempts."""
    import hashlib
    import shutil
    import tempfile
    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch import data as rdata
    from ray_tpu_torch.data.context import DataContext
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config, adamw, train_step
    from ray_tpu_torch.train import (FailureConfig, RunConfig, ScalingConfig,
                                     TorchPredictor, TorchTrainer)

    st = os.statvfs("/dev/shm")
    if st.f_bavail * st.f_frsize < GANG_STORE_MIB * 2**20:
        raise RuntimeError(f"/dev/shm has less than {GANG_STORE_MIB} MiB "
                           "free; train_gang sizes the object store there")
    cfg = GPT2Config.gpt2_small(max_seq_len=seq)
    rows = np.random.default_rng(SEED + 7).integers(
        0, cfg.vocab_size, (steps * batch, seq), dtype=np.int64)
    batches = [rows[i * batch:(i + 1) * batch] for i in range(steps)]
    digests = [hashlib.sha1(b.tobytes()).hexdigest() for b in batches]
    probe = rows[:GANG_PROBE[0], :GANG_PROBE[1]]

    # 1. the direct reference in this process, then its memory freed
    model = GPT2(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(SEED))
    opt = adamw(model.parameters(), lr=3e-4, weight_decay=0.01)
    direct, direct_s = [], []
    for b in batches:
        tokens = torch.as_tensor(b).cuda()
        t0 = time.perf_counter()
        loss = train_step(model, opt, tokens,
                          head_logits_dtype=torch.bfloat16)
        direct.append(loss.item())
        direct_s.append(time.perf_counter() - t0)
    with torch.inference_mode():
        direct_logits = model.eval()(
            torch.as_tensor(probe).cuda()).float().cpu()
    del model, opt, loss, tokens
    _free()

    # 2. the trainer, on the same seed and rows
    store = tempfile.mkdtemp(prefix="chip_smoke_gang_")
    ctx = DataContext.get_current()
    ctx.streaming_train_ingest = True
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1,
            object_store_memory=GANG_STORE_MIB * 2**20)
    init_s = time.perf_counter() - t0
    try:
        trainer = TorchTrainer(
            gang_train_loop,
            train_loop_config={"seed": SEED, "steps": steps, "batch": batch,
                               "seq": seq,
                               "kill_after": kill_after, "storage": store,
                               "marker": os.path.join(store, "killed.json"),
                               "wait_s": GANG_WAIT_S},
            scaling_config=ScalingConfig(num_workers=1,
                                         gpus_per_worker=1),
            datasets={"train": rdata.from_numpy(batches)},
            run_config=RunConfig(name="chip_smoke_train_gang",
                                 storage_path=store,
                                 failure_config=FailureConfig(
                                     max_failures=1)))
        t_fit = time.time()
        result = trainer.fit()
        fit_s = time.time() - t_fit
    finally:
        ctx.streaming_train_ingest = False
        t0 = time.perf_counter()
        rt.shutdown()
        shutdown_s = time.perf_counter() - t0
    try:
        assert result.error is None, result.error
        hist = result.metrics_history
        assert [h["step"] for h in hist] == list(range(1, steps + 1)), [
            h["step"] for h in hist]
        assert [h["attempt"] for h in hist] == [1] * kill_after + [2] * (
            steps - kill_after)
        assert [h["batch_sha1"] for h in hist] == digests
        diffs = [abs(h["loss"] - d) for h, d in zip(hist, direct)]
        for h, d in zip(hist, direct):
            assert abs(h["loss"] - d) <= GANG_LOSS_RTOL * abs(d), (
                h["step"], h["loss"], d)
        assert all(not h["foreign_modules"] for h in hist), hist[-1]
        per_step = {**_flash_per(cfg.num_layers), "rmsnorm": 0}
        for h in hist:
            assert h["launches"] == per_step, (h["step"], h["launches"])
        launches = dict.fromkeys(FLASH_ALL, 0)
        for h in hist:
            for k in launches:
                launches[k] += h["launches"][k]
        # 3. the final checkpoint through TorchPredictor
        t0 = time.perf_counter()
        predictor = TorchPredictor.from_checkpoint(
            result.checkpoint, model=GPT2(cfg, device="cuda"))
        logits = torch.from_numpy(predictor.predict({"data": probe})[
            "predictions"])
        predictor_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(store, ignore_errors=True)
    # one bf16 ulp at the largest logit: the weights are the same f32
    # masters, so 0 is expected; a rounding of the bf16 compute that
    # flips costs at most one ulp
    logit_err = max_err(logits, direct_logits)
    logit_tol = 2.0 ** -7 * direct_logits.abs().max().item()
    assert logit_err <= logit_tol, (logit_err, logit_tol)
    first, second = hist[:kill_after], hist[kill_after:]
    killed = second[0]["killed"]
    timed = [h for h in first[1:] + second[1:]]  # each attempt's first is warm-up
    step_ms = statistics.mean(h["step_s"] for h in timed) * 1e3
    direct_ms = statistics.mean(direct_s[1:]) * 1e3
    emit({"phase": "train_gang", "ok": True,
          "config": f"gpt2_small ({cfg.num_layers} layers, {cfg.embed_dim} "
          "wide, bf16 compute, f32 masters, AdamW(3e-4, 0.01), bf16 head "
          "logits) through TorchTrainer(ScalingConfig(num_workers=1, "
          "gpus_per_worker=1), FailureConfig(max_failures=1)), "
          "streaming ingest",
          "batch": batch, "seq": seq, "steps": steps,
          "killed_after_step": kill_after, "init_s": init_s,
          "gang_start_s": first[0]["t_loop_start"] - t_fit,
          "restart_s": second[0]["t_loop_start"] - killed["t_kill"],
          "restore_s": second[0]["t_restored"] - second[0]["t_loop_start"],
          "fit_s": fit_s, "shutdown_s": shutdown_s,
          "step_ms": step_ms, "tokens_per_s": batch * seq / step_ms * 1e3,
          "direct_step_ms": direct_ms,
          "step_ms_each": [h["step_s"] * 1e3 for h in hist],
          "direct_step_ms_each": [t * 1e3 for t in direct_s],
          "mfu": second[-1]["device"]["mfu"],
          "mfu_steady": batch * seq / step_ms * 1e3 * cfg.flops_per_token()
          / PEAK_FLOPS[torch.bfloat16],
          "mfu_attempt_1": first[-1]["device"]["mfu"],
          "device_frac": second[-1]["device"]["device_frac"],
          "batch_wait_p50_s": statistics.median(
              h["data_wait_s"] for h in hist),
          "ckpt_bytes": killed["ckpt_bytes"],
          "ckpt_report_to_registered_s": killed["report_to_registered_s"],
          "losses": [h["loss"] for h in hist], "direct_losses": direct,
          "loss_rtol": GANG_LOSS_RTOL, "loss_max_abs_diff": max(diffs),
          "batches_equal": True, "worker_gpu": hist[0]["gpu"],
          "foreign_modules": [], "launches_per_step": per_step,
          "launches": {k: v for k, v in launches.items() if v},
          "predictor_s": predictor_s, "predictor_probe": list(GANG_PROBE),
          "predictor_max_abs_err": logit_err,
          "predictor_atol": logit_tol, "card": card_line()})
    return launches


def _top2_margin(engine, payloads):
    """The smallest gap between the two largest logits over the decode
    steps of ``payloads`` (request at a time): how close the greedy
    choice came to a tie."""
    smallest = math.inf
    for p in payloads:
        state = engine.begin_request(dict(p, prompt=list(p["prompt"])))
        seq = state["tokens"]
        for _ in range(p["max_new_tokens"]):
            tokens = torch.tensor([seq], device=engine.device)
            pooled = engine._pooled(tokens, torch.tensor(
                [len(seq)], device=engine.device), engine._embed)
            logits = torch.tanh(pooled @ engine._w1) @ engine._w2
            logits[:, engine.pad_token] = -1e9
            top = logits.topk(2, dim=-1).values[0]
            smallest = min(smallest, (top[0] - top[1]).item())
            nxt = int(logits.argmax(-1)[0])
            seq.append(nxt)
            if nxt == engine.eos_token:
                break
    return smallest


def phase_serve_batching():
    """The port's continuous-batching serve path on the card: a
    ContinuousBatcher deployment of the torch ToyDecoder (fractional
    GPU), SERVE_REQUESTS concurrent requests by handle, one over HTTP, a
    two-shard gang on the same card and a multiplexed deployment
    swapping two seeds, each answer held to request-at-a-time decode on
    the card and on the CPU."""
    import urllib.request

    import ray_tpu_torch as rt
    from ray_tpu_torch import serve
    from ray_tpu_torch.serve.http_proxy import start_proxy
    from ray_tpu_torch.serve.toy_decoder import (ToyDecoder,
                                                 ToyDecoderShard,
                                                 make_prompt)

    payloads = [{"prompt": make_prompt(i),
                 "max_new_tokens": SERVE_NEW_TOKENS}
                for i in range(SERVE_REQUESTS)]
    card_engine, cpu_engine = ToyDecoder(), ToyDecoder(device="cpu")

    def expected(engine, ps):
        return [engine.generate_unbatched(dict(p, prompt=list(p["prompt"])))
                ["tokens"] for p in ps]

    want_card = expected(card_engine, payloads)
    want_cpu = expected(cpu_engine, payloads)
    if want_card != want_cpu:
        raise AssertionError(
            "request-at-a-time tokens differ between the card and the CPU; "
            f"smallest top-2 logit margin {_top2_margin(card_engine, payloads)}")
    opts = {"ray_actor_options": {"num_gpus": SERVE_GPU_SHARE}}
    _zero_counts()
    before = _flash_counts()
    rt.init(num_cpus=4, num_gpus=1,
            object_store_memory=RUNTIME_STORE_MIB * 2**20)
    try:
        dep = serve.deployment(name="toy", batching=dict(SERVE_BATCHING),
                               max_concurrent_queries=SERVE_REQUESTS,
                               **opts)(ToyDecoder)
        handle = serve.run(dep.bind())
        handle.call({"prompt": [2], "max_new_tokens": 2}, timeout=300)
        t0 = time.perf_counter()
        pending = {handle.remote(dict(p)): i for i, p in enumerate(payloads)}
        outs, latency = [None] * len(payloads), []
        while pending:
            ready, _ = rt.wait(list(pending), num_returns=1, timeout=300)
            assert ready, "serve requests timed out"
            i = pending.pop(ready[0])
            outs[i] = rt.get(ready[0], timeout=60)["tokens"]
            latency.append(time.perf_counter() - t0)
        wall = time.perf_counter() - t0
        if outs != want_card:
            wrong = [i for i, (a, b) in enumerate(zip(outs, want_card))
                     if a != b]
            raise AssertionError(
                f"batched tokens differ from request-at-a-time decode at "
                f"requests {wrong[:8]}; smallest top-2 logit margin "
                f"{_top2_margin(card_engine, [payloads[i] for i in wrong])}")
        from ray_tpu_torch.serve._internal import CONTROLLER_NAME
        controller = rt.get_actor(CONTROLLER_NAME)
        table = rt.get(controller.get_routing_table.remote(-1, 1.0),
                       timeout=60)
        m = rt.get(table["table"]["toy"]["replicas"][0].metrics.remote(),
                   timeout=60)
        assert all(bs == SERVE_BATCHING["max_batch_size"]
                   for bs, _ in m["step_shapes"]), m["step_shapes"]
        # one request over HTTP
        host, port = start_proxy()
        body = json.dumps(payloads[3]).encode()
        req = urllib.request.Request(
            f"http://{host}:{port}/toy", data=body,
            headers={"content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=120) as resp:
            http_tokens = json.loads(resp.read())["result"]["tokens"]
        assert http_tokens == want_card[3], (http_tokens, want_card[3])
        serve.delete("toy")
        # a two-shard gang on the same card
        gang = serve.deployment(name="gang", batching=dict(SERVE_BATCHING),
                                max_concurrent_queries=32, num_shards=2,
                                **opts)(ToyDecoderShard)
        gang_handle = serve.run(gang.bind())
        gang_outs = rt.get([gang_handle.remote(dict(p))
                            for p in payloads[:8]], timeout=300)
        assert [o["tokens"] for o in gang_outs] == want_card[:8]
        serve.delete("gang")
        # a multiplexed deployment swapping between two seeds
        mux = serve.deployment(
            name="mux", batching=dict(SERVE_BATCHING),
            max_concurrent_queries=32,
            multiplexed_models={"s0": {"seed": 0}, "s1": {"seed": 1}},
            multiplex_max_resident=1, **opts)(ToyDecoder)
        mux_handle = serve.run(mux.bind())
        mux_payloads = [dict(payloads[i], model=f"s{i % 2}")
                        for i in range(8)]
        mux_outs = rt.get([mux_handle.remote(dict(p))
                           for p in mux_payloads], timeout=300)
        for i, (p, o) in enumerate(zip(mux_payloads, mux_outs)):
            seed_engine = ToyDecoder(seed=i % 2)
            want = seed_engine.generate_unbatched(
                {"prompt": list(p["prompt"]),
                 "max_new_tokens": p["max_new_tokens"]})["tokens"]
            assert o["tokens"] == want, (i, o["tokens"], want)
        mux_m = rt.get(rt.get(controller.get_routing_table.remote(
            -1, 1.0), timeout=60)["table"]["mux"]["replicas"][0]
            .metrics.remote(), timeout=60)
        assert mux_m["mux_swaps_total"] >= 2, mux_m
        serve.delete("mux")
        launches = _delta(before, _flash_counts())
    finally:
        serve.shutdown()
        rt.shutdown()
    latency.sort()
    tokens = sum(len(t) for t in outs)
    emit({"phase": "serve_batching", "ok": True,
          "requests": SERVE_REQUESTS, "new_tokens": SERVE_NEW_TOKENS,
          "batching": SERVE_BATCHING, "gpu_share": SERVE_GPU_SHARE,
          "wall_s": wall, "requests_per_s": SERVE_REQUESTS / wall,
          "tokens_per_s": tokens / wall,
          "latency_p50_s": latency[len(latency) // 2],
          "latency_p99_s": latency[min(len(latency) - 1,
                                       int(len(latency) * 0.99))],
          "batch_steps": m["batch_steps"],
          "batch_occupancy": m["batch_occupancy"],
          "step_p50_ms": m["step_p50_ms"], "step_p99_ms": m["step_p99_ms"],
          "decode_device_frac": m.get("device_frac"),
          "step_shapes": m["step_shapes"],
          "http_tokens_equal": True, "gang_requests": 8,
          "mux_requests": 8, "mux_swaps": mux_m["mux_swaps_total"],
          "card": card_line()})
    return launches


SYMBOLS = {"flash_fwd": "flash_fwd_bf16_kernel",  # the bf16 kernel's name
           "flash_hm_fwd": "flash_fwd_bf16_kernel",
           "flash_bwd_dkdv": "bwd_dkdv_bf16_kernel",
           "flash_hm_bwd_dkdv": "bwd_dkdv_bf16_kernel",
           "flash_bwd_dq": "bwd_dq_bf16_kernel",
           "flash_hm_bwd_dq": "bwd_dq_bf16_kernel"}
SUMMARY = {  # name: (source, TPU kernel it replaces, shape in the table)
    "flash_fwd": ("ray_tpu_torch/ops/csrc/flash_fwd.cu",
                  "ray_tpu/ops/flash_attention.py:447", [4, 1024, 32, 128]),
    "flash_bwd_dkdv": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                       "ray_tpu/ops/flash_attention.py:606",
                       list(GPT2_SHAPE)),
    "flash_bwd_dq": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                     "ray_tpu/ops/flash_attention.py:680", list(GPT2_SHAPE)),
    "rmsnorm": ("ray_tpu_torch/ops/csrc/rmsnorm.cu",
                "ray_tpu/ops/fused.py:23", [4096, 4096]),
    "flash_hm_fwd": ("ray_tpu_torch/ops/csrc/flash_fwd.cu",
                     "ray_tpu/ops/flash_attention.py:82", list(XL_SHAPE)),
    "flash_hm_bwd_dkdv": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                          "ray_tpu/ops/flash_attention.py:212",
                          list(XL_SHAPE)),
    "flash_hm_bwd_dq": ("ray_tpu_torch/ops/csrc/flash_bwd.cu",
                        "ray_tpu/ops/flash_attention.py:268", list(XL_SHAPE)),
    # the head-major kernels above head_dim 128
    "flash_generic_fwd": ("ray_tpu_torch/ops/csrc/flash_generic.cu",
                          "ray_tpu/ops/flash_attention.py:82",
                          list(HEAD_DIM_SHAPE + (256,))),
    "flash_generic_bwd_dkdv": ("ray_tpu_torch/ops/csrc/flash_generic.cu",
                               "ray_tpu/ops/flash_attention.py:212",
                               list(HEAD_DIM_SHAPE + (256,))),
    "flash_generic_bwd_dq": ("ray_tpu_torch/ops/csrc/flash_generic.cu",
                             "ray_tpu/ops/flash_attention.py:268",
                             list(HEAD_DIM_SHAPE + (256,))),
}


def kernel_summary(cases, by_path, usage):
    """One row per kernel.  ``launches`` sums the main paths (each read
    between a reset and its end); for the backward kernels ``plain_ms``
    and ``library_ms`` are the whole backward (dq, dk and dv: the plain
    version and SDPA's backward), as neither splits it.  The flash rows
    add, for the bf16 kernel at the row's head_dim, ptxas's registers
    (the launch bound's share; the warp-specialised kernels' consumers
    raise theirs to 240 with setmaxnreg) and the shared memory a block
    takes: ptxas's static bytes and the dynamic bytes the runtime holds
    for the kernel's last launch.  The RMSNorm row adds its times at a
    decode step's shape (``decode``)."""
    rows = []
    for name, (src, replaces, shape) in SUMMARY.items():
        kind, part = name.rsplit("_", 1) if "_bwd_" in name else (name, None)
        c = next(c for c in cases if c["kernel"] == kind
                 and c["shape"] == shape and c["dtype"] == "bfloat16"
                 and c.get("causal", True) and "plain_ms" in c)
        launches = {path: n[name] for path, n in by_path.items()
                    if n.get(name)}
        assert launches, f"{name} was not launched on any main path"
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": sum(launches.values()),
               "launches_by_path": launches,
               "max_abs_err": c[f"max_abs_err_{part}"] if part
               else c["max_abs_err"],
               "ms": c[f"kernel_ms_{part}"] if part else c["kernel_ms"],
               "plain_ms": c["plain_ms"],
               "bound_ms": c[f"bound_ms_{part}"] if part else c["bound_ms"],
               "bound_by": c[f"bound_by_{part}"] if part else c["bound_by"],
               "library_ms": c["library_ms"], "shape": shape,
               "dtype": "bfloat16"}
        if part:  # which SDPA backend ran the backward
            row["library_backend"] = c["library_backend"]
        if part or name.endswith("fwd"):  # the other timed model shapes
            row["other_shapes"] = [
                {"shape": o["shape"], "causal": o["causal"],
                 "ms": o[f"kernel_ms_{part}"] if part else o["kernel_ms"],
                 "bound_ms": o[f"bound_ms_{part}"] if part
                 else o["bound_ms"], "plain_ms": o["plain_ms"],
                 "library_ms": o["library_ms"],
                 **({"library_backend": o["library_backend"]} if part
                    else {})}
                for o in cases if o["kernel"] == kind and "plain_ms" in o
                and o["dtype"] == "bfloat16" and o["shape"] != shape]
        if name == "rmsnorm":  # and at the decode step's shape
            c = next(c for c in cases if c["kernel"] == kind
                     and c["shape"] == list(RMSNORM_DECODE)
                     and c["dtype"] == "bfloat16" and "plain_ms" in c)
            row["decode"] = {k: c[k] for k in (
                "shape", "kernel_ms", "library_ms", "bound_ms", "bound_by")}
        if name in SYMBOLS:
            sym, d = SYMBOLS[name], shape[-1]
            regs, static = next(v for k, v in usage.items()
                                if f"{sym}ILi{d}E" in k)
            row["registers"] = regs
            row["smem_bytes"] = static + runtime_attrs(sym, d)[2]
        rows.append(row)
    return {"kernels": rows}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 2
    from ray_tpu_torch import __version__
    assert not torch.backends.cuda.matmul.allow_tf32
    emit({"phase": "start", "torch": torch.__version__,
          "cuda": torch.version.cuda, "ray_tpu_torch": __version__,
          "device": torch.cuda.get_device_name(0)})
    usage = phase_build()
    cases = phase_kernels()
    phase_model_parity()
    _free()
    serve = phase_serve()
    _free()
    phase_train_parity()
    train = phase_train()
    _free()
    phase_train_parity("gpt2_xl", hm=True, phase="train_parity_xl")
    _free()
    train_xl = phase_train("gpt2_xl", batch=8, steps=XL_STEPS, hm=True,
                           loss_drop=XL_LOSS_DROP, phase="train_xl",
                           with_head_cost=False)
    _free()
    phase_vit_parity()
    _free()
    vit = phase_vit()
    _free()
    phase_moe_parity()
    _free()
    moe = phase_moe()
    _free()
    phase_resnet_parity()
    _free()
    resnet = phase_resnet()
    _free()
    phase_tiny_parity()
    _free()
    head_dims = phase_head_dim_parity()
    _free()
    runtime = phase_runtime()
    _free()
    train_gang = phase_train_gang()
    _free()
    serve_batching = phase_serve_batching()
    # the runtime and the toy decoder launch no kernel of the port
    assert not any(runtime.values()), runtime
    assert not any(serve_batching.values()), serve_batching
    emit(kernel_summary(cases, {"serve": serve, "train": train,
                                "train_xl": train_xl, "vit": vit,
                                "moe": moe, "resnet": resnet,
                                "head_dims": head_dims,
                                "train_gang": train_gang}, usage))
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
