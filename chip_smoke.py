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
16. ``head_dims``: GPT-2 of 2 layers at head_dim 160, 256, 512 and 1024
    (f32: csrc/flash_fma.cu's forward, csrc/flash_fma_bwd.cu's dK/dV and
    dQ) and 20 (the head-major kernels on zero-padded inputs), f32: one
    step's loss and every gradient on the card against the CPU, with each
    route's launches; then at 160, 256, 512 and 1024 in bf16
    (csrc/flash_wide.cu's forward, dK/dV and dQ; at 512 and 1024
    csrc/flash_xwide.cu's forward and csrc/flash_xwide_bwd.cu's dK/dV and
    dQ) against the f32 step.
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
20. ``long_context``: bench.py's long-context attention, causal forward
    + backward through ``flash_attention`` at [1, 32768, 12, 64] and
    [1, 131072, 12, 64] bf16: ms, tokens/s, the launches, and O, dQ, dK,
    dV against a plain version computed 256 queries at a time (at
    131072, the last 1024 queries and keys).
21. ``seq_parallel``: GPT-2 124M at 1 x 32768 tokens through
    ``attn_impl`` "flash", "ring" and "ulysses" on a world-size-1 NCCL
    mesh, a warm-up and 4 AdamW steps each from the same seeded weights:
    the losses against flash's, step ms, tokens/s, peak memory and the
    launches (the ring's steps launch only the chunk mode of #1/#3/#4);
    then ring attention over 4 ranks driven in one process
    (``simulate_ring``) at [1, 32768, 12, 64], [1, 8192, 25, 64],
    [1, 4096, 4, 256] (flash_wide.cu's chunk kernels), [1, 2048, 4, 512]
    and [1, 1024, 2, 1024] (flash_xwide.cu's forward, flash_xwide_bwd.cu's
    dK/dV and dQ), and Ulysses
    (``simulate_ulysses``) at
    [1, 32768, 12, 64], against ``flash_attention`` on the whole
    sequence, row by row.

The ``kernels`` phase also holds the backward kernels (dK/dV and dQ) and
both kernel families (native layout and head-major; head-major at every
head_dim it takes a build for, 32, 64 and 128, and at 16, 48, 80 and 96,
at 20 and 44 on zero-padded inputs, at 136 to 256 on csrc/flash_wide.cu
(bf16 forward, dK/dV and dQ), at 264 to 1024 on csrc/flash_xwide.cu (the
bf16 forward) and csrc/flash_xwide_bwd.cu (bf16 dK/dV and dQ, timed
beside SDPA's backward at six shapes and held at its tiles' edges), at
136 to 1024 on csrc/flash_fma.cu (the f32 forward) and
csrc/flash_fma_bwd.cu (dK/dV and dQ in f32, timed beside SDPA's f32
backward, read three times, and held at its tiles' edges), odd head
counts, ragged
lengths, ViT's non-causal 197, more than 65535 heads in all) against
their plain versions, RMSNorm with a bf16 weight
too, and times them at the training shapes (GPT-2 124M and XL, ViT-B/16,
the MoE) beside SDPA; and the chunk mode of ring attention
(``_flash_chunk_fwd`` / ``_flash_chunk_bwd``: bf16 in, f32 out, the
backward from a given LSE and delta) on every route, timed at a 4-way
ring's chunk of 32768 tokens of GPT-2 124M and of XL's head count, and
at head_dim 256, 512 and 1024, and held at the new kernels' ragged ends.  Each main path (``serve``, ``train``,
``train_xl``, ``vit``, ``moe``, ``resnet``, ``head_dims``, ``runtime``,
``train_gang``, whose worker counts its own, ``serve_batching``,
``long_context`` and each run of ``seq_parallel``) is
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
# head-major head sizes no 32/64/128 build takes as they are
# (flash_attention._hm_route): 20 and 44 run on the 24 and 48 builds'
# kernels on zero-padded copies; 160 and 256 in bf16 on csrc/flash_wide.cu
# (the forward, dK/dV and dQ; its 192 and 256 builds), in f32 on
# csrc/flash_fma.cu (the forward) and flash_fma_bwd.cu (dK/dV, dQ); 512
# (ROUTED_WIDE, and HEAD_DIM_SHAPE at 512 and 384) in bf16 on
# csrc/flash_xwide.cu (the forward; its 384 and 512 builds) and
# csrc/flash_xwide_bwd.cu (dK/dV, dQ; its 384 and 512 builds); 1024
# (ROUTED_XXWIDE and [2, 512, 4, 768], and HEAD_DIM_SHAPE at 1024 and 768)
# on flash_xwide.cu's and flash_xwide_bwd.cu's 768 and 1024 builds (the
# backward at HEAD_DIM_SHAPE at 1024, not 768); each held and timed at
# HEAD_DIM_SHAPE's batch, length and heads, causal and full, and in f32 at
# ROUTED_F32 (the f32 forward and backward at ROUTED_F32_DIMS, the f32
# backward also at HEAD_DIM_SHAPE at 256), then held at ragged lengths
# (ROUTED_RAGGED_DIMS: the wide kernels' 136-256, flash_xwide.cu's and
# flash_xwide_bwd.cu's 264-1024, in f32 flash_fma.cu's and
# flash_fma_bwd.cu's 136-1024) and flash_xwide_bwd.cu and flash_fma_bwd.cu
# at their tiles' edges (XBWD_EDGE_DIMS, FMA_BWD_EDGE_DIMS)
ROUTED_HEAD_DIMS = (20, 44, 160, 256)
ROUTED_WIDE = (2, 512, 4, 512)
ROUTED_XWIDE_DIMS = (384, 512)
ROUTED_XXWIDE = (2, 512, 4, 1024)
ROUTED_XXWIDE_DIMS = (768, 1024)
# flash_xwide_bwd.cu's dK/dV and dQ timed beside ROUTED_WIDE and
# ROUTED_XXWIDE (whose backward is timed with their forward)
XBWD_TIMED = (HEAD_DIM_SHAPE + (384,), HEAD_DIM_SHAPE + (512,),
              ROUTED_XXWIDE[:3] + (768,), HEAD_DIM_SHAPE + (1024,))
# and held at the backward's tile edges (causal lengths, and (Tq, Tk) not
# causal) on each of its builds
XBWD_EDGE_DIMS = (384, 512, 768, 1024)
XBWD_EDGE_LENGTHS = (1, 63, 64, 65, 127, 128, 129, 200, 1000)
XBWD_CROSS_LENGTHS = ((130, 257), (65, 191))
# flash_fma_bwd.cu in f32 at the same edges (64 keys or queries a block,
# 64-row tiles, 32-row accumulation chunks), at head sizes that reach each
# group width and 2 to 8 groups a cluster: 136 (dK/dV and dQ 3 groups of
# 64; 2 of 128 and 1 of 256 at T = 1000), 256 (4 of 64), 384 (6), 520 (5
# of 128, the last 8 wide), 800 (7), 1000 (8 of 128, the last 104 wide;
# dQ 4 of 256 at T = 1000), 1024
FMA_BWD_EDGE_DIMS = (136, 256, 384, 520, 800, 1000, 1024)
ROUTED_F32 = (2, 256, 4)
ROUTED_F32_DIMS = ROUTED_HEAD_DIMS + (512, 1024)
# the f32 backward's case big enough that launch latency does not hide the
# design: 2048 clusters of dK/dV, 2048 blocks of dQ
F32_BWD_TIMED = HEAD_DIM_SHAPE + (256,)
# SDPA's f32 backward read 0.1990 to 0.5339 ms at [2, 256, 4, 256] causal
# from one call to another (H100): each f32 backward case reads it this
# many times in a row and takes the median as its library_ms
SDPA_F32_READINGS = 3
ROUTED_RAGGED = ((2, 100, 3), (1, 1, 2), (2, 257, 3))
WIDE_HELD_DIMS = (136, 150, 160, 200, 256)
XWIDE_HELD_DIMS = (264, 300, 384, 400, 512)
# 520 and 776-1000 leave boxes wholly past head_dim (768 and 1024 builds),
# 600 and 1000 a box partly past it, 601 takes the pad route (608 in
# bf16, 604 in f32)
XXWIDE_HELD_DIMS = (520, 600, 601, 768, 1000, 1024)
ROUTED_RAGGED_DIMS = (20, 44) + WIDE_HELD_DIMS + XWIDE_HELD_DIMS \
    + XXWIDE_HELD_DIMS
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


def runtime_attrs(symbol, d, f32_out=False):
    """(registers, static shared bytes, dynamic shared bytes) of a
    bf16-input flash kernel at head_dim ``d``, with bf16 or (``f32_out``)
    f32 outputs, as the CUDA runtime holds them; the dynamic bytes are
    those its last launch set."""
    import ctypes
    from ray_tpu_torch.ops import _build
    lib = _build.load_library()
    out = (ctypes.c_int * 3)()
    if symbol == "flash_fwd_bf16_kernel":
        rc = lib.rtt_flash_fwd_attrs(d, int(f32_out), out)
    elif symbol == "xwide_fwd_kernel":
        rc = lib.rtt_flash_xwide_attrs(d, int(f32_out), out)
    elif symbol.startswith("wide_"):
        rc = lib.rtt_flash_wide_attrs(
            {"wide_fwd_kernel": 0, "wide_dkdv_kernel": 1,
             "wide_dq_kernel": 2}[symbol], d, int(f32_out), out)
    else:
        rc = lib.rtt_flash_bwd_attrs(
            {"bwd_dkdv_bf16_kernel": 0, "bwd_dq_bf16_kernel": 1}[symbol], d,
            int(f32_out), out)
    _build.check(rc, f"attributes of {symbol}")
    return tuple(out)


def group_attrs(entry, *args):
    """(registers, static shared bytes, dynamic shared bytes, group width,
    clusters the card holds at once, clusters of the launch) that the
    attributes entry ``entry`` of a column-group kernel reports for a
    launch at ``args``."""
    import ctypes
    from ray_tpu_torch.ops import _build
    out = (ctypes.c_int * 6)()
    _build.check(getattr(_build.load_library(), entry)(*args, out),
                 f"{entry}{args}")
    return tuple(out)


def fma_attrs(shape):
    """group_attrs of the f32 forward (flash_fma.cu) at ``shape``."""
    return group_attrs("rtt_flash_fma_attrs", *shape)


def xbwd_attrs(part, shape, f32_out=False):
    """group_attrs of flash_xwide_bwd.cu's dK/dV (``part`` "dkdv") or dQ
    ("dq") at ``shape`` (Tq = Tk) with bf16 or (``f32_out``) f32
    outputs."""
    b, t, h, d = shape
    return group_attrs("rtt_flash_xwide_bwd_attrs", {"dkdv": 0, "dq": 1}[part],
                       b, t, t, h, d, int(f32_out))


def fma_bwd_attrs(part, shape):
    """group_attrs of flash_fma_bwd.cu's dK/dV (``part`` "dkdv") or dQ
    ("dq") at ``shape`` (Tq = Tk)."""
    b, t, h, d = shape
    return group_attrs("rtt_flash_fma_bwd_attrs", {"dkdv": 0, "dq": 1}[part],
                       b, t, t, h, d)


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


def _route_kinds(hm, d, dtype):
    """The kernel selector of each part ("fwd", "dkdv", "dq") of a call
    of one family at head_dim d with inputs of dtype: "nl", or
    _hm_route's "hm", "wide", "xwide", "xxwide" or "fma"."""
    from ray_tpu_torch.ops.flash_attention import PARTS, _hm_route
    return {p: _hm_route(d, dtype, p)[0] if hm else "nl" for p in PARTS}


def _case_kernel(hm, d, dtype, part):
    """A case's kernel name for ``part`` ("fwd", "bwd_dkdv", "bwd_dq"):
    the native-layout family's (flash_fwd), or the head-major kernel
    _hm_route picks (flash_hm_fwd, flash_wide_fwd, flash_fma_fwd, ...)."""
    kind = _route_kinds(hm, d, dtype)[part.split("_")[-1]]
    return f"flash_{'' if kind == 'nl' else kind + '_'}{part}"


def _launched(hm, d, dtype):
    """The launch counts a head-major or native-layout call at head_dim d
    with inputs of dtype moves: (forward, dK/dV, dQ) as (function,
    attribute)."""
    fwd, bwd = _family(hm)
    kinds = _route_kinds(hm, d, dtype)

    def attr(part):
        kind = kinds[part]
        return "launches" + ("" if kind in ("nl", "hm") else "_" + kind) + (
            "" if part == "fwd" else "_" + part)

    return ((fwd, attr("fwd")), (bwd, attr("dkdv")), (bwd, attr("dq")))


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
    counter = _launched(hm, d, dtype)[0]
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
    res = {"kernel": _case_kernel(hm, d, dtype, "fwd"),
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
    counters = _launched(hm, d, dtype)[1:]
    before = [getattr(*c) for c in counters]
    grads = bwd(q, k, v, out, lse, do, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert [getattr(*c) for c in counters] == [n + 1 for n in before]
    ref = attention_backward_reference(q, k, v, out, lse, do, causal, scale)
    tol = ROW_TOL[dtype]
    # one name for the pair, and each part's kernel: above head_dim 512
    # in bf16 the forward runs on flash_xwide.cu's "xxwide" builds, dK/dV
    # and dQ on flash_xwide_bwd.cu ("xwide")
    res = {"kernel": _case_kernel(hm, d, dtype, "bwd_dkdv")[:-len("_dkdv")],
           "kernel_dkdv": _case_kernel(hm, d, dtype, "bwd_dkdv"),
           "kernel_dq": _case_kernel(hm, d, dtype, "bwd_dq"),
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
            _unpad(g, d) for g in _kernel_dkdv(*_bwd_inputs(*args, hm)[0])])
        res["kernel_ms_dq"] = timer(lambda: _unpad(
            _kernel_dq(*_bwd_inputs(*args, hm)[1]), d))
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
        # take, PyTorch's own pick, as the forward's case times; f32 read
        # SDPA_F32_READINGS times (its readings vary from call to call),
        # library_ms their median
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
            n = SDPA_F32_READINGS if dtype == torch.float32 else 1
            readings = sorted((sdpa_ms() for _ in range(n)),
                              key=lambda r: r[1] - r[0])
            if n > 1:
                res["library_ms_readings"] = [b - f for f, b in readings]
            fwd_ms, both_ms = readings[n // 2]  # the median backward
        res["library_ms"] = both_ms - fwd_ms
        res["library_fwd_bwd_ms"] = both_ms
        res["bound_ms_dkdv"], res["bound_by_dkdv"] = bound(
            8 * d * b * h * pairs, 6 * one + rows, dtype)
        res["bound_ms_dq"], res["bound_by_dq"] = bound(
            6 * d * b * h * pairs, 5 * one + rows, dtype)
        res["bound_ms"], res["bound_by"] = bound(
            14 * d * b * h * pairs, 7 * one + rows, dtype)
    return res


# The chunk mode (ring attention's _flash_chunk_fwd / _flash_chunk_bwd):
# bf16 inputs, f32 outputs, the backward from a given LSE and delta.  Its
# shapes: a 4-way ring over 32768 tokens of GPT-2 124M (12 heads of 64,
# native layout) and of GPT-2 XL's head count (25, head-major), causal
# (the diagonal chunk) and not (a past one); head_dim 256 (flash_wide.cu),
# 512 and 1024 (flash_xwide.cu's forward, flash_xwide_bwd.cu's dK/dV and
# dQ); then the tiles' edges of every route untimed, with the ring's chunk
# at head_dim 256 (SP_RING_SHAPES) on the diagonal and a past one, and the
# wide kernels' ragged ends at every head_dim chip_smoke holds them at
# (WIDE_HELD_DIMS, XWIDE_HELD_DIMS, XXWIDE_HELD_DIMS).
CHUNK_NL = (1, 8192, 12, 64)
CHUNK_HM = (1, 8192, 25, 64)
CHUNK_WIDE = HEAD_DIM_SHAPE + (256,)
CHUNK_XWIDE = ROUTED_WIDE
CHUNK_XXWIDE = ROUTED_XXWIDE
CHUNK_EDGES = (((2, 200, 2, 64), True, None), ((2, 1000, 2, 128), True, None),
               ((2, 65, 2, 64), True, None), ((2, 130, 2, 64), False, 257),
               ((2, 200, 3, 32), True, None), ((2, 63, 3, 128), True, None),
               ((2, 129, 3, 20), True, None), ((2, 100, 3, 160), True, None),
               ((2, 130, 3, 160), False, 257), ((2, 100, 3, 200), True, None),
               ((1, 4096, 4, 256), True, None),
               ((1, 4096, 4, 256), False, None))
# the plain versions of the chunk cases run over this many heads at a time
# (a [1, 8192, 25, 64] backward at once holds 30 GB of [T, T] f32 tensors)
PLAIN_HEADS = 4


def _by_heads(fn, *xs, heads=PLAIN_HEADS):
    """``fn`` over slices of ``heads`` heads of the ``[B, T, H, ...]``
    tensors ``xs``, its outputs (tuples of ``[B, T, H, ...]`` tensors)
    joined again: exact, as attention is per head."""
    parts = [fn(*(x[:, :, h:h + heads] for x in xs))
             for h in range(0, xs[0].shape[2], heads)]
    return tuple(torch.cat(p, dim=2) for p in zip(*parts))


def _chunk_kinds(q):
    """The chunk call's kernel of each part ("fwd", "dkdv", "dq"), as
    _flash_chunk_fwd / _flash_chunk_bwd dispatch it: "" (native layout),
    "hm", "wide", "xwide" or "xxwide" (the backward of both "xwide"),
    its counters' suffix."""
    from ray_tpu_torch.ops.flash_attention import _chunk_family
    kinds = _route_kinds(_chunk_family(q, q, q), q.shape[-1], q.dtype)
    return {p: "" if k == "nl" else k for p, k in kinds.items()}


def chunk_name(kind, part):
    """The kernels line's name of a chunk-mode kernel."""
    return f"flash_{kind + '_' if kind else ''}{part}_f32out"


def _chunk_counter(kind, part):
    """(function, attribute) counting chunk-mode launches of ``part``
    ("fwd", "dkdv", "dq") on ``kind``."""
    from ray_tpu_torch.ops.flash_attention import (_flash_chunk_bwd,
                                                   _flash_chunk_fwd)
    sfx = "_" + kind if kind else ""
    if part == "fwd":
        return _flash_chunk_fwd, "launches" + sfx
    return _flash_chunk_bwd, f"launches{sfx}_{part}"


def chunk_case(timer, gen, shape, causal, timed, tk=None):
    """The chunk mode of one family: ``_flash_chunk_fwd`` (f32 O and the
    LSE) and ``_flash_chunk_bwd`` (f32 dQ, dK, dV from the forward's LSE
    and a given delta) on bf16 inputs, against the plain versions with
    the same LSE and delta, row by row at the bf16 limit: P is still
    rounded to bf16 inside, so the f32 outputs do not earn the f32 one.
    The delta given is half of rowsum(dO * O), so that a kernel which
    recomputed it would fail.  Timed: each kernel as its wrapper runs it,
    and with bf16 outputs on the same inputs (``bf16out_ms*``), the
    plain versions over PLAIN_HEADS heads at a time; no library call
    returns f32 O from bf16 inputs (library_ms null)."""
    from ray_tpu_torch.ops.flash_attention import (
        _bwd_inputs, _flash_chunk_bwd, _flash_chunk_fwd, _kernel_dkdv,
        _kernel_dq, _kernel_for, _kernel_fwd, _pad_cols,
        attention_backward_reference, attention_delta, attention_reference)
    b, t, h, d = shape
    kv_shape = shape if tk is None else (b, tk, h, d)
    bf = torch.bfloat16
    q, g = (torch.randn(shape, generator=gen, device="cuda").to(bf)
            for _ in range(2))
    k, v = (torch.randn(kv_shape, generator=gen, device="cuda").to(bf)
            for _ in range(2))
    scale = d ** -0.5
    kinds = _chunk_kinds(q)
    counters = [_chunk_counter(kinds[p], p) for p in ("fwd", "dkdv", "dq")]
    before = [getattr(*c) for c in counters]
    out, lse = _flash_chunk_fwd(q, k, v, causal, scale)
    out_bf = out.to(bf)
    delta = 0.5 * attention_delta(out_bf, g).transpose(1, 2)  # [B, T, H]
    grads = _flash_chunk_bwd(q, k, v, out_bf, lse, g, causal, scale,
                             delta=delta)
    torch.cuda.synchronize()
    assert [getattr(*c) for c in counters] == [n + 1 for n in before]
    assert out.dtype == torch.float32 and lse.shape == (b, t, h)
    lse_h = lse.transpose(1, 2)

    def plain_fwd(q_, k_, v_):
        o, l_ = attention_reference(q_, k_, v_, causal, scale,
                                    out_dtype=torch.float32)
        return o, l_.transpose(1, 2)

    def plain_bwd(q_, k_, v_, o_, l_, g_, dl_):
        return attention_backward_reference(
            q_, k_, v_, o_, l_.transpose(1, 2).contiguous(), g_, causal,
            scale, delta=dl_.transpose(1, 2).contiguous(),
            grad_dtype=torch.float32)

    ref, ref_lse = _by_heads(plain_fwd, q, k, v)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=1e-5)
    tol = ROW_TOL[bf]
    res = {"kernel": chunk_name(kinds["fwd"], "fwd"),
           "kernel_dkdv": chunk_name(kinds["dkdv"], "bwd_dkdv"),
           "kernel_dq": chunk_name(kinds["dq"], "bwd_dq"), "mode": "f32out",
           "shape": list(shape), **({} if tk is None else {"tk": tk}),
           "dtype": "bfloat16", "out_dtype": "float32", "causal": causal,
           "row_tol": tol, "launches": 1,
           "max_abs_err": max_err(out, ref),
           "lse_max_abs_err": max_err(lse, ref_lse),
           "row_scaled_err": row_scaled_err(out, ref)}
    assert res["row_scaled_err"] <= tol, ("O", res["row_scaled_err"])
    refs = _by_heads(plain_bwd, q, k, v, out_bf, lse, g, delta)
    for name, x, r in zip(("dq", "dk", "dv"), grads, refs):
        assert x.dtype == torch.float32 and torch.isfinite(x).all(), name
        res[f"{name}_max_abs_err"] = max_err(x, r)
        # row by row everywhere, one causal position too: with half of
        # delta, dS = P (dP - delta) is dP / 2 there, not 0 (held_err)
        res[f"{name}_row_scaled_err"] = err = row_scaled_err(x, r)
        assert err <= tol, (name, err, tol)
    res["max_abs_err_dq"] = res["dq_max_abs_err"]
    res["max_abs_err_dkdv"] = max(res["dk_max_abs_err"],
                                  res["dv_max_abs_err"])
    if timed:
        tkk = t if tk is None else tk
        pairs = t * (t + 1) // 2 if causal else t * tkk
        one = q.numel() * 2          # one bf16 [B, T, H, D] input
        rows = b * h * t * 4         # one f32 [B, T, H] row statistic
        hm = bool(kinds["fwd"])
        args = (q, k, v, g, lse_h.contiguous(),
                delta.transpose(1, 2).contiguous(), causal, scale)
        f32 = torch.float32
        res["kernel_ms"] = timer(lambda: _flash_chunk_fwd(q, k, v, causal,
                                                          scale))
        res["kernel_ms_dkdv"] = timer(lambda: _kernel_dkdv(
            *_bwd_inputs(*args, hm)[0], out_dtype=f32))
        res["kernel_ms_dq"] = timer(lambda: _kernel_dq(
            *_bwd_inputs(*args, hm)[1], out_dtype=f32))
        # the same kernels with bf16 outputs, on the same inputs
        kernel, d_k = _kernel_for(q, hm)
        res["bf16out_ms"] = timer(lambda: _kernel_fwd(
            *_pad_cols(d_k, q, k, v), causal, scale, kernel))
        res["bf16out_ms_dkdv"] = timer(lambda: _kernel_dkdv(
            *_bwd_inputs(*args, hm)[0]))
        res["bf16out_ms_dq"] = timer(lambda: _kernel_dq(
            *_bwd_inputs(*args, hm)[1]))
        res["plain_ms"] = timer(lambda: _by_heads(plain_fwd, q, k, v))
        res["plain_ms_bwd"] = timer(lambda: _by_heads(
            plain_bwd, q, k, v, out_bf, lse, g, delta))
        res["library_ms"] = None
        res["bound_ms"], res["bound_by"] = bound(
            4 * d * b * h * pairs, 3 * one + 2 * one + rows, bf)
        res["bound_ms_dkdv"], res["bound_by_dkdv"] = bound(
            8 * d * b * h * pairs, 4 * one + 4 * one + 2 * rows, bf)
        res["bound_ms_dq"], res["bound_by_dq"] = bound(
            6 * d * b * h * pairs, 4 * one + 2 * one + 2 * rows, bf)
    return res


def chunk_cases(timer, gen, add):
    """The chunk mode's cases: timed at CHUNK_NL, CHUNK_HM, CHUNK_WIDE,
    CHUNK_XWIDE and CHUNK_XXWIDE, causal and not, then held at
    CHUNK_EDGES and at the ragged ends of flash_wide.cu's and
    flash_xwide.cu's head sizes."""
    for shape in (CHUNK_NL, CHUNK_HM, CHUNK_WIDE, CHUNK_XWIDE,
                  CHUNK_XXWIDE):
        for causal in (True, False):
            add(chunk_case(timer, gen, shape, causal, timed=True))
            _free()
    for shape, causal, tk in CHUNK_EDGES:
        add(chunk_case(timer, gen, shape, causal, timed=False, tk=tk))
    for d in WIDE_HELD_DIMS + XWIDE_HELD_DIMS + XXWIDE_HELD_DIMS:
        for shape in ROUTED_RAGGED:
            add(chunk_case(timer, gen, shape + (d,), True, timed=False))
        add(chunk_case(timer, gen, (2, 130, 3, d), False, timed=False,
                       tk=257))


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
    # ring attention's chunk mode: f32 outputs, a given LSE and delta
    chunk_cases(timer, gen, add)
    emit({"phase": "kernels", "ok": True, "cases": len(cases)})
    return cases


def routed_head_dim_cases(timer, gen, add, cases):
    """The head-major family at the head sizes _hm_route pads (20, 44)
    or sends to flash_wide.cu, flash_xwide.cu, flash_xwide_bwd.cu,
    flash_fma.cu or flash_fma_bwd.cu (136 and up), against the plain
    versions at ROW_TOL, forward and backward; then the pad route's cost
    beside its build's (d 20 against 24, 44 against 48), as one line."""
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
        for d in ROUTED_XWIDE_DIMS + ROUTED_XXWIDE_DIMS:
            add(flash_case(timer, gen, HEAD_DIM_SHAPE + (d,), torch.bfloat16,
                           causal, timed=True, hm=True))
            _free()
        add(flash_case(timer, gen, ROUTED_XXWIDE, torch.bfloat16, causal,
                       timed=True, hm=True))
        add(bwd_case(timer, gen, ROUTED_XXWIDE, torch.bfloat16, causal,
                     timed=True, hm=True))
        # flash_xwide_bwd.cu's dK/dV and dQ on each build
        for shape in XBWD_TIMED:
            add(bwd_case(timer, gen, shape, torch.bfloat16, causal,
                         timed=True, hm=True))
            _free()
    # f32: the forward on flash_fma.cu, dK/dV and dQ on flash_fma_bwd.cu
    for d in ROUTED_F32_DIMS:
        for causal in (False, True):
            add(flash_case(timer, gen, ROUTED_F32 + (d,), torch.float32,
                           causal, timed=True, hm=True))
            add(bwd_case(timer, gen, ROUTED_F32 + (d,), torch.float32,
                         causal, timed=True, hm=True))
    add(bwd_case(timer, gen, F32_BWD_TIMED, torch.float32, True, timed=True,
                 hm=True))
    _free()
    # ragged ends of every route's tiles, one position, Tq != Tk (150,
    # 300 and 601: the wide kernels and the xwide forward and backward on
    # inputs padded to 152, 304 and 608, in f32 the fma forward on 152, 300
    # and 604; 136, 200, 264, 400, 520, 600 and 1000: a build's last box
    # partly past head_dim, and at 264, 400 and 520 a box wholly past it;
    # in f32 the fma backward's last group partly past it)
    for d in ROUTED_RAGGED_DIMS:
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
    # flash_xwide_bwd.cu at its tiles' edges (64 keys or queries a block,
    # 32-row tiles), on each build, two batches
    for d in XBWD_EDGE_DIMS:
        for t in XBWD_EDGE_LENGTHS:
            add(bwd_case(timer, gen, (2, t, 3, d), torch.bfloat16, True,
                         timed=False, hm=True))
        for tq, tk in XBWD_CROSS_LENGTHS:
            add(bwd_case(timer, gen, (2, tq, 3, d), torch.bfloat16, False,
                         timed=False, hm=True, tk=tk))
    # flash_fma_bwd.cu at the same edges in f32
    for d in FMA_BWD_EDGE_DIMS:
        for t in XBWD_EDGE_LENGTHS:
            add(bwd_case(timer, gen, (2, t, 3, d), torch.float32, True,
                         timed=False, hm=True))
        for tq, tk in XBWD_CROSS_LENGTHS:
            add(bwd_case(timer, gen, (2, tq, 3, d), torch.float32, False,
                         timed=False, hm=True, tk=tk))

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
# head_dim 129-256 in bf16: flash_wide.cu's forward, dK/dV and dQ
FLASH_WIDE = ("flash_wide_fwd", "flash_wide_bwd_dkdv", "flash_wide_bwd_dq")
# head_dim 257-512 and 513-1024 in bf16: flash_xwide.cu's forward, and
# flash_xwide_bwd.cu's dK/dV and dQ; f32 above 128: flash_fma.cu's
# forward, and flash_fma_bwd.cu's dK/dV and dQ
FLASH_XWIDE_BWD = ("flash_xwide_bwd_dkdv", "flash_xwide_bwd_dq")
FLASH_XWIDE = ("flash_xwide_fwd",) + FLASH_XWIDE_BWD
FLASH_XXWIDE = ("flash_xxwide_fwd",) + FLASH_XWIDE_BWD
FLASH_FMA_BWD = ("flash_fma_bwd_dkdv", "flash_fma_bwd_dq")
FLASH_FMA = ("flash_fma_fwd",) + FLASH_FMA_BWD
FLASH_ALL = (FLASH_NL + FLASH_HM + FLASH_WIDE + FLASH_XWIDE
             + FLASH_XXWIDE[:1] + FLASH_FMA)


def _flash_counts():
    nl_fwd, nl_bwd = _family(False)
    hm_fwd, hm_bwd = _family(True)
    return dict(zip(FLASH_ALL, (
        nl_fwd.launches, nl_bwd.launches_dkdv, nl_bwd.launches_dq,
        hm_fwd.launches, hm_bwd.launches_dkdv, hm_bwd.launches_dq,
        hm_fwd.launches_wide, hm_bwd.launches_wide_dkdv,
        hm_bwd.launches_wide_dq, hm_fwd.launches_xwide,
        hm_bwd.launches_xwide_dkdv, hm_bwd.launches_xwide_dq,
        hm_fwd.launches_xxwide, hm_fwd.launches_fma,
        hm_bwd.launches_fma_dkdv, hm_bwd.launches_fma_dq)))


def _flash_per(fwd, hm=False, bwd=None, route=None):
    """Launches of one family's kernels (or, with ``route`` "wide",
    "xwide", "xxwide" or "fma", of the kernels a head-major call on that
    forward route launches: FLASH_WIDE, FLASH_XWIDE, FLASH_XXWIDE or
    FLASH_FMA): ``fwd`` forwards and ``bwd`` of each backward kernel
    (default ``fwd``); none of the others."""
    bwd = fwd if bwd is None else bwd
    counts = dict.fromkeys(FLASH_ALL, 0)
    names = {"wide": FLASH_WIDE, "xwide": FLASH_XWIDE,
             "xxwide": FLASH_XXWIDE, "fma": FLASH_FMA}.get(
        route, FLASH_HM if hm else FLASH_NL)
    counts.update(zip(names, (fwd, bwd, bwd)))
    return counts


def _zero_counts():
    from ray_tpu_torch.ops.fused import fused_rmsnorm
    for fwd, bwd in (_family(False), _family(True)):
        fwd.launches = bwd.launches_dkdv = bwd.launches_dq = 0
    hm_fwd, hm_bwd = _family(True)
    hm_fwd.launches_wide = hm_bwd.launches_wide_dkdv = 0
    hm_bwd.launches_wide_dq = hm_fwd.launches_xwide = 0
    hm_fwd.launches_xxwide = hm_fwd.launches_fma = 0
    hm_bwd.launches_xwide_dkdv = hm_bwd.launches_xwide_dq = 0
    hm_bwd.launches_fma_dkdv = hm_bwd.launches_fma_dq = 0
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
# at head sizes only the routes take: (heads, width) for head_dim 160, 256,
# 512 and 1024 (f32: flash_fma.cu's forward, flash_fma_bwd.cu's dK/dV and
# dQ; 1024 as 2 heads, the 512 model's width) and 20 (zero-padded onto
# the 24 build's kernels)
HEAD_DIM_MODELS = ((4, 640), (4, 80), (4, 1024),
                   (4, 2048), (2, 2048))  # head_dim 160, 20, 256, 512, 1024
# head_dims in bf16 (head_dim 160 and 256: flash_wide.cu's forward, dK/dV
# and dQ; 512 and 1024: flash_xwide.cu's forward, flash_xwide_bwd.cu's
# dK/dV and dQ) against the same weights' f32 step on the
# card: the loss within HEAD_DIM_BF16_LOSS_RTOL, each gradient within
# HEAD_DIM_BF16_GRAD_TOL of its tensor's largest element: bf16 rounding of
# every product.  Measured on an H100: 0.7-1.2e-5 (loss) and 0.0106-0.0108
# (gradients); the plain versions on the CPU read 3-4e-5 and 0.010-0.011.
# Limits about 2.5 and 3 times the worst of those.
HEAD_DIM_BF16_LOSS_RTOL = 1e-4
HEAD_DIM_BF16_GRAD_TOL = 3e-2


def phase_head_dim_parity(batch=2, seq=128):
    """The model path through the routed head-major kernels: one
    training step's loss and every gradient of each HEAD_DIM_MODELS
    GPT-2, f32, TF32 off, on the card against the CPU, with its launches
    (2 of flash_fma.cu's forward and of each flash_fma_bwd.cu kernel for
    head_dim 160, 256, 512 and 1024; 2 of #5, #6, #7 for head_dim 20);
    then, above 128, the same weights in bf16 on the card (2 of each
    flash_wide.cu kernel at 160 and 256; 2 of flash_xwide.cu's forward and
    of flash_xwide_bwd.cu's dK/dV and dQ at 512 and 1024) against the f32
    step.  Returns the launch counts of all runs."""
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config, loss_fn
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
        route = _route_kinds(True, d, torch.float32)["fwd"]
        assert launches == _flash_per(
            cfg.num_layers, hm=True,
            route=None if route == "hm" else route), launches
        assert abs(gpu_loss - cpu_loss) <= PARITY_LOSS_RTOL * abs(cpu_loss), (
            gpu_loss, cpu_loss)
        grad_err = {n: _gradient_err(gpu_grads[n].cpu(), g)[1]
                    for n, g in cpu_grads.items()}
        worst = max(grad_err, key=grad_err.get)
        assert grad_err[worst] <= TRAIN_GRAD_TOL, (d, worst, grad_err[worst])
        rows.append({"head_dim": d, "dtype": "float32", "route": route,
                     "heads": heads, "width": width, "loss_cpu": cpu_loss,
                     "loss_gpu": gpu_loss, "worst_grad": worst,
                     "worst_grad_err_over_max": grad_err[worst],
                     "launches": {k: v for k, v in launches.items() if v}})
        total = {k: total[k] + launches[k] for k in total}
        if d > 128:
            f32_grads = {n: g.clone() for n, g in gpu_grads.items()}
            cfg_bf = dataclasses.replace(cfg, dtype=torch.bfloat16)
            model_bf = GPT2(cfg_bf, device="cuda",
                            generator=torch.Generator(device="cuda"))
            model_bf.load_state_dict(model.state_dict())
            _zero_counts()
            bf_loss, bf_grads = step_grads(model_bf, loss_fn, tokens.cuda())
            torch.cuda.synchronize()
            launches = _flash_counts()
            assert launches == _flash_per(
                cfg.num_layers,
                route=_route_kinds(True, d, torch.bfloat16)["fwd"]), launches
            loss_rel = abs(bf_loss - gpu_loss) / abs(gpu_loss)
            grad_err = {n: _gradient_err(bf_grads[n], g)[1]
                        for n, g in f32_grads.items()}
            worst = max(grad_err, key=grad_err.get)
            rows.append({"head_dim": d, "dtype": "bfloat16",
                         "route": _route_kinds(True, d, torch.bfloat16),
                         "heads": heads, "width": width,
                         "loss_gpu_f32": gpu_loss, "loss_gpu": bf_loss,
                         "loss_rel_diff": loss_rel, "worst_grad": worst,
                         "worst_grad_err_over_max": grad_err[worst],
                         "launches": {k: v for k, v in launches.items()
                                      if v}})
            assert loss_rel <= HEAD_DIM_BF16_LOSS_RTOL, rows[-1]
            assert grad_err[worst] <= HEAD_DIM_BF16_GRAD_TOL, rows[-1]
            total = {k: total[k] + launches[k] for k in total}
            del model_bf
        del model
    emit({"phase": "head_dims", "ok": True,
          "config": "GPT2Config.tiny(dtype=float32 | bfloat16, num_heads, "
          "embed_dim)", "tokens": [batch, seq],
          "grad_tol_err_over_max": TRAIN_GRAD_TOL,
          "loss_rtol": PARITY_LOSS_RTOL,
          "bf16_grad_tol_err_over_max": HEAD_DIM_BF16_GRAD_TOL,
          "bf16_loss_rtol": HEAD_DIM_BF16_LOSS_RTOL, "models": rows})
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
                (flash_attention_hm_fwd, "launches_wide"),
                (flash_attention_hm_fwd, "launches_xwide"),
                (flash_attention_hm_fwd, "launches_xxwide"),
                (flash_attention_hm_fwd, "launches_fma"),
                (flash_attention_hm_bwd, "launches_dkdv"),
                (flash_attention_hm_bwd, "launches_dq"),
                (flash_attention_hm_bwd, "launches_wide_dkdv"),
                (flash_attention_hm_bwd, "launches_wide_dq"),
                (flash_attention_hm_bwd, "launches_xwide_dkdv"),
                (flash_attention_hm_bwd, "launches_xwide_dq"),
                (flash_attention_hm_bwd, "launches_fma_dkdv"),
                (flash_attention_hm_bwd, "launches_fma_dq"),
                (fused_rmsnorm, "launches"))
    for fn, attr in counters:
        setattr(fn, attr, 0)

    def counts():
        names = ("flash_fwd", "flash_bwd_dkdv", "flash_bwd_dq",
                 "flash_hm_fwd", "flash_wide_fwd", "flash_xwide_fwd",
                 "flash_xxwide_fwd", "flash_fma_fwd", "flash_hm_bwd_dkdv",
                 "flash_hm_bwd_dq",
                 "flash_wide_bwd_dkdv", "flash_wide_bwd_dq",
                 "flash_xwide_bwd_dkdv", "flash_xwide_bwd_dq",
                 "flash_fma_bwd_dkdv", "flash_fma_bwd_dq",
                 "rmsnorm")
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


# long_context: bench.py's bench_long_context lengths on one card, GPT-2
# 124M's heads (12 of 64, bf16, causal), forward + backward through
# flash_attention; held against a plain version computed LONG_BLOCK
# queries at a time (a whole [T, T] f32 score matrix is 4 GiB per head
# at 32768).  At LONG_LENGTHS[-1] only the last LONG_TAIL queries (the
# longest rows: O and dQ) and the last LONG_TAIL keys (dK and dV, which
# only those queries see) are held.
LONG_LENGTHS = (32768, 131072)
LONG_HEADS = (12, 64)
LONG_BLOCK = 256
LONG_TAIL = 1024
# seq_parallel: GPT-2 124M at 1 x SP_SEQ tokens (max_seq_len SP_SEQ),
# bf16 compute, f32 masters, AdamW, 1 warm-up and SP_STEPS steps through
# attn_impl "flash", "ring" and "ulysses" on a world-size-1 mesh; the
# losses of ring and Ulysses within SP_LOSS_RTOL of flash's (the
# embedding's backward sums by atomics, so two runs of one model need not
# agree to the bit).  Then the ring's composition across SP_RANKS ranks
# in one process at SP_RING_SHAPES, and Ulysses' at SP_ULYSSES_SHAPE,
# against flash_attention on the whole sequence, row by row at ROW_TOL.
SP_SEQ = 32768
SP_STEPS = 4
SP_LOSS_RTOL = 1e-3
SP_RANKS = 4
# the in-process ring at GPT-2 124M's and XL's head counts (the chunk mode
# of #1/#3/#4 and #5-#7), at head_dim 256 (flash_wide.cu's forward, dK/dV
# and dQ), at 512 and 1024 (flash_xwide.cu's forward, flash_xwide_bwd.cu's
# dK/dV and dQ); SP_RING_KERNELS: the chunk kernels each of those head
# sizes must launch
SP_RING_SHAPES = ((1, 32768, 12, 64), (1, 8192, 25, 64), (1, 4096, 4, 256),
                  (1, 2048, 4, 512), (1, 1024, 2, 1024))
SP_RING_KERNELS = {256: ("flash_wide_fwd_f32out", "flash_wide_bwd_dq_f32out"),
                   512: ("flash_xwide_fwd_f32out",
                         "flash_xwide_bwd_dkdv_f32out",
                         "flash_xwide_bwd_dq_f32out"),
                   1024: ("flash_xxwide_fwd_f32out",
                          "flash_xwide_bwd_dkdv_f32out",
                          "flash_xwide_bwd_dq_f32out")}
SP_ULYSSES_SHAPE = (1, 32768, 12, 64)


def _chunk_counts():
    """The chunk mode's launch counts by kernels-line name."""
    out = {}
    for kind in ("", "hm", "wide", "xwide", "xxwide"):
        for part in ("fwd", "dkdv", "dq"):
            fn, attr = _chunk_counter(kind, part)
            if hasattr(fn, attr):  # "xxwide" has no backward: its
                # backward is "xwide"
                out[chunk_name(kind, part if part == "fwd"
                               else "bwd_" + part)] = getattr(fn, attr)
    return out


def _zero_chunk_counts():
    from ray_tpu_torch.ops.flash_attention import (_flash_chunk_bwd,
                                                   _flash_chunk_fwd)
    for fn in (_flash_chunk_fwd, _flash_chunk_bwd):
        for attr in list(vars(fn)):
            if attr.startswith("launches"):
                setattr(fn, attr, 0)


def _all_counts():
    return {**_flash_counts(), **_chunk_counts(),
            "rmsnorm": _rmsnorm_launches()}


def _zero_all_counts():
    _zero_counts()
    _zero_chunk_counts()


def plain_blocked(q, k, v, do, out, q_from=0, block=LONG_BLOCK):
    """Causal attention and its backward, plain, LONG_BLOCK queries at a
    time from query ``q_from`` on, as the kernels compute it (P~ rounded
    to bf16 for dV, dS~ for dK and dQ; delta from the kernel's bf16
    ``out``): (O, dQ) of those queries, f32, and dK, dV of every key, f32,
    complete for the keys from ``q_from`` on (only those queries see
    them)."""
    b, t, h, d = q.shape
    scale = d ** -0.5
    bf = torch.bfloat16
    o_rows, dq_rows = [], []
    dk = torch.zeros(b, t, h, d, device=q.device)
    dv = torch.zeros(b, t, h, d, device=q.device)
    for a in range(q_from, t, block):
        e = min(a + block, t)
        qb, dob = q[:, a:e].float(), do[:, a:e].float()
        kk, vv = k[:, :e].float(), v[:, :e].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qb, kk) * scale
        keep = (torch.arange(e, device=q.device)[None, :]
                <= torch.arange(a, e, device=q.device)[:, None])
        s = s.masked_fill(~keep, -1e30)
        p = torch.softmax(s, dim=-1)
        del s
        o_rows.append(torch.einsum("bhqk,bkhd->bqhd", p, vv))
        delta = (dob * out[:, a:e].float()).sum(-1).transpose(1, 2)
        dp = torch.einsum("bqhd,bkhd->bhqk", dob, vv)
        ds = (p * (dp - delta[..., None]) * scale).to(bf).float()
        del dp
        dq_rows.append(torch.einsum("bhqk,bkhd->bqhd", ds, kk))
        dk[:, :e] += torch.einsum("bhqk,bqhd->bkhd", ds, qb)
        dv[:, :e] += torch.einsum("bhqk,bqhd->bkhd", p.to(bf).float(), dob)
        del p, ds
    return torch.cat(o_rows, 1), torch.cat(dq_rows, 1), dk, dv


def phase_long_context(lengths=LONG_LENGTHS):
    """Causal flash attention forward + backward at each of ``lengths``
    tokens (1 sequence, 12 heads of 64, bf16) through flash_attention:
    ms and tokens/s (CUDA events, 5 runs), the launches, and O, dQ, dK,
    dV held against :func:`plain_blocked`."""
    from ray_tpu_torch.ops.flash_attention import flash_attention
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    timer = Timer(iters=5, warmup=1)
    launches = dict.fromkeys(_all_counts(), 0)
    for t in lengths:
        shape = (1, t) + LONG_HEADS
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        q, k, v = (x.requires_grad_() for x in (q, k, v))
        _zero_all_counts()
        out = flash_attention(q, k, v, causal=True)
        grads = torch.autograd.grad(out, (q, k, v), do)
        torch.cuda.synchronize()
        run = _all_counts()
        assert run == {**dict.fromkeys(run, 0), **_flash_per(1)}, run
        launches = {k_: launches[k_] + run[k_] for k_ in run}
        q_from = 0 if t == lengths[0] else t - LONG_TAIL
        with torch.no_grad():
            o_ref, dq_ref, dk_ref, dv_ref = plain_blocked(
                q.detach(), k.detach(), v.detach(), do, out.detach(),
                q_from)
        held = {"O": (out[:, q_from:], o_ref),
                "dq": (grads[0][:, q_from:], dq_ref),
                "dk": (grads[1][:, q_from:], dk_ref[:, q_from:]),
                "dv": (grads[2][:, q_from:], dv_ref[:, q_from:])}
        line = {"phase": "long_context", "shape": list(shape),
                "dtype": "bfloat16", "causal": True,
                "held_from_position": q_from, "row_tol": ROW_TOL[
                    torch.bfloat16], "launches": run}
        for name, (got, ref) in held.items():
            assert torch.isfinite(got).all(), name
            line[f"{name}_row_scaled_err"] = err = row_scaled_err(got, ref)
            assert err <= ROW_TOL[torch.bfloat16], (t, name, err)
        del held, o_ref, dq_ref, dk_ref, dv_ref
        line["fwd_ms"] = timer(lambda: flash_attention(q, k, v, causal=True))
        line["fwd_bwd_ms"] = timer(lambda: torch.autograd.grad(
            flash_attention(q, k, v, causal=True), (q, k, v), do))
        line["tokens_per_s"] = t / (line["fwd_bwd_ms"] / 1e3)
        # the kernels' work: 4 D flops a visible pair forward, 8 D in
        # dK/dV and 6 D in dQ; q, k, v, dO read and O, dQ, dK, dV written
        # once, with the LSE
        pairs = t * (t + 1) // 2
        line["bound_ms"], line["bound_by"] = bound(
            18 * shape[3] * shape[2] * pairs,
            8 * q.numel() * 2 + t * shape[2] * 4, torch.bfloat16)
        line["card"] = card_line()
        emit(line)
        del q, k, v, do, out, grads
        _free()
    emit({"phase": "long_context", "ok": True})
    return launches


def _nccl_world_of_one():
    """A one-rank NCCL process group at a free localhost port (nothing
    on the machine tells a program of a cluster)."""
    import socket
    import torch.distributed as dist
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)


def _sp_train(impl, mesh, steps=SP_STEPS):
    """GPT-2 124M at 1 x SP_SEQ tokens through ``attn_impl=impl`` under
    ``mesh``: 1 warm-up and ``steps`` steps from the seeded weights and
    batch; (losses, step ms, peak GB, launches)."""
    from ray_tpu_torch.models.gpt2 import (GPT2, GPT2Config, adamw,
                                           loss_fn, train_step)
    from ray_tpu_torch.parallel import use_mesh
    cfg = GPT2Config.gpt2_small(max_seq_len=SP_SEQ, attn_impl=impl)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = GPT2(cfg, device="cuda", generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, SP_SEQ), generator=gen,
                           device="cuda")
    opt = adamw(model.parameters(), lr=3e-4, weight_decay=0.01)
    losses = []

    def step():
        losses.append(train_step(model, opt, tokens,
                                 head_logits_dtype=torch.bfloat16))

    with use_mesh(mesh):
        _zero_all_counts()
        torch.cuda.reset_peak_memory_stats()
        _sync_time(step)
        _, elapsed = _sync_time(lambda: [step() for _ in range(steps)])
        launches = _all_counts()
    losses = [x.item() for x in losses]
    assert all(map(math.isfinite, losses)), (impl, losses)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del model, opt
    _free()
    return losses, elapsed / steps * 1e3, peak, launches, cfg


def _ring_compose(shape, gen):
    """The kernel ring of SP_RANKS ranks driven in one process
    (simulate_ring) against flash_attention on the whole sequence:
    row-scaled O, dQ, dK, dV, and the launches of the ring's run."""
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.parallel.ring_attention import simulate_ring
    q, k, v, g = (torch.randn(shape, generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    _zero_all_counts()
    out, grads = simulate_ring(q, k, v, g, SP_RANKS, causal=True)
    torch.cuda.synchronize()
    launches = _all_counts()
    # rank r runs the diagonal and its r past chunks, forward and back
    pairs = SP_RANKS * (SP_RANKS + 1) // 2
    kinds = _chunk_kinds(q)
    for name in SP_RING_KERNELS.get(shape[-1], ()):
        assert launches[name] == pairs, (shape, name, launches)
    assert launches == {**dict.fromkeys(launches, 0), **{
        chunk_name(kinds[p], n): pairs for p, n in (
            ("fwd", "fwd"), ("dkdv", "bwd_dkdv"), ("dq", "bwd_dq"))}
    }, (shape, launches)
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    ref = flash_attention(qr, kr, vr, causal=True)
    ref_grads = torch.autograd.grad(ref, (qr, kr, vr), g)
    res = {"shape": list(shape), "ranks": SP_RANKS, "launches": {
        k_: v_ for k_, v_ in launches.items() if v_}}
    for name, got, r in zip(("O", "dq", "dk", "dv"), (out, *grads),
                            (ref, *ref_grads)):
        res[f"{name}_row_scaled_err"] = err = row_scaled_err(got, r)
        assert err <= ROW_TOL[torch.bfloat16], (shape, name, err)
    return res, launches


def phase_seq_parallel():
    """Sequence-parallel GPT-2 and its attention on the card: the 124M
    training step at 1 x SP_SEQ through flash, ring and Ulysses on a
    world-size-1 mesh (losses against flash's; the ring's steps launch
    only the chunk mode of #1/#3/#4), then the ring's and Ulysses'
    composition over SP_RANKS ranks in one process against
    flash_attention.  Returns the launches of every run, summed."""
    import torch.distributed as dist
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.parallel import MeshConfig, build_mesh
    from ray_tpu_torch.parallel.ulysses import simulate_ulysses
    _nccl_world_of_one()
    total = dict.fromkeys(_all_counts(), 0)

    def add(run):
        for k_, v_ in run.items():
            total[k_] += v_

    try:
        mesh = build_mesh(MeshConfig(sp=1))
        runs = {}
        for impl in ("flash", "ring", "ulysses"):
            losses, step_ms, peak, launches, cfg = _sp_train(impl, mesh)
            add(launches)
            per_step = {**_flash_per(cfg.num_layers * (SP_STEPS + 1)),
                        **dict.fromkeys(_chunk_counts(), 0), "rmsnorm": 0}
            if impl == "ring":  # every layer's attention in chunk mode
                per_step.update(dict.fromkeys(FLASH_NL, 0))
                per_step.update({chunk_name("", p): cfg.num_layers
                                 * (SP_STEPS + 1)
                                 for p in ("fwd", "bwd_dkdv", "bwd_dq")})
            assert launches == per_step, (impl, launches, per_step)
            runs[impl] = {"losses": losses, "step_ms": step_ms,
                          "tokens_per_s": SP_SEQ / (step_ms / 1e3),
                          "mfu": SP_SEQ / (step_ms / 1e3)
                          * cfg.flops_per_token()
                          / PEAK_FLOPS[torch.bfloat16],
                          "peak_memory_gb": peak, "launches": {
                              k_: v_ for k_, v_ in launches.items() if v_}}
        for impl in ("ring", "ulysses"):
            rel = max(abs(a - b) / abs(b) for a, b in zip(
                runs[impl]["losses"], runs["flash"]["losses"]))
            runs[impl]["loss_max_rel_diff_vs_flash"] = rel
            assert rel <= SP_LOSS_RTOL, (impl, rel, runs)
        emit({"phase": "seq_parallel", "part": "gpt2_124m",
              "config": f"gpt2_small (12 layers, 768 wide, 12 heads, bf16 "
              f"compute, f32 masters), 1 x {SP_SEQ} tokens, world-size-1 "
              f"mesh", "steps": SP_STEPS, "warmup_steps": 1,
              "loss_rtol": SP_LOSS_RTOL, "runs": runs, "card": card_line()})
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        for shape in SP_RING_SHAPES:
            res, launches = _ring_compose(shape, gen)
            add(launches)
            emit({"phase": "seq_parallel", "part": "ring_in_process",
                  **res})
            _free()
        q, k, v, g = (torch.randn(SP_ULYSSES_SHAPE, generator=gen,
                                  device="cuda").to(torch.bfloat16)
                      for _ in range(4))
        qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
        _zero_all_counts()
        out = simulate_ulysses(qr, kr, vr, SP_RANKS, causal=True)
        grads = torch.autograd.grad(out, (qr, kr, vr), g)
        torch.cuda.synchronize()
        launches = _all_counts()
        # each rank's 3 heads of 64 take the head-major kernels
        assert launches == {**dict.fromkeys(launches, 0),
                            **_flash_per(SP_RANKS, hm=True)}, launches
        add(launches)
        qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
        ref = flash_attention(qr, kr, vr, causal=True)
        ref_grads = torch.autograd.grad(ref, (qr, kr, vr), g)
        res = {"phase": "seq_parallel", "part": "ulysses_in_process",
               "shape": list(SP_ULYSSES_SHAPE), "ranks": SP_RANKS,
               "launches": {k_: v_ for k_, v_ in launches.items() if v_}}
        for name, got, r in zip(("O", "dq", "dk", "dv"), (out, *grads),
                                (ref, *ref_grads)):
            res[f"{name}_row_scaled_err"] = err = row_scaled_err(got, r)
            assert err <= ROW_TOL[torch.bfloat16], ("ulysses", name, err)
        emit(res)
    finally:
        dist.destroy_process_group()
    emit({"phase": "seq_parallel", "ok": True})
    return total


SYMBOLS = {"flash_fwd": "flash_fwd_bf16_kernel",  # the bf16 kernel's name
           "flash_hm_fwd": "flash_fwd_bf16_kernel",
           "flash_bwd_dkdv": "bwd_dkdv_bf16_kernel",
           "flash_hm_bwd_dkdv": "bwd_dkdv_bf16_kernel",
           "flash_bwd_dq": "bwd_dq_bf16_kernel",
           "flash_hm_bwd_dq": "bwd_dq_bf16_kernel",
           "flash_wide_fwd": "wide_fwd_kernel",
           "flash_wide_bwd_dkdv": "wide_dkdv_kernel",
           "flash_wide_bwd_dq": "wide_dq_kernel",
           "flash_xwide_fwd": "xwide_fwd_kernel",
           "flash_xxwide_fwd": "xwide_fwd_kernel",
           "flash_xwide_bwd_dkdv": "xbwd_dkdv_kernel",
           "flash_xwide_bwd_dq": "xbwd_dq_kernel",
           "flash_fma_fwd": "fma_fwd_kernel"}
WIDE_SHAPE = list(HEAD_DIM_SHAPE + (256,))
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
    # the head-major kernels above head_dim 128: bf16 forward, dK/dV and
    # dQ up to 256 on flash_wide.cu, the bf16 forward up to 1024 on
    # flash_xwide.cu, dK/dV and dQ on flash_xwide_bwd.cu, the f32 forward
    # on flash_fma.cu and dK/dV and dQ on flash_fma_bwd.cu (their rows in
    # f32)
    "flash_wide_fwd": ("ray_tpu_torch/ops/csrc/flash_wide.cu",
                       "ray_tpu/ops/flash_attention.py:82", WIDE_SHAPE),
    "flash_wide_bwd_dkdv": ("ray_tpu_torch/ops/csrc/flash_wide.cu",
                            "ray_tpu/ops/flash_attention.py:212", WIDE_SHAPE),
    "flash_wide_bwd_dq": ("ray_tpu_torch/ops/csrc/flash_wide.cu",
                          "ray_tpu/ops/flash_attention.py:268", WIDE_SHAPE),
    "flash_xwide_fwd": ("ray_tpu_torch/ops/csrc/flash_xwide.cu",
                        "ray_tpu/ops/flash_attention.py:82",
                        list(ROUTED_WIDE)),
    "flash_xxwide_fwd": ("ray_tpu_torch/ops/csrc/flash_xwide.cu",
                         "ray_tpu/ops/flash_attention.py:82",
                         list(ROUTED_XXWIDE)),
    "flash_xwide_bwd_dkdv": ("ray_tpu_torch/ops/csrc/flash_xwide_bwd.cu",
                             "ray_tpu/ops/flash_attention.py:212",
                             list(ROUTED_WIDE)),
    "flash_xwide_bwd_dq": ("ray_tpu_torch/ops/csrc/flash_xwide_bwd.cu",
                           "ray_tpu/ops/flash_attention.py:268",
                           list(ROUTED_WIDE)),
    "flash_fma_fwd": ("ray_tpu_torch/ops/csrc/flash_fma.cu",
                      "ray_tpu/ops/flash_attention.py:82",
                      list(ROUTED_F32 + (256,))),
    "flash_fma_bwd_dkdv": ("ray_tpu_torch/ops/csrc/flash_fma_bwd.cu",
                           "ray_tpu/ops/flash_attention.py:212",
                           list(ROUTED_F32 + (256,))),
    "flash_fma_bwd_dq": ("ray_tpu_torch/ops/csrc/flash_fma_bwd.cu",
                         "ray_tpu/ops/flash_attention.py:268",
                         list(ROUTED_F32 + (256,))),
}
# the rows timed in f32
F32_ROWS = FLASH_FMA


def _case_is(c, name):
    """Whether case ``c`` ran kernel ``name`` (a forward's, or one part of
    a backward pair's; chunk-mode names too)."""
    for part in ("dkdv", "dq"):
        if f"_bwd_{part}" in name:
            return c.get(f"kernel_{part}") == name
    return c["kernel"] == name


CHUNK_SUMMARY = (  # the chunk mode's rows: kind, part, TPU line, shape
    ("", "fwd", 447, CHUNK_NL), ("", "bwd_dkdv", 606, CHUNK_NL),
    ("", "bwd_dq", 680, CHUNK_NL), ("hm", "fwd", 82, CHUNK_HM),
    ("hm", "bwd_dkdv", 212, CHUNK_HM), ("hm", "bwd_dq", 268, CHUNK_HM),
    ("wide", "fwd", 82, CHUNK_WIDE), ("wide", "bwd_dkdv", 212, CHUNK_WIDE),
    ("wide", "bwd_dq", 268, CHUNK_WIDE), ("xwide", "fwd", 82, CHUNK_XWIDE),
    ("xwide", "bwd_dkdv", 212, CHUNK_XWIDE),
    ("xwide", "bwd_dq", 268, CHUNK_XWIDE),
    ("xxwide", "fwd", 82, CHUNK_XXWIDE))


def chunk_summary(cases, by_path, usage):
    """The kernels line's rows of the chunk mode (bf16 in, f32 out, the
    backward from a given LSE and delta): the diagonal (causal) case at
    its shape, the past (not causal) one and the kernel's other timed
    shapes in ``other_shapes``, each with the same kernels' time with
    bf16 outputs beside it.  No library call returns f32 O from bf16
    inputs, so ``library_ms`` is null; ``plain_ms`` of a backward row is
    the whole plain backward."""
    rows = []
    for kind, part, line, shape in CHUNK_SUMMARY:
        name = chunk_name(kind, part)
        timed = [c for c in cases if c.get("mode") == "f32out"
                 and "kernel_ms" in c and _case_is(c, name)]
        sfx = "" if part == "fwd" else part[3:]  # "", "_dkdv", "_dq"

        def timing(c):
            return {"ms": c["kernel_ms" + sfx],
                    "bf16out_ms": c["bf16out_ms" + sfx],
                    "bound_ms": c["bound_ms" + sfx],
                    "bound_by": c["bound_by" + sfx],
                    "plain_ms": c["plain_ms" if part == "fwd"
                                  else "plain_ms_bwd"],
                    "library_ms": None}

        c = next(c for c in timed
                 if c["shape"] == list(shape) and c["causal"])
        launches = {path: n[name] for path, n in by_path.items()
                    if n.get(name)}
        assert launches, f"{name} was not launched on any main path"
        src = {"": "flash_{}.cu", "hm": "flash_{}.cu",
               "wide": "flash_wide.cu",
               "xwide": "flash_xwide.cu" if part == "fwd"
               else "flash_xwide_bwd.cu", "xxwide": "flash_xwide.cu"}[kind]
        row = {"name": name, "route": "cuda",
               "source": "ray_tpu_torch/ops/csrc/" + src.format(part[:3]),
               "replaces": f"ray_tpu/ops/flash_attention.py:{line}",
               "launches": sum(launches.values()),
               "launches_by_path": launches,
               "max_abs_err": c["max_abs_err" + sfx], **timing(c),
               "library": "none: no PyTorch call returns f32 outputs "
               "from bf16 inputs", "shape": list(shape),
               "dtype": "bfloat16", "out_dtype": "float32",
               "causal": True,
               "other_shapes": [{"shape": o["shape"], "causal": o["causal"],
                                 **timing(o)} for o in timed if o is not c]}
        if kind == "xwide" and part != "fwd":
            row.update(xbwd_row_attrs(part[4:], shape, usage, True))
            for o in row["other_shapes"]:
                o.update(xbwd_row_attrs(part[4:], o["shape"], usage, True))
        else:
            wide = kind in ("wide", "xwide", "xxwide")
            sym = SYMBOLS[f"flash_{kind + '_' if wide else ''}{part}"]
            d = shape[-1]
            row["registers"], static = next(
                v for k, v in usage.items() if f"{sym}ILi{d}ELb1E" in k)
            row["smem_bytes"] = static + runtime_attrs(sym, d, True)[2]
        rows.append(row)
    return rows


def group_row_attrs(attrs, symbol, usage):
    """A row's registers and shared bytes for the instantiation of a
    kernel that cuts the head_dim into column groups: ``attrs`` as its
    attributes entry reports them for the launch (fma_attrs, xbwd_attrs,
    fma_bwd_attrs), ptxas's counts (``usage``) for ``symbol`` formatted
    with the group width, with the width (``group_cols``), the launch's
    clusters and how many of them the card holds at once."""
    _, _, dynamic, gc, resident, clusters = attrs
    regs, static = next(v for k, v in usage.items()
                        if symbol.format(gc) in k)
    return {"registers": regs, "smem_bytes": static + dynamic,
            "group_cols": gc, "clusters": clusters,
            "clusters_at_once": resident}


def xbwd_row_attrs(part, shape, usage, f32_out=False):
    """group_row_attrs of the flash_xwide_bwd.cu kernel (``part`` "dkdv"
    or "dq") a launch at ``shape`` takes."""
    return group_row_attrs(
        xbwd_attrs(part, shape, f32_out),
        f"xbwd_{part}_kernelILi{{}}ELb{int(f32_out)}E", usage)


NEW_FORWARDS = ("flash_xxwide_fwd", "flash_fma_fwd")


def new_forward_attrs(name, shape, usage):
    """Registers and shared bytes of the instantiation a forward of
    NEW_FORWARDS takes at ``shape``: flash_xwide.cu's 768 or 1024 build, or
    flash_fma.cu's group width (``group_cols``, picked by the shape), with
    its launch's clusters and how many of them the card holds at once."""
    if name == "flash_fma_fwd":
        return group_row_attrs(fma_attrs(shape), "fma_fwd_kernelILi{}E",
                               usage)
    d = 768 if shape[-1] <= 768 else 1024
    regs, static = next(v for k, v in usage.items()
                        if f"xwide_fwd_kernelILi{d}ELb0E" in k)
    return {"registers": regs,
            "smem_bytes": static + runtime_attrs("xwide_fwd_kernel", d)[2]}


def kernel_summary(cases, by_path, usage):
    """One row per kernel.  ``launches`` sums the main paths (each read
    between a reset and its end); for the backward kernels ``plain_ms``
    and ``library_ms`` are the whole backward (dq, dk and dv: the plain
    version and SDPA's backward), as neither splits it.  The flash rows
    add, for the bf16 kernel at the row's head_dim, ptxas's registers
    (the launch bound's share; the warp-specialised kernels' consumers
    raise theirs to 240 with setmaxnreg) and the shared memory a block
    takes: ptxas's static bytes and the dynamic bytes the runtime holds
    for the kernel's last launch; the rows of NEW_FORWARDS,
    flash_xwide_bwd.cu and flash_fma_bwd.cu carry them at every shape (the
    f32 rows, in f32, with the group width each shape takes).  The f32
    backward rows carry SDPA's SDPA_F32_READINGS readings beside their
    median (``library_ms_readings``).  The RMSNorm row adds its times at a
    decode step's shape (``decode``)."""
    rows = []
    for name, (src, replaces, shape) in SUMMARY.items():
        part = name.rsplit("_", 1)[1] if "_bwd_" in name else None
        dtype = "float32" if name in F32_ROWS else "bfloat16"
        c = next(c for c in cases if _case_is(c, name)
                 and c["shape"] == shape and c["dtype"] == dtype
                 and c.get("causal", True) and "plain_ms" in c
                 and c.get("mode") != "f32out")
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
               "dtype": dtype}
        if part:  # which SDPA backend ran the backward, each f32 reading
            row["library_backend"] = c["library_backend"]
            if "library_ms_readings" in c:
                row["library_ms_readings"] = c["library_ms_readings"]
        if part or name.endswith("fwd"):  # the other timed model shapes
            row["other_shapes"] = [
                {"shape": o["shape"], "causal": o["causal"],
                 "ms": o[f"kernel_ms_{part}"] if part else o["kernel_ms"],
                 "bound_ms": o[f"bound_ms_{part}"] if part
                 else o["bound_ms"], "plain_ms": o["plain_ms"],
                 "library_ms": o["library_ms"],
                 **({k: o[k] for k in ("library_backend",
                                       "library_ms_readings") if k in o}
                    if part else {})}
                for o in cases if _case_is(o, name) and "plain_ms" in o
                and o.get("mode") != "f32out" and o["dtype"] == dtype
                and o is not c]
        if name == "rmsnorm":  # and at the decode step's shape
            c = next(c for c in cases if c["kernel"] == name
                     and c["shape"] == list(RMSNORM_DECODE)
                     and c["dtype"] == "bfloat16" and "plain_ms" in c)
            row["decode"] = {k: c[k] for k in (
                "shape", "kernel_ms", "library_ms", "bound_ms", "bound_by")}
        if name in NEW_FORWARDS:  # and at each other shape, as they vary
            row.update(new_forward_attrs(name, shape, usage))
            for o in row["other_shapes"]:
                o.update(new_forward_attrs(name, o["shape"], usage))
        elif name in FLASH_XWIDE_BWD:  # and at each other shape
            row.update(xbwd_row_attrs(part, shape, usage))
            for o in row["other_shapes"]:
                o.update(xbwd_row_attrs(part, o["shape"], usage))
        elif name in FLASH_FMA_BWD:  # and at each other shape
            sym = f"fma_{part}_kernelILi{{}}E"
            row.update(group_row_attrs(fma_bwd_attrs(part, shape), sym,
                                       usage))
            for o in row["other_shapes"]:
                o.update(group_row_attrs(fma_bwd_attrs(part, o["shape"]),
                                         sym, usage))
        elif name in SYMBOLS:
            sym, d = SYMBOLS[name], shape[-1]
            regs, static = next(v for k, v in usage.items()
                                if f"{sym}ILi{d}ELb0E" in k)
            row["registers"] = regs
            row["smem_bytes"] = static + runtime_attrs(sym, d)[2]
        rows.append(row)
    return {"kernels": rows + chunk_summary(cases, by_path, usage)}


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
    _free()
    long_context = phase_long_context()
    _free()
    seq_parallel = phase_seq_parallel()
    # the runtime and the toy decoder launch no kernel of the port
    assert not any(runtime.values()), runtime
    assert not any(serve_batching.values()), serve_batching
    emit(kernel_summary(cases, {"serve": serve, "train": train,
                                "train_xl": train_xl, "vit": vit,
                                "moe": moe, "resnet": resnet,
                                "head_dims": head_dims,
                                "train_gang": train_gang,
                                "long_context": long_context,
                                "seq_parallel": seq_parallel}, usage))
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
