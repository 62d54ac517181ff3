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
22. ``sharded``: the sharding presets on DTensor, on a world-size-1 NCCL
    mesh with every axis of one rank: GPT-2 124M at 32 x 1024 placed
    under TP_RULES and FSDP_RULES and the MoE (``MoEConfig()``, 8 x 1024)
    under EP_RULES, a warm-up and 3 AdamW steps each, against the direct
    steps on the same weights and batches (losses, step ms, the host's
    time to issue a step, the device-traced idle share, #1/#3/#4 once a
    layer a step); ``simulate_pipeline`` over GPT-2 124M's 12 blocks as 4
    stages of 3 with 8 microbatches of 4 x 1024 against the blocks run in
    sequence (output and gradients); ResNet-18 at 256 images with
    ``axis_name="dp"`` against ``axis_name=None`` (logits, running
    statistics, gradients).
23. ``rl``: PPO with the learner on the card.  ``learn_on_batch`` for
    the MLP, LSTM and attention models on the card against the CPU on
    the same weights and CartPole batch (each parameter's update, the
    stats; the parameters and Adam's moments on the card), then
    bench.py's ``bench_rllib_ppo`` shapes on ``init(num_cpus=16)``:
    inline (0 workers x 8 envs), fleet_legacy (2 rollout workers x 16
    envs, ``sample_async``) and fleet (the decoupled pipeline, 2 env
    actors x 256 envs, inference on the host): env-steps/s, the
    learner's ms per ``train()`` and per SGD update, its busy share from
    a device trace, finite losses, the pipeline's occupancy and stale
    drops.  No kernel of the port.
24. ``rl_zoo``: the model-free algorithms with their learners on the
    card.  ``learn_on_batch`` (R2D2: ``learn_on_sequences``) of IMPALA,
    APPO, PG, A2C, MARWIL (beta 1 and 0), DQN (double-Q on and off),
    R2D2, SAC, DDPG, TD3, CQL and CRR on the card against the CPU on the
    same weights, batch, update noise and Adam moments (each tensor's
    update, the stats; every network, target copy, log_alpha and moment
    on the card; each state restored across devices), then the tuned
    example of each ported algorithm on ``init(num_cpus=16)``: env-steps/s
    (offline: rows learned/s) per ``train()``, the learner's ms per
    update and updates per ``train()``, finite losses; IMPALA's and
    APPO's yaml run to its criterion.  No kernel of the port.
25. ``tune``: Tune on ``init(num_cpus=4, num_gpus=1)`` with trials that
    train GPT-2 124M at full width (8 x 1024 tokens a step, AdamW(lr,
    0.01)), each trial a cold-spawned worker leasing half the card, two
    at a time: the direct run of each lr in this process first, then
    ASHA over four lrs (every loss against the direct run's, the later
    two stopped at rung 2, the best result's lr), then PBT over two
    trials of 3 steps that check in together and checkpoint every step
    (model, AdamW state, step and writer): an exploit restores the other
    trial's checkpoint, and the restored trial's first loss must equal
    the loss its writer reported at that step.  Each trial's start,
    the step alone and shared, the checkpoint's bytes and trip, the
    card's busy share from ``nvidia-smi``.
26. ``cluster``: GPT-2 124M on a multi-node cluster
    (``cluster_utils.Cluster``: a head with no GPU, a GPU node and a CPU
    node), its weights put once as CPU tensors; a ``num_gpus=1`` actor,
    placed on the GPU node (read through ``experimental.state``), runs
    the bf16 forward at 8 x 1024 tokens (12 launches of #1), held against
    the same forward in this process; ``timeline()`` and
    ``summarize_tasks`` show its calls; a second driver connects by
    ``ray://`` to a client server on the head and runs the forward as a
    GPU task, the logits back on its own card; then the CLI starts a
    head with the GPU, a driver joins with ``init(address="auto")`` and
    runs it once more; the CLI's ``status``, ``list tasks`` and
    ``stop``.  Each stage's seconds, the launches, each max |diff| and
    whether it is bitwise.
27. ``ops``: the control plane on a cluster that starts without the
    card (a head with no GPU): the dashboard (``Dashboard(port=0)``) and
    an ``AutoscalerMonitor`` over a ``FakeMultiNodeProvider`` whose one
    node type, ``gpu_worker``, is {CPU: 2, GPU: 1}, at most one.  A job
    submitted over the dashboard's REST routes
    (``JobSubmissionClient``) runs ``scripts/gpt2_job_torch.py``, whose
    ``num_gpus=1`` task runs GPT-2 124M's bf16 forward at 8 x 1024
    tokens (12 launches of #1): the autoscaler must launch exactly one
    GPU node, the task must run there, and the logits' sha256 and last
    rows in the job's log must equal the same forward in this process
    bit for bit.  Then ``/api/nodes``, ``/api/node_stats`` (an agent row
    for every live node), ``/api/jobs/`` and ``/metrics`` (parsed as
    Prometheus text), the CLI's ``nodes`` (the monitor's last decision),
    the idle node drained through the GCS and terminated, and the CLI's
    ``up`` / ``down`` on a local-provider YAML (a CPU head and a CPU
    worker that a driver reaches; no process left).  Each stage's
    seconds; the phase holds itself under OPS_LIMIT_S.
28. ``workflow``: a durable workflow (``ray_tpu_torch.workflow``) driven
    by ``scripts/gpt2_workflow_torch.py``, each driver with a local
    cluster of its own: a CPU step draws 8 x 1024 token ids, a
    ``num_gpus=1`` step runs GPT-2 124M's bf16 forward (12 launches of
    #1) and returns its logits' sha256 and last rows as a CUDA tensor,
    then the workflow waits for an event.  The driver hard-exits
    (``os._exit(9)``) there: none of its session's processes may be left
    and the card's free memory must be back to what it was; the storage
    reads RUNNING, and step 2's stored CUDA tensor reloads on this
    process's card equal to the in-process forward's.  A fresh driver
    sends the event and resumes: SUCCEEDED, steps 1 and 2 run once in
    all, step 4 (``num_gpus=1``) and its continuation (``num_gpus=1``,
    step 2's tensor its argument, on the card) once; the sha256, the last
    rows' sha256 and f64 sum equal the in-process forward's bit for bit;
    ``list_all()`` and the management actor read SUCCEEDED.  Each stage's
    seconds; the phase holds itself under WORKFLOW_LIMIT_S.

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
at head_dim 256, 512 and 1024, and held at the new kernels' ragged ends;
and ``flash_attention(native=False, bwd_impl="xla")`` at GPT-2 124M's
attention (``bwd_impl_case``: one #5 launch and no #6/#7, the recomputed
gradients against #6/#7 and the plain backward on the same delta and an
f64 backward, both backwards' ms).  Each main path (``serve``, ``train``,
``train_xl``, ``vit``, ``moe``, ``resnet``, ``head_dims``, ``runtime``,
``train_gang``, whose worker counts its own, ``serve_batching``,
``long_context``, each run of ``seq_parallel``, each placed run and
the pipeline of ``sharded``, ``rl``'s shapes, ``rl_zoo``'s tuned
examples, ``tune``, whose trials count their own, ``cluster``, whose
actor and GPU tasks count their own, ``ops``, whose job's task
counts its own, and ``workflow``, whose GPU step counts its own) is
driven with the kernels' launch counts set to 0 just before it and read
just after; the native-layout paths launch no
head-major kernel, GPT-2 XL no native-layout one, and ResNet, the
runtime, the toy decoder's serve path and RL none at all.

Then the kernels' summary line, the card's name and power limit, and,
last, ``{"ok": true, "device": {...}}``.  Any failure raises: no result
line, nonzero exit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
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
NEG_INF_F64 = -1e300
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


# flash_attention's bwd_impl switch at GPT-2 124M's attention, head-major:
# "xla" keeps kernel #5's forward and recomputes the backward through the
# plain attention under autograd; "pallas" runs kernels #6 and #7.  The two
# differ in delta = rowsum(dO * O): the kernels' backward (as the JAX
# package's) takes it from the bf16 O, the recompute from the exact one.
# Where dS = P (dP - delta) cancels, at the first causal queries, that
# rounding moves dQ by up to 0.42 of its row's RMS (this case on an H100
# 80GB HBM3 at 700 W: the "xla" dQ within 0.014 of an f64 backward, the
# "pallas" one 0.44 from it), so the "xla" gradients are held against the
# kernels and the plain backward given the same, exact delta, and against
# f64 on one batch.
BWD_IMPL_SHAPE = (8, 1024, 12, 64)


def _attention_grads_f64(q, k, v, do, scale):
    """Causal attention's (dq, dk, dv) in f64 by autograd."""
    q, k, v = (x.double().requires_grad_() for x in (q, k, v))
    t = q.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    keep = torch.ones(t, t, dtype=torch.bool, device=q.device).tril()
    out = torch.einsum("bhqk,bkhd->bqhd",
                       s.masked_fill(~keep, NEG_INF_F64).softmax(-1), v)
    return torch.autograd.grad(out, (q, k, v), do.double())


def bwd_impl_case(timer, gen, shape=BWD_IMPL_SHAPE, dtype=torch.bfloat16):
    """``flash_attention(native=False, bwd_impl="xla")`` against the
    same call with ``"pallas"``, causal: the same forward (one #5 launch
    each), no #6/#7 launch in the "xla" backward.  Its gradients within
    ROW_TOL of kernels #6/#7 and of the plain backward on the exact delta
    (the f32 O's) and of an f64 backward on the first batch row; their
    distance from the "pallas" call's gradients (bf16 O's delta) is read,
    not held.  Each backward's ms (readings: the switch is the caller's
    A/B, not a claim)."""
    from ray_tpu_torch.ops.flash_attention import (
        _bwd_inputs, _kernel_dkdv, _kernel_dq, _recompute_backward,
        attention_backward_reference, attention_delta, attention_reference,
        flash_attention)
    fwd, bwd = _family(True)
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
                   for _ in range(4))
    scale = shape[-1] ** -0.5

    def call(impl):
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        counts = (fwd.launches, bwd.launches_dkdv, bwd.launches_dq)
        out = flash_attention(*leaves, causal=True, native=False,
                              bwd_impl=impl)
        grads = torch.autograd.grad(out, leaves, do)
        torch.cuda.synchronize()
        moved = [n - c for n, c in zip(
            (fwd.launches, bwd.launches_dkdv, bwd.launches_dq), counts)]
        return out, grads, moved

    out_x, grads_x, moved_x = call("xla")
    out_p, grads_p, moved_p = call("pallas")
    assert moved_x == [1, 0, 0], moved_x
    assert moved_p == [1, 1, 1], moved_p
    assert torch.equal(out_x, out_p)
    out, lse = fwd(q, k, v, causal=True, scale=scale)
    delta = attention_delta(
        attention_reference(q, k, v, True, scale, torch.float32)[0], do)
    plain = attention_backward_reference(q, k, v, out, lse, do, True,
                                         scale, delta=delta)
    dkdv_args, dq_args = _bwd_inputs(q, k, v, do, lse, delta, True, scale,
                                     hm=True)
    kernels = (_kernel_dq(*dq_args), *_kernel_dkdv(*dkdv_args))
    exact = _attention_grads_f64(*(x[:1] for x in (q, k, v, do)), scale)
    tol = ROW_TOL[dtype]
    res = {"kernel": "bwd_impl_xla", "shape": list(shape),
           "dtype": str(dtype).replace("torch.", ""), "causal": True,
           "row_tol": tol, "launches_xla": moved_x,
           "launches_pallas": moved_p}
    for name, gx, gp, kern, r, e in zip(("dq", "dk", "dv"), grads_x,
                                        grads_p, kernels, plain, exact):
        assert gx.dtype == dtype and torch.isfinite(gx).all(), name
        errs = {"kernels_exact_delta": row_scaled_err(gx, kern),
                "plain_exact_delta": row_scaled_err(gx, r),
                "f64_batch0": row_scaled_err(gx[:1], e)}
        assert max(errs.values()) <= tol, (name, errs, tol)
        errs["pallas_call"] = row_scaled_err(gx, gp)  # read, not held
        errs["pallas_call_f64_batch0"] = row_scaled_err(gp[:1], e)
        res[f"{name}_row_scaled_err"] = errs
        res[f"{name}_max_abs_err_vs_pallas"] = max_err(gx, gp)
    res["xla_bwd_ms"] = timer(
        lambda: _recompute_backward(q, k, v, do, True, scale))
    res["pallas_bwd_ms"] = timer(
        lambda: bwd(q, k, v, out, lse, do, causal=True, scale=scale))
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
    add(bwd_impl_case(timer, gen))
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


# the sharded phase: GPT-2 124M and the MoE trained on DTensor parameters
# placed by the presets, on a world-size-1 mesh (every axis of one rank,
# so each DTensor is whole on the card), against the direct steps
SHARDED_BATCH, SHARDED_SEQ = 32, 1024
SHARDED_MOE_BATCH = 8
SHARDED_STEPS = 3
# the losses of the placed steps against the direct ones on the same
# weights and batches: the same kernels on the same values (nothing is
# split at one rank; the LM head's softmax and the lookup take the port's
# per-rank code, whose sums over one rank add nothing), so they differ at
# most where an op sums in another order (the placed MoE's combine is one
# product over (expert, slot), the direct one torch's einsum); 1e-3 is
# train_gang's limit for a bf16 step taken twice
SHARDED_LOSS_RTOL = 1e-3
# the pipeline: GPT-2 124M's 12 blocks as 4 stages of 3, 8 microbatches
# of 4 x 1024, bf16 activations; the same block calls on the same values
# as the blocks run in sequence, the parameters' f32 gradients summed over
# the microbatches in another order: each held at 1e-5 of its largest
# element
PIPE_STAGES, PIPE_MICRO, PIPE_MB = 4, 8, 4
PIPE_REL_TOL = 1e-5
# ResNet-18 with axis_name="dp" at one rank against axis_name=None: the
# all-reduce of one rank and the division by 1 are exact, so the two
# agree to the bit under deterministic cuDNN algorithms (held at 1e-6 of
# each tensor's largest element)
SHARDED_RESNET_BATCH = 256
SHARDED_RESNET_REL_TOL = 1e-6


def _rel_err(got, ref) -> float:
    """max |got - ref| over max |ref|, in f32."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)
            ).item()


def _sharded_run(build, loss_fn, tokens, per_step, rules=None, mesh=None):
    """A warm-up and SHARDED_STEPS AdamW(3e-4, 0.01) steps of
    ``loss_fn(model, tokens)`` on ``build()``, with the parameters and
    the batch placed under ``rules`` on ``mesh`` where given (each step
    then gives the gradients their parameters' placements), each step
    launching ``per_step`` flash kernels; then the host's time to issue
    one step and one device-traced step.  Returns (the line's fields,
    the launches of the warm-up and timed steps)."""
    from ray_tpu_torch.models.gpt2 import adamw
    from ray_tpu_torch.parallel import sharding
    model = build()
    if rules is not None:
        sharding.place_module_params(model, rules, mesh)
        tokens = sharding.shard_tensor(tokens, rules, mesh, "batch", None)
    opt = adamw(model.parameters(), lr=3e-4, weight_decay=0.01)

    def step():
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens)
        loss.backward()
        sharding.place_gradients(model)
        opt.step()
        return loss.detach()

    _zero_all_counts()
    losses, warm_s, elapsed = train_loop(step, SHARDED_STEPS, per_step)
    launches = _all_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    line = {"losses": losses, "warmup_s": warm_s,
            "step_ms": elapsed / SHARDED_STEPS * 1e3,
            "host_issue_ms": host_ms,
            "device_traced_step": device_traced_step(step)}
    if rules is not None:
        line["placements"] = sorted({str(tuple(p.placements))
                                     for p in model.parameters()})
    del model, opt
    _free()
    return line, launches


def _sharded_train(phase_part, config, build, loss_fn, tokens, per_step,
                   presets, mesh, total):
    """The direct steps, then the same steps under each preset; every
    placed run's losses within SHARDED_LOSS_RTOL of the direct ones."""
    from ray_tpu_torch.parallel.sharding import PRESETS
    direct, _ = _sharded_run(build, loss_fn, tokens, per_step)
    runs = {}
    for name in presets:
        run, launches = _sharded_run(build, loss_fn, tokens, per_step,
                                     PRESETS[name], mesh)
        for k_, v_ in launches.items():
            total[k_] += v_
        run["launches"] = {k_: v_ for k_, v_ in launches.items() if v_}
        run["loss_max_rel_diff_vs_direct"] = rel = max(
            abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                direct["losses"]))
        assert rel <= SHARDED_LOSS_RTOL, (phase_part, name, rel, run,
                                          direct)
        runs[f"{name}_rules"] = run
    emit({"phase": "sharded", "part": phase_part, "config": config,
          "steps": SHARDED_STEPS, "warmup_steps": 1,
          "loss_rtol": SHARDED_LOSS_RTOL, "direct": direct, **runs,
          "card": card_line()})


def _sharded_pipeline(total):
    """simulate_pipeline over GPT-2 124M's 12 blocks as PIPE_STAGES
    stages against the blocks run in sequence: the output, the
    microbatches' gradient and every block parameter's."""
    from torch.func import functional_call
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from ray_tpu_torch.parallel.pipeline import (simulate_pipeline,
                                                 stack_block_params)
    cfg = GPT2Config.gpt2_small()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = GPT2(cfg, device="cuda", generator=gen)
    per = cfg.num_layers // PIPE_STAGES
    stages = [torch.nn.Sequential(*model.h[i * per:(i + 1) * per])
              for i in range(PIPE_STAGES)]
    stacked = stack_block_params([dict(s.named_parameters())
                                  for s in stages])
    shape = (PIPE_MICRO, PIPE_MB, SHARDED_SEQ, cfg.embed_dim)
    x, g = (torch.randn(shape, generator=gen, device="cuda").to(
        cfg.dtype) for _ in range(2))
    params = list(model.h.parameters())
    xr = x.clone().requires_grad_()
    _zero_all_counts()
    out, elapsed = _sync_time(lambda: simulate_pipeline(
        lambda p, a: functional_call(stages[0], p, (a,)), stacked, xr))
    grads, bwd_s = _sync_time(lambda: torch.autograd.grad(
        out, [xr, *params], g))
    launches = _all_counts()
    n = cfg.num_layers * PIPE_MICRO
    assert launches == {**dict.fromkeys(launches, 0),
                        **_flash_per(n)}, launches
    for k_, v_ in launches.items():
        total[k_] += v_
    del stacked
    xs = x.clone().requires_grad_()
    ref = torch.stack([functools.reduce(lambda a, b: b(a), model.h, xs[m])
                       for m in range(PIPE_MICRO)])
    ref_grads = torch.autograd.grad(ref, [xs, *params], g)
    errs = {"out": _rel_err(out, ref), "dx": _rel_err(grads[0],
                                                      ref_grads[0]),
            "params_max": max(_rel_err(a, b) for a, b in
                              zip(grads[1:], ref_grads[1:]))}
    assert all(e <= PIPE_REL_TOL for e in errs.values()), errs
    emit({"phase": "sharded", "part": "pipeline",
          "config": f"gpt2_small blocks ({cfg.num_layers}) as {PIPE_STAGES}"
          f" stages of {per}, {PIPE_MICRO} microbatches of {PIPE_MB} x "
          f"{SHARDED_SEQ}, bf16 activations", "forward_s": elapsed,
          "backward_s": bwd_s, "rel_tol": PIPE_REL_TOL,
          "rel_errs_vs_sequence": errs,
          "launches": {k_: v_ for k_, v_ in launches.items() if v_}})
    del model, out, grads, ref, ref_grads
    _free()


def _sharded_resnet(mesh):
    """ResNet-18 with axis_name="dp" on the one-rank mesh against
    axis_name=None: one training-mode forward and backward on the same
    weights and images; the logits, every BatchNorm's updated running
    statistics and every gradient."""
    from ray_tpu_torch.models.resnet import ResNet, ResNetConfig
    from ray_tpu_torch.parallel import use_mesh
    cfg = ResNetConfig.resnet18()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    images = torch.randn(SHARDED_RESNET_BATCH, 32, 32, 3, generator=gen,
                         device="cuda")
    labels = torch.randint(0, cfg.num_classes, (SHARDED_RESNET_BATCH,),
                           generator=gen, device="cuda")
    runs = {}
    before = (torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for axis in (None, "dp"):
            model = ResNet(cfg, device="cuda", axis_name=axis,
                           generator=torch.Generator(
                               device="cuda").manual_seed(SEED))
            _zero_all_counts()
            with use_mesh(mesh):
                loss, ms = _sync_time(lambda: _resnet_loss(model, images,
                                                           labels))
                with torch.no_grad():  # through the updated statistics
                    logits = model(images, train=False)
                grads = torch.autograd.grad(loss, list(model.parameters()))
            assert not any(_all_counts().values())
            runs[axis] = (logits, [b.clone() for b in model.buffers()],
                          grads, ms)
            del model
    finally:
        torch.backends.cudnn.deterministic, \
            torch.backends.cudnn.benchmark = before
    (l0, b0, g0, _), (l1, b1, g1, ms) = runs[None], runs["dp"]
    errs = {"eval_logits": _rel_err(l1, l0),
            "running_stats_max": max(_rel_err(a, b)
                                     for a, b in zip(b1, b0)),
            "grads_max": max(_rel_err(a, b) for a, b in zip(g1, g0))}
    assert all(e <= SHARDED_RESNET_REL_TOL for e in errs.values()), errs
    emit({"phase": "sharded", "part": "resnet_cross_replica_bn",
          "config": "ResNetConfig.resnet18(), bf16 convolutions, f32 "
          f"BatchNorm, {SHARDED_RESNET_BATCH} images, axis_name='dp' on a "
          "one-rank NCCL group", "rel_tol": SHARDED_RESNET_REL_TOL,
          "rel_errs_vs_no_axis": errs, "train_forward_s": ms})
    del runs
    _free()


def phase_sharded():
    """The sharding presets, the pipeline and cross-replica BatchNorm on
    the card, on a world-size-1 NCCL mesh (MeshConfig(): every axis of
    one rank): GPT-2 124M at SHARDED_BATCH x SHARDED_SEQ placed under
    TP_RULES and FSDP_RULES and the MoE at SHARDED_MOE_BATCH x
    SHARDED_SEQ under EP_RULES, each against the direct steps (#1, #3 and
    #4 once a layer a step); simulate_pipeline over GPT-2's blocks; and
    ResNet-18 with axis_name="dp".  Returns the launches of the placed
    runs and the pipeline, summed."""
    import torch.distributed as dist
    from ray_tpu_torch.models import gpt2, moe
    from ray_tpu_torch.parallel import MeshConfig, build_mesh
    _nccl_world_of_one()
    total = dict.fromkeys(_all_counts(), 0)
    try:
        mesh = build_mesh(MeshConfig())
        cfg = gpt2.GPT2Config.gpt2_small(max_seq_len=SHARDED_SEQ)
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        tokens = torch.randint(0, cfg.vocab_size,
                               (SHARDED_BATCH, SHARDED_SEQ), generator=gen,
                               device="cuda")
        _sharded_train(
            "gpt2_124m", f"gpt2_small (12 layers, 768 wide, 12 heads, "
            f"bf16 compute, f32 masters), {SHARDED_BATCH} x {SHARDED_SEQ} "
            "tokens, bf16 LM-head logits",
            lambda: gpt2.GPT2(cfg, device="cuda", generator=torch.Generator(
                device="cuda").manual_seed(SEED)),
            lambda m, t: gpt2.loss_fn(m, t,
                                      head_logits_dtype=torch.bfloat16),
            tokens, _flash_per(cfg.num_layers), ("tp", "fsdp"), mesh,
            total)
        mcfg = moe.MoEConfig()
        tokens = torch.randint(0, mcfg.vocab_size,
                               (SHARDED_MOE_BATCH, SHARDED_SEQ),
                               generator=gen, device="cuda")
        _sharded_train(
            "moe", f"MoEConfig() (8 layers, 512 wide, 8 heads of 64, 8 "
            f"experts top-2), {SHARDED_MOE_BATCH} x {SHARDED_SEQ} tokens, "
            "bf16 compute, f32 masters",
            lambda: moe.MoETransformer(mcfg, device="cuda",
                                       generator=torch.Generator(
                                           device="cuda").manual_seed(SEED)),
            moe.loss_fn, tokens, _flash_per(mcfg.num_layers), ("ep",),
            mesh, total)
        _sharded_pipeline(total)
        _sharded_resnet(mesh)
    finally:
        dist.destroy_process_group()
    emit({"phase": "sharded", "ok": True})
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


# rl: PPO's learner on the card.  RL_PARITY holds learn_on_batch on the
# card against the port's own CPU path on one CartPole batch (seed 0,
# RL_PARITY_ENVS envs x RL_PARITY_STEPS steps, sampled on the host), 2 SGD
# iterations over 32-row minibatches, with the CPU tests' limits: each
# parameter's update within RL_UPDATE_TOL of its largest, the stats within
# RL_STATS_RTOL.  RL_SHAPES are bench.py's bench_rllib_ppo shapes (label,
# workers, envs per worker or env actor, mode): CartPole capped at 200
# steps, train_batch_size 4000, sgd_minibatch_size 512, num_sgd_iter 4,
# seed 0, on init(num_cpus=16); one warm-up train(), then train() calls
# until RL_WINDOW_S of wall time has passed (a third of bench.py's 15 s
# windows, so that the whole script keeps inside its time limit), then one
# whose learn_on_batch's first RL_TRACE_UPDATES updates are traced for
# device activity.
RL_PARITY = {"fc": {},
             "lstm": {"use_lstm": True, "max_seq_len": 8},
             "attention": {"use_attention": True, "max_seq_len": 8}}
RL_PARITY_ENVS, RL_PARITY_STEPS = 4, 256
RL_UPDATE_TOL = 1e-3
RL_STATS_RTOL = 1e-5
RL_STATS = ("policy_loss", "vf_loss", "entropy", "kl", "total_loss",
            "grad_gnorm", "kl_coeff", "mean_kl")
RL_SHAPES = (("inline", 0, 8, "legacy"), ("fleet_legacy", 2, 16, "legacy"),
             ("fleet", 2, 256, "pipeline"))
RL_WINDOW_S = {"inline": 5.0, "fleet_legacy": 5.0, "fleet": 5.0}
RL_TRACE_UPDATES = 64
RL_STORE_MIB = 1024


def _rl_batch(model):
    """One CartPole batch from the port's host sampler, advantages
    standardised as PPO's training_step does."""
    from ray_tpu_torch.rllib.algorithms.ppo import PPOPolicy
    from ray_tpu_torch.rllib.env import CartPole
    from ray_tpu_torch.rllib.execution import standardize_advantages
    from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
    worker = RolloutWorker(CartPole, PPOPolicy, {
        "seed": SEED, "_device": "cpu", "model": model,
        "num_envs_per_worker": RL_PARITY_ENVS,
        "rollout_fragment_length": RL_PARITY_STEPS})
    return standardize_advantages(worker.sample())


def _rl_on_card(policy):
    """The learner's parameters and Adam's moments lie on the card."""
    assert policy.device.type == "cuda", policy.device
    state = policy.opt.state_dict()["state"]
    tensors = list(policy.model.parameters()) + [
        t for s in state.values() for t in s.values()
        if isinstance(t, torch.Tensor)]
    assert state and all(t.is_cuda for t in tensors), \
        "the learner's parameters or optimizer state left the card"
    return len(tensors)


def rl_learner_parity(kind, model):
    """learn_on_batch on the card against the CPU on the same weights,
    batch and minibatch order.  The attention's key biases have a zero
    gradient in exact arithmetic (a shift of every key leaves the softmax
    as it is), so Adam scales each device's rounding noise up to steps of
    about lr: their updates are not compared, their gradient on the card
    is held at 1e-6 of the largest instead."""
    import numpy as np
    from ray_tpu_torch.rllib.algorithms.ppo import PPOPolicy
    from ray_tpu_torch.rllib.env import CartPole
    from ray_tpu_torch.rllib.sample_batch import build_sequences
    env = CartPole({})
    batch = _rl_batch(model)
    cfg = {"seed": SEED, "model": model, "num_sgd_iter": 2,
           "sgd_minibatch_size": 32}
    cpu = PPOPolicy(env.observation_space, env.action_space,
                    dict(cfg, _device="cpu"))
    gpu = PPOPolicy(env.observation_space, env.action_space, dict(cfg))
    before = cpu.get_weights()
    for name, w in gpu.get_weights().items():
        assert np.array_equal(w, before[name]), name
    want = cpu.learn_on_batch(batch.copy())
    t0 = time.perf_counter()
    got = gpu.learn_on_batch(batch.copy())
    torch.cuda.synchronize()
    learn_ms = (time.perf_counter() - t0) * 1e3
    tensors = _rl_on_card(gpu)
    cw, gw = cpu.get_weights(), gpu.get_weights()
    noise = {n for n in gw if n.endswith("attn.key.bias")}
    worst = 0.0
    for name in set(gw) - noise:
        upd = cw[name] - before[name]
        scale = float(np.abs(upd).max())
        assert scale > 0, f"rl {kind}: {name} was not updated"
        err = float(np.abs((gw[name] - before[name]) - upd).max()) / scale
        assert err <= RL_UPDATE_TOL, (kind, name, err)
        worst = max(worst, err)
    stats_err = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
                 for k in RL_STATS}
    assert all(e <= RL_STATS_RTOL for e in stats_err.values()), \
        (kind, stats_err)
    zero_grad = None
    if noise:
        seq = build_sequences(batch, model["max_seq_len"])
        seq["kl_coeff"] = np.float32(0.2)
        grads, _ = gpu.compute_gradients(seq)
        names = [n for n, _ in gpu.model.named_parameters()]
        largest = max(float(np.abs(g).max()) for g in grads)
        zero_grad = max(float(np.abs(g).max()) for n, g in
                        zip(names, grads) if n in noise) / largest
        assert zero_grad <= 1e-6, (kind, zero_grad)
    return {"rows": len(batch), "update_err": worst,
            "stats_rel_err": stats_err, "key_bias_grad": zero_grad,
            "tensors_on_card": tensors, "gpu_learn_ms": learn_ms,
            "total_loss": got["total_loss"]}


class _LearnerClock:
    """Wraps a policy's learn_on_batch (synchronised before and after)
    and counts the SGD updates of the calls it times: ``ms`` and
    ``updates`` cover the same calls.  With ``trace`` set, the next call's
    first RL_TRACE_UPDATES updates run under a device-only trace: the
    union of their kernels' intervals over the window's wall time (a
    whole fleet-shape call launches some 60,000 kernels, whose events
    would take the trace longer to read than the call took)."""

    def __init__(self, policy):
        from torch.profiler import ProfilerActivity, profile
        self.ms, self.updates, self.trace = [], 0, False
        self.traced, self._prof, self._n = None, None, 0
        learn, update = policy.learn_on_batch, policy._update

        def timed_learn(batch):
            if self.trace:
                self.trace = False
                self._left = RL_TRACE_UPDATES
                self._prof = profile(activities=[ProfilerActivity.CUDA])
                self._prof.__enter__()
                torch.cuda.synchronize()
                self._t0 = time.perf_counter()
                out = learn(batch)
                if self._prof is not None:
                    self._finish()
                return out
            n0 = self._n
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = learn(batch)
            torch.cuda.synchronize()
            self.ms.append((time.perf_counter() - t0) * 1e3)
            n = len(batch)
            want = int(policy.config.get("num_sgd_iter", 30)) * max(
                1, n // int(policy.config.get("sgd_minibatch_size", 128)))
            assert self._n - n0 == want, (n, self._n - n0, want)
            self.updates += self._n - n0
            return out

        def counted_update(dev):
            self._n += 1
            out = update(dev)
            if self._prof is not None:
                self._left -= 1
                if not self._left:
                    self._finish()
            return out

        policy.learn_on_batch = timed_learn
        policy._update = counted_update

    def _finish(self):
        torch.cuda.synchronize()
        wall = (time.perf_counter() - self._t0) * 1e3
        prof, self._prof = self._prof, None
        prof.__exit__(None, None, None)
        spans = [(ev.time_range.start, ev.time_range.end)
                 for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(ev, "is_user_annotation", False)]
        assert spans, "no kernel in the learner's device-only trace"
        busy = _union_ms(spans)
        self.traced = {"updates": RL_TRACE_UPDATES - self._left,
                       "kernels": len(spans), "busy_ms": busy,
                       "wall_ms": wall, "idle_share": 1 - busy / wall}


def _rl_measure(algo, clock, label):
    """One warm-up train(), then train() calls until RL_WINDOW_S[label]
    has passed, then one whose learn_on_batch's first RL_TRACE_UPDATES
    updates are traced.  Each timed call's env-steps/s too: their range
    is the spread within the window."""
    import numpy as np
    t0 = time.perf_counter()
    algo.train()  # warm-up: workers' first fragments, first shapes
    warm_s = time.perf_counter() - t0
    clock.ms, clock.updates = [], 0
    steps, losses, rates = 0, [], []
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < RL_WINDOW_S[label]:
        t1 = time.perf_counter()
        r = algo.train()
        n = r["num_env_steps_sampled_this_iter"]
        rates.append(n / (time.perf_counter() - t1))
        steps += n
        losses.append(r["total_loss"])
    wall = time.perf_counter() - t0
    iters = len(rates)
    clock.trace, clock.traced = True, None
    r = algo.train()
    losses.append(r["total_loss"])
    assert clock.traced is not None
    assert all(np.isfinite(x) for x in losses), losses
    traced = clock.traced
    per_update = sum(clock.ms) / clock.updates
    return {"warmup_train_s": warm_s, "window_s": wall, "iters": iters,
            "env_steps": steps, "env_steps_per_s": steps / wall,
            "env_steps_per_s_per_train": [min(rates), max(rates)],
            "train_ms": wall * 1e3 / iters,
            "learner_ms_per_train": statistics.mean(clock.ms),
            "learner_ms": clock.ms, "sgd_updates": clock.updates,
            "learner_ms_per_update": per_update,
            "learner_share_of_train": sum(clock.ms) / (wall * 1e3),
            # the traced window's own share (the trace slows the host),
            # and its busy ms per update over an untraced update's ms
            "learner_busy_share_traced": 1 - traced["idle_share"],
            "learner_busy_share": traced["busy_ms"] / traced["updates"]
            / per_update,
            "learner_traced": traced, "total_losses": losses,
            "episode_reward_mean": r["episode_reward_mean"]}


def _rl_shape(label, workers, envs, mode):
    """One of bench_rllib_ppo's shapes, measured by _rl_measure."""
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig
    from ray_tpu_torch.rllib.env import CartPole
    config = (PPOConfig()
              .environment(CartPole, env_config={"max_episode_steps": 200})
              .rollouts(num_rollout_workers=workers,
                        num_envs_per_worker=envs if mode != "pipeline"
                        else 1,
                        rollout_fragment_length=200,
                        sample_async=(mode == "legacy" and workers > 0),
                        decoupled=(mode == "pipeline"),
                        rl_envs_per_actor=envs)
              .training(train_batch_size=4000, sgd_minibatch_size=512,
                        num_sgd_iter=4)
              .debugging(seed=SEED))
    t_shape = t0 = time.perf_counter()
    algo = config.build()
    build_s = time.perf_counter() - t0
    try:
        policy = algo.get_policy()
        clock = _LearnerClock(policy)
        out = {"shape": label, "workers": workers, "envs": envs,
               "mode": mode, "build_s": build_s}
        out.update(_rl_measure(algo, clock, label))
        out["tensors_on_card"] = _rl_on_card(policy)
        if mode == "pipeline":
            stats = algo._pipeline.stats()
            infer = stats["inference"][0]
            out.update(inference_occupancy=infer["mean_occupancy"],
                       inference_batch_shapes=infer["batch_shapes"],
                       inference_dispatches=infer["dispatches"],
                       stale_dropped=stats["stale_dropped"],
                       weights_version=stats["weights_version"])
            out["inference_device"] = rt.get(
                algo._pipeline.inference_actors[0].device.remote(),
                timeout=60)
            assert out["inference_device"] == "cpu", out
    finally:
        algo.stop()
    out["shape_s"] = time.perf_counter() - t_shape
    return out


def phase_rl():
    """PPO with the learner on the card: learn_on_batch for FCNet, LSTM
    and attention against the CPU path, then bench_rllib_ppo's three
    shapes on the port's runtime.  Returns the launches of the port's
    kernels over the shapes' runs (none: RL's models are plain torch)."""
    import ray_tpu_torch as rt
    t0 = time.perf_counter()
    parity = {kind: rl_learner_parity(kind, model)
              for kind, model in RL_PARITY.items()}
    emit({"phase": "rl_parity", "ok": True, "models": parity,
          "seconds": time.perf_counter() - t0,
          "update_tol": RL_UPDATE_TOL, "stats_rtol": RL_STATS_RTOL})
    _zero_all_counts()
    before = _all_counts()
    t0 = time.perf_counter()
    rt.init(num_cpus=16, object_store_memory=RL_STORE_MIB * 2**20)
    init_s = time.perf_counter() - t0
    try:
        shapes = [_rl_shape(*shape) for shape in RL_SHAPES]
    finally:
        t1 = time.perf_counter()
        rt.shutdown()
        shutdown_s = time.perf_counter() - t1
    launches = _delta(before, _all_counts())
    emit({"phase": "rl", "ok": True, "init_s": init_s,
          "shutdown_s": shutdown_s, "shapes": shapes,
          "launches": launches, "card": card_line()})
    return launches


# rl_zoo: the model-free algorithms of ray_tpu_torch.rllib.algorithms with
# their learners on the card.  rl_zoo_parity takes one or two updates
# (RL_ZOO_PARITY's calls) of each policy on the card against the CPU on
# the same weights (each tensor plus normal noise of std 0.05, the target
# networks with their own noise), batch (numpy, from SEED, at the tuned
# examples' sizes), update noise (drawn once on the host) and Adam
# moments, warmed on both devices to count RL_ZOO_WARM_COUNT, mu 0 and nu
# RL_ZOO_WARM_NU: a cold Adam's first step is lr * sign(g), so an element
# whose gradient cancels to rounding level (some of the 256-wide critics'
# 130,000 weights do) steps by +lr on one device and -lr on the other;
# from these moments a small gradient makes a small step on both.  The
# squashed actors' log_std bias is lowered by 2 on both, which keeps tanh
# out of saturation, where log(1 - tanh^2 + 1e-6) turns a last-ulp
# difference of tanh into a different loss.  Each tensor's move is held
# within RL_UPDATE_TOL of its largest element's, the stats within
# RL_STATS_RTOL of their magnitude or of 1, whichever is larger.  Then
# each state crosses devices: the card's restored on the CPU and the
# CPU's on the card, exactly.
# RL_ZOO_EXAMPLES: each ported algorithm's tuned-example yaml on
# init(num_cpus=16), learner on the card: train() until the learner has
# taken its first update (the replay learners first fill to their start),
# then train() calls for RL_ZOO_WINDOW_S of wall time; RL_ZOO_CRITERION's
# yamls then go on training to their stop criterion (iterations counted
# from the first); last, the last update's call runs RL_ZOO_TRACE_UPDATES
# times more under a device-only trace.
RL_ZOO_WARM_COUNT, RL_ZOO_WARM_NU = 20, 1e-4
RL_ZOO_NOISE_STD = 0.05
# short, so that the whole script ends well inside its 1200 s limit
RL_ZOO_WINDOW_S = 1.0
RL_ZOO_MAX_WARMUP = 300
RL_ZOO_TRACE_UPDATES = 16
# the meta, model-based and search learners' parity also holds every
# parameter's Adam moments within RL_UPDATE_TOL of their largest; a
# tensor whose largest move is below RL_ZOO_RESOLUTION ulps of its
# largest weight (a move read from the f32 weights resolves only an ulp:
# DT's LayerNorm scales move by 2-3 ulps, its torso's by about 800) is
# held by those moments alone
RL_ZOO_RESOLUTION = 2 / RL_UPDATE_TOL
# the attention's key biases have a zero gradient in exact arithmetic (the
# softmax cancels q . b), so Adam scales each device's rounding up to a
# step: their first moment is held below RL_ZOO_ROUNDING of their module's
# largest on both devices instead (the CPU tests' rule)
RL_ZOO_ZERO_GRAD = ("attn.key.bias",)
RL_ZOO_ROUNDING = 1e-6
RL_ZOO_EXAMPLES = (
    "cartpole-impala", "cartpole-appo", "cartpole-pg", "cartpole-a2c",
    "cartpole-a3c", "cartpole-marwil", "cartpole-bc", "cartpole-dqn",
    "cartpole-simpleq", "cartpole-apex-dqn", "cartpole-r2d2",
    "pendulum-sac", "pendulum-ddpg", "pendulum-td3", "pendulum-apex-ddpg",
    "pendulum-cql", "pendulum-crr", "cartpole-es", "cartpole-ars",
    "bandit-linucb", "bandit-lints", "rps-alphastar", "cartpole-mass-maml",
    "cartpole-mass-mbmpo", "cartpole-dt", "catch-alphazero",
    "simple-rec-slateq", "target-chase-maddpg", "two-step-qmix",
    "pixelcatch-dreamer", "cartpole-ddppo")
RL_ZOO_CRITERION = ("cartpole-impala", "cartpole-appo",
                    "cartpole-mass-mbmpo", "cartpole-dt",
                    "pixelcatch-dreamer", "two-step-qmix", "cartpole-ddppo")
# examples whose learners are remote workers (DD-PPO's ranks, each on a
# share of the card), which the driver's _UpdateClock cannot see:
# rl_zoo_gang runs them
RL_ZOO_GANG = ("cartpole-ddppo",)
# DD-PPO: minibatch steps (gradient, allreduce, apply) timed inside each rank
RL_DDPPO_TIMED = 20
# examples whose learner is host numpy: ES/ARS (the policy acts on the
# card, the search is numpy) and the bandits (no device code)
RL_ZOO_HOST_LEARNERS = ("cartpole-es", "cartpole-ars", "bandit-linucb",
                        "bandit-lints")
#: pixelcatch-dreamer.yaml's sizes
RL_DREAMER_CFG = {"batch_size": 8, "batch_length": 10, "imagine_horizon": 5}
# label: (module, policy class, env, config, batch kind, rows, calls)
RL_ZOO_PARITY = {
    "impala": ("impala", "ImpalaPolicy", "CartPole",
               {"rollout_fragment_length": 64}, "unrolls", 8 * 64, 2),
    "appo": ("impala", "APPOPolicy", "CartPole",
             {"rollout_fragment_length": 64}, "unrolls", 8 * 64, 2),
    "pg": ("pg", "PGPolicy", "CartPole", {}, "onpolicy", 400, 2),
    "a2c": ("pg", "A2CPolicy", "CartPole", {}, "onpolicy", 200, 2),
    "marwil": ("marwil", "MARWILPolicy", "CartPole", {"beta": 1.0},
               "offline", 1000, 2),
    "bc": ("marwil", "MARWILPolicy", "CartPole", {"beta": 0.0},
           "offline", 1000, 2),
    "dqn": ("dqn", "DQNPolicy", "CartPole", {"double_q": True},
            "transitions", 64, 2),
    "simple_q": ("dqn", "DQNPolicy", "CartPole", {"double_q": False},
                 "transitions", 64, 2),
    "r2d2": ("r2d2", "R2D2Policy", "RepeatPrevEnv",
             {"model": {"use_lstm": True, "lstm_cell_size": 32,
                        "max_seq_len": 20, "fcnet_hiddens": [32]}},
             "sequences", 32, 2),
    "sac": ("sac", "SACPolicy", "Pendulum", {}, "continuous", 256, 2),
    "ddpg": ("ddpg", "DDPGPolicy", "Pendulum", {}, "continuous", 256, 2),
    "td3": ("ddpg", "DDPGPolicy", "Pendulum",
            {"twin_q": True, "policy_delay": 2,
             "smooth_target_policy": True}, "continuous", 256, 2),
    "cql": ("cql", "CQLPolicy", "Pendulum", {"cql_n_actions": 2},
            "continuous", 64, 2),
    "crr": ("crr", "CRRPolicy", "Pendulum", {}, "continuous", 64, 2),
    # the meta, model-based and search learners (their yamls' sizes):
    # MAML's meta-update on 2 tasks of 200 rows; MBMPO's ensemble step
    # (K = 2 members, 256-row bootstrap minibatches of 400 rows) and its
    # meta-step (16 imagined envs, horizon 16; entropy_coeff 0.1, since
    # the imagined ratio's logp is not detached and a discrete policy's
    # own tensors learn only through the entropy); DT's update on 64
    # windows of 20; AlphaZero's on 128 boards of 6 x 6; SlateQ's on 64
    # transitions
    "maml": ("maml", "MAMLPolicy", "CartPoleMass",
             {"inner_lr": 0.05, "entropy_coeff": 0.01}, "meta", 200, 2),
    "mbmpo_models": ("mbmpo", "MBMPOPolicy", "CartPoleMass",
                     {"ensemble_size": 2}, "models", 400, 2),
    "mbmpo_meta": ("mbmpo", "MBMPOPolicy", "CartPoleMass",
                   {"ensemble_size": 2, "horizon": 16,
                    "entropy_coeff": 0.1}, "imagined", 16, 2),
    "dt": ("dt", "DTLearner", "CartPole", {}, "dt", 64, 2),
    "alpha_zero": ("alpha_zero", "AlphaZeroLearner", "PixelCatch", {},
                   "search", 128, 2),
    "slateq": ("slateq", "SlateQLearner", "SimpleRecEnv", {}, "slates", 64,
               2),
    # the multi-agent and world-model learners (their yamls' sizes):
    # MADDPG's update on 64 transitions of 2 agents; QMIX's recurrent
    # update on 32 TwoStepGame episodes; Dreamer's world-model update on 8
    # sequences of 10 8x8 frames (masked tails) and its behavior update,
    # imagining 5 steps from those 80 states
    "maddpg": ("maddpg", "MADDPGLearner", "SimpleTargetChase", {},
               "multiagent", 64, 2),
    "qmix": ("qmix", "QMixLearner", "TwoStepGame", {}, "episodes", 32, 2),
    "dreamer_wm": ("dreamer", "DreamerLearner", "PixelCatch",
                   RL_DREAMER_CFG, "world_model", 8, 2),
    "dreamer_behavior": ("dreamer", "DreamerLearner", "PixelCatch",
                         RL_DREAMER_CFG, "behavior", 8, 2),
}
#: the env configs of RL_ZOO_PARITY's learners where not the default
RL_ZOO_ENV_CONFIG = {"alpha_zero": {"height": 6, "width": 6},
                     "dreamer_wm": {"height": 8, "width": 8},
                     "dreamer_behavior": {"height": 8, "width": 8}}


def _zoo_batch(kind, n, obs_dim, act_space, rng):
    """A batch of ``kind`` with ``n`` rows (``n`` sequences of 20 for
    "sequences"), from numpy's generator ``rng``."""
    import numpy as np

    def obs(*shape):
        return rng.standard_normal(shape + (obs_dim,)).astype(np.float32)

    term = rng.random(n) < 0.05
    if kind == "sequences":
        S, L = n, 20
        lens = rng.integers(5, L + 1, S)
        mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
        ends = np.zeros((S, L), bool)
        ends[np.arange(S), lens - 1] = rng.random(S) < 0.5
        return {"obs": obs(S, L) * mask[..., None],
                "actions": rng.integers(0, 2, (S, L)) * mask.astype(int),
                "rewards": rng.random((S, L)).astype(np.float32) * mask,
                "terminateds": ends, "seq_mask": mask,
                "state_in_c": rng.standard_normal((S, 32)).astype(
                    np.float32),
                "state_in_h": np.tanh(rng.standard_normal((S, 32))).astype(
                    np.float32)}
    if kind == "continuous":
        high = float(act_space.high)
        return {"obs": obs(n), "new_obs": obs(n),
                "actions": rng.uniform(-0.95 * high, 0.95 * high,
                                       (n,) + act_space.shape).astype(
                    np.float32),
                "rewards": rng.standard_normal(n).astype(np.float32),
                "terminateds": term,
                "weights": rng.uniform(0.2, 1.0, n).astype(np.float32)}
    out = {"obs": obs(n), "new_obs": obs(n),
           "actions": rng.integers(0, act_space.n, n),
           "rewards": rng.random(n).astype(np.float32),
           "terminateds": term,
           "truncateds": ~term & (rng.random(n) < 0.05),
           "action_logp": (np.log(0.5) + 0.3 * rng.standard_normal(n)
                           ).astype(np.float32),
           "advantages": rng.standard_normal(n).astype(np.float32),
           "value_targets": rng.standard_normal(n).astype(np.float32),
           "eps_id": np.cumsum(rng.random(n) < 0.02)}
    if kind == "transitions":
        out["rewards"] = 3 * out["rewards"]  # |td| on both Huber sides
    return out


def _zoo_learner_batch(kind, n, env, rng):
    """A batch for one of the meta, model-based or search learners:
    numpy columns (``"meta"``: pre and post columns of 2 tasks,
    ``"models"``: replay rows, ``"imagined"``: the imagined envs' start
    states), from numpy's generator ``rng``."""
    import numpy as np
    if kind == "meta":
        def columns():
            return {"obs": rng.standard_normal((2, n, 4)).astype(
                        np.float32),
                    "actions": rng.integers(0, 2, (2, n)),
                    "action_logp": (np.log(0.5) + 0.2 * rng.standard_normal(
                        (2, n))).astype(np.float32),
                    "advantages": (3 * rng.standard_normal((2, n)) + 1
                                   ).astype(np.float32),
                    "value_targets": rng.standard_normal((2, n)).astype(
                        np.float32)}
        return {"pre": columns(), "post": columns()}
    if kind == "models":
        obs = rng.standard_normal((n, 4)).astype(np.float32)
        return {"obs": obs, "act": rng.integers(0, 2, n),
                "nobs": (obs + 0.05 * rng.standard_normal(obs.shape)
                         ).astype(np.float32),
                "rew": np.ones(n, np.float32)}
    if kind == "imagined":
        return {"obs0": 0.1 * rng.standard_normal((n, 4)).astype(
            np.float32)}
    if kind == "dt":
        K = 20
        lens = rng.integers(1, K + 1, n)
        mask = (np.arange(K)[None] < lens[:, None]).astype(np.float32)
        act = rng.integers(0, 2, (n, K)) * mask.astype(np.int64)
        prev = np.full((n, K), -1, np.int64)
        prev[:, 1:] = np.where(mask[:, 1:] > 0, act[:, :-1], -1)
        return {"obs": rng.standard_normal((n, K, 4)).astype(np.float32)
                * mask[..., None], "act": act, "prev_act": prev,
                "rtg": (rng.uniform(0, 100, (n, K, 1)) * mask[..., None]
                        ).astype(np.float32), "mask": mask}
    if kind == "multiagent":  # n transitions of SimpleTargetChase's agents
        a = len(env.agent_ids)
        return {"obs": rng.uniform(-1, 1, (n, a, 2)).astype(np.float32),
                "actions": rng.uniform(-0.9, 0.9, (n, a, 1)).astype(
                    np.float32),
                "rewards": rng.standard_normal((n, a)).astype(np.float32),
                "next_obs": rng.uniform(-1, 1, (n, a, 2)).astype(np.float32),
                "dones": (rng.random(n) < 0.1).astype(np.float32)}
    if kind == "episodes":  # n padded two-step episodes (QMIX's replay)
        a, d, st = len(env.agent_ids), 4 + len(env.agent_ids), 3
        dones = np.zeros((n, 2), np.float32)
        dones[:, -1] = 1.0
        return {"obs_seq": rng.random((n, 3, a, d)).astype(np.float32),
                "state_seq": rng.random((n, 3, st)).astype(np.float32),
                "actions": rng.integers(0, 2, (n, 2, a)),
                "rewards": rng.uniform(0, 8, (n, 2)).astype(np.float32),
                "dones": dones, "mask": np.ones((n, 2), np.float32)}
    if kind in ("world_model", "behavior"):  # n sequences, masked tails
        T = RL_DREAMER_CFG["batch_length"]
        lens = rng.integers(4, T + 1, n)
        mask = (np.arange(T)[None] < lens[:, None]).astype(np.float32)
        if kind == "behavior":  # posterior states to imagine from
            return {"deter": np.tanh(rng.standard_normal((n, T, 64))).astype(
                        np.float32),
                    "stoch": rng.standard_normal((n, T, 16)).astype(
                        np.float32), "mask": mask}
        obs = np.zeros((n, T, 64), np.float32)  # ball and paddle pixels
        for _ in range(2):
            obs[np.arange(n)[:, None], np.arange(T)[None],
                rng.integers(0, 64, (n, T))] = 1.0
        act = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (n, T))]
        act[:, 0] = 0.0
        return {"obs": obs * mask[..., None], "actions_onehot": act,
                "rewards": (rng.choice([-0.1, 0.1], (n, T)) * mask).astype(
                    np.float32),
                "dones": (np.arange(T)[None] == lens[:, None] - 1).astype(
                    np.float32), "mask": mask}
    if kind == "search":
        return {"obs": (rng.random((n, 36)) < 0.1).astype(np.float32),
                "pi": rng.dirichlet(np.ones(3), n).astype(np.float32),
                "z": rng.uniform(-1, 1, n).astype(np.float32)}
    assert kind == "slates", kind
    t, d = env.topic_dim, env.num_docs

    def unit(*shape):
        v = rng.standard_normal(shape + (t,))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)
    click = (rng.random(n) < 0.6).astype(np.float32)
    return {"state": unit(n), "clicked_doc": unit(n) * click[:, None],
            "click_mask": click,
            "reward": (rng.random(n) * click).astype(np.float32),
            "next_state": unit(n), "next_docs": unit(n, d),
            "done": (rng.random(n) < 0.05).astype(np.float32)}


def _zoo_build(cls, env, cfg, device):
    """A policy of RL_ZOO_PARITY on ``device`` ("cpu", or None for the
    card): a TorchPolicy subclass from the env's spaces, a learner from
    the sizes its algorithm gives it."""
    import numpy as np
    name = cls.__name__
    if name == "DTLearner":
        return cls(env.action_space.n,
                   int(np.prod(env.observation_space.shape)), cfg, device)
    if name == "AlphaZeroLearner":
        return cls(int(np.prod(env.observation_space.shape)),
                   env.action_space.n, cfg, device)
    if name == "SlateQLearner":
        return cls(env.topic_dim, env.slate_size, cfg, device)
    if name == "MADDPGLearner":
        first = env.agent_ids[0]
        return cls(len(env.agent_ids),
                   int(np.prod(env.observation_space_for(first).shape)),
                   int(np.prod(env.action_space_for(first).shape)), cfg,
                   device)
    if name == "QMixLearner":
        first, n = env.agent_ids[0], len(env.agent_ids)
        return cls(n, int(np.prod(env.observation_space_for(first).shape))
                   + n, len(env.global_state()),
                   env.action_space_for(first).n, cfg, device)
    if name == "DreamerLearner":
        shape = tuple(env.observation_space.shape)
        return cls(int(np.prod(shape)), env.action_space.n, shape, cfg,
                   device)
    spaces = (env.observation_space, env.action_space)
    return cls(*spaces, dict(cfg, _device=device) if device else dict(cfg))


def _zoo_learner_step(policy, kind, batch, draws):
    """One update of a meta, model-based or search learner on ``batch``
    (numpy) with ``draws`` (host tensors: MBMPO's bootstrap indices or
    action noise); its stats as floats."""
    dev = policy.device
    t = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    if kind == "meta":
        return {"meta_loss": float(policy.meta_update(batch["pre"],
                                                      batch["post"]))}
    if kind == "models":
        loss = policy._train_models(
            t(batch["obs"]), t(batch["act"]), t(batch["nobs"]),
            t(batch["rew"]), draws["idx"].to(dev))
        return {"model_loss": float(loss)}
    if kind == "imagined":
        loss, rew = policy._meta_step(
            t(batch["obs0"]), {k: v.to(dev) for k, v in draws.items()})
        return {"meta_loss": float(loss), "imagined_reward_mean": float(rew)}
    if kind == "world_model":
        out = policy._wm_update(policy.tensors(batch),
                                {k: v.to(dev) for k, v in draws.items()})
        return {k: float(v) for k, v in zip(
            ("world_model_loss", "recon_loss", "reward_loss", "kl_loss"),
            out)}
    if kind == "behavior":
        out = policy._behavior_update(
            t(batch["deter"]), t(batch["stoch"]), t(batch["mask"]),
            {k: v.to(dev) for k, v in draws.items()})
        return {"actor_loss": float(out[0]), "critic_loss": float(out[1])}
    out = policy.update(batch)
    names = {"dt": ("loss",), "search": ("policy_loss", "value_loss"),
             "slates": ("loss", "td_error_abs"),
             "multiagent": ("critic_loss", "actor_loss"),
             "episodes": ("loss", "td_error_abs")}[kind]
    out = out if isinstance(out, tuple) else (out,)
    return {k: float(v) for k, v in zip(names, out)}


#: RL_ZOO_PARITY's batch kinds of the meta, model-based and search
#: learners
_ZOO_LEARNER_KINDS = ("meta", "models", "imagined", "dt", "search",
                      "slates", "multiagent", "episodes", "world_model",
                      "behavior")


def _zoo_modules(policy):
    """Every network of a policy by name: the model and its target, or
    the actor, critic and their targets."""
    return {name: getattr(policy, name) for name in
            ("model", "target_model", "actor", "critic", "target_actor",
             "target_critic", "dyn", "nets", "target", "wm")
            if hasattr(policy, name)}


def _zoo_opts(policy):
    return [getattr(policy, name) for name in
            ("opt", "actor_opt", "critic_opt", "alpha_opt", "dyn_opt",
             "wm_opt") if hasattr(policy, name)]


def _zoo_flat(policy):
    """Every parameter and log_alpha, on the host, by name."""
    out = {f"{m}.{k}": v.detach().cpu().numpy().copy()
           for m, module in _zoo_modules(policy).items()
           for k, v in module.state_dict().items()}
    if hasattr(policy, "log_alpha"):
        out["log_alpha"] = policy.log_alpha.detach().cpu().numpy().copy()
    return out


def _zoo_prepare(cpu, gpu, seed):
    """The same perturbed weights, lowered log_std bias and warmed Adam
    moments on both policies."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, module in _zoo_modules(cpu).items():
            target = _zoo_modules(gpu)[name]
            for p, q in zip(module.parameters(), target.parameters()):
                noise = RL_ZOO_NOISE_STD * torch.randn(p.shape,
                                                       generator=gen)
                p.add_(noise)
                q.add_(noise.to(q.device))
        for policy in (cpu, gpu):
            if hasattr(getattr(policy, "actor", None), "log_std"):
                policy.actor.log_std.bias.sub_(2.0)
    for policy in (cpu, gpu):
        for opt in _zoo_opts(policy):
            for group in opt.param_groups:
                for p in group["params"]:
                    opt.state[p] = {
                        "count": RL_ZOO_WARM_COUNT,
                        "mu": torch.zeros_like(p),
                        "nu": torch.full_like(p, RL_ZOO_WARM_NU)}


def _zoo_on_card(policy):
    """Every network, log_alpha and Adam moment of ``policy`` lies on the
    card; returns how many tensors that is."""
    assert policy.device.type == "cuda", policy.device
    tensors = [t for m in _zoo_modules(policy).values()
               for t in m.state_dict().values()]
    if hasattr(policy, "log_alpha"):
        tensors.append(policy.log_alpha)
    states = [opt.state_dict()["state"] for opt in _zoo_opts(policy)]
    assert any(states), "no optimizer has moments"  # (CRR's alpha: none)
    tensors += [t for state in states for s in state.values()
                for t in s.values() if isinstance(t, torch.Tensor)]
    assert all(t.is_cuda for t in tensors), \
        "a network, log_alpha or an Adam moment left the card"
    return len(tensors)


def _zoo_moment_err(cpu, gpu):
    """Each parameter's Adam moments (mu and nu) on the card against the
    CPU's: the largest difference over the CPU's largest element, the
    worse of the two, by the parameter's ``_zoo_flat`` name.  A
    RL_ZOO_ZERO_GRAD tensor's entry is instead its largest first moment
    on either device over the largest first moment of its module on the
    CPU (rounding, held below RL_ZOO_ROUNDING)."""
    import numpy as np
    err = {}
    for m, module in _zoo_modules(cpu).items():
        gmod = _zoo_modules(gpu)[m]
        copt = {id(p): o for o in _zoo_opts(cpu)
                for g in o.param_groups for p in g["params"]}
        gopt = {id(p): o for o in _zoo_opts(gpu)
                for g in o.param_groups for p in g["params"]}
        for (name, p), q in zip(module.named_parameters(),
                                gmod.parameters()):
            if id(p) not in copt:  # a target network: no moments
                continue
            if name.endswith(RL_ZOO_ZERO_GRAD):
                top = max(float(copt[id(x)].state[x]["mu"].abs().max())
                          for x in module.parameters() if id(x) in copt)
                mu = max(float(copt[id(p)].state[p]["mu"].abs().max()),
                         float(gopt[id(q)].state[q]["mu"].abs().max()))
                err[f"{m}.{name}"] = mu / top
                continue
            worst = 0.0
            for key in ("mu", "nu"):
                c = copt[id(p)].state[p][key].detach().cpu().numpy()
                g = gopt[id(q)].state[q][key].detach().cpu().numpy()
                scale = float(np.abs(c).max())
                if scale == 0.0:
                    assert np.array_equal(g, c), (m, name, key)
                    continue
                worst = max(worst, float(np.abs(g - c).max()) / scale)
            err[f"{m}.{name}"] = worst
    return err


def _same_tree(a, b, path=""):
    import numpy as np
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same_tree(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        assert np.array_equal(a, b), path
    else:
        assert a == b, path


def rl_zoo_parity(label):
    """RL_ZOO_PARITY[label]'s policy on the card against the CPU."""
    import importlib
    import numpy as np
    from ray_tpu_torch.rllib import env as envs
    from ray_tpu_torch.rllib.sample_batch import SampleBatch
    module, cls_name, env_name, cfg, kind, rows, calls = \
        RL_ZOO_PARITY[label]
    mod = importlib.import_module(
        f"ray_tpu_torch.rllib.algorithms.{module}")
    cls = getattr(mod, cls_name)
    env_cls = getattr(envs, env_name, None) or getattr(mod, env_name)
    env = env_cls(dict(RL_ZOO_ENV_CONFIG.get(label, {})))
    cfg = {"seed": SEED, **cfg}
    cpu = _zoo_build(cls, env, cfg, "cpu")
    gpu = _zoo_build(cls, env, cfg, None)
    _zoo_prepare(cpu, gpu, SEED + 1)
    before = _zoo_flat(cpu)
    _same_tree(before, _zoo_flat(gpu))
    learner = kind in _ZOO_LEARNER_KINDS
    if learner:
        batch = _zoo_learner_batch(kind, rows, env,
                                   np.random.default_rng(SEED))
    else:
        batch = _zoo_batch(kind, rows, env.observation_space.shape[0],
                           env.action_space, np.random.default_rng(SEED))
    learn = "learn_on_sequences" if kind == "sequences" else \
        "learn_on_batch"
    ms = []
    for _ in range(calls):
        if learner:
            # the draws of MBMPO and Dreamer, once on the host (the CPU
            # policy's)
            draws = ({"models": lambda: cpu._update_noise("models", rows),
                      "imagined": lambda: cpu._update_noise("meta", rows),
                      "world_model": lambda: cpu._draws(
                          "observe", rows, cfg["batch_length"]),
                      "behavior": lambda: cpu._draws(
                          "imagine", rows * cfg["batch_length"],
                          cfg["imagine_horizon"])}
                     .get(kind, dict)())
            want = _zoo_learner_step(cpu, kind, batch, draws)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got = _zoo_learner_step(gpu, kind, batch, draws)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            continue
        if hasattr(cpu, "_update_noise"):  # drawn once, on the host
            noise = cpu._update_noise(rows)
            cpu._update_noise = lambda b, n=noise: {
                k: v.clone() for k, v in n.items()}
            gpu._update_noise = lambda b, n=noise: {
                k: v.to("cuda") for k, v in n.items()}
        want = getattr(cpu, learn)(
            SampleBatch(batch) if learn == "learn_on_batch" else batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = getattr(gpu, learn)(
            SampleBatch(batch) if learn == "learn_on_batch" else batch)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    cw, gw = _zoo_flat(cpu), _zoo_flat(gpu)
    update_err, by_moments = {}, []
    moment_err = _zoo_moment_err(cpu, gpu) if learner else {}
    for name, b in before.items():
        upd = cw[name] - b
        scale = float(np.abs(upd).max())
        if scale == 0.0:  # a tensor the CPU left as it was
            assert np.array_equal(gw[name], b), (label, name)
            update_err[name] = 0.0
            continue
        if name.endswith(RL_ZOO_ZERO_GRAD) and name in moment_err:
            update_err[name] = None  # held as rounding, below
            continue
        if learner and name in moment_err and scale < RL_ZOO_RESOLUTION \
                * float(np.spacing(np.abs(b).max().astype(np.float32))):
            # a move of a few ulps of the weights: held by the Adam
            # moments that made it
            update_err[name] = moment_err[name]
            by_moments.append(name)
            continue
        update_err[name] = float(np.abs((gw[name] - b) - upd).max()) / scale
    moved = sum(1 for n in before if not np.array_equal(cw[n], before[n]))
    td = {}
    if "_td_error_np" in want:
        w, g = want.pop("_td_error_np"), got.pop("_td_error_np")
        td["td_error_err"] = float(np.abs(g - w).max() / np.abs(w).max())
    stats_err = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1e-30)
                 for k in want}
    # a stat below 1 in magnitude is held absolutely: a mean of terms
    # that cancel (CRR's mean advantage) loses relative digits to the
    # cancellation, not to the device
    held = {k: abs(got[k] - want[k]) / max(abs(want[k]), 1.0)
            for k in want}
    failed = [f"update {n}" for n, e in update_err.items()
              if e is not None and e > RL_UPDATE_TOL] + [
        f"stat {k}" for k, e in held.items() if e > RL_STATS_RTOL]
    failed += [f"moments {n}" for n, e in moment_err.items()
               if e > (RL_ZOO_ROUNDING if n.endswith(RL_ZOO_ZERO_GRAD)
                       else RL_UPDATE_TOL)]
    failed += [k for k, e in td.items() if e > RL_STATS_RTOL]
    failed += [] if moved else ["nothing moved"]
    tensors = _zoo_on_card(gpu)
    # each state crosses devices: the card's restored on the CPU, the
    # CPU's on the card, exactly
    other = dict(cfg, seed=SEED + 7)
    cpu2 = _zoo_build(cls, env, other, "cpu")
    cpu2.set_state(gpu.get_state())
    _same_tree(cpu2.get_state(), gpu.get_state())
    gpu2 = _zoo_build(cls, env, other, None)
    gpu2.set_state(cpu.get_state())
    _same_tree(gpu2.get_state(), cpu.get_state())
    _zoo_on_card(gpu2)
    return {"ok": not failed, "failed": failed, "policy": cls_name,
            "config": cfg, "rows": rows, "calls": calls,
            "update_err": update_err,
            "worst_update_err": max(e for e in update_err.values()
                                    if e is not None),
            "moment_err": moment_err, "held_by_moments": by_moments,
            "tensors_moved": moved, "stats": got, "stats_rel_err": stats_err,
            "stats_held_err": held, **td, "tensors_on_card": tensors,
            "gpu_learn_ms": ms}


#: a policy's or learner's methods that each take one learner update:
#: ``learn_on_batch``, R2D2's ``learn_on_sequences``, A3C's
#: ``apply_gradients``, MAML's ``meta_update``, MBMPO's ``train_models``
#: (the ensemble) and ``meta_step``, the DT, AlphaZero, SlateQ, MADDPG
#: and QMIX learners' ``update``, Dreamer's ``wm_update`` and
#: ``behavior_update``
UPDATE_METHODS = ("learn_on_batch", "learn_on_sequences", "apply_gradients",
                  "meta_update", "train_models", "meta_step", "update",
                  "wm_update", "behavior_update")


class _UpdateClock:
    """Times each learner update of a policy (synchronised before and
    after), every UPDATE_METHODS call one, in ``ms`` and by method in
    ``by_method``.  :meth:`trace` runs the last update's call again under
    a device-only trace."""

    def __init__(self, policy, methods=UPDATE_METHODS):
        self.ms, self.last, self.by_method = [], None, {}
        for name in methods:
            if hasattr(policy, name):
                setattr(policy, name,
                        self._timed(name, getattr(policy, name)))

    def _timed(self, name, fn):
        def timed(*args):
            self.last, self.last_method = (fn, args), name
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            self.ms.append(ms)
            self.by_method.setdefault(name, []).append(ms)
            return out
        return timed

    def summary(self):
        """Per method: calls, mean ms and range."""
        return {name: {"calls": len(ms), "ms_mean": statistics.mean(ms),
                       "ms_range": [min(ms), max(ms)]}
                for name, ms in self.by_method.items()}

    def trace(self, n):
        """The last update's call ``n`` times more (on the same inputs,
        after the measurement) under a device-only trace: its kernels'
        busy ms (the union of their intervals) per update."""
        from torch.profiler import ProfilerActivity, profile
        fn, args = self.last
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                torch.cuda.synchronize()
                fn(*args)
                torch.cuda.synchronize()
        spans = [(ev.time_range.start, ev.time_range.end)
                 for ev in prof.events()
                 if ev.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(ev, "is_user_annotation", False)]
        assert spans, "no kernel in the learner's device-only trace"
        return {"updates": n, "kernels_per_update": len(spans) / n,
                "busy_ms_per_update": _union_ms(spans) / n}


def _loss_values(result):
    return {k: v for k, v in result.items()
            if "loss" in k and isinstance(v, float)}


def rl_zoo_example(name):
    """A tuned example's yaml, its learner on the card: train() until the
    first update, then RL_ZOO_WINDOW_S of train() calls, then (for
    RL_ZOO_CRITERION's yamls) on to the yaml's stop criterion, then the
    last update traced.  ``criterion_met_at``: the first iteration whose
    result met the yaml's criterion, if one did."""
    import numpy as np
    from ray_tpu_torch.rllib import tuned_examples
    path = os.path.join(os.path.dirname(tuned_examples.__file__),
                        name + ".yaml")
    t_all = t0 = time.perf_counter()
    algo, spec = tuned_examples.load(path)
    build_s = time.perf_counter() - t0
    stop, first, met = spec.get("stop") or {}, {}, []

    def train():
        r = algo.train()
        if not first:
            first.update(r)
        if not met and tuned_examples._criteria_met(stop, r, first):
            met.append(algo.iteration)
        return r

    host = name in RL_ZOO_HOST_LEARNERS
    try:
        policy = algo.get_policy()
        clock = _UpdateClock(policy)
        # AlphaZero's leaf evaluations (one forward and one copy to the
        # host a simulation) and Dreamer's acting steps (one posterior
        # filter step and actor sample a step, then the action's copy)
        infer = _UpdateClock(policy, ("infer", "policy_step"))
        t0 = time.perf_counter()
        while not (clock.ms or host and algo.iteration):
            train()
            assert algo.iteration <= RL_ZOO_MAX_WARMUP, (name, "no update")
        warm_s = time.perf_counter() - t0
        warm = algo.iteration
        clock.ms, clock.by_method, infer.ms = [], {}, []
        sims0 = getattr(algo, "simulations", 0)
        steps0, rates, losses, trains = algo._timesteps_total, [], [], 0
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < RL_ZOO_WINDOW_S:
            t1, n0 = time.perf_counter(), algo._timesteps_total
            r = train()
            rates.append((algo._timesteps_total - n0)
                         / (time.perf_counter() - t1))
            losses.append(_loss_values(r))
            trains += 1
        wall = time.perf_counter() - t0
        assert all(np.isfinite(v) for d in losses for v in d.values()), \
            (name, losses)
        offline = bool(spec.get("offline_input"))
        out = {"example": name, "algo": spec["run"], "build_s": build_s,
               "warmup_trains": warm, "warmup_s": warm_s,
               "window_s": wall, "trains": trains,
               ("rows_per_s" if offline else "env_steps_per_s"):
                   (algo._timesteps_total - steps0) / wall,
               ("rows_per_s_per_train" if offline
                else "env_steps_per_s_per_train"): [min(rates),
                                                    max(rates)],
               "last_losses": losses[-1], "host_learner": host}
        if host:
            # ES/ARS report no loss; the bandits' update is numpy
            out["episode_reward_mean"] = r["episode_reward_mean"]
            out["policy_device"] = str(policy.device)
            if name.startswith("cartpole-"):  # ES/ARS act on the card
                assert policy.device.type == "cuda", policy.device
        else:
            assert clock.ms and all(losses), (name, losses)
            ms = list(clock.ms)
            out.update({
                "updates": len(ms), "updates_per_train": len(ms) / trains,
                "learner_ms_per_update": statistics.mean(ms),
                "learner_ms_range": [min(ms), max(ms)],
                "learner_share_of_train": sum(ms) / (wall * 1e3),
                "by_method": clock.summary()})
        if infer.ms and hasattr(algo, "simulations"):
            sims = algo.simulations - sims0
            out["simulations"] = sims
            out["ms_per_simulation"] = wall * 1e3 / sims
        if infer.ms:
            out["infer"] = {"calls": len(infer.ms),
                            "ms_mean": statistics.mean(infer.ms),
                            "ms_range": [min(infer.ms), max(infer.ms)],
                            "share_of_window": sum(infer.ms) / (wall * 1e3)}
        if name in RL_ZOO_CRITERION:
            t0 = time.perf_counter()
            budget = int(stop.get("training_iteration", 50))
            while not met and algo.iteration < budget:
                r = train()
            out["criterion"] = {
                "passed": bool(met), "iterations": met[0] if met else None,
                "budget": budget, "iterations_run": algo.iteration,
                "episode_reward_mean": r["episode_reward_mean"],
                "seconds_after_window": time.perf_counter() - t0}
            assert met, (name, out["criterion"])
        out["criterion_met_at"] = met[0] if met else None
        if not host:
            out["traced"] = clock.trace(RL_ZOO_TRACE_UPDATES)
            # the device's busy share of an untraced update: the rest is
            # the host's (dispatch, syncs, host-side batch work)
            out["device_busy_share"] = \
                out["traced"]["busy_ms_per_update"] \
                / out["by_method"][clock.last_method]["ms_mean"]
            out["tensors_on_card"] = _zoo_on_card(policy)
    finally:
        algo.stop()
    out["seconds"] = time.perf_counter() - t_all
    return out


def _rank_device(worker):
    """Inside a DD-PPO rank: its policy's device, and whether every
    parameter and Adam moment lies on it."""
    policy = worker.policy
    tensors = list(policy.model.parameters()) + [
        t for s in policy.opt.state.values() for t in s.values()
        if isinstance(t, torch.Tensor)]
    return str(policy.device), all(t.device.type == policy.device.type
                                   for t in tensors)


def _ddppo_minibatch_ms(worker, group_name, n):
    """Inside a DD-PPO rank (every rank at once: each step allreduces):
    ``n`` minibatch steps on a fresh batch of the rank's, each timed in
    three parts with the card synchronised between them: the gradient,
    the gang's mean (one copy to the host, the object-store allreduce,
    one copy back) and the apply (clip and Adam)."""
    import numpy as np
    from ray_tpu_torch.rllib.algorithms.ddppo import allreduce_gradients
    from ray_tpu_torch.rllib.execution import standardize_advantages
    from ray_tpu_torch.util.collective import collective
    policy = worker.policy
    world = collective.get_collective_group_size(group_name)
    batch = standardize_advantages(worker.sample())
    mb = batch.slice(0, min(len(batch), int(
        policy.config.get("sgd_minibatch_size", 128))))
    dev = policy._device_batch(mb)
    dev["kl_coeff"] = float(np.float32(policy.kl_coeff))
    parts = {"grads_ms": [], "allreduce_ms": [], "apply_ms": []}
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads, _ = policy._grads(dev)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        mean = allreduce_gradients(policy, grads, group_name, world)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        policy.apply_gradients(mean)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, ms in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(ms * 1e3)
    return {"rows": len(mb), "floats": int(sum(g.numel() for g in grads)),
            **{k: {"mean": statistics.mean(v), "range": [min(v), max(v)]}
               for k, v in parts.items()}}


def rl_zoo_gang(name):
    """DD-PPO's yaml with its learners on the card: every rank's policy
    is asserted on CUDA, one warm-up train(), RL_ZOO_WINDOW_S of train()
    calls (env steps a second, ms a train()), then train() on to the
    yaml's criterion; the ranks' weights must then be equal bit for bit.
    Last, RL_DDPPO_TIMED minibatch steps timed inside each rank
    (_ddppo_minibatch_ms) and the ranks held equal again."""
    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch.rllib import tuned_examples
    path = os.path.join(os.path.dirname(tuned_examples.__file__),
                        name + ".yaml")
    t_all = t0 = time.perf_counter()
    algo, spec = tuned_examples.load(path)
    build_s = time.perf_counter() - t0
    stop, first, met = spec.get("stop") or {}, {}, []

    def train():
        r = algo.train()
        if not first:
            first.update(r)
        if not met and tuned_examples._criteria_met(stop, r, first):
            met.append(algo.iteration)
        return r

    def same_ranks():
        weights = rt.get([w.get_weights.remote() for w in workers])
        return all(np.array_equal(weights[0][k], w[k])
                   for w in weights[1:] for k in weights[0])

    try:
        workers = algo.workers.remote_workers
        devices = rt.get([w.apply.remote(_rank_device) for w in workers])
        assert all(d.startswith("cuda") and on for d, on in devices), \
            devices
        t0 = time.perf_counter()
        train()
        warm_s = time.perf_counter() - t0
        steps0, ms, losses = algo._timesteps_total, [], []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < RL_ZOO_WINDOW_S:
            t1 = time.perf_counter()
            r = train()
            ms.append((time.perf_counter() - t1) * 1e3)
            losses.append(_loss_values(r))
        wall = time.perf_counter() - t0
        assert all(np.isfinite(v) for d in losses for v in d.values()), \
            (name, losses)
        cfg = algo.config
        minibatches = int(cfg["num_sgd_iter"]) * max(1, (
            int(cfg["rollout_fragment_length"])
            * int(cfg["num_envs_per_worker"]))
            // int(cfg["sgd_minibatch_size"]))
        out = {"example": name, "algo": spec["run"], "build_s": build_s,
               "ranks": len(workers), "rank_devices": devices,
               "warmup_s": warm_s, "window_s": wall, "trains": len(ms),
               "env_steps_per_s": (algo._timesteps_total - steps0) / wall,
               "ms_per_train": statistics.mean(ms),
               "ms_per_train_range": [min(ms), max(ms)],
               "minibatches_per_train": minibatches,
               "last_losses": losses[-1]}
        t0 = time.perf_counter()
        budget = int(stop.get("training_iteration", 50))
        while not met and algo.iteration < budget:
            r = train()
        out["criterion"] = {
            "passed": bool(met), "iterations": met[0] if met else None,
            "budget": budget, "iterations_run": algo.iteration,
            "episode_reward_mean": r["episode_reward_mean"],
            "seconds_after_window": time.perf_counter() - t0}
        assert met, (name, out["criterion"])
        out["criterion_met_at"] = met[0]
        out["ranks_equal"] = same_ranks()
        assert out["ranks_equal"], "DD-PPO's ranks diverged"
        timed = rt.get([w.apply.remote(_ddppo_minibatch_ms, algo._group,
                                       RL_DDPPO_TIMED) for w in workers])
        assert same_ranks(), "DD-PPO's ranks diverged in the timed steps"
        out["minibatch"] = timed
        allreduce = statistics.mean(t["allreduce_ms"]["mean"]
                                    for t in timed)
        out["allreduce_ms_per_minibatch"] = allreduce
        out["allreduce_share_of_train"] = \
            allreduce * minibatches / out["ms_per_train"]
    finally:
        algo.stop()
    out["seconds"] = time.perf_counter() - t_all
    return out


def rl_zoo_rl_trainer(iterations=3):
    """RLTrainer.fit() with PG, its learner on the card, for
    ``iterations`` iterations; its checkpoint restored into a PG on the
    CPU, every weight equal to the card's."""
    import pickle
    import tempfile
    import numpy as np
    from ray_tpu_torch.rllib.algorithms import PG, PGConfig
    from ray_tpu_torch.train import RLTrainer, RunConfig
    devices = []

    class _PG(PG):  # PG, recording where its learner was built
        def setup(self):
            super().setup()
            devices.append(str(self.get_policy().device))

    config = {"env": "CartPole-v1", "train_batch_size": 400, "lr": 4e-3,
              "seed": SEED}
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        result = RLTrainer(algorithm=_PG, config=config,
                           stop={"training_iteration": iterations},
                           run_config=RunConfig(storage_path=d)).fit()
        fit_s = time.perf_counter() - t0
        assert devices and devices[0].startswith("cuda"), devices
        assert result.metrics["training_iteration"] == iterations
        algo = (PGConfig().environment("CartPole-v1")
                .resources(num_gpus_per_learner=0).debugging(seed=SEED)
                .build())
        try:
            with result.checkpoint.as_directory() as cd:
                algo.restore(cd)
                with open(os.path.join(cd, "algorithm_state.pkl"),
                          "rb") as f:
                    saved = pickle.load(f)["policy_state"]["weights"]
            policy = algo.get_policy()
            assert algo.iteration == iterations
            assert policy.device.type == "cpu"
            restored = policy.get_weights()
            assert all(np.array_equal(saved[k], restored[k]) for k in saved)
        finally:
            algo.stop()
    return {"algorithm": "PG", "learner_device": devices[0],
            "iterations": iterations, "fit_s": fit_s,
            "episode_reward_mean": result.metrics["episode_reward_mean"],
            "restored_on": "cpu", "weights_equal": True}


def phase_rl_zoo():
    """The model-free algorithm zoo with its learners on the card:
    rl_zoo_parity for each RL_ZOO_PARITY policy, then each tuned example
    of RL_ZOO_EXAMPLES on the port's runtime, RL_ZOO_CRITERION's to their
    criteria.  Returns the launches of the port's kernels over the
    runs (none: these learners' networks are plain torch)."""
    import ray_tpu_torch as rt
    t0 = time.perf_counter()
    with no_tf32():
        parity = {}
        for label in RL_ZOO_PARITY:
            t1 = time.perf_counter()
            parity[label] = rl_zoo_parity(label)
            parity[label]["seconds"] = time.perf_counter() - t1
    ok = all(p["ok"] for p in parity.values())
    emit({"phase": "rl_zoo_parity", "ok": ok, "policies": parity,
          "seconds": time.perf_counter() - t0,
          "update_tol": RL_UPDATE_TOL, "stats_rtol": RL_STATS_RTOL,
          "card": card_line()})
    assert ok, {k: p["failed"] for k, p in parity.items() if p["failed"]}
    _zero_all_counts()
    before = _all_counts()
    t0 = time.perf_counter()
    # the card as a resource: DD-PPO's ranks each lease a share of it
    rt.init(num_cpus=16, num_gpus=1,
            object_store_memory=RL_STORE_MIB * 2**20)
    init_s = time.perf_counter() - t0
    try:
        examples = [rl_zoo_gang(name) if name in RL_ZOO_GANG
                    else rl_zoo_example(name) for name in RL_ZOO_EXAMPLES]
        t1 = time.perf_counter()
        rl_trainer = rl_zoo_rl_trainer()
        rl_trainer["seconds"] = time.perf_counter() - t1
    finally:
        t1 = time.perf_counter()
        rt.shutdown()
        shutdown_s = time.perf_counter() - t1
    launches = _delta(before, _all_counts())
    emit({"phase": "rl_zoo", "ok": True, "init_s": init_s,
          "shutdown_s": shutdown_s, "examples": examples,
          "rl_trainer": rl_trainer, "launches": launches,
          "seconds": time.perf_counter() - t0, "card": card_line()})
    return launches


# tune: Tune trials that train GPT-2 124M at full width, two sharing the
# card (resources_per_trial {"GPU": 0.5}), under ASHA and then PBT.  The
# trials are cold-spawned GPU workers; each counts its own launches.
TUNE_LRS = (1e-4, 3e-4, 1e-3, 3e-3)
TUNE_STEPS = 8
TUNE_BATCH = 8
TUNE_PBT_LRS = (1e-4, 1e-3)
# one exploit (at step 2): more steps add exploits, each a cold trial start
# and 1.5 GB checkpoint trips, and the script has a time limit
TUNE_PBT_STEPS = 3
TUNE_RESOURCES = {"GPU": 0.5, "CPU": 1}
# the driver holds each trial's newest checkpoint (1.5 GB) and the store
# carries it from the trial's actor; PBT's donor crosses it once more
TUNE_STORE_MIB = 12288
TUNE_BARRIER_S = 300  # the trials' bounded wait for their population
TUNE_UTIL_MS = 200  # nvidia-smi's sampling period for the busy share


def _process_start() -> float:
    """This process's start on the host's clock (/proc: the boot time
    plus the start in clock ticks)."""
    with open("/proc/stat") as f:
        btime = next(int(ln.split()[1]) for ln in f if ln.startswith("btime"))
    with open(f"/proc/{os.getpid()}/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return btime + ticks / os.sysconf("SC_CLK_TCK")


def tune_trial_loop(config):
    """The Tune trainable of phase tune, in a trial's cold-spawned GPU
    worker: GPT-2 124M from ``config["seed"]`` with AdamW(config["lr"],
    0.01) on the batch of each step, ``tune.report`` each step, a
    checkpoint (the model, the optimizer's state and the step, and its
    writer: this run's token, lr and step) every ``ckpt_every`` steps.
    It resumes from ``tune.get_checkpoint()`` at the saved step, and its
    first result after a restore names the writer.  With a
    ``population``, a run that resumes nothing first checks in under
    ``config["barrier"]`` and waits (bounded) for the round of that many
    runs it belongs to, so that they train side by side.  Each result
    carries the step's launches, the current device and the GPU lease;
    the first, when the run reached each stage of its start."""
    t_loop_start = time.time()
    import hashlib
    import uuid
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config, adamw, train_step
    from ray_tpu_torch.ops.fused import fused_rmsnorm
    from ray_tpu_torch.train import Checkpoint

    t_imports = time.time()
    token = uuid.uuid4().hex[:12]
    lease = rt.get_gpu_ids()
    resumed = tune.get_checkpoint()
    if config["population"] and resumed is None:
        open(os.path.join(config["barrier"], token), "w").close()
        size, population = len(os.listdir(config["barrier"])), \
            config["population"]
        goal = -(-size // population) * population
        deadline = time.time() + TUNE_BARRIER_S
        while len(os.listdir(config["barrier"])) < goal:
            if time.time() > deadline:
                raise TimeoutError("the population never checked in")
            time.sleep(0.05)
    t_barrier = time.time()
    torch.zeros(1, device="cuda")  # the CUDA context
    torch.cuda.synchronize()
    t_cuda = time.time()
    _zero_counts()
    fused_rmsnorm.launches = 0
    cfg = GPT2Config.gpt2_small(max_seq_len=config["batches"][0].shape[1])
    model = GPT2(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(config["seed"]))
    torch.cuda.synchronize()
    t_model = time.time()
    # a process's first torch.optim optimizer imports torch._dynamo
    opt = adamw(model.parameters(), lr=config["lr"], weight_decay=0.01)
    t_opt = time.time()
    start, writer, restore_s = 0, None, None
    if resumed is not None:
        t0 = time.perf_counter()
        tree = resumed.to_pytree({"model": model.state_dict(),
                                  "optim": opt.state_dict(), "step": 0,
                                  "writer": {}})
        model.load_state_dict(tree["model"])
        opt.load_state_dict(tree["optim"])
        for group in opt.param_groups:  # the new config's lr
            group["lr"] = config["lr"]
        start, writer = tree["step"], tree["writer"]
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
    t_ready = time.time()
    for step in range(start + 1, config["steps"] + 1):
        tokens = torch.tensor(config["batches"][step - 1], device="cuda")
        before = {**_flash_counts(), "rmsnorm": fused_rmsnorm.launches}
        t0 = time.perf_counter()
        loss = train_step(model, opt, tokens,
                          head_logits_dtype=torch.bfloat16)
        value = loss.item()
        step_s = time.perf_counter() - t0
        after = {**_flash_counts(), "rmsnorm": fused_rmsnorm.launches}
        metrics = {
            "loss": value, "step": step, "training_iteration": step,
            "lr": config["lr"], "token": token, "step_s": step_s,
            "launches": {k: after[k] - before[k] for k in after},
            "device": str(tokens.device),
            "current_device": torch.cuda.current_device(), "lease": lease,
            "batch_sha1": hashlib.sha1(
                config["batches"][step - 1].tobytes()).hexdigest(),
            "t_result": time.time()}
        if step == start + 1:  # the run's first result
            metrics.update(t_process_start=_process_start(),
                           t_loop_start=t_loop_start, t_imports=t_imports,
                           t_barrier=t_barrier, t_cuda=t_cuda,
                           t_model=t_model, t_opt=t_opt, t_ready=t_ready,
                           resumed_from=writer, restore_s=restore_s)
        ckpt = None
        if config["ckpt_every"] and step % config["ckpt_every"] == 0:
            t0 = time.perf_counter()
            ckpt = Checkpoint.from_pytree(
                {"model": model.state_dict(), "optim": opt.state_dict(),
                 "step": step, "writer": {"token": token,
                                          "lr": config["lr"], "step": step}})
            metrics["ckpt_build_s"] = time.perf_counter() - t0
            metrics["ckpt_bytes"] = len(ckpt.to_dict()["pytree_torch"])
        if step > start + 1:  # the last report's wait for the runner
            metrics["prev_report_s"] = report_s
        t0 = time.perf_counter()
        tune.report(metrics, checkpoint=ckpt)
        report_s = time.perf_counter() - t0


class _BusySampler:
    """The card's utilization (the share of each sample period in which
    a kernel ran) from ``nvidia-smi -lms``, over a ``with`` block."""

    def __enter__(self):
        self._proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=utilization.gpu",
             "--format=csv,noheader,nounits", "-lms", str(TUNE_UTIL_MS)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self._proc.terminate()
        out = self._proc.communicate(timeout=30)[0]
        self.samples = [int(v) for v in out.split() if v.isdigit()]


def _tune_runs(grid):
    """Each run of each trial: its results in order, split where the
    token (one per actor run) changes."""
    runs = {}
    for i in range(len(grid)):
        r = grid[i]
        rows = []
        for h in r.metrics_history:
            if not rows or rows[-1][0]["token"] != h["token"]:
                rows.append([])
            rows[-1].append(h)
        runs[r.trial_id] = rows
    return runs


def _tune_check_run(run, per_step):
    """What every run must show: each step on the card, on its lease,
    with the flash kernels' launches of one GPT-2 124M step."""
    for h in run:
        assert h["device"].startswith("cuda"), h["device"]
        assert h["lease"] and h["current_device"] == int(h["lease"][0]), (
            h["current_device"], h["lease"])
        assert h["launches"] == per_step, (h["step"], h["launches"])
        assert math.isfinite(h["loss"]), h


def _tune_step_ms(rows):
    """The ms of each step but a run's first (its warm-up), split by
    whether a step of another run was on the card at the same time."""
    spans = [(h["t_result"] - h["step_s"], h["t_result"], h["token"])
             for h in rows]
    shared, alone = [], []
    for h in rows:
        if "t_process_start" in h:  # a run's first result
            continue
        a, b = h["t_result"] - h["step_s"], h["t_result"]
        side = any(t != h["token"] and lo < b and hi > a
                   for lo, hi, t in spans)
        (shared if side else alone).append(h["step_s"] * 1e3)
    return {"shared_ms": statistics.mean(shared) if shared else None,
            "shared_ms_each": shared,
            "alone_ms": statistics.mean(alone) if alone else None,
            "alone_ms_each": alone}


def _tune_start_s(run):
    """A run's start, stage by stage: the worker's spawn to the loop
    (interpreter, runtime, torch and chip_smoke imports, the actor's
    arguments), the loop's imports, the wait for its population, the
    CUDA context, the model on the card, the optimizer, the restore,
    the first step."""
    first = run[0]
    return {"process_to_first_result_s":
            first["t_result"] - first["t_process_start"],
            "process_to_loop_s":
            first["t_loop_start"] - first["t_process_start"],
            "imports_s": first["t_imports"] - first["t_loop_start"],
            "barrier_s": first["t_barrier"] - first["t_imports"],
            "cuda_s": first["t_cuda"] - first["t_barrier"],
            "model_s": first["t_model"] - first["t_cuda"],
            "optimizer_s": first["t_opt"] - first["t_model"],
            "restore_s": first["restore_s"],
            "first_step_s": first["t_result"] - first["t_ready"]}


def phase_tune(batch=TUNE_BATCH, seq=1024):
    """Tune on the port's runtime with GPT-2 124M trials on the card:
    the direct reference for each lr of TUNE_LRS in this process first
    (freed after); then ASHA over the four lrs, two trials at a time on
    one card, every loss against the direct run's; then PBT over two
    trials that checkpoint every step, whose exploit restores the other
    trial's checkpoint: the restored trial's first loss against the one
    its writer reported at that step, on the same weights and batch.
    Returns the launches of every trial's steps."""
    import hashlib
    import shutil
    import tempfile
    import numpy as np
    import ray_tpu_torch as rt
    from ray_tpu_torch import tune
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config, adamw, train_step
    from ray_tpu_torch.train import RunConfig

    class StartLog(tune.Callback):
        """Each trial's starts, with the config each started with, and
        when the runner took each result."""

        def __init__(self):
            self.starts = {}

        def on_trial_start(self, iteration, trials, trial):
            self.starts.setdefault(trial.trial_id, []).append(
                {k: v for k, v in trial.config.items() if k != "batches"})

        def on_trial_result(self, iteration, trials, trial, result):
            # after the runner took the result (and fetched its checkpoint)
            result["t_driver"] = time.time()

    t_phase = time.perf_counter()
    st = os.statvfs("/dev/shm")
    if st.f_bavail * st.f_frsize < TUNE_STORE_MIB * 2**20:
        raise RuntimeError(f"/dev/shm has less than {TUNE_STORE_MIB} MiB "
                           "free; tune sizes the object store there")
    cfg = GPT2Config.gpt2_small(max_seq_len=seq)
    rows = np.random.default_rng(SEED + 11).integers(
        0, cfg.vocab_size, (TUNE_STEPS * batch, seq), dtype=np.int64)
    batches = [rows[i * batch:(i + 1) * batch] for i in range(TUNE_STEPS)]
    digests = [hashlib.sha1(b.tobytes()).hexdigest() for b in batches]

    # 1. the direct reference: each lr's steps in this process, one trial
    # alone on the card
    direct, direct_s = {}, []
    for lr in TUNE_LRS:
        model = GPT2(cfg, device="cuda", generator=torch.Generator(
            device="cuda").manual_seed(SEED))
        opt = adamw(model.parameters(), lr=lr, weight_decay=0.01)
        direct[lr] = []
        for i, b in enumerate(batches):
            tokens = torch.as_tensor(b).cuda()
            t0 = time.perf_counter()
            loss = train_step(model, opt, tokens,
                              head_logits_dtype=torch.bfloat16)
            direct[lr].append(loss.item())
            if i:  # the first step of each model is warm-up
                direct_s.append(time.perf_counter() - t0)
        del model, opt, loss, tokens
        _free()
    per_step = {**_flash_per(cfg.num_layers), "rmsnorm": 0}
    order = sorted(TUNE_LRS, key=lambda lr: direct[lr][1])

    def close(got, want):
        return abs(got - want) <= GANG_LOSS_RTOL * abs(want)

    barriers = [tempfile.mkdtemp(prefix="chip_smoke_tune_")
                for _ in range(2)]  # ASHA's and PBT's
    t0 = time.perf_counter()
    rt.init(num_cpus=4, num_gpus=1,
            object_store_memory=TUNE_STORE_MIB * 2**20)
    init_s = time.perf_counter() - t0
    try:
        # 2. ASHA: four lrs in the order of their step-2 loss, best first,
        # so the later two meet a better value at rung 2 and stop there;
        # each pair that runs together starts its steps together
        log = StartLog()
        t0 = time.perf_counter()
        with _BusySampler() as asha_busy:
            asha = tune.Tuner(
                tune_trial_loop,
                param_space={"lr": tune.grid_search(order), "seed": SEED,
                             "steps": TUNE_STEPS, "ckpt_every": 0,
                             "batches": batches, "population": 2,
                             "barrier": barriers[0]},
                tune_config=tune.TuneConfig(
                    metric="loss", mode="min", max_concurrent_trials=2,
                    scheduler=tune.AsyncHyperBandScheduler(
                        metric="loss", mode="min", max_t=TUNE_STEPS,
                        grace_period=2, reduction_factor=2)),
                run_config=RunConfig(name="chip_smoke_tune_asha",
                                     callbacks=[log]),
                resources_per_trial=dict(TUNE_RESOURCES)).fit()
        asha_s = time.perf_counter() - t0
        assert not asha.errors, asha.errors
        runs = runs_asha = _tune_runs(asha)
        reached = {}
        for i in range(len(asha)):
            r = asha[i]
            trial_runs = runs[r.trial_id]
            assert len(trial_runs) == 1, r.trial_id
            run = trial_runs[0]
            _tune_check_run(run, per_step)
            lr = r.config["lr"]
            assert [h["step"] for h in run] == list(range(1, len(run) + 1))
            for h in run:
                assert h["batch_sha1"] == digests[h["step"] - 1]
                assert close(h["loss"], direct[lr][h["step"] - 1]), (
                    lr, h["step"], h["loss"], direct[lr][h["step"] - 1])
            reached[lr] = len(run)
        assert min(reached.values()) < TUNE_STEPS, reached
        assert max(reached.values()) == TUNE_STEPS, reached
        # ResultGrid's pick (each trial's best result) from the direct losses
        want_best = min(reached, key=lambda lr: min(direct[lr][:reached[lr]]))
        best = asha.get_best_result()
        assert best.config["lr"] == want_best, (best.config["lr"], want_best)
        assert reached[want_best] == TUNE_STEPS, reached
        asha_starts = [_tune_start_s(runs[asha[i].trial_id][0])
                       for i in range(len(asha))]
        asha_rows = [h for i in range(len(asha))
                     for h in runs[asha[i].trial_id][0]]
        launches = dict.fromkeys(FLASH_ALL, 0)
        for h in asha_rows:
            for k in launches:
                launches[k] += h["launches"][k]
        asha_summary = {
            "order": order, "steps_reached": {
                str(lr): n for lr, n in reached.items()},
            "best_lr": best.config["lr"], "seconds": asha_s,
            "starts": asha_starts,
            "steps": _tune_step_ms(asha_rows),
            "report_wait_s_mean": statistics.mean(
                h["prev_report_s"] for h in asha_rows
                if "prev_report_s" in h),
            "report_to_driver_s_mean": statistics.mean(
                h["t_driver"] - h["t_result"] for h in asha_rows),
            "busy_pct_mean": statistics.mean(asha_busy.samples),
            "busy_samples": len(asha_busy.samples)}
        emit({"phase": "tune_asha", **asha_summary, "card": card_line()})

        # 3. PBT: two trials that check in together, a checkpoint a step
        pbt_log = StartLog()
        t0 = time.perf_counter()
        with _BusySampler() as pbt_busy:
            pbt = tune.Tuner(
                tune_trial_loop,
                param_space={"lr": tune.grid_search(list(TUNE_PBT_LRS)),
                             "seed": SEED, "steps": TUNE_PBT_STEPS,
                             "ckpt_every": 1, "batches": batches,
                             "population": len(TUNE_PBT_LRS),
                             "barrier": barriers[1]},
                tune_config=tune.TuneConfig(
                    metric="loss", mode="min",
                    max_concurrent_trials=len(TUNE_PBT_LRS),
                    scheduler=tune.PopulationBasedTraining(
                        metric="loss", mode="min", perturbation_interval=2,
                        hyperparam_mutations={"lr": [1e-4, 3e-4, 1e-3]},
                        seed=0)),
                run_config=RunConfig(name="chip_smoke_tune_pbt",
                                     callbacks=[pbt_log]),
                resources_per_trial=dict(TUNE_RESOURCES)).fit()
        pbt_s = time.perf_counter() - t0
        assert not pbt.errors, pbt.errors
    finally:
        t0 = time.perf_counter()
        rt.shutdown()
        shutdown_s = time.perf_counter() - t0
        for path in barriers:
            shutil.rmtree(path, ignore_errors=True)
    runs = _tune_runs(pbt)
    by_token = {h["token"]: (tid, run) for tid, trial_runs in runs.items()
                for run in trial_runs for h in run[:1]}
    first_runs = {trial_runs[0][0]["token"] for trial_runs in runs.values()}
    restores, checked = [], 0
    for tid, trial_runs in runs.items():
        starts = pbt_log.starts[tid]
        # a restore from the last step's checkpoint runs no step
        assert len(starts) - len(trial_runs) in (0, 1), (tid, len(starts))
        first_lr = trial_runs[0][0]["lr"]
        for k, run in enumerate(trial_runs):
            _tune_check_run(run, per_step)
            for h in run:
                assert h["batch_sha1"] == digests[h["step"] - 1]
                assert h["lr"] == starts[k]["lr"], (h["lr"], starts[k])
            if k == 0:  # before the trial's first exploit: the direct run
                assert run[0]["resumed_from"] is None
                for h in run:
                    assert close(h["loss"], direct[first_lr][h["step"] - 1]), (
                        first_lr, h["step"], h["loss"])
                continue
            writer = run[0]["resumed_from"]
            if writer is None:
                continue  # PBT found no checkpoint of the donor yet
            w_tid, w_run = by_token[writer["token"]]
            assert run[0]["step"] == writer["step"] + 1, (run[0], writer)
            later = [h for h in w_run if h["step"] == run[0]["step"]]
            entry = {"trial": tid, "writer_trial": w_tid,
                     "writer_lr": writer["lr"], "lr": run[0]["lr"],
                     "step": writer["step"], "loss": run[0]["loss"],
                     "writer_loss_same_step":
                     later[0]["loss"] if later else None,
                     **_tune_start_s(run),
                     "writer_report_to_restored_s":
                     run[0]["t_ready"] - next(
                         h["t_result"] for h in w_run
                         if h["step"] == writer["step"])}
            # the loss at step s + 1 on a checkpoint of step s: what its
            # writer reported at s + 1 or, where the exploit stopped the
            # writer at s, the direct run that the writer's first run
            # followed (held against it above)
            if later:
                entry["want"], entry["want_from"] = later[0]["loss"], "writer"
            elif writer["token"] in first_runs:
                entry["want"] = direct[writer["lr"]][writer["step"]]
                entry["want_from"] = "direct"
            restores.append(entry)
            if w_tid != tid and "want" in entry:
                assert close(run[0]["loss"], entry["want"]), entry
                checked += 1
    assert any(e["writer_trial"] != e["trial"] for e in restores), restores
    assert checked, restores
    pbt_first = [_tune_start_s(trial_runs[0]) for trial_runs in runs.values()]
    pbt_rows = [h for trial_runs in runs.values() for run in trial_runs
                for h in run]
    ckpts = [h for h in pbt_rows if "ckpt_bytes" in h]
    for trial_runs in runs.values():
        for run in trial_runs:
            for h in run:
                for k in launches:
                    launches[k] += h["launches"][k]
    emit({"phase": "tune", "ok": True,
          "config": f"gpt2_small ({cfg.num_layers} layers, {cfg.embed_dim} "
          "wide, bf16 compute, f32 masters, AdamW(lr, 0.01), bf16 head "
          f"logits), {batch} x {seq} tokens a step, Tune trials on "
          f"init(num_cpus=4, num_gpus=1), resources_per_trial "
          f"{TUNE_RESOURCES}",
          "direct_losses": {str(lr): v for lr, v in direct.items()},
          "direct_step_ms": statistics.mean(direct_s) * 1e3,
          "direct_step_ms_each": [t * 1e3 for t in direct_s],
          "init_s": init_s, "shutdown_s": shutdown_s,
          "asha": asha_summary,
          "pbt": {"seconds": pbt_s, "first_starts": pbt_first,
                  "restores": restores, "restores_checked": checked,
                  "runs": {tid: [[{k: h[k] for k in ("step", "lr", "loss")}
                                  for h in run] for run in trial_runs]
                           for tid, trial_runs in runs.items()},
                  "steps": _tune_step_ms(pbt_rows),
                  "report_wait_s_mean": statistics.mean(
                      h["prev_report_s"] for h in pbt_rows
                      if "prev_report_s" in h),
                  "report_to_driver_s_mean": statistics.mean(
                      h["t_driver"] - h["t_result"] for h in pbt_rows),
                  "ckpt_bytes": ckpts[0]["ckpt_bytes"],
                  "ckpt_build_s_mean": statistics.mean(
                      h["ckpt_build_s"] for h in ckpts),
                  "checkpoints": len(ckpts),
                  "busy_pct_mean": statistics.mean(pbt_busy.samples),
                  "busy_samples": len(pbt_busy.samples)},
          "loss_rtol": GANG_LOSS_RTOL, "launches_per_step": per_step,
          "launches": {k: v for k, v in launches.items() if v},
          "seconds": time.perf_counter() - t_phase, "card": card_line()})
    return launches


# ---------------------------------------------------------------- cluster --
# GPT-2 124M answering on a multi-node cluster: a head without the card,
# a GPU node and a CPU node (cluster_utils), a ray:// client server and
# a second driver, then a head started by the CLI and a driver that finds
# it with address="auto".  Each forward runs in a cluster worker that
# zeroes and reads its own launch counts.  The drivers' processes, the
# client server and the CLI's head start with the phase, so that their
# interpreters and imports overlap the actor's stage; the actor warms its
# process (torch, the model's modules, the CUDA context) while the
# weights are put; the two drivers then run side by side, each on its
# own cluster.
CLUSTER_SHAPE = (8, 1024)  # tokens of each forward
CLUSTER_PRESET = "gpt2_small"
CLUSTER_HOLDER = "chip-smoke-cluster-weights"
CLUSTER_DRIVER_TIMEOUT_S = 300


def cluster_weights(preset=CLUSTER_PRESET):
    """GPT-2's f32 master weights as CPU tensors, random from a seeded
    CPU generator, and the forward's tokens."""
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config
    cfg = getattr(GPT2Config, preset)(max_seq_len=CLUSTER_SHAPE[1])
    model = GPT2(cfg, device="cpu",
                 generator=torch.Generator().manual_seed(SEED))
    tokens = torch.randint(0, cfg.vocab_size, CLUSTER_SHAPE,
                           generator=torch.Generator().manual_seed(SEED + 1))
    return {k: v.detach() for k, v in model.state_dict().items()}, tokens


def _cluster_warm(device):
    """This process ready for the forward: the model's modules imported
    and, on the card, the CUDA context made."""
    from ray_tpu_torch.models.gpt2 import GPT2  # noqa: F401
    if device == "cuda":
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()


def cluster_forward(weights, tokens, preset, device):
    """The bf16 forward from ``weights`` on ``device``: f32 logits, this
    process's launches of the port's kernels in it, and the seconds of
    the model's build and of the forward."""
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config
    from ray_tpu_torch.ops.fused import fused_rmsnorm
    t0 = time.perf_counter()
    cfg = getattr(GPT2Config, preset)(max_seq_len=CLUSTER_SHAPE[1])
    model = GPT2(cfg, device=device)
    model.load_state_dict(weights)
    _zero_counts()
    t1 = time.perf_counter()
    with torch.no_grad():
        logits = model(tokens.to(device))
    if device == "cuda":
        torch.cuda.synchronize()
    return logits, {**_flash_counts(), "rmsnorm": fused_rmsnorm.launches}, \
        {"model_s": t1 - t0, "forward_s": time.perf_counter() - t1}


def _cluster_where():
    import ray_tpu_torch as rt
    return {"node": rt.get_runtime_context().get_node_id(),
            "gpu_ids": rt.get_gpu_ids(), "pid": os.getpid(),
            "process_start": _process_start(),
            "device": (torch.cuda.get_device_name()
                       if torch.cuda.is_available() else "cpu")}


class ClusterForwardActor:
    """The GPU actor of phase ``cluster``: warms its process when made,
    then one forward a call."""

    def __init__(self, device):
        t0 = time.time()
        _cluster_warm(device)
        self.times = {"warm_start": t0, "warm_end": time.time()}

    def forward(self, weights, tokens, preset, device):
        self.times["call_start"] = time.time()
        logits, self.launches, took = cluster_forward(weights, tokens,
                                                      preset, device)
        self.times.update(took, call_end=time.time())
        return logits

    def info(self):
        return {**_cluster_where(), "launches": self.launches,
                "times": self.times}


class ClusterWeightsHolder:
    """Holds the weights' ObjectRef (in a list, so that it stays a ref)
    for drivers that did not put them."""

    def __init__(self, box):
        self._box = box

    def box(self):
        return self._box


def cluster_forward_task(weights, tokens, preset, device):
    """Phase ``cluster``'s GPU task: the forward from ``weights``, or,
    where None, from the weights the named holder keeps.  Returns the
    logits and, as a second value, where it ran, its launches and its
    times (the logits alone take the store's tensor path)."""
    import ray_tpu_torch as rt
    times = {"call_start": time.time()}
    _cluster_warm(device)
    times["warm_end"] = time.time()
    if weights is None:
        box = rt.get(rt.get_actor(CLUSTER_HOLDER).box.remote(), timeout=60)
        weights = rt.get(box[0], timeout=120)
    times["weights_end"] = time.time()
    logits, launches, took = cluster_forward(weights, tokens, preset, device)
    times.update(took, call_end=time.time())
    return logits, {**_cluster_where(), "launches": launches,
                    "times": times}


def cluster_hold(got, ref):
    """``got`` against the in-process logits ``ref``, within
    model_parity's limit (atol = rtol = 1e-3): its max |diff| and whether
    the two are equal bit for bit."""
    got = got.to(ref.device)
    assert got.shape == ref.shape and torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, atol=1e-3, rtol=1e-3)
    return {"max_abs_err": max_err(got, ref), "bitwise": torch.equal(got, ref)}


def _await_file(path, timeout=CLUSTER_DRIVER_TIMEOUT_S):
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)
    with open(path) as f:
        return f.read().strip()


def cluster_driver(mode, go_path, ref_path, preset=CLUSTER_PRESET,
                   device="cuda"):
    """A second driver process of phase ``cluster``, started early: it
    imports what it needs, then waits for ``go_path`` to name its
    address.  ``mode`` "client" connects by ``ray://`` and runs the
    forward as a GPU task on the holder's weights; "auto" (the file says
    "auto") finds the CLI's head with ``init(address="auto")``, puts the
    weights again and runs it.  The logits come back to this process (on
    its card), are held against the in-process ones saved at
    ``ref_path``, and a JSON line reports it."""
    import ray_tpu_torch as rt
    _cluster_warm(device)
    _, tokens = cluster_weights(preset)
    t_ready = time.time()
    address = _await_file(go_path)
    t0 = time.perf_counter()
    info = rt.init(address=address)
    t_init = time.perf_counter() - t0
    weights = None
    if mode == "auto":
        weights = rt.put(cluster_weights(preset)[0])
    # on the card the GPU lease places the task; the rehearsal without
    # one names the GPU node of phase cluster's Cluster by its resource
    place = {"num_gpus": 1} if device == "cuda" else (
        {"resources": {"gpu_node": 1}} if mode == "client" else {})
    remote = rt.remote(cluster_forward_task).options(num_returns=2, **place)
    t1 = time.perf_counter()
    t_submit = time.time()
    logits_ref, where_ref = remote.remote(weights, tokens, preset, device)
    logits = rt.get(logits_ref, timeout=CLUSTER_DRIVER_TIMEOUT_S)
    t_got = time.time()
    where = rt.get(where_ref, timeout=60)
    t_forward = time.perf_counter() - t1
    if device == "cuda":
        assert logits.device.type == "cuda", logits.device
    held = cluster_hold(logits, torch.load(ref_path).to(logits.device))
    out = {"mode": mode, "address": address, "connection": info,
           "logits_device": str(logits.device), "where": where,
           "process_start": _process_start(), "ready": t_ready,
           "submit": t_submit, "got": t_got,
           "init_s": t_init, "forward_s": t_forward, **held}
    rt.shutdown()
    print("CLUSTER_DRIVER " + json.dumps(out, default=str), flush=True)
    return 0


def _free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _repo_root():
    return os.path.dirname(os.path.abspath(__file__))


def _cluster_spawn(mode, go_path, ref_path, preset, device, env=None):
    """Start a driver of ``cluster_driver`` (it waits for ``go_path``)."""
    return subprocess.Popen(
        [sys.executable, "-c", "import sys, chip_smoke as c; "
         f"sys.exit(c.cluster_driver({mode!r}, {go_path!r}, {ref_path!r},"
         f" {preset!r}, {device!r}))"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=_repo_root(), env={**os.environ, **(env or {})})


def _cluster_go(go_path, address):
    """Let a waiting driver go at ``address``."""
    with open(go_path + ".tmp", "w") as f:
        f.write(address)
    os.replace(go_path + ".tmp", go_path)


def _cluster_report(proc):
    """A driver's report, once it has ended."""
    out, err = proc.communicate(timeout=CLUSTER_DRIVER_TIMEOUT_S)
    assert proc.returncode == 0, (out[-3000:], err[-3000:])
    line = [ln for ln in out.splitlines() if ln.startswith("CLUSTER_DRIVER ")]
    return json.loads(line[-1].split(" ", 1)[1])


def _cluster_cli(*argv, env):
    out = subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *argv],
        capture_output=True, text=True, cwd=_repo_root(), timeout=120,
        env={**os.environ, **env})
    assert out.returncode == 0, (argv, out.stdout[-3000:],
                                 out.stderr[-3000:])
    return out.stdout


def _cluster_task_times(where, submit, got):
    """A remote forward's seconds: from the driver's submit to its
    worker's start (a cold spawn) and to the call, the warm-up, the
    weights' fetch, the model's build, the forward, and the logits' way
    back to the driver."""
    t = where["times"]
    return {"spawn_s": t["call_start"] - max(submit, where["process_start"])
            if where["process_start"] > submit else 0.0,
            "to_call_s": t["call_start"] - submit,
            "warm_s": t["warm_end"] - t["call_start"],
            "weights_s": t["weights_end"] - t["warm_end"],
            "model_s": t["model_s"], "forward_s": t["forward_s"],
            "back_s": got - t["call_end"]}


def phase_cluster(preset=CLUSTER_PRESET, device="cuda"):
    """GPT-2 124M (12 layers, full width, random from a seed) answering
    on a two-node cluster on the card: a head without the GPU, a GPU node
    and a CPU node (``cluster_utils.Cluster``); the weights put once as
    CPU tensors; a ``num_gpus=1`` actor, which must land on the GPU node
    (``experimental.state.list_actors``), runs the bf16 forward at
    CLUSTER_SHAPE, held against the same forward in this process;
    ``timeline()`` and ``summarize_tasks`` must show the actor's calls.
    Then a second driver connects by ``ray://`` to a client server on the
    head and runs the forward as a GPU task, its logits back on its own
    card, while beside it a driver finds the head the CLI started with
    the GPU (``init(address="auto")``) and runs it once more; the CLI's
    ``status``, ``list tasks`` and ``stop``.  Returns the launches of
    the three forwards.  ``device="cpu"`` (and a smaller ``preset``)
    rehearses it without a card."""
    import concurrent.futures
    import shutil
    import tempfile
    import ray_tpu_torch as rt
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.experimental.state import api as state

    gpus = 1 if device == "cuda" else 0
    t_phase = time.perf_counter()
    stages = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_cluster_")
    ref_path = os.path.join(tmp, "reference_logits.pt")
    go = {m: os.path.join(tmp, f"go_{m}") for m in ("client", "auto")}
    env = {"RAY_TPU_TORCH_SESSION_ROOT": os.path.join(tmp, "sessions")}
    os.makedirs(env["RAY_TPU_TORCH_SESSION_ROOT"])
    drivers = {m: _cluster_spawn(m, go[m], ref_path, preset, device,
                                 env=env if m == "auto" else None)
               for m in ("client", "auto")}
    pool = concurrent.futures.ThreadPoolExecutor(1)

    def start_head():
        t0 = time.perf_counter()
        out = _cluster_cli("start", "--head", "--num-cpus", "2",
                           "--num-gpus", str(gpus), env=env)
        return out, time.perf_counter() - t0

    cli_head = pool.submit(start_head)
    cluster = client_server = None
    try:
        t0 = time.perf_counter()
        cluster = Cluster(initialize_head=True,
                          head_node_args={"num_cpus": 2, "num_gpus": 0})
        gpu_node = cluster.add_node(num_cpus=2, num_gpus=1,
                                    resources={"gpu_node": 1})
        cluster.add_node(num_cpus=2, num_gpus=0)
        cluster.connect()
        cluster.wait_for_nodes()
        assert rt.cluster_resources().get("GPU") == 1.0, \
            rt.cluster_resources()
        stages["cluster_up_s"] = time.perf_counter() - t0
        # the GPU node's lease places the actor; without the card (the
        # rehearsal) the node's own resource does
        t_actor = time.time()
        actor = rt.remote(ClusterForwardActor).options(
            num_gpus=gpus, num_cpus=0,
            **({} if gpus else {"resources": {"gpu_node": 1}})).remote(
                device)
        port = _free_port()
        client_server = subprocess.Popen(
            [sys.executable, "-m", "ray_tpu_torch.util.client.server",
             "--address", "{}:{}".format(*cluster.gcs_address),
             "--host", "127.0.0.1", "--port", str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=_repo_root())

        # the in-process reference, saved for the other drivers
        t0 = time.perf_counter()
        weights, tokens = cluster_weights(preset)
        ref, _, _ = cluster_forward(weights, tokens, preset, device)
        torch.save(ref.cpu(), ref_path)
        stages["reference_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        weights_ref = rt.put(weights)
        # kept: the holder lives while its handle does
        holder = rt.remote(ClusterWeightsHolder).options(
            name=CLUSTER_HOLDER, num_cpus=0).remote([weights_ref])
        stages["put_weights_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        t_submit = time.time()
        logits = rt.get(actor.forward.remote(weights_ref, tokens, preset,
                                             device), timeout=300)
        t_got = time.time()
        actor_info = rt.get(actor.info.remote(), timeout=60)
        stages["actor_forward_s"] = time.perf_counter() - t0
        at = actor_info["times"]
        actor_times = {
            "start_to_warm_s": at["warm_end"] - t_actor,
            "warm_s": at["warm_end"] - at["warm_start"],
            "wait_s": at["call_start"] - t_submit,
            "model_s": at["model_s"], "forward_s": at["forward_s"],
            "back_s": t_got - at["call_end"]}
        if gpus:
            assert logits.device.type == "cuda", logits.device
        actor_held = cluster_hold(logits, ref)
        del logits
        rows = [a for a in state.list_actors(filters=[("state", "=",
                                                       "ALIVE")])
                if "ClusterForwardActor" in a.get("class_name", "")]
        assert len(rows) == 1, rows
        assert rows[0]["node_id"] == gpu_node.node_id_hex == \
            actor_info["node"], (rows, gpu_node.node_id_hex, actor_info)
        if gpus:
            assert actor_info["gpu_ids"], actor_info
        rt.kill(actor)  # its GPU lease goes back for the client's task

        t0 = time.perf_counter()
        time.sleep(1.5)  # the task events' flush period
        trace_path = os.path.join(tmp, "timeline.json")
        rt.timeline(trace_path)
        with open(trace_path) as f:
            trace = json.load(f)
        # an actor's calls are named by their method
        method_events = [e for e in trace if e.get("cat") == "task"
                         and e["name"] == "forward"]
        assert method_events, sorted({e["name"] for e in trace})[:40]
        summary = state.summarize_tasks()
        key = "forward"
        assert summary.get(key, {}).get("FINISHED", 0) >= 1, summary
        stages["timeline_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        deadline = time.monotonic() + 120
        while "ready on ray://" not in client_server.stdout.readline():
            assert client_server.poll() is None and \
                time.monotonic() < deadline, "client server did not start"
        started, stages["cli_start_s"] = cli_head.result(timeout=120)
        stages["client_server_and_cli_head_wait_s"] = \
            time.perf_counter() - t0
        t0 = time.perf_counter()
        _cluster_go(go["client"], f"ray://127.0.0.1:{port}")
        _cluster_go(go["auto"], "auto")
        client = _cluster_report(drivers.pop("client"))
        stages["client_driver_s"] = time.perf_counter() - t0
        auto = _cluster_report(drivers.pop("auto"))
        stages["auto_driver_s"] = time.perf_counter() - t0
        assert client["where"]["node"] == gpu_node.node_id_hex, client
        if gpus:
            assert client["logits_device"].startswith("cuda"), client
        client_server.terminate()
        client_server.wait(timeout=30)
        client_server = None
        del holder
        t0 = time.perf_counter()
        cluster.shutdown()
        cluster = None
        stages["cluster_down_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        status = _cluster_cli("status", env=env)
        assert "alive" in status and ("GPU" in status or not gpus), status
        tasks = json.loads(_cluster_cli("list", "tasks", env=env))
        assert any("cluster_forward_task" in (r.get("name") or "")
                   and r.get("state") == "FINISHED" for r in tasks), \
            [(r.get("name"), r.get("state")) for r in tasks]
        stages["cli_status_list_s"] = time.perf_counter() - t0
    finally:
        for proc in drivers.values():
            proc.kill()
            proc.wait(timeout=30)
        if client_server is not None:
            client_server.kill()
        if cluster is not None:
            cluster.shutdown()
        try:
            cli_head.result(timeout=120)
        except Exception:  # noqa: BLE001 — no head was recorded
            pass
        else:
            t0 = time.perf_counter()
            stopped = _cluster_cli("stop", env=env)
            stages["cli_stop_s"] = time.perf_counter() - t0
        pool.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    assert "SIGTERM" in stopped, stopped

    per_forward = {**_flash_per(0), "rmsnorm": 0}
    if gpus:
        from ray_tpu_torch.models.gpt2 import GPT2Config
        per_forward = {**_flash_per(getattr(GPT2Config, preset)().num_layers,
                                    bwd=0), "rmsnorm": 0}
    launches = dict.fromkeys(per_forward, 0)
    for got in (actor_info["launches"], client["where"]["launches"],
                auto["where"]["launches"]):
        assert got == per_forward, (got, per_forward)
        for k in launches:
            launches[k] += got[k]
    drivers_out = {
        d["mode"]: {**{k: d[k] for k in ("max_abs_err", "bitwise",
                                         "logits_device", "init_s",
                                         "forward_s")},
                    "task": _cluster_task_times(d["where"], d["submit"],
                                                d["got"])}
        for d in (client, auto)}
    emit({"phase": "cluster", "ok": True,
          "config": f"{preset} ({CLUSTER_SHAPE[0]} x {CLUSTER_SHAPE[1]} "
          "tokens, bf16 compute, f32 masters, random from a seed); "
          "Cluster: head num_cpus=2 num_gpus=0, a GPU node (num_gpus=1) "
          "and a CPU node (num_gpus=0)",
          "stages_s": stages,
          "actor": {**actor_held, "node": actor_info["node"],
                    "gpu_ids": actor_info["gpu_ids"],
                    "times": actor_times},
          "timeline_method_events": len(method_events),
          "summary": {key: summary[key]}, **drivers_out,
          "cli_start": started.strip().splitlines()[:2],
          "atol": 1e-3, "launches": {k: v for k, v in launches.items() if v},
          "seconds": time.perf_counter() - t_phase,
          "card": card_line() if gpus else "no card"})
    return launches


# -------------------------------------------------------------------- ops --
# The dashboard, a job and the autoscaler on a cluster without the card:
# the job's GPU task waits until the monitor launches a GPU node, runs
# GPT-2 124M's forward there and reports a digest of its logits through
# the job's log; the idle node is then drained and terminated.  Then the
# cluster launcher's up and down on a local-provider YAML.
OPS_NODE_TYPE = {"CPU": 2, "GPU": 1}
OPS_IDLE_TIMEOUT_S = 3.0  # the autoscaler's idle timeout
OPS_QUIET_S = 3.0  # the policy's quiet edge before a scale-down
OPS_LIMIT_S = 120.0
OPS_JOB_SCRIPT = os.path.join("scripts", "gpt2_job_torch.py")
OPS_UP_YAML = """\
cluster_name: chip-smoke-ops
provider: {type: local}
min_workers: 1
max_workers: 1
head_node: {resources: {CPU: 2}}
worker_nodes: {resources: {CPU: 2}}
"""
_PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="([^"\\]|'
    r'\\.)*",?)*\})? ([+-]?[0-9.]+([eE][+-]?[0-9]+)?|[+-]?[Ii]nf|'
    r'[Nn]a[Nn])$')


def prometheus_samples(text):
    """{metric name: samples} of Prometheus text exposition; raises on
    a line that is neither a comment nor a sample."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        assert _PROM_LINE.match(line), f"not Prometheus text: {line!r}"
        name = re.match(r"[a-zA-Z_:][a-zA-Z0-9_:]*", line).group(0)
        out[name] = out.get(name, 0) + 1
    return out


def tensor_sha256(t):
    """The sha256 of ``t``'s bytes as f32 on the host."""
    import hashlib
    return hashlib.sha256(
        memoryview(t.float().cpu().numpy()).cast("B")).hexdigest()


def logits_digest(logits):
    """What the job's task reports of its logits: the sha256 of the f32
    bytes and each sequence's last-position row."""
    logits = logits.float().cpu()
    return tensor_sha256(logits), logits[:, -1, :].contiguous()


def _get_json(url, timeout=30):
    import urllib.request
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _poll(fn, timeout, what, period=0.25):
    """fn()'s first truthy value within ``timeout`` seconds."""
    deadline = time.monotonic() + timeout
    while True:
        got = fn()
        if got:
            return got
        if time.monotonic() > deadline:
            raise TimeoutError(f"{what} after {timeout:.0f} s")
        time.sleep(period)


def _session_processes(root):
    """Live processes whose command line names a path under ``root``."""
    import psutil
    out = []
    for proc in psutil.process_iter(["pid", "cmdline"]):
        try:
            if any(root in a for a in proc.info["cmdline"] or []):
                out.append(proc.pid)
        except (psutil.NoSuchProcess, psutil.AccessDenied):
            continue
    return out


def ops_up_down(tmp, stages):
    """The CLI's ``up`` on a local-provider YAML (a CPU head, one CPU
    worker), a driver that reaches both nodes, then ``down``: no process
    of the cluster's sessions may be left."""
    root = os.path.join(tmp, "launcher")
    os.makedirs(root)
    config = os.path.join(tmp, "cluster.yaml")
    with open(config, "w") as f:
        f.write(OPS_UP_YAML)
    env = {"RAY_TPU_TORCH_SESSION_ROOT": root}
    t0 = time.perf_counter()
    up = _cluster_cli("up", config, env=env)
    stages["up_s"] = time.perf_counter() - t0
    try:
        with open(os.path.join(root, "cluster-chip-smoke-ops.json")) as f:
            state = json.load(f)
        t0 = time.perf_counter()
        code = ("import json, time, ray_tpu_torch as rt\n"
                f"rt.init(address={state['head']['gcs_address']!r})\n"
                "deadline = time.time() + 60\n"
                "while len(rt.nodes()) < 2 and time.time() < deadline:\n"
                "    time.sleep(0.25)\n"
                "@rt.remote(num_cpus=2)\n"
                "def where():\n"
                "    return rt.get_runtime_context().get_node_id()\n"
                "nodes = sorted(set(rt.get([where.remote() for _ in "
                "range(8)], timeout=120)))\n"
                "print('UP ' + json.dumps({'nodes': len(rt.nodes()), "
                "'ran_on': len(nodes), 'resources': "
                "rt.cluster_resources()}), flush=True)\n"
                "rt.shutdown()\n")
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=180,
                             cwd=_repo_root(), env={**os.environ, **env})
        assert out.returncode == 0, (out.stdout[-3000:], out.stderr[-3000:])
        driver = json.loads([ln for ln in out.stdout.splitlines()
                             if ln.startswith("UP ")][-1][3:])
        stages["up_driver_s"] = time.perf_counter() - t0
    finally:
        t0 = time.perf_counter()
        down = _cluster_cli("down", config, env=env)
        stages["down_s"] = time.perf_counter() - t0
    assert driver["nodes"] == 2, driver
    # the YAML's resources exactly: the nodes leave the card alone
    assert driver["resources"].get("CPU") == 4.0, driver
    assert not driver["resources"].get("GPU"), driver
    t0 = time.perf_counter()
    left = []
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        left = _session_processes(root)
        if not left:
            break
        time.sleep(0.25)
    assert not left, f"processes left after down: {left}"
    stages["down_clean_s"] = time.perf_counter() - t0
    return {"up": up.strip().splitlines(), "down": down.strip().splitlines(),
            "driver": driver, "head_pids": state["head"]["pids"],
            "worker_pids": [w["pids"] for w in state["workers"]]}


def phase_ops(preset=CLUSTER_PRESET, device="cuda"):
    """The dashboard, job submission, the autoscaler and the cluster
    launcher on the card (phase 27 above).  Returns the job task's
    launches.  ``device="cpu"`` (and a smaller ``preset``) rehearses it
    without a card: the node type's "GPU" is then a label."""
    import base64
    import shutil
    import tempfile
    import ray_tpu_torch as rt
    from ray_tpu_torch.autoscaler import (AutoscalerMonitor,
                                          FakeMultiNodeProvider,
                                          NodeTypeConfig, StandardAutoscaler)
    from ray_tpu_torch.autoscaler.policy import PolicyConfig, ScalingPolicy
    from ray_tpu_torch.cluster_utils import Cluster
    from ray_tpu_torch.dashboard import Dashboard
    from ray_tpu_torch.job import JobSubmissionClient

    t_phase = time.perf_counter()
    stages = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ops_")
    cluster = dash = monitor = None
    launched, terminated = [], []
    try:
        t0 = time.perf_counter()
        cluster = Cluster(initialize_head=True,
                          head_node_args={"num_cpus": 2, "num_gpus": 0})
        cluster.connect()
        cluster.wait_for_nodes()
        assert not rt.cluster_resources().get("GPU"), rt.cluster_resources()
        gcs = "{}:{}".format(*cluster.gcs_address)
        stages["cluster_up_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        dash = Dashboard(port=0)
        url = dash.start()
        provider = FakeMultiNodeProvider(
            cluster, {"gpu_worker": {"resources": dict(OPS_NODE_TYPE)}})
        create, terminate = provider.create_node, provider.terminate_node

        def counted_create(node_config, tags, count):
            launched.append((tags.get("node-type"), count, time.time()))
            create(node_config, tags, count)

        def counted_terminate(node_id):
            terminated.append((node_id, time.time()))
            terminate(node_id)

        provider.create_node = counted_create
        provider.terminate_node = counted_terminate
        autoscaler = StandardAutoscaler(
            provider, {"gpu_worker": NodeTypeConfig(
                resources=dict(OPS_NODE_TYPE), max_workers=1)},
            idle_timeout_s=OPS_IDLE_TIMEOUT_S)
        monitor = AutoscalerMonitor(
            autoscaler, policy=ScalingPolicy(PolicyConfig(
                down_for_s=OPS_QUIET_S)), update_interval_s=0.5)
        monitor.start()
        stages["control_plane_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        t_submit = time.time()
        client = JobSubmissionClient(url)
        script = os.path.join(_repo_root(), OPS_JOB_SCRIPT)
        sid = client.submit_job(
            entrypoint=f"{sys.executable} {script} --preset {preset} "
            f"--seed {SEED} --batch {CLUSTER_SHAPE[0]} "
            f"--seq {CLUSTER_SHAPE[1]} --device {device}",
            metadata={"phase": "ops"})
        stages["submit_s"] = time.perf_counter() - t0

        # the in-process reference while the job waits for its node
        t0 = time.perf_counter()
        weights, tokens = cluster_weights(preset)
        ref, _, _ = cluster_forward(weights, tokens, preset, device)
        ref_sha, ref_last = logits_digest(ref)
        ref_shape = list(ref.shape)
        del ref, weights
        stages["reference_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        status = _poll(lambda: (lambda s: s if s in ("SUCCEEDED", "FAILED",
                                                     "STOPPED") else None)(
            client.get_job_status(sid)), 300, f"job {sid} not finished")
        t_done = time.time()
        logs = client.get_job_logs(sid)
        assert status == "SUCCEEDED", (status, logs[-4000:])
        stages["job_wait_s"] = time.perf_counter() - t0
        line = [ln for ln in logs.splitlines() if ln.startswith("GPT2_JOB ")]
        assert line, logs[-4000:]
        job = json.loads(line[-1].split(" ", 1)[1])
        last = torch.frombuffer(bytearray(base64.b64decode(
            job.pop("last_rows_f32_b64"))), dtype=torch.float32).reshape(
                ref_last.shape)
        assert job["shape"] == ref_shape and job["finite"], job
        bitwise = job["sha256"] == ref_sha and torch.equal(last, ref_last)
        assert bitwise, (job["sha256"], ref_sha, max_err(last, ref_last))

        # exactly one GPU node launched, and the task ran on it
        assert [(t, n) for t, n, _ in launched] == [("gpu_worker", 1)], \
            launched
        nodes = _get_json(url + "/api/nodes")
        gpu_rows = [n for n in nodes if n["node_id"] == job["node"]]
        assert gpu_rows and gpu_rows[0]["state"] == "ALIVE", nodes
        assert gpu_rows[0]["resources_total"].get("GPU") == 1.0, gpu_rows
        head_id = cluster.head.node_id_hex
        assert job["node"] != head_id, (job["node"], head_id)
        if device == "cuda":
            assert job["gpu_ids"] and \
                job["device"] == torch.cuda.get_device_name(0), job
            assert job["launches"] == {
                "flash_attention_fwd.launches":
                    _gpt2_config(preset).num_layers}, job["launches"]
        else:
            assert job["launches"] == {}, job["launches"]

        t0 = time.perf_counter()

        def agent_rows():
            rows = _get_json(url + "/api/node_stats")
            live = [r for r in rows if r.get("state") == "ALIVE"]
            return rows if live and len(live) == 2 and all(
                r.get("source") == "agent" for r in live) else None

        stats = _poll(agent_rows, 30, "no agent row for every live node")
        jobs = _get_json(url + "/api/jobs/")
        assert any(j["submission_id"] == sid and j["status"] == "SUCCEEDED"
                   for j in jobs), jobs

        def scrape():
            import urllib.request
            with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
                text = r.read().decode()
            samples = prometheus_samples(text)
            return samples if "ray_tpu_autoscaler_decisions_total" in \
                samples else None

        samples = _poll(scrape, 30, "no ray_tpu_autoscaler_decisions_total",
                        period=1.0)
        cli_env = {"RAY_TPU_TORCH_SESSION_ROOT": os.path.join(tmp, "cli")}
        status_out = _cluster_cli("status", "--address", gcs, env=cli_env)
        assert "GPU" in status_out, status_out
        nodes_out = _cluster_cli("nodes", "--address", gcs, env=cli_env)
        decision = [ln for ln in nodes_out.splitlines()
                    if ln.startswith("autoscaler: ")]
        assert decision and "no decision recorded" not in decision[0], \
            nodes_out
        stages["dashboard_checks_s"] = time.perf_counter() - t0

        # the idle node drained through the GCS, then terminated
        t0 = time.perf_counter()
        _poll(lambda: not provider.non_terminated_nodes({}), 90,
              "the idle GPU node was not terminated")
        stages["scale_down_s"] = time.perf_counter() - t0
        assert monitor.drains_completed == 1 and \
            monitor.drains_aborted == 0, (monitor.drains_completed,
                                          monitor.drains_aborted)
        assert len(terminated) == 1, terminated
        after = {n["node_id"]: n["state"]
                 for n in _get_json(url + "/api/nodes")}
        monitor.stop()
        monitor_decision = monitor.last_decision.to_dict()
        monitor = None

        t0 = time.perf_counter()
        dash.stop()
        dash = None
        rt.shutdown()
        cluster.shutdown()
        cluster = None
        stages["cluster_down_s"] = time.perf_counter() - t0

        up_down = ops_up_down(tmp, stages)
    finally:
        if monitor is not None:
            monitor.stop()
        if dash is not None:
            dash.stop()
        if cluster is not None:
            rt.shutdown()
            cluster.shutdown()
        shutil.rmtree(tmp, ignore_errors=True)
    seconds = time.perf_counter() - t_phase
    assert seconds < OPS_LIMIT_S, f"phase ops took {seconds:.1f} s"

    per_forward = {**_flash_per(0), "rmsnorm": 0}
    if device == "cuda":
        per_forward = {**_flash_per(
            _gpt2_config(preset).num_layers, bwd=0), "rmsnorm": 0}
    emit({"phase": "ops", "ok": True,
          "config": f"{preset} ({CLUSTER_SHAPE[0]} x {CLUSTER_SHAPE[1]} "
          "tokens, bf16 compute, f32 masters, random from a seed) in a "
          "job's num_gpus=1 task; Cluster head num_cpus=2 num_gpus=0; "
          f"node type gpu_worker {OPS_NODE_TYPE} max_workers 1, idle "
          f"timeout {OPS_IDLE_TIMEOUT_S} s, quiet edge {OPS_QUIET_S} s",
          "stages_s": stages, "job": {
              "submission_id": sid, "status": status, "bitwise": bitwise,
              "sha256": job["sha256"], "node": job["node"],
              "gpu_ids": job["gpu_ids"], "device": job["device"],
              "task_times": job["times"], "driver_s": job["driver_s"],
              "submit_to_done_s": t_done - t_submit,
              "submit_to_launch_s": launched[0][2] - t_submit},
          "launched": [(t, n) for t, n, _ in launched],
          "terminated": len(terminated),
          "drains_completed": 1, "node_states_after": after,
          "node_stats_sources": sorted(
              {r.get("source") or "" for r in stats}),
          "metrics_samples": len(samples),
          "decision": decision[0], "last_decision": monitor_decision,
          "up_down": up_down, "launches": job["launches"],
          "seconds": seconds,
          "card": card_line() if device == "cuda" else "no card"})
    return per_forward


WORKFLOW_SCRIPT = os.path.join("scripts", "gpt2_workflow_torch.py")
WORKFLOW_ID = "chip-smoke-gpt2"
WORKFLOW_LIMIT_S = 90.0
WORKFLOW_DRIVER_TIMEOUT_S = 300
WORKFLOW_CLEAN_S = 60.0  # the killed driver's cluster must be gone by then


def _workflow_driver(mode, tmp, preset, device, *extra):
    """One driver of scripts/gpt2_workflow_torch.py, in a session root of
    its own (``tmp/sessions_<mode>``): its exit code, output and root."""
    root = os.path.join(tmp, f"sessions_{mode}")
    os.makedirs(root)
    out = subprocess.run(
        [sys.executable, os.path.join(_repo_root(), WORKFLOW_SCRIPT), mode,
         "--storage", os.path.join(tmp, "store"), "--workflow-id",
         WORKFLOW_ID, "--counts", os.path.join(tmp, "counts"),
         "--preset", preset, "--seed", str(SEED),
         "--batch", str(CLUSTER_SHAPE[0]), "--seq", str(CLUSTER_SHAPE[1]),
         "--device", device, *extra],
        capture_output=True, text=True, cwd=_repo_root(),
        timeout=WORKFLOW_DRIVER_TIMEOUT_S,
        env={**os.environ, "RAY_TPU_TORCH_SESSION_ROOT": root})
    return out, root


def _alive(tree):
    """The pids of ``tree`` ([pid, start time] pairs) still running: a
    zombie, which holds no memory, counts as gone."""
    import psutil
    out = []
    for pid, created in tree:
        try:
            proc = psutil.Process(pid)
            if proc.create_time() == created \
                    and proc.status() != psutil.STATUS_ZOMBIE:
                out.append(pid)
        except psutil.NoSuchProcess:
            continue
    return out


def _step_counts(tmp):
    counts = os.path.join(tmp, "counts")
    return {name: len(open(os.path.join(counts, name)).read())
            for name in sorted(os.listdir(counts))}


def phase_workflow(preset=CLUSTER_PRESET, device="cuda"):
    """A durable workflow on the card that survives a killed driver
    (phase 28 above).  Returns its GPU step's launches.  ``device="cpu"``
    (and a smaller ``preset``) rehearses it without a card: "GPU" is then
    a label, and the card's memory is not read."""
    import shutil
    import tempfile
    from ray_tpu_torch import workflow

    t_phase = time.perf_counter()
    stages = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_workflow_")
    try:
        # the in-process reference first, so this process's memory on the
        # card stays as it is while the drivers run
        t0 = time.perf_counter()
        weights, tokens = cluster_weights(preset)
        ref, ref_launches, _ = cluster_forward(weights, tokens, preset,
                                               device)
        ref_sha, ref_last = logits_digest(ref)
        ref_last = ref_last.to(device)
        del ref, weights
        _free()
        stages["reference_s"] = time.perf_counter() - t0

        def card_free():
            return torch.cuda.mem_get_info()[0] if device == "cuda" else 0

        free_before = card_free()
        t0 = time.perf_counter()
        first, root = _workflow_driver("run", tmp, preset, device,
                                       "--exit-at-event")
        waiting = [ln for ln in first.stdout.splitlines()
                   if ln.startswith("WORKFLOW_WAITING ")]
        assert first.returncode == 9 and waiting, \
            (first.returncode, first.stdout[-3000:], first.stderr[-3000:])
        tree = json.loads(waiting[-1].split(" ", 1)[1])["tree"]
        assert tree, "the killed driver had no cluster of its own"
        stages["first_driver_s"] = time.perf_counter() - t0

        # the killed driver's head, raylet and workers went with it, and
        # the card's memory is back to what it was
        t0 = time.perf_counter()
        _poll(lambda: not (_alive(tree) or _session_processes(root)),
              WORKFLOW_CLEAN_S, "the killed driver's processes remain")
        try:
            _poll(lambda: card_free() == free_before, WORKFLOW_CLEAN_S,
                  "card memory")
        except TimeoutError:
            raise AssertionError(
                f"the card's free memory is not back after the kill: "
                f"{free_before} bytes before, {card_free()} now") from None
        free_after_kill = card_free()
        stages["killed_cluster_gone_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        workflow.init(os.path.join(tmp, "store"))
        status_killed = workflow.get_status(WORKFLOW_ID)
        assert status_killed == workflow.RUNNING, status_killed
        counts_killed = _step_counts(tmp)
        assert counts_killed == {"draw_tokens": 1, "gpt2_forward": 1}, \
            counts_killed
        # step 2's stored output reloads here, on this process's card
        stored = workflow.WorkflowStorage(WORKFLOW_ID).load_step(
            "0001_gpt2_forward")
        assert stored["last"].device.type == device, stored["last"].device
        assert torch.equal(stored["last"], ref_last)
        assert stored["sha256"] == ref_sha
        del stored
        stages["storage_checks_s"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        second, root2 = _workflow_driver("resume", tmp, preset, device)
        assert second.returncode == 0, (second.stdout[-3000:],
                                        second.stderr[-3000:])
        line = [ln for ln in second.stdout.splitlines()
                if ln.startswith("WORKFLOW ")]
        assert line, second.stdout[-3000:]
        report = json.loads(line[-1].split(" ", 1)[1])
        stages["resume_driver_s"] = time.perf_counter() - t0
        _poll(lambda: not _session_processes(root2), WORKFLOW_CLEAN_S,
              "the resumed driver's processes remain")
        counts = _step_counts(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    out = report["output"]
    # steps 1 and 2 ran once in all; step 4 and its continuation once
    assert counts == {"draw_tokens": 1, "gpt2_forward": 1, "finish": 1,
                      "digest_on_card": 1}, counts
    assert report["status"] == workflow.SUCCEEDED, report
    listed = [r["status"] for r in report["listed"]]
    assert listed == [workflow.SUCCEEDED], report["listed"]
    assert report["actor_status"] == workflow.SUCCEEDED, report
    assert out["shape"] == [*CLUSTER_SHAPE, ref_last.shape[-1]] \
        and out["finite"], out
    assert out["sha256"] == ref_sha, (out["sha256"], ref_sha)
    assert out["last_sha256"] == tensor_sha256(ref_last), out["last_sha256"]
    assert out["last_sum_f64"] == ref_last.double().sum().item(), out
    assert out["last_device"].split(":")[0] == device, out
    assert out["event"] is not None, out
    layers = _gpt2_config(preset).num_layers
    if device == "cuda":
        assert out["gpu_ids"] and out["digest_gpu_ids"], out
        assert out["launches"] == {
            "flash_attention_fwd.launches": layers}, out["launches"]
        assert ref_launches["flash_fwd"] == layers, ref_launches
    else:
        assert out["launches"] == {}, out["launches"]
    seconds = time.perf_counter() - t_phase
    assert seconds < WORKFLOW_LIMIT_S, \
        f"phase workflow took {seconds:.1f} s"
    emit({"phase": "workflow", "ok": True,
          "config": f"{preset} ({CLUSTER_SHAPE[0]} x {CLUSTER_SHAPE[1]} "
          "tokens, bf16 compute, f32 masters, random from a seed) in a "
          "durable workflow's num_gpus=1 step; each driver "
          "init(num_cpus=2, num_gpus=1); the first os._exit(9) at the "
          "event, the second delivers it and resumes",
          "stages_s": stages, "status_after_kill": status_killed,
          "counts_after_kill": counts_killed, "counts": counts,
          "card_free_bytes": {"before": free_before,
                              "after_kill": free_after_kill},
          "status": report["status"],
          "actor_status": report["actor_status"],
          "sha256": out["sha256"], "bitwise": True,
          "forward_times": out["times"], "launches": out["launches"],
          "killed_driver_processes": len(tree),
          "resume_driver_s": report["driver_s"], "seconds": seconds,
          "card": card_line() if device == "cuda" else "no card"})
    if device == "cuda":
        return {**_flash_per(layers, bwd=0), "rmsnorm": 0}
    return {**_flash_per(0), "rmsnorm": 0}


def _gpt2_config(preset):
    from ray_tpu_torch.models.gpt2 import GPT2Config
    return getattr(GPT2Config, preset)()


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
    t_start = time.perf_counter()
    seconds = {}

    def timed(name, run, *args, **kwargs):
        """Run one phase and keep its seconds for the timing line."""
        t0 = time.perf_counter()
        out = run(*args, **kwargs)
        seconds[name] = time.perf_counter() - t0
        return out

    usage = timed("build", phase_build)
    cases = timed("kernels", phase_kernels)
    timed("model_parity", phase_model_parity)
    _free()
    serve = timed("serve", phase_serve)
    _free()
    timed("train_parity", phase_train_parity)
    train = timed("train", phase_train)
    _free()
    timed("train_parity_xl", phase_train_parity, "gpt2_xl", hm=True,
          phase="train_parity_xl")
    _free()
    train_xl = timed("train_xl", phase_train, "gpt2_xl", batch=8,
                     steps=XL_STEPS, hm=True, loss_drop=XL_LOSS_DROP,
                     phase="train_xl", with_head_cost=False)
    _free()
    timed("vit_parity", phase_vit_parity)
    _free()
    vit = timed("vit", phase_vit)
    _free()
    timed("moe_parity", phase_moe_parity)
    _free()
    moe = timed("moe", phase_moe)
    _free()
    timed("resnet_parity", phase_resnet_parity)
    _free()
    resnet = timed("resnet", phase_resnet)
    _free()
    timed("tiny_parity", phase_tiny_parity)
    _free()
    head_dims = timed("head_dims", phase_head_dim_parity)
    _free()
    runtime = timed("runtime", phase_runtime)
    _free()
    train_gang = timed("train_gang", phase_train_gang)
    _free()
    serve_batching = timed("serve_batching", phase_serve_batching)
    _free()
    long_context = timed("long_context", phase_long_context)
    _free()
    seq_parallel = timed("seq_parallel", phase_seq_parallel)
    _free()
    sharded = timed("sharded", phase_sharded)
    _free()
    rl = timed("rl", phase_rl)
    _free()
    rl_zoo = timed("rl_zoo", phase_rl_zoo)
    _free()
    tune = timed("tune", phase_tune)
    _free()
    cluster = timed("cluster", phase_cluster)
    _free()
    ops = timed("ops", phase_ops)
    _free()
    wf = timed("workflow", phase_workflow)
    # the runtime, the toy decoder and RL's models launch no kernel of
    # the port
    assert not any(runtime.values()), runtime
    assert not any(serve_batching.values()), serve_batching
    assert not any(rl.values()), rl
    assert not any(rl_zoo.values()), rl_zoo
    # each phase's seconds: the script must end inside its time limit
    emit({"phase": "timing", "phases_s": seconds,
          "total_s": time.perf_counter() - t_start})
    emit(kernel_summary(cases, {"serve": serve, "train": train,
                                "train_xl": train_xl, "vit": vit,
                                "moe": moe, "resnet": resnet,
                                "head_dims": head_dims,
                                "train_gang": train_gang,
                                "long_context": long_context,
                                "seq_parallel": seq_parallel,
                                "sharded": sharded, "rl": rl,
                                "rl_zoo": rl_zoo, "tune": tune,
                                "cluster": cluster, "ops": ops,
                                "workflow": wf}, usage))
    print(card_line(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
