#!/usr/bin/env python3
"""The sharding presets, pipeline parallelism and expert parallelism
across real ranks: the port's counterpart of ``dryrun_multichip``.

    python3 scripts/sharded_train_torch.py          # 4 CUDA GPUs, NCCL
    python3 scripts/sharded_train_torch.py --cpu    # 4 gloo processes

Starts one process per rank (a process group at a free localhost port).
Every rank makes the same weights and batches from one seed; each part
builds its own ``build_mesh``:

1. GPT-2 at sp = 2 x tp = 2 under SP_RULES with ``attn_impl="ring"``:
   parameters placed as DTensors (``place_module_params``), the batch
   split over the sequence, a warm-up and ``STEPS`` AdamW steps; the
   losses against rank 0's direct step (``attn_impl="flash"``, nothing
   placed) on the same weights and batch.
2. pp = 4 over GPT-2's blocks (``pipeline_apply``, a quarter of the
   blocks a stage, ``MICRO`` microbatches): the output and each rank's
   blocks' gradients against the blocks run in sequence on that rank.
3. The MoE at ep = 4 under EP_RULES (its experts split over the ranks):
   a warm-up and ``STEPS`` steps, the losses against rank 0's direct
   step.

On the card: GPT-2 124M at 8 x 1024 tokens, bf16 compute, f32 masters;
microbatches of 4 x 1024; ``MoEConfig()`` at 8 x 1024.  On the CPU: the
``tiny`` presets in f32 (the kernels' plain versions).  One JSON line per
part from rank 0 (errors reduced to their maximum over the ranks; step
ms on the card), then, on the card, the card's name and power limit.
Exits nonzero if a check fails.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import math
import os
import socket
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402

RANKS = 4
STEPS = 3
MICRO = 8
# the placed steps' losses against the direct step: on the card the
# ring rounds its merged f32 output to bf16 where the flash kernel rounds
# its one pass (scripts/sequence_parallel_torch.py's limit), and the
# MoE's experts and the split vocabulary sum in another order; f32 on the
# CPU differs in summation order only
LOSS_RTOL = {"cuda": 1e-2, "cpu": 1e-4}
# the pipeline against the blocks in sequence, at the largest element of
# each tensor: the same block calls on the same values, the parameters'
# gradients summed over the microbatches in another order
PIPE_REL_TOL = 1e-5


def _setting(device):
    """GPT-2 and MoE configurations and batch shapes per device."""
    from ray_tpu_torch.models.gpt2 import GPT2Config
    from ray_tpu_torch.models.moe import MoEConfig
    if device == "cuda":
        return dict(gpt2=GPT2Config.gpt2_small(), tokens=(8, 1024),
                    micro=(4, 1024), moe=MoEConfig(), moe_tokens=(8, 1024))
    return dict(gpt2=GPT2Config.tiny(dtype=torch.float32, num_layers=4,
                                     num_heads=4),
                tokens=(4, 64), micro=(2, 32),
                moe=MoEConfig.tiny(dtype=torch.float32),
                moe_tokens=(4, 32))


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _max_over_ranks(x: float, dev) -> float:
    t = torch.tensor(x, device=dev, dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.item()


def _steps(model, loss_fn, tokens, device):
    """A warm-up and STEPS AdamW(3e-4, 0.01) steps; (losses, step ms),
    the gradients given their parameters' placements before each
    update."""
    from ray_tpu_torch.models.gpt2 import adamw
    from ray_tpu_torch.parallel.sharding import place_gradients
    opt = adamw(model.parameters(), lr=3e-4, weight_decay=0.01)
    losses = []
    for i in range(STEPS + 1):
        if i == 1:
            _sync(device)
            t0 = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(model, tokens)
        loss.backward()
        place_gradients(model)
        opt.step()
        losses.append(loss.item())
    _sync(device)
    return losses, (time.perf_counter() - t0) / STEPS * 1e3


def _placed_vs_direct(part, rank, device, dev, build, loss_fn, tokens,
                      rules, mesh, axes, direct_build=None):
    """The placed steps on every rank, the direct ones on rank 0."""
    from ray_tpu_torch.parallel import sharding
    model = build()
    sharding.place_module_params(model, rules, mesh)
    placed = sharding.shard_tensor(tokens, rules, mesh, *axes)
    losses, step_ms = _steps(model, loss_fn, placed, device)
    del model
    line = {"part": part, "ranks": RANKS,
            "tokens": list(tokens.shape), "losses": losses,
            "step_ms": step_ms}
    if rank == 0:
        direct, direct_ms = _steps((direct_build or build)(), loss_fn,
                                   tokens, device)
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, direct))
        line.update({"direct_losses": direct, "direct_step_ms": direct_ms,
                     "loss_max_rel_diff": rel,
                     "loss_rtol": LOSS_RTOL[device]})
        assert all(map(math.isfinite, losses)), losses
        assert rel <= LOSS_RTOL[device], line
    return line


def _gpt2_sp_tp(rank, device, dev):
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel import MeshConfig, build_mesh, sharding
    s = _setting(device)
    mesh = build_mesh(MeshConfig(sp=2, tp=2), device=device)
    batch, seq = s["tokens"]
    cfg = dataclasses.replace(s["gpt2"], max_seq_len=seq)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=dev)

    def build(impl):
        return lambda: gpt2.GPT2(
            dataclasses.replace(cfg, attn_impl=impl), device=dev,
            generator=torch.Generator(device=dev).manual_seed(
                chip_smoke.SEED))

    def loss_fn(m, t):
        return gpt2.loss_fn(m, t)

    line = _placed_vs_direct("gpt2_sp2_tp2_ring", rank, device, dev,
                             build("ring"), loss_fn, tokens,
                             sharding.SP_RULES, mesh, ("batch", "seq"),
                             direct_build=build("flash"))
    line["mesh"] = {"sp": 2, "tp": 2}
    return line


def _moe_ep(rank, device, dev):
    from ray_tpu_torch.models import moe
    from ray_tpu_torch.parallel import MeshConfig, build_mesh, sharding
    s = _setting(device)
    mesh = build_mesh(MeshConfig(ep=RANKS), device=device)
    cfg = s["moe"]
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    tokens = torch.randint(0, cfg.vocab_size, s["moe_tokens"],
                           generator=gen, device=dev)
    line = _placed_vs_direct(
        "moe_ep4", rank, device, dev,
        lambda: moe.MoETransformer(cfg, device=dev,
                                   generator=torch.Generator(
                                       device=dev).manual_seed(
                                           chip_smoke.SEED)),
        moe.loss_fn, tokens, sharding.EP_RULES, mesh, ("batch", None))
    line["mesh"] = {"ep": RANKS}
    line["experts_a_rank"] = cfg.num_experts // RANKS
    return line


def _pipeline(rank, device, dev):
    """pp = RANKS over GPT-2's blocks: pipeline_apply's output and this
    rank's blocks' gradients against the blocks in sequence."""
    from torch.func import functional_call
    from ray_tpu_torch.models.gpt2 import GPT2
    from ray_tpu_torch.parallel import (MeshConfig, build_mesh,
                                        pipeline_apply)
    from ray_tpu_torch.parallel.pipeline import stack_block_params
    s = _setting(device)
    mesh = build_mesh(MeshConfig(pp=RANKS), device=device)
    cfg = dataclasses.replace(s["gpt2"], max_seq_len=s["micro"][1])
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    model = GPT2(cfg, device=dev, generator=gen)
    per = cfg.num_layers // RANKS
    stages = [torch.nn.Sequential(*model.h[i * per:(i + 1) * per])
              for i in range(RANKS)]
    stacked = stack_block_params([dict(st.named_parameters())
                                  for st in stages])
    shape = (MICRO, *s["micro"], cfg.embed_dim)
    x, g = (torch.randn(shape, generator=gen, device=dev).to(cfg.dtype)
            for _ in range(2))
    xr = x.clone().requires_grad_()
    _sync(device)
    t0 = time.perf_counter()
    out = pipeline_apply(lambda p, a: functional_call(stages[0], p, (a,)),
                         stacked, xr, mesh=mesh)
    _sync(device)
    fwd_ms = (time.perf_counter() - t0) * 1e3
    mine = list(stages[rank].parameters())
    grads = torch.autograd.grad(out, [xr, *mine], g)
    _sync(device)
    fwd_bwd_ms = (time.perf_counter() - t0) * 1e3
    xs = x.clone().requires_grad_()
    ref = torch.stack([functools.reduce(lambda a, b: b(a), model.h, xs[m])
                       for m in range(MICRO)])
    ref_grads = torch.autograd.grad(ref, [xs, *mine], g)
    errs = {"out": chip_smoke._rel_err(out, ref),
            "dx": chip_smoke._rel_err(grads[0], ref_grads[0]),
            "own_blocks_grads_max": max(
                chip_smoke._rel_err(a, b)
                for a, b in zip(grads[1:], ref_grads[1:]))}
    errs = {k: _max_over_ranks(v, dev) for k, v in errs.items()}
    assert all(e <= PIPE_REL_TOL for e in errs.values()), errs
    return {"part": "gpt2_blocks_pp4", "ranks": RANKS,
            "blocks_a_stage": per, "microbatches": [MICRO, *s["micro"]],
            "forward_ms": fwd_ms, "forward_backward_ms": fwd_bwd_ms,
            "rel_tol": PIPE_REL_TOL, "rel_errs_vs_sequence": errs}


def _worker(rank, device, port, out):
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device(
        "cpu")
    if device == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=RANKS, rank=rank)
    try:
        lines = [_gpt2_sp_tp(rank, device, dev),
                 _pipeline(rank, device, dev),
                 _moe_ep(rank, device, dev)]
        if rank == 0:
            with open(out, "w") as f:
                for line in lines:
                    f.write(json.dumps(line) + "\n")
    finally:
        dist.destroy_process_group()


def main() -> int:
    device = "cpu" if "--cpu" in sys.argv[1:] else "cuda"
    if device == "cuda":
        if torch.cuda.device_count() < RANKS:
            print(f"sharded_train_torch: needs {RANKS} CUDA GPUs "
                  "(or --cpu)", file=sys.stderr)
            return 2
        from ray_tpu_torch.ops import _build
        _build.build()  # once, before the ranks load it
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       os.pardir, "build", "sharded_train.jsonl")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    mp.spawn(_worker, args=(device, port, out), nprocs=RANKS)
    with open(out) as f:
        for line in f:
            print(line.strip(), flush=True)
    if device == "cuda":
        print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
