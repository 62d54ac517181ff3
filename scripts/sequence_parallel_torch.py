#!/usr/bin/env python3
"""Ring attention, Ulysses and sequence-parallel GPT-2 across real ranks.

    python3 scripts/sequence_parallel_torch.py          # 4 CUDA GPUs, NCCL
    python3 scripts/sequence_parallel_torch.py --cpu    # 4 gloo processes

Starts one process per rank (a process group at a free localhost port)
and a ``build_mesh(MeshConfig(sp=4))``.  Every rank makes the same global
inputs from one seed and holds its own chunk of the sequence:

1. ``ring_attention`` (the kernel ring on the chunk mode) and
   ``ulysses_attention``, forward and backward, causal, against the
   whole-sequence ``flash_attention`` that each rank also computes, row
   by row (``chip_smoke.row_scaled_err`` at ``chip_smoke.ROW_TOL``);
2. GPT-2 (124M on the card, ``tiny`` on the CPU) trained for a warm-up
   and ``STEPS`` AdamW steps with ``attn_impl`` "ring" and "ulysses" on
   the 4 ranks' chunks of one sequence, its losses against rank 0's
   single-device ``attn_impl="flash"`` run on the whole sequence.

On the card the sequence is 32768 tokens (8192 a rank), bf16; on the CPU
256 tokens in f32 (the kernels' plain versions).  One JSON line per
part from rank 0 (errors reduced to their maximum over the ranks; step
ms and tokens/s on the card), then, on the card, the card's name and
power limit.  Exits nonzero if a check fails.
"""

from __future__ import annotations

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
# GPT-2's losses against the single-device run: the ring rounds its merged
# f32 output to bf16 once where the flash kernel rounds its one pass, so
# the attention outputs differ at bf16's rounding (0.03 of a row's RMS in
# chip_smoke's seq_parallel); f32 on the CPU differs in summation order
LOSS_RTOL = {"cuda": 1e-2, "cpu": 1e-5}
# attention, row-scaled: the card at chip_smoke's bf16 limit; the CPU's
# plain ring against plain attention in f32, two summation orders, where
# causal dQ's first row (exactly 0) is held at 1% of the tensor's RMS
# (measured 1.3e-4 there, 5e-6 elsewhere)
ROW_TOL = {"cuda": chip_smoke.ROW_TOL[torch.bfloat16], "cpu": 1e-3}


def _setting(device):
    """(sequence, heads and head_dim, dtype, GPT-2 preset and its
    keywords) per device; Ulysses needs the heads to divide by RANKS."""
    if device == "cuda":
        return 32768, (12, 64), torch.bfloat16, ("gpt2_small", {})
    return 256, (4, 16), torch.float32, ("tiny", {"num_heads": 4})


def _sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def _attention(rank, device, dev, mesh):
    from ray_tpu_torch.ops.flash_attention import flash_attention
    from ray_tpu_torch.parallel import ring_attention, ulysses_attention
    seq, (heads, dim), dtype, _ = _setting(device)
    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    q, k, v, g = (torch.randn((1, seq, heads, dim), generator=gen)
                  .to(dev, dtype) for _ in range(4))
    qf, kf, vf = (x.clone().requires_grad_() for x in (q, k, v))
    ref = flash_attention(qf, kf, vf, causal=True)
    refs = (ref, *torch.autograd.grad(ref, (qf, kf, vf), g))
    chunk = seq // RANKS
    sl = slice(rank * chunk, (rank + 1) * chunk)
    errs = {}
    for name, fn in (("ring", ring_attention),
                     ("ulysses", ulysses_attention)):
        qs, ks, vs = (x[:, sl].clone().requires_grad_() for x in (q, k, v))
        out = fn(qs, ks, vs, causal=True, mesh=mesh)
        got = (out, *torch.autograd.grad(out, (qs, ks, vs), g[:, sl]))
        for label, a, r in zip(("O", "dq", "dk", "dv"), got, refs):
            e = torch.tensor(chip_smoke.row_scaled_err(a, r[:, sl]),
                             device=dev)
            dist.all_reduce(e, op=dist.ReduceOp.MAX)
            errs[f"{name}_{label}_row_scaled_err"] = e.item()
    tol = ROW_TOL[device]
    assert all(e <= tol for e in errs.values()), errs
    return {"part": "attention", "shape": [1, seq, heads, dim],
            "dtype": str(dtype), "row_tol": tol, **errs}


def _train(impl, device, dev, mesh, tokens_of):
    """Losses and step ms of GPT-2 through ``attn_impl=impl`` on this
    rank's tokens (``tokens_of(cfg, gen)``)."""
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config, adamw, train_step
    from ray_tpu_torch.parallel import use_mesh
    seq, _, dtype, (preset, kw) = _setting(device)
    cfg = getattr(GPT2Config, preset)(max_seq_len=seq, attn_impl=impl,
                                      dtype=dtype, **kw)
    gen = torch.Generator(device=dev).manual_seed(chip_smoke.SEED)
    model = GPT2(cfg, device=dev, generator=gen)
    tokens = tokens_of(cfg, gen)
    opt = adamw(model.parameters())
    losses = []
    with use_mesh(mesh):
        for i in range(STEPS + 1):
            if i == 1:
                _sync(device)
                t0 = time.perf_counter()
            losses.append(train_step(model, opt, tokens).item())
        _sync(device)
    return losses, (time.perf_counter() - t0) / STEPS * 1e3


def _worker(rank, device, port, out):
    dev = torch.device("cuda", rank) if device == "cuda" else torch.device(
        "cpu")
    if device == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{port}",
                            world_size=RANKS, rank=rank)
    try:
        from ray_tpu_torch.parallel import MeshConfig, build_mesh
        mesh = build_mesh(MeshConfig(sp=RANKS), device=device)
        lines = [_attention(rank, device, dev, mesh)]
        seq = _setting(device)[0]
        chunk = seq // RANKS

        def whole(cfg, gen):
            return torch.randint(0, cfg.vocab_size, (1, seq), generator=gen,
                                 device=dev)

        def mine(cfg, gen):
            return whole(cfg, gen)[:, rank * chunk:(rank + 1) * chunk]

        flash = _train("flash", device, dev, None, whole) if rank == 0 \
            else None
        for impl in ("ring", "ulysses"):
            losses, step_ms = _train(impl, device, dev, mesh, mine)
            line = {"part": f"gpt2_{impl}", "ranks": RANKS,
                    "tokens": [1, seq], "losses": losses,
                    "step_ms": step_ms}
            if rank == 0:
                rel = max(abs(a - b) / abs(b)
                          for a, b in zip(losses, flash[0]))
                line.update({"flash_losses": flash[0],
                             "flash_step_ms": flash[1],
                             "loss_max_rel_diff": rel,
                             "loss_rtol": LOSS_RTOL[device]})
                if device == "cuda":
                    line["tokens_per_s"] = seq / (step_ms / 1e3)
                    line["flash_tokens_per_s"] = seq / (flash[1] / 1e3)
                assert all(map(math.isfinite, losses)), losses
                assert rel <= LOSS_RTOL[device], line
            lines.append(line)
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
            print(f"sequence_parallel_torch: needs {RANKS} CUDA GPUs "
                  "(or --cpu)", file=sys.stderr)
            return 2
        from ray_tpu_torch.ops import _build
        _build.build()  # once, before the ranks load it
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       os.pardir, "build", "sequence_parallel.jsonl")
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
