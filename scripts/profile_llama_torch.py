#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's Llama-2-7B serving path.

    python3 scripts/profile_llama_torch.py     # one CUDA GPU, nvcc

Full Llama-2-7B (32 layers, bf16, random weights from seed 0), 4
requests x 1024 prompt tokens.  Prints one JSON line for each of:

* ``profile``: the score forward (cacheless path: flash kernel) and one
  decode step through a 1088-slot KV cache.  Wall time is the median of
  5 unprofiled runs (host clock around a synchronised call); device busy
  time is the sum of CUDA kernel times from one ``torch.profiler`` run,
  grouped by kind; the idle share is 1 - busy / wall.
* ``divergence``: the flash path's logits against the KV-cache path's
  (``decode_attention``) on the same prompt, the model cut to its first
  1, 2, 4, ... 32 layers (same weights).  The flash kernel rounds P to
  bf16 before P V, as the TPU kernel does; the cache path keeps P in
  f32.  This measures how that rounding grows with depth.

Then the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ray_tpu_torch.models.llama import Llama, LlamaConfig  # noqa: E402

KINDS = (("flash_fwd", ("flash_fwd",)),
         ("rmsnorm", ("rmsnorm_",)),
         ("dense", ("gemm", "gemv", "nvjet", "xmma", "splitK", "cutlass")),
         ("softmax", ("softmax",)))


def kind_of(name: str) -> str:
    for kind, keys in KINDS:
        if any(k in name for k in keys):
            return kind
    return "elementwise_copy_other"


def wall_ms(fn, runs=5) -> float:
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def device_breakdown(fn) -> dict:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kind, launches = {}, 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            k = kind_of(e.name)
            by_kind[k] = by_kind.get(k, 0.0) + e.time_range.elapsed_us() / 1e3
            launches += 1
    return {"by_kind_ms": by_kind, "kernel_launches": launches,
            "busy_ms": sum(by_kind.values())}


def report(name, fn):
    wall = wall_ms(fn)
    dev = device_breakdown(fn)
    print(json.dumps({"profile": name, "wall_ms": wall, **dev,
                      "idle_share": 1 - dev["busy_ms"] / wall}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile_llama_torch: needs a CUDA device", file=sys.stderr)
        return 2
    batch, prompt, slots = 4, 1024, 1088
    cfg = LlamaConfig.llama2_7b()
    gen = torch.Generator(device="cuda").manual_seed(0)
    model = Llama(cfg, device="cuda", generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (batch, prompt),
                           generator=gen, device="cuda")
    positions = torch.arange(prompt, device="cuda")[None].expand(batch, -1)

    report("score", lambda: model(tokens))
    _, caches = model(tokens, positions, model.init_kv_caches(batch, slots))
    nxt = tokens[:, -1:]
    pos = torch.full((batch, 1), prompt, device="cuda")
    # every call writes slot `prompt` of a new copy of the same caches:
    # the same step each time
    report("decode_step", lambda: model(nxt, pos, caches))

    layers = model.layers
    depth = 1
    while depth <= cfg.num_layers:
        model.layers = layers[:depth]
        flash = model(tokens)
        cached, _ = model(tokens, positions,
                          model.init_kv_caches(batch, slots))
        diff = (flash - cached).abs()
        print(json.dumps({
            "divergence": depth, "max_abs": diff.max().item(),
            "mean_abs": diff.mean().item(),
            "argmax_agreement": (flash.argmax(-1) == cached.argmax(-1))
            .float().mean().item(),
            "max_abs_logit": flash.abs().max().item()}), flush=True)
        depth *= 2
    model.layers = layers
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
