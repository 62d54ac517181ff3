#!/usr/bin/env python3
"""Time the bf16 flash forward in three block orders.

    python3 scripts/compare_flash_block_order_torch.py  # one CUDA GPU, nvcc

The persistent forward kernel (``flash_fwd_bf16_kernel``) walks its work
items, (batch * head, query tile) pairs, by a linear index ``lin`` in the
order of ``work_head_tile_pairs`` (``csrc/flash_common.cuh``: a head's
tiles k and n-1-k on one block, a head's pairs on neighbouring blocks).
This script times the sources as they are and copies (written under
build/ray_tpu_torch/planted/) in which that call reads one of two other
orders of the same index: a head's tiles in order, or every head's last,
longest causal tile first.  Each build runs in a process of its own, in
turns (as is, A, B, B, A, as is), at the forward's main-path shapes:
Llama-2-7B's prefill and GPT-2 124M's (native layout), GPT-2 XL's (head
major), bf16, causal.  One JSON line per (build, shape) with the median
ms of chip_smoke.Timer (30 launches, L2 flushed before each), then the
card's name and power limit.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from check_flash_tolerance_torch import use_patched  # noqa: E402

KEPT = "work_head_tile_pairs"
CALL = "work_head_tile_pairs(lin, n_bh, n_qt)"
OTHERS = {  # order: the (bh, tile) of item lin
    "head_tiles_adjacent": "Work{(int)(lin / n_qt), (int)(lin % n_qt)}",
    "longest_first": "Work{(int)(lin % n_bh), (int)(n_qt - 1 - lin / n_bh)}",
}
SHAPES = (((4, 1024, 32, 128), False), (chip_smoke.GPT2_SHAPE, False),
          (chip_smoke.XL_SHAPE, True))


def run_build(order: str) -> None:
    from ray_tpu_torch.ops.flash_attention import _launch_fwd
    if order != KEPT:
        use_patched(order, "flash_fwd.cu", CALL, OTHERS[order])
    timer = chip_smoke.Timer()
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    for shape, hm in SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        ms = timer(lambda: _launch_fwd(q, k, v, True, shape[-1] ** -0.5,
                                       hm=hm))
        print(json.dumps({"order": order, "as_is": order == KEPT,
                          "shape": list(shape), "head_major": hm,
                          "kernel_ms": ms}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--build":
        run_build(sys.argv[2])
        return 0
    if not torch.cuda.is_available():
        print("compare_flash_block_order_torch: needs a CUDA device",
              file=sys.stderr)
        return 2
    a, b = OTHERS
    for order in (KEPT, a, b, b, a, KEPT):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--build", order], capture_output=True,
                              text=True, cwd=ROOT)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            raise RuntimeError(f"build {order}: exit {proc.returncode}")
        print(proc.stdout, end="", flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
