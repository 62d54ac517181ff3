#!/usr/bin/env python3
"""Time the bf16 dQ, dK/dV and RMSNorm kernels of several checkouts in
turns, within one call on one card.

    python3 scripts/compare_kernels_torch.py OTHER [OTHER ...]   # one GPU

Each OTHER is the root of another checkout of the repository: the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists, or a copy of this one with a kernel source changed.  Each checkout
builds its own kernel library (nvcc) into its own build/ and is timed in
a process of its own, in the order OTHER..., this, this, ...OTHER
(reversed), so drift of the card over the call weighs on all alike.
Every run times, with chip_smoke.py's Timer (CUDA events, median of 30
launches, L2 flushed before each), the kernels at the main paths'
shapes: dQ and dK/dV at GPT-2 124M's [32,1024,12,64], Llama width
[4,1024,32,128] (native layout) and GPT-2 XL's [8,1024,25,64]
(head-major), bf16 causal, with SDPA's backward beside them; RMSNorm at
[4096,4096] and [4,4096] bf16 with F.rms_norm and a plain copy of the
same tensor (the card's floor for moving those bytes under this timer).
One JSON line per run and case, then per case the median of each
checkout's runs and its ratio to this one's, then the card's name and
power limit.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BWD_SHAPES = (((32, 1024, 12, 64), False), ((4, 1024, 32, 128), False),
              ((8, 1024, 25, 64), True))
RMSNORM_SHAPES = ((4096, 4096), (4, 4096))


def _chip_smoke():
    """This checkout's chip_smoke.py, whichever package is on the path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def measure(tree: str) -> None:
    """Time ``tree``'s kernels (its ray_tpu_torch first on the path)."""
    sys.path.insert(0, tree)
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from ray_tpu_torch.ops.flash_attention import (
        _launch_dkdv, _launch_dq, attention_delta, flash_attention_fwd,
        flash_attention_hm_fwd)
    from ray_tpu_torch.ops.fused import fused_rmsnorm
    assert os.path.samefile(
        os.path.dirname(sys.modules["ray_tpu_torch"].__file__),
        os.path.join(tree, "ray_tpu_torch"))
    cs = _chip_smoke()
    timer = cs.Timer()
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    for shape, hm in BWD_SHAPES:
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .bfloat16() for _ in range(4))
        scale = shape[-1] ** -0.5
        fwd = flash_attention_hm_fwd if hm else flash_attention_fwd
        out, lse = fwd(q, k, v, causal=True)
        args = (q, k, v, do, lse, attention_delta(out, do), True, scale)
        qt, kt, vt, dot = cs._heads_first(q, k, v, do)
        qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            fwd_ms = timer(sdpa)
            both_ms = timer(lambda: torch.autograd.grad(
                sdpa(), (qt, kt, vt), dot))
        for name, fn in (("dq", _launch_dq), ("dkdv", _launch_dkdv)):
            ms = timer(lambda: fn(*args, hm=hm))
            print(json.dumps({"kernel": name, "shape": list(shape),
                              "head_major": hm, "ms": ms}), flush=True)
        print(json.dumps({"kernel": "sdpa_bwd", "shape": list(shape),
                          "ms": both_ms - fwd_ms}), flush=True)
    for shape in RMSNORM_SHAPES:
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        w = 1 + 0.1 * torch.randn(shape[1], generator=gen, device="cuda")
        w_lib, y = w.bfloat16(), torch.empty_like(x)
        for name, fn in (
                ("rmsnorm", lambda: fused_rmsnorm(x, w, eps=1e-5)),
                ("F.rms_norm", lambda: F.rms_norm(x, (shape[1],), w_lib,
                                                  1e-5)),
                ("copy", lambda: y.copy_(x))):
            print(json.dumps({"kernel": name, "shape": list(shape),
                              "ms": timer(fn)}), flush=True)


def main() -> int:
    args = sys.argv[1:]
    if len(args) == 2 and args[0] == "--measure":
        measure(os.path.abspath(args[1]))
        return 0
    if not args or args[0].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_kernels_torch: needs a CUDA device", file=sys.stderr)
        return 2
    others = [os.path.abspath(a) for a in args]
    order = others + [ROOT, ROOT] + others[::-1]
    rows = []
    for run, tree in enumerate(order):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--measure", tree],
                              capture_output=True, text=True, cwd=tree)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            raise RuntimeError(f"run {run} ({tree}): exit {proc.returncode}")
        label = "this" if tree == ROOT else os.path.relpath(tree, ROOT)
        for line in proc.stdout.splitlines():
            row = {"tree": label, "run": run, **json.loads(line)}
            print(json.dumps(row), flush=True)
            rows.append(row)
    labels = list(dict.fromkeys(r["tree"] for r in rows))
    for key in dict.fromkeys((r["kernel"], tuple(r["shape"])) for r in rows):
        med = {label: statistics.median(
            r["ms"] for r in rows if r["tree"] == label
            and (r["kernel"], tuple(r["shape"])) == key)
            for label in labels}
        print(json.dumps({"kernel": key[0], "shape": list(key[1]),
                          "ms": med, "over_this": {
                              label: ms / med["this"]
                              for label, ms in med.items()}}), flush=True)
    print(_chip_smoke().card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
