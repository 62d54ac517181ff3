#!/usr/bin/env python3
"""Time the bf16 dQ, dK/dV and RMSNorm kernels and the head-major
forward above head_dim 512 (bf16) and 128 (f32) of several checkouts in
turns, within one call on one card.

    python3 scripts/compare_kernels_torch.py OTHER [OTHER ...]   # one GPU

Each OTHER is the root of another checkout of the repository: the parent
commit, unpacked with ``git archive`` into a directory that .gitignore
lists, or a copy of this one with a kernel source changed; it times the
backward through ``_bwd_inputs``, ``_kernel_dkdv`` and ``_kernel_dq`` of
ray_tpu_torch/ops/flash_attention.py, so each checkout must have them.
Each checkout
builds its own kernel library (nvcc) into its own build/ and is timed in
a process of its own, in the order OTHER..., this, this, ...OTHER
(reversed), so drift of the card over the call weighs on all alike.
Every run times, with chip_smoke.py's Timer (CUDA events, median of 30
launches, L2 flushed before each), the kernels at the main paths'
shapes: dQ and dK/dV at GPT-2 124M's [32,1024,12,64], Llama width
[4,1024,32,128] (native layout) and GPT-2 XL's [8,1024,25,64]
(head-major), and the head-major pair above head_dim 256 at
[2,512,4,1024] and [8,1024,16,512], bf16 causal, with SDPA's backward
beside them (its flash backend where it takes the shape, else PyTorch's
own pick); RMSNorm at
[4096,4096] and [4,4096] bf16 with F.rms_norm and a plain copy of the
same tensor (the card's floor for moving those bytes under this timer);
the head-major forward as its wrapper runs it (``_launch_fwd``, on
whichever kernel the checkout routes it to) at [2,512,4,1024] and
[8,1024,16,1024] bf16 and [2,256,4,d] for d = 160, 256, 512 and 1024
and [8,1024,16,256] f32, causal, with SDPA beside it.  One JSON line per run
and case, then per case the median of each
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
              ((8, 1024, 25, 64), True), ((2, 512, 4, 1024), True),
              ((8, 1024, 16, 512), True))
RMSNORM_SHAPES = ((4096, 4096), (4, 4096))
FWD_SHAPES = (((2, 512, 4, 1024), torch.bfloat16),
              ((8, 1024, 16, 1024), torch.bfloat16),
              ((2, 256, 4, 160), torch.float32),
              ((2, 256, 4, 256), torch.float32),
              ((2, 256, 4, 512), torch.float32),
              ((2, 256, 4, 1024), torch.float32),
              ((8, 1024, 16, 256), torch.float32))


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
        _bwd_inputs, _kernel_dkdv, _kernel_dq, _launch_fwd, attention_delta,
        flash_attention_fwd, flash_attention_hm_fwd)
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
        ins = _bwd_inputs(q, k, v, do, lse, attention_delta(out, do), True,
                          scale, hm)
        # each part's arguments (an older checkout returns one tuple for
        # both)
        ins = dict(zip(("dkdv", "dq"), ins if isinstance(ins[0], tuple)
                       else (ins, ins)))
        qt, kt, vt, dot = cs._heads_first(q, k, v, do)
        qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)

        def sdpa_ms():
            return timer(sdpa), timer(lambda: torch.autograd.grad(
                sdpa(), (qt, kt, vt), dot))

        try:
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                fwd_ms, both_ms = sdpa_ms()
        except RuntimeError as e:  # above head_dim 256
            if "No available kernel" not in str(e):
                raise
            fwd_ms, both_ms = sdpa_ms()
        for name, fn in (("dq", _kernel_dq), ("dkdv", _kernel_dkdv)):
            ms = timer(lambda: fn(*ins[name]))
            print(json.dumps({"kernel": name, "shape": list(shape),
                              "head_major": hm, "ms": ms}), flush=True)
        print(json.dumps({"kernel": "sdpa_bwd", "shape": list(shape),
                          "ms": both_ms - fwd_ms}), flush=True)
        del q, k, v, do, out, lse, ins, qt, kt, vt, dot
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
    for shape, dtype in FWD_SHAPES:
        q, k, v = (torch.randn(shape, generator=gen, device="cuda")
                   .to(dtype) for _ in range(3))
        qt, kt, vt = cs._heads_first(q, k, v)
        dt = str(dtype).replace("torch.", "")
        for name, fn in (
                ("hm_fwd", lambda: _launch_fwd(q, k, v, True,
                                               shape[-1] ** -0.5, hm=True)),
                ("sdpa_fwd", lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=True))):
            print(json.dumps({"kernel": f"{name}_{dt}", "shape": list(shape),
                              "ms": timer(fn)}), flush=True)
        del q, k, v, qt, kt, vt


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
