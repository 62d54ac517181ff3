#!/usr/bin/env python3
"""Check and take apart flash_fma_bwd.cu (the f32 dK/dV and dQ above
head_dim 128) on one card, quicker than chip_smoke.py's kernels phase.

    python3 scripts/fma_bwd_torch.py            # one GPU, nvcc
    python3 scripts/fma_bwd_torch.py --ablate   # one GPU, nvcc

With no argument: build the kernel library, print ptxas's lines for the
f32 kernels (registers, spills), hold the head-major f32 backward against
the plain version (chip_smoke.held_err, per tensor, and max |diff|) at
chip_smoke.py's f32 shapes, at its tile edges (FMA_BWD_EDGE_DIMS x
XBWD_EDGE_LENGTHS and XBWD_CROSS_LENGTHS) and at the ragged shapes of
ROUTED_RAGGED_DIMS, and time dK/dV and dQ (chip_smoke.Timer, 10
launches) at [2,256,4,d] for d = 160, 256, 512, 1024 and at
[8,1024,16,256], with the group width and clusters each launch takes.
One JSON line per case; exits nonzero if a case is over ROW_TOL f32.

With --ablate: copies of this checkout under build/ablate_<name>/ with
one part of flash_fma_bwd.cu removed (unsound: timing only) are timed
against this one by scripts/compare_kernels_torch.py --only f32_bwd, in
turns: ``noscore`` (no score FMAs), ``noacc`` (no accumulations),
``nostage`` (no cp.async staging) and ``nosync`` (no barrier between ring
items).  What each removal saves is what that part costs.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

SRC = os.path.join("ray_tpu_torch", "ops", "csrc", "flash_fma_bwd.cu")
# name: the (text, replacement) pairs of its copy of flash_fma_bwd.cu
ABLATIONS = {
    "noscore": (("      score_chunk(slot, st, dpt);\n", ""),
                ("      score_chunk(slot, s, dp);\n", "")),
    "noacc": (("      accumulate<GC>(t, a % 2 * kBAcc, slot, acc_v);\n"
               "      accumulate<GC>(t + kBT, a % 2 * kBAcc, slot + kBAcc * "
               "GC, acc_k);\n", ""),
              ("      accumulate<GC>(t, a % 2 * kBAcc, slot, acc);\n", "")),
    "nostage": (("    if (it < n_items) {\n", "    if (false) {\n"),),
    "nosync": (("    cp_wait<SM::kStages - 2>();\n    __syncthreads();\n",
                "    cp_wait<SM::kStages - 2>();\n"),),
}
TIMED = tuple(chip_smoke.ROUTED_F32 + (d,) for d in (160, 256, 512, 1024)) \
    + (chip_smoke.F32_BWD_TIMED,)


def check() -> bool:
    import ray_tpu_torch.ops.flash_attention  # noqa: F401
    from ray_tpu_torch.ops import _build
    fa = sys.modules["ray_tpu_torch.ops.flash_attention"]
    _build.load_library()
    keep = False
    for ln in _build.build_log().splitlines():
        if "Compiling" in ln:
            keep = "fma_" in ln
        if keep and ("registers" in ln or "spill" in ln or "Compiling" in ln):
            print(ln.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    timer = chip_smoke.Timer(iters=10, warmup=2)
    tol = chip_smoke.ROW_TOL[torch.float32]
    ok = True

    def case(shape, causal, tk=None, timed=False):
        nonlocal ok
        b, t, h, d = shape
        q, do = (torch.randn(shape, generator=gen, device="cuda")
                 for _ in range(2))
        k, v = (torch.randn((b, tk or t, h, d), generator=gen,
                            device="cuda") for _ in range(2))
        scale = d ** -0.5
        out, lse = fa.flash_attention_hm_fwd(q, k, v, causal=causal)
        grads = fa.flash_attention_hm_bwd(q, k, v, out, lse, do,
                                          causal=causal, scale=scale)
        ref = fa.attention_backward_reference(q, k, v, out, lse, do, causal,
                                              scale)
        res = {"shape": list(shape), "tk": tk, "causal": causal}
        for name, g, r in zip(("dq", "dk", "dv"), grads, ref):
            res[name] = chip_smoke.held_err(name, g, r, causal)
            res[name + "_abs"] = chip_smoke.max_err(g, r)
        res["ok"] = max(res[n] for n in ("dq", "dk", "dv")) <= tol
        ok &= res["ok"]
        if timed:
            ins = fa._bwd_inputs(q, k, v, do, lse, fa.attention_delta(out, do),
                                 causal, scale, True)
            res["dkdv_ms"] = timer(lambda: fa._kernel_dkdv(*ins[0]))
            res["dq_ms"] = timer(lambda: fa._kernel_dq(*ins[1]))
            res["attrs"] = {p: chip_smoke.fma_bwd_attrs(p, shape)
                            for p in ("dkdv", "dq")}
        print(json.dumps(res), flush=True)

    for shape in TIMED:
        for causal in (False, True):
            if causal or shape[1] <= 256:
                case(shape, causal, timed=True)
    for d in chip_smoke.FMA_BWD_EDGE_DIMS:
        for t in chip_smoke.XBWD_EDGE_LENGTHS:
            case((2, t, 3, d), True)
        for tq, tk in chip_smoke.XBWD_CROSS_LENGTHS:
            case((2, tq, 3, d), False, tk=tk)
    for d in chip_smoke.ROUTED_RAGGED_DIMS:
        if d > 128:
            for shape in chip_smoke.ROUTED_RAGGED:
                case(shape + (d,), True)
    return ok


def ablate() -> int:
    trees = []
    for name, subs in ABLATIONS.items():
        tree = os.path.join(ROOT, "build", "ablate_" + name)
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(os.path.join(ROOT, "ray_tpu_torch"),
                        os.path.join(tree, "ray_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"))
        path = os.path.join(tree, SRC)
        with open(path) as f:
            text = f.read()
        for old, new in subs:
            assert old in text, (name, old)
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
        trees.append(tree)
    return subprocess.call([sys.executable, os.path.join(
        ROOT, "scripts", "compare_kernels_torch.py"), "--only", "f32_bwd",
        *trees])


def main() -> int:
    if not torch.cuda.is_available():
        print("fma_bwd_torch: needs a CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1:] == ["--ablate"]:
        return ablate()
    if sys.argv[1:]:
        print(__doc__, file=sys.stderr)
        return 2
    ok = check()
    print(chip_smoke.card_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
