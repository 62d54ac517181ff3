#!/usr/bin/env python3
"""Do chip_smoke.py's limits on the flash kernels catch a kernel that
loses part of a late row?

    python3 scripts/check_flash_tolerance_torch.py     # one CUDA GPU, nvcc

Builds the kernel library from the repository's sources as they are
(``sound``) and from copies with one planted fault each, written under
build/ray_tpu_torch/planted/ (the sources themselves are never touched):

* ``fwd_drop_diag``: the bf16 forward skips the diagonal key tile of
  its last query tile (those 128 queries lose their last 1-128 keys);
* ``dq_drop_diag``: the bf16 dQ kernel does the same at its last
  128-query item (its diagonal tile is 128 keys, 64 at head_dim 128);
* ``dkdv_drop_last``: the bf16 dK/dV kernel skips the last query tile
  (64 queries) of the last key tile (128 keys);
* ``wide_fwd_drop_diag``, ``wide_dkdv_drop_last``: the same faults in
  flash_wide.cu's forward (its diagonal tile is 64 keys) and dK/dV (64
  keys a block, 64 queries a tile), shown at head_dim 256 and 160;
* ``wide_dq_drop_diag``: flash_wide.cu's dQ skips the diagonal key tile
  (64 keys) of its last 64-query block, shown at head_dim 256 and 160;
* ``xwide_fwd_drop_diag``: flash_xwide.cu's forward skips the diagonal
  key tile (32 keys) of its last 64-query tile, shown at head_dim 512
  and 384;
* ``xxwide_fwd_drop_diag``: the same fault in the same source, shown on
  its 1024 and 768 builds (one stage of 32-key tiles, O's columns in
  two groups);
* ``xwide_dkdv_drop_last``: flash_xwide_bwd.cu's dK/dV skips, in the
  last key block (64 keys), the last query tile (32 queries), in every
  block of its cluster; shown at head_dim 512, 384, 1024 and 768;
* ``xwide_dq_drop_diag``: flash_xwide_bwd.cu's dQ skips the diagonal key
  tile (32 keys) of its last 64-query block; shown at the same shapes;
* ``fma_fwd_drop_diag``: flash_fma.cu's f32 forward skips the diagonal
  key tile (64 keys) of its last 64-query tile, shown at head_dim 256 and
  1024 in f32.

Each fault touches the last 64 or 128 positions only, where causal rows
are smallest: the kind of fault a limit scaled to the tensor's max
misses.  Each shortens the tile count that its kernel's producer and
consumers share, so the faulty kernels still run to their end.
Both kernel families (native layout and head-major) launch the same
kernels, so each fault in flash_fwd.cu and flash_bwd.cu is shown through
both: the native family at the GPT-2 124M and Llama shapes, the
head-major one at GPT-2 XL's; flash_wide.cu's at [8, 1024, 16, 256] and
[8, 1024, 16, 160]; flash_xwide.cu's and flash_xwide_bwd.cu's at
[8, 1024, 16, 512] and [8, 1024, 16, 384], and at [2, 512, 4, 1024] and
[2, 512, 4, 768];
flash_fma.cu's at [2, 256, 4, 256] and [2, 256, 4, 1024].

Each build runs in a process of its own (the library loads once per
process).  For each case, one JSON line: the error of O (and LSE), dQ,
dK and dV against the plain version by two measures, max |diff| over
the tensor's max |reference| (``over_max``) and ``row_scaled_err``, the
one chip_smoke.py holds the kernels to (``row``).  The sound build runs
the shapes and dtypes of chip_smoke.py's kernels phase (its grid-limit
cases aside) and the wide shapes; the faulty ones run the causal shapes
of their kernel (bf16, and f32 for flash_fma.cu).
Exits nonzero unless the sound
build meets chip_smoke.ROW_TOL everywhere and every planted fault
exceeds it in the tensor its kernel writes.  Then the card's name and
power limit.
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

# the persistent kernels' key-tile count (the forward's, and dQ's, the
# first in flash_bwd.cu)
KEY_TILES = "return key_tiles(m0, BM, BN, tq, tk, causal);"
DROP_DIAG = KEY_TILES.replace("causal);", "causal) - (m0 + BM >= tq);")
# the dK/dV kernels' query-tile count (flash_bwd.cu, flash_wide.cu,
# flash_xwide_bwd.cu)
DKDV_END = "const int m_end = (tq + BM - 1) / BM;"
DKDV_DROP_LAST = DKDV_END.replace("/ BM;", "/ BM - (n0 + BN >= tk);")
# the key-tile count of the one-block-per-query-tile kernels (flash_wide.cu's
# and flash_xwide_bwd.cu's dQ, flash_xwide.cu's and flash_fma.cu's
# forwards)
N_TILES = "const int n_tiles = key_tiles(m0, BM, BN, tq, tk, causal);"
N_TILES_DROP_DIAG = N_TILES.replace("causal);", "causal) - (m0 + BM >= tq);")
BF16, F32 = torch.bfloat16, torch.float32
# (shape, head-major, dtype): the bf16 causal training shapes of each
# family
TRAIN_SHAPES = ((chip_smoke.GPT2_SHAPE, False, BF16),
                ((4, 1024, 32, 128), False, BF16),
                (chip_smoke.XL_SHAPE, True, BF16))
# flash_wide.cu's two builds (256, and 192 at head_dim 160)
WIDE_SHAPES = tuple((chip_smoke.HEAD_DIM_SHAPE + (d,), True, BF16)
                    for d in (256, 160))
# flash_xwide.cu's builds: 512 and 384, then 1024 and 768
XWIDE_SHAPES = tuple((chip_smoke.HEAD_DIM_SHAPE + (d,), True, BF16)
                     for d in (512, 384))
XXWIDE_SHAPES = tuple((chip_smoke.ROUTED_XXWIDE[:3] + (d,), True, BF16)
                      for d in (1024, 768))
# flash_fma.cu in f32: 256 takes its 64-column groups, 1024 its 256 ones
FMA_SHAPES = tuple((chip_smoke.ROUTED_F32 + (d,), True, F32)
                   for d in (256, 1024))
# name: (source, first occurrence (the bf16 kernel's), replacement, the
# tensors the faulty kernel writes, the shapes it is shown at)
PLANTED = {
    "fwd_drop_diag": ("flash_fwd.cu", KEY_TILES, DROP_DIAG, ("O",),
                      TRAIN_SHAPES),
    "dq_drop_diag": ("flash_bwd.cu", KEY_TILES, DROP_DIAG, ("dq",),
                     TRAIN_SHAPES),
    "dkdv_drop_last": ("flash_bwd.cu", DKDV_END, DKDV_DROP_LAST,
                       ("dk", "dv"), TRAIN_SHAPES),
    "wide_fwd_drop_diag": ("flash_wide.cu", KEY_TILES, DROP_DIAG, ("O",),
                           WIDE_SHAPES),
    "wide_dkdv_drop_last": ("flash_wide.cu", DKDV_END, DKDV_DROP_LAST,
                            ("dk", "dv"), WIDE_SHAPES),
    "wide_dq_drop_diag": ("flash_wide.cu", N_TILES, N_TILES_DROP_DIAG,
                          ("dq",), WIDE_SHAPES),
    "xwide_fwd_drop_diag": ("flash_xwide.cu", N_TILES, N_TILES_DROP_DIAG,
                            ("O",), XWIDE_SHAPES),
    "xxwide_fwd_drop_diag": ("flash_xwide.cu", N_TILES, N_TILES_DROP_DIAG,
                             ("O",), XXWIDE_SHAPES),
    "fma_fwd_drop_diag": ("flash_fma.cu", N_TILES, N_TILES_DROP_DIAG,
                          ("O",), FMA_SHAPES),
    "xwide_dkdv_drop_last": ("flash_xwide_bwd.cu", DKDV_END, DKDV_DROP_LAST,
                             ("dk", "dv"), XWIDE_SHAPES + XXWIDE_SHAPES),
    "xwide_dq_drop_diag": ("flash_xwide_bwd.cu", N_TILES, N_TILES_DROP_DIAG,
                           ("dq",), XWIDE_SHAPES + XXWIDE_SHAPES),
}


def use_planted(name: str) -> None:
    use_patched(name, *PLANTED[name][:3])


def use_patched(name: str, src_name: str, old: str, new: str) -> None:
    """Build and load the kernels from a copy of the sources, written
    under build/ray_tpu_torch/planted/``name``, in which the first ``old``
    of ``src_name`` reads ``new``."""
    from ray_tpu_torch.ops import _build
    out = _build.BUILD_DIR / "planted" / name
    out.mkdir(parents=True, exist_ok=True)
    for src in sorted(_build.CSRC.iterdir()):
        if src.suffix not in (".cu", ".cuh"):
            continue
        text = src.read_text()
        if src.name == src_name:
            assert old in text, (src_name, old)
            text = text.replace(old, new, 1)
        (out / src.name).write_text(text)
    _build.CSRC = out


def measure(gen, shape, hm, dtype, causal, tk=None) -> dict:
    from ray_tpu_torch.ops.flash_attention import (
        attention_backward_reference, attention_reference)
    fwd, bwd = chip_smoke._family(hm)
    b, t, h, d = shape
    q, do = (torch.randn(shape, generator=gen, device="cuda").to(dtype)
             for _ in range(2))
    k, v = (torch.randn((b, tk or t, h, d), generator=gen,
                        device="cuda").to(dtype) for _ in range(2))
    scale = d ** -0.5
    out, lse = fwd(q, k, v, causal=causal)
    ref, ref_lse = attention_reference(q, k, v, causal, scale)
    res = {"shape": list(shape), **({} if tk is None else {"tk": tk}),
           "head_major": hm,
           "dtype": str(dtype).replace("torch.", ""), "causal": causal,
           "lse_max_abs_err": chip_smoke.max_err(lse, ref_lse)}
    grads = bwd(q, k, v, out, lse, do, causal=causal, scale=scale)
    refs = attention_backward_reference(q, k, v, out, lse, do, causal, scale)
    for name, g, r in zip(("O", "dq", "dk", "dv"), (out, *grads),
                          (ref, *refs)):
        res[name] = {"over_max": chip_smoke._gradient_err(g, r)[1],
                     "row": chip_smoke.held_err(name, g, r, causal)}
    return res


def run_build(name: str) -> None:
    if name != "sound":
        use_planted(name)
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED)
    shapes = (TRAIN_SHAPES + WIDE_SHAPES + XWIDE_SHAPES + XXWIDE_SHAPES
              + FMA_SHAPES if name == "sound" else PLANTED[name][4])
    cases = [(s, hm, dtype, True) for s, hm, dtype in shapes]
    if name == "sound":
        for dtype in (torch.float32, torch.bfloat16):
            cases += [((1, 512, 4, 64), False, dtype, c)
                      for c in (False, True)]
            cases += [(s, False, dtype, True) for s in ((1, 100, 2, 64),
                                                         (1, 256, 3, 128))]
            cases += [(s, True, dtype, c) for s in (
                (2, 256, 4, 32), (1, 256, 3, 64), (1, 256, 3, 128))
                for c in (False, True)]
            cases += [(s, True, dtype, True) for s in ((1, 100, 3, 64),
                                                        (1, 100, 5, 32))]
        # the bf16 kernels' tile edges, as in chip_smoke.phase_kernels
        for hm, dims, heads in ((False, (64, 128), 2),
                                (True, (32, 64, 128), 3)):
            for d in dims:
                cases += [((2, t, heads, d), hm, torch.bfloat16, True)
                          for t in (chip_smoke.EDGE_LENGTHS
                                    + chip_smoke.DQ_EDGE_LENGTHS)]
                cases += [((2, tq, heads, d), hm, torch.bfloat16, False, tk)
                          for tq, tk in (chip_smoke.CROSS_LENGTHS,
                                         chip_smoke.DQ_CROSS_LENGTHS)]
    for case in cases:
        print(json.dumps({"build": name, **measure(gen, *case)}), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--build":
        run_build(sys.argv[2])
        return 0
    if not torch.cuda.is_available():
        print("check_flash_tolerance_torch: needs a CUDA device",
              file=sys.stderr)
        return 2
    rows, ok = [], True
    for name in ("sound", *PLANTED):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--build", name], capture_output=True,
                              text=True, cwd=ROOT)
        if proc.returncode != 0:
            print(proc.stderr, file=sys.stderr)
            raise RuntimeError(f"build {name}: exit {proc.returncode}")
        for line in proc.stdout.splitlines():
            print(line, flush=True)
            rows.append(json.loads(line))
    for r in rows:
        tol = chip_smoke.ROW_TOL[getattr(torch, r["dtype"])]
        held = (("O", "dq", "dk", "dv") if r["build"] == "sound"
                else PLANTED[r["build"]][3])
        worst = max(r[t]["row"] for t in held)
        passed = worst <= tol if r["build"] == "sound" else worst > tol
        ok &= passed
        print(json.dumps({"verdict": r["build"], "shape": r["shape"],
                          **({"tk": r["tk"]} if "tk" in r else {}),
                          "head_major": r["head_major"],
                          "dtype": r["dtype"], "causal": r["causal"],
                          "tensors": held, "row": worst, "row_tol": tol,
                          "over_max": max(r[t]["over_max"] for t in held),
                          "as_expected": passed}), flush=True)
    print(chip_smoke.card_line(), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
