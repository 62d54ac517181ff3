"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` (one process
per source, all started together), linked into one shared library with a
plain C interface, and loaded with ``ctypes``.  The library is named
after a hash of its sources and flags and lives under the repository's
``build/ray_tpu_torch/``, so an unchanged tree builds once and a changed
source can never load a stale library.  It is built on first use; a
missing ``nvcc`` or a failed build raises — there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
import time
from typing import Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "ray_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes.  Pointers and the stream are c_void_p
# (a bare Python int would be passed as a 32-bit int and cut).
SIGNATURES = {
    # x, weight, out, rows, cols, eps, dtype, stream
    "rtt_rmsnorm_fwd": [_P, _P, _P, _I, _I, _F, _I, _P],
    # q, k, v, out, lse, batch, seq_q, seq_k, heads, head_dim, scale,
    # causal, dtype, out_dtype, stream
    "rtt_flash_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I, _I,
                      _I, _P],
    # q, k, v, dout, lse, delta, dk, dv, batch, seq_q, seq_k, heads,
    # head_dim, scale, causal, dtype, out_dtype, stream
    "rtt_flash_bwd_dkdv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _F, _I, _I, _I, _P],
    # q, k, v, dout, lse, delta, dq, batch, seq_q, seq_k, heads, head_dim,
    # scale, causal, dtype, out_dtype, stream
    "rtt_flash_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F,
                         _I, _I, _I, _P],
    # flash_fma_bwd.cu, the head-major f32 dK/dV and dQ from head_dim
    # 129 to 1024: as rtt_flash_bwd_dkdv and rtt_flash_bwd_dq
    "rtt_flash_fma_bwd_dkdv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                               _I, _I, _F, _I, _I, _I, _P],
    "rtt_flash_fma_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _F, _I, _I, _I, _P],
    # flash_wide.cu, the head-major bf16 forward, dK/dV and dQ from
    # head_dim 129 to 256: as rtt_flash_fwd, rtt_flash_bwd_dkdv and
    # rtt_flash_bwd_dq
    "rtt_flash_wide_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                           _I, _I, _P],
    "rtt_flash_wide_bwd_dkdv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _F, _I, _I, _I, _P],
    "rtt_flash_wide_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                              _F, _I, _I, _I, _P],
    # flash_xwide.cu, the head-major bf16 forward from head_dim 257 to
    # 1024; flash_fma.cu, the f32 forward from 129 to 1024: as
    # rtt_flash_fwd
    "rtt_flash_xwide_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                            _I, _I, _P],
    "rtt_flash_fma_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                          _I, _I, _P],
    # flash_xwide_bwd.cu, the head-major bf16 dK/dV and dQ from head_dim
    # 257 to 1024: as rtt_flash_bwd_dkdv and rtt_flash_bwd_dq
    "rtt_flash_xwide_bwd_dkdv": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                 _I, _I, _F, _I, _I, _I, _P],
    "rtt_flash_xwide_bwd_dq": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                               _I, _F, _I, _I, _I, _P],
    # the bf16-input kernels' registers and shared bytes as the runtime
    # holds them: head_dim, f32_out, out (int[3]); kernel (0 = dK/dV,
    # 1 = dQ), head_dim, f32_out, out; kernel (0 = forward, 1 = dK/dV,
    # 2 = dQ), head_dim, f32_out, out; head_dim, f32_out, out; and the
    # f32 forward's at a launch's batch, seq_q, heads, head_dim: out
    # (int[6]: then the group width, the clusters the card holds at once
    # and the launch's clusters); flash_xwide_bwd.cu's kernel (0 = dK/dV,
    # 1 = dQ) at a launch's batch, seq_q, seq_k, heads, head_dim, f32_out:
    # out (int[6], the same); flash_fma_bwd.cu's kernel (0 = dK/dV, 1 =
    # dQ) at a launch's batch, seq_q, seq_k, heads, head_dim: out (int[6],
    # the same)
    "rtt_flash_fwd_attrs": [_I, _I, _P],
    "rtt_flash_bwd_attrs": [_I, _I, _I, _P],
    "rtt_flash_wide_attrs": [_I, _I, _I, _P],
    "rtt_flash_xwide_attrs": [_I, _I, _P],
    "rtt_flash_fma_attrs": [_I, _I, _I, _I, _P],
    "rtt_flash_xwide_bwd_attrs": [_I, _I, _I, _I, _I, _I, _I, _P],
    "rtt_flash_fma_bwd_attrs": [_I, _I, _I, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
build_seconds: Optional[float] = None


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
        cand = pathlib.Path(home) / "bin" / "nvcc"
        if cand.exists():
            nvcc = str(cand)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the ray_tpu_torch CUDA kernels cannot be built")
    return nvcc


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libray_tpu_torch_{h.hexdigest()[:16]}.so"


def _run_all(cmds, log):
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    failed = []
    for cmd, p in zip(cmds, procs):
        out, _ = p.communicate()
        log.write(" ".join(cmd) + "\n" + out + "\n")
        if p.returncode != 0:
            failed.append((cmd, p.returncode, out))
    if failed:
        cmd, rc, out = failed[0]
        raise RuntimeError(f"nvcc failed (rc {rc}): {' '.join(cmd)}\n{out}")


def build() -> pathlib.Path:
    """Compile the kernels if the hashed library is not there yet."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [pathlib.Path(tmp) / (s.stem + ".o") for s in _sources()]
        with open(out.with_suffix(".log"), "w") as log:
            _run_all([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
                      for s, o in zip(_sources(), objs)], log)
            staged = pathlib.Path(tmp) / out.name
            _run_all([[nvcc, *NVCC_FLAGS, "-shared", *map(str, objs),
                       "-o", str(staged)]], log)
        os.replace(staged, out)  # atomic: concurrent builds race safely
    build_seconds = time.perf_counter() - t0
    return out


def build_log() -> str:
    """The compiler's output from building the current library, ptxas's
    register, shared-memory and spill counts included."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load_library() -> ctypes.CDLL:
    """The kernel library, built on first use, with argtypes set."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise on a nonzero ``cudaError_t`` returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def dtype_code(dtype) -> int:
    """The C side's dtype switch, for inputs and outputs alike:
    0 = float32, 1 = bfloat16."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"CUDA kernels take float32 or bfloat16, got {dtype}")
    return codes[dtype]
