"""ctypes loader for the native (C++) runtime components.

The sources are the port's own copies of the JAX package's ``src/``
(``csrc/object_store.cc``, ``csrc/sched_core.cc`` beside this module).
They are compiled with ``g++`` on first use into
``build/ray_tpu_torch/librtpu_torch_<hash>.so``, named by a hash of the
sources and flags so that a changed source builds a new library, or
ahead of time via ``python -m ray_tpu_torch.core.native``.  ctypes
rather than an extension module keeps the build a single ``g++``
invocation with no Python-dev dependency.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

_REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", ".."))
_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD_DIR = os.path.join(_REPO_ROOT, "build", "ray_tpu_torch")
_SOURCES = ["object_store.cc", "sched_core.cc"]
_FLAGS = ["-std=c++17", "-O2", "-g", "-fPIC", "-shared", "-Wall", "-Wextra",
          "-pthread"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def library_path() -> str:
    """Where the library for the current sources lives."""
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for s in _SOURCES:
        h.update(s.encode())
        with open(os.path.join(_SRC_DIR, s), "rb") as f:
            h.update(f.read())
    return os.path.join(_BUILD_DIR, f"librtpu_torch_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources; processes that build at once each write their
    own temporary file and rename it into place."""
    path = library_path()
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, *[os.path.join(_SRC_DIR, s) for s in _SOURCES],
           "-o", tmp]
    subprocess.run(cmd, check=True, capture_output=True, text=True)
    os.replace(tmp, path)
    return path


def load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            build()
        lib = ctypes.CDLL(path)
        u64 = ctypes.c_uint64
        p_u64 = ctypes.POINTER(u64)
        buf = ctypes.c_char_p  # 28-byte id blobs pass as bytes

        lib.rtpu_store_create.restype = ctypes.c_void_p
        lib.rtpu_store_create.argtypes = [ctypes.c_char_p, u64]
        lib.rtpu_store_destroy.restype = None
        lib.rtpu_store_destroy.argtypes = [ctypes.c_void_p]
        lib.rtpu_store_put.restype = ctypes.c_int64
        lib.rtpu_store_put.argtypes = [ctypes.c_void_p, buf, u64]
        lib.rtpu_store_put_hint.restype = ctypes.c_int64
        lib.rtpu_store_put_hint.argtypes = [ctypes.c_void_p, buf, u64, u64]
        lib.rtpu_store_seal.restype = ctypes.c_int
        lib.rtpu_store_seal.argtypes = [ctypes.c_void_p, buf]
        lib.rtpu_store_get.restype = ctypes.c_int
        lib.rtpu_store_get.argtypes = [ctypes.c_void_p, buf, p_u64, p_u64]
        lib.rtpu_store_release.restype = ctypes.c_int
        lib.rtpu_store_release.argtypes = [ctypes.c_void_p, buf]
        lib.rtpu_store_contains.restype = ctypes.c_int
        lib.rtpu_store_contains.argtypes = [ctypes.c_void_p, buf]
        lib.rtpu_store_delete.restype = ctypes.c_int
        lib.rtpu_store_delete.argtypes = [ctypes.c_void_p, buf]
        lib.rtpu_store_evict.restype = u64
        lib.rtpu_store_evict.argtypes = [ctypes.c_void_p, u64]
        lib.rtpu_store_lru_candidates.restype = u64
        lib.rtpu_store_lru_candidates.argtypes = [ctypes.c_void_p,
                                                  ctypes.c_char_p, u64]
        lib.rtpu_store_stats.restype = None
        lib.rtpu_store_stats.argtypes = [ctypes.c_void_p, p_u64, p_u64, p_u64]
        try:
            # telemetry extensions (absent from a stale pre-built .so;
            # stats_ex callers fall back to the basic stats)
            lib.rtpu_store_stats_ex.restype = u64
            lib.rtpu_store_stats_ex.argtypes = [ctypes.c_void_p, p_u64, u64]
            lib.rtpu_store_bucket_used.restype = u64
            lib.rtpu_store_bucket_used.argtypes = [ctypes.c_void_p, p_u64,
                                                   u64]
            lib.rtpu_store_shard_contention.restype = u64
            lib.rtpu_store_shard_contention.argtypes = [ctypes.c_void_p,
                                                        p_u64, u64]
            lib.rtpu_store_spill_candidates.restype = u64
            lib.rtpu_store_spill_candidates.argtypes = [
                ctypes.c_void_p, ctypes.c_char_p, p_u64, u64, u64]
            lib.rtpu_store_create_sharded.restype = ctypes.c_void_p
            lib.rtpu_store_create_sharded.argtypes = [ctypes.c_char_p,
                                                      u64, u64]
            lib.rtpu_store_used.restype = u64
            lib.rtpu_store_used.argtypes = [ctypes.c_void_p]
        except AttributeError:
            pass

        f64p = ctypes.POINTER(ctypes.c_double)
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.rtpu_sched_pick_node.restype = ctypes.c_int
        lib.rtpu_sched_pick_node.argtypes = [
            f64p, i64p, ctypes.c_int, ctypes.c_int, f64p, ctypes.c_int,
            ctypes.c_double, ctypes.c_double, ctypes.c_int]
        lib.rtpu_sched_place_bundles.restype = ctypes.c_int
        lib.rtpu_sched_place_bundles.argtypes = [
            f64p, ctypes.c_int, ctypes.c_int, f64p, ctypes.c_int,
            ctypes.c_int, i32p]
        _lib = lib
        return _lib


# ---------------------------------------------------------------------------
# scheduling-core wrappers (dict-of-resources <-> flat matrices)
# ---------------------------------------------------------------------------

def sched_pick_node(candidates, demand: dict, *, strategy: str,
                    local_utilization: float, spread_threshold: float,
                    local_feasible: bool):
    """C++ hybrid/spread spillback choice.  ``candidates`` is a list of
    (available_resources_dict, load_int); returns the chosen candidate
    index or None (stay local)."""
    lib = load()
    keys = sorted({k for a, _ in candidates for k in a} | set(demand))
    n_nodes, n_res = len(candidates), max(len(keys), 1)
    avail = (ctypes.c_double * (n_nodes * n_res))()
    load_arr = (ctypes.c_int64 * max(n_nodes, 1))()
    for i, (a, load_val) in enumerate(candidates):
        for r, k in enumerate(keys):
            avail[i * n_res + r] = float(a.get(k, 0.0))
        load_arr[i] = int(load_val)
    dem = (ctypes.c_double * n_res)()
    for r, k in enumerate(keys):
        dem[r] = float(demand.get(k, 0.0))
    out = lib.rtpu_sched_pick_node(
        avail, load_arr, n_nodes, n_res, dem,
        1 if strategy == "SPREAD" else 0,
        float(local_utilization), float(spread_threshold),
        1 if local_feasible else 0)
    return None if out < 0 else int(out)


def sched_place_bundles(node_avail, bundles, strategy: str):
    """C++ bundle placement.  ``node_avail``: list of resource dicts in
    the caller's (topology-sorted) node order; ``bundles``: list of
    resource dicts.  Returns a list of node indices or None."""
    lib = load()
    keys = sorted({k for a in node_avail for k in a}
                  | {k for b in bundles for k in b})
    n_nodes, n_res = len(node_avail), max(len(keys), 1)
    n_bundles = len(bundles)
    avail = (ctypes.c_double * (n_nodes * n_res))()
    for i, a in enumerate(node_avail):
        for r, k in enumerate(keys):
            avail[i * n_res + r] = float(a.get(k, 0.0))
    bnd = (ctypes.c_double * max(n_bundles * n_res, 1))()
    for b, bd in enumerate(bundles):
        for r, k in enumerate(keys):
            bnd[b * n_res + r] = float(bd.get(k, 0.0))
    out = (ctypes.c_int32 * max(n_bundles, 1))()
    strategies = {"PACK": 0, "SPREAD": 1, "STRICT_PACK": 2,
                  "STRICT_SPREAD": 3}
    ok = lib.rtpu_sched_place_bundles(
        avail, n_nodes, n_res, bnd, n_bundles, strategies[strategy], out)
    return list(out[:n_bundles]) if ok else None


if __name__ == "__main__":
    print(build())
