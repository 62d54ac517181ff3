"""The port stands alone: no JAX, no ray_tpu, no silent CPU fallback."""

import ast
import ctypes
import pathlib
import re
import subprocess
import sys

import pytest
import torch

import ray_tpu_torch
from ray_tpu_torch import resolve_device
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops.flash_attention import (flash_attention,
                                               flash_attention_bwd,
                                               flash_attention_fwd,
                                               flash_attention_hm_bwd,
                                               flash_attention_hm_fwd)
from ray_tpu_torch.ops.fused import fused_rmsnorm

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


def _port_files():
    files = sorted((ROOT / "ray_tpu_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py",
                    *sorted((ROOT / "scripts").glob("*_torch.py"))]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax_or_ray_tpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = [m for m in _imported(tree) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def _strings(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            yield node.lineno, node.value


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_strings_name_no_jax_module_or_env(path):
    """No string in a port file (docstrings included) names a module of
    the JAX package: a spawn string such as ``-m ray_tpu.core.worker_main``
    would start the JAX package's workers, which speak the same protocol.
    Every ``RAY_TPU_*`` environment name carries the port's own
    ``RAY_TPU_TORCH_`` prefix, so the two runtimes never read each
    other's (``RAY_TPU_ADDRESS`` would attach a port driver to a JAX
    cluster), except ``RAY_TPU_FLASH_NATIVE``, the JAX package's own
    switch that the port's flash dispatch reads with its rules."""
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for line, text in _strings(tree):
        bad += [(line, m) for m in re.findall(r"\bray_tpu\.[A-Za-z_]", text)]
        bad += [(line, m) for m in re.findall(r"\bRAY_TPU_[A-Z0-9_]*", text)
                if not m.startswith("RAY_TPU_TORCH_")
                and m != "RAY_TPU_FLASH_NATIVE"]
    assert not bad, f"{path.name}: {bad}"


def test_worker_main_import_leaves_torch_unloaded():
    """A worker (``python -m ray_tpu_torch.core.worker_main``) and the
    zygote import the runtime without torch: each would otherwise pay
    torch's import, seconds and hundreds of MB, before its first task."""
    code = ("import sys, ray_tpu_torch.core.worker_main, "
            "ray_tpu_torch.core.worker_zygote, ray_tpu_torch.serve; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{('torch',) + FORBIDDEN!r}]; print(bad); "
            "sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_train_and_data_imports_leave_torch_unloaded():
    """Importing Train (its framework trainers too), Tune, the data plane,
    AIR and the parallel vocabulary loads no torch (and no JAX): a CPU
    worker that runs a data task, a trial or a train loop that never
    touches torch pays no torch import.  torch comes with a loop's own
    import or with ``to_torch``."""
    code = ("import sys, ray_tpu_torch.train, ray_tpu_torch.data, "
            "ray_tpu_torch.air, ray_tpu_torch.parallel, "
            "ray_tpu_torch.train.pytree_io, ray_tpu_torch.util.actor_pool, "
            "ray_tpu_torch.tune, ray_tpu_torch.train.sklearn, "
            "ray_tpu_torch.train.gbdt, ray_tpu_torch.train.huggingface; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{('torch',) + FORBIDDEN!r}]; print(bad); "
            "import numpy as np; "
            "ds = ray_tpu_torch.data.dataset.Dataset([]); "
            "it = ray_tpu_torch.data.dataset.torch_batches("
            "iter([np.zeros(2)]), 'cpu'); "
            "before = 'torch' in sys.modules; next(it); "
            "sys.exit(1 if bad or before or 'torch' not in sys.modules "
            "else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_import_leaves_jax_unloaded():
    code = ("import sys, ray_tpu_torch.models, "
            "ray_tpu_torch.models.convert, ray_tpu_torch.serve, "
            "ray_tpu_torch.core.worker, ray_tpu_torch.train, "
            "ray_tpu_torch.data, ray_tpu_torch.parallel, ray_tpu_torch.tune, "
            "ray_tpu_torch.train.sklearn, ray_tpu_torch.train.gbdt, "
            "ray_tpu_torch.train.huggingface; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            resolve_device()
        with pytest.raises(RuntimeError):
            resolve_device("cuda")
    assert ray_tpu_torch.__version__


def test_cpu_tensors_never_touch_the_library(monkeypatch):
    def refuse():
        raise AssertionError("kernel library loaded for a CPU tensor")

    monkeypatch.setattr(_build, "load_library", refuse)
    monkeypatch.setattr(flash_attention_fwd, "launches", 0)
    monkeypatch.setattr(fused_rmsnorm, "launches", 0)
    monkeypatch.setattr(flash_attention_bwd, "launches_dkdv", 0)
    monkeypatch.setattr(flash_attention_bwd, "launches_dq", 0)
    monkeypatch.setattr(flash_attention_hm_fwd, "launches", 0)
    monkeypatch.setattr(flash_attention_hm_bwd, "launches_dkdv", 0)
    monkeypatch.setattr(flash_attention_hm_bwd, "launches_dq", 0)
    monkeypatch.setattr(flash_attention_hm_fwd, "launches_wide", 0)
    monkeypatch.setattr(flash_attention_hm_bwd, "launches_wide_dkdv", 0)
    monkeypatch.setattr(flash_attention_hm_bwd, "launches_wide_dq", 0)
    monkeypatch.setattr(flash_attention_hm_fwd, "launches_xwide", 0)
    monkeypatch.setattr(flash_attention_hm_fwd, "launches_xxwide", 0)
    monkeypatch.setattr(flash_attention_hm_fwd, "launches_fma", 0)
    monkeypatch.setattr(flash_attention_hm_bwd, "launches_xwide_dkdv", 0)
    monkeypatch.setattr(flash_attention_hm_bwd, "launches_xwide_dq", 0)
    monkeypatch.setattr(flash_attention_hm_bwd, "launches_fma_dkdv", 0)
    monkeypatch.setattr(flash_attention_hm_bwd, "launches_fma_dq", 0)
    q = torch.randn(1, 16, 2, 64, requires_grad=True)
    flash_attention(q, q, q).sum().backward()
    q_hm = torch.randn(1, 16, 3, 32, requires_grad=True)  # head-major
    flash_attention(q_hm, q_hm, q_hm).sum().backward()
    out, lse = flash_attention_hm_fwd(q_hm, q_hm, q_hm)
    flash_attention_hm_bwd(q_hm, q_hm, q_hm, out, lse, out, causal=True,
                           scale=1.0)
    # the pad route's size, and flash_fma.cu's and flash_fma_bwd.cu's
    # (f32), flash_wide.cu's, flash_xwide.cu's and flash_xwide_bwd.cu's
    # (bf16) sizes
    for dim, dtype in ((20, torch.float32), (160, torch.float32),
                       (150, torch.float32), (160, torch.bfloat16),
                       (150, torch.bfloat16), (300, torch.bfloat16),
                       (601, torch.bfloat16)):
        x = torch.randn(1, 16, 3, dim, dtype=dtype, requires_grad=True)
        flash_attention(x, x, x).sum().backward()
        assert x.grad is not None
    x = torch.randn(3, 64, requires_grad=True)
    fused_rmsnorm(x, torch.ones(64, requires_grad=True)).sum().backward()
    assert q.grad is not None and x.grad is not None
    assert q_hm.grad is not None
    assert flash_attention_fwd.launches == 0
    assert flash_attention_bwd.launches_dkdv == 0
    assert flash_attention_bwd.launches_dq == 0
    assert flash_attention_hm_fwd.launches == 0
    assert flash_attention_hm_bwd.launches_dkdv == 0
    assert flash_attention_hm_bwd.launches_dq == 0
    assert flash_attention_hm_fwd.launches_wide == 0
    assert flash_attention_hm_bwd.launches_wide_dkdv == 0
    assert flash_attention_hm_bwd.launches_wide_dq == 0
    assert flash_attention_hm_fwd.launches_xwide == 0
    assert flash_attention_hm_fwd.launches_xxwide == 0
    assert flash_attention_hm_fwd.launches_fma == 0
    assert flash_attention_hm_bwd.launches_xwide_dkdv == 0
    assert flash_attention_hm_bwd.launches_xwide_dq == 0
    assert flash_attention_hm_bwd.launches_fma_dkdv == 0
    assert flash_attention_hm_bwd.launches_fma_dq == 0
    assert fused_rmsnorm.launches == 0


def test_library_name_hashes_sources():
    path = _build.library_path()
    assert path.parent == ROOT / "build" / "ray_tpu_torch"
    assert path.name.startswith("libray_tpu_torch_") and path.suffix == ".so"
    assert {p.name for p in _build.CSRC.glob("*.cu")} == {
        "flash_bwd.cu", "flash_fma.cu", "flash_fma_bwd.cu", "flash_fwd.cu",
        "flash_wide.cu", "flash_xwide.cu", "flash_xwide_bwd.cu",
        "rmsnorm.cu"}
    assert {p.name for p in _build.CSRC.glob("*.cuh")} == {
        "flash_common.cuh", "flash_fma.cuh", "hopper.cuh"}
    # both kernel families launch the same three flash entry points,
    # and the head-major family above head_dim 128 flash_wide.cu's three,
    # flash_xwide.cu's forward (to 1024), flash_xwide_bwd.cu's two,
    # flash_fma.cu's one and flash_fma_bwd.cu's two; seven more report the
    # flash kernels' registers and shared bytes
    assert set(_build.SIGNATURES) == {"rtt_rmsnorm_fwd", "rtt_flash_fwd",
                                      "rtt_flash_bwd_dkdv",
                                      "rtt_flash_bwd_dq",
                                      "rtt_flash_wide_fwd",
                                      "rtt_flash_wide_bwd_dkdv",
                                      "rtt_flash_wide_bwd_dq",
                                      "rtt_flash_xwide_fwd",
                                      "rtt_flash_fma_fwd",
                                      "rtt_flash_xwide_bwd_dkdv",
                                      "rtt_flash_xwide_bwd_dq",
                                      "rtt_flash_fma_bwd_dkdv",
                                      "rtt_flash_fma_bwd_dq",
                                      "rtt_flash_fwd_attrs",
                                      "rtt_flash_bwd_attrs",
                                      "rtt_flash_wide_attrs",
                                      "rtt_flash_xwide_attrs",
                                      "rtt_flash_fma_attrs",
                                      "rtt_flash_xwide_bwd_attrs",
                                      "rtt_flash_fma_bwd_attrs"}
    for flag in ("arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"):
        assert flag in _build.NVCC_FLAGS


def test_library_hash_covers_every_header(tmp_path, monkeypatch):
    """A change to any source, headers included, names a new library."""
    for src in _build.CSRC.iterdir():
        (tmp_path / src.name).write_bytes(src.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    for name in ("hopper.cuh", "flash_common.cuh", "flash_fwd.cu"):
        (tmp_path / name).write_text((tmp_path / name).read_text() + "\n")
        after = _build.library_path()
        assert after != before, name
        before = after


def _c_entry_points():
    """{name: [parameter kind, ...]} of every ``extern "C" int rtt_*``
    in csrc/*.cu, a kind being "pointer", "float" or "int"."""
    found = {}
    for src in sorted(_build.CSRC.glob("*.cu")):
        for name, params in re.findall(
                r'extern "C" int (rtt_\w+)\((.*?)\)\s*\{',
                src.read_text(), flags=re.S):
            kinds = []
            for param in params.split(","):
                decl = " ".join(param.split())
                kinds.append("pointer" if "*" in decl else
                             "float" if decl.startswith("float ") else
                             "int" if decl.startswith("int ") else decl)
            found[name] = kinds
    return found


def test_c_signatures_match_argtypes():
    """Each C entry point's parameters, in order, are what ctypes passes:
    a pointer for c_void_p, an int for c_int, a float for c_float."""
    kind = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
            ctypes.c_float: "float"}
    entry_points = _c_entry_points()
    assert set(entry_points) == set(_build.SIGNATURES)
    for name, argtypes in _build.SIGNATURES.items():
        assert entry_points[name] == [kind[a] for a in argtypes], name


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda _: None)
    monkeypatch.setenv("CUDA_HOME", str(ROOT / "no-such-cuda"))
    monkeypatch.setattr(_build, "library_path",
                        lambda: ROOT / "build" / "ray_tpu_torch" / "absent.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_model_defaults_to_cuda():
    from ray_tpu_torch.models.llama import Llama, LlamaConfig
    if torch.cuda.is_available():
        assert Llama(LlamaConfig.tiny()).embedding.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            Llama(LlamaConfig.tiny())


def test_gpt2_defaults_to_cuda():
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config
    cfg = GPT2Config.tiny(embed_dim=128, num_heads=2)
    if torch.cuda.is_available():
        assert GPT2(cfg).wte.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            GPT2(cfg)


def test_models_export_the_jax_model_zoo():
    """ray_tpu_torch.models exports the classes of ray_tpu.models under
    the same names: the five models, their configs and SparseMoEMLP."""
    import inspect

    import ray_tpu.models as jax_models
    import ray_tpu_torch.models as port_models

    def classes(mod):
        return {n for n, o in vars(mod).items() if inspect.isclass(o)}

    assert classes(port_models) == classes(jax_models)
    for name in ("GPT2", "Llama", "MoETransformer", "ResNet", "ViT"):
        assert issubclass(getattr(port_models, name), torch.nn.Module)


@pytest.mark.parametrize("name", ["ViT", "MoETransformer", "SparseMoEMLP",
                                  "ResNet"])
def test_new_models_default_to_cuda(name):
    import ray_tpu_torch.models as m
    config = getattr(m, name.replace("Transformer", "")
                     .replace("SparseMoEMLP", "MoE") + "Config")
    cfg = config.tiny() if hasattr(config, "tiny") else config.resnet18()
    if torch.cuda.is_available():
        model = getattr(m, name)(cfg)
        assert next(model.parameters()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(m, name)(cfg)
