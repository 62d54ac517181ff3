"""The port's object wire for torch tensors (``core/serialization.py``)
against the JAX package's wire for the values both carry.

A tensor round-trips with its bytes, shape and dtype, drops
``requires_grad`` (a ``jax.Array`` has none) and, from
``_INBAND_LIMIT`` bytes up, rides out of band as raw bytes beside a small
meta pickle, as the JAX package ships its arrays.  No cluster: the wire
is a pure function of the value.
"""

import numpy as np
import pytest
import torch

from ray_tpu.core import serialization as jax_ser
from ray_tpu_torch.core import serialization as ser

DTYPES = [torch.float32, torch.float16, torch.bfloat16, torch.int8,
          torch.int32, torch.int64, torch.bool]
LAYOUTS = ["contiguous", "transposed", "0-d", "empty"]


def _tensor(dtype, layout):
    gen = torch.Generator().manual_seed(0)
    if layout == "0-d":
        base = torch.randn((), generator=gen) * 50
    elif layout == "empty":
        base = torch.randn(0, 7, generator=gen)
    else:
        base = torch.randn(24, 40, generator=gen) * 50
    t = base > 0 if dtype is torch.bool else base.to(dtype)
    return t.t() if layout == "transposed" else t


def _round_trip(value):
    wire = ser.serialize(value)
    out, is_exc = ser.deserialize(wire.to_bytes())
    assert not is_exc
    return wire, out


def _raw_bytes(t):
    return t.contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_tensor_round_trip(dtype, layout):
    t = _tensor(dtype, layout)
    if dtype.is_floating_point and t.numel():
        t.requires_grad_()
    wire, out = _round_trip(t)
    assert type(out) is torch.Tensor and out.device.type == "cpu"
    assert out.dtype == t.dtype and out.shape == t.shape
    assert _raw_bytes(out) == _raw_bytes(t.detach())
    if t.numel() * t.element_size() >= ser._INBAND_LIMIT:
        # out of band, as raw bytes, and the gradient flag is dropped
        assert len(wire.buffers) == 1
        assert memoryview(wire.buffers[0]).nbytes == \
            t.numel() * t.element_size()
        assert not out.requires_grad


def test_large_tensor_rides_out_of_band_and_is_a_copy():
    """The meta pickle stays small whatever the payload; the rebuilt
    tensor owns its memory (an in-place op cannot reach the wire)."""
    t = torch.arange(1 << 16, dtype=torch.float32)
    wire = ser.serialize(t)
    assert len(wire.meta) < 512 and len(wire.buffers) == 1
    data = bytearray(wire.to_bytes())
    out, _ = ser.deserialize(memoryview(data))
    out.add_(1)
    again, _ = ser.deserialize(memoryview(data))
    assert torch.equal(again, t)


@pytest.mark.parametrize("shape,dtype", [((64, 33), np.float32),
                                         ((1000,), np.int64),
                                         ((8, 8), np.float32)])
def test_numpy_array_takes_the_same_buffers_as_the_jax_package(shape,
                                                                dtype):
    x = (np.arange(np.prod(shape)) * 3).astype(dtype).reshape(shape)
    ours, theirs = ser.serialize(x), jax_ser.serialize(x)
    assert len(ours.buffers) == len(theirs.buffers)
    assert [bytes(memoryview(b)) for b in ours.buffers] == \
        [bytes(memoryview(b)) for b in theirs.buffers]
    assert ours.to_bytes() == theirs.to_bytes()
    out, _ = ser.deserialize(ours.to_bytes())
    np.testing.assert_array_equal(out, x)


def test_cuda_meta_raises_without_cuda(monkeypatch):
    """A CUDA tensor read where there is no CUDA raises; it does not
    land on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    raw = torch.arange(256, dtype=torch.float32)
    buf = raw.view(torch.uint8).numpy()
    with pytest.raises(RuntimeError, match="without CUDA"):
        ser._rebuild_tensor((256,), "float32", "cuda", memoryview(buf))
    out = ser._rebuild_tensor((256,), "float32", "cpu", memoryview(buf))
    assert torch.equal(out, raw)


def test_small_tensors_and_parameters_take_cloudpickle():
    """Below _INBAND_LIMIT bytes, and for tensor subclasses, the value
    takes the cloudpickle path (in band) and comes back equal."""
    small = torch.arange(5, dtype=torch.int32)
    wire, out = _round_trip(small)
    assert wire.buffers == [] and torch.equal(out, small)
    param = torch.nn.Parameter(torch.randn(32, 32))
    _, out = _round_trip(param)
    assert isinstance(out, torch.nn.Parameter)
    assert torch.equal(out.detach(), param.detach())


def test_wire_does_not_need_torch_imported_to_skip_tensors():
    """A value that is no tensor never touches torch: the wire looks
    torch up in sys.modules, as the JAX package looks up jax."""
    import pathlib
    import subprocess
    import sys
    code = ("import sys; from ray_tpu_torch.core import serialization as s;"
            " w = s.serialize({'a': bytes(1000), 'b': [1, 2]});"
            " v, _ = s.deserialize(w.to_bytes());"
            " assert v == {'a': bytes(1000), 'b': [1, 2]};"
            " sys.exit(1 if 'torch' in sys.modules else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       cwd=pathlib.Path(__file__).resolve().parents[1])
    assert r.returncode == 0, r.stdout + r.stderr


def test_serialize_while_another_thread_imports_torch():
    """A result serialized while another thread of the process is still
    importing torch (a train loop's first ``import torch`` beside the
    actor's ``next_results``) takes the plain path: the partial module
    has no ``torch.Tensor`` yet, and reading it raised AttributeError,
    which killed the actor's executor and timed the trainer's poll out.
    The import is replayed in a subprocess: a thread holds torch's
    import open at its first submodule while the main thread serializes
    a result dict and a large array."""
    import pathlib
    import subprocess
    import sys
    code = "\n".join([
        "import sys, threading, importlib.abc",
        "import numpy as np",
        "from ray_tpu_torch.core import serialization as s",
        "entered, release = threading.Event(), threading.Event()",
        "class Hold(importlib.abc.MetaPathFinder):",
        "    def find_spec(self, name, path=None, target=None):",
        "        if name.startswith('torch.') and not entered.is_set():",
        "            entered.set(); release.wait(60)",
        "        return None",
        "sys.meta_path.insert(0, Hold())",
        "t = threading.Thread(target=lambda: __import__('torch'))",
        "t.start(); assert entered.wait(60)",
        "assert 'torch' in sys.modules and not hasattr(",
        "    sys.modules['torch'], 'Tensor')",
        "for v in ({'loss': 1.5, 'rank': 0}, np.ones(1 << 16)):",
        "    w = s.serialize(v)",
        "    got, _ = s.deserialize(w.to_bytes())",
        "    assert repr(got) == repr(v)",
        "assert s.loaded_torch() is None",
        "release.set(); t.join(120)",
        "assert s.loaded_torch() is sys.modules['torch']",
    ])
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=180,
                       cwd=pathlib.Path(__file__).resolve().parents[1])
    assert r.returncode == 0, r.stdout + r.stderr
