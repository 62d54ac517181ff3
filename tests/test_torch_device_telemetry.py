"""The port's device telemetry (``core/device_telemetry.py``) against
the JAX package's: the same call sequence through both
``instrument_step`` wrappers counts the same signatures; the toy
decoders' steps count alike; device time brackets wait for CUDA work;
the MFU denominator is the H100's."""

import numpy as np
import pytest
import torch

from ray_tpu.core import device_telemetry as jax_dt
from ray_tpu.serve.toy_decoder import ToyDecoder as JaxToyDecoder
from ray_tpu_torch.core import device_telemetry as dt
from ray_tpu_torch.serve.toy_decoder import ToyDecoder


@pytest.fixture(autouse=True)
def _isolate_compile_registries():
    dt.reset_for_tests()
    jax_dt.reset_for_tests()
    yield
    dt.reset_for_tests()
    jax_dt.reset_for_tests()


def _calls():
    """Arguments of one call sequence: repeats, new shapes and dtypes,
    a kwarg that appears, changes type and repeats."""
    a4 = np.zeros((4,), np.float32)
    return [((a4,), {}), ((a4,), {}),
            ((np.ones((4,), np.float32),), {}),
            ((np.zeros((8,), np.float32),), {}),
            ((a4.astype(np.int32),), {}),
            ((a4,), {"scale": 2}), ((a4,), {"scale": 2}),
            ((a4,), {"scale": 2.5}),
            ((torch.zeros(4),), {}), ((torch.zeros(4, 2),), {})]


def test_instrument_step_counts_like_the_jax_package():
    def fn(x, scale=1):
        return x * scale

    ours = dt.instrument_step(fn, name="t.step")
    theirs = jax_dt.instrument_step(fn, name="t.step")
    assert dt.is_instrumented(ours) and ours.__wrapped__ is fn
    for args, kwargs in _calls():
        ours(*args, **kwargs)
        theirs(*args, **kwargs)
        assert dt.compile_count("t.step") == jax_dt.compile_count("t.step")
    got, want = dt.compile_stats()["t.step"], jax_dt.compile_stats()["t.step"]
    assert {k: got[k] for k in ("total", "first", "shape_miss")} == \
        {k: want[k] for k in ("total", "first", "shape_miss")} == \
        {"total": 7, "first": 1, "shape_miss": 6}


def test_toy_decoder_step_signatures_count_like_jit():
    """The toy decoders' step wrappers count one signature per padding
    bucket and none at steady state, in lockstep with each engine's own
    trace_count, the same in both packages."""
    ours, theirs = ToyDecoder(dim=8, device="cpu"), JaxToyDecoder(dim=8)
    for prompt in ([2, 3, 4], [5, 6], list(range(2, 12)), [7]):
        for engine in (ours, theirs):
            engine.generate_unbatched({"prompt": list(prompt),
                                       "max_new_tokens": 3})
        assert dt.compile_count("toy_decoder.step") == ours.trace_count \
            == jax_dt.compile_count("toy_decoder.step") \
            == theirs.trace_count
    assert ours.trace_count == 2  # the 8- and 16-token buckets


def test_device_done_synchronises_the_tensors_devices(monkeypatch):
    """device_done waits for the CUDA devices of the tensors it is
    given (nested in lists, tuples and dicts), and for nothing on the
    CPU."""
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", synced.append)

    class FakeCuda:
        is_cuda = True

        def __init__(self, index):
            self.device = torch.device("cuda", index)

    monkeypatch.setattr(torch, "Tensor", (torch.Tensor, FakeCuda))
    mon = dt.StepMonitor("serve", name="t", deployment="d")
    span = mon.step()
    span.dispatched()
    out = {"a": [FakeCuda(0), (FakeCuda(1), torch.zeros(2))],
           "b": FakeCuda(0)}
    assert span.device_done(out) is out
    span.done(requests=1.0)
    assert sorted(d.index for d in synced) == [0, 1]
    synced.clear()
    dt.instrument_step(lambda: torch.zeros(3), name="t.cpu")()
    assert synced == []


def test_peak_flops_is_the_h100_row(monkeypatch):
    """989e12 (dense bf16, NVIDIA's data sheet) for an H100, and for a
    host without CUDA (the JAX package gives its v5e figure there)."""
    assert dt._PEAK_BF16_FLOPS["h100"] == 989e12
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert dt.peak_flops_per_chip() == 989e12
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda *a: "NVIDIA H100 80GB HBM3")
    assert dt.peak_flops_per_chip() == 989e12
    assert jax_dt.peak_flops_per_chip() == 197e12  # its CPU-host figure
