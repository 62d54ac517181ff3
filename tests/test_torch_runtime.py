"""The port's own runtime (``ray_tpu_torch.init`` and the copied GCS,
raylet and workers) on the CPU: tasks, actors, the object store with
torch tensors, GPU scheduling, workers free of the JAX package, a
prompt shutdown.  One cluster for the file; every wait is bounded."""

import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "ray_tpu")


@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, num_gpus=0, object_store_memory=256 * 2**20)
    yield
    rt.shutdown()


@rt.remote
def add_one(x):
    return x + 1


@rt.remote
def double(x):
    return x * 2


@rt.remote
def loaded_modules():
    import sys
    return sorted({m.split(".")[0] for m in sys.modules})


@rt.remote
def tensor_stats(t):
    return str(t.dtype), tuple(t.shape), t.float().sum().item()


@rt.remote
def make_tensor(seed):
    import torch
    gen = torch.Generator().manual_seed(seed)
    return torch.randn(300, 40, generator=gen).to(torch.bfloat16)


@rt.remote
class Counter:
    def __init__(self):
        self.seen = []

    def add(self, i):
        self.seen.append(i)
        return list(self.seen)


def test_chained_tasks(cluster):
    refs = [double.remote(add_one.remote(i)) for i in range(8)]
    assert rt.get(refs, timeout=60) == [2 * (i + 1) for i in range(8)]


def test_ordered_actor_calls(cluster):
    c = Counter.remote()
    refs = [c.add.remote(i) for i in range(10)]
    assert rt.get(refs[-1], timeout=60) == list(range(10))
    assert rt.get(refs, timeout=60)[4] == list(range(5))


def test_put_get_and_task_returns_of_tensors(cluster):
    t = torch.arange(4096, dtype=torch.float32).reshape(64, 64)
    ref = rt.put(t)
    back = rt.get(ref, timeout=30)
    assert back.dtype == t.dtype and torch.equal(back, t)
    assert rt.get(tensor_stats.remote(ref), timeout=60) == \
        ("torch.float32", (64, 64), float(t.sum()))
    got = rt.get(make_tensor.remote(3), timeout=60)
    want = torch.randn(300, 40, generator=torch.Generator().manual_seed(
        3)).to(torch.bfloat16)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    # a numpy array and a small tensor ride along in one container
    mixed = rt.get(rt.put({"a": np.arange(10), "t": torch.ones(3)}),
                   timeout=30)
    assert mixed["a"].tolist() == list(range(10))
    assert torch.equal(mixed["t"], torch.ones(3))


def test_workers_are_free_of_the_jax_package(cluster):
    mods = rt.get(loaded_modules.remote(), timeout=60)
    assert not [m for m in mods if m in FORBIDDEN], mods
    assert "ray_tpu_torch" in mods


def test_num_tpus_is_rejected(cluster):
    for call in (lambda: rt.remote(num_tpus=1)(lambda: 0),
                 lambda: add_one.options(num_tpus=1),
                 lambda: Counter.options(num_tpus=1),
                 lambda: rt.init(num_tpus=1)):
        with pytest.raises(TypeError, match="num_gpus"):
            call()


def test_get_gpu_ids_is_empty_without_a_lease(cluster):
    assert rt.get_gpu_ids() == []


@rt.remote(num_gpus=1)
def needs_a_gpu():
    return rt.get_gpu_ids()


def test_gpu_task_stays_pending_without_gpus(cluster):
    """A node with no GPU never runs a num_gpus task, as the JAX
    package's leaves a num_tpus task pending on a node without TPUs.
    (In both packages the pending task also holds up the driver's later
    tasks, so this test runs last before shutdown.)"""
    assert rt.cluster_resources().get("GPU", 0) == 0
    ref = needs_a_gpu.remote()
    ready, pending = rt.wait([ref], timeout=2.0)
    assert ready == [] and pending == [ref]


def test_shutdown_is_prompt(cluster):
    t0 = time.perf_counter()
    rt.shutdown()
    assert time.perf_counter() - t0 < 5.0
    assert not rt.is_initialized()
