"""The port's ray:// client (``ray_tpu_torch.util.client``) on the CPU:
counterparts of tests/test_client.py's eight cases on one cluster for the
module, with two client servers on it (one shared, one isolated: a server
process per connection), and the rule by which tensors cross the client
boundary, the object store's: a CUDA tensor comes back on the reader's
card, or raises where the reader has no CUDA."""

import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.cluster_utils import Cluster
from ray_tpu_torch.core import serialization as ser
from ray_tpu_torch.util import client as client_mod


def _server(gcs, *extra):
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.util.client.server",
         "--address", gcs, "--host", "127.0.0.1", "--port", "0", *extra],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if "ready on ray://" in line:
            return proc, line.rsplit("ray://", 1)[1].strip()
    proc.kill()
    pytest.fail("client server did not come up")


@pytest.fixture(scope="module")
def servers():
    """A cluster with a shared and an isolated client server; yields
    their ray:// addresses."""
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 4, "num_gpus": 0})
    gcs = "{}:{}".format(*c.gcs_address)
    shared, shared_addr = _server(gcs)
    isolated, isolated_addr = _server(gcs, "--isolate")
    yield {"shared": shared_addr, "isolated": isolated_addr}
    for proc in (shared, isolated):
        proc.terminate()
        proc.wait(timeout=10)
    c.shutdown()


@pytest.fixture
def client(servers):
    rt.init(address=f"ray://{servers['shared']}")
    yield None
    rt.shutdown()


def test_client_tasks_and_objects(client):
    assert rt.is_initialized()

    @rt.remote
    def add(a, b):
        return a + b

    ref = add.remote(1, 2)
    assert rt.get(ref) == 3
    x = rt.put(np.arange(10))
    np.testing.assert_array_equal(rt.get(x), np.arange(10))
    chained = add.remote(add.remote(1, 1), 2)
    assert rt.get(chained) == 4
    ref2 = add.remote(rt.get(x).sum(), 0)
    assert rt.get(ref2) == 45


def test_client_wait_and_options(client):
    @rt.remote
    def slow(t):
        import time as _t
        _t.sleep(t)
        return t

    refs = [slow.remote(0.05), slow.remote(5)]
    ready, pending = rt.wait(refs, num_returns=1, timeout=30)
    assert ready == [refs[0]] and pending == [refs[1]]

    @rt.remote
    def pair():
        return 1, 2

    a, b = pair.options(num_returns=2).remote()
    assert rt.get([a, b]) == [1, 2]


def test_client_actors(client):
    @rt.remote
    class Counter:
        def __init__(self, start=0):
            self.n = start

        def incr(self, k=1):
            self.n += k
            return self.n

    c = Counter.remote(10)
    assert rt.get(c.incr.remote()) == 11
    assert rt.get(c.incr.remote(5)) == 16
    d = Counter.options(name="shared_counter").remote()
    handle = rt.get_actor("shared_counter")
    assert rt.get(handle.incr.remote()) == 1
    rt.kill(d)


def test_client_cluster_info(client):
    assert rt.cluster_resources().get("CPU") == 4.0
    assert rt.cluster_resources().get("GPU", 0.0) == 0.0
    assert len([n for n in rt.nodes() if n["alive"]]) == 1
    assert rt.connection_info()["mode"] == "client"


def test_client_chunked_large_objects(client):
    """Payloads above CHUNK_SIZE ride the wire in pieces both ways."""
    big = np.arange(3 * 1024 * 1024, dtype=np.int64)  # 24 MiB pickled
    np.testing.assert_array_equal(rt.get(rt.put(big)), big)

    @rt.remote
    def make(n):
        return np.ones(n, dtype=np.uint8)

    out = rt.get(make.remote(9 * 1024 * 1024), timeout=120)
    assert out.nbytes == 9 * 1024 * 1024 and out[-1] == 1


def test_client_isolation_per_client_driver(servers):
    """Each connection to the isolated server gets its own server
    process: two sequential clients see different server pids."""
    rt.init(address=f"ray://{servers['isolated']}")
    try:
        pid_a = client_mod.get_client().cluster_info("server_pid")

        @rt.remote
        def f():
            return 41

        assert rt.get(f.remote(), timeout=120) == 41
    finally:
        rt.shutdown()
    rt.init(address=f"ray://{servers['isolated']}")
    try:
        pid_b = client_mod.get_client().cluster_info("server_pid")
        assert pid_b != pid_a, "clients shared a server process"
    finally:
        rt.shutdown()


def test_client_placement_groups(client):
    """Placement groups created, awaited, read and removed over ray://,
    and a task placed on a bundle."""
    from ray_tpu_torch.util.placement_group import (placement_group,
                                                    placement_group_table,
                                                    remove_placement_group)
    from ray_tpu_torch.util.scheduling_strategies import \
        PlacementGroupSchedulingStrategy

    pg = placement_group([{"CPU": 0.5}, {"CPU": 0.5}], strategy="PACK")
    assert pg.wait(60), "PG did not place over ray://"
    assert rt.get(pg.ready(), timeout=60) is not None
    nodes = pg.bundle_nodes()
    assert set(nodes.keys()) == {0, 1}
    assert pg.id.hex() in placement_group_table()

    @rt.remote
    def where():
        import ray_tpu_torch
        return ray_tpu_torch.get_runtime_context().get_node_id()

    strat = PlacementGroupSchedulingStrategy(
        placement_group=pg, placement_group_bundle_index=0)
    node = rt.get(where.options(num_cpus=0.5,
                                scheduling_strategy=strat).remote(),
                  timeout=60)
    assert node == nodes[0], "task did not land on its bundle's node"
    remove_placement_group(pg)
    entry = placement_group_table().get(pg.id.hex())
    assert entry is None or entry.get("state") == "REMOVED"


def test_client_runtime_env_env_vars(client):
    """runtime_env passes through task and actor options over ray://."""
    @rt.remote
    def read_env():
        import os
        return os.environ.get("RTPU_CLIENT_RENV", "missing")

    out = rt.get(read_env.options(
        runtime_env={"env_vars": {"RTPU_CLIENT_RENV": "yes"}}).remote(),
        timeout=120)
    assert out == "yes"

    @rt.remote
    class EnvActor:
        def read(self):
            import os
            return os.environ.get("RTPU_CLIENT_RENV_A", "missing")

    a = EnvActor.options(runtime_env={
        "env_vars": {"RTPU_CLIENT_RENV_A": "actor-yes"}}).remote()
    assert rt.get(a.read.remote(), timeout=120) == "actor-yes"


def test_client_tensors_round_trip(client):
    """CPU tensors of every kind the store's wire carries come back
    equal, through put / get and as task arguments and results."""
    x = {"f": torch.randn(300, 7), "b": torch.arange(5).to(torch.bfloat16),
         "view": torch.arange(40.0).reshape(8, 5)[:, 1]}
    back = rt.get(rt.put(x))
    for k, v in x.items():
        assert back[k].dtype == v.dtype and torch.equal(back[k], v), k

    @rt.remote
    def double(t):
        return t * 2

    assert torch.equal(rt.get(double.remote(x["f"])), x["f"] * 2)


def test_client_tpu_options_refused(client):
    with pytest.raises(TypeError, match="num_gpus="):
        rt.remote(num_tpus=1)(lambda: 1)


def _cuda_blob(monkeypatch, value, available):
    """``value`` with a CUDA tensor in it as the client server sends it:
    a relaying process holds a CUDA tensor on the host and writes it as
    CUDA (``hold_cuda_on_host``).  Then the reader's device check is
    stubbed to ``available``."""
    monkeypatch.setattr(ser, "_HELD_ON_HOST", None)
    ser.hold_cuda_on_host()
    t = ser._rebuild_tensor((4, 3), "float32", "cuda",
                            torch.arange(12.0).numpy().tobytes())
    assert t.device.type == "cpu" and ser.device_kind(t) == "cuda"
    blob = client_mod.dumps(value(t))
    monkeypatch.setattr(ser, "_HELD_ON_HOST", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: available)
    return blob


def test_cuda_value_raises_where_the_reader_has_no_cuda(monkeypatch):
    """A CUDA tensor that crosses the boundary is read by the store's
    rule: where the reader has no CUDA it raises, naming the device; it
    never lands on the CPU."""
    blob = _cuda_blob(monkeypatch, lambda t: {"logits": t}, False)
    with pytest.raises(RuntimeError, match="CUDA tensor was read"):
        client_mod.loads(blob)


def test_cuda_value_lands_on_the_readers_card(monkeypatch):
    """Where the reader has CUDA, the tensor is made on its current
    card (one host-to-device copy; the allocation is stubbed here)."""
    blob = _cuda_blob(monkeypatch, lambda t: [t], True)
    landed = []
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    real_empty = torch.empty

    def empty(shape, dtype=None, device=None):
        landed.append(str(device))
        return real_empty(shape, dtype=dtype)

    monkeypatch.setattr(torch, "empty", empty)
    out = client_mod.loads(blob)[0]
    assert landed == ["cuda:0"]
    assert torch.equal(out, torch.arange(12.0).reshape(4, 3))


def test_relay_keeps_a_cuda_tensor_cuda(monkeypatch):
    """A relaying process (the client server) holds a CUDA tensor it
    reads on the host and writes it again as CUDA, to the client
    (``dumps``) and to the store (``serialize``, in band and on the
    buffer path); a CPU tensor stays a CPU tensor."""
    monkeypatch.setattr(ser, "_HELD_ON_HOST", None)
    ser.hold_cuda_on_host()
    for n in (3, 1000):  # below and above the store's in-band limit
        src = torch.arange(float(n))
        held = ser._rebuild_tensor((n,), "float32", "cuda",
                                   src.numpy().tobytes())
        assert held.device.type == "cpu" and ser.device_kind(held) == "cuda"
        for out in (client_mod.loads(client_mod.dumps(held)),
                    ser.deserialize(ser.serialize(held).to_bytes())[0]):
            assert ser.device_kind(out) == "cuda" and torch.equal(out, src)
        out, _ = ser.deserialize(ser.serialize(src).to_bytes())
        assert ser.device_kind(out) == "cpu" and torch.equal(out, src)
