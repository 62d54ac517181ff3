"""The port's multi-node harness (``ray_tpu_torch.cluster_utils``) on the
CPU: counterparts of tests/test_multinode.py's cases, of
tests/test_chaos.py's node-kill cases (``_test_utils.NodeKiller``) and of
tests/test_serve_batching.py's two-node replica spread, on one cluster for
the module: a head and a side node of 2 CPUs each, GPUs claimed by none.
The serve case and the chaos cases come last, since the chaos cases add
nodes and kill them."""

import time

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch import serve
from ray_tpu_torch._test_utils import NodeKiller, wait_for_condition
from ray_tpu_torch.cluster_utils import Cluster


@pytest.fixture(scope="module")
def cluster():
    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 2, "num_gpus": 0})
    c.add_node(num_cpus=2, num_gpus=0, resources={"side": 1})
    c.connect()
    c.wait_for_nodes()
    yield c
    c.shutdown()


def test_two_nodes_visible(cluster):
    nodes = [n for n in rt.nodes() if n["alive"]]
    assert len(nodes) == 2
    assert rt.cluster_resources().get("CPU") == 4.0
    assert rt.cluster_resources().get("GPU", 0.0) == 0.0


def test_spillback_scheduling(cluster):
    """Demand exceeding the local node spills to the remote node."""

    @rt.remote(num_cpus=2)
    def whoami():
        time.sleep(0.3)
        return rt.get_runtime_context().get_node_id()

    nodes = {rt.get(whoami.remote(), timeout=120) for _ in range(2)}
    deadline = time.monotonic() + 60
    while len(nodes) < 2 and time.monotonic() < deadline:
        refs = [whoami.remote() for _ in range(4)]
        nodes |= set(rt.get(refs, timeout=120))
    assert len(nodes) == 2  # both nodes executed tasks


def test_custom_resource_routing(cluster):
    @rt.remote(resources={"side": 1}, num_cpus=0)
    def on_side():
        return rt.get_runtime_context().get_node_id()

    side_node = rt.get(on_side.remote(), timeout=120)
    head_node = rt.get_runtime_context().get_node_id()
    assert side_node != head_node


def test_cross_node_object_transfer(cluster):
    """A plasma object produced on one node is pulled to the other."""
    arr = np.arange(2_000_000, dtype=np.float64)  # 16MB

    @rt.remote(resources={"side": 1}, num_cpus=0)
    def produce():
        return np.arange(2_000_000, dtype=np.float64)

    @rt.remote(num_cpus=1)
    def consume(a):
        return float(a.sum())

    ref = produce.remote()
    total = rt.get(consume.remote(ref), timeout=120)
    assert total == float(arr.sum())


def test_driver_reads_remote_object(cluster):
    @rt.remote(resources={"side": 1}, num_cpus=0)
    def produce():
        return np.full(1_000_000, 3.25)

    out = rt.get(produce.remote(), timeout=120)
    assert out[0] == 3.25 and out.shape == (1_000_000,)


def test_node_death_detected(cluster):
    node = cluster.add_node(num_cpus=1, num_gpus=0, resources={"doomed": 1})
    cluster.wait_for_nodes()
    assert sum(n["alive"] for n in rt.nodes()) == 3
    cluster.remove_node(node)
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline:
        if sum(n["alive"] for n in rt.nodes()) == 2:
            return
        time.sleep(0.2)
    pytest.fail("node death not detected")


def test_tpu_options_refused(cluster):
    with pytest.raises(TypeError, match="num_gpus="):
        cluster.add_node(num_cpus=1, num_tpus=1)
    with pytest.raises(TypeError, match='"GPU"'):
        cluster.add_node(num_cpus=1, resources={"TPU": 1})


def _routed_replicas(name):
    from ray_tpu_torch.serve._internal import CONTROLLER_NAME
    controller = rt.get_actor(CONTROLLER_NAME)
    table = rt.get(controller.get_routing_table.remote(-1, 1.0), timeout=30)
    return table["table"][name]


def test_two_node_replica_spread(cluster):
    """Replicas of a SPREAD deployment land on distinct nodes and the
    routing table advertises both (the ingress balances across hosts)."""
    try:
        @serve.deployment(
            num_replicas=2, max_concurrent_queries=2,
            ray_actor_options={"scheduling_strategy": "SPREAD"})
        def where(_payload=None):
            time.sleep(0.2)
            return rt.get_runtime_context().get_node_id()

        handle = serve.run(where.bind())
        entry = _routed_replicas("where")
        assert len(entry["replicas"]) == 2
        assert len(entry["replica_depths"]) == 2
        nodes = {rt.get(r.node_id.remote(), timeout=30)
                 for r in entry["replicas"]}
        assert len(nodes) == 2, f"replicas packed onto one node: {nodes}"
        # concurrent load past one replica's capacity spills across nodes
        seen = set(rt.get([handle.remote(None) for _ in range(12)],
                          timeout=60))
        assert len(seen) == 2
    finally:
        serve.shutdown()


@pytest.fixture(scope="module")
def chaos_nodes(cluster):
    """Two more 2-CPU nodes for the chaos cases to kill."""
    for _ in range(2):
        cluster.add_node(num_cpus=2, num_gpus=0)
    cluster.wait_for_nodes()
    return cluster


def test_tasks_survive_node_kills(chaos_nodes):
    """A fan-out/fan-in job keeps its answer while worker nodes are
    SIGKILLed mid-flight (retries + lineage reconstruction)."""
    @rt.remote(max_retries=5)
    def chunk_sum(seed, n):
        # the kills must land mid-flight: a floor on each task's duration
        time.sleep(0.2)
        rng = np.random.default_rng(seed)
        return int(rng.integers(0, 100, size=n).sum())

    @rt.remote(max_retries=5)
    def combine(*parts):
        return int(sum(parts))

    expected = sum(int(np.random.default_rng(s).integers(
        0, 100, size=20_000).sum()) for s in range(24))
    killer = NodeKiller(chaos_nodes, kill_interval_s=0.25, max_kills=2,
                        seed=7).start()
    try:
        parts = [chunk_sum.remote(s, 20_000) for s in range(24)]
        total = rt.get(combine.remote(*parts), timeout=180)
    finally:
        killed = killer.stop()
    assert total == expected
    assert len(killed) >= 1, "chaos did not actually kill any node"
    from ray_tpu_torch.experimental.state.api import list_nodes
    wait_for_condition(
        lambda: sum(1 for n in list_nodes() if n["state"] == "DEAD")
        >= len(killed), timeout=30)


def test_detached_actor_survives_other_node_death(chaos_nodes):
    """Kill a node an actor is NOT on; calls keep succeeding."""
    # a fresh node beside the survivors of the last case's kills (those
    # stay in worker_nodes, so wait_for_nodes would count them)
    alive = sum(n["alive"] for n in rt.nodes())
    chaos_nodes.add_node(num_cpus=2, num_gpus=0)
    wait_for_condition(lambda: sum(n["alive"] for n in rt.nodes())
                       > alive, timeout=60)

    @rt.remote(max_restarts=3, max_task_retries=3)
    class Counter:
        def __init__(self):
            self.n = 0

        def bump(self):
            self.n += 1
            return self.n

    c = Counter.remote()
    assert rt.get(c.bump.remote(), timeout=60) == 1
    from ray_tpu_torch.experimental.state.api import list_actors
    actor_node = next(a["node_id"] for a in list_actors()
                      if a["state"] == "ALIVE"
                      and "Counter" in a.get("class_name", ""))
    victim = next(n for n in chaos_nodes.worker_nodes
                  if not actor_node.startswith(n.handshake["node_id"][:12])
                  and n.proc.poll() is None)
    victim.kill()
    for i in range(2, 12):
        assert rt.get(c.bump.remote(), timeout=60) == i
