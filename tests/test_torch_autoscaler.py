"""The port's autoscaler (``ray_tpu_torch.autoscaler``) on the CPU.

Counterparts of tests/test_autoscaler.py's cases (the demand packer, the
control loop with a mock provider, a fake multi-node cluster whose nodes
are real raylets, standing resource requests, the cloud provider against
a fake ``gcloud``), with GPUs where the JAX package's cases name TPUs.
Then parity with the JAX package: the packer and the control loop fed the
same seeded inputs give the same launches and terminations, and the GPU
provider's lifecycle against a fake ``gcloud`` reads as the TPU
provider's does.  Last, the slice's path: a job submitted to the
dashboard asks for a GPU the cluster lacks, the monitor launches a GPU
node (here "GPU" is a label on a CPU raylet), GPT-2's forward runs there
and the idle node is drained and terminated.  The slow cases share one
cluster for the module."""

import base64
import hashlib
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu.autoscaler import autoscaler as jautoscaler
from ray_tpu.autoscaler import node_provider as jnode_provider
from ray_tpu.autoscaler import resource_demand_scheduler as jrds
from ray_tpu.autoscaler.gcp import GCPTPUNodeProvider
from ray_tpu_torch.autoscaler import (MockProvider, NodeTypeConfig,
                                      ResourceDemandScheduler,
                                      StandardAutoscaler)
from ray_tpu_torch.autoscaler.gcp import GCPGPUNodeProvider
from ray_tpu_torch.autoscaler.node_provider import (TAG_NODE_KIND,
                                                    TAG_NODE_TYPE)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CPU4 = NodeTypeConfig(resources={"CPU": 4})
GPU_HOST = NodeTypeConfig(resources={"CPU": 8, "GPU": 4})


@pytest.fixture(scope="module")
def cluster():
    """One head of 1 CPU, no GPU, connected for the module; each slow
    case makes its own provider, autoscaler and monitor over it."""
    from ray_tpu_torch.cluster_utils import Cluster

    c = Cluster(initialize_head=True,
                head_node_args={"num_cpus": 1, "num_gpus": 0})
    c.connect()
    yield c
    rt.shutdown()
    c.shutdown()


def test_demand_packs_onto_existing():
    sched = ResourceDemandScheduler({"cpu4": CPU4})
    out = sched.get_nodes_to_launch(
        existing_nodes=[("cpu4", {"CPU": 4})],
        demand=[{"CPU": 1}] * 4)
    assert out == {}


def test_demand_launches_minimum_nodes():
    sched = ResourceDemandScheduler({"cpu4": CPU4})
    out = sched.get_nodes_to_launch(
        existing_nodes=[],
        demand=[{"CPU": 1}] * 10)
    assert out == {"cpu4": 3}


def test_demand_picks_best_type():
    sched = ResourceDemandScheduler({"cpu4": CPU4, "gpu": GPU_HOST})
    out = sched.get_nodes_to_launch(
        existing_nodes=[], demand=[{"GPU": 4}])
    assert out == {"gpu": 1}
    # pure-CPU demand should not launch GPU hosts
    out = sched.get_nodes_to_launch(
        existing_nodes=[], demand=[{"CPU": 2}])
    assert out == {"cpu4": 1}


def test_strict_spread_bundles_need_distinct_nodes():
    sched = ResourceDemandScheduler({"cpu4": CPU4})
    out = sched.get_nodes_to_launch(
        existing_nodes=[],
        demand=[],
        pending_placement_groups=[{
            "strategy": "STRICT_SPREAD",
            "bundles": [{"CPU": 1}, {"CPU": 1}, {"CPU": 1}],
        }])
    assert out == {"cpu4": 3}


def test_launching_counts_as_capacity():
    sched = ResourceDemandScheduler({"cpu4": CPU4})
    out = sched.get_nodes_to_launch(
        existing_nodes=[], demand=[{"CPU": 1}] * 4,
        launching={"cpu4": 1})
    assert out == {}


def test_infeasible_demand_not_launched():
    sched = ResourceDemandScheduler({"cpu4": CPU4})
    out = sched.get_nodes_to_launch(
        existing_nodes=[], demand=[{"GPU": 8}])
    assert out == {}


def _snapshot(nodes, demand=(), pgs=(), requests=()):
    return {"nodes": nodes, "pending_demand": list(demand),
            "resource_requests": list(requests),
            "pending_placement_groups": list(pgs)}


def _gcs_node(nid, total, avail, load=0):
    return {"node_id": nid + "0" * (32 - len(nid)), "alive": True,
            "resources_total": total, "resources_available": avail,
            "load": load}


def test_autoscaler_scales_up_and_down():
    provider = MockProvider()
    asc = StandardAutoscaler(
        provider, {"cpu4": NodeTypeConfig(resources={"CPU": 4},
                                          min_workers=0, max_workers=5)},
        idle_timeout_s=0.2)
    # demand for 8 CPUs, head has none free
    asc.update_load_metrics(_snapshot(
        [_gcs_node("head", {"CPU": 1}, {"CPU": 0}, load=2)],
        demand=[{"CPU": 1}] * 8))
    r = asc.update()
    assert r["launched"] == {"cpu4": 2}
    workers = provider.non_terminated_nodes({TAG_NODE_KIND: "worker"})
    assert len(workers) == 2

    # nodes joined the GCS and are now idle with no demand
    asc.update_load_metrics(_snapshot(
        [_gcs_node("head", {"CPU": 1}, {"CPU": 1})] +
        [_gcs_node(w[:12], {"CPU": 4}, {"CPU": 4}) for w in workers]))
    r = asc.update()
    assert r["launched"] == {} and r["terminated"] == []
    time.sleep(0.3)
    r = asc.update()
    assert len(r["terminated"]) == 2
    assert provider.non_terminated_nodes({TAG_NODE_KIND: "worker"}) == []


def test_autoscaler_min_workers_floor():
    provider = MockProvider()
    asc = StandardAutoscaler(
        provider, {"cpu4": NodeTypeConfig(resources={"CPU": 4},
                                          min_workers=2)},
        idle_timeout_s=0.0)
    asc.update_load_metrics(_snapshot([]))
    r = asc.update()
    assert r["launched"] == {"cpu4": 2}
    # idle forever but never below the floor
    workers = provider.non_terminated_nodes({TAG_NODE_KIND: "worker"})
    asc.update_load_metrics(_snapshot(
        [_gcs_node(w[:12], {"CPU": 4}, {"CPU": 4}) for w in workers]))
    asc.update()
    time.sleep(0.05)
    r = asc.update()
    assert r["terminated"] == []


def _await(cond, timeout, what):
    deadline = time.time() + timeout
    while time.time() < deadline:
        if cond():
            return
        time.sleep(0.3)
    pytest.fail(what)


def test_autoscaler_fake_multinode_end_to_end(cluster):
    """Infeasible task -> autoscaler launches a local raylet -> task runs
    -> idle node scaled down (reference test_autoscaler_fake_multinode);
    the JAX package's waits, none shorter."""
    from ray_tpu_torch.autoscaler import FakeMultiNodeProvider, Monitor

    node_types = {"cpu2": NodeTypeConfig(resources={"CPU": 2},
                                         max_workers=2)}
    provider = FakeMultiNodeProvider(
        cluster, {"cpu2": {"resources": {"CPU": 2}}})
    asc = StandardAutoscaler(provider, node_types, max_workers=2,
                             idle_timeout_s=2.0)
    monitor = Monitor(asc, update_interval_s=0.5)
    monitor.start()
    try:
        @rt.remote(num_cpus=2)
        def two_cpu_task():
            return "scaled"

        # head has 1 CPU: this queues until the autoscaler adds a node
        assert rt.get(two_cpu_task.remote(), timeout=90) == "scaled"
        assert len(provider.non_terminated_nodes({})) >= 1

        # after going idle the worker is terminated
        _await(lambda: not provider.non_terminated_nodes({}), 60,
               "idle worker not terminated")
    finally:
        monitor.stop()


def test_request_resources_packs_against_totals_not_free():
    """A busy cluster whose TOTAL capacity already covers the standing
    request launches nothing — request_resources is a min-cluster-size
    ask, not a reservation (reference sdk semantics)."""
    provider = MockProvider()
    asc = StandardAutoscaler(
        provider, {"cpu4": NodeTypeConfig(resources={"CPU": 4},
                                          max_workers=5)},
        idle_timeout_s=60.0)
    # one fully-busy cpu4 worker; request for 4 CPUs fits its TOTALS
    provider.create_node({}, {TAG_NODE_KIND: "worker",
                              TAG_NODE_TYPE: "cpu4"}, 1)
    wid = provider.non_terminated_nodes({TAG_NODE_KIND: "worker"})[0]
    asc.update_load_metrics(_snapshot(
        [_gcs_node("head", {"CPU": 1}, {"CPU": 1}),
         _gcs_node(wid[:12], {"CPU": 4}, {"CPU": 0}, load=4)],
        requests=[{"CPU": 1}] * 4))
    r = asc.update()
    assert r["launched"] == {}
    # but a request BEYOND total capacity does launch
    asc.update_load_metrics(_snapshot(
        [_gcs_node("head", {"CPU": 1}, {"CPU": 1}),
         _gcs_node(wid[:12], {"CPU": 4}, {"CPU": 0}, load=4)],
        requests=[{"CPU": 1}] * 9))
    r = asc.update()
    assert r["launched"] == {"cpu4": 1}


def test_request_resources_pins_only_needed_nodes():
    """A standing request the head already covers must not block idle
    scale-down of unrelated workers; a request needing one worker pins
    exactly one of two idle workers."""
    provider = MockProvider()
    asc = StandardAutoscaler(
        provider, {"cpu4": NodeTypeConfig(resources={"CPU": 4},
                                          max_workers=5)},
        idle_timeout_s=0.1)
    provider.create_node({}, {TAG_NODE_KIND: "worker",
                              TAG_NODE_TYPE: "cpu4"}, 2)
    w1, w2 = provider.non_terminated_nodes({TAG_NODE_KIND: "worker"})
    nodes = [_gcs_node("head", {"CPU": 1}, {"CPU": 1}),
             _gcs_node(w1[:12], {"CPU": 4}, {"CPU": 4}),
             _gcs_node(w2[:12], {"CPU": 4}, {"CPU": 4})]

    # head covers a 1-CPU request: both idle workers terminate
    asc.update_load_metrics(_snapshot(nodes, requests=[{"CPU": 1}]))
    asc.update()
    time.sleep(0.2)
    r = asc.update()
    assert len(r["terminated"]) == 2

    # a 4-CPU request needs one worker: exactly one survives
    provider2 = MockProvider()
    asc2 = StandardAutoscaler(
        provider2, {"cpu4": NodeTypeConfig(resources={"CPU": 4},
                                           max_workers=5)},
        idle_timeout_s=0.1)
    provider2.create_node({}, {TAG_NODE_KIND: "worker",
                               TAG_NODE_TYPE: "cpu4"}, 2)
    w1, w2 = provider2.non_terminated_nodes({TAG_NODE_KIND: "worker"})
    nodes = [_gcs_node("head", {"CPU": 1}, {"CPU": 1}),
             _gcs_node(w1[:12], {"CPU": 4}, {"CPU": 4}),
             _gcs_node(w2[:12], {"CPU": 4}, {"CPU": 4})]
    asc2.update_load_metrics(_snapshot(nodes, requests=[{"CPU": 4}]))
    asc2.update()
    time.sleep(0.2)
    asc2.update_load_metrics(_snapshot(nodes, requests=[{"CPU": 4}]))
    r = asc2.update()
    assert len(r["terminated"]) == 1
    assert len(provider2.non_terminated_nodes(
        {TAG_NODE_KIND: "worker"})) == 1


def test_request_resources_scales_up_and_holds(cluster):
    """autoscaler.sdk.request_resources (reference sdk.py:206): a
    standing capacity request scales the cluster up without any queued
    task, holds it there past the idle timeout, and clearing the
    request releases the nodes."""
    from ray_tpu_torch.autoscaler import (FakeMultiNodeProvider, Monitor,
                                          request_resources)

    node_types = {"cpu2": NodeTypeConfig(resources={"CPU": 2},
                                         max_workers=2)}
    provider = FakeMultiNodeProvider(
        cluster, {"cpu2": {"resources": {"CPU": 2}}})
    asc = StandardAutoscaler(provider, node_types, max_workers=2,
                             idle_timeout_s=1.0)
    monitor = Monitor(asc, update_interval_s=0.3)
    monitor.start()
    try:
        # 3 one-CPU bundles; the 1-CPU head covers one -> 1 cpu2 node
        request_resources(num_cpus=3)
        _await(lambda: provider.non_terminated_nodes({}), 60,
               "standing request did not launch a node")

        # idle_timeout is 1s, but the standing request pins the node
        time.sleep(2.0)
        assert provider.non_terminated_nodes({}), \
            "standing request did not hold the node"

        request_resources()  # clear -> normal idle scale-down
        _await(lambda: not provider.non_terminated_nodes({}), 60,
               "node not released after the request was cleared")
    finally:
        request_resources()
        monitor.stop()


# ---------------------------------------------------------------------------
# GCP GPU-VM provider (fake gcloud runners)
# ---------------------------------------------------------------------------

class _FakeGcloud:
    """Records gcloud invocations; keeps a tiny GPU-VM fleet in memory
    (``gcloud compute instances``: short names, ``status``)."""

    def __init__(self):
        self.calls = []
        self.nodes = {}

    def __call__(self, args):
        self.calls.append(args)
        assert args[:2] == ["compute", "instances"], args
        if args[2] == "list":
            return json.dumps(list(self.nodes.values()))
        if args[2] == "create":
            name = args[3]
            labels = {}
            if "--labels" in args:
                for pair in args[args.index("--labels") + 1].split(","):
                    k, v = pair.split("=")
                    labels[k] = v
            self.nodes[name] = {"name": name, "status": "RUNNING",
                                "labels": labels}
            return ""
        if args[2] == "delete":
            self.nodes[args[3]]["status"] = "TERMINATED"
            return ""
        raise AssertionError(f"unexpected gcloud call: {args}")


class _FakeTpuGcloud:
    """The JAX package's test double for its TPU-VM provider."""

    def __init__(self):
        self.calls = []
        self.nodes = {}

    def __call__(self, args):
        self.calls.append(args)
        if "list" in args:
            return json.dumps(list(self.nodes.values()))
        if "create" in args:
            name = args[args.index("create") + 1]
            labels = {}
            if "--labels" in args:
                for pair in args[args.index("--labels") + 1].split(","):
                    k, v = pair.split("=")
                    labels[k] = v
            self.nodes[name] = {"name": f"projects/p/nodes/{name}",
                                "state": "READY", "labels": labels}
            return ""
        if "delete" in args:
            name = args[args.index("delete") + 1]
            self.nodes[name]["state"] = "TERMINATED"
            return ""
        raise AssertionError(f"unexpected gcloud call: {args}")


def test_gcp_gpu_provider_lifecycle():
    fake = _FakeGcloud()
    provider = GCPGPUNodeProvider(
        {"project_id": "p", "zone": "us-central1-a"},
        cluster_name="c1", runner=fake)
    assert provider.non_terminated_nodes({}) == []
    provider.create_node({}, {TAG_NODE_KIND: "worker",
                              TAG_NODE_TYPE: "h100"}, count=2)
    nodes = provider.non_terminated_nodes({})
    assert len(nodes) == 2
    assert all(n.startswith("ray-tpu-torch-c1-") for n in nodes)
    # tag filtering maps through instance labels
    assert provider.non_terminated_nodes(
        {TAG_NODE_TYPE: "h100"}) == nodes
    assert provider.non_terminated_nodes(
        {TAG_NODE_TYPE: "other"}) == []
    assert provider.is_running(nodes[0])
    assert provider.node_tags(nodes[0])[TAG_NODE_KIND] == "worker"
    # create attached one H100 to the default machine type, and a GPU
    # instance cannot live-migrate
    create = next(c for c in fake.calls if c[2] == "create")
    assert create[create.index("--machine-type") + 1] == "a3-highgpu-1g"
    assert create[create.index("--accelerator") + 1] == \
        "type=nvidia-h100-80gb,count=1"
    assert create[create.index("--maintenance-policy") + 1] == "TERMINATE"
    assert create[create.index("--zone") + 1] == "us-central1-a"
    provider.terminate_node(nodes[0])
    assert len(provider.non_terminated_nodes({})) == 1
    assert not provider.is_running(nodes[0])


def test_gcp_gpu_provider_with_autoscaler():
    """The demand-driven autoscaler drives the gcloud-backed provider
    exactly like the mock one."""
    fake = _FakeGcloud()
    provider = GCPGPUNodeProvider(
        {"project_id": "p", "zone": "z"}, cluster_name="c2", runner=fake)
    autoscaler = StandardAutoscaler(
        provider,
        node_types={"gpu_host": NodeTypeConfig(
            resources={"GPU": 1.0, "CPU": 8.0}, max_workers=4)},
        idle_timeout_s=3600)
    autoscaler.update_load_metrics(
        {"nodes": [], "pending_demand": [{"GPU": 1.0}] * 3,
         "pending_placement_groups": []})
    autoscaler.update()
    # 3 GPU-hosts' worth of demand -> 3 nodes
    assert len(provider.non_terminated_nodes(
        {TAG_NODE_TYPE: "gpu_host"})) == 3


def test_gcp_provider_lifecycle_matches_jax():
    """The same calls on the port's GPU provider and the JAX package's
    TPU provider, each against its fake gcloud, read the same: nodes,
    filters, running state and tags through the lifecycle."""
    def drive(provider):
        seen = [len(provider.non_terminated_nodes({}))]
        provider.create_node({}, {TAG_NODE_KIND: "worker",
                                  TAG_NODE_TYPE: "a"}, count=3)
        provider.create_node({}, {TAG_NODE_KIND: "head",
                                  TAG_NODE_TYPE: "b"}, count=1)
        nodes = sorted(provider.non_terminated_nodes({}))
        seen.append(len(nodes))
        seen.append(len(provider.non_terminated_nodes(
            {TAG_NODE_KIND: "worker"})))
        seen.append(len(provider.non_terminated_nodes(
            {TAG_NODE_TYPE: "b"})))
        workers = sorted(provider.non_terminated_nodes(
            {TAG_NODE_KIND: "worker"}))
        seen.append(provider.node_tags(workers[0]))
        provider.terminate_node(workers[0])
        seen.append(provider.is_running(workers[0]))
        seen.append(provider.is_running(workers[1]))
        seen.append(len(provider.non_terminated_nodes({})))
        seen.append(provider.node_tags(workers[0]))
        seen.append(provider.node_tags("no-such-node"))
        return seen

    ours = drive(GCPGPUNodeProvider({"project_id": "p", "zone": "z"},
                                    cluster_name="c", runner=_FakeGcloud()))
    theirs = drive(GCPTPUNodeProvider({"project_id": "p", "zone": "z"},
                                      cluster_name="c",
                                      runner=_FakeTpuGcloud()))
    assert ours == theirs


def test_tpu_node_types_and_providers_refused(cluster):
    """A node type that names "TPU" raises when the fake provider is
    made, and the JAX package's TPU-VM provider types raise naming the
    port's GPU one."""
    from ray_tpu_torch.autoscaler import FakeMultiNodeProvider
    from ray_tpu_torch.autoscaler.launcher import _make_provider

    with pytest.raises(TypeError, match='"GPU"'):
        FakeMultiNodeProvider(cluster, {"t": {"resources": {"TPU": 4}}})
    for ptype in ("gcp", "gcp_tpu"):
        with pytest.raises(TypeError, match="gcp_gpu"):
            _make_provider({"cluster_name": "x", "provider": {
                "type": ptype, "project_id": "p", "zone": "z"}})
    assert isinstance(_make_provider({"cluster_name": "x", "provider": {
        "type": "gcp_gpu", "project_id": "p", "zone": "z"}}),
        GCPGPUNodeProvider)


# ---------------------------------------------------------------------------
# parity with the JAX package on seeded inputs
# ---------------------------------------------------------------------------

def _random_shape(rng, names=("CPU", "GPU", "memory")):
    shape = {}
    for name in names:
        if rng.random() < 0.6:
            shape[name] = float(rng.integers(1, 5))
    return shape or {"CPU": 1.0}


def _scheduler_case(seed):
    rng = np.random.default_rng(seed)
    types = {f"t{i}": {"resources": _random_shape(rng),
                       "max_workers": int(rng.integers(1, 6))}
             for i in range(int(rng.integers(1, 4)))}
    existing = [(str(rng.choice(list(types))), _random_shape(rng))
                for _ in range(int(rng.integers(0, 4)))]
    demand = [_random_shape(rng) for _ in range(int(rng.integers(0, 12)))]
    pgs = [{"strategy": str(rng.choice(["PACK", "SPREAD",
                                        "STRICT_SPREAD"])),
            "bundles": [_random_shape(rng)
                        for _ in range(int(rng.integers(1, 4)))]}
           for _ in range(int(rng.integers(0, 3)))]
    launching = {t: int(rng.integers(0, 2)) for t in types
                 if rng.random() < 0.3}
    max_workers = int(rng.integers(2, 12))
    return types, existing, demand, pgs, launching, max_workers


@pytest.mark.parametrize("seed", range(8))
def test_scheduler_matches_jax(seed):
    """get_nodes_to_launch on the same seeded node types, live nodes,
    demand, placement groups and in-flight launches."""
    types, existing, demand, pgs, launching, max_workers = \
        _scheduler_case(seed)
    ours = ResourceDemandScheduler(
        {n: NodeTypeConfig(**t) for n, t in types.items()}, max_workers)
    theirs = jrds.ResourceDemandScheduler(
        {n: jrds.NodeTypeConfig(**t) for n, t in types.items()},
        max_workers)
    args = dict(existing_nodes=existing, demand=demand,
                pending_placement_groups=pgs, launching=launching)
    assert ours.get_nodes_to_launch(**args) == \
        theirs.get_nodes_to_launch(**args)


def _drive_autoscaler(pkg_autoscaler, pkg_provider, pkg_rds, seed):
    """A seeded run of the control loop: each tick's demand, the live
    nodes the provider launched (joined one tick later, idle or busy at
    random); returns each tick's launches, number terminated and size."""
    rng = np.random.default_rng(seed)
    provider = pkg_provider.MockProvider()
    asc = pkg_autoscaler.StandardAutoscaler(
        provider,
        {"cpu4": pkg_rds.NodeTypeConfig(resources={"CPU": 4},
                                        max_workers=4),
         "gpu": pkg_rds.NodeTypeConfig(resources={"CPU": 8, "GPU": 1},
                                       min_workers=int(rng.integers(0, 2)),
                                       max_workers=2)},
        max_workers=8, idle_timeout_s=0.0)
    out = []
    joined = []
    for _ in range(6):
        nodes = [_gcs_node("head", {"CPU": 1}, {"CPU": 1})]
        for wid in joined:
            if wid not in provider.non_terminated_nodes({}):
                continue
            tags = provider.node_tags(wid)
            total = {"CPU": 4.0} if tags[TAG_NODE_TYPE] == "cpu4" \
                else {"CPU": 8.0, "GPU": 1.0}
            busy = rng.random() < 0.4
            nodes.append(_gcs_node(wid[:12], total,
                                   {k: 0.0 for k in total} if busy
                                   else dict(total), load=int(busy)))
        demand = [{"CPU": float(rng.integers(1, 5))} if rng.random() < 0.7
                  else {"CPU": 1.0, "GPU": 1.0}
                  for _ in range(int(rng.integers(0, 8)))] \
            if rng.random() < 0.6 else []
        asc.update_load_metrics(_snapshot(nodes, demand=demand))
        r = asc.update()
        time.sleep(0.002)  # an idle node's clock moves past the timeout
        r2 = asc.update()
        out.append((r["launched"], len(r["terminated"]), r2["launched"],
                    len(r2["terminated"]), r2["num_workers"]))
        joined = list(provider.non_terminated_nodes(
            {TAG_NODE_KIND: "worker"}))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_autoscaler_updates_match_jax(seed):
    from ray_tpu_torch.autoscaler import autoscaler as tautoscaler
    from ray_tpu_torch.autoscaler import node_provider as tnode_provider
    from ray_tpu_torch.autoscaler import resource_demand_scheduler as trds

    ours = _drive_autoscaler(tautoscaler, tnode_provider, trds, seed)
    theirs = _drive_autoscaler(jautoscaler, jnode_provider, jrds, seed)
    assert ours == theirs
    assert any(step[0] or step[2] for step in ours)  # it did launch


# ---------------------------------------------------------------------------
# the slice's path: a job's GPU task makes the monitor add a GPU node
# ---------------------------------------------------------------------------

def _port_forward_digest(preset, seed, batch, seq):
    """The job task's forward in this process: sha256 and last rows."""
    from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config

    cfg = getattr(GPT2Config, preset)(max_seq_len=seq)
    weights = GPT2(cfg, device="cpu",
                   generator=torch.Generator().manual_seed(seed)).state_dict()
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq),
                           generator=torch.Generator().manual_seed(seed + 1))
    model = GPT2(cfg, device="cpu")
    model.load_state_dict(weights)
    with torch.no_grad():
        logits = model(tokens).float()
    return (hashlib.sha256(memoryview(logits.numpy()).cast("B")).hexdigest(),
            logits[:, -1, :].contiguous())


def test_gpu_job_scales_up_a_gpu_node_and_drains_it(cluster):
    """phase ``ops`` of chip_smoke.py at a small size: the job's
    ``num_gpus=1`` task waits until the monitor launches the one
    ``gpu_worker`` node, runs there, and reports the same digest as the
    forward in this process; the dashboard lists the node with an agent
    row for every live node; the idle node is drained through the GCS and
    terminated."""
    from ray_tpu_torch.autoscaler import (AutoscalerMonitor,
                                          FakeMultiNodeProvider)
    from ray_tpu_torch.autoscaler.policy import PolicyConfig, ScalingPolicy
    from ray_tpu_torch.dashboard import Dashboard
    from ray_tpu_torch.job import JobSubmissionClient

    import urllib.request

    def get(url):
        with urllib.request.urlopen(url, timeout=30) as resp:
            return json.loads(resp.read())

    shape = {"CPU": 2, "GPU": 1}
    provider = FakeMultiNodeProvider(
        cluster, {"gpu_worker": {"resources": dict(shape)}})
    asc = StandardAutoscaler(
        provider, {"gpu_worker": NodeTypeConfig(resources=dict(shape),
                                                max_workers=1)},
        idle_timeout_s=2.0)
    monitor = AutoscalerMonitor(
        asc, policy=ScalingPolicy(PolicyConfig(down_for_s=2.0)),
        update_interval_s=0.5)
    dash = Dashboard(port=0)
    url = dash.start()
    monitor.start()
    try:
        client = JobSubmissionClient(url)
        script = os.path.join(REPO, "scripts", "gpt2_job_torch.py")
        sid = client.submit_job(
            entrypoint=f"{sys.executable} {script} --preset tiny --seed 3 "
            "--batch 2 --seq 32 --device cpu")
        ref_sha, ref_last = _port_forward_digest("tiny", 3, 2, 32)
        status = client.wait_until_finished(sid, timeout=180)
        logs = client.get_job_logs(sid)
        assert status == "SUCCEEDED", logs[-3000:]
        line = [ln for ln in logs.splitlines() if ln.startswith("GPT2_JOB ")]
        job = json.loads(line[-1].split(" ", 1)[1])
        last = torch.frombuffer(bytearray(base64.b64decode(
            job["last_rows_f32_b64"])), dtype=torch.float32).reshape(
                ref_last.shape)
        assert job["sha256"] == ref_sha and torch.equal(last, ref_last)
        assert job["gpu_ids"] == [0] and job["launches"] == {}
        (wid,) = provider.non_terminated_nodes({})
        assert job["node"].startswith(wid)
        assert job["node"] != cluster.head.node_id_hex

        rows = get(url + "/api/nodes")
        gpu_row = next(r for r in rows if r["node_id"] == job["node"])
        assert gpu_row["resources_total"]["GPU"] == 1.0
        deadline = time.time() + 30
        while time.time() < deadline:
            stats = [r for r in get(url + "/api/node_stats")
                     if r.get("state") == "ALIVE"]
            if len(stats) == 2 and all(r["source"] == "agent"
                                       for r in stats):
                break
            time.sleep(0.5)
        assert {r["source"] for r in stats} == {"agent"}, stats
        assert any(j["submission_id"] == sid for j in get(url + "/api/jobs/"))

        _await(lambda: not provider.non_terminated_nodes({}), 60,
               "the idle GPU node was not terminated")
        assert monitor.drains_completed == 1
        assert monitor.drains_aborted == 0
    finally:
        monitor.stop()
        dash.stop()
