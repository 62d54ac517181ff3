"""The port's closed-loop autoscaler on the CPU: counterparts of
tests/test_autoscaler_monitor.py's cases (the ScalingPolicy state machine:
two-sided for:-duration hysteresis, burn-rate urgency, signal
aggregation; the AutoscalerMonitor tick against a mock provider and a
scripted GCS: pre-scale demand injection, launch-failure backoff that
never wedges the loop, drain-gated scale-down, change-gated decision
persistence; the serve controller's per-shard capacity bundles, with
GPUs), then parity with the JAX package: both policies and both monitors
fed the same seeded signal streams decide the same."""

import time

import numpy as np
import pytest

from ray_tpu.autoscaler import monitor as jmonitor
from ray_tpu.autoscaler import node_provider as jnode_provider
from ray_tpu.autoscaler import policy as jpolicy
from ray_tpu.autoscaler.autoscaler import StandardAutoscaler as JStandard
from ray_tpu.autoscaler.resource_demand_scheduler import \
    NodeTypeConfig as JNodeTypeConfig
from ray_tpu_torch.autoscaler import (MockProvider, NodeTypeConfig,
                                      StandardAutoscaler)
from ray_tpu_torch.autoscaler.monitor import AutoscalerMonitor
from ray_tpu_torch.autoscaler.node_provider import TAG_NODE_KIND
from ray_tpu_torch.autoscaler.policy import PolicyConfig, ScalingPolicy
from ray_tpu_torch.util import failpoint as fp

SEED = 1234


# ---------------------------------------------------------------------------
# ScalingPolicy units (pure: explicit clocks, no cluster)
# ---------------------------------------------------------------------------
def _policy(**over):
    base = dict(up_for_s=5.0, down_for_s=30.0)
    base.update(over)
    return ScalingPolicy(PolicyConfig(**base))


def test_policy_scale_up_needs_sustained_pressure():
    p = _policy()
    sig = {"cluster:pending_leases": 5.0}
    assert p.decide(sig, 0.0).action == "hold"
    assert p.decide(sig, 3.0).action == "hold"
    d = p.decide(sig, 5.5)
    assert d.action == "scale_up" and d.step == 1 and not d.urgent
    assert "pending_leases" in d.reason


def test_policy_pressure_blip_resets_the_edge():
    """The for:-duration edge restarts from zero when pressure clears
    mid-maturation — a blip never scales."""
    p = _policy()
    sig = {"cluster:pending_leases": 5.0}
    p.decide(sig, 0.0)
    p.decide({}, 3.0)            # pressure cleared: edge resets
    p.decide(sig, 4.0)           # back: must mature again from t=4
    assert p.decide(sig, 8.0).action == "hold"
    assert p.decide(sig, 9.5).action == "scale_up"


def test_policy_urgent_burn_skips_hysteresis_and_scales_step():
    """burn >= 1.0 means the error budget is actively burning: the
    decision is immediate (no up_for_s wait) and the step scales with
    the burn magnitude, capped at max_step."""
    p = _policy(max_step=4)
    d = p.decide({"serve:slo_burn_rate": 2.5}, 0.0)
    assert d.action == "scale_up" and d.urgent and d.step == 3
    d = _policy(max_step=4).decide({"serve:slo_burn_rate": 9.0}, 0.0)
    assert d.step == 4  # capped


def test_policy_prescales_below_alert_thresholds():
    """The ordering that IS the feature: arena 0.87 is below the
    ArenaPressure alert (0.9) but above the policy threshold (0.85);
    burn 0.6 is below ServeSLOBurnRate's 1.0 but above the policy's
    0.5 — both scale up, so capacity lands before any alert fires."""
    p = _policy()
    sig = {"cluster:arena_occupancy": 0.87}
    p.decide(sig, 0.0)
    assert p.decide(sig, 6.0).action == "scale_up"
    p2 = _policy()
    sig2 = {"serve:slo_burn_rate": 0.6}
    d = p2.decide(sig2, 0.0)
    assert d.action == "hold" and not d.urgent  # sub-1.0: hysteresis
    assert p2.decide(sig2, 6.0).action == "scale_up"


def test_policy_down_requires_sustained_quiet_with_data():
    p = _policy(down_for_s=10.0)
    quiet = {"cluster:pending_leases": 0.0, "cluster:arena_occupancy": 0.1}
    assert p.decide(quiet, 0.0).action == "hold"
    assert p.decide(quiet, 11.0).action == "allow_down"
    # NO data is not quiet: an empty signal map never unlocks the
    # down path, no matter how long it persists
    p2 = _policy(down_for_s=10.0)
    p2.decide({}, 0.0)
    assert p2.decide({}, 100.0).action == "hold"


def test_policy_trigger_resets_down_edge():
    p = _policy(down_for_s=10.0)
    quiet = {"cluster:pending_leases": 0.0}
    p.decide(quiet, 0.0)
    p.decide({"serve:slo_burn_rate": 3.0}, 8.0)  # urgent scale-up
    # quiet again, but the down edge restarts from t=9
    p.decide(quiet, 9.0)
    assert p.decide(quiet, 18.0).action == "hold"
    assert p.decide(quiet, 19.5).action == "allow_down"


def test_latest_signals_aggregation():
    """Per-tag series flatten to one value per signal: the LATEST point
    of each row, max-aggregated for worst-case signals (arena, burn)
    and summed for additive ones (pending leases per node)."""
    rows = [
        {"name": "cluster:pending_leases", "tags": {"node": "a"},
         "points": [[1.0, 9.0], [2.0, 3.0]]},
        {"name": "cluster:pending_leases", "tags": {"node": "b"},
         "points": [[2.0, 4.0]]},
        {"name": "cluster:arena_occupancy", "tags": {"node": "a"},
         "points": [[2.0, 0.2]]},
        {"name": "cluster:arena_occupancy", "tags": {"node": "b"},
         "points": [[2.0, 0.9]]},
        {"name": "serve:slo_burn_rate", "tags": {"deployment": "d"},
         "points": []},  # empty ring: no reading, not 0.0
    ]
    sig = ScalingPolicy.latest_signals(rows)
    assert sig["cluster:pending_leases"] == 7.0   # 3 + 4, latest points
    assert sig["cluster:arena_occupancy"] == 0.9  # worst node wins
    assert "serve:slo_burn_rate" not in sig


# ---------------------------------------------------------------------------
# AutoscalerMonitor tick (mock provider + scripted GCS)
# ---------------------------------------------------------------------------
class FakeGcs:
    """Scripted gcs_call: load snapshot + derived-signal rows in,
    drain verdicts out, every call recorded."""

    def __init__(self):
        self.nodes = []
        self.rows = []
        self.drain_reply = {"drained": True, "migrated": 0}
        self.calls = []
        self.kv = {}

    def __call__(self, method, data):
        self.calls.append((method, data))
        if method == "get_cluster_load":
            return {"nodes": list(self.nodes), "pending_demand": [],
                    "resource_requests": [],
                    "pending_placement_groups": []}
        if method == "get_timeseries":
            pfx = data["series"].rstrip("*")
            return [r for r in self.rows if r["name"].startswith(pfx)]
        if method == "drain_node":
            return dict(self.drain_reply)
        if method == "kv_put":
            self.kv[data["key"]] = data["value"]
            return True
        raise AssertionError(f"unexpected gcs_call {method}")

    def set_signals(self, **signals):
        self.rows = [{"name": k.replace("__", ":"), "tags": {},
                      "points": [[0.0, v]]}
                     for k, v in signals.items()]


def _gcs_node(nid, total, avail, load=0):
    return {"node_id": nid + "0" * (32 - len(nid)), "alive": True,
            "resources_total": total, "resources_available": avail,
            "load": load}


def _monitor(gcs, *, idle_timeout_s=60.0, policy=None, max_workers=5,
             **kw):
    provider = MockProvider()
    asc = StandardAutoscaler(
        provider, {"cpu4": NodeTypeConfig(resources={"CPU": 4},
                                          max_workers=max_workers)},
        idle_timeout_s=idle_timeout_s)
    m = AutoscalerMonitor(asc, policy=policy or ScalingPolicy(),
                          gcs_call=gcs, **kw)
    return m, provider


def test_monitor_urgent_burn_launches_node_shaped_capacity():
    """An urgent burn signal with ZERO queued demand still launches:
    the monitor injects whole-node bundles, so the packer cannot
    satisfy the pre-scale from capacity the signals proved short."""
    gcs = FakeGcs()
    gcs.nodes = [_gcs_node("head", {"CPU": 1}, {"CPU": 0}, load=2)]
    gcs.set_signals(**{"serve__slo_burn_rate": 2.0})
    m, provider = _monitor(gcs)
    out = m.run_once(now=0.0)
    assert out["decision"]["action"] == "scale_up"
    assert out["decision"]["urgent"] and out["decision"]["step"] == 2
    assert out["launched"] == {"cpu4": 2}
    assert len(provider.non_terminated_nodes(
        {TAG_NODE_KIND: "worker"})) == 2


def test_monitor_launch_failure_backs_off_and_never_wedges():
    """A failed provider launch is counted, holds off relaunches with
    exponential backoff, and NEVER raises out of the tick; standing
    pressure relaunches once the holdoff expires."""
    gcs = FakeGcs()
    gcs.nodes = [_gcs_node("head", {"CPU": 1}, {"CPU": 0}, load=2)]
    gcs.set_signals(**{"serve__slo_burn_rate": 1.0})
    m, provider = _monitor(gcs, launch_backoff_s=0.1,
                           max_launch_backoff_s=0.4)
    fp.arm("autoscaler.provider.launch_fail", "drop", count=2, seed=SEED)
    try:
        m.run_once(now=0.0)  # fails: no exception escapes
        assert m.launch_failures == 1
        assert provider.non_terminated_nodes({}) == []
        m.run_once(now=1.0)  # inside the holdoff: suppressed
        assert m.launches_suppressed >= 1
        assert m.launch_failures == 1
        time.sleep(0.15)
        m.run_once(now=2.0)  # holdoff expired: fails again, backoff x2
        assert m.launch_failures == 2
        assert m._launch_backoff == pytest.approx(0.4)
        time.sleep(0.25)
        m.run_once(now=3.0)  # failpoint exhausted: launch lands
        assert provider.non_terminated_nodes(
            {TAG_NODE_KIND: "worker"})
        assert fp.fire_count("autoscaler.provider.launch_fail") == 2
    finally:
        fp.disarm_all()


def _idle_worker_cluster(gcs, m, provider):
    """Launch one worker via demand, then report it joined + idle."""
    gcs.set_signals(**{"serve__slo_burn_rate": 1.0})
    m.run_once(now=0.0)
    wid = provider.non_terminated_nodes({TAG_NODE_KIND: "worker"})[0]
    gcs.nodes = [_gcs_node("head", {"CPU": 1}, {"CPU": 1}),
                 _gcs_node(wid, {"CPU": 4}, {"CPU": 4})]
    return wid


def test_monitor_terminate_suppressed_until_quiet_edge():
    """Idle past the timeout but the policy's quiet edge hasn't
    matured (here: NO signal data at all): every terminate is refused
    and the node stays."""
    gcs = FakeGcs()
    gcs.nodes = [_gcs_node("head", {"CPU": 1}, {"CPU": 0}, load=2)]
    m, provider = _monitor(gcs, idle_timeout_s=0.05)
    _idle_worker_cluster(gcs, m, provider)
    gcs.rows = []  # signal plane dark: no data is never quiet
    m.run_once(now=10.0)   # notices idle
    time.sleep(0.1)
    m.run_once(now=100.0)  # idle past timeout, but down gate closed
    assert m.terminations_suppressed >= 1
    assert len(provider.non_terminated_nodes(
        {TAG_NODE_KIND: "worker"})) == 1


def test_monitor_drain_then_terminate_on_allow_down():
    """The quiet edge matured: the idle node is DRAINED first and
    terminated only on the GCS's drained=True verdict."""
    gcs = FakeGcs()
    gcs.nodes = [_gcs_node("head", {"CPU": 1}, {"CPU": 0}, load=2)]
    m, provider = _monitor(
        gcs, idle_timeout_s=0.05,
        policy=ScalingPolicy(PolicyConfig(down_for_s=0.0)))
    wid = _idle_worker_cluster(gcs, m, provider)
    gcs.set_signals(**{"cluster__pending_leases": 0.0})
    gcs.drain_reply = {"drained": True, "migrated": 3,
                       "spill_handed_off": 1}
    m.run_once(now=10.0)
    time.sleep(0.1)
    m.run_once(now=100.0)
    assert provider.non_terminated_nodes({TAG_NODE_KIND: "worker"}) == []
    assert m.drains_completed == 1
    drains = [d for meth, d in gcs.calls if meth == "drain_node"]
    assert drains and drains[0]["node_id"] == bytes.fromhex(
        wid + "0" * 24)


def test_monitor_aborted_drain_keeps_the_node():
    """drained=False (migration failed): the provider node is NOT
    released — an aborted drain leaves the node serving."""
    gcs = FakeGcs()
    gcs.nodes = [_gcs_node("head", {"CPU": 1}, {"CPU": 0}, load=2)]
    m, provider = _monitor(
        gcs, idle_timeout_s=0.05,
        policy=ScalingPolicy(PolicyConfig(down_for_s=0.0)))
    _idle_worker_cluster(gcs, m, provider)
    gcs.set_signals(**{"cluster__pending_leases": 0.0})
    gcs.drain_reply = {"drained": False, "error": "migration failed"}
    m.run_once(now=10.0)
    time.sleep(0.1)
    m.run_once(now=100.0)
    assert m.drains_aborted >= 1
    assert len(provider.non_terminated_nodes(
        {TAG_NODE_KIND: "worker"})) == 1


def test_monitor_unregistered_node_terminates_without_drain():
    """A provider node that never joined the GCS (failed-launch
    remnant) holds no objects: plain terminate, no drain RPC."""
    gcs = FakeGcs()
    gcs.nodes = [_gcs_node("head", {"CPU": 1}, {"CPU": 1})]
    m, provider = _monitor(
        gcs, idle_timeout_s=0.0,
        policy=ScalingPolicy(PolicyConfig(down_for_s=0.0)))
    m._allow_down = True
    provider.create_node({}, {TAG_NODE_KIND: "worker"}, 1)
    wid = provider.non_terminated_nodes({TAG_NODE_KIND: "worker"})[0]
    m.autoscaler.provider.terminate_node(wid)  # through the proxy
    assert provider.non_terminated_nodes({TAG_NODE_KIND: "worker"}) == []
    assert not any(meth == "drain_node" for meth, _ in gcs.calls)


def test_monitor_persists_decisions_change_gated():
    """The last-decision KV record is written on actions and state
    CHANGES only — a steady stream of hold ticks must not grind the
    WAL-backed KV."""
    from ray_tpu_torch.core.gcs import AUTOSCALER_DECISION_KV_KEY

    gcs = FakeGcs()
    gcs.nodes = [_gcs_node("head", {"CPU": 1}, {"CPU": 1})]
    gcs.set_signals(**{"cluster__pending_leases": 0.0})
    m, _provider = _monitor(gcs)
    for i in range(5):
        m.run_once(now=float(i))
    puts = [d for meth, d in gcs.calls if meth == "kv_put"]
    assert len(puts) == 1  # first hold recorded, repeats gated
    assert AUTOSCALER_DECISION_KV_KEY in gcs.kv
    # an action writes again
    gcs.set_signals(**{"serve__slo_burn_rate": 2.0})
    m.run_once(now=10.0)
    puts = [d for meth, d in gcs.calls if meth == "kv_put"]
    assert len(puts) == 2


# ---------------------------------------------------------------------------
# Serve controller: gang-aware (card-shaped) capacity requests
# ---------------------------------------------------------------------------
def test_replica_bundles_are_per_shard_shapes():
    """A sharded deployment asks for shards-worth of GPUs, not replica
    counts: target x num_shards bundles of the per-shard resource
    shape."""
    from ray_tpu_torch.serve._internal import ServeController
    ServeController = ServeController._cls  # unwrap the actor class

    class Cfg:
        ray_actor_options = {"num_cpus": 2, "num_gpus": 1}
        num_shards = 4

    bundles = ServeController._replica_bundles(Cfg(), 2)
    assert len(bundles) == 8
    assert all(b == {"CPU": 2.0, "GPU": 1.0} for b in bundles)

    class Plain:
        ray_actor_options = {}
        num_shards = 1

    assert ServeController._replica_bundles(Plain(), 3) == [
        {"CPU": 1.0}] * 3
    assert ServeController._replica_bundles(Plain(), 0) == []


# ---------------------------------------------------------------------------
# parity with the JAX package on seeded signal streams
# ---------------------------------------------------------------------------
_SIGNALS = ("cluster:pending_leases", "cluster:arena_occupancy",
            "serve:shed_rate", "serve:slo_burn_rate")


def _signal_stream(seed, ticks=60):
    """Seeded (now, signals) ticks: pressure, quiet and gaps in bursts."""
    rng = np.random.default_rng(seed)
    now, out = 0.0, []
    level = {name: 0.0 for name in _SIGNALS}
    for _ in range(ticks):
        now += float(rng.choice([0.5, 1.0, 2.0, 7.0]))
        if rng.random() < 0.12:  # a quiet regime
            level = dict.fromkeys(_SIGNALS, 0.0)
        elif rng.random() < 0.15:  # a pressure regime
            level = {"cluster:pending_leases": float(rng.integers(0, 4)),
                     "cluster:arena_occupancy": float(rng.random()),
                     "serve:shed_rate": float(rng.choice([0.0, 0.0, 0.5])),
                     "serve:slo_burn_rate": float(rng.choice(
                         [0.0, 0.1, 0.3, 0.7, 1.5, 3.2]))}
        signals = {k: v for k, v in level.items() if rng.random() < 0.9}
        if rng.random() < 0.05:
            signals = {}  # a dark tick
        out.append((now, signals))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_policy_decisions_match_jax(seed):
    cfg = dict(up_for_s=5.0, down_for_s=12.0, max_step=3)
    ours = ScalingPolicy(PolicyConfig(**cfg))
    theirs = jpolicy.ScalingPolicy(jpolicy.PolicyConfig(**cfg))
    actions = set()
    for now, signals in _signal_stream(seed):
        a = ours.decide(dict(signals), now).to_dict()
        b = theirs.decide(dict(signals), now).to_dict()
        assert a == b, (now, signals)
        actions.add(a["action"])
    assert "scale_up" in actions


@pytest.mark.parametrize("seed", range(3))
def test_latest_signals_match_jax(seed):
    rng = np.random.default_rng(seed)
    rows = [{"name": str(rng.choice(_SIGNALS + ("serve:p99_latency_s",))),
             "tags": {"node": str(i)},
             "points": [[float(t), float(rng.random() * 3)]
                        for t in range(int(rng.integers(0, 4)))]}
            for i in range(12)]
    assert ScalingPolicy.latest_signals(rows) == \
        jpolicy.ScalingPolicy.latest_signals(rows)


def _drive_monitor(seed, pkg):
    """A seeded run of the monitor's tick over a scripted GCS: the
    signals of _signal_stream, a head without free CPU, the launched
    workers reported joined and idle one tick later, drains that succeed
    or abort at random.  Returns each tick's decision and what the
    packer and the drain protocol did."""
    (Standard, NodeType, Monitor, Provider, Policy, Config) = pkg
    rng = np.random.default_rng(seed + 100)
    gcs = FakeGcs()
    provider = Provider()
    asc = Standard(provider, {"gpu": NodeType(resources={"CPU": 2,
                                                         "GPU": 1},
                                              max_workers=3)},
                   idle_timeout_s=0.0)
    m = Monitor(asc, policy=Policy(Config(up_for_s=3.0, down_for_s=6.0)),
                gcs_call=gcs)
    out = []
    for now, signals in _signal_stream(seed, ticks=30):
        gcs.rows = [{"name": k, "tags": {}, "points": [[now, v]]}
                    for k, v in signals.items()]
        gcs.drain_reply = {"drained": bool(rng.random() < 0.7)}
        workers = provider.non_terminated_nodes({TAG_NODE_KIND: "worker"})
        gcs.nodes = [_gcs_node("head", {"CPU": 1}, {"CPU": 0}, load=1)] + [
            _gcs_node(w, {"CPU": 2, "GPU": 1}, {"CPU": 2, "GPU": 1})
            for w in workers]
        r = m.run_once(now=now)
        time.sleep(0.002)  # idle clocks move past the zero timeout
        out.append((r["decision"], r["launched"], len(r["terminated"]),
                    r["num_workers"], m.drains_completed, m.drains_aborted,
                    m.terminations_suppressed))
    return out


# streams whose ticks both launch and drain (of seeds 0-7, 2-5 do not)
@pytest.mark.parametrize("seed", [0, 1, 6, 7])
def test_monitor_ticks_match_jax(seed):
    ours = _drive_monitor(seed, (StandardAutoscaler, NodeTypeConfig,
                                 AutoscalerMonitor, MockProvider,
                                 ScalingPolicy, PolicyConfig))
    theirs = _drive_monitor(seed, (JStandard, JNodeTypeConfig,
                                   jmonitor.AutoscalerMonitor,
                                   jnode_provider.MockProvider,
                                   jpolicy.ScalingPolicy,
                                   jpolicy.PolicyConfig))
    assert ours == theirs
    assert any(step[1] for step in ours)  # it launched
    assert ours[-1][4] + ours[-1][5] > 0  # and drained
