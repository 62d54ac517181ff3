"""The port's dashboard, its per-node agents and job submission
(``ray_tpu_torch.dashboard``, ``dashboard_agent``, ``job``) on the CPU.

Counterparts of tests/test_state_api.py's dashboard cases (the JSON
routes, ``/metrics``, a job submitted over REST; the per-node agent's
registration, stats and log tails, and ``/api/node_stats`` preferring the
agents' rows), on one port cluster for the module.  Then: the job
routes' errors and ``stop``, the fall-back to the health beat when an
agent cannot be reached, the agent's refusal of paths outside its logs;
``_prometheus_text`` gives the JAX package's bytes for the same seeded
records; and every live route answers with the JAX package's keys for
the same small workload (the JAX cluster runs in a subprocess started
with the module, so the two runtimes never share a process)."""

import json
import os
import subprocess
import sys
import textwrap
import time
import urllib.error
import uuid
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.dashboard import _prometheus_text as jax_prometheus_text
from ray_tpu_torch.dashboard import Dashboard, _prometheus_text
from ray_tpu_torch.job import JobSubmissionClient

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the workload both packages run for the key comparison, and what it
#: returns: each route's keys (a dict's, or the union of a list's rows')
_COLLECT = textwrap.dedent("""
    def collect(name):
        import json, time, urllib.request
        from importlib import import_module
        pkg = import_module(name)
        Dashboard = import_module(name + ".dashboard").Dashboard
        Client = import_module(name + ".job").JobSubmissionClient
        worker = import_module(name + ".core.worker").global_worker()

        def get(url):
            with urllib.request.urlopen(url, timeout=30) as r:
                return json.loads(r.read())

        def keys(body):
            if isinstance(body, dict):
                return sorted(body)
            rows = [r for r in body if isinstance(r, dict)]
            return sorted({k for r in rows for k in r})

        @pkg.remote
        def quick(x):
            return x + 1

        @pkg.remote
        class Named:
            def ping(self):
                return "pong"

        a = Named.options(name="keys-actor").remote()
        pkg.get([quick.remote(i) for i in range(3)] + [a.ping.remote()],
                timeout=120)
        dash = Dashboard(port=0)
        url = dash.start()
        try:
            deadline = time.time() + 60
            while time.time() < deadline:
                stats = get(url + "/api/node_stats")
                if stats and all(r.get("source") == "agent" for r in stats):
                    break
                time.sleep(0.5)
            client = Client(url)
            sid = client.submit_job(entrypoint="echo keys")
            status = client.wait_until_finished(sid, timeout=120)
            time.sleep(1.5)  # task events' flush period
            out = {"job_status": status,
                   "job_logs": client.get_job_logs(sid),
                   "job_info": keys(client.get_job_info(sid))}
            for route in ("/api/nodes", "/api/actors", "/api/tasks",
                          "/api/placement_groups", "/api/cluster_status",
                          "/api/serve/applications", "/api/node_stats",
                          "/api/profile", "/api/analyze",
                          "/api/incidents", "/api/alerts", "/healthz",
                          "/api/jobs/"):
                out[route] = keys(get(url + route))
            # tail-sampled: whether a trace is kept depends on timing
            out["/api/traces"] = type(get(url + "/api/traces")).__name__
            out["node_stats_sources"] = sorted(
                {r.get("source") for r in get(url + "/api/node_stats")})
            agent_key = worker.gcs_call("kv_keys", {
                "namespace": "_internal", "prefix": "dashboard_agent:"})[0]
            entry = json.loads(worker.gcs_call("kv_get", {
                "namespace": "_internal", "key": agent_key}).decode())
            out["agent_entry"] = sorted(entry)
            addr = "http://" + entry["address"]
            stats = get(addr + "/api/local/stats")
            out["agent_stats"] = keys(stats)
            out["agent_workers"] = keys(stats["workers"])
            out["agent_kinds"] = sorted({w["kind"] for w in stats["workers"]})
            out["agent_logs"] = keys(get(addr + "/api/local/logs"))
            out["agent_healthz"] = keys(get(addr + "/healthz"))
            with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
                text = r.read().decode()
                out["metrics_type"] = r.headers.get("Content-Type")
            out["metrics_core"] = sorted(
                n for n in ("ray_tpu_alive_nodes", "ray_tpu_actors_alive",
                            "ray_tpu_tasks_finished_total",
                            "ray_tpu_object_store_used_bytes")
                if n in text)
            return out
        finally:
            dash.stop()
""")

_KEYS_SCRIPT = _COLLECT + textwrap.dedent("""
    import json, sys
    pkg = __import__(sys.argv[1])
    pkg.init(num_cpus=2)
    print("KEYS " + json.dumps(collect(sys.argv[1])), flush=True)
    pkg.shutdown()
""")


@pytest.fixture(scope="module")
def jax_keys():
    """The JAX package's route keys, from a subprocess started with the
    module so that it runs beside the port's cases."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", _KEYS_SCRIPT, "ray_tpu"],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=10)


@pytest.fixture(scope="module", autouse=True)
def cluster(jax_keys):
    rt.init(num_cpus=2, num_gpus=0)
    yield
    rt.shutdown()


@pytest.fixture(scope="module")
def dashboard():
    dash = Dashboard(port=0)
    url = dash.start()
    yield url
    dash.stop()


def _get(url, timeout=30):
    with urllib.request.urlopen(url, timeout=timeout) as r:
        return json.loads(r.read())


def test_live_routes_have_the_jax_keys(jax_keys):
    """Runs first: its job's entrypoint runs no task, and a later job's
    driver in this module runs tasks (ROADMAP.md, queue 3, item 9)."""
    ns = {"__name__": "route_keys"}
    exec(_COLLECT, ns)
    ours = ns["collect"]("ray_tpu_torch")
    out, err = jax_keys.communicate(timeout=300)
    assert jax_keys.returncode == 0, err[-3000:]
    theirs = json.loads([ln for ln in out.splitlines()
                         if ln.startswith("KEYS ")][-1][5:])
    assert ours == theirs
    assert ours["job_status"] == "SUCCEEDED"
    assert ours["node_stats_sources"] == ["agent"]
    assert "daemon" in ours["agent_kinds"]


def test_dashboard_and_job_submission(dashboard, tmp_path):
    url = dashboard
    nodes = _get(url + "/api/nodes")
    assert nodes and nodes[0]["state"] == "ALIVE"
    status = _get(url + "/api/cluster_status")
    assert status["cluster_resources"].get("CPU", 0) > 0
    with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
        text = r.read().decode()
    # core cluster gauges are always exported (the generated Grafana
    # dashboard's panels query exactly these names)
    assert "ray_tpu_alive_nodes" in text
    assert "ray_tpu_object_store_used_bytes" in text
    assert "ray_tpu_actors_alive" in text
    assert "ray_tpu_tasks_finished_total" in text

    client = JobSubmissionClient(url)
    script = tmp_path / "job.py"
    script.write_text(
        "import sys, ray_tpu_torch\n"
        "ray_tpu_torch.init()\n"
        "@ray_tpu_torch.remote\n"
        "def f():\n"
        "    return 40 + 2\n"
        "print('answer:', ray_tpu_torch.get(f.remote()))\n"
        "print('torch loaded:', 'torch' in sys.modules)\n")
    sid = client.submit_job(
        entrypoint=f"{sys.executable} {script}",
        metadata={"owner": "tests"})
    final = client.wait_until_finished(sid, timeout=120)
    logs = client.get_job_logs(sid)
    assert final == "SUCCEEDED", logs
    assert "answer: 42" in logs
    assert "torch loaded: False" in logs
    jobs = client.list_jobs()
    mine = [j for j in jobs if j["submission_id"] == sid]
    assert mine and mine[0]["metadata"] == {"owner": "tests"}
    assert mine[0]["exit_code"] == 0


def test_job_routes_errors_and_stop(dashboard):
    """A failing entrypoint is FAILED with its exit code; ``stop`` of a
    finished job answers False; a duplicate id is a 400, an unknown one a
    404, a body without an entrypoint a 400.  (``stop`` of a running job
    waits behind the supervisor's ``wait`` and times out, in both
    packages: ROADMAP.md, queue 3.)"""
    client = JobSubmissionClient(dashboard)
    sid = client.submit_job(entrypoint="echo failing; exit 3",
                            submission_id=f"failing-{uuid.uuid4().hex}")
    assert client.wait_until_finished(sid, timeout=60) == "FAILED"
    info = client.get_job_info(sid)
    assert info["exit_code"] == 3 and info["end_time"] >= info["start_time"]
    assert client.get_job_logs(sid) == "failing\n"
    assert client.stop_job(sid) is False  # already terminal
    with pytest.raises(RuntimeError, match="400.*already exists"):
        client.submit_job(entrypoint="true", submission_id=sid)
    with pytest.raises(RuntimeError, match="404"):
        client.get_job_status("no-such-job")
    with pytest.raises(RuntimeError, match="404"):
        client.get_job_logs("no-such-job")
    req = urllib.request.Request(
        dashboard + "/api/jobs/", data=b"{}", method="POST",
        headers={"Content-Type": "application/json"})
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(req, timeout=30)
    assert e.value.code == 400
    assert json.loads(e.value.read()) == {"error": "entrypoint required"}


def _agent_address():
    from ray_tpu_torch.core import worker as worker_mod

    w = worker_mod.global_worker()
    deadline = time.monotonic() + 30
    keys = []
    while time.monotonic() < deadline and not keys:
        keys = w.gcs_call("kv_keys", {"namespace": "_internal",
                                      "prefix": "dashboard_agent:"})
        if not keys:
            time.sleep(0.5)
    assert keys, "dashboard agent never registered"
    entry = json.loads(w.gcs_call("kv_get", {"namespace": "_internal",
                                             "key": keys[0]}).decode())
    assert entry["ts"] > 0  # liveness beat timestamp
    return entry["address"]


def test_per_node_dashboard_agent(dashboard):
    """The per-node agent (reference dashboard/agent.py) registers in
    the GCS KV, serves node-local stats + log tails over HTTP, and the
    head dashboard's /api/node_stats prefers agent data over the
    health-beat fallback."""
    addr = _agent_address()
    stats = _get(f"http://{addr}/api/local/stats", timeout=15)
    assert "cpu_percent" in stats and isinstance(stats["workers"], list)
    logs = _get(f"http://{addr}/api/local/logs", timeout=15)["logs"]
    assert logs  # session log dir is populated by this cluster
    assert any(n.startswith("dashboard-agent-") for n in logs)
    rows = _get(dashboard + "/api/node_stats")
    assert any(row.get("source") == "agent" for row in rows), rows


def test_agent_log_tails_stay_in_the_session(dashboard):
    addr = _agent_address()
    name = next(n for n in _get(f"http://{addr}/api/local/logs")["logs"]
                if n.startswith("dashboard-agent-") and n.endswith(".err"))
    lines = _get(f"http://{addr}/api/local/logs?name={name}&lines=5")
    assert len(lines["lines"]) <= 5
    for bad, code in (("..%2Fx", 400), ("a/b", 400), ("no-such.log", 404)):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(
                f"http://{addr}/api/local/logs?name={bad}", timeout=15)
        assert e.value.code == code, bad


def test_node_stats_fall_back_to_the_health_beat(monkeypatch):
    """An agent that cannot be reached leaves its node's row to the
    health beat's snapshot."""
    dash = Dashboard(port=0)

    async def unreachable():
        from ray_tpu_torch.experimental.state.api import node_stats
        return {r["node_id"].hex() if isinstance(r["node_id"], bytes)
                else str(r["node_id"]): "127.0.0.1:9" for r in node_stats()}

    monkeypatch.setattr(dash, "_agent_addresses", unreachable)
    url = dash.start()
    try:
        rows = _get(url + "/api/node_stats")
    finally:
        dash.stop()
    assert rows and {r["source"] for r in rows} == {"health_beat"}


def test_healthz_and_metrics_formats(dashboard):
    with urllib.request.urlopen(dashboard + "/healthz", timeout=30) as r:
        assert r.status == 200
        assert json.loads(r.read())["ok"] is True
    for query in ("", "?openmetrics=1"):
        with urllib.request.urlopen(dashboard + "/metrics" + query,
                                    timeout=30) as r:
            assert r.headers.get("Content-Type").startswith("text/plain")
            text = r.read().decode()
        assert text.endswith("\n") and "# TYPE ray_tpu_alive_nodes gauge" \
            in text


def _records(seed):
    """Seeded metric records of every type, with tags that need
    escaping and histogram exemplars."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(int(rng.integers(3, 9))):
        kind = str(rng.choice(["counter", "gauge", "histogram"]))
        rec = {"name": f"ray_tpu_test.metric-{i % 4}", "type": kind,
               "tags": {k: str(rng.choice(['a', 'b"q', 'c\\d', 'e\nf',
                                           '/tmp/x']))
                        for k in rng.choice(["node", "job", "route"],
                                            int(rng.integers(0, 3)),
                                            replace=False)}}
        if rng.random() < 0.6:
            rec["description"] = str(rng.choice(
                ["plain", "with\\backslash", "two\nlines"]))
        if kind == "histogram":
            bounds = sorted(float(x) for x in rng.random(3) * 10)
            rec.update(boundaries=bounds,
                       buckets=[int(x) for x in rng.integers(0, 5, 4)],
                       sum=float(rng.random() * 100), count=7)
            if rng.random() < 0.5:
                rec["exemplars"] = {
                    int(rng.integers(0, 4)): {
                        "trace_id": f"t{i}", "value": float(rng.random()),
                        "ts": 1700000000.5}}
        else:
            rec["value"] = float(rng.integers(0, 100)) \
                if rng.random() < 0.5 else float(rng.random())
        out.append(rec)
    return out


@pytest.mark.parametrize("exemplars", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_prometheus_text_matches_jax(seed, exemplars):
    records = _records(seed)
    assert _prometheus_text(records, exemplars=exemplars) == \
        jax_prometheus_text(records, exemplars=exemplars)
