"""The port's state API (``ray_tpu_torch.experimental.state``) on the CPU.

Counterparts of tests/test_state_api.py's cases that need no dashboard
(tasks and their summary, actors / nodes / workers, objects and the
store's stats, the Chrome trace of ``timeline()``, tracing propagation,
cluster events and node stats) on one port cluster for the module.  Then
parity with the JAX package: the pure functions of ``analyze``,
``traces`` and ``incidents`` fed the same recorded event and span lists
in both packages give equal output, and the live ``list_*`` rows of the
same small workload have the same keys in both (the JAX cluster runs in
a subprocess started with the module, so the two runtimes never share a
process)."""

import json
import os
import subprocess
import sys
import textwrap
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu.experimental.state import analyze as janalyze
from ray_tpu.experimental.state import incidents as jincidents
from ray_tpu.experimental.state import traces as jtraces
from ray_tpu_torch.experimental.state import analyze as tanalyze
from ray_tpu_torch.experimental.state import api as state
from ray_tpu_torch.experimental.state import incidents as tincidents
from ray_tpu_torch.experimental.state import traces as ttraces

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the workload both packages run for the key comparison, and what each
#: prints: the sorted keys of every row of each listing
_KEYS_SCRIPT = textwrap.dedent("""
    import json, sys, time
    pkg = __import__(sys.argv[1])
    from importlib import import_module
    state = import_module(sys.argv[1] + ".experimental.state.api")
    pkg.init(num_cpus=2)

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
    ref = pkg.put(bytes(2_000_000))
    time.sleep(1.5)  # task event flush period
    out = {}
    for name in ("list_tasks", "list_actors", "list_nodes",
                 "list_workers", "list_objects", "object_store_stats",
                 "list_jobs"):
        rows = getattr(state, name)()
        out[name] = sorted({k for r in rows for k in r})
    summary = state.summarize_tasks()
    out["summarize_tasks"] = sorted({s for v in summary.values() for s in v})
    print("KEYS " + json.dumps(out), flush=True)
    pkg.shutdown()
""")


def _keys_run(package, env_extra=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    env.update(env_extra or {})
    return subprocess.Popen([sys.executable, "-c", _KEYS_SCRIPT, package],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)


@pytest.fixture(scope="module")
def jax_keys():
    """The JAX package's listing keys, from a subprocess started with
    the module so that it runs beside the port's cases."""
    proc = _keys_run("ray_tpu")
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=10)


@pytest.fixture(scope="module", autouse=True)
def cluster(jax_keys):
    rt.init(num_cpus=2, num_gpus=0)
    yield
    rt.shutdown()


# the remote functions are made inside fixtures, so that they pickle by
# value: a module-level one makes each worker import this file (and the
# JAX package's modules with it)
@pytest.fixture(scope="module")
def quick():
    @rt.remote
    def quick(x):
        return x + 1
    return quick


@pytest.fixture(scope="module")
def named():
    @rt.remote
    class Named:
        def ping(self):
            return "pong"
    return Named


def test_list_tasks_and_summary(quick):
    rt.get([quick.remote(i) for i in range(5)], timeout=60)
    time.sleep(1.5)  # task event flush period
    rows = state.list_tasks()
    mine = [r for r in rows if "quick" in r["name"]]
    assert len(mine) >= 5
    assert all(r["state"] == "FINISHED" for r in mine)
    summary = state.summarize_tasks()
    name = next(k for k in summary if "quick" in k)
    assert summary[name]["FINISHED"] >= 5


def test_list_actors_nodes_workers(named):
    a = named.options(name="state-test-actor").remote()
    assert rt.get(a.ping.remote(), timeout=60) == "pong"
    actors = state.list_actors(filters=[("state", "=", "ALIVE")])
    assert any(r.get("name") == "state-test-actor" for r in actors)
    nodes = state.list_nodes()
    assert len(nodes) >= 1 and nodes[0]["state"] == "ALIVE"
    workers = state.list_workers()
    assert any(w["is_actor"] for w in workers)


def test_list_objects_and_store_stats():
    refs = [rt.put(bytes(2_000_000)) for _ in range(3)]
    objs = state.list_objects()
    assert len(objs) >= 3
    stats = state.object_store_stats()
    assert stats and stats[0]["used"] > 0
    del refs


def test_timeline_chrome_trace(tmp_path, quick):
    rt.get([quick.remote(i) for i in range(3)], timeout=60)
    time.sleep(1.5)
    path = tmp_path / "trace.json"
    events = rt.timeline(str(path))
    assert any("quick" in e["name"] for e in events)
    loaded = json.loads(path.read_text())
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in loaded)


def test_tracing_propagation():
    """Opt-in tracing: context injected at submission, extracted in the
    worker (no SDK installed -> no-op spans, carrier still flows)."""
    from ray_tpu_torch.util import tracing

    assert tracing.enable_tracing()
    try:
        @rt.remote
        def traced():
            return "traced-ok"

        assert rt.get(traced.remote(), timeout=60) == "traced-ok"
    finally:
        import ray_tpu_torch.util.tracing.tracing_helper as th
        th._enabled = False


def test_cluster_events_and_node_stats():
    """Structured events reach the GCS ring buffer and per-node reporter
    stats appear in the node table."""
    @rt.remote
    class Doomed:
        def ping(self):
            return 1

    a = Doomed.remote()
    rt.get(a.ping.remote())
    rt.kill(a)
    deadline = time.monotonic() + 30
    events = []
    while time.monotonic() < deadline:
        events = state.list_cluster_events()
        if any(e["label"] == "ACTOR_DEAD" for e in events):
            break
        time.sleep(0.2)
    assert any(e["label"] == "ACTOR_DEAD" for e in events), events[-5:]
    assert all("severity" in e and "source_type" in e for e in events)

    deadline = time.monotonic() + 30
    stats = []
    while time.monotonic() < deadline:
        stats = state.node_stats()
        if stats and stats[0].get("mem_total"):
            break
        time.sleep(0.2)
    assert stats and stats[0]["mem_total"] > 0
    assert "workers" in stats[0]


# ------------------------------------------------ parity with the JAX side --

@pytest.fixture(scope="module")
def recorded():
    """A chained workload's task events, exec spans and gang spans as
    the port's GCS recorded them: the inputs both packages' pure
    functions get."""
    @rt.remote
    def leaf(i):
        time.sleep(0.01)
        return i

    @rt.remote
    def join(*xs):
        return sum(xs)

    assert rt.get(join.remote(*[leaf.remote(i) for i in range(4)]),
                  timeout=60) == 6
    time.sleep(1.5)
    # the workers flush their spans about once a second, later on a host
    # that the rest of the suite loads
    deadline = time.monotonic() + 30
    while True:
        job = tanalyze._latest_job(tanalyze._core().gcs_call(
            "get_task_events", {"limit": 1000}))
        events, spans, gang = tanalyze._fetch(job, 100_000)
        if events and spans or time.monotonic() > deadline:
            break
        time.sleep(0.5)
    assert events and spans
    return job, events, spans, gang


def _mk(name, start, end, span_id, parent=None, tags=None, root=False):
    rec = {"trace_id": "t" * 16, "span_id": span_id, "parent_id": parent,
           "name": name, "start": start, "end": end, "status": "ok",
           "source": "unit"}
    if root:
        rec["root"] = True
    if tags:
        rec["tags"] = tags
    return rec


#: a serve request's spans, with an orphan (its parent never reported)
_TRACE_SPANS = [
    _mk("ingress:d", 0.0, 1.0, "r", root=True),
    _mk("proxy.dispatch", 0.05, 0.95, "d", parent="r"),
    _mk("router.assign", 0.05, 0.10, "a", parent="d"),
    _mk("exec:handle_request", 0.15, 0.90, "e", parent="d",
        tags={"slot": 1}),
    _mk("batch.queue", 0.15, 0.20, "q", parent="e"),
    _mk("batch.decode", 0.20, 0.90, "b", parent="e"),
    _mk("orphan", 0.3, 0.4, "o", parent="gone"),
]

_TRACE_ROW = {"trace_id": "t" * 16, "status": "error", "duration_s": 1.0,
              "deployment": "d", "slo_miss": True, "retried": True,
              "complete": True, "name": "ingress:d", "n_spans": 7}

#: an incident record with every section format_incident renders
_INCIDENT = {
    "id": "inc-0001", "kind": "death", "severity": "critical",
    "state": "open", "partial": True, "title": "worker died",
    "window": [1000.25, 1012.5], "opened_at": 1000.25,
    "last_update": 1012.5, "nodes": ["ab" * 14], "jobs": ["cd" * 4],
    "deployments": ["d"],
    "deaths": [{"ts": 1001.0, "source": "worker", "pid": 4242,
                "node": "ab" * 14, "reason": "SIGKILL", "torn": 2,
                "partial": True,
                "frames": [{"ts": 1000.5 + i, "type": "task_start",
                            "detail": f"f{i}"} for i in range(45)]}],
    "alerts": [{"ts": 1002.0, "severity": "warning", "rule": "Arena",
                "tags": {"node": "n1"}, "from": "ok", "to": "firing",
                "value": 0.975}],
    "links": {"alerts_firing": [{"severity": "critical", "rule": "SLO",
                                 "since": 1003.0}],
              "traces": [_TRACE_ROW],
              "timeseries": {"arena_used": [[1000.0 + i, float(i % 5)]
                                            for i in range(30)],
                             "empty": []},
              "recovery": {"restored": True, "actors_recovered": 2,
                           "wal_records_replayed": 9, "duration_s": 0.5},
              "profile_records": 12},
}


def test_analyze_functions_match_jax(recorded, monkeypatch):
    """``build_tasks``, ``critical_path``, ``analyze_job`` (its fetch
    replaced by the recorded lists), ``format_report`` and
    ``summary_line`` give the same output in both packages."""
    job, events, spans, gang = recorded
    tasks = tanalyze.build_tasks(events, spans)
    assert tasks == janalyze.build_tasks(events, spans)
    assert len(tasks) >= 5
    assert tanalyze.critical_path(tasks) == janalyze.critical_path(tasks)
    for mod in (tanalyze, janalyze):
        monkeypatch.setattr(mod, "_fetch",
                            lambda j, limit: (events, spans, gang))
    ours, theirs = tanalyze.analyze_job(job), janalyze.analyze_job(job)
    assert ours == theirs and "error" not in ours
    assert tanalyze.format_report(ours) == janalyze.format_report(theirs)
    assert tanalyze.summary_line(ours) == janalyze.summary_line(theirs)


def test_trace_functions_match_jax(recorded):
    """``build_tree``, ``phase_rollup``, ``perfetto_events`` (also on the
    recorded exec spans), ``format_trace`` and ``format_trace_list``."""
    spans = recorded[2]
    roots = ttraces.build_tree(_TRACE_SPANS)
    assert roots == jtraces.build_tree(_TRACE_SPANS)
    assert [r["span_id"] for r in roots] == ["r", "o"]
    assert ttraces.phase_rollup(roots[0]) == jtraces.phase_rollup(roots[0])
    for batch in (_TRACE_SPANS, spans):
        assert ttraces.perfetto_events(batch) == \
            jtraces.perfetto_events(batch)
    trace = dict(_TRACE_ROW, spans=_TRACE_SPANS)
    assert ttraces.format_trace(trace) == jtraces.format_trace(trace)
    assert ttraces.format_trace_list([_TRACE_ROW]) == \
        jtraces.format_trace_list([_TRACE_ROW])


def test_incident_functions_match_jax():
    """``format_incident`` (with and without linked trace trees) and
    ``format_incident_list``; the one line that names the CLI names each
    package's own."""
    def fetch(trace_id):
        return dict(_TRACE_ROW, spans=_TRACE_SPANS)

    for kw in ({}, {"fetch_trace": fetch}):
        ours = tincidents.format_incident(_INCIDENT, **kw)
        theirs = jincidents.format_incident(_INCIDENT, **kw)
        assert "(ray-tpu profile pulls" in theirs
        assert ours == theirs.replace("(ray-tpu profile pulls",
                                      "(the CLI's profile pulls")
    assert tincidents.format_incident(None) == \
        jincidents.format_incident(None)
    row = {"id": "inc-0001", "kind": "death", "severity": "critical",
           "state": "open", "opened_at": 1000.25, "n_deaths": 1,
           "n_alerts": 1, "title": "worker died", "partial": True}
    for rows in ([], [row]):
        assert tincidents.format_incident_list(rows) == \
            jincidents.format_incident_list(rows)


def test_live_listings_have_the_jax_keys(jax_keys):
    """The same small workload on both packages' clusters: every
    listing's rows carry the same keys."""
    ours = _keys_run("ray_tpu_torch")
    outs = []
    for proc in (ours, jax_keys):
        out, err = proc.communicate(timeout=240)
        assert proc.returncode == 0, err[-3000:]
        line = next(ln for ln in out.splitlines() if ln.startswith("KEYS "))
        outs.append(json.loads(line[len("KEYS "):]))
    assert outs[0] == outs[1]
    assert all(outs[0].values())
