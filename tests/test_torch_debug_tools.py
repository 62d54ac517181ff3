"""The port's debugging and monitoring tools on the CPU:
``util.check_serialize.inspect_serializability`` against the JAX
package's on the same objects (counterparts of tests/test_debug_tools.py's
three cases), the remote pdb (``util.rpdb``) end to end on one cluster
for the module, with its own timeouts, and ``util.metrics_config``
against the JAX package's (the counterpart of
tests/test_state_api.py::test_metrics_export_config): the same files,
the same YAML and JSON once parsed, and every metric its default
Grafana dashboard queries present in a live port ``Dashboard``'s
``/metrics``."""

import io
import json
import os
import re
import socket
import threading
import time

import pytest
import yaml

import ray_tpu_torch as rt
from ray_tpu.util import check_serialize as jcheck
from ray_tpu.util import metrics_config as jmetrics
from ray_tpu_torch.util import check_serialize as tcheck
from ray_tpu_torch.util import metrics_config as tmetrics


@pytest.fixture(scope="module", autouse=True)
def cluster():
    rt.init(num_cpus=2)
    yield
    rt.shutdown()


class _Client:
    def __init__(self):
        self.sock = socket.socket()  # unpicklable leaf
        self.name = "fine"


def _leaf_culprit():
    return _Client()


def _closure_capture():
    lock = threading.Lock()

    def task():
        with lock:
            return 1

    return task


def _clean():
    return {"a": [1, 2], "b": "x"}


@pytest.mark.parametrize("make, name, culprit", [
    (_leaf_culprit, "client", "sock"),
    (_closure_capture, "task", "lock"),
    (_clean, "clean", None),
], ids=["leaf_culprit", "closure_capture", "clean_object"])
def test_inspect_serializability_matches_jax(make, name, culprit):
    """Both packages find the same culprits in the same object, and
    print them."""
    obj = make()
    try:
        results = {}
        for label, mod in (("jax", jcheck), ("torch", tcheck)):
            buf = io.StringIO()
            results[label] = mod.inspect_serializability(obj, name,
                                                         print_file=buf)
            if culprit is not None:
                assert culprit in buf.getvalue(), label
        assert results["torch"] == results["jax"]
        ok, culprits = results["torch"]
        if culprit is None:
            assert ok and not culprits
        else:
            assert not ok
            assert any(culprit in c for c in culprits), culprits
    finally:
        if isinstance(obj, _Client):
            obj.sock.close()


def _breakpoints(timeout):
    from ray_tpu_torch.util import rpdb
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        bps = rpdb.list_breakpoints()
        if bps:
            return bps
        time.sleep(0.2)
    return []


def test_remote_pdb_end_to_end():
    """A task pauses at set_trace; the driver finds the breakpoint in
    KV, attaches over TCP, inspects a local, and continues."""
    @rt.remote(num_cpus=0)
    def buggy():
        secret = 12345  # noqa: F841 — inspected through the debugger
        from ray_tpu_torch.util import rpdb
        rpdb.set_trace()
        return "resumed"

    ref = buggy.remote()
    from ray_tpu_torch.util import rpdb
    bps = _breakpoints(60)
    assert bps, "breakpoint never registered in KV"
    bp = bps[0]
    assert bp["task"].startswith("task ")

    sock = socket.create_connection((bp["host"], bp["port"]), timeout=10)
    try:
        sockfile = sock.makefile("rw", buffering=1)
        sockfile.write("p secret\n")
        sockfile.flush()
        deadline = time.monotonic() + 20
        seen = ""
        sock.settimeout(1.0)
        while time.monotonic() < deadline and "12345" not in seen:
            try:
                chunk = sock.recv(4096)
            except socket.timeout:
                continue
            if not chunk:
                break
            seen += chunk.decode(errors="replace")
        assert "12345" in seen, f"debugger did not evaluate local: {seen!r}"
        sockfile.write("c\n")
        sockfile.flush()
        assert rt.get(ref, timeout=60) == "resumed"
    finally:
        sock.close()
    # the breakpoint deregisters after the session
    deadline = time.monotonic() + 30
    while time.monotonic() < deadline and rpdb.list_breakpoints():
        time.sleep(0.2)
    assert not rpdb.list_breakpoints()


def _tree(root):
    """{relative path: parsed content} of a written config tree, with the
    tree's own root spelled ``<root>``."""
    out = {}
    for path in sorted(os.path.relpath(os.path.join(d, f), root)
                       for d, _, files in os.walk(root) for f in files):
        text = open(os.path.join(root, path)).read().replace(root, "<root>")
        if path.endswith(".json"):
            out[path] = json.loads(text)
        elif path.endswith(".yml"):
            out[path] = yaml.safe_load(text)
        else:
            out[path] = text
    return out


def test_metrics_export_config_matches_jax(tmp_path):
    """write_configs: the JAX package's files, returned in its order,
    with the same YAML, INI and JSON once parsed."""
    roots = {label: str(tmp_path / label) for label in ("jax", "torch")}
    written = {
        "jax": jmetrics.write_configs(roots["jax"],
                                      dashboard_address="127.0.0.1:9999"),
        "torch": tmetrics.write_configs(roots["torch"],
                                        dashboard_address="127.0.0.1:9999")}
    rel = {k: [os.path.relpath(p, roots[k]) for p in v]
           for k, v in written.items()}
    assert rel["torch"] == rel["jax"]
    assert {os.path.basename(p) for p in rel["torch"]} >= {
        "prometheus.yml", "grafana.ini", "default.yml",
        "ray_tpu_default.json"}
    assert _tree(roots["torch"]) == _tree(roots["jax"])
    prom = yaml.safe_load(open(os.path.join(roots["torch"],
                                            "prometheus.yml")))
    job = prom["scrape_configs"][0]
    assert job["metrics_path"] == "/metrics"
    assert job["static_configs"][0]["targets"] == ["127.0.0.1:9999"]


def test_dashboard_panels_query_live_metrics():
    """Every metric the default Grafana dashboard's panels query is in a
    live port dashboard's ``/metrics``."""
    import urllib.request

    from ray_tpu_torch.dashboard import Dashboard

    @rt.remote
    def one():
        return 1

    assert rt.get(one.remote(), timeout=60) == 1
    names = {m for panel in tmetrics._default_dashboard()["panels"]
             for target in panel["targets"]
             for m in re.findall(r"ray_tpu_[a-z_]+", target["expr"])}
    assert names == {"ray_tpu_tasks_finished_total",
                     "ray_tpu_object_store_used_bytes",
                     "ray_tpu_alive_nodes", "ray_tpu_actors_alive"}
    dash = Dashboard(port=0)
    url = dash.start()
    try:
        with urllib.request.urlopen(url + "/metrics", timeout=30) as r:
            text = r.read().decode()
    finally:
        dash.stop()
    exported = {line.split("{")[0].split(" ")[0]
                for line in text.splitlines()
                if line and not line.startswith("#")}
    assert names <= exported, names - exported
