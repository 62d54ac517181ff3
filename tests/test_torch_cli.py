"""The port's CLI (``python -m ray_tpu_torch.scripts.cli``) on the CPU:
counterparts of tests/test_cli.py's four cases on one head started by the
CLI for the module (with the ray:// client server ``start --head`` can
spawn beside it), ``init(address="auto")`` finding the recorded head,
and the subcommands of later ROADMAP items raising, naming them.  The
client server's case runs first and the case that stops the head
last."""

import json
import os
import socket
import subprocess
import sys
import textwrap
import time

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.scripts import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*argv, env_extra=None, timeout=120):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    env.update(env_extra or {})
    return subprocess.run(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", *argv],
        capture_output=True, text=True, timeout=timeout, env=env, cwd=REPO)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def cli_cluster(tmp_path_factory):
    """A head (and a client server) started via the CLI under a session
    root of the module's own, stopped via the CLI."""
    root = str(tmp_path_factory.mktemp("sessions"))
    env = {"RAY_TPU_TORCH_SESSION_ROOT": root}
    port = _free_port()
    out = _run("start", "--head", "--num-cpus", "2", "--num-gpus", "0",
               "--ray-client-server-port", str(port), env_extra=env)
    if out.returncode != 0:
        _run("stop", env_extra=env)  # a head it recorded must not outlive us
        pytest.fail(out.stderr)
    addr = [ln for ln in out.stdout.splitlines()
            if "GCS address" in ln][0].split(": ")[1]
    yield addr, env, port
    _run("stop", env_extra=env)


def test_start_head_spawns_the_client_server(cli_cluster):
    """The client server that ``start --head --ray-client-server-port``
    spawned answers ray:// connections.  It runs first: in both packages
    a driver's tasks wait forever on a head where an earlier driver ran
    tasks and exited (ROADMAP.md, queue 3)."""
    _, _, port = cli_cluster
    rt.init(address=f"ray://127.0.0.1:{port}")
    try:
        @rt.remote
        def add(a, b):
            return a + b

        assert rt.get(add.remote(20, 22), timeout=60) == 42
        assert rt.cluster_resources().get("CPU") == 2.0
    finally:
        rt.shutdown()


def test_cli_top_and_alerts(cli_cluster):
    """``top --once`` renders the health plane's frame and ``alerts``
    the (quiet) alert table through the real CLI."""
    addr, env, _ = cli_cluster
    out = _run("top", "--once", "--jobs", "--address", addr, env_extra=env)
    assert out.returncode == 0, out.stderr
    assert "health:" in out.stdout
    assert "job" in out.stdout  # the --jobs attribution table header
    out = _run("alerts", "--address", addr, env_extra=env)
    assert out.returncode == 0, out.stderr
    assert "no alerts firing" in out.stdout or "FIRING" in out.stdout
    out = _run("alerts", "--json", "--address", addr, env_extra=env)
    assert out.returncode == 0, out.stderr
    view = json.loads(out.stdout)
    assert {r["name"] for r in view["rules"]} >= {
        "ServeSLOBurnRate", "ArenaPressure"}


def test_cli_memory_and_summary(cli_cluster):
    addr, env, _ = cli_cluster
    out = _run("memory", "--address", addr, env_extra=env)
    assert out.returncode == 0, out.stderr
    assert "bytes" in out.stdout
    out = _run("summary", "tasks", "--address", addr, env_extra=env)
    assert out.returncode == 0, out.stderr


def test_cli_serve_status(cli_cluster):
    """``serve status`` against a cluster with a live deployment."""
    addr, env, _ = cli_cluster
    script = textwrap.dedent(f"""
        import ray_tpu_torch
        from ray_tpu_torch import serve
        ray_tpu_torch.init(address="{addr}")

        @serve.deployment(num_replicas=1)
        def hello(req):
            return "ok"

        serve.run(hello.bind(), name="cli_app")
        print("DEPLOYED", flush=True)
        from ray_tpu_torch.scripts.cli import main
        main(["serve", "status", "--address", "{addr}"])
        main(["serve", "shutdown", "--address", "{addr}"])
    """)
    out = subprocess.run([sys.executable, "-c", script],
                         capture_output=True, text=True, timeout=180,
                         env={**os.environ, **env}, cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "DEPLOYED" in out.stdout
    assert "hello" in out.stdout  # deployment visible in status
    assert "serve shut down" in out.stdout


def test_init_auto_finds_the_recorded_head(cli_cluster, monkeypatch):
    """``init(address="auto")`` without RAY_TPU_TORCH_ADDRESS connects
    to the head that ``start --head`` recorded, and ``timeline()``
    reads its task events."""
    addr, env, _ = cli_cluster
    monkeypatch.delenv("RAY_TPU_TORCH_ADDRESS", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    info = rt.init(address="auto")
    try:
        assert "{}:{}".format(*info["gcs_address"]) == addr

        @rt.remote
        def square(x):
            return x * x

        assert rt.get([square.remote(i) for i in range(4)],
                      timeout=60) == [0, 1, 4, 9]
        time.sleep(1.5)  # the task events' flush period
        assert any("square" in e["name"] for e in rt.timeline())
    finally:
        rt.shutdown()


def test_init_auto_without_a_head_raises(tmp_path, monkeypatch):
    monkeypatch.delenv("RAY_TPU_TORCH_ADDRESS", raising=False)
    monkeypatch.setenv("RAY_TPU_TORCH_SESSION_ROOT", str(tmp_path))
    with pytest.raises(rt.RayTpuError, match="no running cluster"):
        rt.init(address="auto")


@pytest.mark.parametrize("argv, item", [
    (["dashboard"], "queue 1, item 7.5"),
    (["job", "list"], "queue 1, item 7.5"),
    (["up", "cluster.yaml"], "queue 1, item 7.6"),
    (["down", "cluster.yaml"], "queue 1, item 7.6"),
    (["debug"], "queue 1, item 7.7"),
    (["metrics", "export-config"], "queue 1, item 7.7"),
])
def test_later_subcommands_raise_naming_their_item(argv, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main(argv)


def test_cli_start_status_list_stop(cli_cluster):
    addr, env, _ = cli_cluster
    out = _run("status", "--address", addr, env_extra=env)
    assert out.returncode == 0, out.stderr
    assert "alive" in out.stdout and "CPU" in out.stdout

    out = _run("list", "nodes", "--address", addr, env_extra=env)
    assert out.returncode == 0, out.stderr
    rows = json.loads(out.stdout)
    assert rows and rows[0]["state"] == "ALIVE"

    # default address resolution via latest_head.json
    out = _run("list", "actors", env_extra=env)
    assert out.returncode == 0, out.stderr

    out = _run("stop", env_extra=env)
    assert out.returncode == 0, out.stderr
    assert "SIGTERM" in out.stdout or "already gone" in out.stdout
