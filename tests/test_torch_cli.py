"""The port's CLI (``python -m ray_tpu_torch.scripts.cli``) on the CPU:
counterparts of tests/test_cli.py's four cases on one head started by the
CLI for the module (with the ray:// client server ``start --head`` can
spawn beside it), ``init(address="auto")`` finding the recorded head,
``dashboard`` serving it, ``job submit/status/logs/list/stop`` through
that dashboard, ``up`` / ``down`` of a local-provider cluster, and the
subcommands of later ROADMAP items raising, naming them.  The
client server's case runs first and the case that stops the head
last."""

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
import urllib.request

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


@pytest.fixture(scope="module")
def cli_dashboard(cli_cluster):
    """``dashboard`` run by the CLI against the module's head, until
    the module ends (ctrl-c stops it)."""
    addr, env, _ = cli_cluster
    port = _free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "ray_tpu_torch.scripts.cli", "dashboard",
         "--port", str(port), "--address", addr],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        cwd=REPO, env={**os.environ, **env, "PYTHONPATH": REPO + os.pathsep
                       + os.environ.get("PYTHONPATH", "")})
    line = proc.stdout.readline()
    if "dashboard at" not in line:
        proc.kill()
        pytest.fail(line + proc.stderr.read()[-3000:])
    yield line.split("dashboard at ", 1)[1].split()[0]
    proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait(timeout=10)


def _json_get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


def test_cli_dashboard_serves_the_head(cli_dashboard):
    nodes = _json_get(cli_dashboard + "/api/nodes")
    assert len(nodes) == 1 and nodes[0]["state"] == "ALIVE"
    status = _json_get(cli_dashboard + "/api/cluster_status")
    assert status["cluster_resources"]["CPU"] == 2.0
    assert not status["cluster_resources"].get("GPU")


def _job(url, *argv):
    return _run("job", "--dashboard-address", url, *argv)


def test_cli_job_submit_wait(cli_dashboard):
    out = _job(cli_dashboard, "submit", "--wait", "echo", "from-the-job")
    assert out.returncode == 0, out.stderr
    sid = out.stdout.split("submitted: ", 1)[1].split()[0]
    assert f"{sid}: SUCCEEDED" in out.stdout
    assert "from-the-job" in out.stdout


def test_cli_job_status_logs_list(cli_dashboard):
    out = _job(cli_dashboard, "submit", "echo", "listed-job")
    assert out.returncode == 0, out.stderr
    sid = out.stdout.split("submitted: ", 1)[1].split()[0]
    deadline = time.time() + 60
    status = ""
    while time.time() < deadline:
        status = _job(cli_dashboard, "status", sid).stdout.strip()
        if status in ("SUCCEEDED", "FAILED", "STOPPED"):
            break
        time.sleep(0.3)
    assert status == "SUCCEEDED"
    logs = _job(cli_dashboard, "logs", sid)
    assert logs.returncode == 0 and "listed-job" in logs.stdout
    # the dashboard's address also comes from RAY_TPU_TORCH_DASHBOARD
    listed = _run("job", "list",
                  env_extra={"RAY_TPU_TORCH_DASHBOARD": cli_dashboard})
    assert listed.returncode == 0, listed.stderr
    jobs = {j["submission_id"]: j for j in json.loads(listed.stdout)}
    assert jobs[sid]["status"] == "SUCCEEDED"
    assert jobs[sid]["entrypoint"] == "echo listed-job"


def test_cli_job_stop_and_unknown_id(cli_dashboard):
    out = _job(cli_dashboard, "submit", "--wait", "true")
    sid = out.stdout.split("submitted: ", 1)[1].split()[0]
    stopped = _job(cli_dashboard, "stop", sid)
    assert stopped.returncode == 0 and stopped.stdout.strip() == "False"
    missing = _job(cli_dashboard, "status", "no-such-job")
    assert missing.returncode != 0 and "404" in missing.stderr


def test_cli_up_and_down(tmp_path):
    """``up`` brings a local-provider cluster up (a CPU head and a CPU
    worker, exactly the YAML's resources) that a driver reaches;
    ``down`` leaves none of its processes."""
    config = tmp_path / "cluster.yaml"
    config.write_text("cluster_name: cli-up\nprovider: {type: local}\n"
                      "min_workers: 1\nhead_node: {resources: {CPU: 2}}\n"
                      "worker_nodes: {resources: {CPU: 1}}\n")
    env = {"RAY_TPU_TORCH_SESSION_ROOT": str(tmp_path / "sessions")}
    up = _run("up", str(config), env_extra=env)
    try:
        assert up.returncode == 0, up.stderr
        assert "cluster cli-up is up" in up.stdout
        with open(tmp_path / "sessions" / "cluster-cli-up.json") as f:
            state = json.load(f)
        code = textwrap.dedent(f"""
            import json, time, ray_tpu_torch as rt
            rt.init(address={state["head"]["gcs_address"]!r})
            deadline = time.time() + 60
            while len(rt.nodes()) < 2 and time.time() < deadline:
                time.sleep(0.25)
            print("UP", json.dumps(rt.cluster_resources()))
        """)
        out = subprocess.run([sys.executable, "-c", code],
                             capture_output=True, text=True, timeout=120,
                             cwd=REPO, env={**os.environ, **env})
        assert out.returncode == 0, out.stderr[-2000:]
        resources = json.loads(out.stdout.split("UP ", 1)[1])
        assert resources["CPU"] == 3.0 and not resources.get("GPU")
    finally:
        down = _run("down", str(config), env_extra=env)
    assert down.returncode == 0 and "cluster cli-up is down" in down.stdout
    pids = state["head"]["pids"] + state["workers"][0]["pids"]
    deadline = time.time() + 30
    while time.time() < deadline:
        alive = [p for p in pids if os.path.exists(f"/proc/{p}")]
        if not alive:
            break
        time.sleep(0.3)
    assert not alive, f"{alive} outlived down"


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
