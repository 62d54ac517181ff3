"""The port's cluster launcher (``ray_tpu_torch.autoscaler.launcher``,
the CLI's ``up`` / ``down``) on the CPU.

Counterparts of tests/test_cluster_launcher.py's four cases (config
validation, the SSH runner's argv, the local runner, a real head and
worker brought up through the local provider, reached by a driver and
torn down), then parity with the JAX package: the same YAML texts load
to the same config or fail alike, the SSH runner builds the same argv
for seeded hosts and commands, and the local runner gives the same
output.  The port's own rules: a node section's resources are the node's
exactly (``"GPU": 0`` unless it names a GPU), and the JAX package's TPU
providers are refused."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest

from ray_tpu.autoscaler import launcher as jlauncher
from ray_tpu_torch.autoscaler import launcher as tlauncher
from ray_tpu_torch.autoscaler.launcher import (
    ClusterConfigError, ClusterLauncher, LocalCommandRunner,
    SSHCommandRunner, load_cluster_config)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_config(tmp_path, text, name="cluster.yaml"):
    path = tmp_path / name
    path.write_text(text)
    return str(path)


def test_config_validation(tmp_path):
    with pytest.raises(ClusterConfigError):
        load_cluster_config(_write_config(tmp_path, "provider: {type: x}"))
    with pytest.raises(ClusterConfigError):
        load_cluster_config(_write_config(
            tmp_path, "cluster_name: a\nprovider: {}\n"))
    with pytest.raises(ClusterConfigError):
        load_cluster_config(_write_config(
            tmp_path,
            "cluster_name: a\nprovider: {type: local}\n"
            "min_workers: 3\nmax_workers: 1\n"))
    cfg = load_cluster_config(_write_config(
        tmp_path, "cluster_name: a\nprovider: {type: local}\n"))
    assert cfg["min_workers"] == 0
    assert cfg["setup_commands"] == []


def test_ssh_runner_argv():
    runner = SSHCommandRunner("10.0.0.5", "ubuntu",
                              ssh_private_key="~/.ssh/key.pem",
                              ssh_port=2222)
    argv = runner.ssh_argv("echo hi")
    assert argv[0] == "ssh"
    assert "-p" in argv and "2222" in argv
    assert "-i" in argv
    assert argv[-2] == "ubuntu@10.0.0.5"
    assert argv[-1] == "echo hi"


def test_local_runner_runs_and_raises(tmp_path):
    runner = LocalCommandRunner(env={"LAUNCHER_T": "v"})
    assert runner.run("echo -n $LAUNCHER_T") == "v"
    with pytest.raises(RuntimeError):
        runner.run("exit 3")


_CONFIGS = [
    "provider: {type: x}",
    "cluster_name: a\nprovider: {}\n",
    "cluster_name: a\nprovider: local\n",
    "cluster_name: a\nprovider: {type: local}\nmin_workers: 3\n"
    "max_workers: 1\n",
    "cluster_name: a\nprovider: {type: local}\n",
    "cluster_name: a\nprovider: {type: local}\nmin_workers: 2\n",
    "cluster_name: a\nprovider: {type: local}\nsetup_commands: ls\n",
    "cluster_name: b\nprovider: {type: mock}\nmin_workers: 1\n"
    "max_workers: 4\nhead_node: {resources: {CPU: 2}}\n"
    "worker_nodes: {resources: {CPU: 2, GPU: 1}}\n"
    "auth: {ssh_user: ubuntu}\ninitialization_commands: [echo i]\n"
    "head_start_ray_commands: ['{python} -c pass']\n",
    "",
]


@pytest.mark.parametrize("text", _CONFIGS, ids=range(len(_CONFIGS)))
def test_config_loading_matches_jax(tmp_path, text):
    """The same YAML loads to the same dict in both packages, or both
    raise their ``ClusterConfigError`` with the same message."""
    path = _write_config(tmp_path, text)

    def load(mod):
        try:
            return ("ok", mod.load_cluster_config(path))
        except mod.ClusterConfigError as e:
            return ("error", str(e))

    assert load(tlauncher) == load(jlauncher)


@pytest.mark.parametrize("seed", range(6))
def test_ssh_argv_matches_jax(seed):
    rng = np.random.default_rng(seed)
    ip = ".".join(str(int(x)) for x in rng.integers(1, 255, 4))
    kwargs = dict(
        ssh_private_key=(None if rng.random() < 0.3
                         else f"~/.ssh/k{int(rng.integers(9))}.pem"),
        ssh_port=int(rng.integers(22, 3000)),
        extra_opts=(["-o", "LogLevel=ERROR"] if rng.random() < 0.5
                    else None))
    user = str(rng.choice(["ubuntu", "root", "ray"]))
    cmd = str(rng.choice(["echo hi", "uptime && nproc",
                          "python -m pkg start --head"]))
    ours = SSHCommandRunner(ip, user, **kwargs)
    theirs = jlauncher.SSHCommandRunner(ip, user, **kwargs)
    assert ours.ssh_argv(cmd) == theirs.ssh_argv(cmd)
    argv = ["printf", "%s", "a b", "c'd"]
    assert LocalCommandRunner().run_argv(argv) == \
        jlauncher.LocalCommandRunner().run_argv(argv) == "a bc'd"


def test_node_resources_are_the_sections_exactly(tmp_path):
    """A section that names no GPU starts its node with "GPU": 0, so a
    CPU node on a host with cards does not take them by detection; one
    that names GPUs keeps its count; none at all leaves detection on."""
    cfg = load_cluster_config(_write_config(
        tmp_path, "cluster_name: r\nprovider: {type: mock}\n"))
    launcher = ClusterLauncher(cfg, state_dir=str(tmp_path / "state"))

    def flag(section):
        out = launcher._resources_flag(section)
        return json.loads(out.split("--resources ", 1)[1].strip("'")) \
            if out else None

    assert flag({"resources": {"CPU": 2}}) == {"CPU": 2, "GPU": 0}
    assert flag({"resources": {"CPU": 4, "GPU": 1}}) == {"CPU": 4, "GPU": 1}
    assert flag({}) is None


def _alive(pid):
    try:
        os.kill(pid, 0)
        return True
    except ProcessLookupError:
        return False


def test_up_down_end_to_end(tmp_path):
    config_path = _write_config(tmp_path, """
cluster_name: e2e
provider: {type: local}
min_workers: 1
head_node: {resources: {CPU: 2}}
worker_nodes: {resources: {CPU: 2}}
setup_commands: []
""")
    state_dir = str(tmp_path / "state")
    config = load_cluster_config(config_path)
    launcher = ClusterLauncher(config, state_dir=state_dir)
    try:
        state = launcher.up()
        address = state["head"]["gcs_address"]
        assert state["head"]["pids"]
        assert len(state["workers"]) == 1

        # a driver can connect and see both nodes
        code = f"""
import ray_tpu_torch, json
ray_tpu_torch.init(address={address!r})
import time
deadline = time.time() + 60
while time.time() < deadline:
    nodes = [n for n in ray_tpu_torch.nodes() if n.get("alive", True)]
    if len(nodes) >= 2:
        break
    time.sleep(0.5)
@ray_tpu_torch.remote
def f():
    return 1
assert sum(ray_tpu_torch.get([f.remote() for _ in range(8)])) == 8
print("E2E_OK", len(nodes), json.dumps(ray_tpu_torch.cluster_resources()))
"""
        env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        proc = subprocess.run([sys.executable, "-c", code],
                              capture_output=True, text=True, timeout=180,
                              env=env, cwd=REPO)
        assert "E2E_OK 2" in proc.stdout, (proc.stdout[-2000:],
                                           proc.stderr[-2000:])
        resources = json.loads(proc.stdout.split("E2E_OK 2 ", 1)[1])
        assert resources["CPU"] == 4.0 and not resources.get("GPU")

        # idempotent: up() again reuses the head
        state2 = launcher.up()
        assert state2["head"]["node_id"] == state["head"]["node_id"]
    finally:
        launcher.down()

    # processes are gone and the state file is removed
    assert not os.path.exists(launcher.state_path)
    pids = state["head"]["pids"] + state["workers"][0]["pids"]
    deadline = time.time() + 30
    while time.time() < deadline and any(_alive(p) for p in pids):
        time.sleep(0.5)
    assert not any(_alive(p) for p in pids), \
        f"pids {pids} still alive after down()"
