"""Cluster launcher: the CLI's ``up`` / ``down`` from a YAML cluster
config (``python -m ray_tpu_torch.scripts.cli up cluster.yaml``).

Parity: reference ``ray up`` (``python/ray/scripts/scripts.py``) driving
``autoscaler/_private/updater.py`` (NodeUpdater: wait for node, run
initialization/setup commands, start ray) over
``autoscaler/_private/command_runner.py`` (SSHCommandRunner).  This
module is the laptop-to-cluster bring-up story: the autoscaler
(``autoscaler.py``) SCALES a running cluster; the launcher CREATES one
from nothing and tears it down.

The ``gcp_gpu`` provider creates GPU VMs (``gcp.GCPGPUNodeProvider``;
the JAX package's ``gcp`` / ``gcp_tpu`` TPU VMs are refused); locally
the ``local`` provider backs nodes with subprocesses on this machine and
the command runner execs directly (the SSH runner is the same code path
with an ``ssh`` argv prefix).  A node section's ``resources`` are the
node's exactly: one that names no GPU starts with ``"GPU": 0``, so a
CPU node on a host with cards does not take them by detection.

Cluster YAML (reference ``autoscaler/ray-schema.json``, scoped):

.. code-block:: yaml

    cluster_name: demo
    provider: {type: local}            # local | gcp_gpu | mock
    auth: {ssh_user: ubuntu, ssh_private_key: ~/.ssh/key.pem}
    min_workers: 2
    head_node: {resources: {CPU: 2}}
    worker_nodes: {resources: {CPU: 2}}
    initialization_commands: []         # once per node, before setup
    setup_commands: []                  # env/deps
    head_start_ray_commands: []         # defaults provided
    worker_start_ray_commands: []
"""

from __future__ import annotations

import json
import logging
import os
import re
import shlex
import subprocess
import sys
import threading
import time
import uuid
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch._port import reject_tpu_provider
from ray_tpu_torch.autoscaler.node_provider import (
    NodeProvider, TAG_NODE_KIND, TAG_NODE_STATUS, TAG_NODE_TYPE,
    STATUS_TERMINATED, STATUS_UP_TO_DATE)

logger = logging.getLogger(__name__)

REQUIRED_FIELDS = ("cluster_name", "provider")


class ClusterConfigError(Exception):
    pass


def load_cluster_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        config = yaml.safe_load(f) or {}
    for field in REQUIRED_FIELDS:
        if field not in config:
            raise ClusterConfigError(
                f"cluster config {path} is missing required field "
                f"{field!r}")
    if not isinstance(config["provider"], dict) \
            or "type" not in config["provider"]:
        raise ClusterConfigError("provider must be a dict with a 'type'")
    config.setdefault("min_workers", 0)
    config.setdefault("max_workers", max(config["min_workers"], 0))
    if config["min_workers"] > config["max_workers"]:
        raise ClusterConfigError("min_workers > max_workers")
    config.setdefault("head_node", {})
    config.setdefault("worker_nodes", {})
    config.setdefault("auth", {})
    for key in ("initialization_commands", "setup_commands",
                "head_start_ray_commands", "worker_start_ray_commands"):
        config.setdefault(key, [])
        if not isinstance(config[key], list):
            raise ClusterConfigError(f"{key} must be a list of commands")
    return config


# ----------------------------------------------------------------------
# command runners (reference command_runner.py)
# ----------------------------------------------------------------------
class CommandRunner:
    """Executes shell commands 'on a node'."""

    def run(self, cmd: str, timeout: float = 600.0) -> str:
        raise NotImplementedError

    def run_argv(self, argv: List[str], timeout: float = 600.0) -> str:
        return self.run(" ".join(shlex.quote(a) for a in argv), timeout)


class LocalCommandRunner(CommandRunner):
    """Node == this machine; 'SSH' is a subprocess (reference fake
    multi-node docker/local runners do the same)."""

    def __init__(self, env: Optional[Dict[str, str]] = None):
        self._env = env

    def run(self, cmd: str, timeout: float = 600.0) -> str:
        env = dict(os.environ)
        if self._env:
            env.update(self._env)
        proc = subprocess.run(
            ["bash", "-c", cmd], capture_output=True, text=True,
            timeout=timeout, env=env)
        if proc.returncode != 0:
            raise RuntimeError(
                f"command failed ({proc.returncode}): {cmd}\n"
                f"stdout: {proc.stdout[-2000:]}\n"
                f"stderr: {proc.stderr[-2000:]}")
        return proc.stdout


class SSHCommandRunner(CommandRunner):
    """Runs commands over ssh with the config's auth material."""

    def __init__(self, ip: str, ssh_user: str,
                 ssh_private_key: Optional[str] = None,
                 ssh_port: int = 22,
                 extra_opts: Optional[List[str]] = None):
        self.ip = ip
        self.ssh_user = ssh_user
        self.ssh_private_key = ssh_private_key
        self.ssh_port = ssh_port
        self.extra_opts = list(extra_opts or [])

    def ssh_argv(self, cmd: str) -> List[str]:
        argv = ["ssh", "-o", "StrictHostKeyChecking=no",
                "-o", "ConnectTimeout=15", "-p", str(self.ssh_port)]
        if self.ssh_private_key:
            argv += ["-i", os.path.expanduser(self.ssh_private_key)]
        argv += self.extra_opts
        argv += [f"{self.ssh_user}@{self.ip}", cmd]
        return argv

    def run(self, cmd: str, timeout: float = 600.0) -> str:
        proc = subprocess.run(self.ssh_argv(cmd), capture_output=True,
                              text=True, timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(
                f"ssh command failed ({proc.returncode}) on {self.ip}: "
                f"{cmd}\nstderr: {proc.stderr[-2000:]}")
        return proc.stdout


# ----------------------------------------------------------------------
# local provider (nodes are records; processes come from start commands)
# ----------------------------------------------------------------------
class LocalNodeProvider(NodeProvider):
    """'Cloud' = this machine.  ``create_node`` only allocates an id —
    the launcher's start commands bring up the actual head/worker
    processes, whose pids the launcher records for ``down``."""

    def __init__(self, provider_config: Optional[Dict[str, Any]] = None,
                 cluster_name: str = "default"):
        super().__init__(provider_config or {}, cluster_name)
        self._nodes: Dict[str, Dict[str, str]] = {}
        self._lock = threading.Lock()

    def non_terminated_nodes(self, tag_filters={}):
        with self._lock:
            return [nid for nid, tags in self._nodes.items()
                    if tags.get(TAG_NODE_STATUS) != STATUS_TERMINATED
                    and all(tags.get(k) == v
                            for k, v in tag_filters.items())]

    def is_running(self, node_id):
        with self._lock:
            tags = self._nodes.get(node_id)
            return tags is not None \
                and tags.get(TAG_NODE_STATUS) != STATUS_TERMINATED

    def node_tags(self, node_id):
        with self._lock:
            return dict(self._nodes.get(node_id, {}))

    def create_node(self, node_config, tags, count):
        with self._lock:
            for _ in range(count):
                nid = uuid.uuid4().hex[:8]
                t = dict(tags)
                t.setdefault(TAG_NODE_STATUS, STATUS_UP_TO_DATE)
                self._nodes[nid] = t

    def terminate_node(self, node_id):
        with self._lock:
            if node_id in self._nodes:
                self._nodes[node_id][TAG_NODE_STATUS] = STATUS_TERMINATED

    def internal_ip(self, node_id) -> str:
        return "127.0.0.1"


def _make_provider(config: Dict[str, Any]) -> NodeProvider:
    ptype = config["provider"]["type"]
    name = config["cluster_name"]
    if ptype in ("local", "fake"):
        return LocalNodeProvider(config["provider"], name)
    if ptype == "mock":
        from ray_tpu_torch.autoscaler.node_provider import MockProvider
        return MockProvider(config["provider"], name)
    reject_tpu_provider("cluster config", ptype)
    if ptype == "gcp_gpu":
        from ray_tpu_torch.autoscaler.gcp import GCPGPUNodeProvider
        return GCPGPUNodeProvider(config["provider"], name)
    raise ClusterConfigError(f"unknown provider type {ptype!r}")


# ----------------------------------------------------------------------
# launcher
# ----------------------------------------------------------------------
class ClusterLauncher:
    """``up``: head bring-up + worker join; ``down``: teardown.

    State (node ids, pids for local nodes, the head address) persists at
    ``<state_dir>/cluster-<name>.json`` so ``down`` finds what ``up``
    created — the moral equivalent of the reference's cluster state in
    ``~/.ray/cluster-<name>.state``.
    """

    def __init__(self, config: Dict[str, Any],
                 state_dir: Optional[str] = None,
                 provider: Optional[NodeProvider] = None):
        self.config = config
        self.provider = provider or _make_provider(config)
        if state_dir is None:
            from ray_tpu_torch.core.config import Config
            state_dir = Config().apply_env_overrides().session_root
        os.makedirs(state_dir, exist_ok=True)
        self.state_path = os.path.join(
            state_dir, f"cluster-{config['cluster_name']}.json")

    # -- state ---------------------------------------------------------
    def _load_state(self) -> Dict[str, Any]:
        try:
            with open(self.state_path) as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {"head": None, "workers": []}

    def _save_state(self, state: Dict[str, Any]) -> None:
        with open(self.state_path, "w") as f:
            json.dump(state, f, indent=1)

    # -- runners -------------------------------------------------------
    def _runner_for(self, ip: str) -> CommandRunner:
        if self.config["provider"]["type"] in ("local", "fake") \
                or ip in ("127.0.0.1", "localhost"):
            # scope the started nodes' session records to this cluster's
            # state dir so concurrent local clusters don't stomp each
            # other's latest_head.json
            return LocalCommandRunner(env={
                "RAY_TPU_TORCH_SESSION_ROOT": os.path.dirname(self.state_path)})
        auth = self.config["auth"]
        if "ssh_user" not in auth:
            raise ClusterConfigError(
                "auth.ssh_user is required for remote providers")
        return SSHCommandRunner(ip, auth["ssh_user"],
                                auth.get("ssh_private_key"),
                                int(auth.get("ssh_port", 22)))

    def _wait_for_ip(self, node_id: str, timeout: float = 300.0) -> str:
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            ip = None
            getter = getattr(self.provider, "internal_ip", None)
            if getter is not None:
                try:
                    ip = getter(node_id)
                except Exception:  # noqa: BLE001 — provider still booting
                    ip = None
            if ip:
                return ip
            time.sleep(2.0)
        raise TimeoutError(f"node {node_id} has no IP after {timeout}s")

    # -- command templating --------------------------------------------
    def _substitute(self, cmd: str, head_address: str = "") -> str:
        return (cmd.replace("{python}", shlex.quote(sys.executable))
                .replace("{head_address}", head_address))

    def _resources_flag(self, node_section: Dict[str, Any]) -> str:
        res = node_section.get("resources")
        if not res:
            return ""
        res = {"GPU": 0, **res}  # the section's resources, exactly
        return f" --resources {shlex.quote(json.dumps(res))}"

    def _bootstrap_node(self, runner: CommandRunner,
                        head_address: str = "") -> None:
        for cmd in (self.config["initialization_commands"]
                    + self.config["setup_commands"]):
            runner.run(self._substitute(cmd, head_address))

    # -- up ------------------------------------------------------------
    def up(self) -> Dict[str, Any]:
        state = self._load_state()
        if state.get("head"):
            logger.info("cluster %s already has a head; reusing",
                        self.config["cluster_name"])
        else:
            state["head"] = self._start_head()
            self._save_state(state)
        head_address = state["head"]["gcs_address"]
        want = int(self.config["min_workers"])
        while len(state["workers"]) < want:
            worker = self._start_worker(head_address)
            state["workers"].append(worker)
            self._save_state(state)
        print(f"cluster {self.config['cluster_name']} is up: "
              f"head at {head_address}, "
              f"{len(state['workers'])} worker(s)")
        print(f"connect with: ray_tpu_torch.init(address=\"{head_address}\")")
        return state

    def _start_head(self) -> Dict[str, Any]:
        existing = set(self.provider.non_terminated_nodes(
            {TAG_NODE_KIND: "head"}))
        self.provider.create_node(self.config["head_node"],
                                  {TAG_NODE_KIND: "head",
                                   TAG_NODE_TYPE: "head"}, 1)
        # before/after diff, NOT [0]: a persistent provider may carry a
        # stale half-configured head from a crashed earlier `up`, and
        # adopting it would leak the node just created
        node_id = next(
            nid for nid in self.provider.non_terminated_nodes(
                {TAG_NODE_KIND: "head"}) if nid not in existing)
        ip = self._wait_for_ip(node_id)
        runner = self._runner_for(ip)
        self._bootstrap_node(runner)
        cmds = self.config["head_start_ray_commands"] or [
            "{python} -m ray_tpu_torch.scripts.cli start --head"
            + self._resources_flag(self.config["head_node"])]
        out = ""
        for cmd in cmds:
            out += runner.run(self._substitute(cmd))
        m = re.search(r"GCS address:\s*(\S+:\d+)", out)
        if not m:
            raise RuntimeError(
                f"head start commands did not report a GCS address; "
                f"output was:\n{out[-2000:]}")
        gcs_address = m.group(1)
        if ip not in ("127.0.0.1", "localhost"):
            # the head printed its local bind; external nodes dial its IP
            gcs_address = f"{ip}:{gcs_address.rsplit(':', 1)[1]}"
        pids = [int(p) for p in re.findall(r"pid (\d+)", out)]
        return {"node_id": node_id, "ip": ip,
                "gcs_address": gcs_address, "pids": pids}

    def _start_worker(self, head_address: str) -> Dict[str, Any]:
        existing = set(self.provider.non_terminated_nodes(
            {TAG_NODE_KIND: "worker"}))
        self.provider.create_node(self.config["worker_nodes"],
                                  {TAG_NODE_KIND: "worker",
                                   TAG_NODE_TYPE: "worker"}, 1)
        node_id = next(
            nid for nid in self.provider.non_terminated_nodes(
                {TAG_NODE_KIND: "worker"}) if nid not in existing)
        ip = self._wait_for_ip(node_id)
        runner = self._runner_for(ip)
        self._bootstrap_node(runner, head_address)
        cmds = self.config["worker_start_ray_commands"] or [
            "{python} -m ray_tpu_torch.scripts.cli start "
            "--address {head_address}"
            + self._resources_flag(self.config["worker_nodes"])]
        out = ""
        for cmd in cmds:
            out += runner.run(self._substitute(cmd, head_address))
        pids = [int(p) for p in re.findall(r"pid (\d+)", out)]
        return {"node_id": node_id, "ip": ip, "pids": pids}

    # -- down ----------------------------------------------------------
    def down(self) -> None:
        state = self._load_state()
        for worker in reversed(state.get("workers", [])):
            self._teardown_node(worker)
        state["workers"] = []
        self._save_state(state)
        head = state.get("head")
        if head:
            self._teardown_node(head)
            state["head"] = None
        self._save_state(state)
        try:
            os.remove(self.state_path)
        except FileNotFoundError:
            pass
        print(f"cluster {self.config['cluster_name']} is down")

    def _teardown_node(self, node: Dict[str, Any]) -> None:
        pids = node.get("pids") or []
        if pids:
            try:
                runner = self._runner_for(node["ip"])
                runner.run("kill " + " ".join(str(p) for p in pids)
                           + " 2>/dev/null || true", timeout=60)
            except Exception:  # noqa: BLE001 — node may already be gone
                logger.info("teardown kill failed on %s", node.get("ip"),
                            exc_info=True)
        try:
            self.provider.terminate_node(node["node_id"])
        except Exception:  # noqa: BLE001
            logger.info("terminate_node failed for %s",
                        node.get("node_id"), exc_info=True)


def up(config_path: str, state_dir: Optional[str] = None) -> Dict[str, Any]:
    return ClusterLauncher(load_cluster_config(config_path),
                           state_dir=state_dir).up()


def down(config_path: str, state_dir: Optional[str] = None) -> None:
    ClusterLauncher(load_cluster_config(config_path),
                    state_dir=state_dir).down()
