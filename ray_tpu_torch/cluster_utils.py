"""Multi-node clusters on one machine, for tests.

Parity: reference ``python/ray/cluster_utils.py`` — ``Cluster`` /
``add_node`` start multiple real raylet processes with distinct stores and
ports so multi-node semantics (spillback scheduling, object transfer,
node death) are exercised without real machines.

GPUs are the accelerator resource: ``num_gpus`` in ``head_node_args``
and ``add_node``.  A node claims the GPUs given, else those it detects
(``core.node.detect_gpu_resources``), so ``num_gpus=0`` keeps a node
off the card.
"""

from __future__ import annotations

import subprocess
import time
from typing import Any, Dict, List, Optional

from ray_tpu_torch._port import reject_tpu_options, reject_tpu_resources
from ray_tpu_torch.core.config import Config, set_config
from ray_tpu_torch.core import node as node_mod


class ClusterNode:
    def __init__(self, proc: subprocess.Popen, handshake: Dict[str, Any]):
        self.proc = proc
        self.handshake = handshake
        self.node_id_hex: str = handshake["node_id"]

    def kill(self) -> None:
        """SIGKILL the raylet process (chaos testing)."""
        self.proc.kill()
        self.proc.wait(timeout=10)

    def terminate(self) -> None:
        self.proc.terminate()
        try:
            self.proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            self.proc.kill()


class Cluster:
    def __init__(self, initialize_head: bool = True,
                 head_node_args: Optional[Dict[str, Any]] = None,
                 connect: bool = False,
                 _system_config: Optional[Dict[str, Any]] = None):
        self.config = Config().apply_env_overrides().apply_overrides(
            _system_config)
        set_config(self.config)
        self.session_dir = node_mod.new_session_dir(self.config)
        self.head: Optional[ClusterNode] = None
        self.worker_nodes: List[ClusterNode] = []
        if initialize_head:
            args = dict(head_node_args or {})
            self._head_resources = self._resources_from_args(args)
            proc, handshake = node_mod.spawn_head(
                self.config, self.session_dir, self._head_resources,
                die_with_parent=node_mod.safe_die_with_parent())
            self.head = ClusterNode(proc, handshake)
        if connect:
            self.connect()

    def supervise_head(self):
        """Arm a :class:`ray_tpu_torch.core.supervisor.HeadSupervisor` over
        this cluster's head, as ``init()``-owned clusters get by
        default: an unexpected head (GCS) death respawns it in place
        on the same port and the GCS recovery path reconverges —
        the restart the test harness used to perform by hand."""
        from ray_tpu_torch.core.supervisor import HeadSupervisor

        def _swap(proc, handshake):
            self.head = ClusterNode(proc, handshake)

        self._supervisor = HeadSupervisor(
            self.config, self.session_dir, self._head_resources,
            self.head.proc, gcs_port=self.gcs_address[1],
            on_respawn=_swap)
        return self._supervisor

    def restart_head(self, wait_s: float = 15.0) -> None:
        """Kill and respawn the head (GCS + head raylet) in place,
        rebinding the SAME GCS port so surviving side-node raylets
        re-register (parity model: reference GCS restart fault
        tolerance, test_gcs_fault_tolerance.py).  Durable GCS tables
        restore from the session-dir snapshot."""
        import time as _time

        gcs_port = self.gcs_address[1]
        # an armed supervisor must not race this EXPLICIT restart with
        # its own spawn_head on the same port
        sup = getattr(self, "_supervisor", None)
        if sup is not None:
            sup.suspend()
        try:
            self.head.kill()
            # the port releases when the process dies; rebind it
            # explicitly
            proc, handshake = node_mod.spawn_head(
                self.config, self.session_dir, self._head_resources,
                gcs_port=gcs_port,
                die_with_parent=node_mod.safe_die_with_parent())
            self.head = ClusterNode(proc, handshake)
            if sup is not None:
                sup.attach(proc)
        finally:
            if sup is not None:
                sup.resume()
        # wait for the side raylets to re-register
        deadline = _time.monotonic() + wait_s
        import asyncio

        from ray_tpu_torch.core import rpc

        want = 1 + len(self.worker_nodes)
        while _time.monotonic() < deadline:
            async def _count():
                conn = await rpc.connect(self.gcs_address)
                try:
                    nodes = await conn.call("get_nodes", {})
                finally:
                    conn.close()
                return sum(1 for n in nodes if n["alive"])
            try:
                if asyncio.run(_count()) >= want:
                    return
            except OSError:
                pass
            _time.sleep(0.2)
        raise TimeoutError(
            f"side raylets did not re-register within {wait_s}s")

    @staticmethod
    def _resources_from_args(args: Dict[str, Any]) -> Optional[Dict[str, float]]:
        reject_tpu_options("Cluster", args)
        reject_tpu_resources("Cluster", args.get("resources"))
        resources = dict(args.get("resources", {}))
        if "num_cpus" in args:
            resources["CPU"] = float(args["num_cpus"])
        if "num_gpus" in args:
            resources["GPU"] = float(args["num_gpus"])
        return resources or None

    @property
    def gcs_address(self):
        return tuple(self.head.handshake["gcs_address"])

    def add_node(self, **args) -> ClusterNode:
        assert self.head is not None, "cluster has no head"
        resources = self._resources_from_args(args)
        proc, handshake = node_mod.spawn_node(
            self.config, self.session_dir, self.gcs_address, resources,
            die_with_parent=node_mod.safe_die_with_parent())
        node = ClusterNode(proc, handshake)
        self.worker_nodes.append(node)
        return node

    def remove_node(self, node: ClusterNode, allow_graceful: bool = False
                    ) -> None:
        if allow_graceful:
            node.terminate()
        else:
            node.kill()
        if node in self.worker_nodes:
            self.worker_nodes.remove(node)

    def connect(self) -> None:
        """Attach the current process as a driver on the head node."""
        import ray_tpu_torch
        from ray_tpu_torch.core.ids import NodeID
        from ray_tpu_torch.core.worker import CoreWorker

        handshake = self.head.handshake
        CoreWorker(
            mode="driver",
            gcs_address=tuple(handshake["gcs_address"]),
            raylet_address=tuple(handshake["raylet_address"]),
            node_id=NodeID.from_hex(handshake["node_id"]),
            store_path=handshake["store_path"],
            store_capacity=handshake["store_capacity"],
            session_dir=handshake["session_dir"],
            config=self.config,
        )

    def wait_for_nodes(self, timeout: Optional[float] = None) -> None:
        """Block until every spawned node is alive in the GCS view.

        The default timeout scales with cluster size: each "node" is a
        full python process tree (raylet + zygote + prestart workers),
        and on a loaded 1-core host a fixed 30 s flaked for 4-node
        chaos clusters (the reference's fixtures wait far longer,
        ``cluster_utils.py:165``)."""
        import ray_tpu_torch

        expected = 1 + len(self.worker_nodes)
        if timeout is None:
            timeout = 30.0 + 30.0 * expected
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            alive = [n for n in ray_tpu_torch.nodes() if n["alive"]]
            if len(alive) >= expected:
                return
            time.sleep(0.1)
        raise TimeoutError(
            f"only {len(alive)} of {expected} nodes alive after {timeout}s")

    def shutdown(self) -> None:
        import ray_tpu_torch

        if getattr(self, "_supervisor", None) is not None:
            self._supervisor.stop()
            self._supervisor = None
        ray_tpu_torch.shutdown()
        for node in self.worker_nodes:
            node.terminate()
        self.worker_nodes.clear()
        if self.head is not None:
            self.head.terminate()
            self.head = None
