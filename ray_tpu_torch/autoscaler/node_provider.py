"""Pluggable node providers.

Parity: reference ``python/ray/autoscaler/node_provider.py`` (:13) — the
cloud-agnostic interface the autoscaler drives — plus the in-process
fake provider used by tests (reference
``autoscaler/_private/fake_multi_node/node_provider.py``), which backs
"nodes" with real local raylet processes via
:class:`ray_tpu_torch.cluster_utils.Cluster`.

A cloud provider implements ``create_node`` as an instance create call
whose startup script joins the cluster (``gcp.GCPGPUNodeProvider``: GPU
VMs); tags ride the instance's labels.  A node type's ``resources`` may
name ``"GPU"``; ``"TPU"`` is refused, as no node of the port has it.
"""

from __future__ import annotations

import threading
import uuid
from typing import Any, Dict, List, Optional

from ray_tpu_torch._port import reject_tpu_resources

TAG_NODE_KIND = "node-kind"  # "head" | "worker"
TAG_NODE_TYPE = "node-type"
TAG_NODE_STATUS = "node-status"
STATUS_UP_TO_DATE = "up-to-date"
STATUS_TERMINATED = "terminated"


class NodeProvider:
    """Interface; all methods are called from the autoscaler thread."""

    def __init__(self, provider_config: Dict[str, Any],
                 cluster_name: str = "default"):
        self.provider_config = provider_config
        self.cluster_name = cluster_name

    def non_terminated_nodes(self, tag_filters: Dict[str, str]
                             ) -> List[str]:
        raise NotImplementedError

    def is_running(self, node_id: str) -> bool:
        raise NotImplementedError

    def node_tags(self, node_id: str) -> Dict[str, str]:
        raise NotImplementedError

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> None:
        raise NotImplementedError

    def terminate_node(self, node_id: str) -> None:
        raise NotImplementedError


class MockProvider(NodeProvider):
    """Pure in-memory provider for unit tests (reference
    ``test_autoscaler.py``'s MockProvider)."""

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
            return self._nodes.get(node_id, {}).get(TAG_NODE_STATUS) \
                != STATUS_TERMINATED

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


class FakeMultiNodeProvider(NodeProvider):
    """Backs nodes with real local raylets (one process per "node"),
    enabling end-to-end autoscaler tests on one machine."""

    def __init__(self, cluster, node_types: Dict[str, Dict[str, Any]],
                 cluster_name: str = "fake"):
        super().__init__({}, cluster_name)
        for name, spec in node_types.items():
            reject_tpu_resources(f"node type {name!r}",
                                 spec.get("resources"))
        self._cluster = cluster  # ray_tpu_torch.cluster_utils.Cluster
        self._node_types = node_types
        self._nodes: Dict[str, Any] = {}  # provider id -> ClusterNode
        self._tags: Dict[str, Dict[str, str]] = {}
        self._lock = threading.Lock()

    def non_terminated_nodes(self, tag_filters={}):
        with self._lock:
            return [nid for nid, n in self._nodes.items()
                    if n.proc.poll() is None
                    and all(self._tags[nid].get(k) == v
                            for k, v in tag_filters.items())]

    def is_running(self, node_id):
        with self._lock:
            n = self._nodes.get(node_id)
            return n is not None and n.proc.poll() is None

    def node_tags(self, node_id):
        with self._lock:
            return dict(self._tags.get(node_id, {}))

    def create_node(self, node_config, tags, count):
        node_type = tags.get(TAG_NODE_TYPE)
        resources = dict(
            self._node_types[node_type].get("resources", {})
            if node_type else node_config.get("resources", {}))
        # a node has exactly its type's resources: one that names no GPU
        # does not take the host's cards by detection
        resources.setdefault("GPU", 0.0)
        for _ in range(count):
            node = self._cluster.add_node(resources=resources)
            with self._lock:
                nid = node.handshake["node_id"][:12]
                self._nodes[nid] = node
                t = dict(tags)
                t.setdefault(TAG_NODE_STATUS, STATUS_UP_TO_DATE)
                self._tags[nid] = t

    def terminate_node(self, node_id):
        with self._lock:
            node = self._nodes.pop(node_id, None)
            self._tags.pop(node_id, None)
        if node is not None:
            self._cluster.remove_node(node, allow_graceful=True)
