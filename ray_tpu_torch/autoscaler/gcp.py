"""GCP GPU-VM node provider.

Parity: reference ``python/ray/autoscaler/_private/gcp/``: nodes are
Compute Engine instances with an attached NVIDIA GPU, created, listed
and deleted through the ``gcloud`` CLI (the reference drives the GCP
REST API through its SDK; the CLI keeps this image dependency-free).
The JAX package's counterpart creates TPU VMs
(``gcloud compute tpus tpu-vm``); this one creates GPU instances
(``gcloud compute instances``, the accelerator attached with
``--accelerator``; a GPU instance cannot live-migrate, hence
``--maintenance-policy TERMINATE``).  All shelling-out goes through an
injectable ``runner`` so the provider logic is testable without a
project (tests inject a fake).

Config (the ``provider`` section of the cluster YAML):

.. code-block:: yaml

    provider:
        type: gcp_gpu
        project_id: my-project
        zone: us-central1-a
        machine_type: a3-highgpu-1g         # one H100 per node
        accelerator_type: nvidia-h100-80gb
        accelerator_count: 1
        image_family: common-cu128-ubuntu-2204
        image_project: deeplearning-platform-release
"""

from __future__ import annotations

import json
import logging
import subprocess
import uuid
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.node_provider import (NodeProvider,
                                                    STATUS_TERMINATED,
                                                    STATUS_UP_TO_DATE,
                                                    TAG_NODE_STATUS)

logger = logging.getLogger(__name__)

Runner = Callable[[List[str]], str]

#: instance states that no longer count as a node of the cluster
#: (Compute Engine's lifecycle: PROVISIONING, STAGING, RUNNING,
#: STOPPING, STOPPED, SUSPENDING, SUSPENDED, REPAIRING, TERMINATED)
_GONE = ("STOPPING", "STOPPED", "TERMINATED", "SUSPENDING", "SUSPENDED")


def _gcloud_runner(args: List[str]) -> str:
    proc = subprocess.run(["gcloud", *args], capture_output=True,
                          text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"gcloud {' '.join(args)} failed: "
                           f"{proc.stderr.strip()}")
    return proc.stdout


class GCPGPUNodeProvider(NodeProvider):
    """GPU-VM lifecycle over gcloud; tags ride instance labels."""

    def __init__(self, provider_config: Dict[str, Any],
                 cluster_name: str = "default",
                 runner: Optional[Runner] = None):
        super().__init__(provider_config, cluster_name)
        self.project = provider_config["project_id"]
        self.zone = provider_config["zone"]
        self.machine_type = provider_config.get(
            "machine_type", "a3-highgpu-1g")
        self.accelerator_type = provider_config.get(
            "accelerator_type", "nvidia-h100-80gb")
        self.accelerator_count = int(provider_config.get(
            "accelerator_count", 1))
        self.image_family = provider_config.get("image_family")
        self.image_project = provider_config.get("image_project")
        self._run = runner or _gcloud_runner

    def _where(self) -> List[str]:
        return ["--project", self.project, "--zone", self.zone]

    def _list(self) -> List[Dict[str, Any]]:
        out = self._run(["compute", "instances", "list",
                         "--project", self.project, "--zones", self.zone,
                         "--format", "json"])
        nodes = json.loads(out or "[]")
        prefix = f"ray-tpu-torch-{self.cluster_name}-"
        return [n for n in nodes
                if self._short_name(n).startswith(prefix)]

    @staticmethod
    def _short_name(node: Dict[str, Any]) -> str:
        return node.get("name", "").rsplit("/", 1)[-1]

    def non_terminated_nodes(self, tag_filters: Dict[str, str]
                             ) -> List[str]:
        out = []
        for n in self._list():
            if n.get("status") in _GONE:
                continue
            labels = n.get("labels", {})
            if all(labels.get(k.replace("-", "_")) == v
                   for k, v in tag_filters.items()):
                out.append(self._short_name(n))
        return out

    def is_running(self, node_id: str) -> bool:
        for n in self._list():
            if self._short_name(n) == node_id:
                return n.get("status") == "RUNNING"
        return False

    def node_tags(self, node_id: str) -> Dict[str, str]:
        for n in self._list():
            if self._short_name(n) == node_id:
                labels = n.get("labels", {})
                tags = {k.replace("_", "-"): v for k, v in labels.items()}
                tags.setdefault(
                    TAG_NODE_STATUS,
                    STATUS_UP_TO_DATE if n.get("status") == "RUNNING"
                    else STATUS_TERMINATED)
                return tags
        return {}

    def create_node(self, node_config: Dict[str, Any],
                    tags: Dict[str, str], count: int) -> None:
        for _ in range(count):
            name = (f"ray-tpu-torch-{self.cluster_name}-"
                    f"{uuid.uuid4().hex[:8]}")
            labels = ",".join(
                f"{k.replace('-', '_')}={v}" for k, v in tags.items())
            accel = node_config.get("accelerator_type",
                                    self.accelerator_type)
            count_per = int(node_config.get("accelerator_count",
                                            self.accelerator_count))
            args = ["compute", "instances", "create", name, *self._where(),
                    "--machine-type",
                    node_config.get("machine_type", self.machine_type),
                    "--accelerator", f"type={accel},count={count_per}",
                    "--maintenance-policy", "TERMINATE"]
            family = node_config.get("image_family", self.image_family)
            if family:
                args += ["--image-family", family]
                project = node_config.get("image_project",
                                          self.image_project)
                if project:
                    args += ["--image-project", project]
            if labels:
                args += ["--labels", labels]
            startup = node_config.get("startup_script")
            if startup:
                args += ["--metadata", f"startup-script={startup}"]
            self._run(args)
            logger.info("created GPU VM %s (%s x%d)", name, accel,
                        count_per)

    def terminate_node(self, node_id: str) -> None:
        self._run(["compute", "instances", "delete", node_id,
                   *self._where(), "--quiet"])
