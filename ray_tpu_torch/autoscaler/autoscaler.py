"""The autoscaler control loop.

Parity: reference ``autoscaler/_private/autoscaler.py``
(``StandardAutoscaler``:167) + ``load_metrics.py`` (:65) — one
``update()`` per tick: read the latest cluster load, launch nodes for
unfulfilled demand (via the demand scheduler), terminate workers idle
past the timeout, honoring min/max workers per type.

Launch tracking needs no separate bookkeeping: a provider node whose
raylet has not yet registered with the GCS *is* an in-flight launch, so
the provider view minus the GCS view gives "launching" exactly (the
reference reconstructs the same thing from NodeLauncher queues + tags).
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Tuple, Optional

from ray_tpu_torch.autoscaler.node_provider import (NodeProvider, TAG_NODE_KIND,
                                              TAG_NODE_STATUS,
                                              TAG_NODE_TYPE,
                                              STATUS_UP_TO_DATE)
from ray_tpu_torch.autoscaler.resource_demand_scheduler import (
    NodeTypeConfig, ResourceDemandScheduler)

logger = logging.getLogger(__name__)


class LoadMetrics:
    """Latest cluster load snapshot (reference ``LoadMetrics``:65)."""

    def __init__(self):
        self.nodes: List[Dict[str, Any]] = []
        self.pending_demand: List[Dict[str, float]] = []
        self.resource_requests: List[Dict[str, float]] = []
        self.pending_placement_groups: List[Dict[str, Any]] = []
        self.last_update = 0.0

    def update(self, snapshot: Dict[str, Any]) -> None:
        self.nodes = [n for n in snapshot.get("nodes", [])
                      if n.get("alive")]
        self.pending_demand = list(snapshot.get("pending_demand", []))
        self.resource_requests = list(snapshot.get("resource_requests", []))
        self.pending_placement_groups = list(
            snapshot.get("pending_placement_groups", []))
        self.last_update = time.monotonic()

    @staticmethod
    def node_idle(node: Dict[str, Any]) -> bool:
        if node.get("load", 0) > 0:
            return False
        total = node.get("resources_total", {})
        avail = node.get("resources_available", {})
        return all(avail.get(k, 0.0) >= v for k, v in total.items())


class StandardAutoscaler:
    def __init__(self, provider: NodeProvider,
                 node_types: Dict[str, NodeTypeConfig],
                 *, max_workers: int = 2 ** 30,
                 idle_timeout_s: float = 60.0):
        self.provider = provider
        self.node_types = node_types
        self.max_workers = max_workers
        self.idle_timeout_s = idle_timeout_s
        self.load_metrics = LoadMetrics()
        self.scheduler = ResourceDemandScheduler(node_types, max_workers)
        self._idle_since: Dict[str, float] = {}
        # provider ids we terminated, until the GCS notices they're gone
        self._terminated_ids: Dict[str, float] = {}

    # ------------------------------------------------------------------
    def update_load_metrics(self, snapshot: Dict[str, Any]) -> None:
        self.load_metrics.update(snapshot)

    def update(self) -> Dict[str, Any]:
        """One reconcile tick; returns a summary for logging/tests."""
        lm = self.load_metrics
        workers = self.provider.non_terminated_nodes(
            {TAG_NODE_KIND: "worker"})
        gcs_ids = [n["node_id"] for n in lm.nodes]

        def joined(provider_id: str) -> bool:
            # provider ids are prefixes of the GCS node id (fake provider
            # uses the handshake hex prefix; clouds tag instances with it)
            return any(g.startswith(provider_id) for g in gcs_ids)

        live: List[Tuple[str, str]] = []      # (provider id, type)
        launching: Dict[str, int] = {}        # created, not yet in GCS
        live_by_type: Dict[str, int] = {}
        for nid in workers:
            ntype = self.provider.node_tags(nid).get(TAG_NODE_TYPE, "")
            if joined(nid):
                live.append((nid, ntype))
                live_by_type[ntype] = live_by_type.get(ntype, 0) + 1
            elif ntype in self.node_types:
                # unknown/untagged types can't be fed to the scheduler
                # (it would KeyError on their resources) — ignore them
                launching[ntype] = launching.get(ntype, 0) + 1

        # ---- scale up: min_workers floor + unfulfilled demand ----
        to_launch: Dict[str, int] = {}
        for name, cfg in self.node_types.items():
            have = live_by_type.get(name, 0) + launching.get(name, 0)
            if have < cfg.min_workers:
                to_launch[name] = cfg.min_workers - have
        demand_launch = self.scheduler.get_nodes_to_launch(
            existing_nodes=[(ntype, self._node_available(nid))
                            for nid, ntype in live] + self._head_nodes(),
            demand=lm.pending_demand,
            pending_placement_groups=lm.pending_placement_groups,
            launching={k: launching.get(k, 0) + to_launch.get(k, 0)
                       for k in set(launching) | set(to_launch)},
        )
        for name, count in demand_launch.items():
            to_launch[name] = to_launch.get(name, 0) + count

        # standing sdk.request_resources bundles: a min-cluster-size
        # request, packed against TOTAL capacity (busy nodes still
        # count — it is not a reservation; reference sdk.py:206)
        if lm.resource_requests:
            request_launch = self.scheduler.get_nodes_to_launch(
                existing_nodes=[
                    (ntype, self._node_resources(nid, "resources_total"))
                    for nid, ntype in live
                ] + self._head_nodes("resources_total"),
                demand=lm.resource_requests,
                pending_placement_groups=[],
                launching={k: launching.get(k, 0) + to_launch.get(k, 0)
                           for k in set(launching) | set(to_launch)},
            )
            for name, count in request_launch.items():
                to_launch[name] = to_launch.get(name, 0) + count

        budget = self.max_workers - len(workers)
        launched: Dict[str, int] = {}
        for name, count in to_launch.items():
            count = min(count, budget)
            if count <= 0:
                continue
            budget -= count
            launched[name] = count
            logger.info("autoscaler: launching %d x %s", count, name)
            self.provider.create_node(
                self.node_types[name].node_config,
                {TAG_NODE_KIND: "worker", TAG_NODE_TYPE: name,
                 TAG_NODE_STATUS: STATUS_UP_TO_DATE}, count)

        # ---- scale down: idle workers past the timeout ----
        terminated: List[str] = []
        if not lm.pending_demand and not lm.pending_placement_groups:
            now = time.monotonic()
            idle_by_id = {n["node_id"]: self.node_idle(n)
                          for n in lm.nodes}
            protected = self._protected_by_requests(live)

            def is_idle(provider_id: str) -> bool:
                return any(v for g, v in idle_by_id.items()
                           if g.startswith(provider_id))

            for nid, ntype in live:
                if nid in protected:
                    self._idle_since.pop(nid, None)
                    continue
                if is_idle(nid):
                    since = self._idle_since.setdefault(nid, now)
                    floor = self.node_types[ntype].min_workers \
                        if ntype in self.node_types else 0
                    if now - since > self.idle_timeout_s \
                            and live_by_type.get(ntype, 0) > floor:
                        logger.info("autoscaler: terminating idle %s", nid)
                        self.provider.terminate_node(nid)
                        self._terminated_ids[nid] = now
                        live_by_type[ntype] -= 1
                        terminated.append(nid)
                        self._idle_since.pop(nid, None)
                else:
                    self._idle_since.pop(nid, None)
        else:
            self._idle_since.clear()

        return {"launched": launched, "terminated": terminated,
                "num_workers": len(self.provider.non_terminated_nodes(
                    {TAG_NODE_KIND: "worker"}))}

    node_idle = staticmethod(LoadMetrics.node_idle)

    # ------------------------------------------------------------------
    def _node_available(self, provider_id: str) -> Dict[str, float]:
        return self._node_resources(provider_id, "resources_available")

    def _node_resources(self, provider_id: str,
                        key: str) -> Dict[str, float]:
        for n in self.load_metrics.nodes:
            if n["node_id"].startswith(provider_id):
                return dict(n.get(key, {}))
        return {}

    def _protected_by_requests(self, live) -> set:
        """Provider ids of the workers a standing resource request needs
        (first-fit against node TOTALS, head capacity first so requests
        the head covers pin nothing) — only these skip idle scale-down;
        a request must not pin the whole cluster."""
        reqs = self.load_metrics.resource_requests
        if not reqs:
            return set()
        caps: List[Tuple[Optional[str], Dict[str, float]]] = [
            (None, tot) for _, tot in self._head_nodes("resources_total")]
        caps += [(nid, self._node_resources(nid, "resources_total"))
                 for nid, ntype in live]
        protected = set()
        for bundle in reqs:
            for owner, cap in caps:
                if all(cap.get(k, 0.0) >= v for k, v in bundle.items()):
                    for k, v in bundle.items():
                        cap[k] = cap.get(k, 0.0) - v
                    if owner is not None:
                        protected.add(owner)
                    break
            # bundles no node fits need launches, not protection
        return protected

    def _head_nodes(self, key: str = "resources_available"
                    ) -> List[Tuple[str, Dict[str, float]]]:
        """Head capacity also absorbs demand (it's not a provider node).

        Nodes we just terminated may still look alive in the GCS until
        the heartbeat expires — they must not masquerade as phantom head
        capacity and suppress needed launches."""
        now = time.monotonic()
        self._terminated_ids = {k: t for k, t in
                                self._terminated_ids.items()
                                if now - t < 600.0}
        prefixes = list(self.provider.non_terminated_nodes({})) \
            + list(self._terminated_ids)
        out = []
        for n in self.load_metrics.nodes:
            if not any(n["node_id"].startswith(p) for p in prefixes):
                out.append(("", dict(n.get(key, {}))))
        return out
