"""Demand-driven bin-packing of queued work onto node types.

Parity: reference
``autoscaler/_private/resource_demand_scheduler.py``
(``ResourceDemandScheduler``:103, ``get_nodes_to_launch``:171) — given
the unfulfilled resource demand (queued task/actor shapes + pending
placement-group bundles) and the available node types, decide how many
of which node type to launch.  Same strategy: try to pack demand onto
existing capacity first; launch the node type with the best utilization
score for what remains; strict-spread bundles force distinct nodes.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class NodeTypeConfig:
    resources: Dict[str, float]
    min_workers: int = 0
    max_workers: int = 2 ** 30
    node_config: Dict[str, Any] = field(default_factory=dict)


def _fits(avail: Dict[str, float], shape: Dict[str, float]) -> bool:
    return all(avail.get(k, 0.0) >= v for k, v in shape.items() if v > 0)


def _take(avail: Dict[str, float], shape: Dict[str, float]) -> None:
    for k, v in shape.items():
        avail[k] = avail.get(k, 0.0) - v


class ResourceDemandScheduler:
    def __init__(self, node_types: Dict[str, NodeTypeConfig],
                 max_workers: int = 2 ** 30):
        self.node_types = node_types
        self.max_workers = max_workers

    def get_nodes_to_launch(
        self,
        existing_nodes: List[Tuple[str, Dict[str, float]]],
        demand: List[Dict[str, float]],
        pending_placement_groups: Optional[List[Dict[str, Any]]] = None,
        launching: Optional[Dict[str, int]] = None,
    ) -> Dict[str, int]:
        """existing_nodes: (node_type, resources_available) per live node;
        ``launching``: launches already requested but not yet joined
        (counted as capacity so demand isn't double-provisioned).
        Returns {node_type: count}."""
        # expand pg bundles into plain demand; STRICT_SPREAD bundles are
        # tagged so the packer places them on distinct (virtual) nodes
        flat: List[Tuple[Dict[str, float], Optional[int]]] = \
            [(d, None) for d in demand]
        for gi, pg in enumerate(pending_placement_groups or []):
            strict = pg.get("strategy") == "STRICT_SPREAD"
            for b in pg.get("bundles", []):
                flat.append((b, gi if strict else None))
        # biggest shapes first: classic first-fit-decreasing
        flat.sort(key=lambda it: -sum(it[0].values()))

        pools: List[Tuple[Optional[str], Dict[str, float], set]] = [
            (None, dict(avail), set()) for _, avail in existing_nodes]
        for ntype, count in (launching or {}).items():
            for _ in range(count):
                pools.append((ntype,
                              dict(self.node_types[ntype].resources),
                              set()))
        to_launch: Dict[str, int] = {}
        existing_count: Dict[str, int] = {}
        for ntype, _ in existing_nodes:
            existing_count[ntype] = existing_count.get(ntype, 0) + 1
        for ntype, count in (launching or {}).items():
            existing_count[ntype] = existing_count.get(ntype, 0) + count
        total_nodes = len(pools)

        unfulfilled: List[Tuple[Dict[str, float], Optional[int]]] = []
        for shape, group in flat:
            placed = False
            for _, avail, groups in pools:
                if group is not None and group in groups:
                    continue  # strict-spread: one bundle per node
                if _fits(avail, shape):
                    _take(avail, shape)
                    if group is not None:
                        groups.add(group)
                    placed = True
                    break
            if not placed:
                unfulfilled.append((shape, group))

        # launch nodes for what's left: pick, per remaining shape batch,
        # the feasible type that wastes least (best utilization)
        while unfulfilled and total_nodes < self.max_workers:
            best: Optional[str] = None
            best_score: Tuple[int, float] = (-1, 0.0)
            for name, cfg in self.node_types.items():
                if existing_count.get(name, 0) + to_launch.get(name, 0) \
                        >= cfg.max_workers:
                    continue
                avail = dict(cfg.resources)
                placed_n, used = 0, 0.0
                groups: set = set()
                for shape, group in unfulfilled:
                    if group is not None and group in groups:
                        continue
                    if _fits(avail, shape):
                        _take(avail, shape)
                        placed_n += 1
                        used += sum(shape.values())
                        if group is not None:
                            groups.add(group)
                score = (placed_n, used / max(1e-9,
                                              sum(cfg.resources.values())))
                if score > best_score:
                    best_score, best = score, name
            if best is None or best_score[0] == 0:
                break  # remaining demand infeasible on any type
            to_launch[best] = to_launch.get(best, 0) + 1
            existing_count[best] = existing_count.get(best, 0)
            total_nodes += 1
            avail = dict(self.node_types[best].resources)
            groups = set()
            still: List[Tuple[Dict[str, float], Optional[int]]] = []
            for shape, group in unfulfilled:
                if (group is None or group not in groups) \
                        and _fits(avail, shape):
                    _take(avail, shape)
                    if group is not None:
                        groups.add(group)
                else:
                    still.append((shape, group))
            unfulfilled = still
        return to_launch
