"""Scheduling strategy objects (parity:
``python/ray/util/scheduling_strategies.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class PlacementGroupSchedulingStrategy:
    placement_group: "PlacementGroup"  # noqa: F821
    placement_group_bundle_index: int = -1
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    node_id: str  # hex
    soft: bool = False
