"""Utility libraries on top of the core API (parity: ``ray.util``)."""

from ray_tpu_torch.util.placement_group import (  # noqa: F401
    PlacementGroup,
    placement_group,
    placement_group_table,
    remove_placement_group,
)
from ray_tpu_torch.util.scheduling_strategies import (  # noqa: F401
    NodeAffinitySchedulingStrategy,
    PlacementGroupSchedulingStrategy,
)
