"""State API (reference ``python/ray/experimental/state/``)."""

from ray_tpu_torch.experimental.state.api import (  # noqa: F401
    available_resources,
    cluster_resources,
    list_actors,
    list_jobs,
    list_nodes,
    list_objects,
    list_placement_groups,
    list_tasks,
    list_workers,
    object_store_stats,
    summarize_tasks,
    timeline,
)
from ray_tpu_torch.experimental.state.traces import (  # noqa: F401
    get_trace,
    list_traces,
)
from ray_tpu_torch.experimental.state.incidents import (  # noqa: F401
    get_incident,
    list_incidents,
)
