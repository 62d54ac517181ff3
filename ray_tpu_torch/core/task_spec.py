"""Task specifications — the unit handed from submitter to executor.

Parity: reference ``src/ray/common/task/task_spec.h`` /
``src/ray/protobuf/common.proto`` TaskSpec.  A spec fully describes one
invocation: function identity (by hash into the GCS function table),
serialized arguments (small values inlined; larger ones as ObjectRef
references), resource demand, retry policy, and — for actor tasks —
ordering metadata.

Wire/snapshot compatibility: spec pickles are SAME-VERSION artifacts —
every process in a cluster (and the GCS snapshot a restarted head
reads) runs the same code.  The ``slots=True`` dataclasses therefore
do not carry cross-version pickle shims; a rolling-upgrade story would
need a versioned codec here first (the reference takes the same
same-version stance for its protobuf-fields-at-head wire format).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core.ids import ActorID, JobID, ObjectID, PlacementGroupID, TaskID
from ray_tpu_torch.core.object_ref import OwnerAddress


class TaskType(enum.Enum):
    NORMAL_TASK = 0
    ACTOR_CREATION_TASK = 1
    ACTOR_TASK = 2


@dataclass(slots=True)
class TaskArg:
    """Either an inlined serialized value or an object reference."""

    # Exactly one of (value_bytes, object_id) is set.
    value_bytes: Optional[bytes] = None
    object_id: Optional[ObjectID] = None
    owner_address: Optional[OwnerAddress] = None
    # ObjectRefs nested INSIDE an inlined value (e.g. a dict of refs):
    # pinned as submitted-refs for the task's flight so the owner cannot
    # free them before the borrowing worker registers (parity: the
    # reference's borrowing protocol pins args until execution).
    contained_ids: List[ObjectID] = field(default_factory=list)

    def is_inline(self) -> bool:
        return self.value_bytes is not None


@dataclass(slots=True)
class SchedulingStrategy:
    """Default / spread / node-affinity / placement-group placement.

    Parity: ``python/ray/util/scheduling_strategies.py``.
    """

    kind: str = "DEFAULT"  # DEFAULT | SPREAD | NODE_AFFINITY | PLACEMENT_GROUP
    node_id_hex: Optional[str] = None
    soft: bool = False
    placement_group_id: Optional[PlacementGroupID] = None
    bundle_index: int = -1
    capture_child_tasks: bool = False


@dataclass(slots=True)
class TaskSpec:
    task_id: TaskID
    job_id: JobID
    task_type: TaskType
    # Identity of the function/class in the GCS function table.
    function_id: str
    function_descriptor: str  # human-readable "module.fn" for errors/state API
    args: List[TaskArg] = field(default_factory=list)
    num_returns: int = 1
    resources: Dict[str, float] = field(default_factory=dict)
    max_retries: int = 0
    retry_exceptions: bool = False
    #: worker recycling: after this many executions of this function the
    #: worker exits and a fresh one serves the next call (0 = unlimited;
    #: reference remote_function.py:58 — and like its num_gpus rule,
    #: TPU-resource tasks default to 1 so device memory is released)
    max_calls: int = 0
    scheduling_strategy: SchedulingStrategy = field(default_factory=SchedulingStrategy)
    owner_address: Optional[OwnerAddress] = None
    # Actor-related fields.
    actor_id: Optional[ActorID] = None
    actor_creation_spec: Optional["ActorCreationSpec"] = None
    # Ordering for actor tasks (per-caller sequence number).
    sequence_number: int = 0
    # Name of the concurrency group for async actors ("" = default).
    concurrency_group: str = ""
    # Runtime environment (env_vars/working_dir/py_modules, packaged) —
    # part of the scheduling key: workers are dedicated per env.
    runtime_env: Optional[Dict[str, Any]] = None
    runtime_env_hash: Optional[str] = None
    # W3C traceparent carrier (opt-in tracing; util/tracing)
    trace_context: Optional[Dict[str, str]] = None
    # Attempt counter (incremented on retries) — return object IDs stay
    # stable across attempts, matching the reference's semantics.
    attempt_number: int = 0
    # Depth in the lineage tree (driver = 0), bounds reconstruction.
    depth: int = 0
    # num_returns="dynamic" (parity: _raylet.pyx:603-622): the task
    # yields a variable number of objects; its single declared return
    # resolves to an ObjectRefGenerator over them.
    dynamic_returns: bool = False
    # num_returns="streaming": dynamic AND each yielded object is
    # pushed to the owner AS PRODUCED, so the caller's generator can
    # consume item i while the task still computes item i+1 (parity:
    # the reference's streaming ObjectRefGenerator protocol).
    stream_returns: bool = False

    def return_ids(self) -> List[ObjectID]:
        return [
            ObjectID.for_task_return(self.task_id, i + 1)
            for i in range(self.num_returns)
        ]

    def dynamic_return_id(self, i: int) -> ObjectID:
        """ID of the i-th yielded object of a dynamic-returns task.
        Index space starts after the declared returns (index 1 is the
        generator handle), and is attempt-independent so lineage
        reconstruction regenerates the same IDs."""
        return ObjectID.for_task_return(self.task_id,
                                        self.num_returns + 1 + i)

    def scheduling_key(self) -> Tuple:
        """Tasks with the same key can share leased workers (parity:
        ``SchedulingKey`` in direct_task_transport.h)."""
        strat = self.scheduling_strategy
        return (
            self.function_id,
            tuple(sorted(self.resources.items())),
            strat.kind,
            strat.node_id_hex,
            strat.placement_group_id,
            strat.bundle_index,
            self.runtime_env_hash,
        )

    def debug_name(self) -> str:
        return f"{self.function_descriptor}[{self.task_id.hex()[:12]}]"


@dataclass(slots=True)
class ActorCreationSpec:
    max_restarts: int = 0
    max_task_retries: int = 0
    name: Optional[str] = None  # named (and optionally detached) actors
    namespace: str = "default"
    lifetime_detached: bool = False
    max_concurrency: int = 1
    is_asyncio: bool = False
    concurrency_groups: Dict[str, int] = field(default_factory=dict)
