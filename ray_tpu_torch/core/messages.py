"""Typed control-plane message schemas.

Parity: reference ``src/ray/protobuf/*.proto`` — every cross-process
message has a declared shape, and a frame from an incompatible peer is
rejected AT THE BOUNDARY with a structured error instead of failing
somewhere inside unpickling.  Two layers:

1. **Frame versioning** (``rpc.py``): the version byte rides the frame
   HEADER, outside the pickled payload, so a mismatched frame is refused
   before any payload bytes are interpreted.
2. **Schema registry** (this module): core RPC methods declare required
   fields (+ optional type constraints); ``validate`` runs in
   ``Server.dispatch`` and turns a malformed payload into a
   ``SchemaError`` naming the method and field.

The registry covers the control-plane surface whose corruption is
hardest to debug (registration, leases, task/actor pushes, object
plane); unregistered methods pass through — adding a schema is one
line, not a migration.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

__all__ = ["SchemaError", "Opt", "register_schema", "validate", "SCHEMAS"]


class SchemaError(Exception):
    """A message failed boundary validation (method + field in text)."""


class Opt:
    """Marks a schema field as optional: absent or None passes; when
    present and non-None, the wrapped type (if any) is enforced."""

    __slots__ = ("type",)

    def __init__(self, type_: Optional[type] = None):
        self.type = type_


#: method -> {field: expected_type | None (presence only) | Opt(...)}
SCHEMAS: Dict[str, Dict[str, Any]] = {}


def register_schema(method: str, **fields: Any) -> None:
    SCHEMAS[method] = fields


def _type_ok(value: Any, expected: type) -> bool:
    """isinstance with JSON-ish numerics: a float field accepts an int
    (handlers coerce with float(...)), but bool never passes for a
    numeric field."""
    if expected is float:
        return isinstance(value, (int, float)) \
            and not isinstance(value, bool)
    return isinstance(value, expected)


def validate(method: str, data: Any) -> None:
    """Raise SchemaError if ``data`` violates the method's schema."""
    schema = SCHEMAS.get(method)
    if schema is None:
        return
    if not isinstance(data, dict):
        # payload-free methods (pure reads like get_nodes/clock_sync)
        # accept the conventional ``None`` body.  Methods with Opt
        # fields still require a dict: their handlers index into the
        # payload, so letting None through would trade this structured
        # error for an AttributeError inside the handler.
        if data is None and not schema:
            return
        raise SchemaError(
            f"{method}: payload must be a dict, got {type(data).__name__}")
    for field, expected in schema.items():
        if isinstance(expected, Opt):
            value = data.get(field)
            if value is not None and expected.type is not None \
                    and not _type_ok(value, expected.type):
                raise SchemaError(
                    f"{method}: optional field {field!r} must be "
                    f"{expected.type.__name__}, got {type(value).__name__}")
            continue
        if field not in data:
            raise SchemaError(f"{method}: missing required field {field!r}")
        if expected is not None and data[field] is not None \
                and not _type_ok(data[field], expected):
            raise SchemaError(
                f"{method}: field {field!r} must be "
                f"{getattr(expected, '__name__', expected)}, got "
                f"{type(data[field]).__name__}")


# -- core control-plane schemas ------------------------------------------
# registration / membership
register_schema("register_node", node_id=bytes, raylet_address=None,
                resources=dict, pid=Opt(int))
register_schema("register_worker", worker_id=bytes, pid=int,
                task_address=None)
register_schema("register_job", driver_address=None)
register_schema("reattach_job", job_id=bytes)
register_schema("health_report", node_id=bytes, resources_available=dict)

# leases / scheduling
register_schema("request_worker_lease", resources=dict, trace=Opt(dict))
register_schema("cancel_lease", token=str)
register_schema("return_worker", worker_id=bytes)
register_schema("lease_worker_for_actor", actor_id=bytes, resources=dict,
                spec_blob=bytes)
# batched bring-up: one RPC leases workers + pushes creation tasks for a
# whole group of actors bound for this node (GCS -> raylet fan-out)
register_schema("lease_workers_for_actors", actors=list)

# task / actor execution
register_schema("push_task", spec_blob=bytes)
register_schema("push_tasks", specs_blob=bytes)
register_schema("cancel_task", task_id=bytes)
register_schema("create_actor", spec_blob=bytes)
register_schema("push_actor_task", spec_blob=bytes)
register_schema("push_actor_tasks", specs_blob=bytes)
register_schema("register_actor", actor_id=bytes, spec_blob=bytes,
                resources=dict, job_id=bytes, strategy=Opt(str),
                strategy_node=Opt(str), strategy_soft=Opt(bool))
# coalesced registration: ``actors`` is a list of register_actor
# payloads; idempotent keyed on each entry's actor_id so a retried
# batch converges on ONE directory entry per actor
register_schema("register_actor_batch", actors=list)
register_schema("actor_started", actor_id=bytes, task_address=None)
register_schema("kill_actor", actor_id=bytes)

# object plane
register_schema("object_create", object_id=bytes, size=int)
register_schema("object_seal", object_id=bytes)
register_schema("object_get", object_ids=list)
register_schema("object_release", object_ids=list)
register_schema("object_free", object_ids=list)
register_schema("get_small_object", object_id=bytes)
# node-to-node transfer protocol (raylet <-> raylet)
register_schema("object_pull_start", object_id=bytes)
register_schema("object_pull_chunk", object_id=bytes, offset=int, n=int)
register_schema("object_pull_end", object_id=bytes)
# owner-side object directory updates (raylet -> owner worker)
register_schema("object_location_added", object_id=bytes, node=None)
register_schema("object_location_removed", object_id=bytes, node=None)

# telemetry pipeline
register_schema("report_metrics", records=list)
register_schema("report_spans", spans=list)
register_schema("clock_sync")
register_schema("get_metrics")
register_schema("get_spans", cat=Opt(str), limit=Opt(int))

# metrics history + alerting plane (core/metrics_history.py)
register_schema("get_timeseries", series=Opt(str), since=Opt(float),
                limit=Opt(int))
register_schema("get_alerts")
register_schema("healthz")

# distributed tracing plane (core/tracing.py -> GCS trace ring)
register_schema("report_trace_spans", spans=list)
register_schema("get_trace", trace_id=str)
register_schema("list_traces", deployment=Opt(str), slo_misses=Opt(bool),
                since=Opt(float), until=Opt(float), limit=Opt(int))

# continuous profiling plane (core/profiler.py)
register_schema("report_profile", records=list)
register_schema("get_profile", job=Opt(str), node=Opt(str),
                since=Opt(float), limit=Opt(int))
register_schema("profiler_control", enabled=bool, hz=Opt(float),
                duration_s=Opt(float))

# introspection / state surface (payload-free or optional-only reads)
register_schema("ping")
register_schema("debug_state")          # served by both GCS and raylet
# GCS restart-recovery snapshot: what the WAL/snapshot restored and how
# far the live reconvergence (node re-registration, restored-actor
# revalidation) has progressed — consumed by `ray-tpu status`, the HA
# bench, and tests/test_gcs_ha.py
register_schema("recovery_state")
register_schema("get_nodes")
register_schema("get_cluster_load")
register_schema("get_cluster_stats")
register_schema("list_jobs")
register_schema("list_actors")
register_schema("list_placement_groups")
register_schema("list_workers")
register_schema("list_events", limit=Opt(int), severity=Opt(str))
# incident forensics plane (core/flight_recorder.py + GCS journal)
register_schema("report_flight_tail", source=str, pid=int, frames=list,
                reason=Opt(str), node_id=Opt(bytes), torn=Opt(int))
register_schema("list_incidents", limit=Opt(int), kind=Opt(str))
register_schema("get_incident", incident_id=str)
register_schema("list_objects", limit=Opt(int))
register_schema("get_task_events", limit=Opt(int), job_id=Opt(str),
                state=Opt(str))
register_schema("store_info")
register_schema("store_stats")
register_schema("stack_trace")          # one worker's dump
register_schema("stack_traces")         # raylet fan-out over its workers
register_schema("kv_keys", prefix=Opt(str), namespace=Opt(str))

# job / node lifecycle
register_schema("job_finished", job_id=bytes)
register_schema("drain_node", node_id=bytes, reason=Opt(str),
                force=Opt(bool))
# graceful drain (GCS -> raylet): migrate sealed primaries + spill
# blobs to the listed ACTIVE peers, then stop taking leases for good
register_schema("drain", peers=list, reason=Opt(str))
# drain migration (raylet -> peer raylet): pull this object from me (or
# my spill tier) and become its primary holder before I release
register_schema("adopt_object", object_id=bytes, owner=Opt(list),
                source=Opt(list), size=Opt(int), spilled=Opt(bool))
# per-job scheduling quotas (weights + in-flight ceilings)
register_schema("set_job_quota", job=str, quota=Opt(dict))
register_schema("get_job_quotas")

# actor lifecycle (beyond registration)
register_schema("actor_creation_failed", actor_id=bytes, reason=Opt(str))
register_schema("get_actor", actor_id=Opt(bytes), name=Opt(str),
                namespace=Opt(str))

# pubsub fan-in
register_schema("publish", channel=str, message=None)

# placement-group internals (GCS <-> raylet two-phase commit, client poll)
register_schema("placement_group_ready", pg_id=bytes, block_s=Opt(float))
register_schema("prepare_bundle", pg_id=bytes, bundle_index=int,
                resources=dict)
register_schema("commit_bundle", pg_id=bytes, bundle_index=int)
register_schema("return_bundle", pg_id=bytes, bundle_index=int)

# object plane: owner-side directory / recovery / borrow tracking
register_schema("reconstruct_object", object_id=bytes)
register_schema("get_object_locations", object_id=bytes)
register_schema("object_spilled", object_id=bytes, uri=Opt(str),
                node=Opt(list))
register_schema("object_contains", object_id=bytes)
register_schema("add_borrow", object_id=bytes, borrower=None)
register_schema("remove_borrow", object_id=bytes, borrower=None)
register_schema("report_task_events", events=list)

# kv / functions / pubsub
register_schema("kv_put", key=str, value=None)
register_schema("kv_get", key=str)
register_schema("kv_del", key=str)
register_schema("get_function", function_id=str)
register_schema("register_function", function_id=str, blob=bytes)
register_schema("subscribe", channel=str)
register_schema("unsubscribe", channel=str)

# placement groups
register_schema("create_placement_group", pg_id=bytes, bundles=list)
register_schema("remove_placement_group", pg_id=bytes)
