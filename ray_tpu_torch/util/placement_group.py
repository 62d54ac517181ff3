"""Placement groups: gang scheduling of resource bundles.

Parity: reference ``python/ray/util/placement_group.py`` +
``src/ray/gcs/gcs_server/gcs_placement_group_scheduler.h`` (two-phase
prepare/commit lives in ``ray_tpu_torch.core.gcs``).  TPU twist: bundles placed
with PACK/STRICT_PACK sort nodes by slice so a gang lands on one ICI
domain (SURVEY.md §7.4).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

from ray_tpu_torch.core.exceptions import PlacementGroupUnschedulableError
from ray_tpu_torch.core.ids import PlacementGroupID
from ray_tpu_torch.core.object_ref import ObjectRef
from ray_tpu_torch.core import worker as worker_mod

VALID_STRATEGIES = ("PACK", "SPREAD", "STRICT_PACK", "STRICT_SPREAD")


class PlacementGroup:
    def __init__(self, pg_id: PlacementGroupID,
                 bundles: List[Dict[str, float]], strategy: str):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy

    @property
    def bundle_count(self) -> int:
        return len(self.bundles)

    def ready(self) -> ObjectRef:
        """An ObjectRef that resolves when the group is placed (parity:
        ``PlacementGroup.ready()``)."""
        core = worker_mod.global_worker()
        ref = core.put("__pg_ready_pending__")

        # resolve via GCS long-polls on the io loop, then publish the ref
        async def _poll():
            import asyncio

            from ray_tpu_torch.core import rpc as rpc_mod
            while True:
                try:
                    reply = await core.gcs_conn.call(
                        "placement_group_ready",
                        {"pg_id": self.id.binary(), "block_s": 25.0},
                        timeout=40.0)
                except asyncio.TimeoutError:
                    continue  # saturated GCS: re-arm the long poll
                except rpc_mod.RpcError:
                    # a FAST server-side error would hot-spin this loop
                    # (and flood the GCS) without a pause
                    await asyncio.sleep(0.5)
                    continue
                except rpc_mod.ConnectionLost:
                    await asyncio.sleep(0.5)  # head restarting
                    continue
                if reply["state"] == "CREATED":
                    from ray_tpu_torch.core.serialization import serialize
                    core._publish(ref.id(), serialize(self).to_bytes())
                    return
                # INFEASIBLE is transient: the GCS retries placement as
                # resources free / nodes join (autoscaler hook).  Only
                # REMOVED is terminal — anything else re-arms the long
                # poll.
                if reply["state"] == "REMOVED":
                    from ray_tpu_torch.core.serialization import serialize_exception
                    core._publish(ref.id(), serialize_exception(
                        PlacementGroupUnschedulableError(
                            f"placement group state: {reply['state']}")
                    ).to_bytes())
                    return

        core.memory_store.delete(ref.id())
        core._post(_poll())
        return ref

    def wait(self, timeout_seconds: float = 30.0) -> bool:
        core = worker_mod.global_worker()
        deadline = time.monotonic() + timeout_seconds
        while True:
            remaining = deadline - time.monotonic()
            # GCS-side long poll: the reply is held until the group is
            # terminal-or-created, so there is no client sleep loop (a
            # fixed 50 ms poll interval used to quantize every barely-
            # missed placement to 50 ms)
            try:
                reply = core._run(core.gcs_conn.call(
                    "placement_group_ready",
                    {"pg_id": self.id.binary(),
                     "block_s": max(0.0, min(remaining, 25.0))},
                    timeout=max(1.0, remaining) + 10.0))
            except Exception:  # noqa: BLE001 — saturated GCS/conn loss:
                if remaining <= 0:  # wait() contract is bool, not raise
                    return False
                time.sleep(0.2)
                continue
            if reply["state"] == "CREATED":
                return True
            if reply["state"] == "REMOVED":
                return False
            if remaining <= 0:
                return False

    def bundle_nodes(self) -> Dict[int, str]:
        """bundle index -> node id hex (introspection)."""
        core = worker_mod.global_worker()
        reply = core._run(core.gcs_conn.call(
            "placement_group_ready", {"pg_id": self.id.binary()}))
        return {int(i): n.hex() if isinstance(n, bytes) else n
                for i, n in (reply.get("bundle_nodes") or {}).items()}

    def __reduce__(self):
        return (PlacementGroup, (self.id, self.bundles, self.strategy))


def placement_group(bundles: List[Dict[str, float]],
                    strategy: str = "PACK",
                    name: Optional[str] = None) -> PlacementGroup:
    if strategy not in VALID_STRATEGIES:
        raise ValueError(f"strategy must be one of {VALID_STRATEGIES}")
    if not bundles or any(not b for b in bundles):
        raise ValueError("bundles must be non-empty resource dicts")
    core = worker_mod.global_worker()
    pg_id = PlacementGroupID.of(core.job_id)
    core._run(core.gcs_conn.call("create_placement_group", {
        "pg_id": pg_id.binary(),
        "bundles": bundles,
        "strategy": strategy,
        "name": name,
    }))
    return PlacementGroup(pg_id, bundles, strategy)


def remove_placement_group(pg: PlacementGroup) -> None:
    core = worker_mod.global_worker()
    core._run(core.gcs_conn.call("remove_placement_group",
                                 {"pg_id": pg.id.binary()}))


def placement_group_table() -> Dict[str, Dict]:
    core = worker_mod.global_worker()
    out = {}
    reply = core._run(core.gcs_conn.call("list_placement_groups", {}))
    for entry in reply:
        out[entry["pg_id"].hex()] = entry
    return out
