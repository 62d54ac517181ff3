"""Ownership-based reference counting and task lifetime management.

Parity: reference ``src/ray/core_worker/reference_count.h`` (distributed
refcount + borrowing) and ``task_manager.h`` (in-flight task tracking,
retries, lineage pinning for reconstruction).

Model: the worker that creates an object (by ``put`` or by submitting the
producing task) is its *owner*.  The owner tracks

- local refs    — live ``ObjectRef`` pythons objects in the owner process,
- submitted refs — uses of the object as an argument of in-flight tasks,
- borrowers     — remote workers that deserialized the ref.

When all three hit zero, the object is freed: dropped from the owner's
memory store and, for shared-memory objects, a free is broadcast to every
raylet holding a copy.  Borrowing workers keep a local count per borrowed
ref and tell the owner when they first see the ref and when their last
local ref dies.

Lineage: the owner keeps the producing TaskSpec of every finished task
whose returns are still referenced, so a lost shared-memory object can be
reconstructed by resubmitting the task (reference
``object_recovery_manager.h``).
"""

from __future__ import annotations

import logging
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

from ray_tpu_torch.core.ids import ObjectID, TaskID
from ray_tpu_torch.core.task_spec import TaskSpec

logger = logging.getLogger(__name__)


class Reference:
    """Slots class, not a dataclass: one is allocated per owned/borrowed
    object on the submit hot path, and the three collection fields start
    as shared empty singletons (a set/list allocation each measured ~1 us
    ×3 per task).  Mutating sites replace the singleton first."""

    __slots__ = ("local_refs", "submitted_refs", "borrowers", "owned",
                 "owner_address", "locations", "spilled_on", "spilled_uri",
                 "in_plasma",
                 "producing_task", "contained_ids", "freed")

    _EMPTY_SET: frozenset = frozenset()

    def __init__(self):
        self.local_refs = 0
        self.submitted_refs = 0
        self.borrowers: Set[tuple] = self._EMPTY_SET  # worker addresses
        self.owned = False  # this process is the owner
        self.owner_address: Optional[tuple] = None  # for borrowed refs
        # nodes (raylet addresses) known to hold a shm copy; owner-side only
        self.locations: Set[tuple] = self._EMPTY_SET
        self.spilled_on: Optional[tuple] = None
        self.spilled_uri: Optional[str] = None
        self.in_plasma = False
        # lineage: the task that produces this object (owner-side)
        self.producing_task: Optional[TaskID] = None
        # refs nested inside this object's serialized bytes: pinned (as
        # submitted refs) until this object itself is freed, so readers can
        # always borrow them (parity: the reference records nested ids on
        # the owning reference)
        self.contained_ids: Sequence[ObjectID] = ()
        self.freed = False


class ReferenceCounter:
    """Thread-safe refcount table.

    Locking discipline (parity: the reference posts release callbacks to the
    io_service instead of invoking them under its mutex,
    ``src/ray/core_worker/reference_count.cc``): ``self._lock`` protects only
    the table; the ``on_free`` / ``on_borrow_*`` callbacks are ALWAYS invoked
    after the lock is released.  Callbacks may therefore take other locks
    (e.g. the TaskManager's) without risking lock-order inversion — the
    round-1 AB-BA deadlock was exactly ``remove_local_ref`` (RC lock held)
    → ``evict_lineage`` (wants TM lock) racing ``TaskManager.register``
    (TM lock held) → ``add_owned`` (wants RC lock).
    """

    def __init__(self, on_free: Callable[[ObjectID, Reference], None],
                 on_borrow_added: Callable[[ObjectID, Optional[tuple]], None],
                 on_borrow_removed: Callable[[ObjectID, Optional[tuple]], None]):
        self._lock = threading.RLock()
        self._refs: Dict[ObjectID, Reference] = {}
        self._on_free = on_free
        self._on_borrow_added = on_borrow_added
        self._on_borrow_removed = on_borrow_removed

    # A "release action" is computed under the lock and fired outside it.
    def _fire(self, action: Optional[tuple]) -> None:
        if action is None:
            return
        kind, object_id, payload = action
        try:
            if kind == "free":
                self._on_free(object_id, payload)
                # the freed object's nested refs lose their containment
                # pin (may cascade; we are outside the lock)
                for cid in payload.contained_ids:
                    self.remove_submitted_ref(cid)
            else:  # "borrow_removed"
                self._on_borrow_removed(object_id, payload)
        except Exception:  # callbacks must never poison the caller
            logger.exception("refcount release callback failed for %s",
                             object_id)

    def _get(self, object_id: ObjectID) -> Reference:
        ref = self._refs.get(object_id)
        if ref is None:
            ref = Reference()
            self._refs[object_id] = ref
        return ref

    # -- owner-side -------------------------------------------------------
    def add_owned(self, object_id: ObjectID,
                  producing_task: Optional[TaskID] = None) -> None:
        with self._lock:
            ref = self._get(object_id)
            ref.owned = True
            ref.producing_task = producing_task

    def add_local_ref(self, object_id: ObjectID) -> None:
        with self._lock:
            self._get(object_id).local_refs += 1

    def set_contained(self, object_id: ObjectID,
                      contained: List[ObjectID]) -> None:
        """Pin refs nested inside ``object_id``'s serialized value for
        the outer object's lifetime (released on its free)."""
        if not contained:
            return
        with self._lock:
            self._get(object_id).contained_ids = list(contained)
            for cid in contained:
                self._get(cid).submitted_refs += 1

    def remove_local_ref(self, object_id: ObjectID) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            ref.local_refs -= 1
            action = self._maybe_release(object_id, ref)
        self._fire(action)

    def add_submitted_ref(self, object_id: ObjectID) -> None:
        with self._lock:
            self._get(object_id).submitted_refs += 1

    def remove_submitted_ref(self, object_id: ObjectID) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            ref.submitted_refs -= 1
            action = self._maybe_release(object_id, ref)
        self._fire(action)

    def add_borrower(self, object_id: ObjectID, borrower: tuple) -> None:
        with self._lock:
            ref = self._get(object_id)
            if ref.borrowers is Reference._EMPTY_SET:
                ref.borrowers = set()
            ref.borrowers.add(borrower)

    def remove_borrower(self, object_id: ObjectID, borrower: tuple) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return
            if ref.borrowers:
                ref.borrowers.discard(borrower)
            action = self._maybe_release(object_id, ref)
        self._fire(action)

    def add_location(self, object_id: ObjectID, node_address: tuple) -> None:
        with self._lock:
            ref = self._get(object_id)
            ref.in_plasma = True
            if ref.locations is Reference._EMPTY_SET:
                ref.locations = set()
            ref.locations.add(node_address)

    def set_spilled(self, object_id: ObjectID, node_address: tuple) -> None:
        with self._lock:
            self._get(object_id).spilled_on = node_address

    def set_spilled_uri(self, object_id: ObjectID, uri: str) -> None:
        """External spill tier: the blob survives the spilling node, so
        the owner records the URI (any node can restore from it)."""
        with self._lock:
            self._get(object_id).spilled_uri = uri

    def get_spilled_uri(self, object_id: ObjectID) -> Optional[str]:
        with self._lock:
            ref = self._refs.get(object_id)
            return ref.spilled_uri if ref is not None else None

    def remove_location(self, object_id: ObjectID, node_address: tuple) -> None:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is not None and ref.locations:
                ref.locations.discard(node_address)

    def get_locations(self, object_id: ObjectID) -> Tuple[List[tuple],
                                                          Optional[tuple]]:
        with self._lock:
            ref = self._refs.get(object_id)
            if ref is None:
                return [], None
            return list(ref.locations), ref.spilled_on

    def get(self, object_id: ObjectID) -> Optional[Reference]:
        with self._lock:
            return self._refs.get(object_id)

    # -- borrower-side ----------------------------------------------------
    def add_borrowed_ref(self, object_id: ObjectID,
                         owner_address: Optional[tuple]) -> None:
        with self._lock:
            ref = self._get(object_id)
            first = ref.local_refs == 0 and not ref.owned
            ref.local_refs += 1
            if ref.owner_address is None:
                ref.owner_address = owner_address
        if first:
            self._on_borrow_added(object_id, owner_address)

    # -- release ----------------------------------------------------------
    def _maybe_release(self, object_id: ObjectID,
                       ref: Reference) -> Optional[tuple]:
        """Called with self._lock held.  Returns the release action to fire
        AFTER the lock is released (never invokes callbacks inline)."""
        if ref.local_refs > 0 or ref.submitted_refs > 0 or ref.borrowers:
            return None
        if ref.freed:
            return None
        ref.freed = True
        del self._refs[object_id]
        if ref.owned:
            return ("free", object_id, ref)
        # last local borrow released: tell the owner
        return ("borrow_removed", object_id, ref.owner_address)

    def owned_count(self) -> int:
        with self._lock:
            return sum(1 for r in self._refs.values() if r.owned)

    def summary(self) -> Dict[str, int]:
        with self._lock:
            return {
                "total": len(self._refs),
                "owned": sum(1 for r in self._refs.values() if r.owned),
                "borrowed": sum(1 for r in self._refs.values() if not r.owned),
                "in_plasma": sum(1 for r in self._refs.values() if r.in_plasma),
            }


@dataclass
class PendingTask:
    spec: TaskSpec
    retries_left: int
    # callbacks fired with (results | None, error | None)
    lineage_footprint: List[ObjectID] = field(default_factory=list)


class TaskManager:
    """Owner-side in-flight task table with retry + lineage bookkeeping.

    The owner registers every submitted task here before handing it to a
    submitter.  On completion the return values are published to the
    memory store; the spec is retained (lineage) while any return object
    may still need reconstruction.  On worker/node failure the task is
    resubmitted if its retry budget allows.

    Locking discipline: the TM lock protects only the pending/lineage
    tables.  All ReferenceCounter calls happen OUTSIDE the TM lock (the RC
    may fire free callbacks that re-enter ``evict_lineage``), so the only
    nesting that ever occurs is "no lock held → RC lock" and "no lock held
    → TM lock" — no AB-BA cycle is possible.
    """

    def __init__(self, reference_counter: ReferenceCounter):
        self._lock = threading.RLock()
        self._pending: Dict[TaskID, PendingTask] = {}
        self._lineage: Dict[TaskID, TaskSpec] = {}
        self._rc = reference_counter

    @staticmethod
    def _arg_ids(spec: TaskSpec):
        """Every object id a task's flight must pin: direct ref args plus
        refs nested inside inlined values."""
        for arg in spec.args:
            if arg.object_id is not None:
                yield arg.object_id
            yield from arg.contained_ids

    def register(self, spec: TaskSpec) -> List[ObjectID]:
        """Registers the flight; returns the return ids so the submitter
        can build its ObjectRefs without recomputing them (they cost one
        hash construction each on the hot path)."""
        rets = spec.return_ids()
        for ret in rets:
            self._rc.add_owned(ret, producing_task=spec.task_id)
        for oid in self._arg_ids(spec):
            self._rc.add_submitted_ref(oid)
        with self._lock:
            self._pending[spec.task_id] = PendingTask(
                spec=spec, retries_left=spec.max_retries)
        return rets

    def is_pending(self, task_id: TaskID) -> bool:
        with self._lock:
            return task_id in self._pending

    def pending_spec(self, task_id: TaskID) -> Optional[TaskSpec]:
        with self._lock:
            entry = self._pending.get(task_id)
            return entry.spec if entry is not None else None

    def num_pending(self) -> int:
        with self._lock:
            return len(self._pending)

    def complete(self, task_id: TaskID) -> Optional[TaskSpec]:
        """Mark done; returns the spec (now lineage) if it was pending."""
        with self._lock:
            entry = self._pending.pop(task_id, None)
            if entry is None:
                return None
            self._lineage[task_id] = entry.spec
        for oid in self._arg_ids(entry.spec):
            self._rc.remove_submitted_ref(oid)
        return entry.spec

    def take_for_retry(self, task_id: TaskID) -> Optional[TaskSpec]:
        """Consume one retry; returns the bumped spec or None if exhausted."""
        with self._lock:
            entry = self._pending.get(task_id)
            if entry is None or entry.retries_left <= 0:
                return None
            entry.retries_left -= 1
            entry.spec.attempt_number += 1
            return entry.spec

    def fail(self, task_id: TaskID) -> Optional[TaskSpec]:
        with self._lock:
            entry = self._pending.pop(task_id, None)
            if entry is None:
                return None
        for oid in self._arg_ids(entry.spec):
            self._rc.remove_submitted_ref(oid)
        return entry.spec

    def lineage_spec(self, task_id: TaskID) -> Optional[TaskSpec]:
        with self._lock:
            return self._lineage.get(task_id)

    def resubmit_for_reconstruction(self, task_id: TaskID
                                    ) -> Optional[TaskSpec]:
        """Move a finished task back to pending for lineage reconstruction."""
        with self._lock:
            spec = self._lineage.get(task_id)
            if spec is None:
                return None
            if task_id in self._pending:
                return None  # already being re-executed
            spec.attempt_number += 1
            self._pending[task_id] = PendingTask(spec=spec, retries_left=0)
        for oid in self._arg_ids(spec):
            self._rc.add_submitted_ref(oid)
        return spec

    def evict_lineage(self, task_id: TaskID) -> None:
        with self._lock:
            self._lineage.pop(task_id, None)
