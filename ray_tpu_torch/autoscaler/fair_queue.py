"""Weighted fair queueing + per-job quotas for the raylet lease queue.

Parity model: deficit round robin (Shreedhar & Varghese, SIGCOMM '95)
over per-job sub-queues, the same discipline the reference's
out-of-order actor scheduling RFC proposes for multi-tenant raylets,
crossed with the TPU concurrency-limits motivation (arXiv:2011.03641):
keep the chips saturated across jobs without letting one tenant's
burst starve a latency-sensitive deployment.

This module is PURE STATE — no clocks, no asyncio, no RPC — so the
scheduling math is unit-testable in isolation (`tests/test_fair_queue.py`)
and the raylet merely feeds it events:

* :meth:`FairQueue.push` enqueues a pending lease under its job key.
* :meth:`FairQueue.next_grant` returns the next lease a scheduling
  pass should try, honoring weighted deficits and quota ceilings.
* :meth:`FairQueue.commit` / :meth:`FairQueue.requeue` settle the
  attempt (resources taken vs. didn't fit).
* :meth:`FairQueue.release` returns in-flight usage when a lease's
  resources free.
* :meth:`FairQueue.reconcile` resets the in-flight ledger from ground
  truth (the raylet's actual active leases) — accounting drops (the
  ``raylet.quota.account_drop`` failpoint, or a crashed worker path)
  converge instead of wedging a job under a phantom quota forever.

Fairness: each job owns a deficit counter.  A grant round adds
``quantum * weight`` to every backlogged job's deficit; a job may be
granted while its deficit covers the lease's dominant-resource cost.
A 10k-task burst from one tenant therefore queues behind its weight —
other jobs' grant rates degrade no worse than their weight share —
and every nonzero-weight job is granted eventually (starvation-free:
deficits grow each round until the head lease is covered).

Quotas: an optional per-job ceiling on *in-flight* resources (e.g.
``{"CPU": 8}``).  A job at its ceiling is skipped — its leases stay
queued (``mode="queue"``) or are rejected back to the caller
(``mode="reject"``), the reference's two placement-queue behaviors.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "JobQuota", "FairQueue", "QuotaExceeded",
    "NODE_ACTIVE", "NODE_DRAINING", "NODE_DRAINED", "NODE_DEAD",
    "DRAIN_TRANSITIONS", "can_transition", "validate_transition",
]

# ---------------------------------------------------------------------------
# node lifecycle state machine (used by the GCS drain protocol)
# ---------------------------------------------------------------------------
NODE_ACTIVE = "ACTIVE"
NODE_DRAINING = "DRAINING"
NODE_DRAINED = "DRAINED"
NODE_DEAD = "DEAD"

#: the full transition matrix.  DRAINING -> ACTIVE is the abort edge (a
#: failed migration returns the node to service); DRAINED never goes
#: back — a drained node's only exit is release (DEAD).
DRAIN_TRANSITIONS: Dict[str, Tuple[str, ...]] = {
    NODE_ACTIVE: (NODE_DRAINING, NODE_DEAD),
    NODE_DRAINING: (NODE_ACTIVE, NODE_DRAINED, NODE_DEAD),
    NODE_DRAINED: (NODE_DEAD,),
    NODE_DEAD: (),
}


def can_transition(src: str, dst: str) -> bool:
    return dst in DRAIN_TRANSITIONS.get(src, ())


def validate_transition(src: str, dst: str) -> None:
    if not can_transition(src, dst):
        raise ValueError(f"illegal node state transition {src} -> {dst}")


# ---------------------------------------------------------------------------
# quotas
# ---------------------------------------------------------------------------
class QuotaExceeded(Exception):
    """A ``mode="reject"`` job pushed past its in-flight ceiling."""

    def __init__(self, job: str, resource: str):
        super().__init__(
            f"job {job} exceeded its {resource} quota (reject mode)")
        self.job = job
        self.resource = resource


@dataclass
class JobQuota:
    """Per-job scheduling contract.

    ``weight`` scales the job's deficit refill (its long-run share of
    contended grant throughput).  ``limits`` caps in-flight resources;
    empty means unlimited.  ``mode`` picks the over-quota behavior:
    ``"queue"`` parks leases until usage drains, ``"reject"`` bounces
    them at push time.
    """

    weight: float = 1.0
    limits: Dict[str, float] = field(default_factory=dict)
    mode: str = "queue"  # "queue" | "reject"

    def to_dict(self) -> Dict[str, Any]:
        return {"weight": self.weight, "limits": dict(self.limits),
                "mode": self.mode}

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "JobQuota":
        return cls(weight=float(d.get("weight", 1.0)),
                   limits=dict(d.get("limits", {})),
                   mode=str(d.get("mode", "queue")))


@dataclass
class _JobState:
    queue: List[Any] = field(default_factory=list)   # pending items
    deficit: float = 0.0
    usage: Dict[str, float] = field(default_factory=dict)  # in-flight


def _cost(resources: Dict[str, float]) -> float:
    """Dominant-resource cost of one lease (max requested amount; a
    zero-resource lease still costs 1 grant slot so deficits matter)."""
    return max(list(resources.values()) + [1.0])


class FairQueue:
    """Deficit-round-robin lease queue with per-job quotas.

    The raylet owns one instance; items are opaque (PendingLease
    objects there, ints in the unit tests).  ``key_of`` maps an item
    to its resource dict.
    """

    def __init__(self, *, quantum: float = 1.0,
                 resources_of: Optional[Callable[[Any],
                                                 Dict[str, float]]] = None):
        self.quantum = quantum
        self._resources_of = resources_of or (lambda item: item.resources)
        self._jobs: Dict[str, _JobState] = {}
        self._quotas: Dict[str, JobQuota] = {}
        self._rr: List[str] = []      # round-robin order of job keys
        self._rr_pos = 0
        self.throttled_total: Dict[str, int] = {}  # job -> skip events

    # -- quota table -------------------------------------------------------
    def set_quota(self, job: str, quota: JobQuota) -> None:
        self._quotas[job] = quota

    def remove_quota(self, job: str) -> None:
        self._quotas.pop(job, None)

    def quota_of(self, job: str) -> JobQuota:
        return self._quotas.get(job) or JobQuota()

    def quotas(self) -> Dict[str, JobQuota]:
        return dict(self._quotas)

    # -- queue state -------------------------------------------------------
    def _state(self, job: str) -> _JobState:
        st = self._jobs.get(job)
        if st is None:
            st = self._jobs[job] = _JobState()
            self._rr.append(job)
        return st

    def push(self, item: Any, job: str) -> None:
        """Enqueue; raises :class:`QuotaExceeded` for a reject-mode job
        already past its ceiling (queue-mode jobs always enqueue)."""
        quota = self.quota_of(job)
        if quota.mode == "reject":
            st = self._state(job)
            over = self._over_limit(st, quota,
                                    self._resources_of(item))
            if over is not None:
                self._note_throttle(job)
                raise QuotaExceeded(job, over)
        self._state(job).queue.append(item)

    def remove(self, item: Any) -> bool:
        for st in self._jobs.values():
            try:
                st.queue.remove(item)
                return True
            except ValueError:
                continue
        return False

    def pending(self) -> List[Any]:
        """Every queued item, in per-job round-robin order (for
        introspection / demand reporting)."""
        out: List[Any] = []
        for job in self._rr:
            out.extend(self._jobs[job].queue)
        return out

    def pending_count(self) -> int:
        return sum(len(st.queue) for st in self._jobs.values())

    def backlogged_jobs(self) -> List[str]:
        return [j for j in self._rr if self._jobs[j].queue]

    # -- usage ledger ------------------------------------------------------
    def usage_of(self, job: str) -> Dict[str, float]:
        st = self._jobs.get(job)
        return dict(st.usage) if st is not None else {}

    def release(self, job: str, resources: Dict[str, float]) -> None:
        st = self._jobs.get(job)
        if st is None:
            return
        for k, v in resources.items():
            left = st.usage.get(k, 0.0) - v
            if left > 1e-9:
                st.usage[k] = left
            else:
                st.usage.pop(k, None)
        self._gc(job)

    def reconcile(self, usage_by_job: Dict[str, Dict[str, float]]) -> None:
        """Reset the in-flight ledger from ground truth (the raylet's
        live lease table).  Converges dropped/duplicated accounting
        updates — the ledger is advisory, the lease table is real."""
        for job, st in self._jobs.items():
            st.usage = dict(usage_by_job.get(job, {}))
        for job, usage in usage_by_job.items():
            if usage and job not in self._jobs:
                self._state(job).usage = dict(usage)
        for job in list(self._jobs):
            self._gc(job)

    def export_usage(self) -> Dict[str, Dict[str, float]]:
        return {job: dict(st.usage) for job, st in self._jobs.items()
                if st.usage}

    # -- scheduling --------------------------------------------------------
    def _over_limit(self, st: _JobState, quota: JobQuota,
                    resources: Dict[str, float]) -> Optional[str]:
        for k, cap in quota.limits.items():
            if st.usage.get(k, 0.0) + resources.get(k, 0.0) > cap + 1e-9:
                return k
        return None

    def _note_throttle(self, job: str) -> None:
        self.throttled_total[job] = self.throttled_total.get(job, 0) + 1

    def grant_order(self, fits: Callable[[Any], bool],
                    budget: Optional[int] = None) -> List[Tuple[str, Any]]:
        """One scheduling pass: the ``(job, item)`` grants this round,
        in deficit-round-robin order.  ``fits`` is the caller's
        resource/worker feasibility check; items granted here are
        REMOVED from their queues and charged to the usage ledger —
        the caller must :meth:`requeue` any it fails to place after
        all (worker spawn raced away etc.).

        The loop terminates: each outer round either grants at least
        one item (bounded by queue sizes + budget) or refills deficits
        for blocked jobs at most once before exiting.
        """
        grants: List[Tuple[str, Any]] = []
        refilled = False
        while budget is None or len(grants) < budget:
            progressed = False
            jobs = [j for j in self._rr if self._jobs[j].queue]
            if not jobs:
                break
            if self._rr_pos >= len(self._rr):
                self._rr_pos = 0
            # rotate the scan start so equal-weight jobs alternate
            order = self._rr[self._rr_pos:] + self._rr[:self._rr_pos]
            for job in order:
                st = self._jobs[job]
                if not st.queue:
                    continue
                quota = self.quota_of(job)
                if quota.weight <= 0.0:
                    continue  # parked tenant: never granted
                item = st.queue[0]
                resources = self._resources_of(item)
                over = self._over_limit(st, quota, resources)
                if over is not None:
                    self._note_throttle(job)
                    continue  # quota ceiling: stays queued
                cost = _cost(resources)
                if st.deficit < cost:
                    continue  # not this round; refill below
                if not fits(item):
                    continue  # node can't place it right now
                st.queue.pop(0)
                st.deficit -= cost
                for k, v in resources.items():
                    st.usage[k] = st.usage.get(k, 0.0) + v
                grants.append((job, item))
                progressed = True
                self._rr_pos = (self._rr.index(job) + 1) % len(self._rr)
                if budget is not None and len(grants) >= budget:
                    break
            if progressed:
                refilled = False
                continue
            if refilled:
                break  # a full refilled round granted nothing: done
            # refill: every backlogged job earns quantum * weight
            for job in jobs:
                q = self.quota_of(job)
                if q.weight > 0.0:
                    st = self._jobs[job]
                    st.deficit = min(st.deficit + self.quantum * q.weight,
                                     self._deficit_cap(job))
            refilled = True
        return grants

    def _deficit_cap(self, job: str) -> float:
        """Bound accrued credit: an idle-then-bursty job may carry at
        most one max-cost lease worth of savings plus one refill, so a
        long-idle tenant cannot monopolize the node when it wakes."""
        st = self._jobs[job]
        head_cost = _cost(self._resources_of(st.queue[0])) \
            if st.queue else 1.0
        return head_cost + self.quantum * self.quota_of(job).weight

    def requeue(self, job: str, item: Any) -> None:
        """Return an ungranted item to the head of its job queue and
        refund its usage charge (the caller could not actually place
        it)."""
        st = self._state(job)
        st.queue.insert(0, item)
        resources = self._resources_of(item)
        for k, v in resources.items():
            left = st.usage.get(k, 0.0) - v
            if left > 1e-9:
                st.usage[k] = left
            else:
                st.usage.pop(k, None)
        st.deficit += _cost(resources)

    def _gc(self, job: str) -> None:
        st = self._jobs.get(job)
        if st is not None and not st.queue and not st.usage \
                and job not in self._quotas:
            del self._jobs[job]
            idx = self._rr.index(job)
            self._rr.remove(job)
            if idx < self._rr_pos:
                self._rr_pos -= 1
            if self._rr_pos >= len(self._rr):
                self._rr_pos = 0

    # -- introspection -----------------------------------------------------
    def snapshot(self) -> Dict[str, Any]:
        return {
            "jobs": {
                job: {
                    "queued": len(st.queue),
                    "deficit": round(st.deficit, 6),
                    "usage": dict(st.usage),
                    "quota": self.quota_of(job).to_dict(),
                    "throttled": self.throttled_total.get(job, 0),
                }
                for job, st in self._jobs.items()
            },
            "throttled_total": dict(self.throttled_total),
        }
