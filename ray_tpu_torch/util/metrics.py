"""User-defined metrics: Counter / Gauge / Histogram.

Parity: reference ``python/ray/util/metrics.py`` — the same three
classes and tag semantics, flowing through the same pipeline the C++
runtime metrics use (``src/ray/stats/`` → node agent →
Prometheus): here each process's registry flushes deltas to the GCS
metrics table, and the dashboard exports Prometheus text from it.

Registry lifetime: the process registry holds *weak* references, so a
metric owned by a short-lived actor disappears from the flush payload
when the actor drops it (previously the module-global list pinned every
metric ever created and the flush payload grew forever).  Pending
deltas are NOT lost on teardown: a finalizer drains them into a
process-level orphan buffer that the next ``flush_all`` ships, so
``Counter("x").inc()`` followed by an immediate GC still reaches the
GCS.  ``close()`` does the same deterministically.

Cardinality: each metric caps its live tagsets per process
(``metrics_max_tagsets`` in ``core/config.py``).  Observations against
tagsets beyond the cap are dropped with one warning per metric — an
unbounded tag (request id, object id) would otherwise grow every flush
payload and the GCS table without bound.
"""

from __future__ import annotations

import logging
import threading
import time
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

logger = logging.getLogger(__name__)

_registry_lock = threading.Lock()
_registry: List["weakref.ref[Metric]"] = []
#: records drained from dying metrics (finalizer / close), shipped by
#: the next flush_all
_orphans: List[Dict[str, Any]] = []


def _adopt_orphans(drain) -> None:
    """weakref.finalize callback: capture a dead metric's pending
    records.  ``drain`` closes over the metric's state dicts only —
    never the metric itself."""
    try:
        records = drain()
    except Exception:  # noqa: BLE001 — interpreter teardown
        return
    if records:
        with _registry_lock:
            _orphans.extend(records)


def _max_tagsets() -> int:
    try:
        from ray_tpu_torch.core.config import get_config
        return int(getattr(get_config(), "metrics_max_tagsets", 64))
    except Exception:  # noqa: BLE001 — config not importable (teardown)
        return 64


def _tags_key(tags: Optional[Dict[str, str]]) -> Tuple[Tuple[str, str], ...]:
    return tuple(sorted((tags or {}).items()))


class Metric:
    TYPE = "untyped"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        if not name:
            raise ValueError("metric name required")
        self.name = name
        self.description = description
        self.tag_keys = tuple(tag_keys or ())
        self._default_tags: Dict[str, str] = {}
        self._lock = threading.Lock()
        # per-tagset state; counters accumulate deltas since last flush
        self._values: Dict[Tuple, float] = {}
        self._cardinality_warned = False
        self._finalizer: Optional[weakref.finalize] = None
        with _registry_lock:
            _registry.append(weakref.ref(self))

    def _arm_finalizer(self) -> None:
        """Called at the end of each concrete __init__ (the state dicts
        must exist): on GC, pending records drain into the orphan
        buffer instead of vanishing."""
        drain = self._make_drain()
        if drain is not None:
            self._finalizer = weakref.finalize(self, _adopt_orphans, drain)

    def _make_drain(self):
        """Return a callable producing this metric's pending records
        from CAPTURED state only (must not reference ``self``)."""
        return None

    def set_default_tags(self, tags: Dict[str, str]) -> "Metric":
        self._default_tags = dict(tags)
        return self

    def close(self) -> None:
        """Deregister this metric from the process flush registry.

        Idempotent.  Pending records are drained into the orphan buffer
        (shipped by the next flush); observations made after close()
        never leave the process."""
        if self._finalizer is not None:
            self._finalizer()  # runs at most once, even if GC races
        with _registry_lock:
            _registry[:] = [r for r in _registry
                            if r() is not None and r() is not self]

    def _merged(self, tags: Optional[Dict[str, str]]) -> Dict[str, str]:
        out = dict(self._default_tags)
        out.update(tags or {})
        extra = set(out) - set(self.tag_keys)
        if extra:
            raise ValueError(f"unknown tag keys {sorted(extra)} for "
                             f"metric {self.name!r} (declared "
                             f"{self.tag_keys})")
        return out

    def _admit_key(self, key: Tuple, table: Dict) -> bool:
        """Cardinality gate (caller holds self._lock): a NEW tagset past
        the per-process cap is dropped with one warning per metric."""
        if key in table:
            return True
        if len(table) < _max_tagsets():
            return True
        if not self._cardinality_warned:
            self._cardinality_warned = True
            logger.warning(
                "metric %r exceeded %d tagsets in this process; further "
                "new tagsets are dropped (unbounded tag values — ids, "
                "addresses — do not belong in metric tags)",
                self.name, _max_tagsets())
        return False

    def _flush(self) -> List[Dict[str, Any]]:
        raise NotImplementedError


class Counter(Metric):
    TYPE = "counter"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        self._arm_finalizer()

    def _make_drain(self):
        name, typ, desc = self.name, self.TYPE, self.description
        values, lock = self._values, self._lock

        def drain():
            with lock:
                out = [{"name": name, "type": typ, "description": desc,
                        "tags": dict(k), "value": v}
                       for k, v in values.items() if v]
                values.clear()
            return out
        return drain

    def inc(self, value: float = 1.0,
            tags: Optional[Dict[str, str]] = None) -> None:
        if value < 0:
            raise ValueError("counters only increase")
        self.inc_key(_tags_key(self._merged(tags)), value)

    def inc_key(self, key: Tuple, value: float = 1.0) -> None:
        """Hot-path increment with a precomputed tags key (skips the
        merge/validate path — internal runtime instrumentation)."""
        with self._lock:
            if not self._admit_key(key, self._values):
                return
            self._values[key] = self._values.get(key, 0.0) + value

    def _flush(self):
        with self._lock:
            out = [{"name": self.name, "type": self.TYPE,
                    "description": self.description,
                    "tags": dict(k), "value": v}
                   for k, v in self._values.items() if v]
            self._values.clear()
        return out


class Gauge(Metric):
    TYPE = "gauge"

    def __init__(self, name: str, description: str = "",
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        self._arm_finalizer()

    def _make_drain(self):
        name, typ, desc = self.name, self.TYPE, self.description
        values, lock = self._values, self._lock

        def drain():
            with lock:
                out = [{"name": name, "type": typ, "description": desc,
                        "tags": dict(k), "value": v}
                       for k, v in values.items()]
                values.clear()
            return out
        return drain

    def set(self, value: float,
            tags: Optional[Dict[str, str]] = None) -> None:
        self.set_key(_tags_key(self._merged(tags)), value)

    def set_key(self, key: Tuple, value: float) -> None:
        with self._lock:
            if not self._admit_key(key, self._values):
                return
            self._values[key] = float(value)

    def _flush(self):
        with self._lock:
            return [{"name": self.name, "type": self.TYPE,
                     "description": self.description,
                     "tags": dict(k), "value": v}
                    for k, v in self._values.items()]


class Histogram(Metric):
    TYPE = "histogram"

    def __init__(self, name: str, description: str = "",
                 boundaries: Optional[Sequence[float]] = None,
                 tag_keys: Optional[Sequence[str]] = None):
        super().__init__(name, description, tag_keys)
        self.boundaries = sorted(boundaries or
                                 [0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                                  0.5, 1, 2.5, 5, 10])
        self._buckets: Dict[Tuple, List[int]] = {}
        self._sums: Dict[Tuple, float] = {}
        self._counts: Dict[Tuple, int] = {}
        # OpenMetrics exemplars: tagset -> {bucket_index: exemplar dict}
        # (last observation wins per bucket; shipped with each flush so
        # dashboards can jump from a hot p99 bucket to a trace_id)
        self._exemplars: Dict[Tuple, Dict[int, Dict[str, Any]]] = {}
        self._arm_finalizer()

    def _make_drain(self):
        name, typ, desc = self.name, self.TYPE, self.description
        boundaries = self.boundaries
        buckets, sums = self._buckets, self._sums
        counts, lock = self._counts, self._lock
        exemplars = self._exemplars

        def drain():
            with lock:
                return _histogram_records(name, typ, desc, boundaries,
                                          buckets, sums, counts,
                                          exemplars)
        return drain

    def observe(self, value: float,
                tags: Optional[Dict[str, str]] = None,
                exemplar: Optional[Dict[str, Any]] = None) -> None:
        self.observe_key(_tags_key(self._merged(tags)), value,
                         exemplar=exemplar)

    def observe_key(self, key: Tuple, value: float,
                    exemplar: Optional[Dict[str, Any]] = None) -> None:
        """Hot-path observe with a precomputed tags key.  ``exemplar``
        (e.g. ``{"trace_id": ...}``) attaches to the bucket the value
        lands in — OpenMetrics exemplar semantics, last-wins."""
        from bisect import bisect_left
        with self._lock:
            if not self._admit_key(key, self._buckets):
                return
            buckets = self._buckets.get(key)
            if buckets is None:
                buckets = self._buckets[key] = \
                    [0] * (len(self.boundaries) + 1)
            idx = bisect_left(self.boundaries, value)
            buckets[idx] += 1
            self._sums[key] = self._sums.get(key, 0.0) + value
            self._counts[key] = self._counts.get(key, 0) + 1
            if exemplar is not None:
                ex = dict(exemplar)
                ex.setdefault("value", value)
                ex.setdefault("ts", time.time())
                self._exemplars.setdefault(key, {})[idx] = ex

    def _flush(self):
        with self._lock:
            return _histogram_records(
                self.name, self.TYPE, self.description, self.boundaries,
                self._buckets, self._sums, self._counts, self._exemplars)


def _histogram_records(name, typ, desc, boundaries, buckets, sums,
                       counts, exemplars) -> List[Dict[str, Any]]:
    """Drain one histogram's per-tagset state into flush records
    (caller holds the metric's lock).  Shared by ``_flush`` and the
    finalizer drain so the two record shapes can never drift."""
    out = []
    for k, b in buckets.items():
        rec = {"name": name, "type": typ, "description": desc,
               "tags": dict(k), "buckets": list(b),
               "boundaries": boundaries,
               "sum": sums.get(k, 0.0),
               "count": counts.get(k, 0)}
        ex = exemplars.get(k)
        if ex:
            rec["exemplars"] = dict(ex)
        out.append(rec)
    buckets.clear()
    sums.clear()
    counts.clear()
    exemplars.clear()
    return out


def flush_all() -> List[Dict[str, Any]]:
    """Collect pending records from every live metric in this process,
    plus records drained from metrics that died since the last flush
    (dead weak references are pruned as a side effect)."""
    with _registry_lock:
        metrics = [m for m in (r() for r in _registry) if m is not None]
        if len(metrics) != len(_registry):
            _registry[:] = [r for r in _registry if r() is not None]
        out: List[Dict[str, Any]] = list(_orphans)
        _orphans.clear()
    for m in metrics:
        out.extend(m._flush())
    return out


def registry_size() -> int:
    with _registry_lock:
        return sum(1 for r in _registry if r() is not None)


_flusher_started = False


def start_flusher(period_s: float = 5.0) -> None:
    """Push this process's metrics to the GCS periodically.

    Thread-based legacy entry point; runtime processes (worker, raylet,
    GCS) run their own asyncio flush loops instead (see
    ``core/telemetry.py``), which also carry runtime spans and gauges."""
    global _flusher_started
    if _flusher_started:
        return
    _flusher_started = True

    def loop():
        from ray_tpu_torch.core import worker as worker_mod
        seq = 0
        while True:
            time.sleep(period_s)
            try:
                core = worker_mod.global_worker_or_none()
                if core is None:
                    continue
                records = flush_all()
                if records:
                    seq += 1
                    core.gcs_call("report_metrics", {
                        "records": records,
                        "source": f"flusher-{core.worker_id.hex()[:8]}",
                        "seq": seq})
            except Exception:
                pass

    threading.Thread(target=loop, name="metrics-flusher",
                     daemon=True).start()
