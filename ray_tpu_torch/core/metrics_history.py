"""Metrics history + SLO alerting: the cluster health plane's engine.

The GCS metrics table (``gcs.py::_ingest_metrics``) is point-in-time:
one merged value per ``(name, tags)`` series.  This module gives it a
past and a judgement:

* **History rings** — every sample tick (``metrics_history_interval_s``)
  the engine folds the merged table into per-series ring buffers
  bounded to ``metrics_history_window_s / metrics_history_interval_s``
  points.  Counters are stored as **per-tick deltas** (reset-safe), so
  rates fall out of a window sum; gauges store raw values; histograms
  store per-tick ``(count, sum, buckets)`` deltas so windowed quantiles
  fall out of a bucket merge.  Eviction is accounted
  (``ray_tpu_metrics_history_evicted_total``) exactly like the trace /
  profile rings — memory is provably ``series x window/interval``
  points, never more.

* **Recording rules** — named derived signals re-evaluated each tick
  from the rings (rate-over-window, histogram-quantile, sum/max of
  gauges) and appended to their own rings, so consumers (``ray-tpu
  top`` sparklines, ``/api/timeseries``, the node
  autoscaler) subscribe to *signals*, not raw series.  The built-in
  set covers exactly the autoscaler's inputs: pending-lease backlog,
  arena occupancy, serve request rate / p99 / shed rate, heartbeat
  miss rate, GCS persist failures.

* **Alert rules** — threshold and SLO burn-rate rules with
  ``for:``-duration hysteresis on both edges: a condition must hold
  ``for_s`` before ``pending -> firing``, and clear continuously for
  ``resolve_for_s`` before ``firing -> resolved`` (flaps die in
  ``pending``).  Transitions are returned to the caller (the GCS
  publishes them on the ``alerts`` pubsub channel and persists the
  firing set), and a firing alert restored after a GCS restart re-fires
  or resolves through the same machinery — never silently vanishes.

Static analysis: ``rtpu-check``'s ``metric-drift`` rule reads the
``RecordingRule(source=...)`` / ``AlertRule(signal=..., source=...)``
constructor calls below and requires every referenced ``ray_tpu_*``
series to exist in ``scripts/metrics_golden.txt`` (and every derived
signal to be defined by a RecordingRule), so a renamed producer cannot
leave a rule silently evaluating a series that no longer exists.

No asyncio in here: the engine is a pure state machine driven by the
GCS's ``_history_loop`` with explicit ``now`` timestamps, which is what
makes the hysteresis matrix unit-testable with a fake clock.
"""

from __future__ import annotations

import bisect
import logging
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

logger = logging.getLogger(__name__)

__all__ = ["RecordingRule", "AlertRule", "MetricsHistory",
           "default_recording_rules", "default_alert_rules"]


# ---------------------------------------------------------------------------
# rule definitions (declarative: the metric-drift rule reads these)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RecordingRule:
    """One derived signal: ``name`` is re-computed each tick from the
    ``source`` series' rings and appended to its own ring."""

    name: str            # derived series, e.g. "serve:p99_latency_s"
    source: str          # ray_tpu_* series the rule reads
    fn: str              # rate | quantile | sum | max | avg | burn
    window_s: float = 60.0
    q: float = 0.99
    #: tag keys preserved in the derived series (one derived ring per
    #: distinct projection, e.g. per deployment); () = one global ring
    group_by: Tuple[str, ...] = ()


@dataclass(frozen=True)
class AlertRule:
    """Threshold or SLO burn-rate rule with two-sided hysteresis."""

    name: str
    #: derived-signal (RecordingRule) or raw gauge series to compare;
    #: unused by kind="slo_burn" rules (they read ``source`` directly)
    signal: str = ""
    op: str = ">"
    threshold: float = 0.0
    #: the condition must hold this long before pending -> firing
    for_s: float = 10.0
    #: ... and clear continuously this long before firing -> resolved
    resolve_for_s: float = 10.0
    severity: str = "warning"  # warning | critical
    description: str = ""
    kind: str = "threshold"    # threshold | slo_burn
    #: slo_burn: latency histogram whose over-SLO mass is the burn input
    source: str = ""
    window_s: float = 60.0
    group_by: Tuple[str, ...] = ()


def default_recording_rules(interval_s: float) -> List[RecordingRule]:
    """The built-in signal set.  Window spans at least a few sample
    ticks so one missed flush doesn't zero a rate."""
    w = max(60.0, 4 * interval_s)
    return [
        # -- the item-5 node autoscaler's subscription points ----------
        RecordingRule(name="cluster:pending_leases",
                      source="ray_tpu_sched_pending_leases", fn="sum"),
        RecordingRule(name="cluster:arena_occupancy",
                      source="ray_tpu_arena_occupancy_fraction",
                      fn="max"),
        # -- serve SLO plane -------------------------------------------
        RecordingRule(name="serve:request_rate",
                      source="ray_tpu_serve_request_latency_s",
                      fn="rate", window_s=w, group_by=("deployment",)),
        RecordingRule(name="serve:p99_latency_s",
                      source="ray_tpu_serve_request_latency_s",
                      fn="quantile", q=0.99, window_s=w,
                      group_by=("deployment",)),
        RecordingRule(name="serve:shed_rate",
                      source="ray_tpu_serve_shed_total", fn="rate",
                      window_s=w, group_by=("deployment",)),
        RecordingRule(name="serve:queue_depth",
                      source="ray_tpu_serve_queue_depth", fn="sum",
                      group_by=("deployment",)),
        # burn rate as a first-class series: the EXACT input the
        # ServeSLOBurnRate alert compares against 1.0, exposed through
        # get_timeseries so the autoscaler can scale up at burn ~0.5 —
        # before the alert's threshold is ever reached
        RecordingRule(name="serve:slo_burn_rate",
                      source="ray_tpu_serve_request_latency_s",
                      fn="burn", window_s=w, group_by=("deployment",)),
        # -- control-plane health --------------------------------------
        RecordingRule(name="gcs:heartbeat_miss_rate",
                      source="ray_tpu_gcs_heartbeat_misses_total",
                      fn="rate", window_s=w),
        RecordingRule(name="gcs:persist_failure_rate",
                      source="ray_tpu_gcs_persist_failures_total",
                      fn="rate", window_s=w),
        # -- device plane ----------------------------------------------
        # compile rate as a series: the RecompileStorm alert's input
        # (threshold alerts read gauges/derived series, not counters) —
        # steady state is 0; warmup shows one burst then decays
        RecordingRule(name="device:compile_rate",
                      source="ray_tpu_xla_compiles_total",
                      fn="rate", window_s=w),
        RecordingRule(name="train:mfu",
                      source="ray_tpu_train_mfu", fn="max"),
        RecordingRule(name="train:step_data_wait_frac",
                      source="ray_tpu_train_step_data_wait_frac",
                      fn="max"),
        RecordingRule(name="serve:decode_device_frac",
                      source="ray_tpu_serve_decode_device_frac",
                      fn="max", group_by=("deployment",)),
    ]


def default_alert_rules(interval_s: float) -> List[AlertRule]:
    """Built-in alert set.  The serve burn rule's ``for_s`` spans two
    evaluation intervals, so a sustained SLO barrage fires within
    three ticks (the e2e gate) while a single slow flush cannot."""
    return [
        AlertRule(name="ServeSLOBurnRate", kind="slo_burn",
                  source="ray_tpu_serve_request_latency_s",
                  threshold=1.0, for_s=2 * interval_s,
                  resolve_for_s=2 * interval_s, severity="critical",
                  window_s=max(5.0, 10 * interval_s),
                  group_by=("deployment",),
                  description="fraction of serve requests over "
                              "serve_slo_latency_s is burning the "
                              "error budget (burn rate > 1 sustains "
                              "an SLO violation)"),
        AlertRule(name="ServeShedRate", signal="serve:shed_rate",
                  op=">", threshold=0.5, for_s=15.0,
                  resolve_for_s=30.0, severity="warning",
                  group_by=("deployment",),
                  description="requests are being shed (429) at a "
                              "sustained rate: the deployment is "
                              "under-provisioned for its load"),
        AlertRule(name="HeartbeatMissRate",
                  signal="gcs:heartbeat_miss_rate", op=">",
                  threshold=0.2, for_s=15.0, resolve_for_s=30.0,
                  severity="warning",
                  description="raylet health reports are failing: "
                              "nodes are at risk of being declared "
                              "dead"),
        AlertRule(name="ArenaPressure",
                  signal="cluster:arena_occupancy", op=">",
                  threshold=0.9, for_s=15.0, resolve_for_s=30.0,
                  severity="warning",
                  description="an object-store arena is nearly full; "
                              "creates will soon spill reactively or "
                              "fail"),
        AlertRule(name="GcsPersistFailures",
                  signal="gcs:persist_failure_rate", op=">",
                  threshold=0.0, for_s=0.0, resolve_for_s=60.0,
                  severity="critical",
                  description="GCS table snapshot writes are failing: "
                              "durability is degraded to the WAL (or "
                              "nothing)"),
        # -- device plane ----------------------------------------------
        # steady-state steps must not compile: a sustained compile rate
        # means shapes keep missing the padding buckets (a shape leak),
        # collapsing device throughput while host metrics look healthy.
        # for_s spans two ticks (the ServeSLOBurnRate fires-within-
        # three-ticks discipline); resolves once shapes stabilize.
        AlertRule(name="RecompileStorm",
                  signal="device:compile_rate", op=">",
                  threshold=0.5, for_s=2 * interval_s,
                  resolve_for_s=2 * interval_s, severity="warning",
                  description="XLA keeps compiling during steady-state "
                              "stepping: input shapes are leaking past "
                              "the padding buckets and every retrace "
                              "stalls the device"),
        # persistent rank skew gates every gang step on the slowest
        # member; group_by includes the straggler tag so the alert
        # NAMES the slow rank
        AlertRule(name="GangStraggler",
                  signal="ray_tpu_gang_rank_skew_seconds", op=">",
                  threshold=0.05, for_s=2 * interval_s,
                  resolve_for_s=2 * interval_s, severity="warning",
                  group_by=("deployment", "straggler"),
                  description="one rank of a sharded gang is "
                              "persistently slower than its peers; "
                              "every decode step waits for it (the "
                              "straggler tag names the rank)"),
    ]


# ---------------------------------------------------------------------------
# series rings
# ---------------------------------------------------------------------------

class _Ring:
    """One series' bounded history.  ``kind`` decides the point shape:
    counter points are per-tick deltas, gauge/derived points raw
    values, histogram points ``(count_d, sum_d, buckets_d)`` tuples."""

    __slots__ = ("kind", "points", "last_raw", "last_sum", "last_count",
                 "last_buckets", "boundaries", "last_ts")

    def __init__(self, kind: str):
        self.kind = kind
        self.points: deque = deque()  # (ts, value)
        self.last_raw = 0.0     # counters: last cumulative seen
        self.last_sum = 0.0     # histograms: last cumulative sum/count
        self.last_count = 0
        self.last_buckets: Optional[List[float]] = None
        self.boundaries: Optional[List[float]] = None
        self.last_ts = 0.0


class _AlertState:
    __slots__ = ("state", "since", "pending_since", "clear_since",
                 "value", "restored", "severity")

    def __init__(self):
        self.state = "inactive"  # inactive | pending | firing
        self.since = 0.0         # when the current state was entered
        self.pending_since = 0.0
        self.clear_since: Optional[float] = None
        self.value: Optional[float] = None
        self.restored = False    # firing state carried over a restart
        self.severity = "warning"


def _cmp(value: float, op: str, threshold: float) -> bool:
    return value > threshold if op == ">" else value < threshold


class MetricsHistory:
    """Bounded time-series rings + recording rules + alert evaluator.

    Driven by the GCS: ``sample(table, now)`` each tick, then
    ``evaluate(now)``; both take explicit timestamps so tests drive a
    fake clock.  Memory bound: ``capacity`` points per series ring,
    rings for series that stopped appearing are swept after two
    windows, and every overwritten point increments ``evicted_total``.
    """

    def __init__(self, interval_s: float, window_s: float, *,
                 slo_latency_s: float = 0.0,
                 slo_error_budget: float = 0.01,
                 recording_rules: Optional[List[RecordingRule]] = None,
                 alert_rules: Optional[List[AlertRule]] = None,
                 restored_firing: Optional[List[Dict[str, Any]]] = None):
        self.interval_s = max(0.05, float(interval_s))
        self.window_s = max(self.interval_s * 2, float(window_s))
        self.capacity = max(2, int(round(self.window_s / self.interval_s)))
        self.slo_latency_s = float(slo_latency_s)
        self.slo_error_budget = max(1e-6, float(slo_error_budget))
        self.recording_rules = (default_recording_rules(self.interval_s)
                                if recording_rules is None
                                else list(recording_rules))
        rules = (default_alert_rules(self.interval_s)
                 if alert_rules is None else list(alert_rules))
        self.alert_rules: Dict[str, AlertRule] = {r.name: r for r in rules}
        self._rings: Dict[Tuple[str, Tuple], _Ring] = {}
        self._alerts: Dict[Tuple[str, Tuple], _AlertState] = {}
        #: recently-resolved alerts, newest last (bounded)
        self.resolved: deque = deque(maxlen=64)
        self.evicted_total = 0
        self.samples_total = 0
        self.sample_failures = 0
        # firing state persisted by the previous GCS incarnation: seed
        # the machine as FIRING so the alert is visible immediately and
        # either re-confirms from fresh samples or resolves through the
        # normal hysteresis — a restart can never silently lose it
        for rec in restored_firing or []:
            rule = self.alert_rules.get(rec.get("rule", ""))
            if rule is None:
                continue
            key = (rule.name,
                   tuple(sorted((rec.get("tags") or {}).items())))
            st = self._alerts[key] = _AlertState()
            st.state = "firing"
            st.since = float(rec.get("since", 0.0))
            st.value = rec.get("value")
            st.restored = True
            st.severity = rule.severity

    # -- sampling ------------------------------------------------------
    def _append(self, ring: _Ring, ts: float, value: Any) -> None:
        if len(ring.points) >= self.capacity:
            ring.points.popleft()
            self.evicted_total += 1
        ring.points.append((ts, value))
        ring.last_ts = ts

    def sample(self, table: Dict[Any, Dict[str, Any]], now: float) -> None:
        """Fold one snapshot of the GCS merged-metrics table into the
        rings.  ``table`` is read-only here (the read handler is
        side-effect free too; pruning lives in the GCS sweep)."""
        self.samples_total += 1
        for key, rec in table.items():
            name, tags = key[0], key[1]
            rkey = (name, tags)
            kind = rec.get("type")
            ring = self._rings.get(rkey)
            if ring is None:
                ring = self._rings[rkey] = _Ring(kind)
            if kind == "counter":
                value = float(rec.get("value", 0.0))
                delta = value - ring.last_raw
                if delta < 0:  # producer restarted: the value IS the delta
                    delta = value
                ring.last_raw = value
                self._append(ring, now, delta)
            elif kind == "gauge":
                self._append(ring, now, float(rec.get("value", 0.0)))
            elif kind == "histogram":
                buckets = list(rec.get("buckets") or [])
                count = int(rec.get("count", 0))
                total = float(rec.get("sum", 0.0))
                last_b = ring.last_buckets
                if last_b is None or len(last_b) != len(buckets) \
                        or count < ring.last_count:
                    bucket_d = list(buckets)
                    count_d, sum_d = count, total
                else:
                    bucket_d = [b - a for a, b in zip(last_b, buckets)]
                    count_d = count - ring.last_count
                    sum_d = total - ring.last_sum
                ring.last_buckets = buckets
                ring.last_count = count
                ring.last_sum = total
                ring.boundaries = list(rec.get("boundaries") or [])
                self._append(ring, now, (count_d, sum_d, bucket_d))
            else:
                continue
        # sweep rings whose series left the table (pruned gauges, dead
        # processes): after two windows without a sample they free
        for rkey, ring in list(self._rings.items()):
            if now - ring.last_ts > 2 * self.window_s:
                del self._rings[rkey]
        self._run_recording_rules(now)

    def observe(self, name: str, value: float, now: float,
                tags: Optional[Dict[str, str]] = None) -> None:
        """Direct gauge-style observation (the GCS pushes a few
        tick-local series — alive nodes, actors — that must not depend
        on any flush loop)."""
        rkey = (name, tuple(sorted((tags or {}).items())))
        ring = self._rings.get(rkey)
        if ring is None:
            ring = self._rings[rkey] = _Ring("gauge")
        self._append(ring, now, float(value))

    # -- windowed math -------------------------------------------------
    def _series(self, name: str) -> List[Tuple[Tuple, _Ring]]:
        return [(key[1], ring) for key, ring in self._rings.items()
                if key[0] == name]

    @staticmethod
    def _window_points(ring: _Ring, since: float):
        # half-open window (since, now]: a delta stamped exactly at the
        # window's left edge belongs to the PREVIOUS window.  Rings are
        # append-ordered; iterate from the right.
        out = []
        for ts, v in reversed(ring.points):
            if ts <= since:
                break
            out.append((ts, v))
        out.reverse()
        return out

    def rate(self, name: str, now: float, window_s: float,
             group: Optional[Dict[str, str]] = None) -> Optional[float]:
        """Sum of counter deltas over the window / window seconds,
        across every tagset of ``name`` whose tags contain ``group``
        (histogram points contribute their count delta)."""
        since = now - window_s
        total = 0.0
        seen = False
        for tags, ring in self._series(name):
            if ring.kind not in ("counter", "histogram"):
                continue
            if group and not (set(group.items()) <= set(tags)):
                continue
            for _ts, v in self._window_points(ring, since):
                total += v[0] if ring.kind == "histogram" else v
                seen = True
        if not seen:
            return None
        return total / window_s

    def _merged_hist_window(self, name: str, now: float, window_s: float,
                            group: Optional[Dict[str, str]] = None
                            ) -> Tuple[List[float], List[float], float]:
        """(boundaries, merged bucket deltas incl. +Inf, total count)
        of ``name`` over the window, restricted to rings whose tags
        contain ``group``."""
        since = now - window_s
        bounds: List[float] = []
        merged: List[float] = []
        total = 0.0
        for tags, ring in self._series(name):
            if ring.kind != "histogram" or not ring.boundaries:
                continue
            if group and not (set(group.items()) <= set(tags)):
                continue
            if not bounds:
                bounds = ring.boundaries
                merged = [0.0] * (len(bounds) + 1)
            if ring.boundaries != bounds:
                continue  # incompatible layout (renamed bounds): skip
            for _ts, (count_d, _sum_d, bucket_d) in \
                    self._window_points(ring, since):
                total += count_d
                for i, b in enumerate(bucket_d):
                    if i < len(merged):
                        merged[i] += b
        return bounds, merged, total

    def quantile(self, name: str, q: float, now: float, window_s: float,
                 group: Optional[Dict[str, str]] = None
                 ) -> Optional[float]:
        """Windowed histogram quantile (prometheus-style: linear
        interpolation inside the target bucket, upper bound for the
        overflow bucket)."""
        bounds, merged, total = self._merged_hist_window(
            name, now, window_s, group)
        if not bounds or total <= 0:
            return None
        target = q * total
        cum = 0.0
        for i, b in enumerate(merged):
            prev_cum = cum
            cum += b
            if cum >= target:
                if i >= len(bounds):  # overflow bucket: clamp
                    return bounds[-1]
                lo = bounds[i - 1] if i > 0 else 0.0
                hi = bounds[i]
                frac = (target - prev_cum) / b if b > 0 else 1.0
                return lo + (hi - lo) * frac
        return bounds[-1]

    def fraction_over(self, name: str, threshold: float, now: float,
                      window_s: float,
                      group: Optional[Dict[str, str]] = None
                      ) -> Optional[float]:
        """Fraction of windowed observations above ``threshold``
        (conservative: mass in buckets whose upper bound exceeds it)."""
        bounds, merged, total = self._merged_hist_window(
            name, now, window_s, group)
        if not bounds or total <= 0:
            return None
        idx = bisect.bisect_left(bounds, threshold)
        if idx >= len(bounds):
            over = merged[-1]  # only the overflow bucket can exceed
        else:
            over = sum(merged[idx + 1:])
            if bounds[idx] > threshold:
                # the threshold falls INSIDE this bucket: count its
                # whole mass as over (conservative — an SLO between
                # bounds can only over-report, never hide a burn)
                over += merged[idx]
        return over / total

    def latest(self, name: str, fn: str = "sum",
               group: Optional[Dict[str, str]] = None,
               now: Optional[float] = None) -> Optional[float]:
        """Latest-point aggregate of a gauge/derived series across
        matching tagsets (sum | max | avg).  With ``now``, rings that
        stopped updating (their series left the merged table — dead
        node, pruned stale gauge) drop out after ~3 missed ticks
        instead of contributing a ghost value for up to two windows
        (a dead node must not hold cluster:arena_occupancy high)."""
        stale_before = None if now is None else now - 3 * self.interval_s
        vals = []
        for tags, ring in self._series(name):
            if ring.kind not in ("gauge", "derived") or not ring.points:
                continue
            if stale_before is not None and ring.last_ts < stale_before:
                continue
            if group and not (set(group.items()) <= set(tags)):
                continue
            vals.append(ring.points[-1][1])
        if not vals:
            return None
        if fn == "max":
            return max(vals)
        if fn == "avg":
            return sum(vals) / len(vals)
        return sum(vals)

    # -- recording rules -----------------------------------------------
    def _groups_of(self, source: str, group_by: Tuple[str, ...]
                   ) -> List[Dict[str, str]]:
        if not group_by:
            return [{}]
        groups = []
        for tags, _ring in self._series(source):
            d = dict(tags)
            proj = {k: d[k] for k in group_by if k in d}
            if proj and proj not in groups:
                groups.append(proj)
        return groups

    def _run_recording_rules(self, now: float) -> None:
        for rule in self.recording_rules:
            for group in self._groups_of(rule.source, rule.group_by):
                value: Optional[float]
                if rule.fn == "rate":
                    value = self.rate(rule.source, now, rule.window_s,
                                      group or None)
                elif rule.fn == "quantile":
                    value = self.quantile(rule.source, rule.q, now,
                                          rule.window_s, group or None)
                elif rule.fn == "burn":
                    if self.slo_latency_s <= 0:
                        continue
                    miss = self.fraction_over(
                        rule.source, self.slo_latency_s, now,
                        rule.window_s, group or None)
                    value = (None if miss is None
                             else miss / self.slo_error_budget)
                else:
                    value = self.latest(rule.source, rule.fn,
                                        group or None, now=now)
                if value is None:
                    continue
                rkey = (rule.name, tuple(sorted(group.items())))
                ring = self._rings.get(rkey)
                if ring is None:
                    ring = self._rings[rkey] = _Ring("derived")
                self._append(ring, now, float(value))

    # -- alert evaluation ----------------------------------------------
    def _signal_value(self, rule: AlertRule, group: Dict[str, str],
                      now: float) -> Optional[float]:
        if rule.kind == "slo_burn":
            if self.slo_latency_s <= 0:
                return None
            miss = self.fraction_over(rule.source, self.slo_latency_s,
                                      now, rule.window_s, group or None)
            if miss is None:
                return None
            return miss / self.slo_error_budget
        return self.latest(rule.signal, "max", group or None, now=now)

    def evaluate(self, now: float) -> List[Dict[str, Any]]:
        """One evaluation tick over every rule x live tag group.
        Returns the state TRANSITIONS (pending->firing,
        firing->resolved, restored->firing/resolved) for the caller to
        publish; steady states return nothing."""
        transitions: List[Dict[str, Any]] = []
        for rule in self.alert_rules.values():
            source = rule.source if rule.kind == "slo_burn" \
                else rule.signal
            groups = self._groups_of(source, rule.group_by)
            # pending/firing (incl. restored) alerts may name groups
            # whose series vanished: keep evaluating them (condition
            # reads as no-data -> they resolve through hysteresis).
            # Inactive states are pruned below, so this cannot grow.
            for key, st in self._alerts.items():
                if key[0] == rule.name and st.state != "inactive":
                    g = dict(key[1])
                    if g not in groups:
                        groups.append(g)
            for group in groups:
                key = (rule.name, tuple(sorted(group.items())))
                st = self._alerts.get(key)
                if st is None:
                    st = self._alerts[key] = _AlertState()
                st.severity = rule.severity
                value = self._signal_value(rule, group, now)
                cond = value is not None and _cmp(value, rule.op,
                                                 rule.threshold)
                if value is not None:
                    st.value = value
                if st.state == "inactive":
                    if cond:
                        st.pending_since = now
                        if rule.for_s <= 0:
                            self._fire(rule, key, st, now, transitions)
                        else:
                            st.state = "pending"
                            st.since = now
                elif st.state == "pending":
                    if not cond:
                        st.state = "inactive"
                        st.since = now
                    elif now - st.pending_since >= rule.for_s:
                        self._fire(rule, key, st, now, transitions)
                elif st.state == "firing":
                    if cond:
                        if st.restored:
                            # restart survival: the condition still
                            # holds — announce the re-fire so no
                            # subscriber misses it
                            st.restored = False
                            transitions.append(self._event(
                                rule, key, st, "restored", "firing",
                                now))
                        st.clear_since = None
                    else:
                        if st.clear_since is None:
                            st.clear_since = now
                        if now - st.clear_since >= rule.resolve_for_s:
                            st.restored = False
                            st.state = "inactive"
                            resolved_at = now
                            self.resolved.append({
                                "rule": rule.name, "tags": dict(group),
                                "severity": rule.severity,
                                "value": st.value,
                                "since": st.since,
                                "resolved_at": resolved_at})
                            transitions.append(self._event(
                                rule, key, st, "firing", "resolved",
                                now))
                            st.since = now
                            st.clear_since = None
        # inactive states carry no memory (pending/firing are the only
        # states with history): drop them so deployment/group churn
        # cannot grow the table — alert-state memory stays bounded by
        # what is actually pending or firing
        for key in [k for k, st in self._alerts.items()
                    if st.state == "inactive"]:
            del self._alerts[key]
        return transitions

    def _fire(self, rule: AlertRule, key, st: _AlertState, now: float,
              transitions: List[Dict[str, Any]]) -> None:
        prev = st.state
        st.state = "firing"
        st.since = now
        st.clear_since = None
        transitions.append(self._event(rule, key, st, prev, "firing",
                                       now))

    def _event(self, rule: AlertRule, key, st: _AlertState,
               prev: str, new: str, now: float) -> Dict[str, Any]:
        return {"rule": rule.name, "tags": dict(key[1]),
                "from": prev, "to": new, "value": st.value,
                "severity": rule.severity, "ts": now,
                "description": rule.description}

    # -- views ----------------------------------------------------------
    def firing(self) -> List[Dict[str, Any]]:
        out = []
        for (name, tags), st in self._alerts.items():
            if st.state != "firing":
                continue
            rule = self.alert_rules.get(name)
            out.append({"rule": name, "tags": dict(tags),
                        "severity": st.severity, "value": st.value,
                        "since": st.since, "restored": st.restored,
                        "description": rule.description if rule else ""})
        out.sort(key=lambda a: a["since"])
        return out

    def export_firing(self) -> List[Dict[str, Any]]:
        """JSON-serializable firing set for restart persistence."""
        return [{"rule": a["rule"], "tags": a["tags"],
                 "severity": a["severity"], "value": a["value"],
                 "since": a["since"]} for a in self.firing()]

    def alerts_view(self) -> Dict[str, Any]:
        return {
            "firing": self.firing(),
            "resolved": list(self.resolved),
            "rules": [{"name": r.name, "kind": r.kind,
                       "signal": r.signal or r.source, "op": r.op,
                       "threshold": r.threshold, "for_s": r.for_s,
                       "resolve_for_s": r.resolve_for_s,
                       "severity": r.severity,
                       "description": r.description}
                      for r in self.alert_rules.values()],
        }

    def query(self, series: Optional[str] = None,
              since: Optional[float] = None,
              limit: int = 200) -> List[Dict[str, Any]]:
        """Ring contents for ``/api/timeseries`` / ``ray-tpu top``.
        ``series``: exact name, or a prefix ending in ``*``.  Histogram
        rings serve their per-tick count deltas (quantiles are served
        via the derived recording-rule series)."""
        prefix = None
        if series and series.endswith("*"):
            prefix = series[:-1]
        out = []
        for (name, tags), ring in self._rings.items():
            if series is not None:
                if prefix is not None:
                    if not name.startswith(prefix):
                        continue
                elif name != series:
                    continue
            pts = []
            for ts, v in ring.points:
                if since is not None and ts < since:
                    continue
                pts.append([ts, v[0] if ring.kind == "histogram" else v])
            out.append({"name": name, "tags": dict(tags),
                        "kind": ring.kind, "points": pts})
        # sort BEFORE applying the limit: under limit pressure the
        # caller gets a deterministic prefix, not whichever series
        # happened to sit first in ring-insertion order
        out.sort(key=lambda r: (r["name"], sorted(r["tags"].items())))
        return out[:limit]

    def stats(self) -> Dict[str, Any]:
        return {
            "series": len(self._rings),
            "points": sum(len(r.points) for r in self._rings.values()),
            "capacity_per_series": self.capacity,
            "evicted_total": self.evicted_total,
            "samples_total": self.samples_total,
            "sample_failures": self.sample_failures,
            "alerts_firing": sum(1 for s in self._alerts.values()
                                 if s.state == "firing"),
            "alerts_resolved_recent": len(self.resolved),
        }
