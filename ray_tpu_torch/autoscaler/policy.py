"""Signal-driven scaling policy: the autoscaler's judgement.

``StandardAutoscaler`` (autoscaler.py) is a *packer*: given demand it
launches nodes that fit, and terminates idle ones.  This module is the
layer above it — the decision of WHEN capacity should move, driven by
the same derived signals the alert plane evaluates
(``cluster:pending_leases``, ``cluster:arena_occupancy``,
``serve:slo_burn_rate``, ``serve:shed_rate`` via ``get_timeseries``),
with the same two-sided ``for:``-duration hysteresis the alert rules
use:

* **scale-up** — a pressure condition must hold ``up_for_s`` before a
  step is emitted... unless the serve SLO burn rate crosses
  ``urgent_burn_rate``, in which case the wait is SKIPPED and the step
  scales with the burn magnitude.  Every scale-up threshold sits
  *below* its alerting counterpart (arena 0.85 vs the ArenaPressure
  alert's 0.9; burn 0.5 vs ServeSLOBurnRate's 1.0), so a correct
  decision lands new capacity before the alert would fire.
* **scale-down** — every pressure signal must read quiet continuously
  for ``down_for_s`` before idle nodes may be released (flapping load
  keeps the fleet; a no-data tick never reads as quiet).

Like ``fair_queue`` and ``metrics_history`` this is a pure state
machine with explicit ``now`` timestamps — no clocks, no RPC — which is
what makes the hysteresis matrix unit-testable.  The monitor
(monitor.py) owns the I/O.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

__all__ = ["PolicyConfig", "Decision", "ScalingPolicy"]

#: signals aggregated across tagsets with max (worst instance rules);
#: everything else sums (rates and backlogs are additive)
_MAX_AGGREGATED = ("cluster:arena_occupancy", "serve:p99_latency_s",
                   "serve:slo_burn_rate")


@dataclass(frozen=True)
class PolicyConfig:
    """Thresholds + hysteresis windows.  Scale-up thresholds must stay
    below the alert thresholds (that ordering IS the feature)."""

    #: queued leases across the cluster that mean "work is waiting"
    pending_leases_threshold: float = 1.0
    #: arena occupancy pressure (ArenaPressure alerts at 0.9)
    arena_occupancy_threshold: float = 0.85
    #: any sustained shedding is a capacity failure
    shed_rate_threshold: float = 0.0
    #: SLO burn worth pre-scaling for (the alert fires at 1.0)
    burn_rate_threshold: float = 0.5
    #: burn at/above this skips the up-hysteresis entirely
    urgent_burn_rate: float = 1.0
    #: pressure must hold this long before a normal scale-up
    up_for_s: float = 5.0
    #: ... and quiet must hold this long before scale-down unlocks
    down_for_s: float = 30.0
    #: quiet readings (all must be below these for the down edge)
    quiet_arena_occupancy: float = 0.5
    quiet_burn_rate: float = 0.25
    #: max nodes added per decision (urgent burn scales the step)
    max_step: int = 4


@dataclass
class Decision:
    """One policy verdict.  ``action``: ``scale_up`` (add ``step``
    node-shaped bundles of demand), ``allow_down`` (idle release is
    unlocked), ``hold`` (neither edge has matured)."""

    action: str = "hold"
    step: int = 0
    urgent: bool = False
    reason: str = ""
    triggers: List[str] = field(default_factory=list)
    signals: Dict[str, float] = field(default_factory=dict)
    ts: float = 0.0

    def to_dict(self) -> Dict[str, Any]:
        return {"action": self.action, "step": self.step,
                "urgent": self.urgent, "reason": self.reason,
                "triggers": list(self.triggers),
                "signals": dict(self.signals), "ts": self.ts}


class _Edge:
    """One ``for:``-duration condition detector (the same shape as the
    alert evaluator's pending state): ``update`` returns True once the
    condition has held continuously for ``for_s``."""

    __slots__ = ("since",)

    def __init__(self):
        self.since: Optional[float] = None

    def update(self, cond: bool, now: float, for_s: float) -> bool:
        if not cond:
            self.since = None
            return False
        if self.since is None:
            self.since = now
        return now - self.since >= for_s


class ScalingPolicy:
    def __init__(self, config: Optional[PolicyConfig] = None):
        self.config = config or PolicyConfig()
        self._up_edges: Dict[str, _Edge] = {}
        self._down_edge = _Edge()
        self.last_decision: Optional[Decision] = None

    # -- signal extraction ---------------------------------------------
    @staticmethod
    def latest_signals(rows: List[Dict[str, Any]]) -> Dict[str, float]:
        """Flatten a ``get_timeseries`` reply into {signal: value} —
        the latest point of each series, max-aggregated for worst-case
        signals and summed for additive ones."""
        vals: Dict[str, List[float]] = {}
        for row in rows or []:
            pts = row.get("points") or []
            if not pts:
                continue
            try:
                v = float(pts[-1][1])
            except (TypeError, ValueError, IndexError):
                continue
            vals.setdefault(row["name"], []).append(v)
        return {name: (max(vs) if name in _MAX_AGGREGATED else sum(vs))
                for name, vs in vals.items()}

    # -- the decision tick ---------------------------------------------
    def _up_edge(self, name: str) -> _Edge:
        edge = self._up_edges.get(name)
        if edge is None:
            edge = self._up_edges[name] = _Edge()
        return edge

    def decide(self, signals: Dict[str, float], now: float) -> Decision:
        cfg = self.config
        pending = float(signals.get("cluster:pending_leases") or 0.0)
        arena = float(signals.get("cluster:arena_occupancy") or 0.0)
        shed = float(signals.get("serve:shed_rate") or 0.0)
        burn = float(signals.get("serve:slo_burn_rate") or 0.0)

        # -- up edges (each pressure signal matures independently) ----
        triggers: List[str] = []
        if self._up_edge("pending").update(
                pending >= cfg.pending_leases_threshold, now, cfg.up_for_s):
            triggers.append(f"pending_leases={pending:g}")
        if self._up_edge("arena").update(
                arena >= cfg.arena_occupancy_threshold, now, cfg.up_for_s):
            triggers.append(f"arena_occupancy={arena:.2f}")
        if self._up_edge("shed").update(
                shed > cfg.shed_rate_threshold, now, cfg.up_for_s):
            triggers.append(f"shed_rate={shed:.2f}/s")
        urgent = burn >= cfg.urgent_burn_rate
        if urgent:
            # burn >= 1.0 means the error budget is actively burning:
            # the ServeSLOBurnRate alert will fire after its for_s
            # sustain — act NOW so capacity lands inside that window
            self._up_edge("burn").since = now
            triggers.append(f"slo_burn_rate={burn:.2f} (urgent)")
        elif self._up_edge("burn").update(
                burn >= cfg.burn_rate_threshold, now, cfg.up_for_s):
            triggers.append(f"slo_burn_rate={burn:.2f}")

        if triggers:
            step = 1
            if urgent:
                step = min(cfg.max_step, max(1, math.ceil(burn)))
            self._down_edge.since = None
            decision = Decision(
                action="scale_up", step=step, urgent=urgent,
                reason="; ".join(triggers), triggers=triggers,
                signals=dict(signals), ts=now)
            self.last_decision = decision
            return decision

        # -- down edge: EVERY pressure signal quiet, with data --------
        quiet = bool(signals) \
            and pending < cfg.pending_leases_threshold \
            and shed <= cfg.shed_rate_threshold \
            and arena < cfg.quiet_arena_occupancy \
            and burn < cfg.quiet_burn_rate
        if self._down_edge.update(quiet, now, cfg.down_for_s):
            decision = Decision(
                action="allow_down",
                reason=f"quiet for {cfg.down_for_s:g}s",
                signals=dict(signals), ts=now)
        else:
            decision = Decision(action="hold", signals=dict(signals),
                                ts=now)
        self.last_decision = decision
        return decision
