"""Autoscaler monitor: polls GCS load and drives the autoscaler.

Parity: reference ``autoscaler/_private/monitor.py`` (``Monitor``:126) —
the head-side process that reads resource load from the GCS and runs
``StandardAutoscaler.update`` on a fixed period.  Here it can run as a
thread inside the driver/head or standalone.

Two layers live here:

* :class:`Monitor` — the legacy load-only loop (demand in, packer out).
* :class:`AutoscalerMonitor` — the closed-loop monitor
  (docs/autoscaler.md): it additionally subscribes to the
  derived signals via ``get_timeseries``, runs them through
  :class:`~ray_tpu_torch.autoscaler.policy.ScalingPolicy` (two-sided
  hysteresis, burn-rate urgency), pre-scales by injecting node-shaped
  demand, gates idle scale-down behind the policy's quiet edge, and
  replaces blind ``terminate_node`` with the GCS **drain protocol**
  (``drain_node`` → migrate → terminate only on ``drained=True``; an
  aborted drain leaves the node serving).  Provider launches ride a
  failpoint (``autoscaler.provider.launch_fail``) + exponential
  backoff so a flaky cloud API can never wedge the control loop.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ray_tpu_torch.autoscaler.autoscaler import StandardAutoscaler
from ray_tpu_torch.autoscaler.node_provider import NodeProvider
from ray_tpu_torch.autoscaler.policy import Decision, ScalingPolicy
from ray_tpu_torch.core import telemetry as _tm
from ray_tpu_torch.util import failpoint as _fp

logger = logging.getLogger(__name__)


class Monitor:
    def __init__(self, autoscaler: StandardAutoscaler,
                 *, update_interval_s: float = 1.0):
        self.autoscaler = autoscaler
        self.update_interval_s = update_interval_s
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _fetch_load(self) -> Dict[str, Any]:
        from ray_tpu_torch.core import worker as worker_mod
        core = worker_mod.global_worker()
        return core.gcs_call("get_cluster_load", {})

    def run_once(self) -> Dict[str, Any]:
        self.autoscaler.update_load_metrics(self._fetch_load())
        return self.autoscaler.update()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception:
                logger.exception("autoscaler update failed")
            self._stop.wait(self.update_interval_s)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop,
                                        name="autoscaler-monitor",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


class _ManagedProvider(NodeProvider):
    """Wraps the real provider with the monitor's safety rails:

    * ``create_node`` fires the ``autoscaler.provider.launch_fail``
      failpoint and converts ANY launch failure into an exponential
      holdoff instead of an exception — the monitor loop keeps ticking
      and retries once the holdoff expires (demand is standing, so
      nothing is lost).
    * ``terminate_node`` is the drain protocol: refused while the
      policy's quiet edge hasn't matured, and otherwise routed through
      the GCS ``drain_node`` RPC — the provider node is only actually
      terminated after the GCS reports ``drained=True`` (every sealed
      primary object migrated, spill blobs handed off).  An aborted
      drain leaves the node ACTIVE and serving.
    """

    def __init__(self, inner: NodeProvider, monitor: "AutoscalerMonitor"):
        super().__init__(getattr(inner, "provider_config", {}),
                         getattr(inner, "cluster_name", "default"))
        self._inner = inner
        self._monitor = monitor

    # -- passthrough reads ---------------------------------------------
    def non_terminated_nodes(self, tag_filters={}):
        return self._inner.non_terminated_nodes(tag_filters)

    def is_running(self, node_id):
        return self._inner.is_running(node_id)

    def node_tags(self, node_id):
        return self._inner.node_tags(node_id)

    # -- guarded writes ------------------------------------------------
    def create_node(self, node_config, tags, count):
        m = self._monitor
        now = time.monotonic()
        if now < m._launch_holdoff_until:
            m.launches_suppressed += count
            return
        try:
            if _fp.failpoint("autoscaler.provider.launch_fail"):
                raise RuntimeError(
                    "failpoint autoscaler.provider.launch_fail")
            self._inner.create_node(node_config, tags, count)
            m._launch_backoff = m.launch_backoff_s
        except Exception as e:  # noqa: BLE001 — the loop must survive
            m.launch_failures += 1
            _tm.autoscaler_launch_failure()
            m._launch_holdoff_until = now + m._launch_backoff
            logger.warning(
                "autoscaler: node launch failed (%s); backing off %.1fs",
                e, m._launch_backoff)
            m._launch_backoff = min(m._launch_backoff * 2,
                                    m.max_launch_backoff_s)

    def terminate_node(self, node_id):
        m = self._monitor
        if not m._allow_down:
            logger.info("autoscaler: scale-down of %s suppressed "
                        "(policy quiet edge not matured)", node_id)
            m.terminations_suppressed += 1
            return
        if not m._drain_and_release(node_id):
            return  # drain aborted: the node keeps serving
        self._inner.terminate_node(node_id)


class AutoscalerMonitor:
    """The closed-loop monitor: signals -> policy -> packer -> drain.

    One ``run_once`` tick:

    1. fetch ``get_cluster_load`` + the ``cluster:*`` / ``serve:*``
       derived-signal rings via ``get_timeseries``;
    2. run :class:`ScalingPolicy` (two-sided hysteresis, burn-rate
       urgency — thresholds sit below the alert thresholds so
       capacity lands before an alert fires);
    3. on ``scale_up``: inject ``step`` node-shaped bundles of demand
       so the packer launches ahead of the backlog;
       on ``allow_down``: unlock the drain-then-terminate path;
    4. ``StandardAutoscaler.update()`` does the packing;
    5. publish the decision (telemetry counters + the
       ``__autoscaler_last_decision`` KV record the CLI's ``nodes``
       shows).
    """

    def __init__(self, autoscaler: StandardAutoscaler, *,
                 policy: Optional[ScalingPolicy] = None,
                 update_interval_s: float = 1.0,
                 gcs_call: Optional[Callable[..., Any]] = None,
                 launch_backoff_s: float = 1.0,
                 max_launch_backoff_s: float = 30.0,
                 drain_reason: str = "autoscaler scale-down"):
        self.autoscaler = autoscaler
        self.policy = policy or ScalingPolicy()
        self.update_interval_s = update_interval_s
        self.launch_backoff_s = launch_backoff_s
        self.max_launch_backoff_s = max_launch_backoff_s
        self.drain_reason = drain_reason
        self._gcs_call = gcs_call
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # interpose the safety rails on whatever provider was given
        self.provider = autoscaler.provider
        autoscaler.provider = _ManagedProvider(self.provider, self)
        # policy gates + launch backoff state (read by the proxy)
        self._allow_down = False
        self._launch_holdoff_until = 0.0
        self._launch_backoff = launch_backoff_s
        # observability
        self.launch_failures = 0
        self.launches_suppressed = 0
        self.terminations_suppressed = 0
        self.drains_aborted = 0
        self.drains_completed = 0
        self.last_decision: Optional[Decision] = None
        self._last_persisted: Optional[str] = None

    # -- I/O -----------------------------------------------------------
    def _call(self, method: str, data: Optional[dict] = None):
        if self._gcs_call is not None:
            return self._gcs_call(method, data or {})
        from ray_tpu_torch.core import worker as worker_mod
        return worker_mod.global_worker().gcs_call(method, data or {})

    def _fetch_signals(self) -> Dict[str, float]:
        rows: List[Dict[str, Any]] = []
        for prefix in ("cluster:*", "serve:*"):
            try:
                rows.extend(self._call("get_timeseries",
                                       {"series": prefix}) or [])
            except Exception:  # noqa: BLE001
                logger.exception("get_timeseries %s failed", prefix)
        return ScalingPolicy.latest_signals(rows)

    def _node_shaped_demand(self, step: int) -> List[Dict[str, float]]:
        """``step`` whole-node bundles of the first configured worker
        type: pre-scale demand must be chip-shaped (a full node's
        resources), or the packer would satisfy it from capacity the
        pressure signals just proved insufficient."""
        for cfg in self.autoscaler.node_types.values():
            shape = {k: float(v) for k, v in cfg.resources.items() if v}
            if shape:
                return [dict(shape) for _ in range(step)]
        return []

    # -- drain-then-terminate -----------------------------------------
    def _gcs_id_for(self, provider_id: str) -> Optional[str]:
        for n in self.autoscaler.load_metrics.nodes:
            if n["node_id"].startswith(provider_id):
                return n["node_id"]
        return None

    def _drain_and_release(self, provider_id: str) -> bool:
        """Graceful scale-down of one provider node.  True only when
        the GCS confirmed the drain (objects migrated, spill handed
        off) — anything else keeps the node."""
        gcs_id = self._gcs_id_for(provider_id)
        if gcs_id is None:
            # never registered (failed launch remnant): nothing to
            # migrate, plain terminate is safe
            return True
        try:
            reply = self._call("drain_node", {
                "node_id": bytes.fromhex(gcs_id),
                "reason": self.drain_reason,
            }) or {}
        except Exception as e:  # noqa: BLE001
            logger.warning("autoscaler: drain_node(%s) failed: %s",
                           provider_id, e)
            reply = {"drained": False, "error": str(e)}
        if not reply.get("drained"):
            self.drains_aborted += 1
            logger.warning(
                "autoscaler: drain of %s aborted (%s); node stays",
                provider_id, reply.get("error", "unknown"))
            return False
        self.drains_completed += 1
        logger.info("autoscaler: node %s drained (%d migrated, %d "
                    "spill blobs handed off); terminating", provider_id,
                    int(reply.get("migrated", 0)),
                    int(reply.get("spill_handed_off", 0)))
        return True

    # -- the tick ------------------------------------------------------
    def run_once(self, now: Optional[float] = None) -> Dict[str, Any]:
        now = time.monotonic() if now is None else now
        self.autoscaler.update_load_metrics(
            self._call("get_cluster_load", {}))
        signals = self._fetch_signals()
        decision = self.policy.decide(signals, now)
        self.last_decision = decision
        self._allow_down = decision.action == "allow_down"
        if decision.action == "scale_up" and decision.step > 0:
            self.autoscaler.load_metrics.pending_demand.extend(
                self._node_shaped_demand(decision.step))
        summary = self.autoscaler.update()
        _tm.autoscaler_decision(decision.action)
        _tm.autoscaler_target_nodes(summary.get("num_workers", 0))
        self._persist_decision(decision, summary)
        return {"decision": decision.to_dict(), **summary}

    def _persist_decision(self, decision: Decision,
                          summary: Dict[str, Any]) -> None:
        """Last decision -> internal KV (the CLI's ``nodes`` reads it).
        Only state CHANGES are written: the KV put is WAL-backed, and a
        hold-tick heartbeat must not grind the GCS WAL."""
        from ray_tpu_torch.core.gcs import AUTOSCALER_DECISION_KV_KEY

        record = decision.to_dict()
        record.update({
            "launched": summary.get("launched", {}),
            "terminated": summary.get("terminated", []),
            "num_workers": summary.get("num_workers", 0),
        })
        acted = record["launched"] or record["terminated"] \
            or decision.action == "scale_up"
        key = json.dumps({k: record[k] for k in
                          ("action", "launched", "terminated",
                           "num_workers")}, sort_keys=True)
        if not acted and key == self._last_persisted:
            return
        self._last_persisted = key
        try:
            self._call("kv_put", {"key": AUTOSCALER_DECISION_KV_KEY,
                                  "value": json.dumps(record)})
        except Exception:  # noqa: BLE001
            logger.exception("failed to persist autoscaler decision")

    # -- lifecycle -----------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.run_once()
            except Exception:  # noqa: BLE001 — the loop must survive
                logger.exception("autoscaler monitor tick failed")
            self._stop.wait(self.update_interval_s)

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop,
                                        name="autoscaler-monitor",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
