"""Event-loop instrumentation: lag watchdog + per-handler timings.

Parity: reference ``src/ray/common/asio/instrumented_io_context.h`` and
the ``event_stats`` flag (``ray_config_def.h:33``) — the practical "is a
handler stuck" tool.  Two pieces:

- :class:`LoopMonitor`: a coroutine that sleeps a fixed interval and
  measures scheduling drift.  Sustained drift means some callback is
  hogging the loop (the asyncio analogue of a blocked io_context);
  drifts above the threshold are logged with the worst offender from
  the handler table.
- handler stats: ``record(method, seconds)`` is called by the RPC
  server around every dispatched handler; ``snapshot()`` feeds
  ``debug_state`` RPCs / the dashboard.

Everything is per-process and lock-free (single loop thread mutates,
readers tolerate torn reads of plain dicts).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class HandlerStats:
    def __init__(self):
        self._stats: Dict[str, Dict[str, float]] = {}

    def record(self, method: str, seconds: float) -> None:
        entry = self._stats.get(method)
        if entry is None:
            entry = self._stats[method] = {
                "count": 0, "total_s": 0.0, "max_s": 0.0}
        entry["count"] += 1
        entry["total_s"] += seconds
        if seconds > entry["max_s"]:
            entry["max_s"] = seconds

    def worst(self) -> Optional[str]:
        if not self._stats:
            return None
        return max(self._stats, key=lambda m: self._stats[m]["max_s"])

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        return {m: dict(v) for m, v in self._stats.items()}


class LoopMonitor:
    """Measures event-loop scheduling lag (drift of a periodic sleep)."""

    def __init__(self, name: str, stats: Optional[HandlerStats] = None,
                 interval_s: float = 0.1, warn_lag_s: float = 0.5):
        self.name = name
        self.stats = stats
        self.interval_s = interval_s
        self.warn_lag_s = warn_lag_s
        self.max_lag_s = 0.0
        self.ewma_lag_s = 0.0
        self._task: Optional[asyncio.Task] = None

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()

    async def _run(self) -> None:
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(self.interval_s)
            lag = max(0.0, time.monotonic() - t0 - self.interval_s)
            self.ewma_lag_s = 0.9 * self.ewma_lag_s + 0.1 * lag
            if lag > self.max_lag_s:
                self.max_lag_s = lag
            if lag > self.warn_lag_s:
                worst = self.stats.worst() if self.stats else None
                logger.warning(
                    "%s event loop lagged %.2fs (worst handler so far: "
                    "%s) — a callback is blocking the loop",
                    self.name, lag, worst or "unknown")

    def snapshot(self) -> Dict[str, Any]:
        return {"loop": self.name,
                "max_lag_s": round(self.max_lag_s, 4),
                "ewma_lag_s": round(self.ewma_lag_s, 4),
                "handlers": self.stats.snapshot() if self.stats else {}}
