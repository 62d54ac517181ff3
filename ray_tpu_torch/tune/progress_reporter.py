"""Console progress reporting (parity: reference
``tune/progress_reporter.py`` ``CLIReporter`` — a periodic trial-status
table on stdout)."""

from __future__ import annotations

import sys
import time
from typing import Any, Dict, List, Optional


class CLIReporter:
    def __init__(self, *, metric_columns: Optional[List[str]] = None,
                 max_report_frequency: float = 5.0,
                 out=None):
        self.metric_columns = metric_columns or [
            "training_iteration", "episode_reward_mean", "loss",
            "accuracy", "score"]
        self.period = float(max_report_frequency)
        self._last = 0.0
        self._out = out or sys.stdout

    def should_report(self, force: bool = False) -> bool:
        now = time.monotonic()
        if force or now - self._last >= self.period:
            self._last = now
            return True
        return False

    def report(self, trials: List[Any], done: bool = False) -> None:
        by_status: Dict[str, int] = {}
        for t in trials:
            by_status[t.status] = by_status.get(t.status, 0) + 1
        header = ", ".join(f"{count} {status}"
                           for status, count in sorted(by_status.items()))
        lines = [f"== Status: {header} =="]
        cols = [c for c in self.metric_columns
                if any(c in (t.last_result or {}) for t in trials)]
        lines.append("  ".join(["trial".ljust(16), "status".ljust(10),
                                *[c[:20].ljust(20) for c in cols]]))
        for t in trials:
            result = t.last_result or {}
            row = [t.trial_id[:16].ljust(16), t.status.ljust(10)]
            for c in cols:
                val = result.get(c)
                row.append((f"{val:.4g}" if isinstance(val, float)
                            else str(val))[:20].ljust(20))
            lines.append("  ".join(row))
        print("\n".join(lines), file=self._out, flush=True)
