"""Tune callbacks + logger integrations.

Parity: reference ``tune/callback.py`` (``Callback`` hook surface),
``tune/logger/{csv,json,tensorboardx}.py`` (per-trial progress.csv /
result.json / tensorboard event files), and the ``air/callbacks``
integration gate pattern (W&B/MLflow raise with instructions when the
client library is absent).
"""

from __future__ import annotations

import csv
import json
import logging
import os
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)


class Callback:
    """Experiment-loop hooks (reference ``tune/callback.py:63``)."""

    def setup(self, trials: List[Any]) -> None:
        pass

    def on_trial_start(self, iteration: int, trials: List[Any],
                       trial: Any) -> None:
        pass

    def on_trial_result(self, iteration: int, trials: List[Any],
                        trial: Any, result: Dict[str, Any]) -> None:
        pass

    def on_trial_complete(self, iteration: int, trials: List[Any],
                          trial: Any) -> None:
        pass

    def on_trial_error(self, iteration: int, trials: List[Any],
                       trial: Any) -> None:
        pass

    def on_experiment_end(self, trials: List[Any]) -> None:
        pass


class LoggerCallback(Callback):
    """Base for per-trial file loggers (reference
    ``tune/logger/logger.py`` ``LoggerCallback``)."""

    def __init__(self, local_dir: str):
        self.local_dir = local_dir

    def _trial_dir(self, trial: Any) -> str:
        path = os.path.join(self.local_dir, trial.trial_id)
        os.makedirs(path, exist_ok=True)
        return path


def _scalars(result: Dict[str, Any]) -> Dict[str, Any]:
    out = {}
    for key, val in result.items():
        if isinstance(val, (int, float, str, bool)) or val is None:
            out[key] = val
    return out


class JsonLoggerCallback(LoggerCallback):
    """result.json (one JSON line per result) + params.json (reference
    ``tune/logger/json.py``)."""

    def on_trial_start(self, iteration, trials, trial) -> None:
        with open(os.path.join(self._trial_dir(trial),
                               "params.json"), "w") as f:
            json.dump(_scalars(trial.config), f)

    def on_trial_result(self, iteration, trials, trial, result) -> None:
        with open(os.path.join(self._trial_dir(trial),
                               "result.json"), "a") as f:
            f.write(json.dumps(_scalars(result)) + "\n")


class CSVLoggerCallback(LoggerCallback):
    """progress.csv per trial (reference ``tune/logger/csv.py``).  The
    header is fixed at the first result; later keys are dropped (same
    contract as the reference's CSV logger)."""

    def __init__(self, local_dir: str):
        super().__init__(local_dir)
        self._writers: Dict[str, Any] = {}
        self._files: Dict[str, Any] = {}

    def on_trial_result(self, iteration, trials, trial, result) -> None:
        row = _scalars(result)
        writer = self._writers.get(trial.trial_id)
        if writer is None:
            f = open(os.path.join(self._trial_dir(trial),
                                  "progress.csv"), "w", newline="")
            writer = csv.DictWriter(f, fieldnames=sorted(row))
            writer.writeheader()
            self._writers[trial.trial_id] = writer
            self._files[trial.trial_id] = f
        writer.writerow({k: row.get(k) for k in writer.fieldnames})
        self._files[trial.trial_id].flush()

    def on_experiment_end(self, trials) -> None:
        for f in self._files.values():
            try:
                f.close()
            except Exception:  # noqa: BLE001
                pass
        self._files.clear()
        self._writers.clear()


class TBXLoggerCallback(LoggerCallback):
    """TensorBoard event files per trial (reference
    ``tune/logger/tensorboardx.py``).  Uses torch's bundled
    SummaryWriter; raises at construction with instructions when no
    tensorboard writer is importable (the air/callbacks gate pattern)."""

    def __init__(self, local_dir: str):
        super().__init__(local_dir)
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            try:
                from tensorboardX import SummaryWriter  # type: ignore
            except ImportError as e:
                raise ImportError(
                    "TBXLoggerCallback needs tensorboard (pip install "
                    "tensorboard) or tensorboardX") from e
        self._writer_cls = SummaryWriter
        self._writers: Dict[str, Any] = {}

    def on_trial_result(self, iteration, trials, trial, result) -> None:
        w = self._writers.get(trial.trial_id)
        if w is None:
            w = self._writer_cls(log_dir=self._trial_dir(trial))
            self._writers[trial.trial_id] = w
        step = int(result.get("training_iteration", iteration))
        for key, val in result.items():
            if isinstance(val, (int, float)) and not isinstance(val, bool):
                w.add_scalar(key, val, global_step=step)

    def on_experiment_end(self, trials) -> None:
        for w in self._writers.values():
            try:
                w.close()
            except Exception:  # noqa: BLE001
                pass
        self._writers.clear()


def default_callbacks(local_dir: Optional[str]) -> List[Callback]:
    """CSV + JSON loggers (the reference's DEFAULT_LOGGERS)."""
    if not local_dir:
        return []
    return [CSVLoggerCallback(local_dir), JsonLoggerCallback(local_dir)]
