"""Trial runner event loop (parity: reference
``tune/execution/trial_runner.py`` ``TrialRunner:327`` +
``ray_trial_executor.py`` ``RayTrialExecutor:213``): trials are actors
with per-trial resources, polled for buffered results; schedulers may
stop trials early; failed trials restore from their last checkpoint up to
``FailureConfig.max_failures``; PBT exploits restart a trial from a
donor's checkpoint with a mutated config.

``resources_per_trial`` names ``"GPU"`` where the JAX package names
``"TPU"`` (``Tuner`` raises ``TypeError`` for that key): a share below 1
puts ``1 // share`` trials side by side on one card.  A trial that leases a
GPU runs in a cold-spawned worker, and so does each restart."""

from __future__ import annotations

import logging
import time
from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch.train.config import FailureConfig, RunConfig
from ray_tpu_torch.tune import schedulers as sched_mod
from ray_tpu_torch.tune.trial import (ERROR, PAUSED, PENDING, RUNNING, TERMINATED,
                                Trial, TrialActor)

logger = logging.getLogger(__name__)


class ExperimentSync:
    """Durable experiment-state + per-trial checkpoint sync.

    Parity: reference ``tune/syncer.py`` (SyncerCallback uploading trial
    checkpoints to ``RunConfig.storage_path``) + the experiment-state
    snapshots ``Tuner.restore`` reads.  A lost head node loses nothing:
    every checkpoint and the trial table live at the storage URI.
    """

    STATE_FILE = "experiment_state.pkl"
    #: min seconds between non-forced snapshots: the snapshot pickles the
    #: FULL trial table (all results), so per-checkpoint snapshots would
    #: be O(trials x results) work inside the runner's poll loop
    SNAPSHOT_PERIOD_S = 2.0

    def __init__(self, storage_path: str, name: str):
        from ray_tpu_torch.air import storage
        self._storage = storage
        self.root = storage.join(storage_path, name)
        self._synced: Dict[str, Any] = {}  # trial_id -> last synced ckpt obj
        self._last_snapshot = 0.0

    @classmethod
    def load(cls, experiment_uri: str) -> Dict[str, Any]:
        """Read a synced experiment state (dumped with cloudpickle; plain
        pickle loads it)."""
        import pickle

        from ray_tpu_torch.air import storage
        return pickle.loads(storage.read_bytes(
            storage.join(experiment_uri, cls.STATE_FILE)))

    def sync_trial_checkpoint(self, trial: Trial) -> None:
        ckpt = trial.checkpoint
        if ckpt is None or self._synced.get(trial.trial_id) is ckpt:
            return
        uri = self._storage.join(self.root, trial.trial_id, "checkpoint")
        with ckpt.as_directory() as local:
            self._storage.upload_dir(local, uri)
        trial.checkpoint_uri = uri
        self._synced[trial.trial_id] = ckpt

    def snapshot(self, trials: List[Trial],
                 meta: Optional[Dict[str, Any]] = None,
                 force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last_snapshot < self.SNAPSHOT_PERIOD_S:
            return
        self._last_snapshot = now
        import cloudpickle
        state = {
            "meta": dict(meta or {}),
            "trials": [{
                "trial_id": t.trial_id,
                "config": t.config,
                "status": t.status,
                "last_result": t.last_result,
                "results": t.results,
                "error": t.error,
                "num_failures": t.num_failures,
                "checkpoint_uri": t.checkpoint_uri,
            } for t in trials],
        }
        self._storage.write_bytes(
            self._storage.join(self.root, self.STATE_FILE),
            cloudpickle.dumps(state))



class TrialRunner:
    def __init__(self, trainable: Callable, trials: List[Trial], *,
                 scheduler: Optional[sched_mod.TrialScheduler] = None,
                 max_concurrent: int = 0,
                 resources_per_trial: Optional[Dict[str, float]] = None,
                 run_config: Optional[RunConfig] = None,
                 sync_meta: Optional[Dict[str, Any]] = None):
        self.trainable = trainable
        self.trials = trials
        self.scheduler = scheduler or sched_mod.FIFOScheduler()
        self.resources = resources_per_trial or {"CPU": 1}
        self.run_config = run_config or RunConfig()
        self.max_concurrent = max_concurrent or len(trials)
        self._exploit_requests: Dict[str, tuple] = {}
        self._sync: Optional[ExperimentSync] = None
        self._sync_meta = dict(sync_meta or {})
        if self.run_config.storage_path:
            self._sync = ExperimentSync(
                self.run_config.storage_path,
                self.run_config.name or "tune_experiment")
        from ray_tpu_torch.tune.callback import default_callbacks
        from ray_tpu_torch.tune.stopper import resolve_stopper
        callbacks = getattr(self.run_config, "callbacks", None)
        if callbacks is None:
            import os
            local_dir = getattr(self.run_config, "local_dir", None) \
                or os.path.expanduser(os.path.join(
                    "~", "ray_tpu_torch_results",
                    self.run_config.name or "tune_experiment"))
            callbacks = default_callbacks(local_dir)
        self.callbacks = list(callbacks)
        self._stopper = resolve_stopper(
            getattr(self.run_config, "stop", None))
        self._reporter = None
        period = float(getattr(self.run_config, "progress_report_s", 0.0)
                       or 0.0)
        if period > 0:
            from ray_tpu_torch.tune.progress_reporter import CLIReporter
            self._reporter = CLIReporter(max_report_frequency=period)
        self._iteration = 0

    def _fire(self, hook: str, *args) -> None:
        for cb in self.callbacks:
            try:
                getattr(cb, hook)(*args)
            except Exception:  # noqa: BLE001 — callbacks must not kill
                logger.exception("callback %s.%s failed",
                                 type(cb).__name__, hook)

    def _sync_progress(self, trial: Optional[Trial] = None,
                       force: bool = False) -> None:
        if self._sync is None:
            return
        try:
            if trial is not None:
                self._sync.sync_trial_checkpoint(trial)
            self._sync.snapshot(self.trials, self._sync_meta, force=force)
        except Exception:  # noqa: BLE001 — sync must not kill training
            logger.exception("experiment sync failed")

    def get_trial(self, trial_id: str) -> Optional[Trial]:
        for t in self.trials:
            if t.trial_id == trial_id:
                return t
        return None

    def exploit_trial(self, trial: Trial, donor: Trial,
                      new_config: Dict[str, Any]) -> None:
        """PBT hook: restart ``trial`` from ``donor``'s checkpoint with a
        mutated config."""
        donor_ckpt = donor.checkpoint
        if donor_ckpt is None and donor.actor is not None:
            try:
                donor_ckpt = ray_tpu_torch.get(donor.actor.get_checkpoint.remote(),
                                         timeout=30)
            except Exception:  # noqa: BLE001
                donor_ckpt = None
        self._exploit_requests[trial.trial_id] = (new_config, donor_ckpt)

    # ------------------------------------------------------------------
    def _start_trial(self, trial: Trial) -> None:
        opts = {"resources": dict(self.resources)}
        trial.actor = TrialActor.options(**opts).remote()
        ray_tpu_torch.get(trial.actor.run.remote(
            self.trainable, trial.config, trial.checkpoint), timeout=300)
        trial.status = RUNNING

    def _stop_trial(self, trial: Trial, status: str) -> None:
        if trial.actor is not None:
            try:
                ray_tpu_torch.get(trial.actor.request_stop.remote(), timeout=10)
                ckpt = ray_tpu_torch.get(trial.actor.get_checkpoint.remote(),
                                   timeout=10)
                if ckpt is not None:
                    trial.checkpoint = ckpt
            except Exception:  # noqa: BLE001
                pass
            ray_tpu_torch.kill(trial.actor)
            trial.actor = None
        trial.status = status

    def requeue_trial(self, trial: Trial) -> None:
        """Move a PAUSED trial back to the pending queue (sync-HyperBand
        promotion, PBT exploit targets)."""
        if trial.status == PAUSED:
            trial.status = PENDING
            self._pending.append(trial)

    def _effective_max_concurrent(self) -> int:
        """Cap concurrency at what the cluster can actually place:
        ``_start_trial`` blocks on actor placement, so starting more
        trials than fit would deadlock the event loop against its own
        finished-but-unreaped trials."""
        cap = self.max_concurrent
        try:
            total = ray_tpu_torch.cluster_resources()
        except Exception:  # noqa: BLE001 — sizing is best-effort
            return cap
        for res, need in self.resources.items():
            if need and total.get(res):
                cap = min(cap, max(1, int(total[res] // need)))
        return cap

    def run(self, poll_period: float = 0.05) -> List[Trial]:
        self._pending = pending = [t for t in self.trials
                                   if t.status == PENDING]
        live: List[Trial] = []
        max_concurrent = self._effective_max_concurrent()
        self._fire("setup", self.trials)
        stop_all = False
        while pending or live:
            while pending and len(live) < max_concurrent and not stop_all:
                trial = pending.pop(0)
                try:
                    self._start_trial(trial)
                    live.append(trial)
                    self._fire("on_trial_start", self._iteration,
                               self.trials, trial)
                except Exception as e:  # noqa: BLE001
                    trial.status = ERROR
                    trial.error = str(e)
                    self.scheduler.on_trial_complete(self, trial, None)
                    self._fire("on_trial_error", self._iteration,
                               self.trials, trial)
            if stop_all and not live:
                break
            progressed = False
            self._iteration += 1
            for trial in list(live):
                polls = ray_tpu_torch.get(trial.actor.poll.remote(), timeout=60)
                decision = sched_mod.CONTINUE
                for result in polls["results"]:
                    progressed = True
                    if result.pop("_has_checkpoint", False):
                        trial.checkpoint = ray_tpu_torch.get(
                            trial.actor.get_checkpoint.remote(), timeout=30)
                        self._sync_progress(trial)
                    trial.last_result = result
                    trial.results.append(result)
                    self._fire("on_trial_result", self._iteration,
                               self.trials, trial, result)
                    if self._stopper is not None and \
                            self._stopper(trial.trial_id, result):
                        decision = sched_mod.STOP
                    d = self.scheduler.on_trial_result(self, trial, result)
                    if d != sched_mod.CONTINUE:
                        decision = d
                if decision == sched_mod.STOP:
                    self._stop_trial(trial, TERMINATED)
                    live.remove(trial)
                    self.scheduler.on_trial_complete(self, trial,
                                                     trial.last_result)
                    self._fire("on_trial_complete", self._iteration,
                               self.trials, trial)
                    self._sync_progress(trial, force=True)
                    continue
                if trial.trial_id in self._exploit_requests:
                    new_config, ckpt = self._exploit_requests.pop(
                        trial.trial_id)
                    self._stop_trial(trial, PAUSED)
                    live.remove(trial)
                    trial.config = new_config
                    if ckpt is not None:
                        trial.checkpoint = ckpt
                    trial.status = PENDING
                    pending.append(trial)
                    continue
                if decision == sched_mod.PAUSE:
                    # sync-scheduler pause (no exploit attached): park the
                    # trial; the scheduler promotes via requeue_trial
                    self._stop_trial(trial, PAUSED)
                    live.remove(trial)
                    self.scheduler.on_trial_paused(self, trial)
                    continue
                if polls["done"]:
                    live.remove(trial)
                    if polls["error"]:
                        trial.num_failures += 1
                        trial.error = polls["error"]
                        maxf = self.run_config.failure_config.max_failures
                        if maxf < 0 or trial.num_failures <= maxf:
                            logger.warning(
                                "trial %s failed (%d); restoring from "
                                "checkpoint", trial.trial_id,
                                trial.num_failures)
                            self._stop_trial(trial, PENDING)
                            pending.append(trial)
                        else:
                            self._stop_trial(trial, ERROR)
                            self.scheduler.on_trial_complete(self, trial, None)
                            self._fire("on_trial_error", self._iteration,
                                       self.trials, trial)
                        self._sync_progress(trial, force=True)
                    else:
                        trial.error = None  # a successful retry clears it
                        ckpt = ray_tpu_torch.get(
                            trial.actor.get_checkpoint.remote(), timeout=30)
                        if ckpt is not None:
                            trial.checkpoint = ckpt
                        self._stop_trial(trial, TERMINATED)
                        self.scheduler.on_trial_complete(
                            self, trial, trial.last_result)
                        self._fire("on_trial_complete", self._iteration,
                                   self.trials, trial)
                        self._sync_progress(trial, force=True)
            if self._stopper is not None and self._stopper.stop_all() \
                    and not stop_all:
                # experiment-level stop: drain live trials, start no more
                stop_all = True
                for trial in pending:
                    # never-started trials end TERMINATED, not stuck
                    # PENDING in the returned ResultGrid — but they get
                    # no on_trial_complete: callbacks that pair
                    # start/complete or read last_result never saw an
                    # on_trial_start for these
                    trial.status = TERMINATED
                pending.clear()
                for trial in list(live):
                    self._stop_trial(trial, TERMINATED)
                    live.remove(trial)
                    self.scheduler.on_trial_complete(self, trial,
                                                     trial.last_result)
                    self._fire("on_trial_complete", self._iteration,
                               self.trials, trial)
                    self._sync_progress(trial, force=True)
            if self._reporter is not None and self._reporter.should_report():
                self._reporter.report(self.trials)
            if not progressed:
                time.sleep(poll_period)
        if self._reporter is not None:
            self._reporter.report(self.trials, done=True)
        self._fire("on_experiment_end", self.trials)
        self._sync_progress(force=True)
        return self.trials
