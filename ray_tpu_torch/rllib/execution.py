"""Execution utilities shared by algorithms.

Parity: reference ``rllib/execution/rollout_ops.py``
(``synchronous_parallel_sample``) and ``train_ops.py``
(``train_one_step``), plus the Podracer-style decoupled pipeline
(:class:`DecoupledPipeline`) that replaces per-worker policy inference
with vectorized env actors feeding a centralized batched-inference
actor over the object plane (docs/rl_pipeline.md).
"""

from __future__ import annotations

import time
from typing import Any, Dict, List

import ray_tpu_torch
from ray_tpu_torch.core import telemetry as _tm
from ray_tpu_torch.rllib.sample_batch import (MultiAgentBatch,
                                              SampleBatch, concat_samples)


def _batch_steps(b: Any) -> int:
    return b.env_steps() if isinstance(b, MultiAgentBatch) else len(b)


def synchronous_parallel_sample(worker_set, *,
                                max_env_steps: int):
    """Fan out ``sample()`` across the fleet until at least
    ``max_env_steps`` env steps are gathered.  Returns a SampleBatch, or
    a MultiAgentBatch (concatenated per policy) in multi-agent mode.

    Admission is ``ray_tpu_torch.wait``-streamed: each worker keeps exactly
    one ``sample()`` in flight, fast workers are re-dispatched as their
    fragments land, and the quota can fill from the fast side of the
    fleet while a straggler is still stepping — one slow env actor no
    longer idles the learner.  A straggler's fragment is consumed on the
    NEXT call (its in-flight ref is carried on the worker set), so its
    work is never discarded; carried fragments are at most one update
    stale, which every algorithm on this path already tolerates from
    worker-side exploration lag.  This helper remains the fallback path
    for algorithms not yet migrated to :class:`DecoupledPipeline`.
    """
    batches: List[Any] = []
    steps = 0
    if not worker_set.remote_workers:
        while steps < max_env_steps:
            b = worker_set.local_worker.sample()
            batches.append(b)
            steps += _batch_steps(b)
        return _concat_result(batches)

    # carried in-flight refs from the previous call (straggler results)
    inflight: Dict[Any, Any] = getattr(worker_set, "_stream_inflight", {})
    live = {id(w) for w in worker_set.remote_workers}
    inflight = {ref: w for ref, w in inflight.items() if id(w) in live}
    have = {id(w) for w in inflight.values()}
    for w in worker_set.remote_workers:
        if id(w) not in have:
            inflight[w.sample.remote()] = w
    deadline = time.monotonic() + 300.0
    while steps < max_env_steps and inflight \
            and time.monotonic() < deadline:
        ready, _ = ray_tpu_torch.wait(list(inflight), num_returns=1,
                                      timeout=30)
        for ref in ready:
            worker = inflight.pop(ref)
            try:
                b = ray_tpu_torch.get(ref)
            except Exception:  # noqa: BLE001 — dead worker: drop its
                continue       # ref; probe_and_recreate replaces it
            batches.append(b)
            steps += _batch_steps(b)
            if steps < max_env_steps:
                inflight[worker.sample.remote()] = worker
    worker_set._stream_inflight = inflight
    if not batches:
        # whole fleet died mid-iteration: sample locally so the learner
        # sees a real batch while the next probe rebuilds the workers
        batches = [worker_set.local_worker.sample()]
    return _concat_result(batches)


def _concat_result(batches: List[Any]):
    if isinstance(batches[0], MultiAgentBatch):
        pids = {pid for b in batches for pid in b}
        return MultiAgentBatch(
            {pid: concat_samples([b[pid] for b in batches if pid in b])
             for pid in pids},
            env_steps=sum(b.env_steps() for b in batches))
    return concat_samples(batches)


def train_one_step(algorithm, batch: SampleBatch) -> Dict[str, float]:
    """Learn on the local worker's policy (reference ``train_one_step``)."""
    return algorithm.workers.local_worker.policy.learn_on_batch(batch)


def standardize_advantages(batch: SampleBatch) -> SampleBatch:
    adv = batch[SampleBatch.ADVANTAGES]
    batch[SampleBatch.ADVANTAGES] = \
        (adv - adv.mean()) / max(1e-4, adv.std())
    return batch


class DecoupledPipeline:
    """Sebulba-style acting plane: ``num_env_actors`` vectorized env
    actors feed ``rl_num_inference_actors`` centralized batched-
    inference actors; trajectory fragments ride the object plane back to
    the learner, which admits them with ``ray_tpu_torch.wait`` streaming and
    enforces the off-policy staleness bound (``rl_max_fragment_lag``
    learner updates).  Weight sync is ONE ``put()`` per learner step
    broadcast to the inference actors only — flat in env-actor count.
    """

    def __init__(self, env_spec: Any, policy_cls: type,
                 config: Dict[str, Any]):
        from ray_tpu_torch.rllib.inference import InferenceActor
        from ray_tpu_torch.rllib.rollout_worker import EnvActor

        self._env_spec = env_spec
        self._policy_cls = policy_cls
        self._config = dict(config)
        self._num_actors = int(config.get("num_env_actors")
                               or config.get("num_rollout_workers") or 1)
        num_inference = max(1, int(config.get("rl_num_inference_actors",
                                              1) or 1))
        self._max_lag = int(config.get("rl_max_fragment_lag", 2))
        # inference actors are service actors (like serve proxies):
        # num_cpus=0 so they never compete with env actors for slots
        self._inference_cls = ray_tpu_torch.remote(InferenceActor).options(
            num_cpus=0,
            max_concurrency=2 * self._num_actors + 4)
        self.inference_actors = [
            self._inference_cls.remote(env_spec, policy_cls, self._config)
            for _ in range(num_inference)]
        self._env_cls = ray_tpu_torch.remote(EnvActor).options(
            num_cpus=float(config.get("num_cpus_per_worker", 1)))
        self.env_actors: List[Any] = []
        for i in range(self._num_actors):
            self.env_actors.append(self._make_env_actor(i))
        self.version = 0
        self._inflight: Dict[Any, int] = {}      # ref -> actor slot
        self._last_seq: Dict[int, int] = {}      # slot -> last seq seen
        self._pending_metrics: List[Dict[str, Any]] = []
        self.stale_dropped = 0
        self.actors_recreated = 0
        # pin the latest broadcast object: the non-blocking set_weights
        # pushes must be able to pull it however late they land, and it
        # backs the stale-storm republish below
        self._weights_ref: Any = None

    def _make_env_actor(self, slot: int):
        inference = self.inference_actors[slot
                                          % len(self.inference_actors)]
        return self._env_cls.remote(self._env_spec, self._config,
                                    slot + 1, inference)

    # ------------------------------------------------------------------
    def publish_weights(self, weights: Any) -> int:
        """One object-plane broadcast per learner step: a single
        ``put()``; inference actors chain on the in-flight copy.
        Non-blocking — ordered actor queues make the new version
        visible before any later ``infer``/``stats`` call."""
        self.version += 1
        self._weights_ref = ray_tpu_torch.put(weights)
        for actor in self.inference_actors:
            actor.set_weights.remote(self._weights_ref, self.version)
        return self.version

    def collect(self, target_steps: int) -> SampleBatch:
        """Gather at least ``target_steps`` env steps of fragments,
        streaming-admitted; every env actor keeps one
        ``collect_fragment`` in flight THROUGH the learner's update, so
        acting, transfer, and learning overlap."""
        for slot in range(len(self.env_actors)):
            if slot not in self._inflight.values():
                self._inflight[
                    self.env_actors[slot].collect_fragment.remote()] = slot
        batches: List[SampleBatch] = []
        steps = 0
        consecutive_stale = 0
        deadline = time.monotonic() + 300.0
        while steps < target_steps and self._inflight \
                and time.monotonic() < deadline:
            # zero-timeout snapshot of EVERYTHING ready: the true
            # learner backlog (a num_returns=1 wait would cap the
            # gauge at 1 and hide learner-bound pipelines)
            refs = list(self._inflight)
            ready, _ = ray_tpu_torch.wait(refs, num_returns=len(refs),
                                          timeout=0)
            _tm.rl_fragment_queue_depth(len(ready))
            if not ready:
                ready, _ = ray_tpu_torch.wait(refs, num_returns=1, timeout=30)
            if not ready:
                continue  # wedged fleet: bounded by the deadline above
            for ref in ready:
                slot = self._inflight.pop(ref)
                try:
                    result = ray_tpu_torch.get(ref)
                except Exception:  # noqa: BLE001 — env actor died
                    # (chaos/SIGKILL): replace it in place; the learner
                    # keeps training on the surviving fleet meanwhile
                    self.env_actors[slot] = self._make_env_actor(slot)
                    self._last_seq.pop(slot, None)
                    self.actors_recreated += 1
                    self._inflight[self.env_actors[slot]
                                   .collect_fragment.remote()] = slot
                    continue
                # re-dispatch FIRST: the actor starts its next fragment
                # while this one is admitted/learned on
                self._inflight[self.env_actors[slot]
                               .collect_fragment.remote()] = slot
                last = self._last_seq.get(slot, 0)
                if result["seq"] <= last:
                    continue  # replayed fragment from a recreated handle
                self._last_seq[slot] = result["seq"]
                self._pending_metrics.append(result["metrics"])
                if self.version - result["version"] > self._max_lag:
                    self.stale_dropped += 1
                    consecutive_stale += 1
                    _tm.rl_fragments_dropped_stale()
                    if consecutive_stale >= 2 * len(self.env_actors) \
                            and self._weights_ref is not None:
                        # a stale STORM means the fire-and-forget
                        # set_weights push was lost (dead inference
                        # actor exec thread, dropped reply, ...):
                        # republish the pinned broadcast so the fleet
                        # converges instead of burning the deadline
                        for actor in self.inference_actors:
                            actor.set_weights.remote(
                                self._weights_ref, self.version)
                        consecutive_stale = 0
                    continue
                consecutive_stale = 0
                batches.append(result["batch"])
                steps += len(result["batch"])
        if not batches:
            raise RuntimeError(
                "decoupled pipeline collected no fragments (whole env "
                "fleet unreachable for 300s)")
        return concat_samples(batches)

    def drain_metrics(self) -> List[Dict[str, Any]]:
        out, self._pending_metrics = self._pending_metrics, []
        return out

    def stats(self) -> Dict[str, Any]:
        """Merged inference stats + pipeline counters (best-effort)."""
        out: Dict[str, Any] = {
            "weights_version": self.version,
            "stale_dropped": self.stale_dropped,
            "actors_recreated": self.actors_recreated,
        }
        try:
            infer = ray_tpu_torch.get(
                [a.stats.remote() for a in self.inference_actors],
                timeout=30)
            out["inference"] = infer
        except Exception:  # noqa: BLE001 — stats are advisory
            pass
        return out

    def stop(self) -> None:
        self._inflight.clear()
        for actor in self.env_actors + self.inference_actors:
            try:
                ray_tpu_torch.kill(actor)
            except Exception:  # noqa: BLE001 — already dead is fine
                pass
        self.env_actors = []
        self.inference_actors = []
