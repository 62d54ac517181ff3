"""Centralized batched inference for the decoupled RL pipeline.

Podracer/Sebulba architecture (PAPERS.md arXiv:2104.06272): rollout
processes never hold the policy.  Vectorized env actors ship observation
batches here; a single decode-loop-style thread admits every request
queued at a dispatch boundary into ONE padded, bucketed forward (the
continuous-batching admission discipline of ``serve/batching.py``
applied to policy forwards), then scatters the per-request slices back.
Policy inference over the whole fleet is a stream of a few large
forwards of a few fixed shapes instead of thousands of tiny per-step
dispatches — the fix for BENCH_r05's PPO anti-scaling.

Weight sync: the learner publishes weights ONCE per update as a single
object-plane broadcast; only inference actors (O(1) of them, not O(env
actors)) apply it.  Replies are tagged with the weights *version* in
force at dispatch so the learner can enforce the off-policy staleness
bound (``rl_max_fragment_lag``).
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.core import device_telemetry as _dt
from ray_tpu_torch.core import telemetry as _tm

__all__ = ["InferenceActor", "InferenceBatcher", "inference_buckets"]


def inference_buckets(max_rows: int, floor: int = 8) -> Tuple[int, ...]:
    """Power-of-two row-count buckets up to ``max_rows`` (rounded up).
    Each bucket is one step shape of the action forward (one compile
    where the forward is compiled); requests pad to the smallest bucket
    that fits, so the shape set is O(log N)."""
    out: List[int] = []
    b = max(1, int(floor))
    while b < max_rows:
        out.append(b)
        b *= 2
    out.append(b)
    return tuple(out)


class _Pending:
    __slots__ = ("obs", "rows", "future")

    def __init__(self, obs: np.ndarray, future: Future):
        self.obs = obs
        self.rows = int(obs.shape[0])
        self.future = future


class InferenceBatcher:
    """Admission queue + dispatch loop over a policy's batched forward.

    Thread model mirrors ``serve.batching.ContinuousBatcher``:
    submitters are the actor's request-handling threads (one per env
    actor call, ``max_concurrency`` bounds them); one dedicated
    ``rtpu-rl-infer`` thread runs dispatches.  Submitters block on a
    per-request Future so actor-call ordering is preserved end to end.

    Admission: a dispatch takes everything queued at the boundary (the
    forward itself is the natural accumulation window — while one
    batch computes, the next one queues).  When fewer distinct clients
    than have registered are present, the loop waits up to
    ``max_wait_s`` for stragglers so steady-state dispatches carry the
    whole fleet's rows in one call.
    """

    def __init__(self, policy: Any, *, max_rows: int = 1024,
                 max_wait_s: float = 0.002):
        self._policy = policy
        # round up to a power of two (every full chunk of an oversized
        # request then lands EXACTLY on its bucket — no mid-stream pad
        # rows to misalign the scatter slices below) and to the bucket
        # floor (a cap below the smallest bucket would shunt every
        # dispatch through the chunking path)
        self._max_rows = max(8, 1 << max(0, int(max_rows) - 1).bit_length())
        self._buckets = inference_buckets(self._max_rows)
        self._max_wait_s = float(max_wait_s)
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queue: List[_Pending] = []
        self._stop = False
        self._client_ids: set = set()
        self._version = 0
        self._synced_at = time.monotonic()
        # stats for tests / `ray-tpu status` / bench
        self._dispatches = 0
        self._rows_total = 0
        self._occupancy_sum = 0.0
        self._batch_shapes: set = set()
        # device-plane attribution: data_wait = queue idle + straggler
        # window, device = the bucketed forward, sync = the scatter
        self._monitor = _dt.StepMonitor("rl", name="rl.inference")
        self._thread = threading.Thread(
            target=self._run, name="rtpu-rl-infer", daemon=True)
        self._thread.start()

    # -- submit side ---------------------------------------------------
    def register_client(self, client_id: Any = None) -> None:
        """An env actor announcing itself; the dispatch loop uses the
        count to wait briefly for full-fleet batches.  Idempotent per
        ``client_id`` so a recreated env actor (same slot) does not
        inflate the wait target forever."""
        with self._lock:
            if client_id is None:
                self._anon_clients = getattr(self, "_anon_clients", 0) + 1
                client_id = ("anon", self._anon_clients)
            self._client_ids.add(client_id)

    @property
    def _clients(self) -> int:
        return len(self._client_ids)

    def submit(self, obs: np.ndarray) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._stop:
                raise RuntimeError("inference batcher stopped")
            self._queue.append(_Pending(np.asarray(obs, np.float32), fut))
            self._wake.notify()
        return fut

    def __call__(self, obs: np.ndarray):
        return self.submit(obs).result()

    def set_weights(self, weights: Any, version: int) -> None:
        self._policy.set_weights(weights)
        with self._lock:
            self._version = int(version)
            self._synced_at = time.monotonic()

    def stop(self) -> None:
        with self._lock:
            self._stop = True
            self._wake.notify()
        self._thread.join(timeout=5.0)
        with self._lock:
            for p in self._queue:
                if not p.future.done():
                    p.future.set_exception(
                        RuntimeError("inference actor shutting down"))
            self._queue.clear()

    def stats(self) -> Dict[str, Any]:
        dev = self._monitor.stats()   # own lock: take outside ours
        with self._lock:
            return {
                "dispatches": self._dispatches,
                "rows": self._rows_total,
                "mean_occupancy": (self._occupancy_sum / self._dispatches)
                if self._dispatches else 0.0,
                "batch_shapes": sorted(self._batch_shapes),
                "queue_depth": len(self._queue),
                "weights_version": self._version,
                "clients": self._clients,
                "device_frac": dev["device_frac"],
                "data_wait_frac": dev["data_wait_frac"],
                "goodput_per_s": dev["goodput_per_s"],
                "phase_s": dev["phase_s"],
                "compiles": _dt.compile_count(),
            }

    # -- dispatch loop -------------------------------------------------
    def _bucket_for(self, rows: int) -> int:
        for b in self._buckets:
            if rows <= b:
                return b
        return self._buckets[-1]

    def _take_locked(self) -> List[_Pending]:
        batch: List[_Pending] = []
        rows = 0
        while self._queue and rows + self._queue[0].rows <= self._max_rows:
            p = self._queue.pop(0)
            batch.append(p)
            rows += p.rows
        if not batch and self._queue:
            # one oversized request: dispatch it alone (it will be
            # split across bucket-capped forward calls below)
            batch.append(self._queue.pop(0))
        return batch

    def _run(self) -> None:
        while True:
            t_iter = time.time()
            with self._lock:
                while not self._queue and not self._stop:
                    self._wake.wait(timeout=0.1)
                if self._stop:
                    return
                # straggler window: when the fleet is larger than what
                # is queued, a tiny wait turns k small dispatches into
                # one large one
                if self._max_wait_s > 0 and self._clients > len(self._queue):
                    deadline = time.monotonic() + self._max_wait_s
                    while len(self._queue) < self._clients \
                            and not self._stop:
                        remaining = deadline - time.monotonic()
                        if remaining <= 0:
                            break
                        self._wake.wait(timeout=remaining)
                    if self._stop:
                        return
                batch = self._take_locked()
                version = self._version
                age = time.monotonic() - self._synced_at
            if not batch:
                continue
            self._dispatch(batch, version, age,
                           data_wait_s=time.time() - t_iter)

    def _dispatch(self, batch: List[_Pending], version: int,
                  age: float, data_wait_s: float = 0.0) -> None:
        span = self._monitor.step(data_wait_s=data_wait_s)
        rows = sum(p.rows for p in batch)
        obs = np.concatenate([p.obs for p in batch], axis=0) \
            if len(batch) > 1 else batch[0].obs
        bucket = self._bucket_for(rows)
        if rows < bucket:
            pad = np.zeros((bucket - rows,) + obs.shape[1:], obs.dtype)
            padded = np.concatenate([obs, pad], axis=0)
        else:
            padded = obs
        padded_rows = padded.shape[0]
        span.dispatched()
        try:
            if padded.shape[0] > self._max_rows:
                # oversized single request: chunk at the largest bucket
                parts = []
                padded_rows = 0
                for s in range(0, padded.shape[0], self._max_rows):
                    chunk = padded[s:s + self._max_rows]
                    b = self._bucket_for(chunk.shape[0])
                    if chunk.shape[0] < b:
                        chunk = np.concatenate(
                            [chunk, np.zeros((b - chunk.shape[0],)
                                             + chunk.shape[1:],
                                             chunk.dtype)], axis=0)
                    padded_rows += chunk.shape[0]
                    parts.append(self._forward(chunk))
                actions = np.concatenate([a for a, _ in parts], axis=0)
                extras = {k: np.concatenate([e[k] for _, e in parts],
                                            axis=0)
                          for k in parts[0][1]}
                shape = (self._max_rows,)
            else:
                actions, extras = self._forward(padded)
                shape = (padded.shape[0],)
        except Exception as e:  # noqa: BLE001 — fail this batch's
            for p in batch:      # callers, keep serving the rest
                if not p.future.done():
                    p.future.set_exception(e)
            return
        span.device_done(actions)
        occupancy = rows / max(1, padded_rows)
        with self._lock:
            self._dispatches += 1
            self._rows_total += rows
            self._occupancy_sum += occupancy
            self._batch_shapes.add(shape)
        _tm.rl_inference_batch(occupancy)
        _tm.rl_weight_sync_age(age)
        start = 0
        for p in batch:
            sl = slice(start, start + p.rows)
            start += p.rows
            if p.future.done():
                continue
            p.future.set_result(
                (np.asarray(actions)[sl],
                 {k: np.asarray(v)[sl] for k, v in extras.items()},
                 version))
        span.done(tokens=float(rows), requests=float(len(batch)))

    def _forward(self, obs: np.ndarray):
        return self._policy.compute_actions(obs)


class InferenceActor:
    """Actor façade over :class:`InferenceBatcher`: holds the only
    policy replica on the acting path.  Env actors call :meth:`infer`
    (their exec thread blocks on the batch future); the learner calls
    :meth:`set_weights` with the broadcast object ref's value.

    Run with ``max_concurrency >= 2 * num_env_actors + 2`` so every env
    actor can keep a request in flight while control calls
    (set_weights / stats / ping) still land.
    """

    def __init__(self, env_spec: Any, policy_cls: type,
                 config: Dict[str, Any]):
        from ray_tpu_torch.rllib.env import make_env

        cfg = dict(config)
        # acting is latency-tolerant batched forward; the learner owns
        # the training chip unless explicitly told otherwise
        cfg.setdefault("_device", config.get("rl_inference_device")
                       or "cpu")
        env = make_env(env_spec, dict(config.get("env_config") or {}))
        self._policy = policy_cls(env.observation_space, env.action_space,
                                  cfg)
        max_rows = int(config.get("rl_inference_batch_size") or 0)
        if max_rows <= 0:
            actors = max(1, int(config.get("num_env_actors")
                                or config.get("num_rollout_workers") or 1))
            envs = int(config.get("rl_envs_per_actor")
                       or config.get("num_envs_per_worker") or 1)
            max_rows = 1
            while max_rows < 2 * actors * envs:
                max_rows *= 2
            max_rows = min(max_rows, 4096)
        self._batcher = InferenceBatcher(
            self._policy, max_rows=max_rows,
            max_wait_s=float(config.get("rl_inference_max_wait_s", 0.002)))

    def register_client(self, client_id: Any = None) -> None:
        self._batcher.register_client(client_id)

    def infer(self, obs: np.ndarray
              ) -> Tuple[np.ndarray, Dict[str, np.ndarray], int]:
        """Batched policy forward: (actions, extras, weights_version).
        ``obs`` may stack live rows and bootstrap-value rows; callers
        slice what they need (extras cover every row)."""
        return self._batcher.submit(obs).result()

    def set_weights(self, weights: Any, version: int) -> int:
        self._batcher.set_weights(weights, version)
        return int(version)

    def get_weights(self):
        return self._policy.get_weights()

    def device(self) -> str:
        """The acting policy's device (``rl_inference_device``, else the
        host)."""
        return str(self._policy.device)

    def stats(self) -> Dict[str, Any]:
        return self._batcher.stats()

    def ping(self) -> str:
        return "ok"

    def arm_failpoint(self, name: str, action: str = "raise",
                      **options) -> None:
        """Chaos tooling: arm a failpoint inside THIS actor's process
        (mirrors the serve replicas' per-replica arming)."""
        from ray_tpu_torch.util import failpoint as _fp

        _fp.arm(name, action, **options)

    def stop(self) -> None:
        self._batcher.stop()
