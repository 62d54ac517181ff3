"""WorkerSet: a local learner-side worker plus a fleet of remote
rollout actors.

Parity: reference ``rllib/evaluation/worker_set.py`` — local worker for
learning/eval, remote ``RolloutWorker`` actors for sampling, weight
broadcast, and fault-tolerant recreation of failed workers.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

import ray_tpu_torch
from ray_tpu_torch import _port
from ray_tpu_torch.rllib.algorithm_config import learner_gpus
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker


class WorkerSet:
    def __init__(self, env_spec: Any, policy_cls: type,
                 config: Dict[str, Any]):
        self._env_spec = env_spec
        self._policy_cls = policy_cls
        self._config = config
        _port.reject_tpu_options("WorkerSet", config)
        # the learner runs on the card (num_gpus_per_learner defaults to
        # 1; without CUDA the policy raises) unless the config names the
        # CPU with num_gpus_per_learner=0
        local_cfg = dict(config)
        if not learner_gpus(config):
            local_cfg.setdefault("_device", "cpu")
        self.local_worker = RolloutWorker(env_spec, policy_cls, local_cfg,
                                          worker_index=0)
        # a share of the card for samplers that learn themselves (DD-PPO
        # sets "_num_gpus_per_worker"); other samplers stay on the host
        gpus = float(config.get("_num_gpus_per_worker", 0) or 0)
        self._remote_cls = ray_tpu_torch.remote(RolloutWorker).options(
            num_cpus=float(config.get("num_cpus_per_worker", 1)),
            **({"num_gpus": gpus} if gpus else {}))
        # every creation issues up front without awaiting readiness:
        # the whole fleet registers as one coalesced batch and brings
        # up as one pipelined lease wave on the control plane
        self.remote_workers: List[Any] = []
        for i in range(int(config.get("num_rollout_workers", 0))):
            self.remote_workers.append(self._make_remote(i + 1))

    def _make_remote(self, index: int):
        return self._remote_cls.remote(self._env_spec, self._policy_cls,
                                       self._config, index)

    # ------------------------------------------------------------------
    def sync_weights(self, *, block: bool = False) -> None:
        """Publish local weights ONCE as a single object-plane broadcast
        object; each worker's ``set_weights`` carries only the ref, and
        concurrent pulls chain on the in-flight copy (the transfer
        plane's ``_InflightPull`` broadcast-tree path), so sync cost is
        flat in worker count.  Non-blocking by default: ordered actor
        queues guarantee every call submitted after this one sees the
        new weights; pass ``block=True`` to wait for full application
        (e.g. before measuring)."""
        if not self.remote_workers:
            return
        ref = ray_tpu_torch.put(self.local_worker.get_weights())
        pending = [w.set_weights.remote(ref)
                   for w in self.remote_workers]
        if block:
            ray_tpu_torch.get(pending)

    def foreach_worker(self, fn: Callable[[RolloutWorker], Any],
                       local: bool = True) -> List[Any]:
        out = [fn(self.local_worker)] if local else []
        if self.remote_workers:
            out.extend(ray_tpu_torch.get(
                [w.apply.remote(fn) for w in self.remote_workers]))
        return out

    def probe_and_recreate(self) -> int:
        """Replace dead remote workers (reference
        ``WorkerSet.probe_unhealthy_workers``); returns replacements.

        All probes fan out concurrently and resolve under ONE bounded
        wait (was a serial 30 s-timeout get per worker, so a mostly-dead
        fleet cost minutes); replacements are issued together so they
        ride the batched registration path."""
        if not self.remote_workers:
            return 0
        probes = [w.metrics.remote() for w in self.remote_workers]
        try:
            ready, _ = ray_tpu_torch.wait(probes,
                                          num_returns=len(probes),
                                          timeout=30)
            ready_set = set(ready)
        except Exception:  # noqa: BLE001 — treat as all-dead below
            ready_set = set()
        replaced = 0
        for i, ref in enumerate(probes):
            ok = False
            if ref in ready_set:
                try:
                    ray_tpu_torch.get(ref, timeout=5)
                    ok = True
                except Exception:  # noqa: BLE001 — dead worker
                    pass
            if not ok:
                self.remote_workers[i] = self._make_remote(i + 1)
                replaced += 1
        if replaced:
            self.sync_weights()
        return replaced

    def stop(self) -> None:
        for w in self.remote_workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:
                pass
        self.remote_workers = []
