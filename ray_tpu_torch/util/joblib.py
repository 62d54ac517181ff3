"""joblib backend: scale sklearn & friends onto the cluster.

Parity: reference ``python/ray/util/joblib/`` — ``register_ray()``
installs a joblib ``ParallelBackendBase`` whose ``apply_async`` submits
cluster tasks, so ``with joblib.parallel_backend("ray_tpu_torch"): ...``
parallelizes any joblib-using library (e.g. sklearn grid search) across
nodes.
"""

from __future__ import annotations

from typing import Any, Callable

import ray_tpu_torch


def register_ray() -> None:
    from joblib.parallel import ParallelBackendBase, register_parallel_backend

    @ray_tpu_torch.remote
    def _run_joblib_batch(batch) -> Any:
        return batch()

    class RayTpuBackend(ParallelBackendBase):
        supports_timeout = True
        #: joblib batches callables itself; one task per batch
        uses_threads = False
        supports_sharedmem = False

        def configure(self, n_jobs: int = 1, parallel=None, **kwargs):
            self.parallel = parallel
            return self.effective_n_jobs(n_jobs)

        def effective_n_jobs(self, n_jobs: int) -> int:
            if n_jobs == -1:
                if not ray_tpu_torch.is_initialized():
                    ray_tpu_torch.init()
                return max(1, int(ray_tpu_torch.cluster_resources()
                                  .get("CPU", 1)))
            return max(1, n_jobs)

        def apply_async(self, func: Callable, callback=None):
            ref = _run_joblib_batch.remote(func)

            class _Future:
                def get(self, timeout=None):
                    return ray_tpu_torch.get(ref, timeout=timeout)

            fut = _Future()
            if callback is not None:
                import threading

                def waiter():
                    # only signal completion once the result truly exists
                    while True:
                        ready, _ = ray_tpu_torch.wait([ref], num_returns=1,
                                                timeout=60)
                        if ready:
                            break
                    callback(fut)

                threading.Thread(target=waiter, daemon=True).start()
            return fut

        def submit(self, func: Callable, callback=None):
            # joblib >= 1.4 name for apply_async
            return self.apply_async(func, callback)

        def abort_everything(self, ensure_ready=True):
            pass

    register_parallel_backend("ray_tpu_torch", RayTpuBackend)
