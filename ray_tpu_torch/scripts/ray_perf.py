"""Core microbenchmark suite.

Parity: reference ``python/ray/_private/ray_perf.py:93`` (``ray
microbenchmark``) — the same scenario set BASELINE.md quotes: single/
multi-client task throughput sync/async, 1:1 and n:n actor calls,
object-store put/get small objects, and put throughput in Gbps.
Numbers print one scenario per line plus a JSON summary tail.
"""

from __future__ import annotations

import json
import time
from typing import Any, Callable, Dict, List

import numpy as np

import ray_tpu_torch


def timeit(name: str, fn: Callable[[], Any], multiplier: int = 1,
           duration: float = 2.0) -> Dict[str, float]:
    # warmup
    fn()
    start = time.perf_counter()
    count = 0
    while time.perf_counter() - start < duration:
        fn()
        count += 1
    dt = time.perf_counter() - start
    rate = count * multiplier / dt
    print(f"{name:<44} {rate:>12.1f} /s")
    return {"name": name, "rate": rate}


@ray_tpu_torch.remote
def _noop():
    return None


@ray_tpu_torch.remote
def _noop_small_arg(x):
    return None


@ray_tpu_torch.remote
class _Actor:
    def noop(self):
        return None


@ray_tpu_torch.remote
class _AsyncCaller:
    """Drives a burst of task submissions from inside the cluster."""

    def do_tasks(self, n):
        ray_tpu_torch.get([_noop.remote() for _ in range(n)])
        return n

    def do_actor_calls(self, handle, n):
        ray_tpu_torch.get([handle.noop.remote() for _ in range(n)])
        return n


def main() -> List[Dict[str, float]]:
    own = not ray_tpu_torch.is_initialized()
    if own:
        ray_tpu_torch.init()
    results: List[Dict[str, float]] = []
    r = results.append

    # -- tasks ----------------------------------------------------------
    r(timeit("single client tasks sync",
             lambda: ray_tpu_torch.get(_noop.remote())))
    r(timeit("single client tasks async (batch 100)",
             lambda: ray_tpu_torch.get([_noop.remote() for _ in range(100)]),
             multiplier=100))
    callers = [_AsyncCaller.remote() for _ in range(4)]
    r(timeit("multi client tasks async (4 clients x 50)",
             lambda: ray_tpu_torch.get([c.do_tasks.remote(50) for c in callers]),
             multiplier=200))

    # -- actor calls ----------------------------------------------------
    a = _Actor.remote()
    r(timeit("1:1 actor calls sync",
             lambda: ray_tpu_torch.get(a.noop.remote())))
    r(timeit("1:1 actor calls async (batch 100)",
             lambda: ray_tpu_torch.get([a.noop.remote() for _ in range(100)]),
             multiplier=100))
    targets = [_Actor.remote() for _ in range(4)]
    r(timeit("n:n actor calls async (4x4x25)",
             lambda: ray_tpu_torch.get(
                 [c.do_actor_calls.remote(t, 25)
                  for c, t in zip(callers, targets)]),
             multiplier=100))

    # -- object store ---------------------------------------------------
    small = b"x" * 1024
    r(timeit("put small (1 KiB)", lambda: ray_tpu_torch.put(small)))
    ref_small = ray_tpu_torch.put(small)
    r(timeit("get small (1 KiB)", lambda: ray_tpu_torch.get(ref_small)))
    big = np.zeros(64 * 1024 * 1024, dtype=np.uint8)  # 64 MiB

    def put_big():
        ray_tpu_torch.put(big)
    res = timeit("put 64 MiB", put_big)
    res["gbps"] = res["rate"] * big.nbytes * 8 / 1e9
    print(f"{'put throughput':<44} {res['gbps']:>12.2f} Gbps")
    r(res)
    ref_big = ray_tpu_torch.put(big)

    def get_big():
        ray_tpu_torch.get(ref_big)
    res = timeit("get 64 MiB (zero-copy)", get_big)
    res["gbps"] = res["rate"] * big.nbytes * 8 / 1e9
    print(f"{'get throughput':<44} {res['gbps']:>12.2f} Gbps")
    r(res)

    # -- control plane --------------------------------------------------
    from ray_tpu_torch.util.placement_group import (placement_group,
                                              remove_placement_group)

    def pg_cycle():
        pg = placement_group([{"CPU": 0.01}])
        pg.wait(30)
        remove_placement_group(pg)
    r(timeit("placement group create+remove", pg_cycle))

    def actor_burst():
        # pipelined creation (how the reference's many_actors suite
        # measures actors/s — creations overlap worker spawns)
        actors = [_Actor.remote() for _ in range(16)]
        ray_tpu_torch.get([a.noop.remote() for a in actors])
        for a in actors:
            ray_tpu_torch.kill(a)
    r(timeit("actor create+first-call (pipelined x16)", actor_burst,
             multiplier=16))

    print(json.dumps({"microbenchmark": results}, default=float))
    if own:
        ray_tpu_torch.shutdown()
    return results


if __name__ == "__main__":
    main()
