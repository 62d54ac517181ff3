"""Chaos-testing helpers.

Parity: reference ``python/ray/_private/test_utils.py`` —
``NodeKillerActor`` (:1301) / ``_kill_raylet`` (:1377) used by
``test_chaos.py``'s ``set_kill_interval`` (:27): SIGKILL random worker
raylets on an interval while a workload runs, asserting the job still
completes through retries + lineage reconstruction.

Runs as a driver-side thread rather than an actor (killing the node an
actor lives on from inside it is the one placement we can't allow).
"""

from __future__ import annotations

import random
import threading
import time
from typing import List, Optional


class NodeKiller:
    """Kills random *worker* nodes of a ``cluster_utils.Cluster`` on an
    interval; the head is never a target."""

    def __init__(self, cluster, *, kill_interval_s: float = 1.0,
                 max_kills: Optional[int] = None,
                 seed: Optional[int] = None):
        self.cluster = cluster
        self.kill_interval_s = kill_interval_s
        self.max_kills = max_kills
        self.killed: List[str] = []
        self._rng = random.Random(seed)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _loop(self) -> None:
        while not self._stop.wait(self.kill_interval_s):
            if self.max_kills is not None and \
                    len(self.killed) >= self.max_kills:
                return
            victims = [n for n in self.cluster.worker_nodes
                       if n.proc.poll() is None]
            if not victims:
                continue
            node = self._rng.choice(victims)
            node_id = node.handshake["node_id"][:12]
            node.kill()  # SIGKILL — no graceful teardown, like the chaos suite
            self.killed.append(node_id)

    def start(self) -> "NodeKiller":
        self._thread = threading.Thread(target=self._loop,
                                        name="node-killer", daemon=True)
        self._thread.start()
        return self

    def stop(self) -> List[str]:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)
        return list(self.killed)


class HeadKiller:
    """Kill-mid-storm tooling (docs/ha.md): SIGKILLs the HEAD node the
    moment a driver-observable condition holds — e.g. "the GCS has
    acked at least K registrations of my fleet" — so chaos tests and
    ``bench_ha.py`` land the kill deterministically *inside* a
    registration storm instead of sleeping and hoping.

    The trigger runs on a watcher thread polling ``predicate()`` (any
    callable; typically a closure over ``gcs_call("debug_state")`` or
    ``list_actors``); the kill is a plain SIGKILL — no snapshot flush,
    no goodbyes.  ``killed_at`` records the wall-clock kill time so the
    caller can measure reconvergence (kill → all-actors-ALIVE)."""

    def __init__(self, cluster, predicate, *,
                 poll_interval_s: float = 0.01):
        self.cluster = cluster
        self.predicate = predicate
        self.poll_interval_s = poll_interval_s
        self.killed_at: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                fire = bool(self.predicate())
            except Exception:  # noqa: BLE001 — mid-storm races are fine
                fire = False
            if fire:
                head = self.cluster.head
                if head is not None and head.proc.poll() is None:
                    head.proc.kill()  # SIGKILL, mid-storm
                    head.proc.wait(timeout=10)
                self.killed_at = time.monotonic()
                return
            self._stop.wait(self.poll_interval_s)

    def start(self) -> "HeadKiller":
        self._thread = threading.Thread(target=self._loop,
                                        name="head-killer", daemon=True)
        self._thread.start()
        return self

    def join(self, timeout: float = 30.0) -> float:
        """Wait for the kill to have happened; returns the kill time."""
        self._thread.join(timeout=timeout)
        if self.killed_at is None:
            raise TimeoutError("HeadKiller predicate never fired")
        return self.killed_at

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)


def wait_for_condition(predicate, timeout: float = 30.0,
                       retry_interval_ms: float = 100.0) -> None:
    """Poll until predicate() is truthy (reference ``wait_for_condition``)."""
    deadline = time.monotonic() + timeout
    last_exc: Optional[BaseException] = None
    while time.monotonic() < deadline:
        try:
            if predicate():
                return
        except Exception as e:  # noqa: BLE001
            last_exc = e
        time.sleep(retry_interval_ms / 1000.0)
    msg = f"condition not met within {timeout}s"
    if last_exc is not None:
        raise TimeoutError(msg) from last_exc
    raise TimeoutError(msg)
