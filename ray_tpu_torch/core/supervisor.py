"""Head-process supervision: auto-respawn a died GCS.

The HA control plane can recover a
restarted GCS — snapshot + WAL replay, idempotent registration replay,
jittered client reconnect — but *something* still had to perform the
restart, and until now that something was the test harness
(``Cluster.restart_head``).  :class:`HeadSupervisor` closes the loop
for driver-owned clusters: a daemon thread watches the head subprocess
(GCS + head raylet) and, when it exits unexpectedly, respawns it on
the SAME session dir and GCS port so every surviving raylet/worker
reconnects to the address it already knows and the HA recovery
path takes over.

Respawns are bounded (``gcs_respawn_max`` per session, with a minimum
spacing) so a crash-looping head degrades loudly instead of burning
the host; an *intentional* shutdown calls :meth:`stop` first and never
respawns.
"""

from __future__ import annotations

import logging
import subprocess
import threading
import time
from typing import Any, Callable, Dict, Optional

logger = logging.getLogger(__name__)

__all__ = ["HeadSupervisor"]


class HeadSupervisor:
    """Watch a head subprocess; respawn it in place when it dies.

    ``on_respawn(proc, handshake)`` (optional) lets the owner swap its
    process handle/bookkeeping for the new head.
    """

    #: poll period for the child's liveness (cheap: one waitpid probe)
    _POLL_S = 0.5
    #: minimum spacing between respawns — a head that dies faster than
    #: this is crash-looping, not crashing
    _MIN_SPACING_S = 1.0

    def __init__(self, config: Any, session_dir: str,
                 resources: Optional[Dict[str, float]],
                 proc: subprocess.Popen, gcs_port: int,
                 on_respawn: Optional[Callable[
                     [subprocess.Popen, Dict[str, Any]], None]] = None):
        self._config = config
        self._session_dir = session_dir
        self._resources = resources
        self._proc = proc
        self._gcs_port = int(gcs_port)
        self._on_respawn = on_respawn
        self._stop = threading.Event()
        self._suspended = False
        self._lock = threading.Lock()
        # held across the monitor's whole kill-detect -> spawn -> swap
        # section; suspend() acquires it, so suspension WAITS OUT any
        # respawn already in flight (lock order: _spawn_lock -> _lock)
        self._spawn_lock = threading.Lock()
        self.respawns = 0
        self._last_respawn = 0.0
        self._thread = threading.Thread(
            target=self._run, name="rtpu-head-supervisor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        """Intentional shutdown: the next head exit is expected.  Takes
        the lock so a respawn in flight finishes swapping (or is
        discarded) before the caller proceeds to terminate the head —
        otherwise shutdown could kill the OLD proc while a freshly
        spawned head survives it, orphaned."""
        with self._lock:
            self._stop.set()

    def attach(self, proc: subprocess.Popen) -> None:
        """Point the supervisor at a head restarted by someone else
        (e.g. an explicit ``Cluster.restart_head``)."""
        with self._lock:
            self._proc = proc

    def suspend(self) -> None:
        """Pause respawning while the owner restarts the head ITSELF
        (``Cluster.restart_head``): without this the supervisor would
        race the explicit restart with its own spawn_head on the same
        GCS port.  Blocks until any respawn already in flight has
        finished (and its swap landed), so the caller proceeds with
        exclusive ownership of the port."""
        with self._spawn_lock:
            with self._lock:
                self._suspended = True

    def resume(self) -> None:
        with self._lock:
            self._suspended = False

    def _run(self) -> None:
        from ray_tpu_torch.core import node as node_mod

        max_respawns = int(getattr(self._config, "gcs_respawn_max", 3))
        while not self._stop.wait(self._POLL_S):
            # the whole detect -> spawn -> swap pass runs under
            # _spawn_lock, so suspend() (an explicit restart_head) and
            # stop() (shutdown) wait out a respawn in flight instead of
            # racing it with a second head on the same port
            with self._spawn_lock:
                if self._respawn_once(node_mod, max_respawns):
                    return

    def _respawn_once(self, node_mod, max_respawns: int) -> bool:
        """One monitor pass under ``_spawn_lock``; True = monitoring is
        over (stopped, or the respawn budget is spent on a dead head)."""
        with self._lock:
            if self._stop.is_set():
                return True
            proc = self._proc
            if self._suspended:
                return False
        if proc.poll() is None:
            return False
        if max_respawns and self.respawns >= max_respawns:
            logger.error(
                "head died (rc=%s) but the respawn budget (%d) is "
                "spent — leaving it down", proc.returncode, max_respawns)
            return True
        since = time.monotonic() - self._last_respawn
        if since < self._MIN_SPACING_S:
            time.sleep(self._MIN_SPACING_S - since)
        logger.warning(
            "head process died (rc=%s); respawning GCS on port %d "
            "(session %s)", proc.returncode, self._gcs_port,
            self._session_dir)
        try:
            new_proc, handshake = node_mod.spawn_head(
                self._config, self._session_dir, self._resources,
                gcs_port=self._gcs_port,
                die_with_parent=node_mod.safe_die_with_parent())
        except Exception:  # noqa: BLE001 — handshake timeout / spawn
            # failure: count it against the budget, retry next poll
            logger.exception("head respawn failed")
            self._last_respawn = time.monotonic()
            self.respawns += 1
            return False
        with self._lock:
            if self._stop.is_set():
                # shutdown raced the respawn: the caller already tore
                # the cluster down — don't orphan this head
                try:
                    new_proc.terminate()
                except Exception:  # noqa: BLE001
                    pass
                return True
            self._proc = new_proc
            # the owner's bookkeeping swap happens under the SAME lock
            # stop() takes, so shutdown always sees (and terminates)
            # the head that actually survives
            if self._on_respawn is not None:
                try:
                    self._on_respawn(new_proc, handshake)
                except Exception:  # noqa: BLE001 — owner bookkeeping
                    logger.exception("on_respawn callback failed")
        self.respawns += 1
        self._last_respawn = time.monotonic()
        try:
            from ray_tpu_torch.core import telemetry as _tm
            _tm.gcs_respawn()
        except Exception:  # noqa: BLE001 — telemetry is best-effort
            pass
        self._ship_dead_head_tail(proc.pid)
        # surviving raylets re-register and drivers reconnect via the
        # HA backoff loops; recovery replays snapshot + WAL
        return False

    def _ship_dead_head_tail(self, dead_pid: int) -> None:
        """Hand the dead head's flight ring to the respawned GCS so the
        incident journal records what the OLD head was doing when it
        died.  Nobody else can: the raylet ships dead workers' rings
        and the GCS reads dead raylets' rings, but when the head itself
        dies the supervisor is the only survivor that knows the pid."""
        import asyncio
        import os

        from ray_tpu_torch.core import flight_recorder as _flight
        from ray_tpu_torch.core import rpc

        async def _ship() -> None:
            for path in _flight.rings_for_pid(self._session_dir,
                                              dead_pid):
                tail = _flight.read_ring(path)
                try:
                    os.unlink(path)  # dead pid: nobody writes it again
                except OSError:
                    pass
                if tail is None or not tail["frames"]:
                    continue
                conn = await rpc.connect(
                    ("127.0.0.1", self._gcs_port), timeout=5.0)
                try:
                    await conn.call("report_flight_tail", {
                        "source": tail["source"],
                        "pid": tail["pid"],
                        "reason": "head process died",
                        "torn": tail["torn"],
                        "frames": tail["frames"][-200:],
                    }, timeout=5.0)
                finally:
                    conn.close()

        try:
            asyncio.run(asyncio.wait_for(_ship(), timeout=15.0))
        except Exception:  # noqa: BLE001 — forensics never blocks
            # the respawn path; a lost tail just means a thinner
            # incident entry
            logger.debug("dead-head flight tail ship failed",
                         exc_info=True)
