"""Structured event framework.

Parity: reference ``src/ray/util/event.h`` (``EventManager``/``RayEvent``
— structured, severity-labelled events appended as JSON lines to
per-source files under the session dir) + ``dashboard/modules/event``
(cluster-wide surfacing).  Here every emitting process writes its own
``logs/events/event_<SOURCE>.log`` file AND best-effort pushes the record
to the GCS, whose ring buffer feeds the state API
(``list_cluster_events``), the dashboard ``/events`` endpoint, and the
CLI.

Usage (any process)::

    from ray_tpu_torch.util import event
    event.init("RAYLET", session_dir, gcs_conn=conn, loop=loop)
    event.emit(event.ERROR, "NODE_DEAD", "node 4f.. health timeout",
               node_id="4f..")
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

DEBUG = "DEBUG"
INFO = "INFO"
WARNING = "WARNING"
ERROR = "ERROR"
FATAL = "FATAL"


class EventManager:
    def __init__(self):
        self._lock = threading.Lock()
        self._source = "UNKNOWN"
        self._path: Optional[str] = None
        self._gcs_conn = None
        self._loop = None

    def init(self, source: str, session_dir: Optional[str] = None,
             gcs_conn=None, loop=None) -> None:
        with self._lock:
            self._source = source
            self._gcs_conn = gcs_conn
            self._loop = loop
            if session_dir:
                d = os.path.join(session_dir, "logs", "events")
                os.makedirs(d, exist_ok=True)
                self._path = os.path.join(d, f"event_{source}.log")

    def emit(self, severity: str, label: str, message: str,
             **fields: Any) -> Dict[str, Any]:
        record = {
            "timestamp": time.time(),
            "severity": severity,
            "label": label,
            "message": message,
            "source_type": self._source,
            "pid": os.getpid(),
            "custom_fields": fields,
        }
        line = json.dumps(record)
        with self._lock:
            if self._path:
                try:
                    with open(self._path, "a") as f:
                        f.write(line + "\n")
                except OSError:
                    pass
            conn, loop = self._gcs_conn, self._loop
        if conn is not None and loop is not None:
            try:
                loop.call_soon_threadsafe(
                    conn.push, "cluster_events", record)
            except Exception:  # loop closed — file record stands
                pass
        return record


_manager = EventManager()


def init(source: str, session_dir: Optional[str] = None, gcs_conn=None,
         loop=None) -> None:
    _manager.init(source, session_dir, gcs_conn=gcs_conn, loop=loop)


def emit(severity: str, label: str, message: str, **fields: Any
         ) -> Dict[str, Any]:
    return _manager.emit(severity, label, message, **fields)


def read_event_file(session_dir: str, source: str
                    ) -> List[Dict[str, Any]]:
    path = os.path.join(session_dir, "logs", "events",
                        f"event_{source}.log")
    out: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if line:
                    try:
                        out.append(json.loads(line))
                    except json.JSONDecodeError:
                        pass
    except FileNotFoundError:
        pass
    return out
