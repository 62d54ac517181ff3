"""Pluggable persistence for the GCS tables.

Parity: reference ``src/ray/gcs/gcs_server/gcs_table_storage.h:261``
(typed table storage behind the GCS) over
``store_client/redis_store_client.h:28`` / ``in_memory_store_client.h``
— the GCS writes through an interface and deployments choose the
backend.  Here:

- ``memory``  — no persistence (explicit ephemeral clusters, tests),
- ``file``    — pickle snapshot in the session dir (same-host restart),
- ``<uri>``   — ``ray_tpu_torch.air.storage`` URI (``file://`` shared
  filesystem today, cloud schemes via ``register_storage``) — survives
  losing the head's DISK/HOST, the gap the session-dir file can't cover.

The unit of storage is the whole-table snapshot dict: the GCS state is
small (control metadata, not data-plane objects), and snapshot-at-once
keeps crash atomicity trivial (single rename/replace).
"""

from __future__ import annotations

import logging
import os
import pickle
import time
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


class TableStorage:
    """Interface: load the last snapshot, store a new one.

    ``store`` returns True on success — the GCS only truncates its
    write-ahead log against a snapshot that actually landed; failures
    are also counted (``ray_tpu_gcs_persist_failures_total``) and
    surfaced through ``debug_state``/``ray-tpu status`` instead of
    being a log line nobody reads.
    """

    #: wall-clock time of the last successful store (0 = never)
    last_persist_ts: float = 0.0
    #: store() failures since boot (mirrors the metrics counter)
    persist_failures: int = 0

    def load(self) -> Optional[Dict[str, Any]]:
        raise NotImplementedError

    def store(self, snapshot: Dict[str, Any]) -> bool:
        raise NotImplementedError

    def describe(self) -> str:
        return type(self).__name__

    def _stored_ok(self) -> bool:
        self.last_persist_ts = time.time()
        return True

    def _store_failed(self, e: BaseException) -> bool:
        self.persist_failures += 1
        logger.warning("GCS table persistence failed on %s: %s",
                       self.describe(), e)
        from ray_tpu_torch.core import telemetry as _tm
        _tm.gcs_persist_failure(type(self).__name__)
        return False


class InMemoryTableStorage(TableStorage):
    """No persistence: a restarted GCS cold-starts (reference
    in-memory store client)."""

    def load(self) -> Optional[Dict[str, Any]]:
        return None

    def store(self, snapshot: Dict[str, Any]) -> bool:
        return True


class FileTableStorage(TableStorage):
    """Session-dir pickle with atomic replace (same-host restarts)."""

    def __init__(self, path: str):
        self.path = path

    def load(self) -> Optional[Dict[str, Any]]:
        if not os.path.exists(self.path):
            return None
        try:
            with open(self.path, "rb") as f:
                return pickle.load(f)
        except Exception as e:  # noqa: BLE001 — a torn snapshot cold-starts
            logger.warning("GCS snapshot unreadable (%s); cold start", e)
            return None

    def store(self, snapshot: Dict[str, Any]) -> bool:
        # single atomic-write implementation lives in air.storage
        from ray_tpu_torch.air.storage import FileStorage as _FS
        try:
            _FS().write_bytes(self.path, pickle.dumps(snapshot))
        except OSError as e:
            return self._store_failed(e)
        return self._stored_ok()

    def describe(self) -> str:
        return f"file:{self.path}"


class URITableStorage(TableStorage):
    """Durable storage through ``ray_tpu_torch.air.storage`` — a head-host
    loss is survivable when the URI lives off-host."""

    def __init__(self, uri: str):
        from ray_tpu_torch.air import storage
        self._storage = storage
        self.uri = storage.join(uri, "gcs_tables.pkl")

    def load(self) -> Optional[Dict[str, Any]]:
        try:
            if not self._storage.exists(self.uri):
                return None
            return pickle.loads(self._storage.read_bytes(self.uri))
        except Exception as e:  # noqa: BLE001
            logger.warning("GCS table storage unreadable (%s); cold start",
                           e)
            return None

    def store(self, snapshot: Dict[str, Any]) -> bool:
        try:
            self._storage.write_bytes(self.uri, pickle.dumps(snapshot))
        except Exception as e:  # noqa: BLE001
            return self._store_failed(e)
        return self._stored_ok()

    def describe(self) -> str:
        return self.uri


def make_table_storage(spec: Optional[str],
                       default_path: Optional[str]) -> TableStorage:
    """Resolve the configured backend (``Config.gcs_table_storage``).

    ``""``/``"file"`` → session-dir file (when a path is known),
    ``"memory"`` → ephemeral, anything with ``://`` → URI storage.
    """
    if spec in (None, "", "file"):
        if default_path:
            return FileTableStorage(default_path)
        return InMemoryTableStorage()
    if spec == "memory":
        return InMemoryTableStorage()
    if "://" in spec:
        return URITableStorage(spec)
    return FileTableStorage(spec)
