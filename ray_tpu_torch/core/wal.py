"""Write-ahead log for the GCS control-plane tables.

Parity: the reference makes GCS storage pluggable (Redis-backed
``gcs_table_storage``) so an acked mutation survives a head restart.
Here the durable tier is a whole-table snapshot behind ``TableStorage``
(``core/table_storage.py``) written on a *debounced* timer — so any
mutation acked inside the debounce window used to be silently lost on
SIGKILL.  This module closes that window: table-mutating GCS handlers
append a typed record to a local append-log *before replying*, and a
restarted GCS replays ``snapshot + log`` to the exact acked state.

Design:

* **Framing** — an 8-byte file header, then length-prefixed records::

      [u32 length][u32 crc32(payload)][payload]

  ``payload = pickle((seq, rtype, data))``.  The CRC makes a torn tail
  (half-written record at the moment of the crash) *detectable*:
  :meth:`recover` replays up to the last complete record, truncates the
  garbage in place, and never raises for tail damage — a crash
  mid-append must not become a crash-on-restart loop.

* **Group commit** — ``append()`` writes the record synchronously
  (``O_APPEND`` fd, page cache: the bytes survive a process SIGKILL the
  moment ``write(2)`` returns); ``await flush()`` then awaits an
  ``fsync`` *shared by every handler awaiting in the same event-loop
  window*, so a registration storm pays one disk sync per wave, not
  per actor.  The ``sync`` policy knob (``Config.gcs_wal_sync``):

  - ``"fsync"`` (default) — flush() awaits fsync: survives host power
    loss, not just process death;
  - ``"write"``  — flush() is a no-op after the write: survives
    process SIGKILL (page cache), not a host crash.  Cheaper on real
    disks; identical on tmpfs.

* **Compaction** — the GCS periodically folds the log into the
  existing ``TableStorage`` snapshot and calls :meth:`truncate`;
  records are *idempotent set-style ops* (full-value puts, not deltas)
  so replaying records the snapshot already covers (crash between
  snapshot write and truncate) converges to the same state.

Failpoints: ``gcs.wal.append_fail`` (an append raises/drops — the GCS
degrades to snapshot-only with a counter, never fails the mutation)
and ``gcs.wal.torn_tail`` (the record is half-written, modelling a
crash mid-append — replay must stop cleanly at the previous record).
"""

from __future__ import annotations

import asyncio
import logging
import os
import pickle
import struct
import zlib
from typing import Any, List, Optional, Tuple

from ray_tpu_torch.util import failpoint as _fp

logger = logging.getLogger(__name__)

#: file magic + format version; a file with a different header is not
#: ours (or from a future format) — recovery treats it as cold start
HEADER = b"RTPUWAL1"

_REC = struct.Struct("<II")  # length, crc32


class WalError(Exception):
    """A WAL append/flush failed (caller degrades to snapshot-only)."""


class WriteAheadLog:
    """Append-log of typed ``(rtype, data)`` records with CRC framing,
    torn-tail-tolerant replay, and loop-shared group-commit fsync."""

    def __init__(self, path: str, *, sync: str = "fsync"):
        self.path = path
        self.sync = sync
        self._fd: Optional[int] = None
        self._seq = 0
        # stats (surfaced via GCS debug_state + telemetry)
        self.size_bytes = 0
        self.appends = 0
        self.fsyncs = 0
        self.truncations = 0
        self.replayed_records = 0
        self.torn_tail_bytes = 0
        # group-commit state: _gen counts writes, _synced the highest
        # generation an fsync is known to cover
        self._gen = 0
        self._synced = 0
        self._inflight: Optional[asyncio.Task] = None

    # -- recovery ----------------------------------------------------------
    def recover(self) -> List[Tuple[int, str, Any]]:
        """Replay every complete record, repair a torn tail in place,
        and leave the log open for append.  Never raises for tail
        damage; an unreadable header cold-starts an empty log."""
        records: List[Tuple[int, str, Any]] = []
        good = len(HEADER)
        raw = b""
        try:
            with open(self.path, "rb") as f:
                raw = f.read()
        except OSError:
            raw = b""
        if raw[:len(HEADER)] == HEADER:
            off = len(HEADER)
            while off + _REC.size <= len(raw):
                length, crc = _REC.unpack_from(raw, off)
                body = raw[off + _REC.size:off + _REC.size + length]
                if len(body) < length or zlib.crc32(body) != crc:
                    break  # torn/corrupt tail: stop at the last good one
                try:
                    seq, rtype, data = pickle.loads(body)
                except Exception:  # noqa: BLE001 — undecodable = torn
                    break
                records.append((seq, rtype, data))
                off += _REC.size + length
                good = off
            self.torn_tail_bytes = len(raw) - good
            if self.torn_tail_bytes:
                logger.warning(
                    "WAL %s: discarding %d torn tail bytes after %d "
                    "complete records", self.path, self.torn_tail_bytes,
                    len(records))
        elif raw:
            logger.warning("WAL %s: unrecognized header; cold start",
                           self.path)
            good = len(HEADER)
            records = []
        self.replayed_records = len(records)
        self._seq = (records[-1][0] + 1) if records else 0
        # open for append, truncated to the last complete record (a
        # fresh/foreign file restarts at a clean header)
        self._fd = os.open(self.path,
                           os.O_CREAT | os.O_RDWR | os.O_APPEND, 0o644)
        if raw[:len(HEADER)] != HEADER:
            os.ftruncate(self._fd, 0)
            os.write(self._fd, HEADER)
            good = len(HEADER)
        elif good < len(raw):
            os.ftruncate(self._fd, good)
        self.size_bytes = good
        return records

    # -- append / group commit --------------------------------------------
    def append(self, rtype: str, data: Any) -> None:
        """Write one record (synchronous, ``O_APPEND``).  Raises
        :class:`WalError` on failure — the caller degrades, the
        mutation itself must never fail on WAL trouble."""
        if self._fd is None:
            raise WalError("WAL is closed")
        try:
            # failpoint: the append path fails (raise) or silently
            # loses the record (drop) — GCS degrades to snapshot-only
            if _fp.active() and _fp.failpoint("gcs.wal.append_fail"):
                raise WalError("injected append drop")
            payload = pickle.dumps((self._seq, rtype, data),
                                   protocol=pickle.HIGHEST_PROTOCOL)
            rec = _REC.pack(len(payload), zlib.crc32(payload)) + payload
            if _fp.active() and _fp.failpoint("gcs.wal.torn_tail"):
                # model a crash mid-append: half the record hits disk.
                # Replay must stop at the previous record, silently.
                os.write(self._fd, rec[:max(1, len(rec) // 2)])
                self.size_bytes += max(1, len(rec) // 2)
                self._seq += 1
                self._gen += 1
                return
            # POSIX permits short writes on regular files (ENOSPC,
            # RLIMIT_FSIZE): loop to completion or fail.  A partial
            # record followed by a raise is safe only because the
            # caller degrades (closes the log) on WalError — nothing
            # ever lands after the torn bytes, so replay stops at the
            # last complete record instead of silently dropping
            # acked records written after a tear.
            written = os.write(self._fd, rec)
            while written < len(rec):
                n = os.write(self._fd, rec[written:])
                if n <= 0:
                    raise WalError("WAL short write")
                written += n
        except WalError:
            raise
        except Exception as e:  # noqa: BLE001 — any I/O trouble degrades
            raise WalError(f"WAL append failed: {e}") from e
        self._seq += 1
        self.size_bytes += len(rec)
        self.appends += 1
        self._gen += 1

    async def flush(self) -> None:
        """Await durability of every record appended so far.  With
        ``sync="fsync"`` this awaits an fsync *round* shared with every
        concurrent awaiter (group commit); generation accounting
        guarantees a record appended after a round's syscall entered
        waits for the next round instead of riding a sync that missed
        it."""
        if self._fd is None or self.sync != "fsync":
            return
        target = self._gen
        while self._synced < target:
            t = self._inflight
            if t is not None and t.get_loop() is not \
                    asyncio.get_running_loop():
                # a previous event loop's round (tests churn loops):
                # its result can never be awaited from here — restart
                self._inflight = t = None
            if t is None:
                t = asyncio.get_running_loop().create_task(
                    self._fsync_round())
                self._inflight = t
            try:
                await asyncio.shield(t)
            except asyncio.CancelledError:
                raise
            except Exception as e:  # noqa: BLE001
                raise WalError(f"WAL fsync failed: {e}") from e

    async def _fsync_round(self) -> None:
        gen = self._gen
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(None, os.fsync, self._fd)
            self.fsyncs += 1
            self._synced = max(self._synced, gen)
        finally:
            self._inflight = None

    # -- compaction --------------------------------------------------------
    def truncate(self) -> None:
        """Drop every record — the snapshot now covers them.  Pending
        flush() awaiters resolve as durable through the snapshot."""
        if self._fd is None:
            return
        os.ftruncate(self._fd, len(HEADER))
        self.size_bytes = len(HEADER)
        self.truncations += 1
        self._synced = self._gen

    def close(self) -> None:
        if self._fd is not None:
            try:
                os.close(self._fd)
            except OSError:
                pass
            self._fd = None
