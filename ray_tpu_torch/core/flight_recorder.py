"""Crash-surviving flight recorder: the last seconds of every process.

Every process of the fleet (GCS, raylet, worker, driver) keeps a
bounded mmap-backed ring file in the session dir recording its recent
state transitions — span completions, the warning-level log tail, task
start/finish with task/actor identity, lease grants, serve batch
steps, WAL positions.  The in-process telemetry buffers drain on a
~2-5 s flush loop, so the most interesting seconds of any incident are
exactly the ones a SIGKILL destroys; the ring is a *file*, so its
dirty pages survive the process and a surviving raylet (or the head
supervisor, for a raylet/GCS death) can read the dead process's tail
and ship it to the GCS incident journal (core/gcs.py).

Disciplines (same contracts as the profiler and the WAL):

* **Off the hot path**: ``record()`` with the recorder disabled is one
  module-global load + ``None`` test.  Enabled, it is one struct pack
  + crc32 + mmap slice copy under a lock (~1-2 us) — no syscall, no
  fsync (mmap dirty pages of a file survive SIGKILL; only an OS crash
  loses them, which is out of scope).
* **Fixed-size binary frames**: 256 bytes each, CRC32-framed like the
  WAL.  A SIGKILL mid-copy leaves exactly one torn frame, which the
  reader detects by CRC and drops — "loses at most one frame".
* **Catalogued vocabulary**: every event type written anywhere in the
  tree must be declared in :data:`EVENT_TYPES` below; the rtpu-check
  ``flight-vocab`` rule (tools/check/project.py) enforces it the way
  the failpoint registry enforces site documentation.

Ring file anatomy (``<session_dir>/flight/flight-<source>-<pid>.ring``)::

    header (32 B): magic RTPUFLT1 | u32 frame_size | u32 nframes
                   | u32 pid | 12 B source (NUL-padded)
    frame (256 B): u32 crc32(rest) | u64 seq | f64 ts | u8 type
                   | u16 detail_len | detail bytes | zero pad

Frames are written at ``seq % nframes``; the reader collects every
CRC-valid frame and sorts by seq, so ordering survives the wrap.  One
ring per process: in the head process (GCS + raylet co-located) the
first ``init`` wins and both planes share the ring — the source label
names the initializer, the pid is what death-path readers key on.
"""

from __future__ import annotations

import logging
import mmap
import os
import struct
import threading
import zlib
from typing import Any, Dict, List, Optional

logger = logging.getLogger(__name__)

__all__ = ["EVENT_TYPES", "init", "enabled", "record", "stats", "close",
           "ring_path", "rings_for_pid", "read_ring"]

#: the complete vocabulary of recordable event types.  Writers pass one
#: of these keys to :func:`record`; the ``flight-vocab`` static rule
#: rejects any literal not declared here, so the postmortem renderer
#: (and anyone reading a ring) can rely on this table as the single
#: legend.  Order matters: the frame stores the type as an index into
#: the sorted key list, so renames are safe but the set is append-only
#: within a session.
EVENT_TYPES: Dict[str, str] = {
    "alert": "GCS-side alert transition (rule, from -> to)",
    "batch_step": "serve continuous-batching decode step "
                  "(deployment, batch size, step ms)",
    "lease_grant": "raylet granted a worker lease (pid, resources)",
    "log": "WARNING-or-worse log record tail",
    "mark": "free-form state transition (boot, shutdown, recovery)",
    "node_dead": "GCS marked a node dead (node id, reason)",
    "span": "trace span completion (name, status, duration)",
    "task_finish": "executor finished a task body (status)",
    "task_start": "executor began a task body "
                  "(function, task/actor/job identity)",
    "task_submit": "owner submitted a task (function, task id)",
    "wal_append": "GCS WAL position after an append (type, seq, bytes)",
    "worker_dead": "raylet observed a worker death (pid, reason)",
}

MAGIC = b"RTPUFLT1"
FRAME_SIZE = 256
_HDR = struct.Struct("<8sIII12s")       # magic, frame, nframes, pid, source
_FRM = struct.Struct("<IQdBH")          # crc, seq, ts, type idx, detail len
_DETAIL_MAX = FRAME_SIZE - _FRM.size
_TYPE_LIST = sorted(EVENT_TYPES)
_TYPE_IDX = {t: i for i, t in enumerate(_TYPE_LIST)}


def ring_path(session_dir: str, source: str, pid: Optional[int] = None
              ) -> str:
    return os.path.join(session_dir, "flight",
                        f"flight-{source}-{pid or os.getpid()}.ring")


class FlightRecorder:
    """One process's ring writer.  Thread-safe; never raises out of
    :meth:`record` (forensics must not take the plane down)."""

    def __init__(self, source: str, session_dir: str,
                 ring_bytes: int = 1 << 18):
        self.source = source
        self.session_dir = session_dir
        self.nframes = max(16, (int(ring_bytes) - _HDR.size) // FRAME_SIZE)
        self.path = ring_path(session_dir, source)
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        size = _HDR.size + self.nframes * FRAME_SIZE
        fd = os.open(self.path, os.O_CREAT | os.O_RDWR | os.O_TRUNC, 0o644)
        try:
            os.ftruncate(fd, size)
            self._mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        self._mm[:_HDR.size] = _HDR.pack(
            MAGIC, FRAME_SIZE, self.nframes, os.getpid(),
            source.encode()[:12].ljust(12, b"\0"))
        self._lock = threading.Lock()
        self._seq = 0
        self._scratch = bytearray(FRAME_SIZE)

    def record(self, etype: str, detail: str = "") -> None:
        import time
        idx = _TYPE_IDX.get(etype)
        if idx is None:  # undeclared type: flight-vocab catches it in CI
            idx = _TYPE_IDX["mark"]
            detail = f"{etype}: {detail}"
        payload = detail.encode("utf-8", "replace")[:_DETAIL_MAX]
        buf = self._scratch
        try:
            with self._lock:
                seq = self._seq
                self._seq = seq + 1
                _FRM.pack_into(buf, 0, 0, seq, time.time(), idx,
                               len(payload))
                buf[_FRM.size:_FRM.size + len(payload)] = payload
                end = _FRM.size + len(payload)
                if end < FRAME_SIZE:
                    buf[end:] = b"\0" * (FRAME_SIZE - end)
                struct.pack_into("<I", buf, 0, zlib.crc32(buf[4:]))
                off = _HDR.size + (seq % self.nframes) * FRAME_SIZE
                self._mm[off:off + FRAME_SIZE] = buf
        except (ValueError, OSError):  # mmap closed mid-shutdown
            pass

    def stats(self) -> Dict[str, Any]:
        return {"path": self.path, "frames_recorded": self._seq,
                "nframes": self.nframes}

    def close(self, unlink: bool = False) -> None:
        """``unlink=True`` on graceful exit: a surviving ring for a
        dead pid then MEANS a crash — death-path readers need no
        reason heuristics."""
        try:
            self._mm.close()
        except (ValueError, OSError):
            pass
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass


# -- module singleton (one ring per process; first init wins) -----------
_recorder: Optional[FlightRecorder] = None
_init_args: Optional[tuple] = None
_log_handler: Optional[logging.Handler] = None


class _FlightLogHandler(logging.Handler):
    """WARNING+ log tail into the ring — the last log lines of a dead
    process are usually the first thing a postmortem wants."""

    def emit(self, rec: logging.LogRecord) -> None:
        r = _recorder
        if r is None:
            return
        try:
            r.record("log", f"{rec.levelname} {rec.name}: "
                            f"{rec.getMessage()}")
        except Exception:  # noqa: BLE001 — never recurse into logging
            pass


def init(source: str, session_dir: Optional[str],
         config: Any = None) -> None:
    """Open this process's ring.  First init wins (the head process
    hosts both the GCS and a raylet — they share one per-process ring);
    disabled by ``flight_recorder_enabled=False``, in which case the
    hot path stays a single None test."""
    global _recorder, _init_args
    if _recorder is not None or not session_dir:
        return
    _init_args = (source, session_dir, config)
    if config is not None and not getattr(config,
                                          "flight_recorder_enabled", True):
        return
    _attach(source, session_dir, config)


def _attach(source: str, session_dir: str, config: Any) -> None:
    global _recorder, _log_handler
    try:
        rec = FlightRecorder(
            source, session_dir,
            ring_bytes=int(getattr(config, "flight_ring_bytes", 1 << 18)
                           if config is not None else 1 << 18))
    except OSError:
        logger.exception("flight recorder init failed; disabled")
        return
    _recorder = rec
    rec.record("mark", f"{source} flight recorder online")
    if _log_handler is None:
        _log_handler = _FlightLogHandler(level=logging.WARNING)
        logging.getLogger().addHandler(_log_handler)
    # span completions ride the ring too (only costs anything while
    # tracing is enabled; the sink itself is one function pointer)
    from ray_tpu_torch.core import tracing as _trace
    _trace.set_span_sink(_span_sink)


def _span_sink(span: Dict[str, Any]) -> None:
    r = _recorder
    if r is None:
        return
    dur_ms = (span.get("end", 0.0) - span.get("start", 0.0)) * 1e3
    r.record("span", f"{span.get('name')} {span.get('status', 'ok')} "
                     f"{dur_ms:.2f}ms")


def enabled() -> bool:
    return _recorder is not None


def record(etype: str, detail: str = "") -> None:
    """Hot-path write: no-op (one None test) when the recorder is off."""
    r = _recorder
    if r is not None:
        r.record(etype, detail)


def stats() -> Optional[Dict[str, Any]]:
    r = _recorder
    return r.stats() if r is not None else None


def close(unlink: bool = False) -> None:
    global _recorder
    r, _recorder = _recorder, None
    if r is not None:
        r.close(unlink=unlink)


def _reset_for_tests(force: Optional[bool] = None) -> None:
    """Bench/test toggle (same contract as tracing._reset_for_tests):
    ``force=False`` detaches the recorder (off block), ``force=True``
    re-attaches it on the saved init args, ``None`` restores the
    config-driven state."""
    global _recorder
    if force is False:
        r, _recorder = _recorder, None
        if r is not None:
            r.close()
        return
    if _recorder is None and _init_args is not None:
        source, session_dir, config = _init_args
        if force or config is None or getattr(
                config, "flight_recorder_enabled", True):
            _attach(source, session_dir, config)


# -- death-path readers --------------------------------------------------

def rings_for_pid(session_dir: str, pid: int) -> List[str]:
    """Ring files a dead process with this pid left behind."""
    d = os.path.join(session_dir, "flight")
    try:
        names = os.listdir(d)
    except OSError:
        return []
    suffix = f"-{pid}.ring"
    return sorted(os.path.join(d, n) for n in names
                  if n.startswith("flight-") and n.endswith(suffix))


def read_ring(path: str, limit: int = 200) -> Optional[Dict[str, Any]]:
    """Decode a ring file: every CRC-valid frame, seq-ordered, torn
    frames counted and dropped (the ring-file analogue of the WAL's
    torn-tail truncation).  Returns None for a missing/foreign file."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return None
    if len(blob) < _HDR.size:
        return None
    magic, frame_size, nframes, pid, source = _HDR.unpack_from(blob, 0)
    if magic != MAGIC or frame_size != FRAME_SIZE:
        return None
    frames: List[Dict[str, Any]] = []
    torn = 0
    for i in range(min(nframes, (len(blob) - _HDR.size) // FRAME_SIZE)):
        off = _HDR.size + i * FRAME_SIZE
        frame = blob[off:off + FRAME_SIZE]
        crc, seq, ts, idx, dlen = _FRM.unpack_from(frame, 0)
        if crc == 0 and seq == 0 and ts == 0.0 and dlen == 0 and idx == 0 \
                and frame[_FRM.size:] == b"\0" * (FRAME_SIZE - _FRM.size):
            continue  # never-written slot
        if crc != zlib.crc32(frame[4:]) or dlen > _DETAIL_MAX:
            torn += 1
            continue
        frames.append({
            "seq": seq, "ts": ts,
            "type": _TYPE_LIST[idx] if idx < len(_TYPE_LIST) else "mark",
            "detail": frame[_FRM.size:_FRM.size + dlen].decode(
                "utf-8", "replace"),
        })
    frames.sort(key=lambda fr: fr["seq"])
    return {"source": source.rstrip(b"\0").decode("utf-8", "replace"),
            "pid": pid, "torn": torn, "frames": frames[-limit:]}
