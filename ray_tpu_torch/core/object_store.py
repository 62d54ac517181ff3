"""Object store layers: native shared-memory store + in-process memory store.

Parity map (reference):
- ``SharedMemoryStore``  -> plasma store, owned by the raylet
  (``src/ray/object_manager/plasma/store.h``); here a thin wrapper over the
  C++ library in ``src/object_store.cc``.
- ``StoreClient``        -> plasma client (``plasma/client.cc``); workers
  mmap the raylet's arena file and turn {offset,size} leases into zero-copy
  memoryviews.
- ``MemoryStore``        -> the core worker's in-process store for small /
  inlined objects (``core_worker/store_provider/memory_store/memory_store.h``).
"""

from __future__ import annotations

import ctypes
import mmap
import os
import threading
from typing import Any, Dict, List, Optional, Tuple

from ray_tpu_torch.core import native
from ray_tpu_torch.core.exceptions import ObjectStoreFullError
from ray_tpu_torch.core.ids import ObjectID
from ray_tpu_torch.core.serialization import SerializedObject


class SharedMemoryStore:
    """Raylet-side owner of the shm arena (C++ allocator + LRU)."""

    def __init__(self, path: str, capacity: int, shards: int = 0):
        """``shards`` stripes the C++ metadata table (0 = library
        default): N concurrent writers doing create/seal/get/release
        only contend when their object ids hash to the same shard."""
        self._lib = native.load()
        create_sharded = getattr(self._lib, "rtpu_store_create_sharded",
                                 None)
        if create_sharded is not None:
            self._handle = create_sharded(path.encode(), capacity,
                                          max(0, int(shards)))
        else:  # stale pre-built .so
            self._handle = self._lib.rtpu_store_create(path.encode(),
                                                       capacity)
        if not self._handle:
            raise OSError(f"failed to create object store at {path}")
        self.path = path
        self.capacity = capacity
        self._mm = _map_file(path, capacity)
        self._view = memoryview(self._mm)
        # Pre-fault the arena in the background: tmpfs pages materialize
        # on FIRST touch, which otherwise lands in some client's timed
        # copy (first-touch faults halved large-put bandwidth).  Faulted
        # once here, every process mapping the file takes only cheap
        # minor faults (parity motivation: plasma pre-allocates its shm
        # pool via dlmalloc at store boot).
        self._closed = False
        # lazily-created base address for GIL-releasing range writes
        self._base_addr: Optional[int] = None
        self._base_export = None
        self._prefault_thread = threading.Thread(
            target=self._prefault, name="rtpu-prefault", daemon=True)
        self._prefault_thread.start()

    #: prefault at most this much (first-fit allocation reuses the low
    #: arena, so the head of the file is where puts land), in small
    #: chunks at a <=20% duty cycle, starting only after the boot
    #: window: populating a multi-GB arena flat-out starved a 1-core
    #: host long enough to trip cluster health checks
    _PREFAULT_CAP = 2 * 1024 ** 3
    _PREFAULT_CHUNK = 64 * 1024 * 1024
    _PREFAULT_DELAY_S = 10.0

    def _prefault(self) -> None:
        import time as time_mod

        # sleep through node bring-up (the CPU-contended window), in
        # small slices so close() never waits long on the join
        deadline = time_mod.monotonic() + self._PREFAULT_DELAY_S
        while time_mod.monotonic() < deadline:
            if self._closed:
                return
            time_mod.sleep(0.2)
        try:
            # MADV_POPULATE_WRITE (=23, Linux 5.14+; the mmap module
            # doesn't expose the constant yet, so call madvise
            # directly).  It only materializes pages — never alters
            # content — so it is safe alongside live allocations.
            arr = ctypes.c_char.from_buffer(self._mm)
            try:
                libc = ctypes.CDLL(None, use_errno=True)
                base = ctypes.addressof(arr)
                # populated pages are COMMITTED tmpfs RAM whether or not
                # the arena is ever used — bound by what the host can
                # spare (multi-node test clusters run many stores on one
                # box), not just the flat cap
                total = min(self.capacity, self._PREFAULT_CAP,
                            _mem_available() // 8)
                for off in range(0, total, self._PREFAULT_CHUNK):
                    if self._closed:
                        return
                    n = min(self._PREFAULT_CHUNK, total - off)
                    t0 = time_mod.monotonic()
                    if libc.madvise(ctypes.c_void_p(base + off),
                                    ctypes.c_size_t(n), 23) != 0:
                        return  # unsupported kernel: stay lazy
                    # <=20% duty cycle: page population is kernel-side
                    # CPU burn that would otherwise starve event loops
                    # on small hosts.  Sleep in small slices re-checking
                    # _closed: one long sleep after a slow madvise could
                    # exceed close()'s 2 s join timeout, leaving this
                    # thread madvising a mapping close() is tearing down
                    pause = 4 * (time_mod.monotonic() - t0) + 0.01
                    end = time_mod.monotonic() + pause
                    while time_mod.monotonic() < end:
                        if self._closed:
                            return
                        time_mod.sleep(0.05)
            finally:
                del arr  # release the buffer export before any close()
        except (IndexError, ValueError, OSError):
            pass  # store closed mid-prefault (or madvise unsupported)

    # -- producer side ----------------------------------------------------
    def alloc(self, object_id: ObjectID, size: int,
              hint: int = 0) -> Tuple[int, memoryview]:
        """Allocate space for the object; returns (offset, writable view).

        ``hint`` keys the allocator's per-client slab bucket: allocations
        with the same hint reuse blocks that hint freed before, so a
        producing process keeps writing through warm page-table entries
        (on fault-expensive hosts a cold 64 MiB write runs ~10x slower
        than a warm one).  0 = the raylet's own bucket (restores, pulls).
        """
        rc = self._lib.rtpu_store_put_hint(
            self._handle, object_id.binary(), size, hint)
        if rc == -2:
            raise ValueError(f"object {object_id.hex()} already exists")
        if rc < 0:
            raise ObjectStoreFullError(
                f"cannot allocate {size} bytes (capacity {self.capacity})"
            )
        return rc, self._view[rc : rc + size]

    def create(self, object_id: ObjectID, size: int,
               hint: int = 0) -> memoryview:
        return self.alloc(object_id, size, hint)[1]

    def seal(self, object_id: ObjectID) -> None:
        self._lib.rtpu_store_seal(self._handle, object_id.binary())

    def put_serialized(self, object_id: ObjectID, obj: SerializedObject) -> int:
        size = obj.total_size()
        buf = self.create(object_id, size)
        obj.write_to(buf)
        self.seal(object_id)
        return size

    def put_raw(self, object_id: ObjectID, data: bytes) -> int:
        buf = self.create(object_id, len(data))
        buf[:] = data
        self.seal(object_id)
        return len(data)

    # -- consumer side ----------------------------------------------------
    def lease(self, object_id: ObjectID) -> Optional[Tuple[int, int]]:
        """Pin the object; returns (offset, size) or None. Caller must
        eventually call release()."""
        off = ctypes.c_uint64()
        size = ctypes.c_uint64()
        ok = self._lib.rtpu_store_get(
            self._handle, object_id.binary(), ctypes.byref(off), ctypes.byref(size)
        )
        return (off.value, size.value) if ok else None

    def view(self, offset: int, size: int) -> memoryview:
        return self._view[offset : offset + size]

    def _ensure_base_addr(self) -> int:
        """Arena base address for ctypes memmoves (the export must be
        dropped before ``close()`` unmaps — see close())."""
        if self._closed:
            raise ValueError("store is closed")
        if self._base_addr is None:
            self._base_export = ctypes.c_char.from_buffer(self._mm)
            self._base_addr = ctypes.addressof(self._base_export)
        return self._base_addr

    def write_range(self, offset: int, data) -> None:
        """Copy ``data`` (bytes-like) into the arena at ``offset`` with a
        GIL-releasing ``ctypes.memmove``.  Pull transfers run this in an
        executor thread: on fault-expensive hosts a cold 5 MiB chunk
        write stalls ~15 ms, which would otherwise freeze the raylet
        event loop (and with it every lease/heartbeat) for the duration
        of an incoming transfer."""
        base = self._ensure_base_addr()
        n = len(data)
        if isinstance(data, (bytearray, memoryview)):
            # ctypes only auto-converts bytes; take the buffer address
            # (zero-copy) for the writable bytes-likes
            src = ctypes.addressof(ctypes.c_char.from_buffer(data))
            ctypes.memmove(base + offset, src, n)
        else:
            ctypes.memmove(base + offset, data, n)

    def copy_in(self, offset: int, src_addr: int, n: int) -> None:
        """memmove from a foreign address (e.g. another raylet's mapped
        arena) into this arena — GIL-releasing, executor-friendly (the
        same-host shm transfer fast path)."""
        ctypes.memmove(self._ensure_base_addr() + offset, src_addr, n)

    def get_pinned(self, object_id: ObjectID) -> Optional[memoryview]:
        lease = self.lease(object_id)
        if lease is None:
            return None
        return self.view(*lease)

    def release(self, object_id: ObjectID) -> None:
        self._lib.rtpu_store_release(self._handle, object_id.binary())

    def contains(self, object_id: ObjectID) -> bool:
        return bool(self._lib.rtpu_store_contains(self._handle, object_id.binary()))

    def delete(self, object_id: ObjectID) -> bool:
        return bool(self._lib.rtpu_store_delete(self._handle, object_id.binary()))

    def evict(self, bytes_needed: int) -> int:
        return self._lib.rtpu_store_evict(self._handle, bytes_needed)

    def lru_candidates(self, max_ids: int = 64) -> List[ObjectID]:
        out = ctypes.create_string_buffer(ObjectID.SIZE * max_ids)
        n = self._lib.rtpu_store_lru_candidates(self._handle, out, max_ids)
        raw = out.raw
        return [
            ObjectID(raw[i * ObjectID.SIZE : (i + 1) * ObjectID.SIZE])
            for i in range(n)
        ]

    def used(self) -> int:
        """Allocated bytes, lock-free (atomic read in the native
        store) — the per-allocation spill-pressure probe.  stats()
        additionally counts objects, which sweeps every shard mutex."""
        fn = getattr(self._lib, "rtpu_store_used", None)
        if fn is None:
            return self.stats()["used"]
        return fn(self._handle)

    def stats(self) -> Dict[str, int]:
        used = ctypes.c_uint64()
        cap = ctypes.c_uint64()
        num = ctypes.c_uint64()
        self._lib.rtpu_store_stats(
            self._handle, ctypes.byref(used), ctypes.byref(cap), ctypes.byref(num)
        )
        return {"used": used.value, "capacity": cap.value, "num_objects": num.value}

    #: StatsEx value layout (keep in sync with Store::StatsEx)
    _STATS_EX_FIELDS = ("used", "capacity", "num_objects",
                        "doomed_current", "doomed_total",
                        "reuse_hits", "reuse_misses",
                        "active_buckets", "bucket_free_bytes",
                        "metadata_shards", "shard_contention",
                        "alloc_contention", "alloc_stripes")

    def stats_ex(self) -> Dict[str, int]:
        """Arena telemetry: basic stats plus slab-bucket reuse hit/miss
        counters, doomed-object counts, and bucket occupancy (the
        observability half of the per-client allocator)."""
        fn = getattr(self._lib, "rtpu_store_stats_ex", None)
        if fn is None:
            return self.stats()
        out = (ctypes.c_uint64 * len(self._STATS_EX_FIELDS))()
        n = fn(self._handle, out, len(self._STATS_EX_FIELDS))
        return {name: out[i]
                for i, name in enumerate(self._STATS_EX_FIELDS[:n])}

    def spill_candidates(self, max_ids: int = 64, max_pins: int = 1
                         ) -> Optional[List[Tuple[ObjectID, int]]]:
        """Sealed objects whose pin count is at most ``max_pins``,
        oldest last-pin first, as (id, payload size) — the raylet's
        LRU-by-last-pin spill queue (its own primary pin keeps
        pin_count at 1, so max_pins=1 means no client is reading).
        Unsealed and client-pinned objects never appear.  Returns
        None on a stale pre-built .so without the symbol — NOT an
        empty list, and not the unpinned LRU queue (primaries always
        hold the raylet's pin, so an LRU-based answer would make the
        spill sweep silently spill nothing); the caller falls back to
        its own primary table."""
        fn = getattr(self._lib, "rtpu_store_spill_candidates", None)
        if fn is None:
            return None
        ids = ctypes.create_string_buffer(ObjectID.SIZE * max_ids)
        sizes = (ctypes.c_uint64 * max_ids)()
        n = fn(self._handle, ids, sizes, max_ids, max_pins)
        raw = ids.raw
        return [(ObjectID(raw[i * ObjectID.SIZE:(i + 1) * ObjectID.SIZE]),
                 sizes[i]) for i in range(n)]

    def shard_contention(self) -> List[int]:
        """Cumulative contended-lock count per metadata shard."""
        fn = getattr(self._lib, "rtpu_store_shard_contention", None)
        if fn is None:
            return []
        out = (ctypes.c_uint64 * 64)()
        n = fn(self._handle, out, 64)
        return list(out[:n])

    def bucket_occupancy(self) -> List[Tuple[int, int]]:
        """Per-bucket live allocation bytes, nonzero buckets only, as
        (bucket index, bytes) — arena occupancy by producing client."""
        fn = getattr(self._lib, "rtpu_store_bucket_used", None)
        if fn is None:
            return []
        out = (ctypes.c_uint64 * 64)()
        n = fn(self._handle, out, 64)
        return [(i, out[i]) for i in range(n) if out[i]]

    def close(self) -> None:
        if self._handle:
            self._closed = True
            # the prefault thread holds a buffer export on the mmap; let
            # it notice _closed and drop it (chunks are sub-second)
            self._prefault_thread.join(timeout=2.0)
            self._base_addr = None
            self._base_export = None  # drop the write_range buffer export
            self._view.release()
            try:
                self._mm.close()
            except BufferError:
                pass  # prefault export still live; process teardown
            self._lib.rtpu_store_destroy(self._handle)
            self._handle = None
            try:
                os.unlink(self.path)
            except OSError:
                pass


class StoreClient:
    """Worker-side zero-copy view of the raylet's arena file.

    Metadata operations (create/seal/get/release) go through the raylet
    socket; this class only turns granted {offset,size} leases into
    memoryviews over a private mapping of the same file.
    """

    def __init__(self, path: str, capacity: int):
        self.path = path
        self._mm = _map_file(path, capacity)
        self._view = memoryview(self._mm)

    def view(self, offset: int, size: int) -> memoryview:
        return self._view[offset : offset + size]

    def close(self) -> None:
        try:
            self._view.release()
            self._mm.close()
        except BufferError:
            # user code still holds zero-copy arrays over the mapping; the
            # mapping lives until those buffers are garbage collected
            pass


def _mem_available() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except (OSError, ValueError, IndexError):
        pass
    return 2 * 1024 ** 3  # unknown: assume a small host


def _map_file(path: str, capacity: int) -> mmap.mmap:
    fd = os.open(path, os.O_RDWR)
    try:
        return mmap.mmap(fd, capacity)
    finally:
        os.close(fd)


def map_arena(path: str, capacity: int) -> Tuple[mmap.mmap, int, Any]:
    """Map an existing arena file for direct memmove access (the
    same-host transfer fast path).  Returns ``(mmap, base_address,
    export)``; the caller owns teardown — drop the export reference
    before closing the mmap, or close() raises BufferError."""
    mm = _map_file(path, capacity)
    export = ctypes.c_char.from_buffer(mm)
    return mm, ctypes.addressof(export), export


class MemoryStore:
    """In-process store for small objects, with blocking waiters.

    Values are kept serialized (meta+buffer bytes) so a stored exception or
    cross-process handoff behaves identically to the shm path.
    """

    def __init__(self):
        self._lock = threading.Condition()
        self._objects: Dict[ObjectID, bytes] = {}

    def put(self, object_id: ObjectID, data: bytes) -> None:
        with self._lock:
            self._objects[object_id] = data
            self._lock.notify_all()

    def get(self, object_id: ObjectID) -> Optional[bytes]:
        with self._lock:
            return self._objects.get(object_id)

    def wait(self, object_ids: List[ObjectID], num_returns: int,
             timeout: Optional[float]) -> List[ObjectID]:
        """Block until num_returns of object_ids are present (or timeout)."""
        import time

        deadline = None if timeout is None else time.monotonic() + timeout
        with self._lock:
            while True:
                ready = [o for o in object_ids if o in self._objects]
                if len(ready) >= num_returns:
                    return ready
                remaining = None
                if deadline is not None:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        return ready
                self._lock.wait(remaining)

    def contains(self, object_id: ObjectID) -> bool:
        with self._lock:
            return object_id in self._objects

    def delete(self, object_id: ObjectID) -> None:
        with self._lock:
            self._objects.pop(object_id, None)

    def size(self) -> int:
        with self._lock:
            return len(self._objects)
