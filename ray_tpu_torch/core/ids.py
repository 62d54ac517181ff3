"""Binary identifiers for jobs, tasks, actors, objects, nodes, and workers.

Design parity: the reference encodes lineage inside its IDs (reference
``src/ray/common/id.h`` — ObjectID = TaskID + index, TaskID embeds ActorID,
ActorID embeds JobID).  We keep that property because object reconstruction
and the ownership protocol depend on being able to recover "which task made
this object" from the ID alone, without a directory lookup.

Layout (bytes):

    JobID    : 4
    ActorID  : 4 (job) + 12 (unique)               = 16
    TaskID   : 16 (actor-or-padding) + 8 (unique)  = 24
    ObjectID : 24 (task) + 4 (big-endian index)    = 28
    NodeID   : 16 random
    WorkerID : 16 random
    PlacementGroupID : 4 (job) + 14 (unique)       = 18

Index semantics for ObjectID match the reference: return objects of a task
use indices 1..n; objects created by ``put`` use a dedicated put-index space
(high bit set) so both can be derived from the producing TaskID.
"""

from __future__ import annotations

import os
import struct
import threading

_NIL_BYTE = b"\xff"


class _EntropyPool:
    """Buffered os.urandom: one getrandom(2) syscall per 1024 draws.

    A single urandom(8) measured ~12 us — the single largest line item in
    task-id generation on nop-task storms.  Thread-safe; the pool is
    refilled wholesale so slices never tear.
    """

    _CHUNK = 8192

    def __init__(self):
        self._lock = threading.Lock()
        self._buf = b""
        self._pos = 0

    def take(self, n: int) -> bytes:
        with self._lock:
            if self._pos + n > len(self._buf):
                self._buf = os.urandom(max(self._CHUNK, n))
                self._pos = 0
            out = self._buf[self._pos:self._pos + n]
            self._pos += n
            return out


_entropy = _EntropyPool()


def _fork_reset():
    # children must not replay the parent's buffered entropy (id collisions)
    global _entropy
    _entropy = _EntropyPool()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_fork_reset)


class BaseID:
    """An immutable, hashable, fixed-width binary ID."""

    SIZE = 0
    __slots__ = ("_bytes", "_hash", "_hex")

    def __init__(self, id_bytes: bytes):
        if len(id_bytes) != self.SIZE:
            raise ValueError(
                f"{type(self).__name__} requires {self.SIZE} bytes, "
                f"got {len(id_bytes)}"
            )
        self._bytes = bytes(id_bytes)
        self._hash = hash((type(self).__name__, self._bytes))
        self._hex: "str | None" = None

    @classmethod
    def from_random(cls) -> "BaseID":
        return cls(_entropy.take(cls.SIZE))

    @classmethod
    def nil(cls) -> "BaseID":
        return cls(_NIL_BYTE * cls.SIZE)

    @classmethod
    def from_hex(cls, hex_str: str) -> "BaseID":
        return cls(bytes.fromhex(hex_str))

    def binary(self) -> bytes:
        return self._bytes

    def hex(self) -> str:
        # cached: id hexes are compared on hot paths (owner checks run
        # once per get; profiling showed 6+ hex() calls per task)
        h = self._hex
        if h is None:
            h = self._hex = self._bytes.hex()
        return h

    def is_nil(self) -> bool:
        return self._bytes == _NIL_BYTE * self.SIZE

    def __hash__(self) -> int:
        return self._hash

    def __eq__(self, other) -> bool:
        return type(other) is type(self) and other._bytes == self._bytes

    def __lt__(self, other) -> bool:
        return self._bytes < other._bytes

    def __repr__(self) -> str:
        return f"{type(self).__name__}({self._bytes.hex()})"

    def __reduce__(self):
        return (type(self), (self._bytes,))


class JobID(BaseID):
    SIZE = 4
    __slots__ = ()

    @classmethod
    def from_int(cls, value: int) -> "JobID":
        return cls(struct.pack(">I", value))

    def int_value(self) -> int:
        return struct.unpack(">I", self._bytes)[0]


class NodeID(BaseID):
    SIZE = 16
    __slots__ = ()


class WorkerID(BaseID):
    SIZE = 16
    __slots__ = ()


class ActorID(BaseID):
    SIZE = 16
    __slots__ = ()

    @classmethod
    def of(cls, job_id: JobID) -> "ActorID":
        return cls(job_id.binary() + _entropy.take(cls.SIZE - JobID.SIZE))

    def job_id(self) -> JobID:
        return JobID(self._bytes[: JobID.SIZE])


class TaskID(BaseID):
    SIZE = 24
    UNIQUE = 8
    __slots__ = ()

    @classmethod
    def for_normal_task(cls, job_id: JobID) -> "TaskID":
        pad = _NIL_BYTE * (ActorID.SIZE - JobID.SIZE)
        return cls(job_id.binary() + pad + _entropy.take(cls.UNIQUE))

    @classmethod
    def for_actor_task(cls, actor_id: ActorID) -> "TaskID":
        return cls(actor_id.binary() + _entropy.take(cls.UNIQUE))

    @classmethod
    def for_driver(cls, job_id: JobID) -> "TaskID":
        """The implicit root task of a driver process."""
        pad = _NIL_BYTE * (ActorID.SIZE - JobID.SIZE)
        return cls(job_id.binary() + pad + b"\x00" * cls.UNIQUE)

    def actor_id(self) -> ActorID:
        return ActorID(self._bytes[: ActorID.SIZE])

    def job_id(self) -> JobID:
        return JobID(self._bytes[: JobID.SIZE])


# High bit of the 4-byte index marks "created by put" rather than "returned
# by the task" — same split as the reference's put/return index spaces.
_PUT_INDEX_FLAG = 0x80000000


class ObjectID(BaseID):
    SIZE = 28
    __slots__ = ()

    @classmethod
    def for_task_return(cls, task_id: TaskID, index: int) -> "ObjectID":
        assert 0 < index < _PUT_INDEX_FLAG
        return cls(task_id.binary() + struct.pack(">I", index))

    @classmethod
    def for_put(cls, task_id: TaskID, put_index: int) -> "ObjectID":
        assert 0 < put_index < _PUT_INDEX_FLAG
        return cls(task_id.binary() + struct.pack(">I", put_index | _PUT_INDEX_FLAG))

    def task_id(self) -> TaskID:
        return TaskID(self._bytes[: TaskID.SIZE])

    def job_id(self) -> JobID:
        return self.task_id().job_id()

    def index(self) -> int:
        return struct.unpack(">I", self._bytes[TaskID.SIZE :])[0] & ~_PUT_INDEX_FLAG

    def is_put(self) -> bool:
        raw = struct.unpack(">I", self._bytes[TaskID.SIZE :])[0]
        return bool(raw & _PUT_INDEX_FLAG)


class PlacementGroupID(BaseID):
    SIZE = 18
    __slots__ = ()

    @classmethod
    def of(cls, job_id: JobID) -> "PlacementGroupID":
        return cls(job_id.binary() + _entropy.take(cls.SIZE - JobID.SIZE))

    def job_id(self) -> JobID:
        return JobID(self._bytes[: JobID.SIZE])


class _Counter:
    """Thread-safe monotonically increasing counter starting at 1."""

    def __init__(self):
        self._value = 0
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            self._value += 1
            return self._value
