"""Exception hierarchy surfaced by the public API.

Parity: reference ``python/ray/exceptions.py``.  Errors that happen inside a
remote task are captured, serialized, and re-raised at ``get`` time wrapped
in :class:`TaskError`, preserving the remote traceback as text.
"""

from __future__ import annotations

import traceback


class RayTpuError(Exception):
    """Base class for all framework errors."""


class TaskError(RayTpuError):
    """A remote task raised an exception; re-raised at ``get`` time.

    Carries the remote traceback as formatted text (the remote frames are
    from another process and cannot be re-materialized).
    """

    def __init__(self, cause: BaseException | None, remote_traceback: str = "",
                 task_desc: str = ""):
        self.cause = cause
        self.remote_traceback = remote_traceback
        self.task_desc = task_desc
        super().__init__(str(cause))

    def __str__(self) -> str:
        out = f"Task {self.task_desc} failed: {self.cause!r}"
        if self.remote_traceback:
            out += "\n--- remote traceback ---\n" + self.remote_traceback
        return out

    @classmethod
    def from_exception(cls, exc: BaseException, task_desc: str = "") -> "TaskError":
        tb = "".join(traceback.format_exception(type(exc), exc, exc.__traceback__))
        return cls(exc, tb, task_desc)


class TaskCancelledError(TaskError):
    """The task was cancelled via ``ray_tpu_torch.cancel`` (parity: reference
    ``python/ray/exceptions.py`` TaskCancelledError).  Raised by ``get``
    on any of the task's return refs.  Subclasses TaskError so the
    owner-side failure plumbing publishes it verbatim and ``get``
    re-raises this exact type."""

    def __init__(self, task_desc: str = ""):
        super().__init__(None, "", task_desc)

    def __str__(self) -> str:
        return f"Task {self.task_desc or '<unknown>'} was cancelled"


class ActorError(TaskError):
    """An actor task failed or the actor died before/while executing it."""


class ActorDiedError(ActorError):
    def __init__(self, actor_desc: str = "", reason: str = ""):
        super().__init__(None, "", actor_desc)
        self.reason = reason

    def __str__(self) -> str:
        return f"Actor {self.task_desc} died: {self.reason}"


class WorkerCrashedError(RayTpuError):
    """The worker process executing the task died unexpectedly."""


class ObjectLostError(RayTpuError):
    """An object's value was lost (all copies evicted or node died) and
    could not be reconstructed from lineage."""

    def __init__(self, object_id_hex: str, reason: str = ""):
        self.object_id_hex = object_id_hex
        super().__init__(f"Object {object_id_hex} lost: {reason}")


class ObjectStoreFullError(RayTpuError):
    """Allocation failed even after eviction and spilling."""


class GetTimeoutError(RayTpuError, TimeoutError):
    """``get(..., timeout=)`` expired before the object was available."""


class RuntimeEnvSetupError(RayTpuError):
    """Preparing a task/actor runtime environment failed."""


class NodeDiedError(RayTpuError):
    """The node hosting the computation was declared dead."""


class PlacementGroupUnschedulableError(RayTpuError):
    """No feasible placement for the requested bundles."""


class RayTpuSystemError(RayTpuError):
    """Internal invariant violation; indicates a framework bug."""


class ActorExitRequest(BaseException):
    """Raised by :func:`ray_tpu_torch.actor.exit_actor`; BaseException so a
    user-level ``except Exception`` inside the method cannot swallow
    the exit (parity: the reference signals via a SystemExit path)."""
