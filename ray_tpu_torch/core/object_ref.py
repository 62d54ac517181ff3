"""ObjectRef: a first-class future/handle for a distributed immutable value.

Parity: reference ``python/ray/_raylet.pyx`` ObjectRef + the ownership
model of ``src/ray/core_worker/reference_count.h`` — every ref knows its
*owner* (the worker that created it), which is the authority for the
value's location and lifetime.  Local ref counting is driven by Python
object lifetime: ``__del__`` notifies the core worker, which releases the
object once all local refs, submitted-task refs, and borrows are gone.
"""

from __future__ import annotations

from typing import Optional, Tuple

from ray_tpu_torch.core.ids import ObjectID

# Owner address: (node hint, host, port, worker_id_hex). Kept as a plain
# tuple so it pickles compactly inside task specs.
OwnerAddress = Tuple[str, str, int, str]


class ObjectRef:
    __slots__ = ("_id", "_owner_address", "_registered", "__weakref__")

    def __init__(self, object_id: ObjectID, owner_address: Optional[OwnerAddress],
                 *, _register: bool = True):
        self._id = object_id
        self._owner_address = owner_address
        self._registered = False
        if _register:
            self._register()

    def _register(self) -> None:
        from ray_tpu_torch.core import worker as worker_mod

        core = worker_mod.global_worker_or_none()
        if core is not None:
            core.reference_counter.add_local_ref(self._id)
            self._registered = True

    # -- identity ---------------------------------------------------------
    def id(self) -> ObjectID:
        return self._id

    def binary(self) -> bytes:
        return self._id.binary()

    def hex(self) -> str:
        return self._id.hex()

    def owner_address(self) -> Optional[OwnerAddress]:
        return self._owner_address

    def task_id(self):
        return self._id.task_id()

    # -- convenience ------------------------------------------------------
    def future(self):
        """Return a concurrent.futures.Future resolving to the value."""
        from ray_tpu_torch.core import worker as worker_mod

        return worker_mod.global_worker().get_async(self)

    def __await__(self):
        from ray_tpu_torch.core import worker as worker_mod

        import asyncio

        fut = worker_mod.global_worker().get_async(self)
        return asyncio.wrap_future(fut).__await__()

    def __hash__(self) -> int:
        return hash(self._id)

    def __eq__(self, other) -> bool:
        return isinstance(other, ObjectRef) and other._id == self._id

    def __repr__(self) -> str:
        return f"ObjectRef({self._id.hex()})"

    def __del__(self):
        if not self._registered:
            return
        try:
            from ray_tpu_torch.core import worker as worker_mod

            core = worker_mod.global_worker_or_none()
            if core is not None:
                # Deferred: finalizers may run on any thread while it holds
                # unrelated locks; the refcount mutation happens on the io
                # loop (see CoreWorker.deferred_remove_local_ref).
                core.deferred_remove_local_ref(self._id)
        except Exception:
            pass  # interpreter shutdown

    def __reduce__(self):
        # Direct pickling travels through serialization.persistent_id in
        # task specs / values; this path covers ad-hoc pickling and marks
        # the ref restored (borrowed) on the far side.
        return (ObjectRef._restore, (self._id.binary(), self._owner_address))

    @staticmethod
    def _restore(id_bytes: bytes, owner_address: Optional[OwnerAddress]) -> "ObjectRef":
        ref = ObjectRef(ObjectID(id_bytes), owner_address, _register=False)
        from ray_tpu_torch.core import worker as worker_mod

        core = worker_mod.global_worker_or_none()
        if core is not None:
            core.reference_counter.add_borrowed_ref(ref._id, owner_address)
            ref._registered = True
        return ref


class ObjectRefGenerator:
    """The value a ``num_returns="dynamic"`` task resolves to: an
    iterable of the ObjectRefs the task yielded (parity: reference
    ``python/ray/_raylet.pyx:603-622`` ObjectRefGenerator — the static
    form, where the refs are known once the task finished).

    ``get`` on the task's return ref produces one of these; iterating
    yields ObjectRefs that can be ``get``-ed lazily or passed to
    downstream tasks.  The refs travel through the normal serialization
    path, so borrow/ownership tracking applies wherever the generator
    object lands.
    """

    def __init__(self, refs):
        self._refs = list(refs)

    def __iter__(self):
        return iter(self._refs)

    def __len__(self) -> int:
        return len(self._refs)

    def __getitem__(self, i):
        return self._refs[i]

    def __repr__(self) -> str:
        return f"ObjectRefGenerator({len(self._refs)} refs)"


class StreamingObjectRefGenerator:
    """num_returns="streaming" handle: yields each item's ObjectRef as
    the executing task produces it — consumption overlaps execution
    (parity: the reference's streaming generator protocol,
    ``python/ray/_raylet.pyx`` StreamingObjectRefGenerator).

    Iteration blocks until the next item is announced (worker → owner
    push) or the task finishes; a task error raises at the position
    where the stream broke.
    """

    def __init__(self, task_id, core):
        self._task_id = task_id
        self._core = core
        self._consumed = 0

    @property
    def task_id(self):
        return self._task_id

    def __iter__(self):
        return self

    def __next__(self):
        ref = self.next_ref(timeout=None)
        if ref is None:
            raise StopIteration
        return ref

    def next_ref(self, timeout=None):
        """Next item's ObjectRef, or None at end-of-stream.  Raises the
        task's error if it failed before producing another item."""
        state = self._core._streaming_states.get(self._task_id.binary())
        if state is None:
            return None  # never registered / already reaped
        with state.cond:
            while True:
                if self._consumed < len(state.dyn_ids) \
                        and state.dyn_ids[self._consumed] is not None:
                    i = self._consumed
                    self._consumed += 1
                    state.consumed = max(state.consumed, self._consumed)
                    return ObjectRef(ObjectID(state.dyn_ids[i]),
                                     self._core.address)
                if state.done:
                    if state.error is not None:
                        raise state.error
                    return None
                if not state.cond.wait(timeout):
                    raise TimeoutError(
                        f"no streamed item within {timeout}s")

    def __del__(self):
        # reap the owner-side stream state once the handle goes away:
        # immediately if the task finished, else mark it abandoned so
        # _finish_stream reaps it at completion (a finished-but-never-
        # drained stream must not pin its dyn_ids forever)
        try:
            core = self._core
            tid_bin = self._task_id.binary()
            state = core._streaming_states.get(tid_bin)
            if state is None:
                return
            if state.done:
                # finished-but-undrained: free the unconsumed remainder
                # too (they hold zero refs and would leak)
                core._reap_stream_remainder(tid_bin)
            else:
                core._stream_abandoned.add(tid_bin)
        except Exception:
            pass
