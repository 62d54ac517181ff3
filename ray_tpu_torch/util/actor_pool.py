"""Actor pool utility (parity: reference ``python/ray/util/actor_pool.py``)."""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, TypeVar

import ray_tpu_torch

V = TypeVar("V")


class ActorPool:
    """Round-robins work over a fixed set of actors, yielding results in
    submission order (``map``) or completion order (``map_unordered``)."""

    def __init__(self, actors: List[Any]):
        self._idle = list(actors)
        self._inflight = {}
        self._ticket_refs = {}
        self._submit_ticket = 0
        self._claim_ticket = 0
        self._backlog: List[tuple] = []

    def map(self, fn: Callable[[Any, V], Any], values: Iterable[V]
            ) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next()

    def map_unordered(self, fn: Callable[[Any, V], Any], values: Iterable[V]
                      ) -> Iterator[Any]:
        for v in values:
            self.submit(fn, v)
        while self.has_next():
            yield self.get_next_unordered()

    def submit(self, fn: Callable[[Any, V], Any], value: V) -> None:
        if self._idle:
            actor = self._idle.pop()
            future = fn(actor, value)
            self._inflight[future] = (self._submit_ticket, actor)
            self._ticket_refs[self._submit_ticket] = future
            self._submit_ticket += 1
        else:
            self._backlog.append((fn, value))

    def has_next(self) -> bool:
        return bool(self._inflight) or bool(self._backlog)

    def _return_actor(self, actor) -> None:
        self._idle.append(actor)
        if self._backlog:
            self.submit(*self._backlog.pop(0))

    def get_next(self, timeout: float = None) -> Any:
        # dispatch is FIFO, so the next ticket to claim is always the
        # earliest-dispatched inflight future
        if not self.has_next():
            raise StopIteration("no more results")
        future = self._ticket_refs[self._claim_ticket]
        # wait BEFORE touching bookkeeping: a timeout must leave the
        # pool intact so the caller can simply retry, and a task error
        # must still return the actor to the idle set
        ready, _ = ray_tpu_torch.wait([future], num_returns=1, timeout=timeout)
        if not ready:
            raise ray_tpu_torch.GetTimeoutError("timed out waiting for result")
        self._ticket_refs.pop(self._claim_ticket)
        self._claim_ticket += 1
        _, actor = self._inflight.pop(future)
        self._return_actor(actor)
        return ray_tpu_torch.get(future)

    def get_next_unordered(self, timeout: float = None) -> Any:
        if not self.has_next():
            raise StopIteration("no more results")
        ready, _ = ray_tpu_torch.wait(list(self._inflight), num_returns=1,
                                timeout=timeout)
        if not ready:
            raise ray_tpu_torch.GetTimeoutError("timed out waiting for result")
        future = ready[0]
        idx, actor = self._inflight.pop(future)
        self._ticket_refs.pop(idx, None)
        self._return_actor(actor)
        return ray_tpu_torch.get(future)

    def has_free(self) -> bool:
        return bool(self._idle)

    def pop_idle(self):
        return self._idle.pop() if self._idle else None

    def push(self, actor) -> None:
        self._return_actor(actor)
