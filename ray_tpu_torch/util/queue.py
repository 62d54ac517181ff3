"""Distributed FIFO queue backed by an actor (parity: reference
``python/ray/util/queue.py``)."""

from __future__ import annotations

import time
from typing import Any, List, Optional

import ray_tpu_torch


class Empty(Exception):
    pass


class Full(Exception):
    pass


@ray_tpu_torch.remote
class _QueueActor:
    def __init__(self, maxsize: int):
        self.maxsize = maxsize
        self.items: List[Any] = []

    def put(self, item) -> bool:
        if self.maxsize > 0 and len(self.items) >= self.maxsize:
            return False
        self.items.append(item)
        return True

    def put_batch(self, items) -> int:
        space = (self.maxsize - len(self.items)) if self.maxsize > 0 else len(items)
        taken = items[:space]
        self.items.extend(taken)
        return len(taken)

    def get(self, n: int = 1) -> Optional[List[Any]]:
        if len(self.items) < n:
            return None
        out, self.items = self.items[:n], self.items[n:]
        return out

    def qsize(self) -> int:
        return len(self.items)


class Queue:
    def __init__(self, maxsize: int = 0, actor_options: Optional[dict] = None):
        self.maxsize = maxsize
        self.actor = _QueueActor.options(**(actor_options or {})).remote(maxsize)

    def put(self, item: Any, block: bool = True,
            timeout: Optional[float] = None) -> None:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            if ray_tpu_torch.get(self.actor.put.remote(item)):
                return
            if not block:
                raise Full()
            if deadline is not None and time.monotonic() > deadline:
                raise Full()
            time.sleep(0.01)

    def put_nowait(self, item: Any) -> None:
        self.put(item, block=False)

    def get(self, block: bool = True, timeout: Optional[float] = None) -> Any:
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            out = ray_tpu_torch.get(self.actor.get.remote(1))
            if out is not None:
                return out[0]
            if not block:
                raise Empty()
            if deadline is not None and time.monotonic() > deadline:
                raise Empty()
            time.sleep(0.01)

    def get_nowait(self) -> Any:
        return self.get(block=False)

    def put_nowait_batch(self, items: List[Any]) -> None:
        n = ray_tpu_torch.get(self.actor.put_batch.remote(list(items)))
        if n < len(items):
            raise Full()

    def get_nowait_batch(self, num_items: int) -> List[Any]:
        out = ray_tpu_torch.get(self.actor.get.remote(num_items))
        if out is None:
            raise Empty()
        return out

    def qsize(self) -> int:
        return ray_tpu_torch.get(self.actor.qsize.remote())

    def empty(self) -> bool:
        return self.qsize() == 0

    def full(self) -> bool:
        return self.maxsize > 0 and self.qsize() >= self.maxsize

    def shutdown(self) -> None:
        ray_tpu_torch.kill(self.actor)
