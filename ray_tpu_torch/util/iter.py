"""Parallel iterators over actor shards.

Parity: reference ``python/ray/util/iter.py`` — ``from_items`` /
``from_range`` build a ``ParallelIterator`` of N shards (one actor
each); ``for_each``/``filter``/``batch`` compose lazily per shard;
``gather_sync``/``gather_async`` stream results back to the driver.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, List, Optional

import ray_tpu_torch


@ray_tpu_torch.remote
class _ShardActor:
    def __init__(self, items: List[Any], ops):
        self._items = items
        self._ops = ops
        self._it: Optional[Iterator] = None

    def reset(self) -> bool:
        # ops compose in chain order: .batch(3).for_each(f) applies f to
        # the 3-element lists, matching the reference semantics
        def _flat(it):
            for v in it:
                yield from v

        base = iter(self._items)
        for kind, arg in self._ops:
            if kind == "for_each":
                base = map(arg, base)
            elif kind == "filter":
                base = filter(arg, base)
            elif kind == "flatten":
                base = _flat(base)
            elif kind == "batch":
                base = _batched(base, arg)
        self._it = base
        return True

    def next_batch(self, n: int) -> List[Any]:
        """Up to n items; empty list = exhausted."""
        if self._it is None:
            self.reset()
        out = []
        try:
            for _ in range(n):
                out.append(next(self._it))
        except StopIteration:
            pass
        return out


def _batched(it: Iterator, size: int) -> Iterator[List[Any]]:
    buf: List[Any] = []
    for x in it:
        buf.append(x)
        if len(buf) >= size:
            yield buf
            buf = []
    if buf:
        yield buf


class ParallelIterator:
    def __init__(self, shards_items: List[List[Any]], ops=None):
        self._shards_items = shards_items
        self._ops = list(ops or [])

    # -- lazy composition ----------------------------------------------
    def for_each(self, fn: Callable[[Any], Any]) -> "ParallelIterator":
        return ParallelIterator(self._shards_items,
                                self._ops + [("for_each", fn)])

    def filter(self, fn: Callable[[Any], bool]) -> "ParallelIterator":
        return ParallelIterator(self._shards_items,
                                self._ops + [("filter", fn)])

    def flatten(self) -> "ParallelIterator":
        return ParallelIterator(self._shards_items,
                                self._ops + [("flatten", None)])

    def batch(self, n: int) -> "ParallelIterator":
        return ParallelIterator(self._shards_items,
                                self._ops + [("batch", n)])

    def num_shards(self) -> int:
        return len(self._shards_items)

    # -- execution ------------------------------------------------------
    def _actors(self) -> List[Any]:
        return [_ShardActor.remote(items, self._ops)
                for items in self._shards_items]

    def gather_sync(self, fetch: int = 64) -> Iterator[Any]:
        """Round-robin over shards, in shard order (reference
        ``gather_sync``)."""
        actors = self._actors()
        ray_tpu_torch.get([a.reset.remote() for a in actors])
        try:
            live = list(actors)
            while live:
                nxt = []
                for a in live:
                    batch = ray_tpu_torch.get(a.next_batch.remote(fetch))
                    if batch:
                        yield from batch
                        nxt.append(a)
                live = nxt
        finally:
            # reached on exhaustion AND on early consumer exit
            # (GeneratorExit) — shard actors must not leak
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass

    def gather_async(self, fetch: int = 64) -> Iterator[Any]:
        """Whichever shard is ready first (reference ``gather_async``)."""
        actors = self._actors()
        ray_tpu_torch.get([a.reset.remote() for a in actors])
        try:
            inflight = {a.next_batch.remote(fetch): a for a in actors}
            while inflight:
                ready, _ = ray_tpu_torch.wait(list(inflight), num_returns=1)
                a = inflight.pop(ready[0])
                batch = ray_tpu_torch.get(ready[0])
                if batch:
                    yield from batch
                    inflight[a.next_batch.remote(fetch)] = a
        finally:
            for a in actors:
                try:
                    ray_tpu_torch.kill(a)
                except Exception:
                    pass

    def take(self, n: int) -> List[Any]:
        out = []
        for x in self.gather_sync():
            out.append(x)
            if len(out) >= n:
                break
        return out


def from_items(items: List[Any], num_shards: int = 2) -> ParallelIterator:
    shards: List[List[Any]] = [[] for _ in range(num_shards)]
    for i, x in enumerate(items):
        shards[i % num_shards].append(x)
    return ParallelIterator(shards)


def from_range(n: int, num_shards: int = 2) -> ParallelIterator:
    return from_items(list(range(n)), num_shards)
