"""Windowed streaming over datasets (parity: reference
``python/ray/data/dataset_pipeline.py``).  A pipeline is a sequence of
Dataset windows executed lazily one after another, so only one window's
blocks need be materialized at a time — the input-pipeline form consumed
by per-epoch training loops."""

from __future__ import annotations

import itertools
import threading
from collections import deque
from typing import Any, Callable, Iterator, List, Optional

from ray_tpu_torch.data.dataset import Dataset


def _fresh_window(ds: Dataset) -> Dataset:
    """A per-epoch copy of a window: shares the (resolved) source
    blocks but owns its stage list and shuffle marker, so transforms
    applied while consuming epoch 1 can never stack onto (or mutate
    state shared with) epoch 2's view of the same window."""
    return Dataset(ds._source, ds._stages, shuffle=ds._shuffle)


class DatasetPipeline:
    def __init__(self, windows: Optional[List[Dataset]],
                 infinite_source: Optional[Dataset] = None,
                 transforms: Optional[List[Callable[[Dataset], Dataset]]] = None,
                 window_source: Optional[Callable[[], Iterator[Dataset]]] = None):
        self._windows = windows
        self._infinite = infinite_source
        self._transforms = list(transforms or [])
        #: lazy window source (a factory returning an iterator) — used
        #: by repeat()/split() so windows materialize one at a time
        self._window_source = window_source

    def _window_iter(self) -> Iterator[Dataset]:
        if self._window_source is not None:
            source: Iterator[Dataset] = self._window_source()
        elif self._infinite is not None:
            source = (_fresh_window(self._infinite)
                      for _ in itertools.count())
        else:
            source = iter(self._windows or [])
        for w in source:
            for t in self._transforms:
                w = t(w)
            yield w

    def _with_transform(self, t: Callable[[Dataset], Dataset]
                        ) -> "DatasetPipeline":
        return DatasetPipeline(self._windows, self._infinite,
                               self._transforms + [t],
                               self._window_source)

    # per-window transforms (all LAZY: recorded here, applied per
    # window as _window_iter yields it — nothing executes until a
    # consumer pulls) ---------------------------------------------------
    def map(self, fn, **kw) -> "DatasetPipeline":
        return self._with_transform(lambda ds: ds.map(fn, **kw))

    def map_batches(self, fn, **kw) -> "DatasetPipeline":
        return self._with_transform(lambda ds: ds.map_batches(fn, **kw))

    def filter(self, fn, **kw) -> "DatasetPipeline":
        return self._with_transform(lambda ds: ds.filter(fn, **kw))

    def random_shuffle_each_window(self, *, seed=None) -> "DatasetPipeline":
        return self._with_transform(lambda ds: ds.random_shuffle(seed=seed))

    def repartition_each_window(self, n: int) -> "DatasetPipeline":
        return self._with_transform(lambda ds: ds.repartition(n))

    def foreach_window(self, fn: Callable[[Dataset], Dataset]
                       ) -> "DatasetPipeline":
        """Apply ``fn`` to every window — lazily: ``fn`` runs when the
        consumer reaches the window, once per window per epoch."""
        return self._with_transform(fn)

    def repeat(self, times: Optional[int] = None) -> "DatasetPipeline":
        """Repeat the pipeline's windows for ``times`` epochs (forever
        when None).  Each epoch iterates FRESH per-window Dataset views
        (shared blocks, private stage state), so window transforms
        applied during one epoch cannot stack into the next — and the
        repeat itself is lazy: epoch N+1's windows don't exist until
        epoch N is consumed."""
        if self._infinite is not None:
            return self  # already unbounded

        if self._window_source is not None:
            # source-driven (e.g. a split shard): epoch 1 streams the
            # source lazily while CACHING its windows; later epochs
            # replay the cache — bounded sources repeat correctly
            # instead of silently yielding one epoch
            base_factory = self._window_source
            cache: List[Dataset] = []
            primed: List[bool] = []

            def _source() -> Iterator[Dataset]:
                epochs = itertools.count() if times is None \
                    else range(times)
                for _ in epochs:
                    if not primed:
                        for w in base_factory():
                            cache.append(w)
                            yield _fresh_window(w)
                        primed.append(True)
                    else:
                        for w in cache:
                            yield _fresh_window(w)

            return DatasetPipeline(None, None, self._transforms,
                                   window_source=_source)

        base = [_fresh_window(w) for w in (self._windows or [])]

        def _source() -> Iterator[Dataset]:
            epochs = itertools.count() if times is None else range(times)
            for _ in epochs:
                for w in base:
                    yield _fresh_window(w)

        return DatasetPipeline(None, None, self._transforms,
                               window_source=_source)

    # consumption ------------------------------------------------------
    def iter_batches(self, **kw) -> Iterator[Any]:
        for window in self._window_iter():
            yield from window.iter_batches(**kw)

    def iter_rows(self) -> Iterator[Any]:
        for window in self._window_iter():
            yield from window.iter_rows()

    def iter_datasets(self) -> Iterator[Dataset]:
        return self._window_iter()

    def split(self, n: int, *, equal: bool = False) -> List["DatasetPipeline"]:
        """Split every window n-ways; consumer i sees shard i of each
        window (parity: pipeline split for Train ingest).  Lazy: the
        parent pipeline advances one window at a time, ON DEMAND, as
        the shard consumers pull — each window is split exactly once
        and its shards buffered for the ranks that haven't reached it
        yet (consumers are expected to progress roughly in lockstep,
        the Train gang pattern)."""
        splitter = _LazySplitter(self._window_iter, n, equal)
        return [DatasetPipeline(None, None, [],
                                window_source=splitter.source(i))
                for i in range(n)]

    def take(self, n: int = 20) -> List[Any]:
        out = []
        for row in self.iter_rows():
            out.append(row)
            if len(out) >= n:
                break
        return out

    def count(self) -> int:
        return sum(w.count() for w in self._window_iter())


class _LazySplitter:
    """Shared on-demand window splitter behind ``DatasetPipeline.split``:
    the slowest consumer drives parent-window materialization, faster
    consumers read from their shard's buffer.  Thread-safe (Train ranks
    poll their shards from concurrent actors via the driver)."""

    def __init__(self, window_iter_factory: Callable[[], Iterator[Dataset]],
                 n: int, equal: bool):
        self._factory = window_iter_factory
        self._iter: Optional[Iterator[Dataset]] = None
        self._n = n
        self._equal = equal
        self._buffers: List[deque] = [deque() for _ in range(n)]
        self._done = False
        self._lock = threading.Lock()

    def _advance(self) -> bool:
        """Pull ONE window from the parent and buffer its shards."""
        if self._iter is None:
            self._iter = self._factory()
        try:
            window = next(self._iter)
        except StopIteration:
            self._done = True
            return False
        for i, sub in enumerate(window.split(self._n, equal=self._equal)):
            self._buffers[i].append(sub)
        return True

    def source(self, i: int) -> Callable[[], Iterator[Dataset]]:
        def _gen() -> Iterator[Dataset]:
            while True:
                with self._lock:
                    if self._buffers[i]:
                        window = self._buffers[i].popleft()
                    elif self._done:
                        return
                    else:
                        if not self._advance():
                            return
                        window = self._buffers[i].popleft()
                yield window
        return _gen
