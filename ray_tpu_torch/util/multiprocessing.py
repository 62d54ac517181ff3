"""multiprocessing.Pool API over the task/actor substrate.

Parity: reference ``python/ray/util/multiprocessing/pool.py`` — drop-in
``Pool`` whose workers are cluster actors, so ``pool.map`` scales past
one machine with the stdlib interface.
"""

from __future__ import annotations

import itertools
import threading
from multiprocessing import TimeoutError as MpTimeoutError
from typing import Any, Callable, Iterable, List, Optional

import ray_tpu_torch


@ray_tpu_torch.remote
class _PoolWorker:
    def run_batch(self, fn, batch: List[tuple], star: bool) -> List[Any]:
        if star:
            return [fn(*args) for args in batch]
        return [fn(args) for args in batch]


class AsyncResult:
    """Stdlib-compatible handle (reference ``AsyncResult``)."""

    def __init__(self, refs: List[ray_tpu_torch.ObjectRef],
                 single: bool = False,
                 callback: Optional[Callable] = None,
                 error_callback: Optional[Callable] = None):
        self._refs = refs
        self._single = single
        self._callback = callback
        self._error_callback = error_callback
        self._value: Any = None
        self._error: Optional[Exception] = None
        self._done = threading.Event()
        threading.Thread(target=self._wait_thread, daemon=True).start()

    def _wait_thread(self):
        try:
            batches = ray_tpu_torch.get(self._refs)
            flat = [v for b in batches for v in b]
            self._value = flat[0] if self._single else flat
            if self._callback is not None:
                self._callback(self._value)
        except Exception as e:  # noqa: BLE001
            self._error = e
            if self._error_callback is not None:
                self._error_callback(e)
        finally:
            self._done.set()

    def wait(self, timeout: Optional[float] = None) -> None:
        self._done.wait(timeout)

    def ready(self) -> bool:
        return self._done.is_set()

    def successful(self) -> bool:
        if not self.ready():
            raise ValueError("result not ready")
        return self._error is None

    def get(self, timeout: Optional[float] = None):
        if not self._done.wait(timeout):
            raise MpTimeoutError("result not ready")
        if self._error is not None:
            raise self._error
        return self._value


class Pool:
    def __init__(self, processes: Optional[int] = None,
                 initializer: Optional[Callable] = None,
                 initargs: tuple = ()):
        if not ray_tpu_torch.is_initialized():
            ray_tpu_torch.init()
        if processes is None:
            processes = max(1, int(ray_tpu_torch.cluster_resources()
                                   .get("CPU", 1)))
        self._size = processes
        self._workers = [_PoolWorker.remote() for _ in range(processes)]
        if initializer is not None:
            # run the initializer once inside every worker
            ray_tpu_torch.get([w.run_batch.remote(
                lambda _: initializer(*initargs), [None], False)
                for w in self._workers])
        self._closed = False
        self._pending: List[AsyncResult] = []

    # ------------------------------------------------------------------
    def _chunks(self, iterable: Iterable, chunksize: Optional[int]
                ) -> List[List[tuple]]:
        items = list(iterable)
        if chunksize is None:
            chunksize = max(1, len(items) // (self._size * 4) or 1)
        return [items[i:i + chunksize]
                for i in range(0, len(items), chunksize)]

    def _dispatch(self, fn, chunks: List[List[Any]], star: bool
                  ) -> List[ray_tpu_torch.ObjectRef]:
        workers = itertools.cycle(self._workers)
        return [next(workers).run_batch.remote(fn, chunk, star)
                for chunk in chunks]

    def _track(self, result: "AsyncResult") -> "AsyncResult":
        self._pending = [r for r in self._pending if not r.ready()]
        self._pending.append(result)
        return result

    # -- stdlib surface -------------------------------------------------
    def apply(self, fn: Callable, args: tuple = (), kwds: dict = None):
        return self.apply_async(fn, args, kwds).get()

    def apply_async(self, fn: Callable, args: tuple = (),
                    kwds: Optional[dict] = None,
                    callback=None, error_callback=None) -> AsyncResult:
        kwds = kwds or {}
        f = (lambda a: fn(*a, **kwds))
        refs = self._dispatch(f, [[args]], star=False)
        return self._track(AsyncResult(refs, single=True, callback=callback,
                                       error_callback=error_callback))

    def map(self, fn: Callable, iterable: Iterable,
            chunksize: Optional[int] = None) -> List[Any]:
        return self.map_async(fn, iterable, chunksize).get()

    def map_async(self, fn: Callable, iterable: Iterable,
                  chunksize: Optional[int] = None,
                  callback=None, error_callback=None) -> AsyncResult:
        chunks = self._chunks(iterable, chunksize)
        refs = self._dispatch(fn, chunks, star=False)
        return self._track(AsyncResult(refs, callback=callback,
                                       error_callback=error_callback))

    def starmap(self, fn: Callable, iterable: Iterable[tuple],
                chunksize: Optional[int] = None) -> List[Any]:
        chunks = self._chunks(iterable, chunksize)
        return self._track(
            AsyncResult(self._dispatch(fn, chunks, star=True))).get()

    def starmap_async(self, fn: Callable, iterable: Iterable[tuple],
                      chunksize: Optional[int] = None) -> AsyncResult:
        chunks = self._chunks(iterable, chunksize)
        return self._track(
            AsyncResult(self._dispatch(fn, chunks, star=True)))

    def imap(self, fn: Callable, iterable: Iterable,
             chunksize: Optional[int] = None):
        chunks = self._chunks(iterable, chunksize)
        refs = self._dispatch(fn, chunks, star=False)
        for ref in refs:  # ordered streaming
            for v in ray_tpu_torch.get(ref):
                yield v

    def imap_unordered(self, fn: Callable, iterable: Iterable,
                       chunksize: Optional[int] = None):
        chunks = self._chunks(iterable, chunksize)
        pending = self._dispatch(fn, chunks, star=False)
        while pending:
            # wait may report more than num_returns ready — consume all
            ready, pending = ray_tpu_torch.wait(pending, num_returns=1)
            for ref in ready:
                for v in ray_tpu_torch.get(ref):
                    yield v

    # ------------------------------------------------------------------
    def close(self) -> None:
        self._closed = True

    def terminate(self) -> None:
        self._closed = True
        for w in self._workers:
            try:
                ray_tpu_torch.kill(w)
            except Exception:  # noqa: BLE001
                pass
        self._workers = []

    def join(self) -> None:
        if not self._closed:
            raise ValueError("Pool is still running")
        # stdlib contract: block until all submitted work completes
        for r in self._pending:
            r.wait()
        self._pending = []

    def __enter__(self) -> "Pool":
        return self

    def __exit__(self, *exc) -> None:
        self.terminate()
