"""Streaming execution engine for ``ray_tpu_torch.data`` (docs/data.md).

Executes a Dataset's fused stage DAG as a *pull-based* pipeline of
per-block tasks instead of the materialize-everything batch plan in
``dataset.py``: at most ``streaming_block_budget`` blocks are ever in
flight (executing, or produced but not yet consumed), admissions are
streamed through ``ray_tpu_torch.wait`` (the PR-8 decoupled-pipeline
discipline), and two backpressure signals stall the producer side —

* **consumer lag**: the ready queue counts against the same budget, so
  a slow consumer stops admissions instead of piling blocks into the
  arena;
* **object-store pressure**: the executor probes its local raylet's
  arena occupancy (cached, ``streaming_arena_probe_interval_s``) and
  stalls admissions above ``streaming_arena_watermark`` — *below* the
  raylet's spill threshold, so steady-state streaming never pays spill
  latency on the ingest path (one block always stays in flight, so a
  stall can never deadlock progress).

Inputs may be sealed ObjectRefs or *factories* (zero-arg callables
submitting the read task on demand — ``read_api`` produces these), so
reads themselves are admitted lazily: a terabyte-scale dataset holds
file paths, not blocks, until the consumer's window reaches them.

Locality: when a map task's input block has a known location on another
node (the owner's object directory), the fused task is submitted with a
soft locality preference so the lease lands where the bytes already
live (owner-side lease routing, ``task_locality_enabled``).

``StreamingShuffle`` runs the all-to-all ``random_shuffle`` in the same
discipline: the map/partition side streams with the bounded budget, the
intermediate partition blocks ride the PR-10 spill tier when the
working set exceeds the arena, and reduce tasks are submitted lazily as
the consumer pulls output blocks.

``StreamShard`` packages a partition of the stream as a picklable
handle a train worker consumes in-process (``session.get_dataset_shard``
→ ``iter_batches``): the shard's tasks are submitted by the *consuming*
rank, so map outputs are node-local to the trainer, and a prefetch
thread assembles the next batch while the current step runs.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple, Union

import ray_tpu_torch
from ray_tpu_torch.core import telemetry as _tm
from ray_tpu_torch.data.block import Block, BlockAccessor, concat_blocks
from ray_tpu_torch.data.context import DataContext
from ray_tpu_torch.util import failpoint as _fp

logger = logging.getLogger(__name__)

#: a stream input: a sealed block ref, or a factory that submits the
#: read task when the window reaches it
StreamInput = Union["ray_tpu_torch.ObjectRef", Callable[[], "ray_tpu_torch.ObjectRef"]]


def _transform_failpoint() -> None:
    """Shared fault-injection site of every streaming map/shuffle-map
    task (``data.block.transform_fail`` — docs/fault_injection.md):
    ``kill`` models a map worker dying mid-stream; the retried task
    regenerates the same return objects (exactly-once)."""
    _fp.failpoint("data.block.transform_fail")


@ray_tpu_torch.remote(num_returns=2)
def _stream_map_block(block: Block, fns) -> Tuple[Block, dict]:
    """One fused map task of the streaming plan: applies every pending
    stage and returns (block, meta) as TWO objects, so the executor can
    watch/fetch the tiny meta without ever pulling the block to the
    driver."""
    _transform_failpoint()
    for fn in fns:
        block = fn(block)
    acc = BlockAccessor(block)
    return block, {"rows": acc.num_rows(), "bytes": acc.size_bytes()}


@ray_tpu_torch.remote
def _stream_shuffle_map(block: Block, n_reducers: int, seed, fns
                        ) -> List[Block]:
    """Partition one (fused-mapped) block into ``n_reducers`` parts +
    a trailing meta dict (ride as ``n_reducers + 1`` returns)."""
    import numpy as np

    _transform_failpoint()
    for fn in fns:
        block = fn(block)
    acc = BlockAccessor(block)
    n = acc.num_rows()
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, n_reducers, size=n)
    parts = [acc.take_indices(np.nonzero(assignment == r)[0])
             for r in range(n_reducers)]
    meta = {"rows": n, "bytes": acc.size_bytes()}
    return parts + [meta]


@ray_tpu_torch.remote(num_returns=2)
def _stream_shuffle_reduce(seed, *parts: Block) -> Tuple[Block, dict]:
    import numpy as np

    merged = concat_blocks(list(parts))
    acc = BlockAccessor(merged)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(acc.num_rows())
    out = acc.take_indices(idx)
    oacc = BlockAccessor(out)
    return out, {"rows": oacc.num_rows(), "bytes": oacc.size_bytes()}


class _ArenaProbe:
    """Cached local-arena pressure probe (one raylet RPC per interval).

    A probe failure reads as "no pressure": backpressure is an
    optimization, and a dead/slow raylet already surfaces through the
    task path."""

    def __init__(self, interval_s: float):
        self._interval = max(0.05, interval_s)
        self._last_ts = 0.0
        self._last_frac = 0.0

    def used_fraction(self) -> float:
        now = time.monotonic()
        if now - self._last_ts < self._interval:
            return self._last_frac
        self._last_ts = now
        try:
            from ray_tpu_torch.core import worker as _worker_mod
            core = _worker_mod.global_worker_or_none()
            if core is None:
                return 0.0
            stats = core.raylet_call(core.raylet_address, "store_stats",
                                     {}, timeout=2.0)
            cap = stats.get("capacity") or 0
            self._last_frac = (stats.get("used", 0) / cap) if cap else 0.0
        except Exception:  # noqa: BLE001 — probe is best-effort
            self._last_frac = 0.0
        return self._last_frac


class StreamingExecutor:
    """Pull-based bounded-window execution of one fused stage chain.

    ``iter_blocks()`` yields ``(block_ref, meta)`` pairs; at most
    ``budget`` blocks are in flight or ready at any moment, and every
    yielded block leaves the executor's accounting the moment the
    consumer takes it (its ref lifetime is then the consumer's)."""

    def __init__(self, inputs: List[StreamInput],
                 stages: Optional[List[Tuple[str, Callable]]] = None,
                 *, budget: Optional[int] = None,
                 preserve_order: Optional[bool] = None,
                 locality: Optional[bool] = None,
                 locality_node: Optional[str] = None):
        ctx = DataContext.get_current()
        self._inputs: deque = deque(enumerate(inputs))
        self._total = len(inputs)
        self._fns = [fn for _, fn in (stages or [])]
        self.budget = max(1, int(budget or ctx.streaming_block_budget))
        self._ordered = (ctx.streaming_preserve_order
                         if preserve_order is None else bool(preserve_order))
        #: per-block input locality rides the owner-side lease routing
        #: (``task_locality_enabled``: the lease request for a map task
        #: whose input block lives on another node goes to THAT node's
        #: raylet); this flag only gates the explicit shard pin below
        self._locality = (ctx.streaming_locality_enabled
                          if locality is None else bool(locality))
        #: explicit target node (hex) for every map task — set by
        #: locality-hinted shards; wins over per-block input locality
        self._locality_node = locality_node if self._locality else None
        self._watermark = float(ctx.streaming_arena_watermark)
        self._probe = _ArenaProbe(ctx.streaming_arena_probe_interval_s)
        # watch ref -> [(index, block_ref), ...]; watch is the meta ref
        # when a task runs, or the input ref itself for ref inputs w/o
        # stages (a LIST because duplicate input refs share one watch)
        self._inflight: Dict[Any, List[Tuple[int, Any]]] = {}
        self._meta_of: Dict[int, Any] = {}
        self._ready: Dict[int, Tuple[Any, Optional[dict]]] = {}
        self._ready_order: deque = deque()  # completion order (unordered)
        self._next_yield = 0
        self.stall_counts = {"consumer": 0, "arena": 0}
        self.max_observed_in_flight = 0

    # -- admission -----------------------------------------------------
    def _in_flight(self) -> int:
        return len(self._inflight) + len(self._ready)

    def _submit_one(self) -> None:
        from ray_tpu_torch.data.dataset import resolve_input

        idx, inp = self._inputs.popleft()
        inp = resolve_input(inp)  # lazy read: submits the task now
        opts: Optional[dict] = None
        if self._locality_node is not None:
            from ray_tpu_torch.util.scheduling_strategies import (
                NodeAffinitySchedulingStrategy,
            )
            opts = {"scheduling_strategy": NodeAffinitySchedulingStrategy(
                node_id=self._locality_node, soft=True)}
        if self._fns:
            fn = _stream_map_block.options(**opts) if opts \
                else _stream_map_block
            block_ref, meta_ref = fn.remote(inp, self._fns)
            self._inflight.setdefault(meta_ref, []).append((idx, block_ref))
            self._meta_of[idx] = meta_ref
        else:
            # no pending stages: the input ref itself is the output;
            # completion is the ref becoming ready (no extra task).
            # The per-watch-ref LIST matters here: duplicate input refs
            # (e.g. ds.union(ds)) share one watch entry and must all
            # surface when it completes.
            self._inflight.setdefault(inp, []).append((idx, inp))

    def _admit(self) -> None:
        stalled_arena = False
        while self._inputs and self._in_flight() < self.budget:
            if self._watermark > 0 and self._in_flight() >= 1 \
                    and self._probe.used_fraction() > self._watermark:
                if not stalled_arena:
                    stalled_arena = True
                    self.stall_counts["arena"] += 1
                    _tm.data_backpressure_stall("arena")
                break
            self._submit_one()
        if self._inputs and self._in_flight() >= self.budget \
                and len(self._ready) > 0:
            # budget saturated by produced-but-unconsumed blocks: the
            # consumer is the bottleneck (counted once per wait round)
            self.stall_counts["consumer"] += 1
            _tm.data_backpressure_stall("consumer")
        depth = self._in_flight()
        if depth > self.max_observed_in_flight:
            self.max_observed_in_flight = depth
        _tm.data_blocks_in_flight(depth)

    # -- completion ----------------------------------------------------
    def _drain_completions(self, block: bool) -> None:
        if not self._inflight:
            return
        watch = list(self._inflight)
        if block:
            done, _ = ray_tpu_torch.wait(watch, num_returns=1, timeout=30.0)
            if done:
                # snapshot EVERYTHING ready in the same pass (the PR-8
                # zero-timeout drain) so one wait round admits the true
                # completion set
                more, _ = ray_tpu_torch.wait(watch, num_returns=len(watch),
                                       timeout=0)
                done = more or done
        else:
            done, _ = ray_tpu_torch.wait(watch, num_returns=len(watch), timeout=0)
        for ref in done:
            for idx, block_ref in self._inflight.pop(ref):
                meta_ref = self._meta_of.pop(idx, None)
                meta = None
                if meta_ref is not None:
                    try:
                        meta = ray_tpu_torch.get(meta_ref, timeout=30.0)
                    except Exception:  # noqa: BLE001 — surfaced on get
                        meta = None
                self._ready[idx] = (block_ref, meta)
                self._ready_order.append(idx)
                _tm.data_blocks_produced()

    def _pop_ready(self) -> Optional[Tuple[Any, Optional[dict]]]:
        if self._ordered:
            if self._next_yield in self._ready:
                idx = self._next_yield
                self._next_yield += 1
                self._ready_order.remove(idx)
                return self._ready.pop(idx)
            return None
        if self._ready_order:
            idx = self._ready_order.popleft()
            return self._ready.pop(idx)
        return None

    def iter_blocks(self) -> Iterator[Tuple[Any, Optional[dict]]]:
        while self._inputs or self._inflight or self._ready:
            self._admit()
            self._drain_completions(block=False)
            out = self._pop_ready()
            if out is None:
                if not self._inflight:
                    if self._inputs:
                        continue  # stalled admission re-evaluates
                    if self._ready:
                        continue  # ordered gap impossible; defensive
                    break
                self._drain_completions(block=True)
                out = self._pop_ready()
                if out is None:
                    continue
            yield out
        _tm.data_blocks_in_flight(0)


class StreamingShuffle:
    """Windowed all-to-all shuffle in the streaming discipline.

    Phase 1 streams partition tasks over the inputs with the bounded
    budget; the per-reducer intermediate blocks accumulate on the
    object plane (and ride the raylet's spill tier past the arena —
    spill-ahead keeps that off the create path).  Phase 2 submits
    reduce tasks *lazily*: a reducer runs only when the consumer's
    window reaches it, so at most ``budget`` shuffled output blocks
    ever co-exist un-consumed."""

    def __init__(self, inputs: List[StreamInput],
                 stages: Optional[List[Tuple[str, Callable]]] = None,
                 *, seed: Optional[int] = None,
                 num_reducers: Optional[int] = None,
                 budget: Optional[int] = None):
        ctx = DataContext.get_current()
        self._inputs = list(inputs)
        self._fns = [fn for _, fn in (stages or [])]
        self._seed = seed
        self._n_red = max(1, int(num_reducers or len(inputs) or 1))
        self.budget = max(1, int(budget or ctx.streaming_block_budget))
        self.spilled_bytes = 0

    def _spill_bytes_now(self) -> int:
        try:
            from ray_tpu_torch.core import worker as _worker_mod
            core = _worker_mod.global_worker_or_none()
            if core is None:
                return 0
            stats = core.raylet_call(core.raylet_address, "store_stats",
                                     {}, timeout=2.0)
            return int(stats.get("spill_bytes", 0))
        except Exception:  # noqa: BLE001 — accounting probe only
            return 0

    def iter_blocks(self) -> Iterator[Tuple[Any, Optional[dict]]]:
        spill_before = self._spill_bytes_now()
        n_red = self._n_red
        parts: List[List[Any]] = [[] for _ in range(n_red)]
        inflight: Dict[Any, List[Any]] = {}  # meta ref -> part refs
        pending = deque(enumerate(self._inputs))
        # ---- phase 1: streamed partition maps ------------------------
        while pending or inflight:
            while pending and len(inflight) < self.budget:
                from ray_tpu_torch.data.dataset import resolve_input

                i, inp = pending.popleft()
                inp = resolve_input(inp)
                seed = None if self._seed is None else self._seed + i
                rets = _stream_shuffle_map.options(
                    num_returns=n_red + 1).remote(inp, n_red, seed,
                                                  self._fns)
                inflight[rets[-1]] = rets[:-1]
                _tm.data_blocks_in_flight(len(inflight))
            if not inflight:
                continue
            watch = list(inflight)
            done, _ = ray_tpu_torch.wait(watch, num_returns=1, timeout=30.0)
            more, _ = ray_tpu_torch.wait(watch, num_returns=len(watch), timeout=0)
            for meta_ref in (more or done):
                ray_tpu_torch.get(meta_ref, timeout=30.0)  # surface map errors
                for r, pref in enumerate(inflight.pop(meta_ref)):
                    parts[r].append(pref)
        # ---- phase 2: lazily pulled reduces --------------------------
        red_pending = deque(range(n_red))
        red_inflight: Dict[Any, Tuple[int, Any]] = {}
        ready: deque = deque()
        while red_pending or red_inflight or ready:
            while red_pending and len(red_inflight) + len(ready) \
                    < self.budget:
                r = red_pending.popleft()
                seed = None if self._seed is None \
                    else self._seed + 100003 + r
                block_ref, meta_ref = _stream_shuffle_reduce.options(
                    num_returns=2).remote(seed, *parts[r])
                parts[r] = []  # reduce task now pins its inputs
                red_inflight[meta_ref] = (r, block_ref)
            _tm.data_blocks_in_flight(len(red_inflight) + len(ready))
            if ready:
                yield ready.popleft()
                continue
            watch = list(red_inflight)
            done, _ = ray_tpu_torch.wait(watch, num_returns=1, timeout=60.0)
            more, _ = ray_tpu_torch.wait(watch, num_returns=len(watch), timeout=0)
            for meta_ref in (more or done):
                r, block_ref = red_inflight.pop(meta_ref)
                try:
                    meta = ray_tpu_torch.get(meta_ref, timeout=30.0)
                except Exception:  # noqa: BLE001 — surfaced on block get
                    meta = None
                ready.append((block_ref, meta))
                _tm.data_blocks_produced()
        delta = self._spill_bytes_now() - spill_before
        if delta > 0:
            self.spilled_bytes = delta
            _tm.data_shuffle_spilled(delta)
        _tm.data_blocks_in_flight(0)


# ---------------------------------------------------------------------------
# batch iteration over a block stream
# ---------------------------------------------------------------------------
def iter_batches_over_blocks(block_iter: Iterator[Tuple[Any, Optional[dict]]],
                             *, batch_size: Optional[int] = 256,
                             batch_format: str = "numpy",
                             drop_last: bool = False) -> Iterator[Any]:
    """Slice a stream of block refs into consumer batches (same carry
    semantics as ``Dataset.iter_batches``)."""
    carry: Optional[Block] = None
    for block_ref, _meta in block_iter:
        blk = ray_tpu_torch.get(block_ref) if isinstance(
            block_ref, ray_tpu_torch.ObjectRef) else block_ref
        del block_ref  # the executor's budget slot is truly released
        if carry is not None:
            blk = concat_blocks([carry, blk])
            carry = None
        acc = BlockAccessor(blk)
        n = acc.num_rows()
        bs = batch_size or n
        start = 0
        while bs and n - start >= bs:
            yield BlockAccessor(acc.slice(start, start + bs)).to_batch(
                batch_format)
            start += bs
        if start < n:
            carry = acc.slice(start, n)
    if carry is not None and not drop_last:
        yield BlockAccessor(carry).to_batch(batch_format)


def _prefetch_fill(it: Iterator[Any], q: "queue.Queue", done: Any,
                   stop: List[bool]) -> None:
    """Fill-thread body of :class:`_PrefetchIterator` (module-level so
    the thread holds no reference to the iterator object itself)."""
    def put_stoppable(item) -> bool:
        # give up when the consumer abandoned the iterator (GC/close
        # set the flag) — a blocked put would otherwise pin ``depth``
        # assembled batches and the suspended executor generator (its
        # in-flight block refs) forever
        while not stop[0]:
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    try:
        for item in it:
            if not put_stoppable(item):
                return
    except BaseException as e:  # noqa: BLE001 — forwarded to consumer
        put_stoppable(e)
    finally:
        # release the executor generator's window (in-flight refs)
        # whether the stream completed or was abandoned...
        close = getattr(it, "close", None)
        if close is not None:
            try:
                close()
            except Exception:  # noqa: BLE001 — teardown best-effort
                pass
        # ...and always terminate the stream: a consumer that catches
        # a forwarded error and calls next() again must see
        # StopIteration, not hang on a dead producer
        put_stoppable(done)


class _PrefetchIterator:
    """Assemble up to ``depth`` batches ahead of the consumer on a
    daemon thread, so the next batch's block fetch + slice overlaps the
    consumer's current step.  Prefetch hit/miss telemetry is the
    "was the batch already waiting when asked for" ratio."""

    def __init__(self, it: Iterator[Any], depth: int):
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._done = object()
        #: shared mutable stop flag: the fill thread must NOT hold a
        #: reference to this iterator object (a bound-method target
        #: would keep it alive forever, so __del__ could never fire)
        self._stop_flag: List[bool] = [False]
        self._thread = threading.Thread(
            target=_prefetch_fill,
            args=(it, self._q, self._done, self._stop_flag),
            daemon=True, name="rtpu-data-prefetch")
        self._thread.start()

    def close(self) -> None:
        self._stop_flag[0] = True

    def __del__(self):  # consumer dropped the iterator mid-stream
        self._stop_flag[0] = True

    def __iter__(self):
        return self

    def __next__(self):
        try:
            item = self._q.get_nowait()
            _tm.data_prefetch(True)
        except queue.Empty:
            _tm.data_prefetch(False)
            item = self._q.get()
        if item is self._done:
            raise StopIteration
        if isinstance(item, BaseException):
            raise item
        return item


def maybe_prefetch(it: Iterator[Any],
                   depth: Optional[int] = None) -> Iterator[Any]:
    ctx = DataContext.get_current()
    depth = ctx.streaming_prefetch_batches if depth is None else depth
    if depth and depth > 0:
        return _PrefetchIterator(it, depth)
    return it


# ---------------------------------------------------------------------------
# per-rank streaming shards (train ingest)
# ---------------------------------------------------------------------------
class StreamShard:
    """One rank's partition of a streaming dataset.

    Picklable: holds input refs/factories + the fused stage chain; the
    executor is created lazily in the *consuming* process, so the
    shard's read/map tasks are owned and submitted by the train worker
    itself — their outputs are node-local to the consumer without any
    placement machinery.  ``locality_node`` (hex node id) optionally
    pins map tasks to the rank's node with a soft affinity (used when
    the shard's consumer is co-located with a known node)."""

    def __init__(self, inputs: List[StreamInput],
                 stages: Optional[List[Tuple[str, Callable]]] = None,
                 *, shuffle: Optional[dict] = None,
                 budget: Optional[int] = None,
                 locality_node: Optional[str] = None):
        self._inputs = list(inputs)
        self._stages = list(stages or [])
        self._shuffle = shuffle
        self._budget = budget
        self._locality_node = locality_node

    def num_blocks(self) -> int:
        return len(self._inputs)

    def _block_iter(self) -> Iterator[Tuple[Any, Optional[dict]]]:
        if self._shuffle is not None:
            return StreamingShuffle(
                self._inputs, self._stages,
                seed=self._shuffle.get("seed"),
                num_reducers=self._shuffle.get("num_blocks")
                or len(self._inputs),
                budget=self._budget).iter_blocks()
        return StreamingExecutor(
            self._inputs, self._stages, budget=self._budget,
            locality_node=self._locality_node).iter_blocks()

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy", drop_last: bool = False,
                     prefetch_batches: Optional[int] = None
                     ) -> Iterator[Any]:
        return maybe_prefetch(
            iter_batches_over_blocks(self._block_iter(),
                                     batch_size=batch_size,
                                     batch_format=batch_format,
                                     drop_last=drop_last),
            prefetch_batches)

    def iter_rows(self) -> Iterator[Any]:
        for block_ref, _meta in self._block_iter():
            blk = ray_tpu_torch.get(block_ref) if isinstance(
                block_ref, ray_tpu_torch.ObjectRef) else block_ref
            yield from BlockAccessor(blk).iter_rows()

    def to_torch(self, *, batch_size: Optional[int] = 256,
                 drop_last: bool = True, device: Any = None
                 ) -> Iterator[Any]:
        """As ``Dataset.to_torch``: tensors on the consuming thread's
        CUDA device unless ``device="cpu"``, made on that thread (the
        prefetch thread assembles numpy batches only)."""
        from ray_tpu_torch.data.dataset import torch_batches

        return torch_batches(self.iter_batches(batch_size=batch_size,
                                               drop_last=drop_last), device)

    def __repr__(self) -> str:
        return (f"StreamShard(blocks={len(self._inputs)}, "
                f"stages={[n for n, _ in self._stages]}, "
                f"shuffle={self._shuffle is not None})")
