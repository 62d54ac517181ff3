"""ray_tpu_torch.data Dataset: distributed blocks on the object plane.

Parity: reference ``python/ray/data/dataset.py`` (map_batches / shuffle /
sort / split / zip / iter_batches / …) with the lazy ``ExecutionPlan`` of
``data/_internal/plan.py:74``.  Blocks are ObjectRefs of numpy-column
tables (see ``block.py``); per-block transforms are fused into a single
task per block at execution time (the reference's stage fusion), and
all-to-all ops (repartition/shuffle/sort) are barriers.

``iter_batches`` produces contiguous numpy batches sized for the device,
``to_torch`` the same batches as tensors on the card (the JAX package's
``to_jax``), and ``split(n, locality_hints=…)`` places shards on the
training gang's hosts the way Ray Train consumes
``_internal/dataset_spec.py``.
"""

from __future__ import annotations

import itertools
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple, Union)

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import (Block, BlockAccessor, BlockMetadata,
                                batch_to_block, build_block, concat_blocks)

# A stage is a named per-block transform: Block -> Block (or -> List[Block]).
Stage = Tuple[str, Callable[[Block], Block]]


def _apply_stages(block: Block, stages: List[Callable[[Block], Block]]) -> Block:
    for fn in stages:
        block = fn(block)
    return block


@ray_tpu_torch.remote(num_returns=2)
def _fused_map_stats(block: Block, named_stages) -> Tuple[Block, list]:
    """materialize() body: runs each fused stage under a timer and returns
    (block, per-stage stats) as two objects so the stats travel separately
    from the (possibly large) data (parity: data/_internal/stats.py
    per-stage wall/mem accounting)."""
    import time as _time

    stats = []
    for name, fn in named_stages:
        t0 = _time.perf_counter()
        block = fn(block)
        acc = BlockAccessor(block)
        stats.append({"stage": name,
                      "wall_s": _time.perf_counter() - t0,
                      "rows": acc.num_rows(),
                      "bytes": acc.size_bytes()})
    return block, stats


@ray_tpu_torch.remote
def _fused_map_meta(block: Block, stages) -> Tuple[Block, BlockMetadata]:
    out = _apply_stages(block, stages)
    return out, BlockAccessor(out).metadata()


def _py(v):
    """numpy scalar -> python scalar for json writers."""
    return v.item() if hasattr(v, "item") else v


@ray_tpu_torch.remote
def _concat_task(*blocks: Block) -> Block:
    return concat_blocks(list(blocks))


@ray_tpu_torch.remote
def _split_task(block: Block, bounds: List[int]) -> List[Block]:
    acc = BlockAccessor(block)
    parts = [acc.slice(s, e)
             for s, e in zip([0] + bounds, bounds + [acc.num_rows()])]
    # num_returns == len(parts): a 1-part scatter must return the part
    # itself (num_returns=1 stores the return value verbatim)
    return parts[0] if len(parts) == 1 else parts


@ray_tpu_torch.remote
def _shuffle_map(block: Block, n_reducers: int, seed: Optional[int],
                 stages) -> List[Block]:
    """Map side of the pull-based shuffle (parity: data/_internal/shuffle.py)."""
    block = _apply_stages(block, stages)
    acc = BlockAccessor(block)
    n = acc.num_rows()
    rng = np.random.default_rng(seed)
    assignment = rng.integers(0, n_reducers, size=n)
    parts = [acc.take_indices(np.nonzero(assignment == r)[0])
             for r in range(n_reducers)]
    return parts[0] if n_reducers == 1 else parts


@ray_tpu_torch.remote
def _shuffle_reduce(seed: Optional[int], *parts: Block) -> Block:
    merged = concat_blocks(list(parts))
    acc = BlockAccessor(merged)
    rng = np.random.default_rng(seed)
    idx = rng.permutation(acc.num_rows())
    return acc.take_indices(idx)


@ray_tpu_torch.remote
def _block_size_bytes(block: Block) -> int:
    return BlockAccessor(block).size_bytes()


@ray_tpu_torch.remote
def _shuffle_merge(*parts: Block) -> Block:
    """Intermediate merge of one round's mapper outputs for one reducer
    (parity: the merge stage of push_based_shuffle.py:330)."""
    return concat_blocks(list(parts))


@ray_tpu_torch.remote
def _sort_sample(block: Block, key) -> np.ndarray:
    acc = BlockAccessor(block)
    if acc.num_rows() == 0:
        return np.asarray([])
    if acc.is_table:
        col = block[key] if isinstance(key, str) else key(block)
    else:
        col = np.asarray([key(r) if key else r for r in block])
    k = min(16, len(col))
    return np.sort(np.random.default_rng(0).choice(col, size=k, replace=False))


@ray_tpu_torch.remote
def _sort_map(block: Block, key, boundaries: np.ndarray,
              descending: bool) -> List[Block]:
    acc = BlockAccessor(block)
    idx = acc.sort_indices(key, descending) if acc.num_rows() else np.asarray([], int)
    block = acc.take_indices(idx)
    acc = BlockAccessor(block)
    if acc.is_table:
        col = block[key] if isinstance(key, str) else key(block)
    else:
        col = np.asarray([key(r) if key else r for r in block])
    if descending:
        cuts = len(col) - np.searchsorted(col[::-1], boundaries[::-1])
        cuts = cuts[::-1]
    else:
        cuts = np.searchsorted(col, boundaries)
    parts = []
    prev = 0
    for c in list(cuts) + [acc.num_rows()]:
        parts.append(acc.slice(int(prev), int(c)))
        prev = c
    return parts[0] if len(parts) == 1 else parts


@ray_tpu_torch.remote
def _sort_merge(key, descending: bool, *parts: Block) -> Block:
    merged = concat_blocks(list(parts))
    acc = BlockAccessor(merged)
    if acc.num_rows() == 0:
        return merged
    return acc.take_indices(acc.sort_indices(key, descending))


@ray_tpu_torch.remote
def _zip_task(a: Block, b: Block) -> Block:
    aa, bb = BlockAccessor(a), BlockAccessor(b)
    if aa.is_table and bb.is_table:
        out = dict(a)
        for k, v in b.items():
            out[k if k not in out else k + "_1"] = v
        return out
    return [(x, y) for x, y in zip(aa.iter_rows(), bb.iter_rows())]


@ray_tpu_torch.remote
def _groupby_map(block: Block, key, n_reducers: int, stages) -> List[Block]:
    block = _apply_stages(block, stages)
    acc = BlockAccessor(block)
    if acc.num_rows() == 0:
        return [] if n_reducers == 1 else [[] for _ in range(n_reducers)]
    if acc.is_table:
        col = np.asarray(block[key])
    else:
        col = np.asarray([r[key] for r in block])
    h = np.asarray([hash(x) % n_reducers for x in col])
    parts = [acc.take_indices(np.nonzero(h == r)[0])
             for r in range(n_reducers)]
    return parts[0] if n_reducers == 1 else parts


def torch_batches(batches: Iterator[Any], device: Any = None
                  ) -> Iterator[Any]:
    """numpy batches (a dict of columns, or one array) as torch tensors
    on ``device`` (``_device.resolve_device``: CUDA unless ``"cpu"``).
    They are made on the thread that iterates, when it iterates: a
    prefetch thread only assembles numpy batches, so no CUDA tensor is
    made on a thread whose current device was never set."""
    import torch

    from ray_tpu_torch._device import resolve_device

    dev = resolve_device(device)

    def tensor(v):
        a = np.ascontiguousarray(v)
        if not a.flags.writeable:  # a zero-copy view of the object store
            a = a.copy()
        return torch.from_numpy(a).to(dev)

    for batch in batches:
        if isinstance(batch, dict):
            yield {k: tensor(v) for k, v in batch.items()}
        else:
            yield tensor(batch)


def resolve_input(inp: Any) -> "ray_tpu_torch.ObjectRef":
    """One stream input -> block ref: invoke a lazy factory (submitting
    its read task now), pass a ref through.  THE shared resolution
    idiom — the batch cache and the streaming admission paths must
    never diverge on what counts as a factory."""
    if callable(inp) and not isinstance(inp, ray_tpu_torch.ObjectRef):
        return inp()
    return inp


class _InputBlocks:
    """Shared lazy input list: refs or factories (zero-arg callables
    submitting the producing read task).  Resolution is cached and
    SHARED across every Dataset derived from the same source, so a
    ``ds.map(f)`` and its parent never double-submit read tasks."""

    __slots__ = ("inputs", "refs")

    def __init__(self, inputs: List[Any]):
        self.inputs = list(inputs)
        self.refs: Optional[List[ray_tpu_torch.ObjectRef]] = None

    def resolve(self) -> List[ray_tpu_torch.ObjectRef]:
        if self.refs is None:
            self.refs = [resolve_input(b) for b in self.inputs]
        return self.refs


class Dataset:
    """Distributed data pipeline (parity: reference ``data/dataset.py``).

    Blocks may be sealed ObjectRefs or *factories* (zero-arg callables
    submitting the producing read task on demand — ``read_api`` creates
    these).  Batch execution resolves every factory up front (the old
    behavior); the streaming engine (``data/streaming.py``) admits them
    lazily inside its bounded in-flight window, so reads never
    front-load the arena.
    """

    def __init__(self, blocks: Union[List[Any], _InputBlocks],
                 stages: Optional[List[Stage]] = None,
                 metadata: Optional[List[Optional[BlockMetadata]]] = None,
                 stats: Optional[List[ray_tpu_torch.ObjectRef]] = None,
                 shuffle: Optional[Dict[str, Any]] = None):
        self._source = blocks if isinstance(blocks, _InputBlocks) \
            else _InputBlocks(blocks)
        self._stages: List[Stage] = list(stages or [])
        self._metadata = metadata if metadata and not self._stages else None
        # per-block stats refs from the materialize() that produced these
        # blocks (each resolves to a list of per-stage dicts)
        self._stats_refs = stats
        # pending streaming_shuffle marker ({"seed", "num_blocks"});
        # batch consumption resolves it through the eager random_shuffle
        self._shuffle = shuffle

    @property
    def _inputs(self) -> List[Any]:
        return self._source.inputs

    def _stream_inputs(self) -> List[Any]:
        """Inputs for the streaming engine: the RESOLVED refs when a
        batch consumer already submitted the reads (never re-read a
        file the cache holds), else the lazy factories."""
        return self._source.refs if self._source.refs is not None \
            else self._source.inputs

    @property
    def _blocks(self) -> List[ray_tpu_torch.ObjectRef]:
        """Resolved block refs: factories are submitted (all at once —
        the batch path's semantics) and cached on first access."""
        return self._source.resolve()

    # ------------------------------------------------------------------
    # plan & execution
    # ------------------------------------------------------------------
    def _with_stage(self, name: str, fn: Callable[[Block], Block]) -> "Dataset":
        if self._shuffle is not None:
            raise ValueError(
                "cannot add transforms after streaming_shuffle(); apply "
                "them before the shuffle (they fuse into its map side)")
        return Dataset(self._source, self._stages + [(name, fn)])

    def materialize(self) -> "Dataset":
        """Execute pending fused stages, one task per block (parity:
        ``ExecutionPlan.execute`` plan.py:295); per-stage wall/rows/bytes
        are recorded and surfaced by ``stats()``."""
        if self._shuffle is not None:
            # batch consumption of a streaming_shuffle marker: the eager
            # all-to-all shuffle computes the same result set
            plain = Dataset(self._source, self._stages)
            return plain.random_shuffle(
                seed=self._shuffle.get("seed"),
                num_blocks=self._shuffle.get("num_blocks")).materialize()
        if not self._stages:
            return self
        pairs = [_fused_map_stats.remote(b, self._stages)
                 for b in self._blocks]
        out = [p[0] for p in pairs]
        stats = [p[1] for p in pairs]
        return Dataset(out, stats=stats)

    def fully_executed(self) -> "Dataset":
        return self.materialize()

    def _executed_blocks(self) -> List[ray_tpu_torch.ObjectRef]:
        return self.materialize()._blocks

    def stats(self) -> str:
        """Per-stage execution summary (parity: data/_internal/stats.py).

        For an executed dataset, prints wall-time min/mean/max across
        blocks plus output rows/bytes per stage; before execution, prints
        the pending plan."""
        if self._stats_refs is None and self._stages:
            return ("Dataset(%d blocks, pending): %s" % (
                self.num_blocks(),
                " -> ".join(name for name, _ in self._stages)))
        if not self._stats_refs:
            return f"Dataset({self.num_blocks()} blocks): (materialized)"
        per_block = ray_tpu_torch.get(list(self._stats_refs))
        by_stage: Dict[str, List[Dict[str, Any]]] = {}
        order: List[str] = []
        for stats in per_block:
            for s in stats:
                if s["stage"] not in by_stage:
                    order.append(s["stage"])
                by_stage.setdefault(s["stage"], []).append(s)
        lines = [f"Dataset({self.num_blocks()} blocks) execution stats:"]
        for name in order:
            entries = by_stage[name]
            walls = [e["wall_s"] for e in entries]
            rows = sum(e["rows"] for e in entries)
            size = sum(e["bytes"] for e in entries)
            lines.append(
                f"  {name}: {len(entries)} blocks, wall "
                f"min={min(walls)*1e3:.1f}ms mean={sum(walls)/len(walls)*1e3:.1f}ms "
                f"max={max(walls)*1e3:.1f}ms, out {rows} rows / "
                f"{size/2**20:.2f} MiB")
        return "\n".join(lines)

    # ------------------------------------------------------------------
    # transforms (lazy, fused per block)
    # ------------------------------------------------------------------
    def map_batches(self, fn: Callable[..., Any], *,
                    batch_size: Optional[int] = None,
                    batch_format: str = "numpy",
                    compute: Optional[Any] = None,
                    fn_args: tuple = (), fn_kwargs: Optional[dict] = None,
                    **_ignored) -> "Dataset":
        fn_kwargs = fn_kwargs or {}

        if compute is not None and getattr(compute, "is_actor_pool", False):
            return self._map_batches_actors(fn, compute, batch_size,
                                            batch_format, fn_args, fn_kwargs)

        def stage(block: Block) -> Block:
            acc = BlockAccessor(block)
            n = acc.num_rows()
            bs = batch_size or max(n, 1)
            outs = []
            for start in range(0, max(n, 1), bs):
                sub = BlockAccessor(acc.slice(start, min(start + bs, n)))
                if n == 0 and start > 0:
                    break
                res = fn(sub.to_batch(batch_format), *fn_args, **fn_kwargs)
                outs.append(batch_to_block(res))
            return concat_blocks(outs) if outs else block

        return self._with_stage(f"map_batches({getattr(fn, '__name__', 'fn')})",
                                stage)

    def _map_batches_actors(self, fn, compute, batch_size, batch_format,
                            fn_args, fn_kwargs) -> "Dataset":
        """ActorPoolStrategy compute: callable-class transforms on a pool of
        actors (parity: data/_internal/compute.py ActorPoolStrategy)."""
        from ray_tpu_torch.util.actor_pool import ActorPool

        cls = fn if isinstance(fn, type) else None
        if cls is None:
            raise ValueError("ActorPoolStrategy requires a callable class")

        @ray_tpu_torch.remote
        class _MapWorker:
            def __init__(self):
                self._fn = cls()

            def apply(self, block, batch_size, batch_format, fn_args, fn_kwargs):
                acc = BlockAccessor(block)
                n = acc.num_rows()
                bs = batch_size or max(n, 1)
                outs = []
                for start in range(0, max(n, 1), bs):
                    sub = BlockAccessor(acc.slice(start, min(start + bs, n)))
                    res = self._fn(sub.to_batch(batch_format),
                                   *fn_args, **fn_kwargs)
                    outs.append(batch_to_block(res))
                return concat_blocks(outs) if outs else block

        pool = ActorPool([_MapWorker.remote() for _ in range(compute.size)])
        blocks = self._executed_blocks()
        out = list(pool.map(
            lambda a, b: a.apply.remote(b, batch_size, batch_format,
                                        fn_args, fn_kwargs),
            blocks))
        # map() returns values; re-put to keep everything as refs
        return Dataset([ray_tpu_torch.put(b) for b in out])

    def map(self, fn: Callable[[Any], Any], **kwargs) -> "Dataset":
        def stage(block: Block) -> Block:
            return build_block([fn(r) for r in BlockAccessor(block).iter_rows()])
        return self._with_stage(f"map({getattr(fn, '__name__', 'fn')})", stage)

    def flat_map(self, fn: Callable[[Any], Iterable[Any]], **kwargs) -> "Dataset":
        def stage(block: Block) -> Block:
            out: List[Any] = []
            for r in BlockAccessor(block).iter_rows():
                out.extend(fn(r))
            return build_block(out)
        return self._with_stage("flat_map", stage)

    def filter(self, fn: Callable[[Any], bool], **kwargs) -> "Dataset":
        def stage(block: Block) -> Block:
            acc = BlockAccessor(block)
            if acc.is_table:
                mask = np.asarray([bool(fn(r)) for r in acc.iter_rows()])
                return acc.take_indices(np.nonzero(mask)[0])
            return [r for r in acc.iter_rows() if fn(r)]
        return self._with_stage("filter", stage)

    def add_column(self, name: str, fn: Callable[[Block], np.ndarray]
                   ) -> "Dataset":
        def stage(block: Block) -> Block:
            out = dict(block)
            out[name] = np.asarray(fn(block))
            return out
        return self._with_stage(f"add_column({name})", stage)

    def drop_columns(self, cols: List[str]) -> "Dataset":
        def stage(block: Block) -> Block:
            return {k: v for k, v in block.items() if k not in cols}
        return self._with_stage("drop_columns", stage)

    def select_columns(self, cols: List[str]) -> "Dataset":
        def stage(block: Block) -> Block:
            return {k: block[k] for k in cols}
        return self._with_stage("select_columns", stage)

    # ------------------------------------------------------------------
    # all-to-all ops (barriers)
    # ------------------------------------------------------------------
    def repartition(self, num_blocks: int) -> "Dataset":
        blocks = self._executed_blocks()
        merged = _concat_task.remote(*blocks)
        total = self.count()
        per = total // num_blocks
        bounds = [per * i + min(i, total % num_blocks)
                  for i in range(1, num_blocks)]
        parts = _split_task.options(num_returns=num_blocks).remote(
            merged, bounds)
        if num_blocks == 1:
            parts = [parts]
        return Dataset(list(parts))

    def random_shuffle(self, *, seed: Optional[int] = None,
                       num_blocks: Optional[int] = None) -> "Dataset":
        from ray_tpu_torch.data.context import DataContext
        ctx = DataContext.get_current()
        n_red = num_blocks or max(self.num_blocks(), 1)
        if ctx.use_push_based_shuffle and self.num_blocks() > 2:
            return self._push_based_shuffle(
                n_red, seed, ctx.push_based_shuffle_merge_factor)
        fns = [fn for _, fn in self._stages]
        maps = [_shuffle_map.options(num_returns=n_red).remote(
            b, n_red, None if seed is None else seed + i, fns)
            for i, b in enumerate(self._blocks)]
        maps = [[m] if n_red == 1 else list(m) for m in maps]
        reduces = [
            _shuffle_reduce.remote(
                None if seed is None else seed + 1000 + r,
                *[m[r] for m in maps])
            for r in range(n_red)
        ]
        return Dataset(reduces)

    def _push_based_shuffle(self, n_red: int, seed: Optional[int],
                            merge_factor: int) -> "Dataset":
        """Two-stage pipelined shuffle (parity: PushBasedShufflePlan,
        push_based_shuffle.py:330): mappers run in rounds of
        ``merge_factor``; each round's per-reducer parts are folded into
        a running merged partial, so reducer-side memory stays bounded by
        one round and merging overlaps the next round's map work (the
        scheduler interleaves them — no barrier between rounds)."""
        fns = [fn for _, fn in self._stages]
        # per reducer, one merged partial per round; the final reduce is
        # variadic over rounds, so data moves O(B) (not a re-concat chain)
        rounds: List[List[ray_tpu_torch.ObjectRef]] = [[] for _ in range(n_red)]
        blocks = self._blocks
        for start in range(0, len(blocks), max(1, merge_factor)):
            round_blocks = blocks[start:start + max(1, merge_factor)]
            maps = [_shuffle_map.options(num_returns=n_red).remote(
                b, n_red, None if seed is None else seed + start + i, fns)
                for i, b in enumerate(round_blocks)]
            maps = [[m] if n_red == 1 else list(m) for m in maps]
            for r in range(n_red):
                rounds[r].append(_shuffle_merge.remote(
                    *[m[r] for m in maps]))
        reduces = [
            _shuffle_reduce.remote(
                None if seed is None else seed + 1000 + r, *rounds[r])
            for r in range(n_red)
        ]
        return Dataset(reduces)

    def sort(self, key: Optional[Union[str, Callable]] = None,
             descending: bool = False) -> "Dataset":
        blocks = self._executed_blocks()
        if not blocks:
            return self
        n = len(blocks)
        samples = ray_tpu_torch.get([_sort_sample.remote(b, key) for b in blocks])
        allsamp = np.sort(np.concatenate([s for s in samples if len(s)]))
        if len(allsamp) == 0:
            return Dataset(blocks)
        qs = [allsamp[int(i * len(allsamp) / n)] for i in range(1, n)]
        boundaries = np.asarray(qs)
        if descending:
            boundaries = boundaries[::-1]
        maps = [_sort_map.options(num_returns=n).remote(
            b, key, boundaries, descending) for b in blocks]
        maps = [[m] if n == 1 else list(m) for m in maps]
        merges = [_sort_merge.remote(key, descending, *[m[r] for m in maps])
                  for r in range(n)]
        return Dataset(merges)

    def zip(self, other: "Dataset") -> "Dataset":
        a = self.repartition(max(self.num_blocks(), 1))._blocks
        b = other.repartition(len(a))._blocks
        return Dataset([_zip_task.remote(x, y) for x, y in zip(a, b)])

    def union(self, *others: "Dataset") -> "Dataset":
        blocks = list(self._executed_blocks())
        for o in others:
            blocks.extend(o._executed_blocks())
        return Dataset(blocks)

    def groupby(self, key: str) -> "GroupedDataset":
        return GroupedDataset(self, key)

    def split(self, n: int, *, equal: bool = False,
              locality_hints: Optional[List[Any]] = None) -> List["Dataset"]:
        """Split into n sub-datasets by block (parity: data/_internal/split.py).
        With ``equal=True`` rows are balanced exactly (needed by Train)."""
        blocks = self._executed_blocks()
        if equal:
            total = self.count()
            per = total // n
            merged = _concat_task.remote(*blocks)
            bounds = [per * (i + 1) for i in range(n - 1)]
            parts = _split_task.options(num_returns=n).remote(merged, bounds)
            if n == 1:
                parts = [parts]
            return [Dataset([p]) for p in parts]
        out: List[List[ray_tpu_torch.ObjectRef]] = [[] for _ in range(n)]
        for i, b in enumerate(blocks):
            out[i % n].append(b)
        return [Dataset(bs) for bs in out]

    def split_at_indices(self, indices: List[int]) -> List["Dataset"]:
        blocks = self._executed_blocks()
        merged = _concat_task.remote(*blocks)
        n = len(indices) + 1
        parts = _split_task.options(num_returns=n).remote(merged, list(indices))
        if n == 1:
            parts = [parts]
        return [Dataset([p]) for p in parts]

    def limit(self, n: int) -> "Dataset":
        taken: List[ray_tpu_torch.ObjectRef] = []
        count = 0
        for b in self._executed_blocks():
            if count >= n:
                break
            blk = ray_tpu_torch.get(b)
            rows = BlockAccessor(blk).num_rows()
            if count + rows > n:
                blk = BlockAccessor(blk).slice(0, n - count)
                taken.append(ray_tpu_torch.put(blk))
                count = n
            else:
                taken.append(b)
                count += rows
        return Dataset(taken)

    def random_sample(self, fraction: float, *, seed: Optional[int] = None
                      ) -> "Dataset":
        rng_seed = seed

        def stage(block: Block) -> Block:
            acc = BlockAccessor(block)
            rng = np.random.default_rng(rng_seed)
            mask = rng.random(acc.num_rows()) < fraction
            return acc.take_indices(np.nonzero(mask)[0])
        return self._with_stage("random_sample", stage)

    # ------------------------------------------------------------------
    # consumption
    # ------------------------------------------------------------------
    def num_blocks(self) -> int:
        return len(self._inputs)

    # -- writes (reference Dataset.write_csv/json/parquet/numpy) -------
    def _write_blocks(self, path: str, writer, extension: str) -> List[str]:
        import os as _os

        _os.makedirs(path, exist_ok=True)
        blocks = self._executed_blocks()

        @ray_tpu_torch.remote
        def _write(block: Block, out_path: str) -> str:
            writer(block, out_path)
            return out_path

        outs = [
            _write.remote(b, _os.path.join(
                path, f"part-{i:05d}.{extension}"))
            for i, b in enumerate(blocks)
        ]
        return ray_tpu_torch.get(outs)

    def write_csv(self, path: str) -> List[str]:
        def w(block, out):
            BlockAccessor(block).to_pandas().to_csv(out, index=False)
        return self._write_blocks(path, w, "csv")

    def write_json(self, path: str) -> List[str]:
        def w(block, out):
            import json as _json
            df = BlockAccessor(block).to_pandas()
            with open(out, "w") as f:
                for rec in df.to_dict(orient="records"):
                    f.write(_json.dumps(
                        {k: _py(v) for k, v in rec.items()}) + "\n")
        return self._write_blocks(path, w, "json")

    def write_parquet(self, path: str) -> List[str]:
        def w(block, out):
            BlockAccessor(block).to_pandas().to_parquet(out)
        return self._write_blocks(path, w, "parquet")

    def write_numpy(self, path: str, column: str = "data") -> List[str]:
        def w(block, out):
            np.save(out, BlockAccessor(block).to_numpy(column))
        return self._write_blocks(path, w, "npy")

    def size_bytes(self) -> int:
        """Total bytes across materialized blocks (reference
        ``Dataset.size_bytes``)."""
        return int(sum(ray_tpu_torch.get(
            [_block_size_bytes.remote(b)
             for b in self._executed_blocks()])))

    def count(self) -> int:
        return int(sum(BlockAccessor(b).num_rows()
                       for b in ray_tpu_torch.get(self._executed_blocks())))

    def schema(self) -> Optional[Any]:
        for b in self._executed_blocks():
            blk = ray_tpu_torch.get(b)
            s = BlockAccessor(blk).schema()
            if s is not None:
                return s
        return None

    def take(self, n: int = 20) -> List[Any]:
        out: List[Any] = []
        for b in self._executed_blocks():
            for row in BlockAccessor(ray_tpu_torch.get(b)).iter_rows():
                out.append(row)
                if len(out) >= n:
                    return out
        return out

    def take_all(self) -> List[Any]:
        out: List[Any] = []
        for b in self._executed_blocks():
            out.extend(BlockAccessor(ray_tpu_torch.get(b)).iter_rows())
        return out

    def show(self, n: int = 20) -> None:
        for row in self.take(n):
            print(row)

    def iter_rows(self) -> Iterator[Any]:
        for b in self._executed_blocks():
            yield from BlockAccessor(ray_tpu_torch.get(b)).iter_rows()

    def iter_batches(self, *, batch_size: Optional[int] = 256,
                     batch_format: str = "numpy",
                     drop_last: bool = False,
                     prefetch_blocks: int = 1,
                     streaming: bool = False,
                     prefetch_batches: Optional[int] = None
                     ) -> Iterator[Any]:
        """Stream batches; prefetches the next block's get while the
        current one is consumed (parity: dataset.py iter_batches).

        ``streaming=True`` executes through the pull-based streaming
        engine instead (docs/data.md): reads + fused maps are admitted
        lazily inside a bounded in-flight window with backpressure, so
        iterating a dataset larger than the arena never front-loads it;
        ``prefetch_batches`` (default ``streaming_prefetch_batches``)
        assembles batches ahead of the consumer on a prefetch thread."""
        if streaming:
            from ray_tpu_torch.data import streaming as _streaming

            return _streaming.maybe_prefetch(
                _streaming.iter_batches_over_blocks(
                    self._stream_block_iter(),
                    batch_size=batch_size, batch_format=batch_format,
                    drop_last=drop_last),
                prefetch_batches)
        if self._shuffle is not None:
            return self.materialize().iter_batches(
                batch_size=batch_size, batch_format=batch_format,
                drop_last=drop_last, prefetch_blocks=prefetch_blocks)
        return self._iter_batches_batchmode(batch_size, batch_format,
                                            drop_last, prefetch_blocks)

    def _iter_batches_batchmode(self, batch_size, batch_format, drop_last,
                                prefetch_blocks) -> Iterator[Any]:
        blocks = self._executed_blocks()
        carry: Optional[Block] = None
        it = iter(blocks)
        pending: List[ray_tpu_torch.ObjectRef] = list(itertools.islice(
            it, prefetch_blocks + 1))
        while pending:
            ref = pending.pop(0)
            nxt = next(it, None)
            if nxt is not None:
                pending.append(nxt)
            blk = ray_tpu_torch.get(ref)
            if carry is not None:
                blk = concat_blocks([carry, blk])
                carry = None
            acc = BlockAccessor(blk)
            n = acc.num_rows()
            bs = batch_size or n
            start = 0
            # `bs and`: an EMPTY block with batch_size=None yields bs=0
            # and the unguarded comparison (0 - 0 >= 0) looped forever
            while bs and n - start >= bs:
                yield BlockAccessor(acc.slice(start, start + bs)).to_batch(
                    batch_format)
                start += bs
            if start < n:
                carry = acc.slice(start, n)
        if carry is not None and not drop_last:
            yield BlockAccessor(carry).to_batch(batch_format)

    def iter_torch_batches(self, **kwargs) -> Iterator[Any]:
        import torch

        for batch in self.iter_batches(**{**kwargs, "batch_format": "numpy"}):
            if isinstance(batch, dict):
                yield {k: torch.as_tensor(np.ascontiguousarray(v))
                       for k, v in batch.items()}
            else:
                yield torch.as_tensor(np.ascontiguousarray(batch))

    def iter_tf_batches(self, **kwargs) -> Iterator[Any]:
        """Batches as tf tensors (reference ``iter_tf_batches``)."""
        import tensorflow as tf

        for batch in self.iter_batches(**{**kwargs,
                                          "batch_format": "numpy"}):
            if isinstance(batch, dict):
                yield {k: tf.convert_to_tensor(v)
                       for k, v in batch.items()}
            else:
                yield tf.convert_to_tensor(batch)

    def to_tf(self, *, batch_size: int = 256):
        """A ``tf.data.Dataset`` over this dataset's batches (reference
        ``Dataset.to_tf``); built from a generator so blocks stream
        without materializing the whole dataset."""
        import tensorflow as tf

        first = next(iter(self.iter_batches(batch_size=2,
                                            batch_format="numpy")))
        if isinstance(first, dict):
            signature = {
                k: tf.TensorSpec(shape=(None,) + v.shape[1:],
                                 dtype=tf.as_dtype(v.dtype))
                for k, v in first.items()}
        else:
            signature = tf.TensorSpec(
                shape=(None,) + first.shape[1:],
                dtype=tf.as_dtype(first.dtype))
        return tf.data.Dataset.from_generator(
            lambda: self.iter_batches(batch_size=batch_size,
                                      batch_format="numpy"),
            output_signature=signature)

    def to_torch(self, *, batch_size: Optional[int] = 256,
                 drop_last: bool = True, device: Any = None
                 ) -> Iterator[Any]:
        """Batches as torch tensors on ``device``: the current CUDA
        device unless it is ``"cpu"`` (the JAX package's ``to_jax``,
        whose arrays the consumer's jit put on the device)."""
        return torch_batches(self.iter_batches(batch_size=batch_size,
                                               drop_last=drop_last), device)

    def to_pandas(self):
        import pandas as pd

        dfs = [BlockAccessor(ray_tpu_torch.get(b)).to_pandas()
               for b in self._executed_blocks()]
        return pd.concat(dfs, ignore_index=True) if dfs else pd.DataFrame()

    def to_numpy_refs(self) -> List[ray_tpu_torch.ObjectRef]:
        return self._executed_blocks()

    def get_internal_block_refs(self) -> List[ray_tpu_torch.ObjectRef]:
        return self._executed_blocks()

    # aggregations ----------------------------------------------------
    def _agg(self, np_fn, column: Optional[str]):
        vals = []
        for b in self._executed_blocks():
            blk = ray_tpu_torch.get(b)
            acc = BlockAccessor(blk)
            if acc.num_rows() == 0:
                continue
            if acc.is_table:
                col = blk[column] if column else next(iter(blk.values()))
            else:
                col = np.asarray(blk)
            vals.append(col)
        if not vals:
            return None
        return np_fn(np.concatenate(vals))

    def sum(self, on: Optional[str] = None):
        r = self._agg(np.sum, on)
        return None if r is None else r.item()

    def min(self, on: Optional[str] = None):
        r = self._agg(np.min, on)
        return None if r is None else r.item()

    def max(self, on: Optional[str] = None):
        r = self._agg(np.max, on)
        return None if r is None else r.item()

    def mean(self, on: Optional[str] = None):
        r = self._agg(np.mean, on)
        return None if r is None else r.item()

    def std(self, on: Optional[str] = None):
        r = self._agg(lambda a: np.std(a, ddof=1), on)
        return None if r is None else r.item()

    # streaming execution (data/streaming.py — docs/data.md) ----------
    def _stream_block_iter(self):
        """Block stream of this dataset's plan under the streaming
        engine (reads admitted lazily, bounded in-flight window)."""
        from ray_tpu_torch.data import streaming as _streaming

        if self._shuffle is not None:
            return _streaming.StreamingShuffle(
                self._stream_inputs(), self._stages,
                seed=self._shuffle.get("seed"),
                num_reducers=self._shuffle.get("num_blocks")
                or self.num_blocks() or 1).iter_blocks()
        return _streaming.StreamingExecutor(
            self._stream_inputs(), self._stages).iter_blocks()

    def streaming_shuffle(self, *, seed: Optional[int] = None,
                          num_blocks: Optional[int] = None) -> "Dataset":
        """Mark a full random shuffle to run inside the streaming
        engine: the partition side streams with the bounded in-flight
        budget, intermediates ride the raylet's spill tier past the
        arena, and reduce outputs are pulled lazily by the consumer.
        Batch consumption (``count``/``materialize``/...) resolves the
        marker through the eager ``random_shuffle`` — same result set,
        different execution discipline."""
        return Dataset(self._source, self._stages,
                       shuffle={"seed": seed, "num_blocks": num_blocks})

    def streaming_split(self, n: int, *, equal: bool = False,
                        locality_hints: Optional[List[Any]] = None
                        ) -> List[Any]:
        """Split into ``n`` per-rank :class:`StreamShard` iterators
        (parity: reference ``Dataset.streaming_split``).  Shards
        partition blocks round-robin and are picklable: each rank's
        shard submits its own read/map tasks when consumed, so block
        production is owned by (and node-local to) the consumer, and
        its ``iter_batches`` prefetches the next batch while the
        current step runs.  A pending ``streaming_shuffle`` shuffles
        within each shard.  ``locality_hints`` optionally pins shard i's
        map tasks to a node (hex node id) with a soft affinity.

        Streaming split is block-granular: ``equal=True`` (exact row
        balance, which needs a barrier) is not supported — use
        ``split(n, equal=True)`` for the materializing path."""
        from ray_tpu_torch.data.streaming import StreamShard

        if equal:
            raise ValueError(
                "streaming_split is block-granular; use "
                "split(n, equal=True) for exact row balance")
        if locality_hints is not None and len(locality_hints) != n:
            raise ValueError("locality_hints must have one entry per shard")
        parts: List[List[Any]] = [[] for _ in range(n)]
        for i, inp in enumerate(self._stream_inputs()):
            parts[i % n].append(inp)
        return [
            StreamShard(parts[i], self._stages, shuffle=self._shuffle,
                        locality_node=(locality_hints[i]
                                       if locality_hints else None))
            for i in range(n)]

    # pipeline --------------------------------------------------------
    def window(self, *, blocks_per_window: int = 10) -> "DatasetPipeline":
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline

        blocks = self._executed_blocks()
        windows = [Dataset(blocks[i:i + blocks_per_window])
                   for i in range(0, len(blocks), blocks_per_window)]
        return DatasetPipeline(windows)

    def repeat(self, times: Optional[int] = None) -> "DatasetPipeline":
        from ray_tpu_torch.data.dataset_pipeline import DatasetPipeline

        ds = self.materialize()
        if times:
            # fresh per-epoch views (shared blocks, private stage
            # state): per-window transforms applied while consuming one
            # epoch can never stack into the next
            return DatasetPipeline([Dataset(ds._source)
                                    for _ in range(times)])
        return DatasetPipeline(None, infinite_source=ds)

    def __repr__(self) -> str:
        return (f"Dataset(num_blocks={self.num_blocks()}, "
                f"pending_stages={[n for n, _ in self._stages]})")


class GroupedDataset:
    """Hash-partitioned groupby with map_groups / aggregations (parity:
    reference ``data/grouped_dataset.py``)."""

    def __init__(self, ds: Dataset, key: str):
        self._ds = ds
        self._key = key

    def _partitions(self) -> List[ray_tpu_torch.ObjectRef]:
        ds = self._ds
        n_red = max(ds.num_blocks(), 1)
        fns = [fn for _, fn in ds._stages]
        maps = [_groupby_map.options(num_returns=n_red).remote(
            b, self._key, n_red, fns) for b in ds._blocks]
        maps = [[m] if n_red == 1 else list(m) for m in maps]
        return [_concat_task.remote(*[m[r] for m in maps])
                for r in range(n_red)]

    def map_groups(self, fn: Callable[[Any], Any]) -> Dataset:
        key = self._key

        def apply(block: Block) -> Block:
            acc = BlockAccessor(block)
            if acc.num_rows() == 0:
                return block
            outs = []
            if acc.is_table:
                col = np.asarray(block[key])
                for val in list(dict.fromkeys(col.tolist())):
                    idx = np.nonzero(col == val)[0]
                    outs.append(batch_to_block(fn(acc.take_indices(idx))))
            else:
                groups: Dict[Any, List[Any]] = {}
                for r in acc.iter_rows():
                    groups.setdefault(r[key], []).append(r)
                for rows in groups.values():
                    outs.append(batch_to_block(fn(rows)))
            return concat_blocks(outs)

        return Dataset(self._partitions(), [("map_groups", apply)])

    def _agg(self, np_fn, on: str, name: str) -> Dataset:
        key = self._key

        def apply(block):
            acc = BlockAccessor(block)
            if acc.num_rows() == 0 or not acc.is_table:
                return block if isinstance(block, dict) else []
            col = np.asarray(block[key])
            keys, vals = [], []
            for val in list(dict.fromkeys(col.tolist())):
                idx = np.nonzero(col == val)[0]
                keys.append(val)
                vals.append(np_fn(np.asarray(block[on])[idx]))
            return {key: np.asarray(keys), name: np.asarray(vals)}

        return Dataset(self._partitions(), [(name, apply)])

    def count(self) -> Dataset:
        key = self._key

        def apply(block):
            acc = BlockAccessor(block)
            if acc.num_rows() == 0:
                return block if isinstance(block, dict) else []
            if acc.is_table:
                col = np.asarray(block[key])
            else:
                col = np.asarray([r[key] for r in acc.iter_rows()])
            keys, counts = np.unique(col, return_counts=True)
            return {key: keys, "count()": counts}

        return Dataset(self._partitions(), [("count", apply)])

    def sum(self, on: str) -> Dataset:
        return self._agg(np.sum, on, f"sum({on})")

    def min(self, on: str) -> Dataset:
        return self._agg(np.min, on, f"min({on})")

    def max(self, on: str) -> Dataset:
        return self._agg(np.max, on, f"max({on})")

    def mean(self, on: str) -> Dataset:
        return self._agg(np.mean, on, f"mean({on})")


class ActorPoolStrategy:
    """Compute strategy for map_batches on a fixed actor pool (parity:
    reference ``data/_internal/compute.py`` ``ActorPoolStrategy``)."""

    is_actor_pool = True

    def __init__(self, size: int = 2, min_size: Optional[int] = None,
                 max_size: Optional[int] = None):
        self.size = max_size or size or min_size or 2
