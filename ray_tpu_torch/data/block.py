"""Block model for ray_tpu_torch.data.

Parity: reference ``python/ray/data/block.py`` + ``_internal/arrow_block.py``
/ ``simple_block.py``.  The canonical tabular block is a dict of *numpy
columns* (``{"col": np.ndarray}``) — the layout a training input
pipeline wants (stack → ``torch.as_tensor`` → device), with zero-copy
reads from the shared-memory object plane.  Arrow tables are a first-class
second tabular kind (parity: ``_internal/arrow_block.py``): they pickle
with out-of-band buffers, so they round-trip through the shm object plane
zero-copy, and ``read_parquet`` / ``batch_format="pyarrow"`` produce and
consume them natively.  pandas interop is provided at the edges.

A block is one of:
  - a *table block*: ``dict[str, np.ndarray]`` with equal-length columns
  - an *arrow block*: ``pyarrow.Table``
  - a *simple block*: ``list`` of arbitrary Python rows
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np

try:  # soft dep: everything works without arrow, just numpy/list blocks
    import pyarrow as pa
except Exception:  # pragma: no cover - arrow is baked into this image
    pa = None

Block = Union[Dict[str, np.ndarray], List[Any], "pa.Table"]


@dataclass
class BlockMetadata:
    """Parity: reference ``data/block.py`` BlockMetadata."""

    num_rows: int
    size_bytes: int
    schema: Optional[Any] = None
    input_files: Optional[List[str]] = None


def _is_arrow(block: Any) -> bool:
    return pa is not None and isinstance(block, pa.Table)


def _copy_arrow(table) -> "pa.Table":
    """Materialize a table into self-contained buffers (drops any parent
    buffer a slice view would otherwise keep alive — and keep pickling)."""
    sink = pa.BufferOutputStream()
    with pa.ipc.new_stream(sink, table.schema) as writer:
        writer.write_table(table)
    return pa.ipc.open_stream(sink.getvalue()).read_all()


def _arrow_col_to_numpy(col) -> np.ndarray:
    arr = col.combine_chunks() if hasattr(col, "combine_chunks") else col
    try:
        return arr.to_numpy(zero_copy_only=True)
    except Exception:
        return arr.to_numpy(zero_copy_only=False)


class BlockAccessor:
    """Uniform access over table/arrow/simple blocks (parity:
    ``data/block.py`` ``BlockAccessor``; arrow paths mirror
    ``_internal/arrow_block.py`` ArrowBlockAccessor)."""

    def __init__(self, block: Block):
        self._block = block
        self._is_arrow = _is_arrow(block)
        self._is_table = isinstance(block, dict)

    @staticmethod
    def for_block(block: Block) -> "BlockAccessor":
        return BlockAccessor(block)

    @property
    def is_table(self) -> bool:
        return self._is_table or self._is_arrow

    @property
    def is_arrow(self) -> bool:
        return self._is_arrow

    def num_rows(self) -> int:
        if self._is_arrow:
            return self._block.num_rows
        if self._is_table:
            if not self._block:
                return 0
            return len(next(iter(self._block.values())))
        return len(self._block)

    def size_bytes(self) -> int:
        if self._is_arrow:
            return int(self._block.nbytes)
        if self._is_table:
            return int(sum(v.nbytes if isinstance(v, np.ndarray) else 64
                           for v in self._block.values()))
        # rough estimate for python rows
        return 64 * len(self._block)

    def schema(self) -> Optional[Any]:
        if self._is_arrow:
            return self._block.schema
        if self._is_table:
            return {k: (v.dtype, v.shape[1:]) for k, v in self._block.items()}
        if self._block:
            return type(self._block[0])
        return None

    def column_names(self) -> List[str]:
        if self._is_arrow:
            return list(self._block.column_names)
        if self._is_table:
            return list(self._block.keys())
        return []

    def metadata(self, input_files: Optional[List[str]] = None
                 ) -> BlockMetadata:
        return BlockMetadata(self.num_rows(), self.size_bytes(),
                             self.schema(), input_files)

    # -- row / batch iteration ---------------------------------------
    def iter_rows(self) -> Iterator[Any]:
        if self._is_arrow:
            for batch in self._block.to_batches():
                yield from batch.to_pylist()
            return
        if self._is_table:
            cols = list(self._block.items())
            for i in range(self.num_rows()):
                yield {k: v[i] for k, v in cols}
        else:
            yield from self._block

    def slice(self, start: int, end: int) -> Block:
        if self._is_arrow:
            # COPY, don't view: pickling an arrow slice serializes the
            # whole parent buffer (measured: a 10-row slice of a 1M-row
            # table pickles to 8 MB), so views multiply full-table copies
            # through the object store.  Same choice as the reference's
            # ArrowBlockAccessor.slice(copy=True) for split/shuffle parts.
            return _copy_arrow(self._block.slice(start, end - start))
        if self._is_table:
            return {k: v[start:end] for k, v in self._block.items()}
        return self._block[start:end]

    def to_pandas(self):
        import pandas as pd

        if self._is_arrow:
            return self._block.to_pandas()
        if self._is_table:
            return pd.DataFrame(
                {k: list(v) if v.ndim > 1 else v
                 for k, v in self._block.items()})
        return pd.DataFrame(self._block)

    def to_numpy(self, column: Optional[str] = None):
        if self._is_arrow:
            if column is not None:
                return _arrow_col_to_numpy(self._block.column(column))
            cols = {name: _arrow_col_to_numpy(self._block.column(name))
                    for name in self._block.column_names}
            if len(cols) == 1:
                return next(iter(cols.values()))
            return cols
        if self._is_table:
            if column is not None:
                return self._block[column]
            if len(self._block) == 1:
                return next(iter(self._block.values()))
            return self._block
        return np.asarray(self._block)

    def to_arrow(self):
        if pa is None:
            raise ImportError("pyarrow is not available")
        if self._is_arrow:
            return self._block
        if self._is_table:
            return pa.table({k: np.asarray(v)
                             for k, v in self._block.items()})
        return pa.Table.from_pylist(list(self.iter_rows()))

    def to_batch(self, batch_format: str = "numpy"):
        if batch_format in ("numpy", "default"):
            if self._is_arrow:
                return {name: _arrow_col_to_numpy(self._block.column(name))
                        for name in self._block.column_names}
            if self._is_table:
                return self._block
            return np.asarray(self._block)
        if batch_format == "pandas":
            return self.to_pandas()
        if batch_format in ("pyarrow", "arrow"):
            return self.to_arrow()
        if batch_format == "pylist":
            return list(self.iter_rows())
        raise ValueError(f"unknown batch_format: {batch_format}")

    # -- sorting helpers ----------------------------------------------
    def sort_indices(self, key: Any, descending: bool = False) -> np.ndarray:
        if self._is_arrow:
            col = (_arrow_col_to_numpy(self._block.column(key))
                   if isinstance(key, str) else key(self._block))
            idx = np.argsort(col, kind="stable")
        elif self._is_table:
            col = self._block[key] if isinstance(key, str) else key(self._block)
            idx = np.argsort(col, kind="stable")
        else:
            if key is None:
                vals = self._block
            else:
                vals = [key(r) for r in self._block]
            idx = np.argsort(np.asarray(vals), kind="stable")
        return idx[::-1] if descending else idx

    def take_indices(self, idx: np.ndarray) -> Block:
        if self._is_arrow:
            return self._block.take(pa.array(np.asarray(idx, dtype=np.int64)))
        if self._is_table:
            return {k: v[idx] for k, v in self._block.items()}
        return [self._block[i] for i in idx]


def build_block(rows: List[Any]) -> Block:
    """Build the canonical block type from a list of rows: dict rows
    become a table block of numpy columns, everything else a simple block."""
    if rows and all(isinstance(r, dict) for r in rows):
        keys = rows[0].keys()
        if all(r.keys() == keys for r in rows):
            return {k: np.asarray([r[k] for r in rows]) for k in keys}
    return list(rows)


def concat_blocks(blocks: List[Block]) -> Block:
    blocks = [b for b in blocks if BlockAccessor(b).num_rows() > 0]
    if not blocks:
        return []
    if all(_is_arrow(b) for b in blocks):
        return pa.concat_tables(blocks) if len(blocks) > 1 else blocks[0]
    if any(_is_arrow(b) for b in blocks):
        # mixed: normalize arrow members to numpy-column tables
        blocks = [BlockAccessor(b).to_batch("numpy") if _is_arrow(b) else b
                  for b in blocks]
    if all(isinstance(b, dict) for b in blocks):
        keys = blocks[0].keys()
        return {k: np.concatenate([b[k] for b in blocks]) for k in keys}
    out: List[Any] = []
    for b in blocks:
        out.extend(BlockAccessor(b).iter_rows())
    return out


def batch_to_block(batch: Any) -> Block:
    """Normalize a user map_batches return value into a block."""
    import pandas as pd

    if _is_arrow(batch):
        return batch
    if isinstance(batch, dict):
        return {k: np.asarray(v) for k, v in batch.items()}
    if isinstance(batch, pd.DataFrame):
        return {str(k): batch[k].to_numpy() for k in batch.columns}
    if isinstance(batch, np.ndarray):
        return {"data": batch}
    if isinstance(batch, list):
        return build_block(batch)
    raise TypeError(f"cannot convert batch of type {type(batch)} to a block")
