"""Dataset creation APIs (parity: reference ``python/ray/data/read_api.py``
+ ``data/datasource/``).  Reads are parallel tasks, one per file/partition;
``read_parquet`` produces Arrow blocks (zero-copy through the object
plane); csv/json/numpy/text/tfrecords/images produce numpy-column or
simple blocks."""

from __future__ import annotations

import glob as glob_mod
import json
import os
from typing import Any, Dict, Iterable, List, Optional, Union

import numpy as np

import ray_tpu_torch
from ray_tpu_torch.data.block import Block, build_block
from ray_tpu_torch.data.dataset import Dataset
from ray_tpu_torch.util import failpoint as _fp


def _read_failpoint() -> None:
    """Shared fault-injection site of every file/partition read task
    (``data.read.fail`` — docs/fault_injection.md): ``kill`` here dies
    mid-read and rides the task-retry machinery like any worker crash
    (the chaos tests assert exactly-once block production); ``raise``
    surfaces as a task error to the consumer (fail-fast)."""
    _fp.failpoint("data.read.fail")


def _lazy(task, *args):
    """Lazy read input: the task is submitted only when the consumer's
    window (or a batch consumer) reaches this block — the streaming
    engine's pull handle (see ``data/streaming.py``)."""
    return lambda: task.remote(*args)


def _expand_paths(paths: Union[str, List[str]], suffix: str) -> List[str]:
    if isinstance(paths, str):
        paths = [paths]
    out: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            out.extend(sorted(glob_mod.glob(os.path.join(p, f"*{suffix}"))))
        elif any(c in p for c in "*?["):
            out.extend(sorted(glob_mod.glob(p)))
        else:
            out.append(p)
    if not out:
        raise FileNotFoundError(f"no files match {paths}")
    return out


@ray_tpu_torch.remote
def _read_csv_file(path: str, kwargs: Dict[str, Any]) -> Block:
    import pandas as pd
    _read_failpoint()

    df = pd.read_csv(path, **kwargs)
    return {str(c): df[c].to_numpy() for c in df.columns}


@ray_tpu_torch.remote
def _read_json_file(path: str) -> Block:
    _read_failpoint()
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return build_block(rows)


@ray_tpu_torch.remote
def _read_numpy_file(path: str) -> Block:
    _read_failpoint()
    return {"data": np.load(path)}


@ray_tpu_torch.remote
def _read_parquet_file(path: str, kwargs: Dict[str, Any]) -> Block:
    # arrow-native (parity: datasource/parquet_datasource.py); the Table
    # block travels the object plane with out-of-band buffers (zero-copy)
    import pyarrow.parquet as pq

    _read_failpoint()

    return pq.read_table(path, **kwargs)


@ray_tpu_torch.remote
def _range_block(start: int, stop: int, tensor_shape: Optional[tuple]) -> Block:
    _read_failpoint()
    arr = np.arange(start, stop)
    if tensor_shape:
        arr = np.stack([np.full(tensor_shape, i) for i in arr])
    return {"id": arr}


_py_range = __import__("builtins").range


def range(n: int, *, parallelism: int = 8) -> Dataset:  # noqa: A001
    parallelism = max(1, min(parallelism, n or 1))
    per = max(1, (n + parallelism - 1) // parallelism)
    blocks = [_lazy(_range_block, s, min(s + per, n), None)
              for s in _py_range(0, n, per)]
    return Dataset(blocks)


def range_tensor(n: int, *, shape: tuple = (1,), parallelism: int = 8
                 ) -> Dataset:
    parallelism = max(1, min(parallelism, n or 1))
    per = max(1, (n + parallelism - 1) // parallelism)
    blocks = [_lazy(_range_block, s, min(s + per, n), shape)
              for s in _py_range(0, n, per)]
    return Dataset(blocks)


def from_items(items: List[Any], *, parallelism: int = 8) -> Dataset:
    items = list(items)
    parallelism = max(1, min(parallelism, len(items) or 1))
    per = max(1, (len(items) + parallelism - 1) // parallelism)
    blocks = [ray_tpu_torch.put(build_block(items[i:i + per]))
              for i in _py_range(0, len(items), per)]
    return Dataset(blocks)


def from_numpy(arrays: Union[np.ndarray, List[np.ndarray]]) -> Dataset:
    if isinstance(arrays, np.ndarray):
        arrays = [arrays]
    return Dataset([ray_tpu_torch.put({"data": a}) for a in arrays])


def from_pandas(dfs) -> Dataset:
    if not isinstance(dfs, list):
        dfs = [dfs]
    blocks = []
    for df in dfs:
        blocks.append(ray_tpu_torch.put(
            {str(c): df[c].to_numpy() for c in df.columns}))
    return Dataset(blocks)


def read_csv(paths: Union[str, List[str]], **kwargs) -> Dataset:
    files = _expand_paths(paths, ".csv")
    return Dataset([_lazy(_read_csv_file, p, kwargs) for p in files])


def read_json(paths: Union[str, List[str]], **kwargs) -> Dataset:
    files = _expand_paths(paths, ".json")
    return Dataset([_lazy(_read_json_file, p) for p in files])


def read_numpy(paths: Union[str, List[str]], **kwargs) -> Dataset:
    files = _expand_paths(paths, ".npy")
    return Dataset([_lazy(_read_numpy_file, p) for p in files])


def read_parquet(paths: Union[str, List[str]], **kwargs) -> Dataset:
    files = _expand_paths(paths, ".parquet")
    return Dataset([_lazy(_read_parquet_file, p, kwargs) for p in files])


@ray_tpu_torch.remote
def _read_text_file(path: str, encoding: str, drop_empty: bool) -> Block:
    _read_failpoint()
    with open(path, encoding=encoding) as f:
        lines = [ln.rstrip("\r\n") for ln in f]
    if drop_empty:
        lines = [ln for ln in lines if ln]
    return {"text": np.asarray(lines, dtype=object)}


def read_text(paths: Union[str, List[str]], *, encoding: str = "utf-8",
              drop_empty_lines: bool = False) -> Dataset:
    """One row per line (reference ``read_text``)."""
    files = _expand_paths(paths, ".txt")
    return Dataset([_lazy(_read_text_file, p, encoding, drop_empty_lines)
                    for p in files])


def read_binary_files(paths: Union[str, List[str]], **kwargs) -> Dataset:
    @ray_tpu_torch.remote
    def _read(path: str) -> Block:
        with open(path, "rb") as f:
            return [f.read()]

    files = _expand_paths(paths, "")
    return Dataset([_read.remote(p) for p in files])


def from_arrow(tables) -> Dataset:
    """One block per pyarrow.Table (parity: ``from_arrow``)."""
    if not isinstance(tables, list):
        tables = [tables]
    return Dataset([ray_tpu_torch.put(t) for t in tables])


@ray_tpu_torch.remote
def _read_tfrecord_file(path: str) -> Block:
    """Parse a TFRecord file of tf.train.Example protos without a tf
    dependency (parity: datasource/tfrecords_datasource.py).

    Record framing: [8B length][4B masked-crc(length)][data]
    [4B masked-crc(data)].  Example protos are decoded with a minimal
    hand-rolled protobuf walk (fields: features -> feature map ->
    bytes_list/float_list/int64_list)."""
    rows = []
    with open(path, "rb") as f:
        while True:
            header = f.read(8)
            if len(header) < 8:
                break
            (length,) = __import__("struct").unpack("<Q", header)
            f.read(4)  # length crc
            data = f.read(length)
            f.read(4)  # data crc
            rows.append(_parse_tf_example(data))
    return build_block(rows)


def _read_varint(buf: bytes, pos: int):
    out = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, pos
        shift += 7


def _parse_tf_example(data: bytes) -> Dict[str, Any]:
    """Minimal decoder for tf.train.Example: Example{1: Features},
    Features{1: map<string, Feature>}, Feature{1: BytesList, 2: FloatList,
    3: Int64List}."""
    import struct as struct_mod

    def parse_fields(buf):
        pos = 0
        while pos < len(buf):
            tag, pos = _read_varint(buf, pos)
            field, wire = tag >> 3, tag & 7
            if wire == 2:  # length-delimited
                ln, pos = _read_varint(buf, pos)
                yield field, buf[pos:pos + ln]
                pos += ln
            elif wire == 0:
                val, pos = _read_varint(buf, pos)
                yield field, val
            elif wire == 5:
                yield field, buf[pos:pos + 4]
                pos += 4
            elif wire == 1:
                yield field, buf[pos:pos + 8]
                pos += 8
            else:
                raise ValueError(f"unsupported wire type {wire}")

    row: Dict[str, Any] = {}
    for f1, features in parse_fields(data):
        if f1 != 1:
            continue
        for f2, entry in parse_fields(features):
            if f2 != 1:
                continue
            name = None
            value: Any = None
            for fk, fv in parse_fields(entry):
                if fk == 1:
                    name = fv.decode()
                elif fk == 2:
                    for ft, payload in parse_fields(fv):
                        if ft == 1:  # BytesList{repeated bytes value=1}
                            vals = [v for t, v in parse_fields(payload)
                                    if t == 1]
                            value = vals[0] if len(vals) == 1 else vals
                        elif ft == 2:  # FloatList{repeated float value=1}
                            floats: List[float] = []
                            for t, v in parse_fields(payload):
                                if t != 1:
                                    continue
                                # wire 5 yields 4 bytes; packed (wire 2)
                                # yields a multiple of 4 — same decode
                                floats.extend(struct_mod.unpack(
                                    f"<{len(v)//4}f", v))
                            value = (floats[0] if len(floats) == 1
                                     else np.asarray(floats, np.float32))
                        elif ft == 3:  # Int64List{repeated int64 value=1}
                            ints: List[int] = []
                            for t, v in parse_fields(payload):
                                if t != 1:
                                    continue
                                if isinstance(v, int):  # unpacked varint
                                    ints.append(v)
                                else:  # packed varints
                                    p = 0
                                    while p < len(v):
                                        iv, p = _read_varint(v, p)
                                        ints.append(iv)
                            ints = [i - (1 << 64) if i >= 1 << 63 else i
                                    for i in ints]
                            value = (ints[0] if len(ints) == 1
                                     else np.asarray(ints, np.int64))
            if name is not None:
                row[name] = value
    return row


def read_tfrecords(paths: Union[str, List[str]], **kwargs) -> Dataset:
    """TFRecord files of tf.train.Example protos → one row per record
    (parity: ``read_tfrecords``)."""
    files = _expand_paths(paths, ".tfrecords")
    return Dataset([_lazy(_read_tfrecord_file, p) for p in files])


@ray_tpu_torch.remote
def _read_image_file(path: str, size, mode) -> Block:
    from PIL import Image  # soft dep, like the reference's datasource

    img = Image.open(path)
    if mode is not None:
        img = img.convert(mode)
    if size is not None:
        img = img.resize(size)
    return {"image": np.asarray(img)[None], "path": np.asarray([path])}


def read_images(paths: Union[str, List[str]], *, size=None, mode=None,
                **kwargs) -> Dataset:
    """Image files → rows of {"image": HWC array, "path"} (parity:
    ``read_images`` / image_datasource.py)."""
    files = _expand_paths(paths, "")
    return Dataset([_lazy(_read_image_file, p, size, mode) for p in files])


def from_huggingface(dataset) -> Dataset:
    """Convert a datasets.Dataset (hf) via its arrow table when exposed,
    else pandas."""
    table = getattr(dataset, "data", None)
    if table is not None and hasattr(table, "table"):
        return from_arrow(table.table)
    return from_pandas(dataset.to_pandas())


# ---------------------------------------------------------------------------
# database + webdataset sources
# ---------------------------------------------------------------------------
def read_sql(sql: str, connection_factory, *,
             parallelism: int = 1) -> Dataset:
    """Rows from any DBAPI-2 connection (parity: reference
    ``read_sql`` / ``sql_datasource.py``).

    ``connection_factory`` is a zero-arg callable returning a DBAPI
    connection (e.g. ``lambda: sqlite3.connect(path)``); it is pickled
    to the reading worker, so it must be importable there.  The query
    runs ONCE on one worker (DBAPI has no portable sharding);
    ``parallelism`` only controls how many blocks the result set is
    split into for downstream parallel stages.
    """
    parallelism = max(1, int(parallelism))

    @ray_tpu_torch.remote
    def _read_all() -> List[Block]:
        conn = connection_factory()
        try:
            cur = conn.cursor()
            cur.execute(sql)
            cols = [d[0] for d in cur.description]
            rows = cur.fetchall()
        finally:
            conn.close()
        if not rows:
            return [{c: np.asarray([]) for c in cols}]
        per = (len(rows) + parallelism - 1) // parallelism
        out = []
        for i in _py_range(0, len(rows), per):
            part = rows[i:i + per]
            out.append({c: np.asarray([r[j] for r in part])
                        for j, c in enumerate(cols)})
        return out

    blocks = ray_tpu_torch.get(_read_all.remote())
    return Dataset([ray_tpu_torch.put(b) for b in blocks])


def read_mongo(uri: str, database: str, collection: str, *,
               pipeline: Optional[List[dict]] = None,
               parallelism: int = 1) -> Dataset:
    """MongoDB collection → Dataset (parity: ``mongo_datasource.py``).
    Soft-dep gated on ``pymongo`` like the reference."""
    parallelism = max(1, int(parallelism))
    try:
        import pymongo  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "read_mongo requires pymongo (pip install pymongo)") from e

    @ray_tpu_torch.remote
    def _read_all() -> List[Block]:
        import pymongo as _pm
        client = _pm.MongoClient(uri)
        try:
            coll = client[database][collection]
            docs = list(coll.aggregate(list(pipeline))
                        if pipeline else coll.find())
        finally:
            client.close()
        if not docs:
            return [{"_id": np.asarray([])}]
        # one reader, split into blocks for downstream parallelism
        # (_id values aren't portably shardable: ObjectId timestamps
        # have second resolution and string _ids break $toDate; the
        # reference partitions by sampled _id ranges, which needs a
        # second server round trip — punted with this honest shape)
        per = (len(docs) + parallelism - 1) // parallelism
        out = []
        for i in _py_range(0, len(docs), per):
            part = docs[i:i + per]
            keys = sorted({k for d in part for k in d})
            out.append({k: np.asarray([d.get(k) for d in part],
                                      dtype=object) for k in keys})
        return out

    blocks = ray_tpu_torch.get(_read_all.remote())
    return Dataset([ray_tpu_torch.put(b) for b in blocks])


def read_webdataset(paths: Union[str, List[str]]) -> Dataset:
    """WebDataset tar shards → one row per sample (parity: reference
    ``webdataset_datasource.py``): files sharing a basename within a
    tar form one sample; each member becomes a column named by its
    extension, raw bytes (decode with ``map``)."""
    @ray_tpu_torch.remote
    def _read_shard(path: str) -> Block:
        import tarfile

        samples: Dict[str, Dict[str, bytes]] = {}
        order: List[str] = []
        with tarfile.open(path) as tf:
            for member in tf:
                if not member.isfile():
                    continue
                # split at the first dot of the BASENAME (tars often
                # carry './' prefixes or dotted directories); the key
                # keeps the directory so same-named samples in
                # different dirs stay distinct
                dirname, _, base = member.name.rpartition("/")
                base_stem, _, ext = base.partition(".")
                stem = f"{dirname}/{base_stem}" if dirname else base_stem
                if stem not in samples:
                    samples[stem] = {}
                    order.append(stem)
                data = tf.extractfile(member)
                samples[stem][ext or "bin"] = data.read() if data else b""
        keys = sorted({k for s in samples.values() for k in s})
        block: Dict[str, Any] = {
            "__key__": np.asarray(order, dtype=object)}
        for k in keys:
            block[k] = np.asarray(
                [samples[stem].get(k) for stem in order], dtype=object)
        return block

    files = _expand_paths(paths, ".tar")
    return Dataset([_read_shard.remote(p) for p in files])
