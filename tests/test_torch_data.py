"""The port's data plane (``ray_tpu_torch.data``) on the CPU: the core
cases of tests/test_data.py and tests/test_data_streaming.py, ``to_torch``
on a Dataset and a StreamShard, and one seeded pipeline through both
packages' data planes.  One port cluster for the file; every wait is
bounded; the JAX package's side runs in a subprocess."""

import json
import pathlib
import subprocess
import sys
import threading
import time

import cloudpickle
import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch import data as rdata
from ray_tpu_torch.data.dataset import torch_batches
from ray_tpu_torch.data.preprocessors import MinMaxScaler, StandardScaler
from ray_tpu_torch.data.streaming import StreamingExecutor

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def cluster():
    rt.init(num_cpus=4, num_gpus=0, object_store_memory=256 * 2**20)
    yield
    rt.shutdown()


def test_range_count_take():
    ds = rdata.range(100, parallelism=4)
    assert ds.count() == 100
    assert [r["id"] for r in ds.take(5)] == [0, 1, 2, 3, 4]


def test_from_numpy_and_from_items():
    arrays = [np.arange(12).reshape(3, 4), np.arange(12, 20).reshape(2, 4)]
    ds = rdata.from_numpy(arrays)
    assert ds.count() == 5
    rows = [r["data"].tolist() for r in ds.take_all()]
    assert rows == np.concatenate(arrays).tolist()
    items = rdata.from_items([{"x": i, "y": str(i)} for i in range(10)],
                             parallelism=3)
    assert sorted(r["x"] for r in items.take_all()) == list(range(10))


def test_map_batches_as_tasks():
    ds = rdata.range(64, parallelism=4).map_batches(
        lambda b: {"id": b["id"] * 3}, batch_size=8)
    assert sorted(r["id"] for r in ds.take_all()) == [3 * i for i in
                                                      range(64)]


def test_map_batches_on_an_actor_pool():
    class AddOne:
        def __call__(self, batch):
            return {"id": batch["id"] + 1}

    ds = rdata.range(40, parallelism=4).map_batches(
        AddOne, compute=rdata.ActorPoolStrategy(size=2))
    assert sorted(r["id"] for r in ds.take_all()) == list(range(1, 41))


def test_split_covers_every_row():
    parts = rdata.range(50, parallelism=5).split(3)
    ids = [r["id"] for p in parts for r in p.take_all()]
    assert len(parts) == 3 and sorted(ids) == list(range(50))


def test_streaming_split_covers_every_row():
    ds = rdata.range(60, parallelism=6).map(lambda r: {"id": r["id"] + 100})
    shards = [cloudpickle.loads(cloudpickle.dumps(s))  # to a train worker
              for s in ds.streaming_split(3)]
    per_shard = [[i for b in s.iter_batches(batch_size=7)
                  for i in b["id"].tolist()] for s in shards]
    assert sorted(i for ids in per_shard for i in ids) == list(
        range(100, 160))
    assert all(per_shard)


def test_bounded_in_flight_budget():
    """A slow consumer caps the window at the budget: blocks executing
    plus produced-but-unconsumed never exceed it."""
    inputs = [rt.put({"id": np.arange(i * 4, (i + 1) * 4)})
              for i in range(12)]
    ex = StreamingExecutor(inputs, [("x2", lambda b: {"id": b["id"] * 2})],
                           budget=3)
    seen = []
    for ref, _meta in ex.iter_blocks():
        time.sleep(0.05)  # slow consumer: the producer must stall
        seen.extend(np.asarray(rt.get(ref, timeout=60)["id"]).tolist())
    assert ex.max_observed_in_flight <= 3
    assert sorted(seen) == [2 * i for i in range(48)]
    assert ex.stall_counts["consumer"] >= 1


def test_pipeline_repeat_and_window():
    ds = rdata.range(40, parallelism=4)
    pipe = ds.window(blocks_per_window=2)
    assert sum(len(b["id"]) for b in pipe.iter_batches(batch_size=10)) == 40
    assert ds.repeat(3).count() == 120
    vals = [r["id"] for r in rdata.range(10, parallelism=2).repeat(3).map(
        lambda r: {"id": r["id"] + 1}).iter_rows()]
    assert sorted(vals) == sorted(list(range(1, 11)) * 3)


def test_preprocessors_fit_and_transform():
    ds = rdata.from_items([{"a": float(i)} for i in range(8)],
                          parallelism=2)
    out = StandardScaler(["a"]).fit(ds).transform(ds).to_pandas()
    assert abs(out["a"].mean()) < 1e-6
    out = MinMaxScaler(["a"]).fit(ds).transform(ds).to_pandas()
    assert out["a"].min() == 0.0 and out["a"].max() == 1.0


def test_dataset_to_torch_on_the_cpu():
    ds = rdata.range(32, parallelism=2)
    batches = list(ds.to_torch(batch_size=16, device="cpu"))
    assert len(batches) == 2
    assert batches[0]["id"].shape == (16,)
    assert batches[0]["id"].device.type == "cpu"
    assert batches[1]["id"].tolist() == list(range(16, 32))
    # drop_last: the ragged tail is dropped unless asked for
    assert len(list(ds.to_torch(batch_size=10, device="cpu"))) == 3
    assert len(list(ds.to_torch(batch_size=10, drop_last=False,
                                device="cpu"))) == 4
    arr = rdata.from_numpy(np.ones((6, 3), np.float32))
    (b,) = list(arr.to_torch(batch_size=6, device="cpu"))
    assert b["data"].dtype == torch.float32 and b["data"].shape == (6, 3)


def test_stream_shard_to_torch_on_the_cpu():
    rows = np.arange(64, dtype=np.int64).reshape(16, 4)
    ds = rdata.from_numpy([rows[:8], rows[8:]])
    (shard,) = ds.streaming_split(1)
    shard = cloudpickle.loads(cloudpickle.dumps(shard))
    got = [b["data"] for b in shard.to_torch(batch_size=4, device="cpu")]
    assert all(t.dtype == torch.int64 and t.device.type == "cpu"
               for t in got)
    assert torch.cat(got).tolist() == rows.tolist()
    # the tensors own their memory: the object store's blocks are
    # read-only views, and a loop may write into its batch
    got[0].add_(1)


def test_to_torch_defaults_to_cuda():
    ds = rdata.range(8, parallelism=1)
    if torch.cuda.is_available():
        assert next(iter(ds.to_torch(batch_size=4)))["id"].is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            next(iter(ds.to_torch(batch_size=4)))


def test_to_torch_makes_tensors_on_the_consuming_thread(monkeypatch):
    """Batches assembled by a prefetch thread become tensors on the
    thread that iterates: a CUDA tensor is never made on a thread whose
    current device the train worker did not set."""
    made_on = []
    real = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy", lambda a: (
        made_on.append(threading.get_ident()), real(a))[1])

    def prefetched():  # numpy batches handed over by another thread
        out = []
        t = threading.Thread(target=lambda: out.extend(
            {"x": np.full(3, i)} for i in range(4)))
        t.start()
        t.join(10)
        yield from out

    got = [b["x"].tolist() for b in torch_batches(prefetched(), "cpu")]
    assert got == [[i] * 3 for i in range(4)]
    assert made_on == [threading.get_ident()] * 4
    rows = np.arange(40, dtype=np.int64).reshape(10, 4)
    (shard,) = rdata.from_numpy([rows[:5], rows[5:]]).streaming_split(1)
    made_on.clear()
    list(shard.to_torch(batch_size=5, device="cpu"))
    assert made_on == [threading.get_ident()] * 2


# --- the same seeded pipeline through both data planes ----------------------

_PIPELINE = """
import numpy as np


def run(data, get_batches):
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 1000, (48, 5))
    ds = data.from_numpy([rows[i:i + 8] for i in range(0, 48, 8)])
    ds = ds.map_batches(lambda b: {"data": b["data"] * 2 + 1,
                                   "sum": b["data"].sum(-1)}, batch_size=4)
    ds = ds.filter(lambda r: r["sum"] % 3 != 0)
    ordered = [{k: v.tolist() for k, v in b.items()}
               for b in get_batches(ds, 6)]
    shuffled = sorted(r["sum"] for r in ds.random_shuffle(seed=5).take_all())
    split = sorted(r["sum"] for s in ds.split(2) for r in s.take_all())
    return {"ordered": ordered, "shuffled": [int(x) for x in shuffled],
            "split": [int(x) for x in split]}
"""


def _jax_side(tmp_path):
    """The pipeline through ray_tpu.data in a subprocess (the two
    packages' clusters never share a process)."""
    (tmp_path / "pipeline_def.py").write_text(_PIPELINE)
    code = (
        "import json, sys, os\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        f"sys.path[:0] = [{str(tmp_path)!r}, {str(ROOT)!r}]\n"
        "import ray_tpu\n"
        "from ray_tpu import data\n"
        "import pipeline_def\n"
        "ray_tpu.init(num_cpus=2, object_store_memory=128 * 2**20)\n"
        "try:\n"
        "    out = pipeline_def.run(data, lambda ds, n: ds.iter_batches("
        "batch_size=n))\n"
        "finally:\n"
        "    ray_tpu.shutdown()\n"
        "print('RESULT' + json.dumps(out))\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                       capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stderr[-3000:]
    line = next(ln for ln in r.stdout.splitlines() if ln.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


def test_same_pipeline_gives_the_same_batches_as_the_jax_package(tmp_path):
    """from_numpy -> map_batches -> filter: batches in the order
    iter_batches defines (block order) equal; a seeded random_shuffle
    and a split, whose row order the API does not define, compared
    sorted.  The port's batches come through to_torch on the CPU."""
    want = _jax_side(tmp_path)
    namespace = {}
    exec(_PIPELINE, namespace)

    def port_batches(ds, n):
        for b in ds.to_torch(batch_size=n, drop_last=False, device="cpu"):
            yield {k: v.numpy() for k, v in b.items()}

    got = namespace["run"](rdata, port_batches)
    assert got == want
    assert len(got["ordered"]) > 1
