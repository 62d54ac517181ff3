"""The port's ``util.multiprocessing``, ``util.joblib``, ``util.iter``,
``util.dask``, ``util.queue`` and ``usage`` on the CPU: counterparts of
tests/test_util_shims.py's cases on one cluster for the module, and one
scenario (the same calls on the same seeded inputs) through both
packages, the JAX package's in a subprocess started with the module (the
two packages' clusters never share a process).  The scenario runs a
seeded sequence of ``Queue`` calls (``put``, ``get``, the nowait batch
calls, timeouts) that the JAX package has no test for; every result and
every exception must be the same."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.util import iter as par_iter
from ray_tpu_torch.util.multiprocessing import Pool

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# One scenario for both packages: ``run(pkg)`` returns every result as
# JSON-able values; exceptions by their class name.
_SCENARIO = textwrap.dedent("""
    import importlib
    from operator import add, mul

    import numpy as np

    def _sq(x):
        return x * x

    def _add(a, b):
        return a + b

    QUEUE_OPS = ("put", "put_nowait", "put_timeout", "get", "get_nowait",
                 "get_timeout", "put_nowait_batch", "get_nowait_batch",
                 "qsize", "empty", "full")

    def _queue_sequence(queue_mod, seed=0, n=60, maxsize=4):
        rng = np.random.default_rng(seed)
        q = queue_mod.Queue(maxsize=maxsize)
        out, next_item = [], 0
        try:
            for _ in range(n):
                op = QUEUE_OPS[int(rng.integers(len(QUEUE_OPS)))]
                k = int(rng.integers(1, 4))
                try:
                    if op in ("put", "put_nowait", "put_timeout"):
                        item, next_item = next_item, next_item + 1
                        if op == "put_nowait":
                            got = q.put_nowait(item)
                        else:  # a full queue must not block the sequence
                            got = q.put(item, timeout=0.05)
                    elif op == "get":
                        got = q.get(timeout=0.05)
                    elif op == "get_nowait":
                        got = q.get_nowait()
                    elif op == "get_timeout":
                        got = q.get(block=True, timeout=0.05)
                    elif op == "put_nowait_batch":
                        items = list(range(next_item, next_item + k))
                        next_item += k
                        got = q.put_nowait_batch(items)
                    elif op == "get_nowait_batch":
                        got = q.get_nowait_batch(k)
                    else:
                        got = getattr(q, op)()
                    out.append([op, k, "ok", got])
                except (queue_mod.Empty, queue_mod.Full) as e:
                    out.append([op, k, type(e).__name__, None])
            out.append(["final", q.qsize(), q.empty(), q.full()])
        finally:
            q.shutdown()
        return out

    def run(pkg_name):
        import sys

        import cloudpickle
        # the workers cannot import this module: its functions go by value
        cloudpickle.register_pickle_by_value(sys.modules[__name__])
        mp = importlib.import_module(pkg_name + ".util.multiprocessing")
        it = importlib.import_module(pkg_name + ".util.iter")
        dask = importlib.import_module(pkg_name + ".util.dask")
        queue_mod = importlib.import_module(pkg_name + ".util.queue")
        res = {}
        with mp.Pool(processes=2) as pool:
            res["map"] = pool.map(_sq, range(10))
            res["map_chunks"] = pool.map(_sq, range(13), chunksize=4)
            res["starmap"] = pool.starmap(_add, [(1, 2), (3, 4), (5, 6)])
            res["apply"] = pool.apply(_add, (5, 6))
            res["apply_async"] = pool.apply_async(_sq, (9,)).get(timeout=60)
            res["imap"] = list(pool.imap(_sq, range(8), chunksize=2))
            res["imap_unordered"] = sorted(
                pool.imap_unordered(_sq, range(8), chunksize=3))
        res["iter_sync"] = list(it.from_range(20, num_shards=3)
                                .for_each(lambda x: x * 2).gather_sync())
        res["iter_async"] = sorted(
            it.from_range(10, num_shards=2).filter(lambda x: x % 2 == 0)
            .for_each(lambda x: x + 1).gather_async())
        res["iter_batch"] = list(it.from_range(10, num_shards=2).batch(3)
                                 .gather_sync())
        res["iter_flatten"] = list(
            it.from_items([[1, 2], [3], [4, 5, 6]], num_shards=2)
            .flatten().gather_sync())
        res["iter_take"] = it.from_range(10, num_shards=2).take(4)
        dsk = {"a": 1, "b": (add, "a", 2), "c": (mul, "b", "b"),
               "d": (sum, ["a", "b", "c"]), "alias": "c"}
        res["dask_d"] = dask.ray_tpu_dask_get(dsk, "d")
        res["dask_keys"] = dask.ray_tpu_dask_get(
            dsk, ["c", "alias", ["a", "b"]])
        try:
            dask.ray_tpu_dask_get({"a": (add, "b", 1), "b": (add, "a", 1)},
                                  "a")
        except ValueError as e:
            res["dask_cycle"] = str(e)
        res["queue"] = _queue_sequence(queue_mod)
        return res
""")

_JAX_SCENARIO = _SCENARIO + textwrap.dedent("""
    import json, sys
    import ray_tpu
    ray_tpu.init(num_cpus=4, object_store_memory=128 * 2**20)
    try:
        print("RESULT " + json.dumps(run("ray_tpu")), flush=True)
    finally:
        ray_tpu.shutdown()
""")


@pytest.fixture(scope="module")
def jax_scenario(tmp_path_factory):
    """The scenario through the JAX package, in a subprocess started with
    the module so that it runs beside the port's cases."""
    src = tmp_path_factory.mktemp("scenario")
    (src / "shims_scenario.py").write_text(_SCENARIO)
    code = "from shims_scenario import *\n" + _JAX_SCENARIO
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [str(src), REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen([sys.executable, "-c", code],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, cwd=REPO)
    yield proc
    if proc.poll() is None:
        proc.kill()
        proc.wait(timeout=10)


@pytest.fixture(scope="module", autouse=True)
def cluster(jax_scenario):
    rt.init(num_cpus=4, object_store_memory=256 * 1024 * 1024)
    yield
    rt.shutdown()


def _sq(x):
    return x * x


def _add(a, b):
    return a + b


def test_pool_map_and_star():
    with Pool(processes=2) as pool:
        assert pool.map(_sq, range(10)) == [x * x for x in range(10)]
        assert pool.starmap(_add, [(1, 2), (3, 4)]) == [3, 7]
        assert pool.apply(_add, (5, 6)) == 11
        r = pool.apply_async(_sq, (9,))
        assert r.get(timeout=60) == 81


def test_pool_imap():
    with Pool(processes=2) as pool:
        assert list(pool.imap(_sq, range(8), chunksize=2)) == \
            [x * x for x in range(8)]
        assert sorted(pool.imap_unordered(_sq, range(8), chunksize=2)) == \
            sorted(x * x for x in range(8))


def test_joblib_backend_registers_under_the_ports_name():
    """The backend is ``"ray_tpu_torch"``: joblib's registry is global to
    the process, and the JAX package's is ``"ray_tpu"``."""
    import joblib
    from joblib.parallel import BACKENDS

    from ray_tpu_torch.util.joblib import register_ray

    had_jax = "ray_tpu" in BACKENDS
    register_ray()
    assert "ray_tpu_torch" in BACKENDS
    assert ("ray_tpu" in BACKENDS) == had_jax
    with joblib.parallel_backend("ray_tpu_torch", n_jobs=2):
        out = joblib.Parallel()(joblib.delayed(_sq)(i) for i in range(6))
    assert out == [0, 1, 4, 9, 16, 25]


def test_parallel_iterator_sync_and_async():
    it = par_iter.from_range(20, num_shards=3).for_each(lambda x: x * 2)
    assert sorted(it.gather_sync()) == sorted(x * 2 for x in range(20))
    it2 = par_iter.from_range(10, num_shards=2) \
        .filter(lambda x: x % 2 == 0).for_each(lambda x: x + 1)
    assert sorted(it2.gather_async()) == [1, 3, 5, 7, 9]


def test_parallel_iterator_batch():
    it = par_iter.from_range(10, num_shards=2).batch(3)
    batches = list(it.gather_sync())
    assert all(isinstance(b, list) for b in batches)
    assert sorted(x for b in batches for x in b) == list(range(10))


def test_dask_scheduler_on_raw_graph():
    from operator import add, mul

    from ray_tpu_torch.util.dask import ray_tpu_dask_get

    dsk = {
        "a": 1,
        "b": (add, "a", 2),          # 3
        "c": (mul, "b", "b"),        # 9
        "d": (sum, ["a", "b", "c"]),  # 13
        "alias": "c",
    }
    assert ray_tpu_dask_get(dsk, "d") == 13
    assert ray_tpu_dask_get(dsk, ["c", "alias", ["a", "b"]]) \
        == [9, 9, [1, 3]]


def test_dask_scheduler_detects_cycles():
    from operator import add

    from ray_tpu_torch.util.dask import ray_tpu_dask_get

    with pytest.raises(ValueError, match="cycle"):
        ray_tpu_dask_get({"a": (add, "b", 1), "b": (add, "a", 1)}, "a")


def test_enable_dask_gate():
    from ray_tpu_torch.util.dask import enable_dask_on_ray_tpu

    try:
        import dask  # noqa: F401
        enable_dask_on_ray_tpu()  # no error when present
    except ImportError:
        with pytest.raises(ImportError, match="dask"):
            enable_dask_on_ray_tpu()


def test_usage_telemetry_local_only(tmp_path, monkeypatch):
    from ray_tpu_torch import __version__, usage

    monkeypatch.setattr(usage, "_RECORDS", [])
    usage.record_library_usage("train")
    usage.record_library_usage("tune")
    usage.record_extra_usage_tag("mesh", "dp2xtp4")
    report = usage.usage_report()
    assert report["libraries"] == ["train", "tune"]
    assert report["tags"]["mesh"] == "dp2xtp4"
    assert report["ray_tpu_version"] == __version__
    path = usage.flush_to_session_dir(str(tmp_path))
    with open(path) as f:
        assert json.load(f)["libraries"] == ["train", "tune"]
    # the JAX package's variable does not opt the port out
    monkeypatch.setenv("RAY_TPU_USAGE_STATS_ENABLED", "0")
    usage.record_library_usage("data")
    assert "data" in usage.usage_report()["libraries"]
    # the port's does
    monkeypatch.setenv("RAY_TPU_TORCH_USAGE_STATS_ENABLED", "0")
    usage.record_library_usage("serve")
    assert "serve" not in usage.usage_report()["libraries"]


def test_queue_basic_calls():
    from ray_tpu_torch.util.queue import Empty, Full, Queue

    q = Queue(maxsize=2)
    try:
        assert q.empty() and not q.full()
        q.put(1)
        q.put_nowait(2)
        assert q.full() and q.qsize() == 2
        with pytest.raises(Full):
            q.put_nowait(3)
        with pytest.raises(Full):
            q.put(3, timeout=0.05)
        assert q.get() == 1
        assert q.get_nowait_batch(1) == [2]
        with pytest.raises(Empty):
            q.get(timeout=0.05)
        with pytest.raises(Empty):
            q.get_nowait_batch(1)
        with pytest.raises(Full):
            q.put_nowait_batch([4, 5, 6])  # takes 2 and refuses the rest
        assert q.get_nowait_batch(2) == [4, 5]
    finally:
        q.shutdown()


def test_scenario_matches_jax(jax_scenario, tmp_path, monkeypatch):
    """Pool, ParallelIterator, the dask scheduler and a seeded Queue
    sequence give the JAX package's results, and raise where it
    raises."""
    (tmp_path / "shims_scenario.py").write_text(_SCENARIO)
    monkeypatch.syspath_prepend(str(tmp_path))
    import shims_scenario
    got = json.loads(json.dumps(shims_scenario.run("ray_tpu_torch")))
    stdout, stderr = jax_scenario.communicate(timeout=240)
    assert jax_scenario.returncode == 0, stderr[-3000:]
    want = json.loads([ln for ln in stdout.splitlines()
                       if ln.startswith("RESULT ")][-1][len("RESULT "):])
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    # the sequence reached both of the queue's edges
    outcomes = {row[2] for row in want["queue"][:-1]}
    assert {"ok", "Empty", "Full"} <= outcomes, outcomes
