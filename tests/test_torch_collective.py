"""The port's ``util.collective`` on its own runtime: the JAX package's
six collective cases (``tests/test_collective.py``) with actors of
``ray_tpu_torch``, a torch tensor reduced in place, and the backends it
refuses.  Sums of small integers are exact, so the results are held
exactly."""

import numpy as np
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu_torch.util import collective as col


@pytest.fixture(scope="module", autouse=True)
def cluster():
    rt.init(num_cpus=4, num_gpus=0, object_store_memory=256 * 2**20)
    yield
    rt.shutdown()


@rt.remote
class Rank:
    """One collective participant per actor process."""

    def init_collective_group(self, world_size, rank, backend, group_name):
        col.init_collective_group(world_size, rank, backend, group_name)
        self.rank = rank
        self.world = world_size
        self.group = group_name
        return rank

    def allreduce(self, value):
        t = np.full((4,), float(value))
        return col.allreduce(t, group_name=self.group)

    def allreduce_tensor(self, value):
        """A torch tensor reduced in place: the same object comes back
        holding the sum."""
        t = torch.full((2, 3), float(value))
        out = col.allreduce(t, group_name=self.group)
        return out is t, t.numpy().copy()

    def broadcast(self):
        t = np.full((3,), float(self.rank))
        return col.broadcast(t, src_rank=1, group_name=self.group)

    def allgather(self):
        out = []
        col.allgather(out, np.array([self.rank], dtype=np.int64),
                      group_name=self.group)
        return out

    def reducescatter(self):
        shards = [np.full((2,), float(self.rank + 10 * i))
                  for i in range(self.world)]
        return col.reducescatter(np.zeros(2), shards, group_name=self.group)

    def barrier_then_rank(self):
        col.barrier(group_name=self.group)
        return self.rank

    def sendrecv(self):
        if self.rank == 0:
            col.send(np.arange(5.0), dst_rank=1, group_name=self.group)
            return None
        return col.recv(np.zeros(5), src_rank=0, group_name=self.group)

    def rank_info(self):
        return (col.get_rank(self.group),
                col.get_collective_group_size(self.group))


@pytest.fixture(scope="module")
def gang():
    """Three rank actors, which each test forms into a new group of its
    own (the rank-death case, the last, kills one)."""
    return [Rank.remote() for _ in range(3)]


def _make_group(n, group_name, gang):
    actors = gang[:n]
    col.create_collective_group(actors, n, list(range(n)),
                                group_name=group_name)
    return actors


def test_allreduce_sum(gang):
    actors = _make_group(3, "g_allreduce", gang)
    outs = rt.get([a.allreduce.remote(v) for a, v in
                   zip(actors, [1, 2, 3])], timeout=60)
    for o in outs:
        np.testing.assert_array_equal(o, np.full((4,), 6.0))


def test_allreduce_torch_tensor_in_place(gang):
    actors = _make_group(2, "g_tensor", gang)
    outs = rt.get([a.allreduce_tensor.remote(v) for a, v in
                   zip(actors, [1, 4])], timeout=60)
    for same, value in outs:
        assert same
        np.testing.assert_array_equal(value, np.full((2, 3), 5.0,
                                                     np.float32))


def test_broadcast(gang):
    actors = _make_group(3, "g_bcast", gang)
    outs = rt.get([a.broadcast.remote() for a in actors], timeout=60)
    for o in outs:
        np.testing.assert_array_equal(o, np.full((3,), 1.0))


def test_allgather(gang):
    actors = _make_group(3, "g_gather", gang)
    outs = rt.get([a.allgather.remote() for a in actors], timeout=60)
    for o in outs:
        assert [int(x[0]) for x in o] == [0, 1, 2]


def test_reducescatter(gang):
    actors = _make_group(2, "g_rs", gang)
    outs = rt.get([a.reducescatter.remote() for a in actors], timeout=60)
    # stripe r = sum over ranks of (rank + 10*r)
    np.testing.assert_array_equal(outs[0], np.full((2,), 1.0))   # 0+1
    np.testing.assert_array_equal(outs[1], np.full((2,), 21.0))  # 10+11
    assert rt.get(actors[0].rank_info.remote(), timeout=30) == (0, 2)


def test_barrier_and_sendrecv(gang):
    actors = _make_group(2, "g_p2p", gang)
    assert sorted(rt.get(
        [a.barrier_then_rank.remote() for a in actors], timeout=60)) == [0, 1]
    outs = rt.get([a.sendrecv.remote() for a in actors], timeout=60)
    np.testing.assert_array_equal(outs[1], np.arange(5.0))


def test_rank_death_fails_allreduce_on_survivors(gang):
    """A rank dying mid-collective fails the op on every member within
    the deadline (NCCL communicator-abort semantics), not leaving the
    survivors spinning on the rendezvous."""
    import time

    actors = _make_group(3, "g_death", gang)
    outs = rt.get([a.allreduce.remote(1) for a in actors], timeout=60)
    np.testing.assert_array_equal(outs[0], np.full((4,), 3.0))
    # ranks 0 and 1 enter the next allreduce; rank 2 never will
    survivors = [actors[0].allreduce.remote(2), actors[1].allreduce.remote(2)]
    time.sleep(0.5)
    rt.kill(actors[2])
    t0 = time.monotonic()
    for ref in survivors:
        with pytest.raises(Exception) as exc_info:
            rt.get(ref, timeout=120)
        msg = str(exc_info.value).lower()
        assert "died" in msg or "aborted" in msg or "collective" in msg, \
            f"wrong failure: {exc_info.value}"
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("backend", ["jax", "nccl"])
def test_only_the_object_store_backend(backend):
    with pytest.raises(ValueError, match="'object_store'"):
        col.init_collective_group(2, 0, backend=backend, group_name="g_bad")
    assert not col.is_group_initialized("g_bad")
    assert col.object_store_available()
