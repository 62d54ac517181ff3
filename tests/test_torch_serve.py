"""The port's serve plane on the CPU: the copied ContinuousBatcher
driving the torch toy decoder, and deployments on the port's own
cluster answering with exactly the JAX package's ``ToyDecoder`` tokens.

No bound here depends on the host's speed: tests hold tokens, step
shapes and counts.  One cluster for the file; every wait is bounded.
"""

import json
import time
import urllib.request

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu.serve.toy_decoder import ToyDecoder as JaxToyDecoder
from ray_tpu_torch import serve
from ray_tpu_torch.serve.batching import (BatchingConfig, ContinuousBatcher,
                                          ReplicaOverloaded,
                                          RequestCancelled,
                                          RequestDeadlineExceeded,
                                          default_buckets)
from ray_tpu_torch.serve.multiplex import MultiplexEngine
from ray_tpu_torch.serve.toy_decoder import (ToyDecoder, ToyDecoderShard,
                                             make_prompt)


def _jax_tokens(payloads, **engine_kwargs):
    ref = JaxToyDecoder(**engine_kwargs)
    return [ref.generate_unbatched(dict(p, prompt=list(p["prompt"])))
            ["tokens"] for p in payloads]


class RecordingEngine:
    """The torch engine, recording each step's occupancy (admission
    proof)."""

    def __init__(self, **kwargs):
        self.inner = ToyDecoder(device="cpu", **kwargs)
        self.eos_token, self.pad_token = None, self.inner.pad_token
        self.occupancies = []

    def begin_request(self, payload):
        return self.inner.begin_request(payload)

    def step(self, tokens, lengths, active):
        self.occupancies.append(int(np.asarray(active).sum()))
        return self.inner.step(tokens, lengths, active)

    def finish_request(self, state):
        return self.inner.finish_request(state)


# ---------------------------------------------------------------------------
# the batcher on the torch engine (no cluster)
# ---------------------------------------------------------------------------
def test_continuous_admission_at_step_boundaries():
    """A request arriving mid-decode joins the in-flight batch at the
    next step boundary, and both answer with the JAX engine's tokens."""
    eng = RecordingEngine(step_delay_s=0.01)
    b = ContinuousBatcher(eng, BatchingConfig(max_batch_size=4,
                                              max_seq_len=64), "t")
    first = {"prompt": make_prompt(0), "max_new_tokens": 30}
    second = {"prompt": make_prompt(1), "max_new_tokens": 5}
    try:
        f1 = b.submit(dict(first))
        deadline = time.monotonic() + 5
        while not eng.occupancies and time.monotonic() < deadline:
            time.sleep(0.005)
        f2 = b.submit(dict(second))
        out2 = f2.result(timeout=30)
        out1 = f1.result(timeout=30)
    finally:
        b.stop()
    assert 1 in eng.occupancies and 2 in eng.occupancies
    assert eng.occupancies.index(1) < eng.occupancies.index(2)
    jax_engine = JaxToyDecoder()
    jax_engine.eos_token = None  # the recording engine decodes to length
    assert [out1["tokens"], out2["tokens"]] == [
        jax_engine.generate_unbatched(dict(p))["tokens"]
        for p in (first, second)]


def test_no_new_signature_within_a_bucket():
    eng = ToyDecoder(device="cpu")
    b = ContinuousBatcher(eng, BatchingConfig(max_batch_size=4,
                                              max_seq_len=64), "t")
    try:
        for n in (3, 4, 5):  # all fit the 8-token bucket
            b.submit({"prompt": make_prompt(0, n),
                      "max_new_tokens": 2}).result(timeout=30)
        assert eng.trace_count == 1
        b.submit({"prompt": make_prompt(1, 20),
                  "max_new_tokens": 2}).result(timeout=30)
        assert eng.trace_count == 2
        shapes = b.stats()["step_shapes"]
        assert all(bs == 4 for bs, _ in shapes)
        assert {L for _, L in shapes} <= set(default_buckets(64))
    finally:
        b.stop()


def test_deadline_eviction_frees_slot():
    eng = ToyDecoder(step_delay_s=0.05, device="cpu")
    b = ContinuousBatcher(
        eng, BatchingConfig(max_batch_size=1, max_seq_len=64,
                            default_deadline_s=0.15), "t")
    try:
        doomed = b.submit({"prompt": [2, 3], "max_new_tokens": 500})
        with pytest.raises(RequestDeadlineExceeded):
            doomed.result(timeout=10)
        ok = b.submit({"prompt": [2], "max_new_tokens": 1},
                      deadline_s=10.0)
        assert len(ok.result(timeout=10)["tokens"]) == 1
    finally:
        b.stop()


def test_cancel_frees_slot():
    eng = ToyDecoder(step_delay_s=0.05, device="cpu")
    b = ContinuousBatcher(
        eng, BatchingConfig(max_batch_size=1, max_seq_len=64), "t")
    try:
        fut = b.submit({"prompt": [2, 3], "max_new_tokens": 500},
                       request_id="doomed")
        deadline = time.monotonic() + 5
        while b.stats()["active"] < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert b.cancel("doomed")
        with pytest.raises(RequestCancelled):
            fut.result(timeout=10)
        ok = b.submit({"prompt": [2], "max_new_tokens": 1})
        assert len(ok.result(timeout=10)["tokens"]) == 1
    finally:
        b.stop()


def test_queue_cap_sheds_with_retry_hint():
    eng = ToyDecoder(step_delay_s=0.05, device="cpu")
    b = ContinuousBatcher(
        eng, BatchingConfig(max_batch_size=1, max_seq_len=64,
                            max_queue_len=2, shed_retry_after_s=0.5), "t")
    try:
        first = b.submit({"prompt": [2], "max_new_tokens": 100})
        deadline = time.monotonic() + 5
        while b.stats()["active"] < 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        queued = [b.submit({"prompt": [2], "max_new_tokens": 100})
                  for _ in range(2)]
        with pytest.raises(ReplicaOverloaded) as ei:
            for _ in range(4):
                b.submit({"prompt": [2], "max_new_tokens": 100})
        assert ei.value.retry_after_s == 0.5
        assert b.stats()["shed_total"] >= 1
        del first, queued
    finally:
        b.stop()


def test_multiplex_swaps_models_and_answers_each_seed():
    """One continuous batch mixes requests for three seeds with room for
    two resident: every answer is that seed's JAX engine's, and the
    resident bound forces swaps and evictions."""
    eng = MultiplexEngine(
        ToyDecoder, init_kwargs={"dim": 16, "device": "cpu"},
        models={f"m{i}": {"seed": i} for i in range(3)}, max_resident=2,
        deployment="t")
    b = ContinuousBatcher(eng, BatchingConfig(max_batch_size=4,
                                              max_seq_len=64), "t")
    try:
        futs, expect = [], []
        for j in range(6):
            m = j % 3
            payload = {"prompt": make_prompt(j, 5), "max_new_tokens": 8}
            futs.append(b.submit(dict(payload, model=f"m{m}"),
                                 deadline_s=60.0))
            expect.append(_jax_tokens([payload], dim=16, seed=m)[0])
        assert [f.result(timeout=60)["tokens"] for f in futs] == expect
        st = eng.mux_stats()
        assert len(st["mux_resident_models"]) <= 2
        assert st["mux_evictions_total"] > 0 and st["mux_swaps_total"] >= 3
    finally:
        b.stop()


# ---------------------------------------------------------------------------
# deployments on the port's cluster
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def cluster():
    rt.init(num_cpus=4, num_gpus=0, object_store_memory=256 * 2**20)
    yield
    serve.shutdown()
    rt.shutdown()


def _replica_metrics(name):
    from ray_tpu_torch.serve._internal import CONTROLLER_NAME
    controller = rt.get_actor(CONTROLLER_NAME)
    table = rt.get(controller.get_routing_table.remote(-1, 1.0), timeout=30)
    entry = table["table"][name]
    return entry, rt.get(entry["replicas"][0].metrics.remote(), timeout=30)


@serve.deployment(batching={"max_batch_size": 4, "max_seq_len": 64},
                  max_concurrent_queries=64)
class Decoder(ToyDecoder):
    def __init__(self):
        # a per-step host cost so the requests overlap in flight
        super().__init__(step_delay_s=0.02, device="cpu")


def test_batched_deployment_answers_the_jax_tokens(cluster):
    handle = serve.run(Decoder.bind())
    payloads = [{"prompt": make_prompt(i), "max_new_tokens": 6}
                for i in range(12)]
    outs = rt.get([handle.remote(p) for p in payloads], timeout=120)
    assert [o["tokens"] for o in outs] == _jax_tokens(payloads)
    _, m = _replica_metrics("Decoder")
    assert m["batch_steps"] > 0
    assert all(bs == 4 for bs, _ in m["step_shapes"])
    assert {L for _, L in m["step_shapes"]} <= set(default_buckets(64))


def test_http_request_through_the_proxy(cluster):
    from ray_tpu_torch.serve.http_proxy import start_proxy

    serve.run(Decoder.bind())
    host, port = start_proxy()
    payload = {"prompt": make_prompt(3), "max_new_tokens": 8}
    req = urllib.request.Request(
        f"http://{host}:{port}/Decoder", data=json.dumps(payload).encode(),
        headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as resp:
        body = json.loads(resp.read())
    assert body["result"]["tokens"] == _jax_tokens([payload])[0]


def test_two_shard_gang_answers_the_jax_tokens(cluster):
    dep = serve.deployment(
        name="gang2", max_concurrent_queries=32,
        batching={"max_batch_size": 4, "max_seq_len": 64},
        num_shards=2)(ToyDecoderShard)
    handle = serve.run(dep.bind(device="cpu"))
    payloads = [{"prompt": make_prompt(i), "max_new_tokens": 10}
                for i in range(5)]
    outs = [handle.call(dict(p), timeout=60) for p in payloads]
    assert [o["tokens"] for o in outs] == _jax_tokens(payloads)
    entry, m = _replica_metrics("gang2")
    assert entry["num_shards"] == 2
    assert m["num_shards"] == 2 and m["attached"] and m["gang_steps"] > 0
    serve.delete("gang2")
