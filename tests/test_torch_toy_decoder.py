"""The port's torch toy decoder (``serve/toy_decoder.py``) against the
JAX package's, on the CPU: the same weights exactly, the same tokens,
the same KV page payload and the same count of step signatures (what
jit compiles once per padding bucket)."""

import numpy as np
import pytest
import torch

from ray_tpu.serve.toy_decoder import ToyDecoder as JaxToyDecoder
from ray_tpu_torch.serve.batching import default_buckets
from ray_tpu_torch.serve.toy_decoder import (ToyDecoder, ToyDecoderShard,
                                             make_prompt)

POOL = 8  # a full slot pool of the serve phase's max_batch_size


def _pool(bucket, first):
    """A full slot pool at one bucket: each slot a make_prompt request
    right-padded to the bucket, all but the last active."""
    tokens = np.zeros((POOL, bucket), np.int32)
    lengths = np.zeros((POOL,), np.int32)
    for i in range(POOL):
        prompt = make_prompt(first + i, min(bucket, 3 + (first + i) % 5))
        tokens[i, :len(prompt)] = prompt
        lengths[i] = len(prompt)
    active = np.ones((POOL,), bool)
    active[-1] = False
    return tokens, lengths, active


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_export_weights_equal_the_jax_engine(seed):
    ours = ToyDecoder(seed=seed, device="cpu").export_weights()
    theirs = JaxToyDecoder(seed=seed).export_weights()
    assert set(ours) == set(theirs)
    for name in theirs:
        assert ours[name].dtype == np.float32
        np.testing.assert_array_equal(ours[name], np.asarray(theirs[name]),
                                      err_msg=name)


def test_generate_unbatched_tokens_equal_the_jax_engine():
    ours, theirs = ToyDecoder(device="cpu"), JaxToyDecoder()
    for i in range(24):
        payload = {"prompt": make_prompt(i), "max_new_tokens": 16}
        assert ours.generate_unbatched(dict(payload)) == \
            theirs.generate_unbatched(dict(payload)), i


@pytest.mark.parametrize("bucket", default_buckets(64))
def test_step_at_every_bucket_equals_the_jax_engine(bucket):
    ours, theirs = ToyDecoder(device="cpu"), JaxToyDecoder()
    for first in (0, 8, 16):
        tokens, lengths, active = _pool(bucket, first)
        got = ours.step(tokens, lengths, active)
        assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
        np.testing.assert_array_equal(
            got.numpy(), np.asarray(theirs.step(tokens, lengths, active)))
        assert got[-1].item() == ours.pad_token  # inactive slot


@pytest.mark.parametrize("world", [1, 2, 4])
def test_shard_gang_equals_the_unsharded_engine(world):
    """Every rank's column block, combined at rank 0, gives the
    unsharded engine's tokens (and so the JAX engine's)."""
    ranks = [ToyDecoderShard(rank=r, world=world, device="cpu")
             for r in range(world)]
    whole, theirs = ToyDecoder(device="cpu"), JaxToyDecoder()
    for bucket in (8, 16):
        tokens, lengths, active = _pool(bucket, bucket)
        parts = [r.shard_step(tokens, lengths, active) for r in ranks]
        assert all(isinstance(p, np.ndarray)
                   and p.shape == (POOL, 32 // world) for p in parts)
        got = ranks[0].combine(parts, active).numpy()
        np.testing.assert_array_equal(
            got, whole.step(tokens, lengths, active).numpy())
        np.testing.assert_array_equal(
            got, np.asarray(theirs.step(tokens, lengths, active)))
    if world == 1:
        payload = {"prompt": make_prompt(5), "max_new_tokens": 12}
        assert ranks[0].generate_unbatched(dict(payload)) == \
            whole.generate_unbatched(dict(payload))


def test_kv_page_payload_equals_the_jax_engine():
    ours, theirs = ToyDecoder(seed=3, device="cpu"), JaxToyDecoder(seed=3)
    for tokens in ([2, 3, 4, 5], list(range(60, 76)), [130, 7]):
        got, want = ours.kv_page_payload(tokens), \
            theirs.kv_page_payload(tokens)
        assert got.shape == want.shape == (len(tokens), 2, 32)
        np.testing.assert_array_equal(got, want)


def test_trace_count_equals_the_jax_engine():
    """The same call sequence counts the same step signatures: one per
    new (batch, bucket) shape, again after a weight swap (the JAX engine
    re-jits), none for a repeat."""
    ours, theirs = ToyDecoder(device="cpu"), JaxToyDecoder()
    counts = []
    for bucket, swap in ((8, False), (8, False), (16, False), (8, True),
                         (32, False), (16, False)):
        if swap:
            for engine in (ours, theirs):
                engine.load_weights(JaxToyDecoder(seed=9).export_weights())
        tokens, lengths, active = _pool(bucket, 0)
        np.testing.assert_array_equal(
            ours.step(tokens, lengths, active).numpy(),
            np.asarray(theirs.step(tokens, lengths, active)))
        counts.append((ours.trace_count, theirs.trace_count))
    assert [a for a, _ in counts] == [b for _, b in counts] == \
        [1, 1, 2, 3, 4, 5]


def test_engine_defaults_to_cuda():
    if torch.cuda.is_available():
        assert ToyDecoder().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            ToyDecoder()
