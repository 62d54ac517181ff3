"""The port's RL path end to end on the CPU: the counterparts of the JAX
package's ``tests/test_rllib.py`` and of ``tests/test_rllib_pipeline.py``'s
cases, at the same sizes and thresholds, with the learner named onto
the CPU (``num_gpus_per_learner=0``).  The distributed cases run on the
port's runtime (``ray_tpu_torch.init``), whose workers import torch and
never JAX."""

import os

import numpy as np
import pytest

import ray_tpu_torch as rt
from ray_tpu_torch.rllib import (CartPole, MultiAgentCartPole, RandomEnv,
                                 SampleBatch, concat_samples)
from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOPolicy
from ray_tpu_torch.rllib.env import (CartPoleVector, SyncVectorEnv,
                                     as_vector_env)
from ray_tpu_torch.rllib.inference import InferenceBatcher, inference_buckets
from ray_tpu_torch.rllib.postprocessing import compute_gae
from ray_tpu_torch.rllib.rollout_worker import RolloutWorker


@pytest.fixture(scope="module")
def cluster():
    # the cluster's processes inherit the driver's environment: one
    # intra-op thread a sampler, so that the test run's parallel files
    # do not share the host's cores with a torch pool per sampler
    old = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        rt.init(num_cpus=4, num_gpus=0, object_store_memory=256 * 2**20)
    finally:
        if old is None:
            del os.environ["OMP_NUM_THREADS"]
        else:
            os.environ["OMP_NUM_THREADS"] = old
    yield
    rt.shutdown()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for the driver's own learners (the local
    worker's PPO updates): under the suite's ``-n 6`` six pools of a
    thread per core on the same cores spend the time waiting for each
    other on these small networks."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _config():
    return PPOConfig().resources(num_gpus_per_learner=0)


def _leaves(weights):
    return np.concatenate([np.ravel(weights[k]) for k in sorted(weights)])


# -- tests/test_rllib.py's cases ----------------------------------------------

def test_sample_batch_ops():
    b1 = SampleBatch({"obs": np.ones((3, 2)), "rewards": np.arange(3.0)})
    b2 = SampleBatch({"obs": np.zeros((2, 2)), "rewards": np.arange(2.0)})
    cat = concat_samples([b1, b2])
    assert len(cat) == 5
    mb = list(cat.minibatches(2, np.random.default_rng(0)))
    assert all(len(m) == 2 for m in mb)


def test_gae_terminal_matches_returns():
    batch = SampleBatch({
        SampleBatch.REWARDS: np.array([1.0, 1.0, 1.0]),
        SampleBatch.VF_PREDS: np.zeros(3, np.float32),
    })
    out = compute_gae(batch, 0.0, gamma=1.0, lambda_=1.0)
    np.testing.assert_allclose(out[SampleBatch.VALUE_TARGETS], [3, 2, 1])
    np.testing.assert_allclose(out[SampleBatch.ADVANTAGES], [3, 2, 1])


def test_rollout_worker_collects_fragments():
    w = RolloutWorker(RandomEnv, PPOPolicy,
                      {"rollout_fragment_length": 25,
                       "num_envs_per_worker": 2, "seed": 0,
                       "_device": "cpu",
                       "env_config": {"episode_len": 10}})
    batch = w.sample()
    assert len(batch) == 50
    assert SampleBatch.ADVANTAGES in batch
    m = w.metrics()
    assert len(m["episode_returns"]) >= 2  # 10-step episodes completed
    # eps ids partition the batch into contiguous chunks
    assert len(batch.split_by_episode()) >= 4


def test_ppo_local_smoke():
    config = (_config()
              .environment(RandomEnv, env_config={"episode_len": 8})
              .rollouts(rollout_fragment_length=16, num_envs_per_worker=2)
              .training(train_batch_size=64, sgd_minibatch_size=32,
                        num_sgd_iter=2)
              .debugging(seed=0))
    algo = config.build()
    r1 = algo.train()
    assert r1["training_iteration"] == 1
    assert r1["timesteps_total"] >= 64
    assert np.isfinite(r1["total_loss"])
    algo.stop()


def test_ppo_learns_cartpole_short():
    """A few iterations must push episode reward clearly above random
    (~22 for random CartPole policy)."""
    config = (_config()
              .environment(CartPole,
                           env_config={"max_episode_steps": 200})
              .rollouts(rollout_fragment_length=256,
                        num_envs_per_worker=4)
              .training(train_batch_size=1024, sgd_minibatch_size=128,
                        num_sgd_iter=6, lr=3e-4, entropy_coeff=0.01)
              .debugging(seed=0))
    algo = config.build()
    best = 0.0
    for _ in range(8):
        result = algo.train()
        best = max(best, result["episode_reward_mean"])
    algo.stop()
    assert best > 40.0, f"PPO failed to learn: best={best}"


@pytest.mark.usefixtures("cluster")
def test_ppo_distributed_rollouts():
    config = (_config()
              .environment(RandomEnv, env_config={"episode_len": 8})
              .rollouts(num_rollout_workers=2, rollout_fragment_length=16,
                        num_envs_per_worker=1)
              .training(train_batch_size=64, sgd_minibatch_size=32,
                        num_sgd_iter=2)
              .debugging(seed=0))
    algo = config.build()
    result = algo.train()
    assert result["num_env_steps_sampled_this_iter"] >= 64
    # remote workers got the new weights
    local = algo.workers.local_worker.get_weights()
    remote = rt.get(
        algo.workers.remote_workers[0].get_weights.remote(), timeout=30)
    np.testing.assert_allclose(_leaves(local), _leaves(remote), rtol=1e-6)
    # the samplers hold their policies on the host
    assert rt.get(algo.workers.remote_workers[0].apply.remote(
        lambda w: (str(w.policy.device), __import__("torch")
                   .get_num_threads())), timeout=30) == ("cpu", 1)
    algo.stop()


@pytest.mark.usefixtures("cluster")
def test_ppo_sample_async_overlap():
    """sample_async keeps one fragment in flight per worker through the
    learner update (the LearnerThread shape); training still progresses,
    metrics flow via the piggyback path, and weights reach the fleet."""
    config = (_config()
              .environment(CartPole,
                           env_config={"max_episode_steps": 50})
              .rollouts(num_rollout_workers=2, rollout_fragment_length=64,
                        num_envs_per_worker=2, sample_async=True)
              .training(train_batch_size=256, sgd_minibatch_size=64,
                        num_sgd_iter=2)
              .debugging(seed=0))
    algo = config.build()
    total = 0
    for _ in range(3):
        result = algo.train()
        total += result["num_env_steps_sampled_this_iter"]
        assert np.isfinite(result["total_loss"])
    assert total >= 3 * 256
    assert result["episodes_this_iter"] >= 0
    assert np.isfinite(result["episode_reward_mean"])
    assert result["episode_reward_mean"] != 0.0
    # the non-blocking broadcast still converges the fleet's weights
    algo._inflight.clear()
    local = _leaves(algo.workers.local_worker.get_weights())
    remote = _leaves(rt.get(
        algo.workers.remote_workers[0].get_weights.remote(), timeout=60))
    np.testing.assert_allclose(local, remote, rtol=1e-5)
    algo.stop()


def test_checkpoint_restore(tmp_path):
    """A checkpoint round trip restores the weights and Adam's moments:
    the next update from the restored learner equals the original's."""
    config = (_config()
              .environment(RandomEnv, env_config={"episode_len": 8})
              .rollouts(rollout_fragment_length=16)
              .training(train_batch_size=32, sgd_minibatch_size=16,
                        num_sgd_iter=1)
              .debugging(seed=0))
    algo = config.build()
    algo.train()
    path = algo.save(str(tmp_path / "ckpt"))
    obs = np.zeros((1, 4), np.float32)
    before = algo.get_policy().compute_values(obs)

    algo2 = config.build()
    algo2.restore(path)
    after = algo2.get_policy().compute_values(obs)
    np.testing.assert_allclose(before, after, rtol=1e-6)
    assert algo2.iteration == 1
    p1, p2 = algo.get_policy(), algo2.get_policy()
    state = p2.get_state()["opt_state"]["state"]
    assert state and all(s["count"] == 2 for s in state.values())
    batch = algo.workers.local_worker.sample()
    p2.kl_coeff = p1.kl_coeff  # adapted by train(), not checkpointed
    p2._np_rng = np.random.default_rng(1)
    p1._np_rng = np.random.default_rng(1)
    p1.learn_on_batch(batch.copy())
    p2.learn_on_batch(batch.copy())
    for k, v in p1.get_weights().items():
        np.testing.assert_array_equal(p2.get_weights()[k], v, err_msg=k)
    algo.stop()
    algo2.stop()


# -- tests/test_rllib_pipeline.py's cases -------------------------------------

def test_cartpole_vector_matches_scalar_semantics():
    vec = CartPoleVector(3, {"max_episode_steps": 10, "seed": 0})
    obs = vec.reset_all()
    assert obs.shape == (3, 4)
    seen_done = False
    for _ in range(12):
        obs, rew, term, trunc = vec.step(np.ones(3, np.int64))
        assert obs.shape == (3, 4) and rew.shape == (3,)
        if (term | trunc).any():
            seen_done = True
            done = term | trunc
            assert np.all(np.abs(obs[done]) <= 0.05 + 1e-6)
    assert seen_done


def test_sync_vector_env_fallback_autoresets():
    vec = as_vector_env(RandomEnv, 2, {"episode_len": 3, "seed": 0})
    assert isinstance(vec, SyncVectorEnv)
    vec.reset_all()
    dones = 0
    for _ in range(7):
        _, _, term, trunc = vec.step(np.zeros(2, np.int64))
        dones += int((term | trunc).sum())
    assert dones == 4


def test_as_vector_env_uses_native_cartpole():
    assert isinstance(as_vector_env(CartPole, 4, {"seed": 0}),
                      CartPoleVector)
    assert isinstance(as_vector_env("CartPole-v1", 4, {"seed": 0}),
                      CartPoleVector)


def test_inference_buckets_are_powers_of_two():
    assert inference_buckets(100) == (8, 16, 32, 64, 128)
    assert inference_buckets(8) == (8,)


def _policy():
    env = CartPole({})
    return PPOPolicy(env.observation_space, env.action_space,
                     {"_device": "cpu", "seed": 0})


def test_batcher_coalesces_concurrent_requests():
    """K requests queued at one dispatch boundary become ONE padded
    forward; per-request slices come back row-exact."""
    batcher = InferenceBatcher(_policy(), max_rows=64, max_wait_s=0.02)
    for _ in range(4):
        batcher.register_client()
    obs = [np.full((5, 4), i, np.float32) for i in range(4)]
    futs = [batcher.submit(o) for o in obs]
    outs = [f.result(timeout=10) for f in futs]
    for actions, extras, version in outs:
        assert actions.shape == (5,)
        assert extras["vf_preds"].shape == (5,)
        assert extras["action_logp"].shape == (5,)
        assert version == 0
    # rows of one request share its obs: equal values for equal inputs
    for i, (_, extras, _) in enumerate(outs):
        np.testing.assert_allclose(
            extras["vf_preds"],
            _policy().compute_values(obs[i]), rtol=1e-6)
    stats = batcher.stats()
    assert stats["rows"] == 20
    assert stats["dispatches"] <= 2
    batcher.stop()


def test_batcher_no_recompile_within_bucket():
    """Varying request sizes inside one bucket must produce ONE batch
    shape; only a bucket change adds a shape."""
    calls = []

    class CountingPolicy:
        def compute_actions(self, obs):
            calls.append(obs.shape)
            n = obs.shape[0]
            return np.zeros(n, np.int64), {
                "action_logp": np.zeros(n, np.float32),
                "vf_preds": np.zeros(n, np.float32)}

        def set_weights(self, w):
            pass

    batcher = InferenceBatcher(CountingPolicy(), max_rows=64,
                               max_wait_s=0.0)
    for rows in (3, 7, 5, 8, 2, 6):
        batcher.submit(np.zeros((rows, 4), np.float32)).result(timeout=10)
    assert set(calls) == {(8, 4)}
    batcher.submit(np.zeros((9, 4), np.float32)).result(timeout=10)
    assert set(calls) == {(8, 4), (16, 4)}
    assert batcher.stats()["batch_shapes"] == [(8,), (16,)]
    batcher.stop()


def test_batcher_set_weights_versions_replies():
    batcher = InferenceBatcher(_policy(), max_rows=16, max_wait_s=0.0)
    _, _, v0 = batcher.submit(
        np.zeros((2, 4), np.float32)).result(timeout=10)
    assert v0 == 0
    batcher.set_weights(_policy().get_weights(), 7)
    _, _, v1 = batcher.submit(
        np.zeros((2, 4), np.float32)).result(timeout=10)
    assert v1 == 7
    batcher.stop()


def test_batcher_oversized_request_chunks():
    batcher = InferenceBatcher(_policy(), max_rows=16, max_wait_s=0.0)
    actions, extras, _ = batcher.submit(
        np.zeros((40, 4), np.float32)).result(timeout=10)
    assert actions.shape == (40,)
    assert extras["vf_preds"].shape == (40,)
    batcher.stop()


def test_batcher_engine_error_fails_only_that_batch():
    class FlakyPolicy:
        def __init__(self):
            self.fail_next = False

        def compute_actions(self, obs):
            if self.fail_next:
                self.fail_next = False
                raise RuntimeError("boom")
            n = obs.shape[0]
            return np.zeros(n, np.int64), {
                "vf_preds": np.zeros(n, np.float32)}

    pol = FlakyPolicy()
    batcher = InferenceBatcher(pol, max_rows=16, max_wait_s=0.0)
    pol.fail_next = True
    with pytest.raises(RuntimeError, match="boom"):
        batcher.submit(np.zeros((2, 4), np.float32)).result(timeout=10)
    actions, _, _ = batcher.submit(
        np.zeros((2, 4), np.float32)).result(timeout=10)
    assert actions.shape == (2,)
    batcher.stop()


@pytest.mark.usefixtures("cluster")
class TestDecoupledPipeline:
    def _build(self, **training):
        config = (_config()
                  .environment(CartPole,
                               env_config={"max_episode_steps": 50})
                  .rollouts(num_rollout_workers=2, decoupled=True,
                            rollout_fragment_length=32,
                            rl_envs_per_actor=8)
                  .training(**{"train_batch_size": 512,
                               "sgd_minibatch_size": 128,
                               "num_sgd_iter": 2, **training})
                  .debugging(seed=0))
        return config.build()

    def test_fragments_ordered_and_versioned(self):
        algo = self._build()
        pipe = algo._pipeline
        assert pipe is not None
        for _ in range(3):
            r = algo.train()
            assert np.isfinite(r["total_loss"])
        assert set(pipe._last_seq) == {0, 1}
        assert all(seq >= 2 for seq in pipe._last_seq.values())
        assert pipe.version == 1 + algo.iteration
        st = pipe.stats()
        infer = st["inference"][0]
        assert infer["dispatches"] > 0
        assert all(s[0] & (s[0] - 1) == 0
                   for s in infer["batch_shapes"])
        assert r["num_env_steps_sampled_this_iter"] >= 512
        # the inference actor acts on the host, as the JAX package's
        assert rt.get(pipe.inference_actors[0].device.remote(),
                      timeout=30) == "cpu"
        v = pipe.version
        pipe.publish_weights(algo.workers.local_worker.get_weights())
        assert pipe.version == v + 1
        algo.stop()

    def test_staleness_bound_drops_old_fragments(self):
        algo = self._build()
        pipe = algo._pipeline
        algo.train()
        before = pipe.stale_dropped
        pipe.version += 10
        pipe.publish_weights(algo.workers.local_worker.get_weights())
        r = algo.train()
        assert pipe.stale_dropped > before
        assert np.isfinite(r["total_loss"])
        assert r["num_env_steps_sampled_this_iter"] >= 512
        algo.stop()

    def test_learning_progress_smoke(self):
        algo = self._build(num_sgd_iter=4, lr=3e-4, entropy_coeff=0.01)
        best = 0.0
        for _ in range(10):
            result = algo.train()
            if np.isfinite(result["episode_reward_mean"]):
                best = max(best, result["episode_reward_mean"])
        algo.stop()
        # random CartPole is ~22; the 50-step cap bounds episodes
        assert best > 30.0, f"decoupled PPO failed to learn: best={best}"


def _shared(agent_id):
    return "shared"


def test_decoupled_falls_back_without_env_actors():
    """decoupled=True must quietly keep the classic paths for configs
    the pipeline does not serve: here, no env actors (0 workers)."""
    config = (_config()
              .environment(CartPole, env_config={"max_episode_steps": 20})
              .rollouts(num_rollout_workers=0, decoupled=True)
              .training(train_batch_size=64, sgd_minibatch_size=32,
                        num_sgd_iter=1)
              .debugging(seed=0))
    algo = config.build()   # 0 workers -> no pipeline, local sampling
    assert algo._pipeline is None
    r = algo.train()
    assert np.isfinite(r["total_loss"])
    algo.stop()


@pytest.mark.usefixtures("cluster")
@pytest.mark.parametrize("case", ["multi_agent", "recurrent"])
def test_decoupled_falls_back_for_multi_agent_and_recurrent(case):
    """With env actors asked for, multi-agent and recurrent configs keep
    the per-worker-policy path: the workers sample, no pipeline."""
    config = (_config()
              .rollouts(num_rollout_workers=2, decoupled=True,
                        rollout_fragment_length=16)
              .training(train_batch_size=64, sgd_minibatch_size=32,
                        num_sgd_iter=1)
              .debugging(seed=0))
    if case == "multi_agent":
        config.environment(MultiAgentCartPole,
                           env_config={"num_agents": 2,
                                       "max_episode_steps": 20})
        config.multi_agent(policies={"shared": None},
                           policy_mapping_fn=_shared)
    else:
        config.environment(CartPole, env_config={"max_episode_steps": 20})
        config.training(model={"use_lstm": True, "max_seq_len": 8,
                               "lstm_cell_size": 16})
    algo = config.build()
    assert algo._pipeline is None
    assert len(algo.workers.remote_workers) == 2
    r = algo.train()
    loss = r["shared/total_loss" if case == "multi_agent" else "total_loss"]
    assert np.isfinite(loss)
    algo.stop()
