"""The port's model-free algorithms end to end on the CPU, with the
learner named onto the CPU (``num_gpus_per_learner=0``): IMPALA's async
pipeline on two remote samplers, APPO, DQN on prioritized replay,
R2D2, SAC's checkpoint, the offline learners on a small dataset, and the
tuned-example registry.  The distributed cases run on the port's
runtime (``ray_tpu_torch.init``), whose workers import torch and never
JAX."""

import os

import numpy as np
import pytest
import torch
import yaml

import ray_tpu_torch as rt
from ray_tpu_torch.rllib import Pendulum, RandomEnv
from ray_tpu_torch.rllib import tuned_examples
from ray_tpu_torch.rllib.algorithms import (A3CConfig, APPOConfig,
                                            BCConfig, CQLConfig, CRRConfig,
                                            DQNConfig, ImpalaConfig,
                                            MARWILConfig, R2D2Config,
                                            SACConfig, TD3Config)
from ray_tpu_torch.rllib.env import RepeatPrevEnv
from ray_tpu_torch.rllib.offline import collect_offline_dataset

CPU = {"num_gpus_per_learner": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: under the
    suite's ``-n 6`` the 256-wide learners' products would otherwise run
    six pools of a thread per core on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def cluster():
    # one intra-op thread a sampler, so that the test run's parallel
    # files do not share the host's cores with a torch pool per sampler
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


def _train(config, iters):
    algo = config.resources(**CPU).build()
    try:
        return algo, [algo.train() for _ in range(iters)]
    finally:
        algo.stop()


def _on_cpu(algo):
    policy = algo.get_policy()
    assert policy.device == torch.device("cpu")


@pytest.mark.usefixtures("cluster")
def test_impala_async_distributed():
    """Two remote samplers, two fragments aggregated a step, each worker
    re-dispatched behind its weights."""
    config = (ImpalaConfig()
              .environment(RandomEnv, env_config={"episode_len": 16})
              .rollouts(num_rollout_workers=2, rollout_fragment_length=32,
                        num_envs_per_worker=1)
              .training(num_aggregation_fragments=2)
              .debugging(seed=0))
    algo, results = _train(config, 4)
    _on_cpu(algo)
    total = sum(r["num_env_steps_sampled_this_iter"] for r in results)
    assert total >= 4 * 32
    assert all(np.isfinite(r["total_loss"]) for r in results)
    assert all(r["mean_rho"] > 0 for r in results)
    assert results[-1]["episodes_this_iter"] > 0


@pytest.mark.usefixtures("cluster")
def test_a3c_applies_remote_gradients():
    config = (A3CConfig()
              .environment(RandomEnv, env_config={"episode_len": 8})
              .rollouts(num_rollout_workers=2, rollout_fragment_length=16)
              .training(grads_per_step=4)
              .debugging(seed=0))
    algo, results = _train(config, 2)
    assert all(r["num_async_grads_applied"] == 4 for r in results)
    assert results[-1]["timesteps_total"] == 2 * 4 * 16
    assert all(np.isfinite(r["total_loss"]) for r in results)


def test_appo_smoke():
    config = (APPOConfig()
              .environment(RandomEnv, env_config={"episode_len": 16})
              .rollouts(rollout_fragment_length=32, num_envs_per_worker=2)
              .debugging(seed=0))
    algo, results = _train(config, 2)
    _on_cpu(algo)
    r = results[-1]
    assert np.isfinite(r["total_loss"]) and "mean_rho" in r
    assert r["num_env_steps_sampled_this_iter"] == 64


def test_dqn_prioritized_smoke():
    config = (DQNConfig()
              .environment(RandomEnv, env_config={"episode_len": 8})
              .rollouts(rollout_fragment_length=4)
              .training(train_batch_size=16, prioritized_replay=True,
                        num_steps_sampled_before_learning_starts=32,
                        target_network_update_freq=16)
              .debugging(seed=0))
    algo = config.resources(**CPU).build()
    try:
        for _ in range(12):
            r = algo.train()
        assert r["replay_size"] == 48
        assert "td_error_abs" in r and np.isfinite(r["total_loss"])
        # the learned |td| became the sampled rows' priorities
        assert len(np.unique(algo.replay._priorities[:48])) > 1
        policy = algo.get_policy()
        for a, b in zip(policy.model.parameters(),
                        policy.target_model.parameters()):
            assert not b.requires_grad
    finally:
        algo.stop()


def test_r2d2_smoke():
    config = (R2D2Config()
              .environment(RepeatPrevEnv, env_config={"episode_len": 10})
              .rollouts(rollout_fragment_length=20, num_envs_per_worker=2)
              .training(train_batch_size=4, training_intensity=2.0,
                        num_steps_sampled_before_learning_starts=40,
                        target_network_update_freq=40,
                        model={"use_lstm": True, "lstm_cell_size": 16,
                               "max_seq_len": 5, "fcnet_hiddens": [16]})
              .debugging(seed=0))
    algo, results = _train(config, 4)
    assert results[-1]["replay_sequences"] > 4
    assert np.isfinite(results[-1]["loss"])
    assert np.isfinite(results[-1]["td_error_abs"])


def test_sac_checkpoint_round_trip(tmp_path):
    """The saved state (actor, critic, target critic, log_alpha, the
    three Adams) restores into a fresh algorithm, which then acts as the
    saved one does."""
    config = (SACConfig()
              .environment(Pendulum, env_config={"max_episode_steps": 50})
              .rollouts(rollout_fragment_length=16)
              .training(train_batch_size=32,
                        num_steps_sampled_before_learning_starts=32)
              .debugging(seed=0)
              .resources(**CPU))
    algo = config.build()
    for _ in range(4):
        r = algo.train()
    assert np.isfinite(r["critic_loss"]) and r["alpha"] != 1.0
    algo.save(str(tmp_path))
    state = algo.get_policy().get_state()
    algo.stop()
    fresh = config.copy().debugging(seed=5).build()
    try:
        fresh.restore(str(tmp_path))
        got = fresh.get_policy().get_state()
        assert got["log_alpha"] == state["log_alpha"]
        for key in ("actor", "critic"):
            for name, v in state["weights"][key].items():
                np.testing.assert_array_equal(got["weights"][key][name], v)
        for name, v in state["target_critic"].items():
            np.testing.assert_array_equal(got["target_critic"][name], v)
        for o_got, o_want in zip(got["opt_states"], state["opt_states"]):
            for i, s in o_want["state"].items():
                np.testing.assert_array_equal(o_got["state"][i]["nu"],
                                              s["nu"])
        obs = np.linspace(-1, 1, 3, dtype=np.float32)
        a = fresh.compute_single_action(obs)
        assert np.all(np.abs(a) <= 2.0)
    finally:
        fresh.stop()


def test_td3_smoke():
    config = (TD3Config()
              .environment(Pendulum, env_config={"max_episode_steps": 50})
              .rollouts(rollout_fragment_length=8)
              .training(train_batch_size=16,
                        num_steps_sampled_before_learning_starts=16)
              .debugging(seed=0))
    algo, results = _train(config, 4)
    assert algo.get_policy()._updates == 8 * 3
    assert all(np.isfinite(r["critic_loss"]) for r in results[1:])


@pytest.fixture(scope="module")
def offline(tmp_path_factory):
    """Small behaviour datasets: CartPole (400 steps), Pendulum (300)."""
    root = tmp_path_factory.mktemp("offline")
    return {"cartpole": collect_offline_dataset(
        "CartPole-v1", str(root / "cartpole"), num_steps=400, seed=0),
        "pendulum": collect_offline_dataset(
            "Pendulum-v1", str(root / "pendulum"), num_steps=300, seed=0)}


OFFLINE = {
    "bc": (BCConfig, "cartpole", "CartPole-v1",
           {"train_batch_size": 100}, ("policy_loss",)),
    "marwil": (MARWILConfig, "cartpole", "CartPole-v1",
               {"train_batch_size": 100}, ("policy_loss", "vf_loss")),
    "cql": (CQLConfig, "pendulum", "Pendulum-v1",
            {"train_batch_size": 32, "updates_per_iteration": 2,
             "cql_n_actions": 2}, ("td_loss", "cql_penalty")),
    "crr": (CRRConfig, "pendulum", "Pendulum-v1",
            {"train_batch_size": 32, "updates_per_iteration": 2},
            ("critic_loss", "mean_weight")),
}


@pytest.mark.parametrize("kind", sorted(OFFLINE))
def test_offline_learners_smoke(kind, offline):
    cls, data, env, training, keys = OFFLINE[kind]
    config = (cls().environment(env).offline_data(input_=offline[data])
              .training(**training).debugging(seed=0))
    algo, results = _train(config, 3)
    for r in results:
        assert all(np.isfinite(r[k]) for k in keys), r
    assert results[-1]["timesteps_total"] > results[0]["timesteps_total"]
    assert np.isnan(results[-1]["episode_reward_mean"])  # no env episodes


@pytest.mark.parametrize("cls", [ImpalaConfig, DQNConfig, R2D2Config,
                                 SACConfig, TD3Config, CQLConfig],
                         ids=lambda c: c.__name__)
def test_default_learner_needs_cuda(cls, monkeypatch, offline):
    """Each learner runs on the card by default and raises without CUDA;
    the CPU is used only when named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    env = Pendulum if cls in (SACConfig, TD3Config, CQLConfig) \
        else RandomEnv
    config = cls().environment(env)
    if cls is CQLConfig:
        config.offline_data(input_=offline["pendulum"])
    assert config.num_gpus_per_learner == 1
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config.build()
    algo = config.resources(**CPU).build()
    try:
        _on_cpu(algo)
    finally:
        algo.stop()


# -- the tuned examples ----------------------------------------------------------

def _runs():
    out = {}
    for path in tuned_examples.list_examples():
        with open(path) as f:
            out[os.path.basename(path)] = yaml.safe_load(f)["run"]
    return out


RUNS = _runs()
#: the yamls of the last RL algorithms ported (MADDPG, QMIX, Dreamer,
#: DD-PPO); the others' cases are test_tuned_example_builds_and_trains'
LAST = sorted(["target-chase-maddpg.yaml", "two-step-qmix.yaml",
               "pixelcatch-dreamer.yaml", "cartpole-ddppo.yaml"])
PORTED = sorted(set(RUNS) - set(LAST))


def test_tuned_examples_cover_the_ported_algorithms():
    """The 32 yaml files are the JAX package's, and each runs an
    algorithm of the port."""
    here = os.path.dirname(tuned_examples.__file__)
    jax_dir = os.path.join(os.path.dirname(here), "..", "..", "ray_tpu",
                           "rllib", "tuned_examples")
    assert len(RUNS) == 32
    for name in RUNS:
        with open(os.path.join(here, name)) as a, \
                open(os.path.join(jax_dir, name)) as b:
            assert a.read() == b.read(), name
    assert set(tuned_examples.algo_names()) == set(RUNS.values())
    assert len(PORTED) == 28 and set(LAST) <= set(RUNS)


@pytest.mark.usefixtures("cluster")
@pytest.mark.parametrize("name", PORTED)
def test_tuned_example_builds_and_trains(name):
    """Each ported algorithm builds from its yaml (learner on the CPU)
    and takes one train()."""
    algo, spec = tuned_examples.load(
        os.path.join(os.path.dirname(tuned_examples.__file__), name), "cpu")
    try:
        assert spec["run"] == type(algo).__name__
        _on_cpu(algo)
        result = algo.train()
        assert result["training_iteration"] == 1
    finally:
        algo.stop()


@pytest.mark.parametrize("name", ["cartpole-mass-mbmpo.yaml",
                                  "cartpole-dt.yaml"])
def test_model_learner_yaml_runs_to_its_criterion(name):
    """The two learners that fit a model (MBMPO's dynamics ensemble, DT's
    action model) reach their yaml's stop criterion through
    ``tuned_examples.run`` on the CPU within its iteration budget."""
    path = os.path.join(os.path.dirname(tuned_examples.__file__), name)
    with open(path) as f:
        budget = yaml.safe_load(f)["stop"]["training_iteration"]
    result = tuned_examples.run(path, device="cpu")
    assert result["passed"], result
    assert result["training_iteration"] <= budget


@pytest.mark.usefixtures("cluster")
@pytest.mark.parametrize("name", LAST)
def test_tuned_example_of_unported_algorithm_raises(name):
    """The yamls whose algorithms a later slice brought (they raised
    NotImplementedError before): each builds with its learner on the CPU
    (DD-PPO's learners are its two remote workers) and takes one
    train()."""
    algo, spec = tuned_examples.load(
        os.path.join(os.path.dirname(tuned_examples.__file__), name), "cpu")
    try:
        assert type(algo).__name__ == {"QMIX": "QMix"}.get(spec["run"],
                                                           spec["run"])
        assert algo.get_policy().device == torch.device("cpu")
        result = algo.train()
        assert result["training_iteration"] == 1
        assert result["timesteps_total"] > 0
    finally:
        algo.stop()
