"""The port's DD-PPO and RLTrainer on the CPU.

DD-PPO's ``_train_once`` (the iteration each rank runs inside its rollout
worker) runs in both packages on one batch and the same weights, its
collective replaced by a two-rank stub whose other rank contributes a
fixed gradient (the same tensors in each package's parameter order) and
a fixed KL: each parameter's move is held within UPDATE_TOL of the
largest element of the JAX package's move, the stats within STATS_RTOL.
A two-worker gang then trains on the port's runtime with the learners on
the CPU and no weight broadcast, its ranks' weights equal bit for bit.
RLTrainer runs PG to its third iteration and its checkpoint restores.
"""

import os
import types

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
from jax.flatten_util import ravel_pytree

from ray_tpu.rllib.algorithms import ddppo as jddppo
from ray_tpu.rllib.algorithms.ppo import PPOPolicy as JPPOPolicy
from ray_tpu.rllib.env import CartPole as JCartPole
from ray_tpu.rllib.sample_batch import SampleBatch as JSampleBatch
import ray_tpu.util.collective.collective as jcol

import ray_tpu_torch as rt
import ray_tpu_torch.util.collective.collective as tcol
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import CartPole
from ray_tpu_torch.rllib.algorithms import DDPPOConfig, PGConfig, ddppo
from ray_tpu_torch.rllib.algorithms.ppo import PPOPolicy
from ray_tpu_torch.rllib.sample_batch import SampleBatch
from ray_tpu_torch.train import RLTrainer, RunConfig

UPDATE_TOL = 1e-3
STATS_RTOL = 1e-5
OTHER_KL = 0.004      # the stub's second rank's mean KL
CPU = {"num_gpus_per_learner": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


#: XLA's LLVM backend at -O0 for the JAX references: the programs are
#: tiny, and compiling them is most of these tests' time; the HLO, and so
#: the arithmetic, is the same
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _fast(fn):
    """``fn`` jitted with FAST_COMPILE; a function the JAX package jitted
    is jitted anew from its Python body."""
    if hasattr(fn, "lower"):
        fn = fn.__wrapped__
    return jax.jit(fn, compiler_options=FAST_COMPILE)


@pytest.fixture(autouse=True, scope="module")
def _jitted_flax_init():
    """The JAX package's networks initialised under one ``jax.jit``
    (FAST_COMPILE): flax's eager ``init`` compiles each operation on its
    own (87 programs for Dreamer's RSSM).  Every test replaces or
    perturbs the initial values."""
    init = nn.Module.init

    def jitted(self, rngs, *args, **kwargs):
        if kwargs:
            return init(self, rngs, *args, **kwargs)
        return _fast(lambda r, *a: init(self, r, *a))(rngs, *args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", jitted)
        yield


def _batch(n, rng):
    return {"obs": rng.standard_normal((n, 4)).astype(np.float32),
            "actions": rng.integers(0, 2, n),
            "action_logp": (np.log(0.5) + 0.1 * rng.standard_normal(n)
                            ).astype(np.float32),
            "advantages": rng.standard_normal(n).astype(np.float32),
            "value_targets": rng.standard_normal(n).astype(np.float32)}


def _stub(flat_other):
    """A two-rank ``allreduce``: MIN against an equal length, SUM with
    the other rank's fixed gradient (``flat_other``) or KL."""
    def allreduce(x, group_name="default", op="sum", timeout_s=None):
        x = np.asarray(x)
        if op == "min":
            return x.copy()
        if x.size == 1:
            return x + OTHER_KL
        return x + flat_other
    return allreduce


def test_train_once_matches_jax(monkeypatch):
    """Two epochs of four minibatches: each rank's gradient averaged
    with the other rank's, applied (Adam), the KL reduced once, then the
    adaptive KL coefficient."""
    config = {"seed": 0, "_device": "cpu", "num_sgd_iter": 2,
              "sgd_minibatch_size": 64, "lr": 1e-3, "kl_coeff": 0.2}
    jp = JPPOPolicy(JCartPole({}).observation_space,
                    JCartPole({}).action_space, dict(config))
    tp = PPOPolicy(CartPole({}).observation_space, CartPole({}).action_space,
                   dict(config))
    tp.set_weights({k: v.numpy() for k, v in
                    convert.fcnet_state_dict_from_jax(
                        jp.get_weights()).items()})
    # the other rank's gradient: fixed tensors in each package's layout
    rng = np.random.default_rng(1)
    other = jax.tree_util.tree_map(
        lambda x: jnp.asarray(0.05 * rng.standard_normal(np.shape(x)),
                              jnp.float32), jp.params)
    by_name = convert.fcnet_state_dict_from_jax(other)
    t_other = torch.cat([by_name[n].reshape(-1)
                         for n, p in tp.model.named_parameters()
                         if p.requires_grad]).numpy()
    j_other = np.asarray(ravel_pytree(other)[0])
    batch = _batch(256, np.random.default_rng(2))
    before = {k: v.copy() for k, v in tp.get_weights().items()}
    for mod, flat in ((jcol, j_other), (tcol, t_other)):
        monkeypatch.setattr(mod, "allreduce", _stub(flat))
        monkeypatch.setattr(mod, "get_collective_group_size",
                            lambda group_name="default": 2)
    want = jddppo._train_once(types.SimpleNamespace(
        policy=jp, sample=lambda: JSampleBatch(dict(batch))), "g")
    got = ddppo._train_once(types.SimpleNamespace(
        policy=tp, sample=lambda: SampleBatch(dict(batch))), "g")
    assert got["env_steps"] == want["env_steps"] == 256
    assert set(got["stats"]) == set(want["stats"])
    for key, w in want["stats"].items():
        np.testing.assert_allclose(got["stats"][key], w, rtol=STATS_RTOL,
                                   err_msg=key)
    jw = {k: v.numpy() for k, v in
          convert.fcnet_state_dict_from_jax(jp.get_weights()).items()}
    tw = tp.get_weights()
    for name in jw:
        w, g = jw[name] - before[name], tw[name] - before[name]
        scale = float(np.abs(w).max())
        assert scale > 0, name
        np.testing.assert_allclose(g, w, rtol=0, atol=UPDATE_TOL * scale,
                                   err_msg=name)
    assert tp._np_rng.bit_generator.state == jp._np_rng.bit_generator.state


@pytest.fixture(scope="module")
def cluster():
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


@pytest.mark.usefixtures("cluster")
def test_two_rank_gang_trains_without_weight_broadcast():
    """Two rollout workers allreduce their gradients among themselves
    for two iterations; the driver never broadcasts weights after the
    first sync, and the ranks' weights stay equal bit for bit."""
    config = (DDPPOConfig()
              .environment(CartPole, env_config={"max_episode_steps": 50})
              .rollouts(num_rollout_workers=2, rollout_fragment_length=100)
              .training(sgd_minibatch_size=50, num_sgd_iter=2, lr=1e-3)
              .resources(**CPU).debugging(seed=0))
    algo = config.build()
    broadcasts = []
    algo.workers.sync_weights = lambda **kw: broadcasts.append(1)
    try:
        results = [algo.train() for _ in range(2)]
        assert not broadcasts
        assert results[-1]["training_iteration"] == 2
        assert all(np.isfinite(r["total_loss"]) for r in results)
        assert results[-1]["timesteps_total"] == 400
        w0, w1 = rt.get([w.get_weights.remote()
                         for w in algo.workers.remote_workers])
        assert set(w0) == set(w1)
        for name in w0:
            np.testing.assert_array_equal(w0[name], w1[name], err_msg=name)
        devices = rt.get([w.apply.remote(lambda wk: str(wk.policy.device))
                          for w in algo.workers.remote_workers])
        assert devices == ["cpu", "cpu"]
        # the driver's copy is rank 0's (evaluate() and checkpoints)
        local = algo.workers.local_worker.get_weights()
        for name in w0:
            np.testing.assert_array_equal(local[name], w0[name])
    finally:
        algo.stop()


def test_ddppo_needs_two_workers_and_the_card_by_default(monkeypatch):
    with pytest.raises(ValueError, match="num_rollout_workers >= 2"):
        DDPPOConfig().environment(CartPole).rollouts(
            num_rollout_workers=1).resources(**CPU).build()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DDPPOConfig().environment(CartPole).build()


def test_rl_trainer_bridge(tmp_path):
    """RLTrainer runs PG (its learner named onto the CPU) under the Train
    fit contract to iteration 3, and its checkpoint restores into a
    fresh PG."""
    trainer = RLTrainer(
        algorithm="PG",
        config={"env": CartPole, "env_config": {"max_episode_steps": 50},
                "train_batch_size": 200, "lr": 4e-3, "seed": 0, **CPU},
        stop={"training_iteration": 3},
        run_config=RunConfig(storage_path=str(tmp_path)))
    result = trainer.fit()
    assert result.metrics["training_iteration"] == 3
    assert len(result.metrics_history) == 3
    assert result.checkpoint is not None
    algo = (PGConfig()
            .environment(CartPole, env_config={"max_episode_steps": 50})
            .resources(**CPU).debugging(seed=0)).build()
    try:
        with result.checkpoint.as_directory() as d:
            algo.restore(d)
        assert algo.iteration == 3
    finally:
        algo.stop()
