"""The port's RL device code against the JAX package's, on the CPU.

Each model (``FCNet``, ``LSTMNet``, ``AttentionNet``, ``TwinQNetwork``)
runs on the JAX package's flax parameters converted
(``ray_tpu_torch.models.convert``); the distributions, the policy and
PPO's ``learn_on_batch`` take the same numpy inputs in both packages.
PPO's minibatch order comes from numpy's ``default_rng(seed)`` in both,
so the learner's updates agree up to rounding: each parameter's update
(after minus before, about 1e-3 of the weights) within 1e-3 of the
largest update, the stats within 1e-5 relative.  Actions cannot be
drawn from ``jax.random``'s streams, so the tests replay them.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rllib import models as jmodels
from ray_tpu.rllib.algorithms.ppo import PPOPolicy as JPPOPolicy
from ray_tpu.rllib.env import CartPole as JCartPole
from ray_tpu.rllib.env import Pendulum as JPendulum
from ray_tpu.rllib.offline import JsonWriter as JJsonWriter
from ray_tpu.rllib.offline import \
    collect_offline_dataset as jcollect_offline_dataset
from ray_tpu.rllib.rollout_worker import RolloutWorker as JRolloutWorker
from ray_tpu.rllib.sample_batch import SampleBatch as JSampleBatch

import ray_tpu_torch.rllib as trl
from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib import models as tmodels
from ray_tpu_torch.rllib.algorithms.ppo import PPOConfig, PPOPolicy
from ray_tpu_torch.rllib.env import CartPole, Pendulum
from ray_tpu_torch.rllib.offline import (ImportanceSampling, JsonReader,
                                         WeightedImportanceSampling)
from ray_tpu_torch.rllib.sample_batch import SampleBatch

MODEL_TOL = 1e-5      # outputs and carries, max abs, f32
DIST_TOL = 1e-6       # logp, entropy, kl
UPDATE_TOL = 1e-3     # of the largest parameter update
STATS_RTOL = 1e-5
OBS_DIM, ACTIONS, BATCH = 4, 3, 6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: under the
    suite's ``-n 6`` six pools of a thread per core on the same cores
    spend the time waiting for each other on these tiny shapes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed):
    return np.random.default_rng(seed)


def _perturbed(params, seed, scale=0.1):
    """flax's zero biases and orthogonal heads hide mapping faults:
    perturb every parameter before converting."""
    rng = _rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float32)
        + scale * rng.standard_normal(np.shape(x)).astype(np.float32),
        params)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# -- models ----------------------------------------------------------------

@pytest.mark.parametrize("vf_share", [False, True])
@pytest.mark.parametrize("activation", ["tanh", "relu", "swish"])
def test_fcnet_matches_jax(activation, vf_share):
    obs = _rng(0).standard_normal((BATCH, OBS_DIM)).astype(np.float32)
    jm = jmodels.FCNet(num_outputs=ACTIONS, hiddens=(32, 16),
                       activation=activation, vf_share_layers=vf_share)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(obs)),
                        1)
    want_logits, want_v = jm.apply(params, jnp.asarray(obs))
    tm = tmodels.FCNet(OBS_DIM, ACTIONS, hiddens=(32, 16),
                       activation=activation, vf_share_layers=vf_share)
    tm.load_state_dict(convert.fcnet_state_dict_from_jax(params))
    logits, v = tm(torch.from_numpy(obs))
    _close(logits, want_logits, MODEL_TOL)
    _close(v, want_v, MODEL_TOL)


def test_fcnet_init_follows_flax():
    """LeCun-normal kernels (truncated at 2 std), zero biases, the
    policy head orthogonal(0.01), the value head orthogonal(1.0)."""
    tm = tmodels.FCNet(64, 2, hiddens=(256,))
    w = tm.fc_0.weight.detach()
    std = (1 / 64) ** 0.5
    assert abs(float(w.std()) - std) < 0.05 * std
    assert float(w.abs().max()) <= 2 * std / .87962566103423978 + 1e-6
    assert float(tm.fc_0.bias.detach().abs().max()) == 0.0
    out = tm.out.weight.detach()
    torch.testing.assert_close(out @ out.T, 1e-4 * torch.eye(2),
                               atol=1e-6, rtol=0)
    vf = tm.vf_out.weight.detach()
    torch.testing.assert_close(vf @ vf.T, torch.eye(1), atol=1e-5, rtol=0)


def test_lstm_matches_jax_from_nonzero_carry():
    rng = _rng(2)
    obs = rng.standard_normal((BATCH, 5, OBS_DIM)).astype(np.float32)
    carry = tuple(rng.standard_normal((BATCH, 16)).astype(np.float32)
                  for _ in range(2))
    jm = jmodels.LSTMNet(num_outputs=ACTIONS, cell_size=16, embed_size=8)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(obs),
                                jm.initial_carry(BATCH)), 3)
    want = jm.apply(params, jnp.asarray(obs),
                    tuple(jnp.asarray(c) for c in carry))
    tm = tmodels.LSTMNet(OBS_DIM, ACTIONS, cell_size=16, embed_size=8)
    tm.load_state_dict(convert.lstm_state_dict_from_jax(params))
    logits, v, (c, h) = tm(torch.from_numpy(obs),
                           tuple(torch.from_numpy(c) for c in carry))
    _close(logits, want[0], MODEL_TOL)
    _close(v, want[1], MODEL_TOL)
    _close(c, want[2][0], MODEL_TOL)
    _close(h, want[2][1], MODEL_TOL)


@pytest.mark.parametrize("count", [0, 5, 16])
def test_attention_matches_jax(count):
    rng = _rng(4)
    layers, mem, dim = 2, 16, 16
    obs = rng.standard_normal((BATCH, 3, OBS_DIM)).astype(np.float32)
    mem_flat = rng.standard_normal(
        (BATCH, layers * mem * dim)).astype(np.float32)
    counts = np.full((BATCH, 1), count, np.float32)
    jm = jmodels.AttentionNet(num_outputs=ACTIONS, dim=dim,
                              num_layers=layers, memory_len=mem, heads=4)
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(obs),
                                jm.initial_carry(BATCH)), 5)
    want = jm.apply(params, jnp.asarray(obs),
                    (jnp.asarray(mem_flat), jnp.asarray(counts)))
    tm = tmodels.AttentionNet(OBS_DIM, ACTIONS, dim=dim, num_layers=layers,
                              memory_len=mem, heads=4)
    tm.load_state_dict(convert.attention_state_dict_from_jax(params))
    logits, v, (m2, c2) = tm(torch.from_numpy(obs),
                             (torch.from_numpy(mem_flat),
                              torch.from_numpy(counts)))
    _close(logits, want[0], MODEL_TOL)
    _close(v, want[1], MODEL_TOL)
    _close(m2, want[2][0], MODEL_TOL)
    _close(c2, want[2][1], 0)


@pytest.mark.parametrize("twin", [True, False])
def test_twin_q_matches_jax(twin):
    rng = _rng(6)
    obs = rng.standard_normal((BATCH, OBS_DIM)).astype(np.float32)
    act = rng.standard_normal((BATCH, 2)).astype(np.float32)
    jm = jmodels.TwinQNetwork(twin=twin, hiddens=(32, 32))
    params = _perturbed(jm.init(jax.random.PRNGKey(0), jnp.asarray(obs),
                                jnp.asarray(act)), 7)
    want = jm.apply(params, jnp.asarray(obs), jnp.asarray(act))
    tm = tmodels.TwinQNetwork(OBS_DIM, 2, twin=twin, hiddens=(32, 32))
    tm.load_state_dict(convert.twin_q_state_dict_from_jax(params))
    got = tm(torch.from_numpy(obs), torch.from_numpy(act))
    _close(got[0], want[0], MODEL_TOL)
    _close(got[1], want[1], MODEL_TOL)


# -- distributions -----------------------------------------------------------

@pytest.mark.parametrize("action_dtype", [np.int64, np.float32])
def test_categorical_matches_jax(action_dtype):
    rng = _rng(8)
    p = rng.standard_normal((BATCH, 5)).astype(np.float32) * 3
    q = rng.standard_normal((BATCH, 5)).astype(np.float32)
    acts = rng.integers(0, 5, BATCH).astype(action_dtype)
    J, T = jmodels.Categorical, tmodels.Categorical
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    _close(T.logp(tp, torch.from_numpy(acts)),
           J.logp(jnp.asarray(p), jnp.asarray(acts)), DIST_TOL)
    _close(T.entropy(tp), J.entropy(jnp.asarray(p)), DIST_TOL)
    _close(T.kl(tp, tq), J.kl(jnp.asarray(p), jnp.asarray(q)), DIST_TOL)


def test_diag_gaussian_matches_jax():
    rng = _rng(9)
    p = rng.standard_normal((BATCH, 4)).astype(np.float32)
    p[0, 2:] = [-30.0, 5.0]  # log_std clipped to [-20, 2]
    q = rng.standard_normal((BATCH, 4)).astype(np.float32)
    acts = rng.standard_normal((BATCH, 2)).astype(np.float32)
    J, T = jmodels.DiagGaussian, tmodels.DiagGaussian
    tp, tq = torch.from_numpy(p), torch.from_numpy(q)
    want = J.logp(jnp.asarray(p), jnp.asarray(acts))
    _close(T.logp(tp, torch.from_numpy(acts)), want,
           DIST_TOL * max(1.0, float(np.abs(want).max())))
    _close(T.entropy(tp), J.entropy(jnp.asarray(p)), DIST_TOL)
    want = J.kl(jnp.asarray(p), jnp.asarray(q))
    _close(T.kl(tp, tq), want, DIST_TOL * max(1.0, float(np.abs(want).max())))


def test_categorical_samples_reproducible_and_fit_softmax():
    logits = torch.tensor([[2.0, 0.5, -1.0, 0.0]]).repeat(20000, 1)
    draw = [tmodels.Categorical.sample(
        logits, torch.Generator().manual_seed(11)) for _ in range(2)]
    assert torch.equal(draw[0], draw[1])
    counts = np.bincount(draw[0].numpy(), minlength=4)
    expect = torch.softmax(logits[0], -1).numpy() * len(logits)
    chi2 = float(np.sum((counts - expect) ** 2 / expect))
    assert chi2 < 16.27, (counts, expect)  # p = 0.001 at 3 dof


def test_diag_gaussian_samples_reproducible():
    inputs = torch.tensor([[1.0, -2.0, float(np.log(0.5)), 0.0]]).repeat(
        20000, 1)
    draw = [tmodels.DiagGaussian.sample(
        inputs, torch.Generator().manual_seed(12)) for _ in range(2)]
    assert torch.equal(draw[0], draw[1])
    mean, std = draw[0].mean(0), draw[0].std(0)
    torch.testing.assert_close(mean, torch.tensor([1.0, -2.0]), atol=0.03,
                               rtol=0)
    torch.testing.assert_close(std, torch.tensor([0.5, 1.0]), atol=0.03,
                               rtol=0)


# -- policy ------------------------------------------------------------------

_CONVERT = {"fc": convert.fcnet_state_dict_from_jax,
            "lstm": convert.lstm_state_dict_from_jax,
            "attention": convert.attention_state_dict_from_jax}
_MODELS = {"fc": {},
           "lstm": {"use_lstm": True, "max_seq_len": 8,
                    "lstm_cell_size": 32, "fcnet_hiddens": (32,)},
           "attention": {"use_attention": True, "max_seq_len": 8,
                         "attention_dim": 32,
                         "attention_memory_inference": 8}}


def _policies(kind="fc", env=JCartPole, tenv=CartPole, **cfg):
    """The JAX policy and the port's on its weights (CPU, seed 0)."""
    config = {"seed": 0, "_device": "cpu", "model": _MODELS[kind], **cfg}
    jenv, t_env = env({}), tenv({})
    jp = JPPOPolicy(jenv.observation_space, jenv.action_space,
                    dict(config))
    tp = PPOPolicy(t_env.observation_space, t_env.action_space,
                   dict(config))
    tp.set_weights({k: v.numpy() for k, v in
                    _CONVERT[kind](jp.get_weights()).items()})
    return jp, tp


def test_policy_greedy_values_and_explore_logp():
    jp, tp = _policies()
    obs = _rng(13).standard_normal((32, 4)).astype(np.float32)
    ja, jx = jp.compute_actions(obs, explore=False)
    ta, tx = tp.compute_actions(obs, explore=False)
    np.testing.assert_array_equal(ta, np.asarray(ja))
    _close(tx["vf_preds"], jx["vf_preds"], MODEL_TOL)
    _close(tp.compute_values(obs), jp.compute_values(obs), MODEL_TOL)
    acts, extras = tp.compute_actions(obs, explore=True)
    logits, _ = tp.model(torch.from_numpy(obs))
    _close(extras["action_logp"],
           tmodels.Categorical.logp(logits, torch.from_numpy(acts)), 0)
    _close(extras["vf_preds"], tx["vf_preds"], 0)


def test_policy_continuous_explore_logp():
    _, tp = _policies(env=JPendulum, tenv=Pendulum)
    obs = _rng(14).standard_normal((16, 3)).astype(np.float32)
    acts, extras = tp.compute_actions(obs, explore=True)
    inputs, _ = tp.model(torch.from_numpy(obs))
    _close(extras["action_logp"],
           tmodels.DiagGaussian.logp(inputs, torch.from_numpy(acts)), 0)


@pytest.mark.parametrize("kind", ["lstm", "attention"])
def test_recurrent_policy_greedy_and_carry(kind):
    jp, tp = _policies(kind)
    rng = _rng(15)
    state = tuple(np.asarray(s) for s in jp.get_initial_state(8))
    for _ in range(3):  # three ticks, carries threaded
        obs = rng.standard_normal((8, 4)).astype(np.float32)
        ja, jstate, jx = jp.compute_actions_rnn(obs, state, explore=False)
        ta, tstate, tx = tp.compute_actions_rnn(obs, state, explore=False)
        np.testing.assert_array_equal(ta, np.asarray(ja))
        _close(tx["vf_preds"], jx["vf_preds"], MODEL_TOL)
        for a, b in zip(tstate, jstate):
            _close(a, b, MODEL_TOL)
        state = tuple(np.asarray(s) for s in jstate)


# -- the learner ------------------------------------------------------------

_LEARN = {"num_sgd_iter": 2, "sgd_minibatch_size": 32}


def _jax_batch(kind="fc"):
    """One CartPole batch from the JAX package's sampler: seed 0, 4 envs,
    256 steps each."""
    w = JRolloutWorker(JCartPole, JPPOPolicy,
                       {"seed": 0, "_device": "cpu",
                        "num_envs_per_worker": 4,
                        "rollout_fragment_length": 256,
                        "model": _MODELS[kind]})
    return w.sample()


@pytest.fixture(scope="module")
def cartpole_batch():
    return _jax_batch()


def _raw(chunk):
    return {k: v for k, v in chunk.items()
            if k not in (JSampleBatch.ADVANTAGES, JSampleBatch.VALUE_TARGETS)}


def test_gae_postprocessing_matches_jax(cartpole_batch):
    """Each episode chunk postprocessed again by both packages' policies
    (GAE, with the truncation bootstrap through each one's value head)."""
    jp, tp = _policies()
    n = 0
    for chunk in cartpole_batch.split_by_episode():
        last = np.asarray(chunk[JSampleBatch.NEXT_OBS][-1])
        truncated = not bool(chunk[JSampleBatch.TERMINATEDS][-1])
        want = jp.postprocess_trajectory(JSampleBatch(_raw(chunk)), last,
                                         truncated=truncated)
        got = tp.postprocess_trajectory(SampleBatch(_raw(chunk)), last,
                                        truncated=truncated)
        for key in (SampleBatch.ADVANTAGES, SampleBatch.VALUE_TARGETS):
            np.testing.assert_array_equal(want[key], chunk[key])
            _close(got[key], want[key], MODEL_TOL)
        n += truncated
    assert n >= 1  # a fragment boundary cut at least one episode


def _weights(policy, kind, jax_side):
    w = policy.get_weights()
    if jax_side:
        w = {k: v.numpy() for k, v in _CONVERT[kind](w).items()}
    return w


def _learn_both(batch, kind="fc", **cfg):
    from ray_tpu.rllib.execution import \
        standardize_advantages as jstandardize
    from ray_tpu_torch.rllib.execution import standardize_advantages
    jp, tp = _policies(kind, **_LEARN, **cfg)
    before = _weights(tp, kind, False)
    jstats = jp.learn_on_batch(jstandardize(JSampleBatch(batch.copy())))
    tstats = tp.learn_on_batch(standardize_advantages(
        SampleBatch(batch.copy())))
    jw, tw = _weights(jp, kind, True), _weights(tp, kind, False)
    return before, jw, tw, jstats, tstats


def _hold_learner(before, jw, tw, jstats, tstats, noise=()):
    """Each parameter's update within UPDATE_TOL of its largest, except
    those in ``noise``: parameters whose gradient is zero in exact
    arithmetic, so that Adam scales each package's rounding noise up to
    steps of about lr (held by :func:`_hold_zero_gradients` instead)."""
    assert set(jw) == set(tw)
    for name in set(tw) - set(noise):
        want = jw[name] - before[name]
        got = tw[name] - before[name]
        scale = float(np.abs(want).max())
        assert scale > 0, f"{name} was not updated"
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=UPDATE_TOL * scale, err_msg=name)
    for key in ("policy_loss", "vf_loss", "entropy", "kl", "total_loss",
                "grad_gnorm", "kl_coeff", "mean_kl"):
        np.testing.assert_allclose(tstats[key], jstats[key],
                                   rtol=STATS_RTOL, err_msg=key)


@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_ppo_learn_on_batch_matches_jax(cartpole_batch, grad_clip):
    before, jw, tw, jstats, tstats = _learn_both(cartpole_batch,
                                                 grad_clip=grad_clip)
    if grad_clip:  # the low clip really clipped
        assert jstats["grad_gnorm"] > grad_clip
    _hold_learner(before, jw, tw, jstats, tstats)


def _key_biases(names):
    """The attention's key-projection biases: adding one vector to every
    key moves each query's logits by one constant, which the softmax
    ignores, so their gradient is zero in exact arithmetic."""
    return {n for n in names if n.endswith("attn.key.bias")}


def _hold_zero_gradients(policy, batch, names):
    from ray_tpu_torch.rllib.sample_batch import build_sequences
    seq = build_sequences(SampleBatch(batch), 8)
    seq["kl_coeff"] = np.float32(0.2)
    grads, _ = policy.compute_gradients(seq)
    by_name = dict(zip([n for n, _ in policy.model.named_parameters()],
                       grads))
    largest = max(float(np.abs(g).max()) for g in grads)
    for name in names:
        assert float(np.abs(by_name[name]).max()) <= 1e-6 * largest, name


@pytest.mark.parametrize("kind", ["lstm", "attention"])
def test_recurrent_ppo_learn_on_batch_matches_jax(kind):
    batch = _jax_batch(kind)
    assert "state_in_c" in batch
    before, jw, tw, jstats, tstats = _learn_both(batch, kind)
    noise = _key_biases(tw)
    assert len(noise) == (2 if kind == "attention" else 0)
    _hold_learner(before, jw, tw, jstats, tstats, noise)
    if noise:
        _hold_zero_gradients(_policies(kind)[1], batch, noise)


def test_compute_and_apply_gradients_match_learn():
    """compute_gradients + apply_gradients is one optimizer step, as
    learn_on_batch's (the A3C path)."""
    batch = SampleBatch({
        SampleBatch.OBS: _rng(16).standard_normal((64, 4)).astype(
            np.float32),
        SampleBatch.ACTIONS: _rng(17).integers(0, 2, 64),
        SampleBatch.ACTION_LOGP: np.full(64, -0.69, np.float32),
        SampleBatch.ADVANTAGES: _rng(18).standard_normal(64).astype(
            np.float32),
        SampleBatch.VALUE_TARGETS: _rng(19).standard_normal(64).astype(
            np.float32)})
    _, a = _policies(grad_clip=0.1)
    _, b = _policies(grad_clip=0.1)
    dev = a._device_batch(batch)
    dev["kl_coeff"] = 0.2
    stats = a._update(dev)
    grads, _ = b.compute_gradients({**batch, "kl_coeff": np.float32(0.2)})
    b.apply_gradients(grads)
    for k, v in a.get_weights().items():
        np.testing.assert_array_equal(b.get_weights()[k], v)
    assert float(stats["grad_gnorm"]) > 0.1


# -- offline estimators -------------------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_offline_is_wis_read_from_jax_dataset(tmp_path, weighted):
    jcollect_offline_dataset(JCartPole, str(tmp_path), num_steps=400,
                             seed=0)
    jp, tp = _policies()
    from ray_tpu.rllib.offline import ImportanceSampling as JIS
    from ray_tpu.rllib.offline import JsonReader as JJsonReader
    from ray_tpu.rllib.offline import WeightedImportanceSampling as JWIS
    data = JsonReader(str(tmp_path)).read()
    jdata = JJsonReader(str(tmp_path)).read()
    assert len(data) == 400
    for key in data:
        np.testing.assert_array_equal(data[key], jdata[key])
    t_est = (WeightedImportanceSampling if weighted
             else ImportanceSampling)(tp)
    j_est = (JWIS if weighted else JIS)(jp)
    got, want = t_est.estimate(data), j_est.estimate(jdata)
    for key in ("v_behavior", "v_target", "v_gain"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                   err_msg=key)


def test_json_writer_round_trip(tmp_path):
    batch = JSampleBatch({"obs": np.ones((3, 2), np.float32),
                          "actions": np.arange(3),
                          "eps_id": np.zeros(3, np.int64)})
    w = JJsonWriter(str(tmp_path))
    w.write(batch)
    w.close()
    back = JsonReader(str(tmp_path)).read()
    for key in batch:
        np.testing.assert_array_equal(back[key], batch[key])


# -- the device ---------------------------------------------------------------

def test_default_learner_needs_cuda(monkeypatch):
    """The learner runs on the card by default and raises without CUDA;
    the CPU is used only when named (num_gpus_per_learner=0)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = (PPOConfig().environment(CartPole)
              .rollouts(rollout_fragment_length=8)
              .training(train_batch_size=16, sgd_minibatch_size=8))
    assert config.num_gpus_per_learner == 1
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config.build()
    algo = config.resources(num_gpus_per_learner=0).build()
    assert algo.get_policy().device == torch.device("cpu")
    assert all(p.device.type == "cpu"
               for p in algo.get_policy().model.parameters())
    algo.stop()


def test_tpu_learner_option_refused():
    with pytest.raises(TypeError, match="num_gpus_per_learner"):
        PPOConfig().resources(num_tpus_per_learner=1)
    with pytest.raises(TypeError, match="num_gpus_per_learner"):
        trl.algorithms.PPO({"env": CartPole, "num_tpus_per_learner": 1})
    with pytest.raises(ValueError, match="framework='torch'"):
        PPOConfig().framework("jax")
    assert PPOConfig().framework("torch").num_gpus_per_learner == 1


@pytest.mark.parametrize("n", [2, 8, 0.5, -1])
def test_multi_card_learner_refused(n):
    """num_gpus_per_learner is 0 or 1: a larger count would still give
    the learner one card, so it raises, through resources() and through
    a config dict alike."""
    with pytest.raises(ValueError, match="num_gpus_per_learner"):
        PPOConfig().resources(num_gpus_per_learner=n)
    with pytest.raises(ValueError, match="num_gpus_per_learner"):
        trl.algorithms.PPO({"env": CartPole, "num_gpus_per_learner": n})


def test_unported_algorithms_raise_naming_roadmap():
    """Every algorithm name of the JAX package's ``rllib.algorithms`` is
    the port's too: no name is left for a later slice to bring."""
    import ray_tpu.rllib.algorithms as jalgos
    import ray_tpu_torch.rllib.algorithms as talgos
    jnames = {n for n in dir(jalgos) if n[0].isupper()}
    assert talgos._LATER == {}
    assert {"PPO", "DDPPO", "IMPALA", "APPO", "PG", "A2C", "A3C", "MARWIL",
            "BC", "DQN", "SimpleQ", "ApexDQN", "R2D2", "SAC", "DDPG", "TD3",
            "ApexDDPG", "CQL", "CRR", "ES", "ARS", "BanditLinUCB",
            "BanditLinTS", "AlphaStar", "MAML", "MBMPO", "DT", "AlphaZero",
            "SlateQ", "MADDPG", "QMix", "Dreamer", "RepeatedRPS",
            "SimpleRecEnv", "SimpleTargetChase"} <= jnames
    for name in sorted(jnames):
        assert getattr(talgos, name).__name__ == name
    jrl = __import__("ray_tpu.rllib", fromlist=["*"])
    for name in dir(jrl):
        if name[0].isupper() and name != "JaxPolicy":
            assert hasattr(trl, name), name
    assert trl.TorchPolicy is not None
