"""The port's MADDPG and QMIX against the JAX package's on the CPU.

Each update runs in both packages on the same (perturbed) weights, target
networks, batch and warmed Adam moments: every tensor's move (after minus
before) is held within UPDATE_TOL of the largest element of the JAX
package's move of it, the targets' and the Adam moments likewise, and the
losses within STATS_RTOL relative.  The converters are held on exact
forwards (FORWARD_TOL, f32 rounding), the host draws (exploration,
epsilon-greedy choices, replay indices) bit for bit.
"""

import copy

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from ray_tpu.rllib.algorithms import maddpg as jmaddpg
from ray_tpu.rllib.algorithms import qmix as jqmix

from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib.algorithms import maddpg, qmix

UPDATE_TOL = 1e-3     # of the largest update of each tensor
STATS_RTOL = 1e-5
FORWARD_TOL = 1e-5
WARM_COUNT, WARM_NU = 20, 1e-4
CPU = {"num_gpus_per_learner": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: under the
    suite's ``-n 6`` the learners' products would otherwise run six
    pools of a thread per core on the same cores."""
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


_BUILT = {}


def _built(key, make):
    """A JAX algorithm built once per module (flax's init and the jitted
    functions' compiles), then copied for each test."""
    if key not in _BUILT:
        _BUILT[key] = make()
    return copy.deepcopy(_BUILT[key])


def _perturbed(params, seed, scale=0.1):
    """flax's zero biases hide mapping faults: perturb every parameter."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x, np.float32) + scale
                              * rng.standard_normal(np.shape(x))
                              .astype(np.float32)), params)


def _sd(tree, conv):
    return {k: v.numpy() for k, v in conv(tree).items()}


def _np_sd(module):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


def _hold_moves(before, want, got, what):
    """Each tensor's move within UPDATE_TOL of the largest element of
    the JAX package's move; a tensor it leaves as it was stays so."""
    assert set(want) == set(got), what
    for name in want:
        w, g = want[name] - before[name], got[name] - before[name]
        scale = float(np.abs(w).max())
        if scale == 0.0:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=UPDATE_TOL * scale,
                                   err_msg=f"{what} {name}")


def _warm_optax(state):
    """Every ``ScaleByAdamState`` inside an optax state warmed to count
    WARM_COUNT, mu zero, nu WARM_NU (masked leaves stay masked).  A cold
    Adam's first step is ``lr * sign(g)``: an element whose gradient
    cancels to rounding would step by +lr in one package and -lr in the
    other."""
    if isinstance(state, optax.ScaleByAdamState):
        return optax.ScaleByAdamState(
            count=jnp.asarray(WARM_COUNT, jnp.int32),
            mu=jax.tree_util.tree_map(jnp.zeros_like, state.mu),
            nu=jax.tree_util.tree_map(lambda x: jnp.full_like(x, WARM_NU),
                                      state.nu))
    if isinstance(state, tuple) and hasattr(state, "_fields"):
        return state._replace(**{f: _warm_optax(getattr(state, f))
                                 for f in state._fields})
    if isinstance(state, tuple):
        return tuple(_warm_optax(s) for s in state)
    if isinstance(state, dict):
        return {k: _warm_optax(v) for k, v in state.items()}
    return state


def _warm_torch(*opts):
    for opt in opts:
        for group in opt.param_groups:
            for p in group["params"]:
                opt.state[p] = {"count": WARM_COUNT,
                                "mu": torch.zeros_like(p),
                                "nu": torch.full_like(p, WARM_NU)}


def _jax_moments(state, conv):
    """{"mu": ..., "nu": ...} of an optax state in the port's layout:
    every ScaleByAdamState's moments, masked leaves dropped."""
    out = {"mu": {}, "nu": {}}

    def walk(s):
        if isinstance(s, optax.ScaleByAdamState):
            for key in ("mu", "nu"):
                tree = getattr(s, key)
                leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
                if not leaves:
                    continue
                out[key].update(_sd(_unmasked(tree), conv))
        elif isinstance(s, tuple):
            for x in s:
                walk(x)
        elif isinstance(s, dict):
            for x in s.values():
                walk(x)

    walk(state)
    return out


def _unmasked(tree):
    """A moments tree without the masked (other group's) branches."""
    if isinstance(tree, dict):
        kept = {k: _unmasked(v) for k, v in tree.items()}
        return {k: v for k, v in kept.items()
                if not (isinstance(v, dict) and not v)}
    if isinstance(tree, tuple) and not hasattr(tree, "shape"):
        return {}  # optax's MaskedNode
    return tree


def _torch_moments(module, *opts):
    names = {id(p): n for n, p in module.named_parameters()}
    out = {"mu": {}, "nu": {}}
    for opt in opts:
        for p, s in opt.state.items():
            for key in ("mu", "nu"):
                out[key][names[id(p)]] = s[key].detach().cpu().numpy()
    return out


def _hold_moments(want, got, what):
    for key in ("mu", "nu"):
        assert set(want[key]) == set(got[key]), (what, key)
        for name, w in want[key].items():
            scale = float(np.abs(w).max())
            np.testing.assert_allclose(got[key][name], w, rtol=0,
                                       atol=UPDATE_TOL * scale,
                                       err_msg=f"{what} {key} {name}")


# -- MADDPG ---------------------------------------------------------------------

MADDPG_CFG = {"actor_hiddens": (32, 32), "critic_hiddens": (32, 32),
              "tau": 0.05}


def _maddpg_pair(**cfg):
    env_config = {"num_agents": 3, "horizon": 10, "seed": 0}
    jc = jmaddpg.MADDPGConfig().environment(
        "SimpleTargetChase", env_config=env_config).debugging(seed=0)
    tc = maddpg.MADDPGConfig().environment(
        "SimpleTargetChase", env_config=env_config).debugging(seed=0) \
        .resources(**CPU)
    for c in (jc, tc):
        for k, v in {**MADDPG_CFG, **cfg}.items():
            setattr(c, k, v)
    def make():
        ja = jc.build()
        ja._update, ja._policy_act = _fast(ja._update), \
            _fast(ja._policy_act)
        return ja
    ja, ta = _built(("maddpg", tuple(sorted(cfg.items()))), make), \
        tc.build()
    ja.params = _perturbed(ja.params, 1)
    ja.target_params = _perturbed(ja.params, 2, 0.05)
    ja.opt_state = _warm_optax(ja.opt.init(ja.params))
    ta.learner.nets.load_state_dict(
        convert.maddpg_state_dict_from_jax(ja.params))
    ta.learner.target.load_state_dict(
        convert.maddpg_state_dict_from_jax(ja.target_params))
    _warm_torch(ta.learner.actor_opt, ta.learner.critic_opt)
    return ja, ta


def _maddpg_batch(B, n, rng):
    return {"obs": rng.uniform(-1, 1, (B, n, 2)).astype(np.float32),
            "actions": rng.uniform(-0.9, 0.9, (B, n, 1)).astype(np.float32),
            "rewards": rng.standard_normal((B, n)).astype(np.float32),
            "next_obs": rng.uniform(-1, 1, (B, n, 2)).astype(np.float32),
            "dones": (rng.random(B) < 0.2).astype(np.float32)}


def test_maddpg_converter_forward_is_exact():
    ja, ta = _maddpg_pair()
    rng = np.random.default_rng(3)
    obs = rng.uniform(-1, 1, (16, 3, 2)).astype(np.float32)
    jobs = obs.reshape(16, -1)
    jact = rng.uniform(-1, 1, (16, 3)).astype(np.float32)
    m = ja.model
    want_a = ja.model.apply(ja.params, jnp.asarray(obs), method=m.act)
    want_q = ja.model.apply(ja.params, jnp.asarray(jobs), jnp.asarray(jact),
                            method=m.critic_values)
    with torch.no_grad():
        nets = ta.learner.nets
        got_a = nets.act(torch.from_numpy(obs))
        got_q = nets.critic_values(torch.from_numpy(jobs),
                                   torch.from_numpy(jact))
    np.testing.assert_allclose(got_a.numpy(), np.asarray(want_a), rtol=0,
                               atol=FORWARD_TOL)
    np.testing.assert_allclose(got_q.numpy(), np.asarray(want_q),
                               rtol=FORWARD_TOL, atol=FORWARD_TOL)


def test_maddpg_update_matches_jax():
    """Two updates: the critics' TD step and the actors' step through
    their own centralized critic with the others' batch actions, both
    Adams, and the Polyak target (tau from the config)."""
    ja, ta = _maddpg_pair()
    learner = ta.learner
    # a real copy: the target does not move with the networks' step
    assert all(t.data_ptr() != p.data_ptr() for t, p in
               zip(learner.target.parameters(), learner.nets.parameters()))
    before = _np_sd(learner.nets)
    target_before = _np_sd(learner.target)
    rng = np.random.default_rng(4)
    params, target, opt_state = ja.params, ja.target_params, ja.opt_state
    for _ in range(2):
        batch = _maddpg_batch(32, 3, rng)
        params, target, opt_state, jc, jact = ja._update(
            params, target, opt_state,
            {k: jnp.asarray(v) for k, v in batch.items()})
        tc, tact = learner.update(batch)
        np.testing.assert_allclose(float(tc), float(jc), rtol=STATS_RTOL)
        np.testing.assert_allclose(float(tact), float(jact),
                                   rtol=STATS_RTOL)
    conv = convert.maddpg_state_dict_from_jax
    _hold_moves(before, _sd(params, conv), _np_sd(learner.nets), "nets")
    _hold_moves(target_before, _sd(target, conv), _np_sd(learner.target),
                "target")
    _hold_moments(_jax_moments(opt_state, conv),
                  _torch_moments(learner.nets, learner.actor_opt,
                                 learner.critic_opt), "adam")


def test_maddpg_exploration_draws_and_checkpoint(tmp_path):
    """Acting draws the JAX package's exploration noise from the same
    numpy generator; a checkpoint restores every network and target on a
    fresh algorithm."""
    ja, ta = _maddpg_pair()
    ja.opt_state = ja.opt.init(ja.params)
    stacked = np.random.default_rng(5).uniform(-1, 1, (3, 2)).astype(
        np.float32)
    for _ in range(3):
        np.testing.assert_allclose(ta._act(stacked, True),
                                   ja._act(stacked, True), rtol=0,
                                   atol=FORWARD_TOL)
    assert ta._np_rng.bit_generator.state == ja._np_rng.bit_generator.state
    ta.train()
    path = ta.save(str(tmp_path / "maddpg"))
    other = maddpg.MADDPGConfig().environment(
        "SimpleTargetChase", env_config={"num_agents": 3}) \
        .debugging(seed=9).resources(**CPU)
    for k, v in MADDPG_CFG.items():
        setattr(other, k, v)
    restored = other.build()
    restored.restore(path)
    for a, b in ((ta.learner.nets, restored.learner.nets),
                 (ta.learner.target, restored.learner.target)):
        for (name, x), y in zip(a.state_dict().items(),
                                b.state_dict().values()):
            assert torch.equal(x, y), name
    assert restored.iteration == 1


# -- QMIX -----------------------------------------------------------------------

QMIX_CFG = {"agent_gru_hidden": 16, "agent_hiddens": (16,),
            "mixing_embed_dim": 8, "hypernet_hiddens": 16, "lr": 1e-3,
            "gamma": 0.9}


def _qmix_pair(recurrent):
    jc = jqmix.QMixConfig().environment("TwoStepGame").debugging(seed=0)
    tc = qmix.QMixConfig().environment("TwoStepGame").debugging(seed=0) \
        .resources(**CPU)
    for c in (jc, tc):
        for k, v in dict(QMIX_CFG, recurrent=recurrent).items():
            setattr(c, k, v)
    def make():
        ja = jc.build()
        ja._update = _fast(ja._update)
        if recurrent:
            ja._agent_step = _fast(ja._agent_step)
        return ja
    ja, ta = _built(("qmix", recurrent), make), tc.build()
    ja.params = _perturbed(ja.params, 1)
    ja.target_params = _perturbed(ja.params, 2, 0.05)
    ja.opt_state = _warm_optax(ja.opt.init(ja.params))
    ta.learner.model.load_state_dict(
        convert.qmix_state_dict_from_jax(ja.params))
    ta.learner.target_model.load_state_dict(
        convert.qmix_state_dict_from_jax(ja.target_params))
    _warm_torch(ta.learner.opt)
    return ja, ta


def _obs_id_dim(algo):
    """An agent's observation width with its one-hot id appended."""
    space = algo.env.observation_space_for(algo.agent_ids[0])
    return int(np.prod(space.shape)) + algo.n_agents


def _episodes(lengths, n, d, s, rng):
    """Replay episodes of the given lengths: obs ⊕ id [T+1, n, d], global
    state [T+1, s], actions, rewards, dones (the last step's 1)."""
    out = []
    for t in lengths:
        dones = np.zeros(t, np.float32)
        dones[-1] = 1.0
        out.append({
            "obs_seq": rng.standard_normal((t + 1, n, d)).astype(np.float32),
            "state_seq": rng.standard_normal((t + 1, s)).astype(np.float32),
            "actions": rng.integers(0, 2, (t, n)),
            "rewards": rng.uniform(0, 8, t).astype(np.float32),
            "dones": dones})
    return out


def _qmix_batch(ja, ta, recurrent, rng):
    n, d, s = ja.n_agents, _obs_id_dim(ja), ja._state_dim
    if recurrent:
        # variable lengths: padded to 8 steps, masked tails
        eps = _episodes(rng.integers(1, 8, 6), n, d, s, rng)
        jb = ja._pad_episode_batch(eps)
        tb = ta._pad_episode_batch(eps)
        assert set(jb) == set(tb)
        for k in jb:
            np.testing.assert_array_equal(np.asarray(jb[k]), tb[k])
        assert tb["mask"].shape == (6, 8) and 0 < tb["mask"].mean() < 1
        return jb, tb
    B = 32
    tb = {"obs": rng.standard_normal((B, n, d)).astype(np.float32),
          "state": rng.standard_normal((B, s)).astype(np.float32),
          "actions": rng.integers(0, 2, (B, n)),
          "rewards": rng.uniform(0, 8, B).astype(np.float32),
          "next_obs": rng.standard_normal((B, n, d)).astype(np.float32),
          "next_state": rng.standard_normal((B, s)).astype(np.float32),
          "dones": (rng.random(B) < 0.3).astype(np.float32)}
    return {k: jnp.asarray(v) for k, v in tb.items()}, tb


@pytest.mark.parametrize("recurrent", [True, False],
                         ids=["recurrent", "feedforward"])
def test_qmix_converter_forward_is_exact(recurrent):
    ja, ta = _qmix_pair(recurrent)
    rng = np.random.default_rng(3)
    n, d, s = ja.n_agents, _obs_id_dim(ja), ja._state_dim
    m = ja.model
    model = ta.learner.model
    state = rng.standard_normal((12, s)).astype(np.float32)
    chosen = rng.standard_normal((12, n)).astype(np.float32)
    if recurrent:
        obs = rng.standard_normal((4, 3, n, d)).astype(np.float32)
        want = ja.model.apply(ja.params, jnp.asarray(obs), method=m.unroll)
        want_mix = ja.model.apply(ja.params, jnp.asarray(chosen),
                                  jnp.asarray(state), method=m.mix)
        with torch.no_grad():
            got = model.unroll(torch.from_numpy(obs))
            got_mix = model.mix(torch.from_numpy(chosen),
                                torch.from_numpy(state))
    else:
        obs = rng.standard_normal((12, n, d)).astype(np.float32)
        want = ja.model.apply(ja.params, jnp.asarray(obs),
                              method=m.agent_qs)
        want_mix = ja.model.apply(ja.params, jnp.asarray(obs),
                                  jnp.asarray(state),
                                  method=m.q_tot_target)
        with torch.no_grad():
            got = model.agent_qs(torch.from_numpy(obs))
            got_mix = model.q_tot_target(torch.from_numpy(obs),
                                         torch.from_numpy(state))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=FORWARD_TOL, atol=FORWARD_TOL)
    np.testing.assert_allclose(got_mix.numpy(), np.asarray(want_mix),
                               rtol=FORWARD_TOL, atol=FORWARD_TOL)


@pytest.mark.parametrize("recurrent", [True, False],
                         ids=["recurrent", "feedforward"])
def test_qmix_update_matches_jax(recurrent):
    """Two TD updates (the recurrent one on padded episodes, its loss
    over the mask), every tensor, Adam's moments, then the target copy:
    a real copy, which the next step leaves where it was."""
    ja, ta = _qmix_pair(recurrent)
    learner = ta.learner
    before = _np_sd(learner.model)
    rng = np.random.default_rng(4)
    params, opt_state = ja.params, ja.opt_state
    for _ in range(2):
        jb, tb = _qmix_batch(ja, ta, recurrent, rng)
        if recurrent:  # every max over actions clear of a tie
            q = ja.model.apply(ja.target_params, jb["obs_seq"],
                               method=ja.model.unroll)
            gap = np.abs(np.diff(np.asarray(q), axis=-1))
            assert gap.min() > 1e-4, gap.min()
        params, opt_state, jl, jtd = ja._update(
            params, ja.target_params, opt_state, jb)
        tl, ttd = learner.update(tb)
        np.testing.assert_allclose(float(tl), float(jl), rtol=STATS_RTOL)
        np.testing.assert_allclose(float(ttd), float(jtd), rtol=STATS_RTOL)
    conv = convert.qmix_state_dict_from_jax
    _hold_moves(before, _sd(params, conv), _np_sd(learner.model), "model")
    target = _np_sd(learner.target_model)
    for name, value in _sd(ja.target_params, conv).items():
        np.testing.assert_array_equal(target[name], value, err_msg=name)
    _hold_moments(_jax_moments(opt_state, conv),
                  _torch_moments(learner.model, learner.opt), "adam")
    learner.sync_target()
    synced = _np_sd(learner.target_model)
    learner.update(tb)
    for name, value in _np_sd(learner.target_model).items():
        np.testing.assert_array_equal(value, synced[name], err_msg=name)


def test_qmix_agent_step_carry_and_epsilon_greedy_choices():
    """The GRU agents' carry over 3 acting steps against the JAX
    package's ``_agent_step``; the epsilon-greedy choices, from the same
    numpy generator on the same Qs, are equal."""
    ja, ta = _qmix_pair(True)
    rng = np.random.default_rng(6)
    n, d = ja.n_agents, _obs_id_dim(ja)
    jcarry = jnp.zeros((1, n, QMIX_CFG["agent_gru_hidden"]), jnp.float32)
    tcarry = ta.learner.initial_carry()
    for _ in range(3):
        obs = rng.standard_normal((1, n, d)).astype(np.float32)
        jcarry, jq = ja._agent_step(ja.params, jcarry, jnp.asarray(obs))
        tcarry, tq = ta.learner.agent_step(tcarry, obs)
        np.testing.assert_allclose(tcarry.numpy(), np.asarray(jcarry),
                                   rtol=FORWARD_TOL, atol=FORWARD_TOL)
        np.testing.assert_allclose(tq, np.asarray(jq), rtol=FORWARD_TOL,
                                   atol=FORWARD_TOL)
    for t in (0, 700, 5000):
        ja._timesteps_total = ta._timesteps_total = t
        q = rng.standard_normal((n, 2)).astype(np.float32)
        for _ in range(4):
            np.testing.assert_array_equal(ta._choose(q, True),
                                          ja._choose(q, True))
    assert ta._np_rng.bit_generator.state == ja._np_rng.bit_generator.state


def test_qmix_training_step_draws_like_jax():
    """A whole recurrent training_step on shared weights: the episodes'
    replay contents, the replay indices and the loss agree, and the
    target is synced on the same step."""
    ja, ta = _qmix_pair(True)
    for a in (ja, ta):
        a.config["rollout_episodes_per_step"] = 4
        a.config["train_batch_size"] = 4
        a.config["num_steps_sampled_before_learning_starts"] = 0
        a.config["target_network_update_freq"] = 8
    jr, tr = ja.training_step(), ta.training_step()
    assert len(ja._replay) == len(ta._replay) == 4
    for je, te in zip(ja._replay, ta._replay):
        for k in je:
            np.testing.assert_array_equal(te[k], je[k], err_msg=k)
    np.testing.assert_allclose(tr["loss"], jr["loss"], rtol=STATS_RTOL)
    assert ja._since_target == ta._since_target == 0
    assert ta._np_rng.bit_generator.state == ja._np_rng.bit_generator.state
    copy.deepcopy(ta.learner.get_state())  # numpy state: plain to copy


@pytest.mark.parametrize("name", ["maddpg", "qmix"])
def test_learner_needs_cuda_by_default(name, monkeypatch):
    """The learner is built on the card unless the config names the CPU;
    without CUDA the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = {"maddpg": lambda: maddpg.MADDPGConfig().environment(
                  "SimpleTargetChase"),
              "qmix": lambda: qmix.QMixConfig().environment("TwoStepGame")}
    assert config[name]().num_gpus_per_learner == 1
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config[name]().build()
    algo = config[name]().resources(**CPU).build()
    assert algo.get_policy().device == torch.device("cpu")
