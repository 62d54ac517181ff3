"""The port's ES/ARS, linear bandits, AlphaStar league, MAML and MBMPO
against the JAX package's, on the CPU.

ES, ARS and the bandits are host numpy over the policy: their theta and
posteriors must equal the JAX package's bit for bit, the greedy
actions' margins held first (every logit gap above ACTION_MARGIN, so
rounding in the forward cannot flip a candidate's episode).  MAML's
adaptation and meta-update and MBMPO's ensemble step, imagined rollout
and meta-step run on shared (perturbed) weights, shared draws and
warmed Adam moments (as ``test_torch_rllib_algorithms.py``'s
``_warm_adam``: a cold Adam's first step is ``lr * sign(g)``), each
tensor's move held within UPDATE_TOL of its
largest element's, the losses and stats within STATS_RTOL, rollout
arrays within ROLLOUT_TOL of their largest element.  The draws of the
port (``MBMPOPolicy._update_noise``) are replaced by the arrays the JAX
key gives by the same splits; sampled actions are held first by their
Gumbel margins, the PPO ratios by their distance from the clip.
"""

import copy
import functools

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from ray_tpu.rllib.algorithms import alpha_star as jas
from ray_tpu.rllib.algorithms import bandit as jbandit
from ray_tpu.rllib.algorithms import es as jes
from ray_tpu.rllib.algorithms import maml as jmaml
from ray_tpu.rllib.algorithms import mbmpo as jmbmpo
from ray_tpu.rllib.env import Box as JBox
from ray_tpu.rllib.env import Discrete as JDiscrete

from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib.algorithms import (AlphaStarConfig, ARSConfig,
                                            BanditLinTSConfig,
                                            BanditLinUCBConfig, ESConfig,
                                            MAMLConfig, MBMPOConfig)
from ray_tpu_torch.rllib.algorithms import alpha_star, es, maml, mbmpo
from ray_tpu_torch.rllib.env import Box, Discrete
from ray_tpu_torch.rllib.sample_batch import SampleBatch

UPDATE_TOL = 1e-3     # of the largest update of each tensor
STATS_RTOL = 1e-5
ROLLOUT_TOL = 1e-5    # of the largest element of each imagined column
ACTION_MARGIN = 1e-5  # least logit gap of a greedy or Gumbel-max choice
CLIP_MARGIN = 1e-4    # least distance of a PPO ratio from 1 +- clip
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


@pytest.fixture(autouse=True, scope="module")
def _jitted_flax_init():
    """The JAX package's networks initialised under one ``jax.jit``
    (FAST_COMPILE):
    flax's eager ``init`` compiles op by op (a Decision Transformer's
    took 5 s of this module's time alone, twice that under the suite's
    ``-n 6``).  Every test replaces or perturbs the initial values."""
    init = nn.Module.init

    def jitted(self, rngs, *args, **kwargs):
        if kwargs:
            return init(self, rngs, *args, **kwargs)
        return _fast(lambda r, *a: init(self, r, *a))(rngs, *args)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nn.Module, "init", jitted)
        yield


#: XLA's LLVM backend at -O0 for the JAX references: the programs are
#: tiny, and compiling them is most of these tests' time (a MAML
#: meta-update took 2.55 s at the default level, 0.73 s so, on this
#: module's sizes); the HLO, and so the arithmetic, is the same
FAST_COMPILE = {"xla_backend_optimization_level": 0,
                "xla_llvm_disable_expensive_passes": True}


def _fast(fn):
    """``fn`` jitted with FAST_COMPILE; a function the JAX package jitted
    is jitted anew from its Python body."""
    if hasattr(fn, "lower"):
        fn = fn.__wrapped__
    return jax.jit(fn, compiler_options=FAST_COMPILE)


def _perturbed(params, seed, scale=0.1):
    """flax's zero biases and orthogonal heads hide mapping faults:
    perturb every parameter."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x, np.float32) + scale
                              * rng.standard_normal(np.shape(x))
                              .astype(np.float32)), params)


def _np(tree, conv=convert.fcnet_state_dict_from_jax):
    return {k: v.numpy() for k, v in conv(tree).items()}


def _np_sd(module):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


def _hold_moves(before, want, got, what):
    """Each tensor's move (after minus before) within UPDATE_TOL of the
    largest element of the JAX package's move; a tensor the JAX package
    leaves as it was stays as it was."""
    assert set(want) == set(got), what
    for name in want:
        w, g = want[name] - before[name], got[name] - before[name]
        scale = float(np.abs(w).max())
        if scale == 0.0:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=UPDATE_TOL * scale,
                                   err_msg=f"{what} {name}")


def _hold_close(want, got, what, tol=UPDATE_TOL):
    """Each array within ``tol`` of its largest element's magnitude."""
    for name in want:
        w, g = np.asarray(want[name]), np.asarray(got[name])
        scale = max(float(np.abs(w).max()), 1e-30)
        np.testing.assert_allclose(g, w, rtol=0, atol=tol * scale,
                                   err_msg=f"{what} {name}")


def _warm_adam(jax_state, opt):
    """Both packages' Adam states warmed to the same moments: count
    WARM_COUNT, mu zero, nu WARM_NU everywhere.  From these moments an
    update is linear in a small gradient, so an element whose gradient
    cancels to rounding moves by next to nothing in both."""
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p] = {"count": WARM_COUNT, "mu": torch.zeros_like(p),
                            "nu": torch.full_like(p, WARM_NU)}
    adam, rest = jax_state[0], jax_state[1:]
    return (optax.ScaleByAdamState(
        count=jnp.asarray(WARM_COUNT, jnp.int32),
        mu=jax.tree_util.tree_map(jnp.zeros_like, adam.mu),
        nu=jax.tree_util.tree_map(lambda x: jnp.full_like(x, WARM_NU),
                                  adam.nu)),) + tuple(rest)


def _hold_adam(jax_state, opt, module, conv):
    """The port's Adam moments against the JAX package's, each within
    UPDATE_TOL of its largest element; the counts equal."""
    adam = jax_state[0]
    names = [n for n, _ in module.named_parameters()]
    for key in ("mu", "nu"):
        want = _np(getattr(adam, key), conv)
        got = {n: opt.state[p][key].numpy()
               for n, p in zip(names, module.parameters())}
        _hold_close(want, got, f"adam {key}")
    assert all(opt.state[p]["count"] == int(adam.count)
               for p in module.parameters())


# -- ES and ARS ---------------------------------------------------------------

ES_ENV = {"max_episode_steps": 40, "seed": 3}
ES_MODEL = {"fcnet_hiddens": (16,)}


def _es_pair(kind):
    """The JAX package's ES/ARS and the port's (learner on the CPU), both
    with no sampler fleet, on the JAX policy's perturbed weights."""
    jcfg = (jes.ARSConfig if kind == "ars" else jes.ESConfig)()
    tcfg = (ARSConfig if kind == "ars" else ESConfig)()
    algos = []
    for cfg in (jcfg, tcfg):
        cfg.environment("CartPole-v1", env_config=dict(ES_ENV)) \
            .training(episodes_per_batch=4, noise_stdev=0.1,
                      stepsize=0.05).debugging(seed=0)
        cfg.model = dict(ES_MODEL)
        if cfg is tcfg:
            cfg.resources(**CPU)
        algos.append(cfg.build())
    ja, ta = algos
    jpol = ja.workers.local_worker.policy
    jpol.set_weights(_perturbed(jpol.params, 1, 0.3))
    ta.workers.local_worker.policy.set_weights(_np(jpol.params))
    ja._theta, ja._spec = jes._flatten(jpol.params)
    ta._theta, ta._spec = es._flatten(
        ta.workers.local_worker.policy.get_weights())
    return ja, ta


def _greedy_margins(policy, record):
    """Wrap ``policy.compute_actions`` to record every greedy choice's
    logit gap."""
    act = policy.compute_actions

    def compute_actions(obs, explore=True):
        with torch.no_grad():
            logits, _ = policy.model(policy._tensor(obs))
        top = torch.topk(logits, 2, dim=-1).values
        record.append(float((top[..., 0] - top[..., 1]).min()))
        return act(obs, explore=explore)
    policy.compute_actions = compute_actions


@pytest.mark.parametrize("kind", ["es", "ars"])
def test_es_ars_training_step_matches_jax(kind):
    """The port's flat vector of the converted weights is the JAX
    package's, bit for bit, and unflattens to the same weights; then one
    training_step of each on a local worker: the same candidates play
    the same greedy episodes, so theta is the JAX package's bit for
    bit."""
    ja, ta = _es_pair(kind)
    try:
        np.testing.assert_array_equal(ta._theta, ja._theta)
        back = es._unflatten(ta._theta, ta._spec)
        want = ta.workers.local_worker.policy.get_weights()
        assert set(back) == set(want)
        for name, w in want.items():
            np.testing.assert_array_equal(back[name], w, err_msg=name)
            assert back[name].flags.c_contiguous
        margins = []
        _greedy_margins(ta.workers.local_worker.policy, margins)
        got = ta.training_step()
        assert min(margins) > ACTION_MARGIN, min(margins)
        want = ja.training_step()
        assert got == want
        np.testing.assert_array_equal(ta._theta, ja._theta)
        assert ta._timesteps_total == ja._timesteps_total
    finally:
        ja.stop()
        ta.stop()


# -- the linear bandits -------------------------------------------------------

@pytest.mark.parametrize("kind", ["linucb", "lints"])
def test_bandit_choices_and_posteriors_match_jax(kind):
    """Three iterations on ContextBandit under one seed: the posteriors
    after each and the next choices equal the JAX package's bit for
    bit."""
    pair = {"linucb": (jbandit.BanditLinUCBConfig, BanditLinUCBConfig),
            "lints": (jbandit.BanditLinTSConfig, BanditLinTSConfig)}[kind]
    algos = [cls().environment("ContextBandit",
                               env_config={"arms": 3, "seed": 0})
             .rollouts(rollout_fragment_length=16)
             .training(train_batch_size=16).debugging(seed=0).build()
             for cls in pair]
    ja, ta = algos
    try:
        for _ in range(3):
            want, got = ja.train(), ta.train()
            assert got["episode_reward_mean"] == want["episode_reward_mean"]
            assert got["cumulative_regret_proxy"] == \
                want["cumulative_regret_proxy"]
            jw = ja.get_policy().get_weights()
            tw = ta.get_policy().get_weights()
            for key in ("A_inv", "b", "theta"):
                np.testing.assert_array_equal(tw[key], jw[key], key)
        obs = np.random.default_rng(4).random((8, 3)).astype(np.float32)
        np.testing.assert_array_equal(ta.get_policy().compute_actions(obs)[0],
                                      ja.get_policy().compute_actions(obs)[0])
    finally:
        ja.stop()
        ta.stop()


# -- AlphaStar ----------------------------------------------------------------

def _league_config(cls):
    config = cls().environment("RepeatedRPS", env_config={"rounds": 8}) \
        .debugging(seed=0)
    config.episodes_per_learner_step = 8
    config.sgd_minibatch_size = 32
    config.min_iters_between_snapshots = 2
    return config


def _numpy_only(tree):
    if isinstance(tree, dict):
        return all(_numpy_only(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return all(_numpy_only(v) for v in tree)
    return not isinstance(tree, torch.Tensor)


def test_alphastar_league_grows_and_checkpoints(tmp_path):
    """As the JAX package's test holds it: snapshots join the league, the
    payoff table fills and stays symmetric, and save/restore round-trips
    the whole league — every policy's state pickled as numpy, so a
    league saved on the card restores on the CPU.  A snapshot win rate
    of 0 freezes a copy of each learner every two iterations, so frozen
    players are saved and restored too."""
    config = _league_config(AlphaStarConfig).resources(**CPU)
    config.snapshot_win_rate = 0.0
    algo = config.build()
    for _ in range(6):
        r = algo.train()
    assert r["league_size"] > 3
    assert any(pl.frozen for pl in algo.players.values())
    assert algo.payoff.get("main"), "payoff table never populated"
    for a, row in algo.payoff.items():
        for b, wr in row.items():
            back = algo.payoff.get(b, {}).get(a)
            if back is not None:
                assert abs((wr + back) - 1.0) < 1e-6
    assert all(pl.policy.device == torch.device("cpu")
               for pl in algo.players.values())

    path = algo.save(str(tmp_path / "league"))
    import pickle
    with open(tmp_path / "league" / "algorithm_state.pkl", "rb") as f:
        assert _numpy_only(pickle.load(f))
    algo2 = config.build()
    algo2.restore(path)
    assert set(algo2.players) == set(algo.players)
    assert algo2.payoff == algo.payoff
    for pid, pl in algo.players.items():
        want = pl.policy.get_weights()
        got = algo2.players[pid].policy.get_weights()
        for name, w in want.items():
            np.testing.assert_array_equal(got[name], w, f"{pid} {name}")
    ev = algo2.evaluate()
    assert np.isfinite(ev["evaluation_reward_mean"])
    algo.stop()
    algo2.stop()


def _bare_league(module, config):
    """An AlphaStar of ``module`` with its matchmaking state only: the
    three learners' and two historical snapshots' slots (no policies),
    an empty payoff table and the seeded generator ``setup`` makes."""
    algo = object.__new__(module.AlphaStar)
    algo.config = config.to_dict()
    roles = {"main": "main", "main_exploiter_0": "main_exploiter",
             "league_exploiter_0": "league_exploiter",
             "main_v0": "historical", "main_exploiter_0_v1": "historical"}
    algo.players = {pid: module._LeaguePlayer(pid, None, role,
                                              frozen=role == "historical")
                    for pid, role in roles.items()}
    algo._np_rng = np.random.default_rng(0)
    return algo


def test_alphastar_pfsp_matches_jax():
    """From one win-rate table (two historical snapshots in the league),
    the PFSP weights and the opponents picked for every learner by the
    JAX package's matchmaking and the port's are equal."""
    ja = _bare_league(jas, _league_config(jas.AlphaStarConfig))
    ta = _bare_league(alpha_star, _league_config(AlphaStarConfig))
    rng = np.random.default_rng(7)
    pids = sorted(ta.players)
    table = {a: {b: float(rng.random()) for b in pids if b != a}
             for a in pids}
    ja.payoff, ta.payoff = copy.deepcopy(table), copy.deepcopy(table)
    for pid in pids:
        pool = [o for o in pids if o != pid]
        want = [(1.0 - ja._winrate(pid, o)) ** 2 + 1e-3 for o in pool]
        assert [(1.0 - ta._winrate(pid, o)) ** 2 + 1e-3
                for o in pool] == want
    learners = [p for p, pl in ta.players.items() if not pl.frozen]
    assert len(learners) == 3
    picks = [[a._sample_opponent(pid) for _ in range(40)
              for pid in learners] for a in (ja, ta)]
    assert picks[1] == picks[0]
    assert len(set(picks[0])) >= 4  # self-play, PFSP and both snapshots


# -- MAML ---------------------------------------------------------------------

OBS_DIM, ACTIONS, TASKS, ROWS = 4, 2, 2, 48
META_MODEL = {"fcnet_hiddens": (32,)}


def _meta_cfg(**cfg):
    return {"seed": 0, "_device": "cpu", "model": META_MODEL, "lr": 1e-3,
            "entropy_coeff": 0.01, **cfg}


def _maml_pair(steps):
    cfg = _meta_cfg(inner_lr=0.1, inner_adaptation_steps=steps)
    jp = jmaml.MAMLPolicy(JBox(-1.0, 1.0, (OBS_DIM,)), JDiscrete(ACTIONS),
                          dict(cfg))
    tp = maml.MAMLPolicy(Box(-1.0, 1.0, (OBS_DIM,)), Discrete(ACTIONS),
                         dict(cfg))
    jp.params = _perturbed(jp.params, 2)
    tp.set_weights(_np(jp.params))
    jp.opt_state = _warm_adam(jp.opt_state, tp.opt)
    return jp, tp


def _task_batches(seed):
    """Pre- and post-adaptation columns stacked ``[tasks, rows, ...]``."""
    rng = np.random.default_rng(seed)

    def one():
        return {
            SampleBatch.OBS: rng.standard_normal(
                (TASKS, ROWS, OBS_DIM)).astype(np.float32),
            SampleBatch.ACTIONS: rng.integers(0, ACTIONS, (TASKS, ROWS)),
            SampleBatch.ACTION_LOGP: (np.log(0.5) + 0.2 * rng.standard_normal(
                (TASKS, ROWS))).astype(np.float32),
            SampleBatch.ADVANTAGES: (3.0 * rng.standard_normal(
                (TASKS, ROWS)) + 1.0).astype(np.float32),
            SampleBatch.VALUE_TARGETS: rng.standard_normal(
                (TASKS, ROWS)).astype(np.float32)}
    return one(), one()


def _hold_ratios(tp, adapted, post):
    """Every PPO ratio of the meta-loss at least CLIP_MARGIN from the
    clip's edges (where min() and clip() change branch)."""
    clip = float(tp.config.get("clip_param", 0.3))
    with torch.no_grad():
        logits, _ = tp._forward(adapted, post[SampleBatch.OBS])
        ratio = torch.exp(tp.dist.logp(logits, post[SampleBatch.ACTIONS])
                          - post[SampleBatch.ACTION_LOGP])
    edge = torch.minimum((ratio - (1 - clip)).abs(),
                         (ratio - (1 + clip)).abs())
    assert float(edge.min()) > CLIP_MARGIN, float(edge.min())
    return float(((ratio < 1 - clip) | (ratio > 1 + clip)).float().mean())


@pytest.mark.parametrize("steps", [1, 2])
def test_maml_adapt_and_meta_update_match_jax(steps):
    """``_adapt`` of each task, then two ``_meta_update`` calls: the
    adapted weights, the loss, every updated tensor and the Adam state
    against the JAX functions, for 1 and 2 inner steps."""
    jp, tp = _maml_pair(steps)
    pre, post = _task_batches(10)
    jpre = {k: jnp.asarray(v) for k, v in pre.items()}
    jpost = {k: jnp.asarray(v) for k, v in post.items()}
    tpre, tpost = tp._device_batch(pre), tp._device_batch(post)
    theta = _np_sd(tp.model)
    clipped = []
    for k in range(TASKS):
        want = _np(_fast(jp._adapt_fn)(jp.params,
                                {c: v[k] for c, v in jpre.items()}))
        adapted = tp._adapt(maml._task(tpre, k))
        _hold_moves(theta, want, {n: t.numpy() for n, t in adapted.items()},
                    f"adapt task {k}")
        clipped.append(_hold_ratios(tp, adapted, maml._task(tpost, k)))
    assert max(clipped) > 0  # the clip bites on some rows
    meta_update = _fast(jp._meta_update_fn)
    for _ in range(2):
        before = _np_sd(tp.model)
        jp.params, jp.opt_state, jloss = meta_update(
            jp.params, jp.opt_state, jpre, jpost)
        tloss = tp._meta_update(tpre, tpost)
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=STATS_RTOL)
        _hold_moves(before, _np(jp.params), _np_sd(tp.model), "meta")
    _hold_adam(jp.opt_state, tp.opt, tp.model,
               convert.fcnet_state_dict_from_jax)


def test_maml_requires_task_settable_env():
    config = (MAMLConfig().environment("CartPole-v1")
              .rollouts(num_rollout_workers=1).resources(**CPU))
    with pytest.raises(ValueError, match="TaskSettableEnv"):
        config.build()


# -- MBMPO --------------------------------------------------------------------

K, HORIZON, IMAGINED, MODEL_BS, N_DATA = 2, 6, 8, 16, 40
C_OBS, C_ACT = 3, 1


def _mbmpo_cfg():
    """entropy_coeff 0.1 and a meta lr of 0.05: see the meta-step test."""
    return _meta_cfg(ensemble_size=K, model_hiddens=(32,),
                     model_batch_size=MODEL_BS, horizon=HORIZON,
                     inner_lr=0.1, model_lr=1e-3, entropy_coeff=0.1,
                     lr=0.05)


def _spaces(continuous, box, discrete):
    if continuous:
        return box(-1.0, 1.0, (C_OBS,)), box(-2.0, 2.0, (C_ACT,))
    return box(-1.0, 1.0, (OBS_DIM,)), discrete(ACTIONS)


@functools.lru_cache(maxsize=None)
def _jax_mbmpo(continuous):
    """One JAX policy per action kind for the module (its jitted steps
    compile once), with its initial state."""
    jp = jmbmpo.MBMPOPolicy(*_spaces(continuous, JBox, JDiscrete),
                            _mbmpo_cfg())
    jp._train_models_fn = _fast(jp._train_models_fn)
    jp._meta_step_fn = _fast(jp._meta_step_fn)
    return jp, (jp.params, jp.opt_state, jp.dyn_params, jp.dyn_opt_state)


def _mbmpo_pair(continuous=False):
    """The JAX policy (reset to its initial state, then perturbed) and the
    port's on its weights."""
    jp, (params, opt_state, dyn_params, dyn_opt_state) = \
        _jax_mbmpo(continuous)
    jp.params = _perturbed(params, 3)
    jp.dyn_params = _perturbed(dyn_params, 4, 0.05)
    jp.opt_state, jp.dyn_opt_state = opt_state, dyn_opt_state
    tp = mbmpo.MBMPOPolicy(*_spaces(continuous, Box, Discrete),
                           _mbmpo_cfg())
    tp.set_weights(_np(jp.params))
    tp.dyn.load_state_dict(
        convert.mbmpo_ensemble_state_dict_from_jax(jp.dyn_params))
    return jp, tp


def _dyn(tree):
    return _np(tree, convert.mbmpo_ensemble_state_dict_from_jax)


def _model_data(seed, continuous=False):
    rng = np.random.default_rng(seed)
    od = C_OBS if continuous else OBS_DIM
    obs = rng.standard_normal((N_DATA, od)).astype(np.float32)
    act = (rng.uniform(-1, 1, (N_DATA, C_ACT)).astype(np.float32)
           if continuous else rng.integers(0, ACTIONS, N_DATA))
    nobs = (obs + 0.1 * rng.standard_normal(obs.shape)).astype(np.float32)
    rew = rng.standard_normal(N_DATA).astype(np.float32)
    return obs, act, nobs, rew


def _hold_ensemble_forward(jp, tp):
    """Each member of the converted ensemble computes the JAX member's
    (delta, reward) within 1e-5, and the batched product over K the
    same."""
    rng = np.random.default_rng(11)
    obs = rng.standard_normal((5, OBS_DIM)).astype(np.float32)
    act = np.eye(ACTIONS, dtype=np.float32)[rng.integers(0, ACTIONS, 5)]
    want = _fast(jax.vmap(jp.dyn.apply, in_axes=(0, None, None)))(
        jp.dyn_params, obs, act)
    with torch.no_grad():
        both = tp.dyn(torch.from_numpy(np.stack([obs] * K)),
                      torch.from_numpy(np.stack([act] * K)))
        for k in range(K):
            got = tp.dyn(torch.from_numpy(obs), torch.from_numpy(act), k)
            for g, b, w in zip(got, both, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w[k]),
                                           rtol=0, atol=1e-5)
                np.testing.assert_allclose(b[k].numpy(), np.asarray(w[k]),
                                           rtol=0, atol=1e-5)


def test_mbmpo_train_models_matches_jax():
    """The converted ensemble's forward (``_hold_ensemble_forward``), then
    two ensemble steps on bootstrap minibatches drawn from the JAX key:
    the loss, each member's updated tensors and the Adam state."""
    jp, tp = _mbmpo_pair()
    _hold_ensemble_forward(jp, tp)
    jp.dyn_opt_state = _warm_adam(jp.dyn_opt_state, tp.dyn_opt)
    data = _model_data(12)
    jdata = [jnp.asarray(x) for x in data]
    tdata = [torch.from_numpy(x) for x in data]
    key = jax.random.PRNGKey(5)
    for _ in range(2):
        key, rng = jax.random.split(key)
        idx = jax.random.randint(rng, (K, MODEL_BS), 0, N_DATA)
        before = _np_sd(tp.dyn)
        jp.dyn_params, jp.dyn_opt_state, jloss = jp._train_models_fn(
            jp.dyn_params, jp.dyn_opt_state, *jdata, rng)
        tloss = tp._train_models(*tdata,
                                 torch.from_numpy(np.array(idx)).long())
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=STATS_RTOL)
        _hold_moves(before, _dyn(jp.dyn_params), _np_sd(tp.dyn), "dyn")
    _hold_adam(jp.dyn_opt_state, tp.dyn_opt, tp.dyn,
               convert.mbmpo_ensemble_state_dict_from_jax)


def _closure(fn):
    """The names a jitted function's Python body closes over."""
    inner = fn.__wrapped__
    return dict(zip(inner.__code__.co_freevars,
                    (c.cell_contents for c in inner.__closure__)))


def _action_noise(key, continuous, b):
    """The per-step draws ``imagine`` takes from ``key``: ``[T, B, A]``."""
    shape = (b, C_ACT if continuous else ACTIONS)
    draw = jax.random.normal if continuous else jax.random.gumbel
    return torch.from_numpy(np.stack([
        np.array(draw(k, shape)) for k in jax.random.split(key, HORIZON)]))


def _hold_gumbel(tp, params, batch, noise):
    """Each imagined discrete action's Gumbel-max gap above
    ACTION_MARGIN."""
    with torch.no_grad():
        logits, _ = tp._forward(params, batch[SampleBatch.OBS])
        top = torch.topk(logits + noise.reshape(logits.shape), 2).values
    gap = float((top[:, 0] - top[:, 1]).min())
    assert gap > ACTION_MARGIN, gap


def _jax_theta(jp):
    return jax.tree_util.tree_map(jnp.asarray, jp.params)


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["discrete", "continuous"])
def test_mbmpo_imagined_rollout_matches_jax(continuous):
    """One imagined rollout inside member 1: the sampled actions equal,
    every column (states, logps, rewards, GAE advantages and targets)
    within ROLLOUT_TOL."""
    jp, tp = _mbmpo_pair(continuous)
    obs0 = np.random.default_rng(13).standard_normal(
        (IMAGINED, C_OBS if continuous else OBS_DIM)).astype(np.float32)
    key = jax.random.PRNGKey(6)
    member = jax.tree_util.tree_map(lambda x: x[1], jp.dyn_params)
    want = _fast(_closure(jp._meta_step_fn)["rollout_batch"])(
        _jax_theta(jp), member, jnp.asarray(obs0), key)
    noise = _action_noise(key, continuous, IMAGINED)
    with torch.no_grad():
        got = tp._rollout(tp._theta(), tp._dyn_constants(), 1,
                          torch.from_numpy(obs0), noise)
    if not continuous:
        _hold_gumbel(tp, tp._theta(), got, noise)
        np.testing.assert_array_equal(got[SampleBatch.ACTIONS].numpy(),
                                      np.asarray(want[SampleBatch.ACTIONS]))
    _hold_close({k: np.asarray(v) for k, v in want.items()},
                {k: v.numpy() for k, v in got.items()}, "rollout",
                ROLLOUT_TOL)


def _meta_noise(rng, continuous):
    """The meta-step's draws from ``rng``, by its splits: per member a
    pre and a post key, each split over the horizon."""
    keys = jax.random.split(rng, 2 * K).reshape(K, 2, -1)
    return {part: torch.stack([_action_noise(keys[k, j], continuous,
                                             IMAGINED) for k in range(K)])
            for j, part in enumerate(("pre", "post"))}


def _hold_meta_draws(tp, obs0, noise, continuous):
    """Before the meta-step: the Gumbel margins of every pre- and
    post-adaptation action, on the port's own rollouts."""
    if continuous:
        return
    theta, dyn = tp._theta(), tp._dyn_constants()
    for k in range(K):
        pre = tp._rollout(theta, dyn, k, obs0, noise["pre"][k])
        _hold_gumbel(tp, theta, pre, noise["pre"][k])
        adapted = {n: t.detach() for n, t in tp._adapt_params(
            theta, pre, create_graph=False).items()}
        with torch.no_grad():
            post = tp._rollout(adapted, dyn, k, obs0, noise["post"][k])
        _hold_gumbel(tp, adapted, post, noise["post"][k])


@pytest.mark.parametrize("continuous", [False, True],
                         ids=["discrete", "continuous"])
def test_mbmpo_meta_step_matches_jax(continuous):
    """Two meta-steps inside the ensemble (pre-imagine, adapt, post-
    imagine, PPO loss through the adaptation) on the JAX key's draws:
    the loss, the imagined reward, every updated tensor and the Adam
    state.  The imagined batch's logp is not detached in either package,
    so the ratio's two terms cancel and so does the surrogate's gradient,
    to rounding: a discrete policy's own tensors learn only through the
    entropy.  entropy_coeff 0.1 makes that gradient (of order 1e-4 in
    the torso) stand above the rounding (of order 1e-7), and the meta lr
    0.05 makes its updates large against the last place of the f32
    weights they are read from.  One inner step (MAML's test takes two
    through the same ``_adapt_params``)."""
    jp, tp = _mbmpo_pair(continuous)
    jp.opt_state = _warm_adam(jp.opt_state, tp.opt)
    obs0 = np.random.default_rng(14).standard_normal(
        (IMAGINED, C_OBS if continuous else OBS_DIM)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    for _ in range(2):
        key, rng = jax.random.split(key)
        noise = _meta_noise(rng, continuous)
        _hold_meta_draws(tp, torch.from_numpy(obs0), noise, continuous)
        before = _np_sd(tp.model)
        jp.params, jp.opt_state, jloss, jrew = jp._meta_step_fn(
            jp.params, jp.opt_state, jp.dyn_params, jnp.asarray(obs0), rng)
        tloss, trew = tp._meta_step(torch.from_numpy(obs0), noise)
        np.testing.assert_allclose(float(tloss), float(jloss),
                                   rtol=STATS_RTOL)
        np.testing.assert_allclose(float(trew), float(jrew),
                                   rtol=STATS_RTOL)
        _hold_moves(before, _np(jp.params), _np_sd(tp.model), "meta")
    _hold_adam(jp.opt_state, tp.opt, tp.model,
               convert.fcnet_state_dict_from_jax)


def test_mbmpo_state_round_trip():
    """The policy's state (model, ensemble, both Adams) as numpy into a
    fresh policy."""
    tp = mbmpo.MBMPOPolicy(Box(-1.0, 1.0, (OBS_DIM,)), Discrete(ACTIONS),
                           _mbmpo_cfg())
    data = [torch.from_numpy(x) for x in _model_data(15)]
    tp.train_models(*data)
    tp.meta_step(data[0][:IMAGINED])
    state = tp.get_state()
    assert _numpy_only(state)
    fresh = mbmpo.MBMPOPolicy(Box(-1.0, 1.0, (OBS_DIM,)), Discrete(ACTIONS),
                              _meta_cfg(ensemble_size=K, seed=9,
                                        model_hiddens=(32,)))
    fresh.set_state(state)
    for a, b in ((tp.model, fresh.model), (tp.dyn, fresh.dyn)):
        for (n, x), y in zip(a.state_dict().items(),
                             b.state_dict().values()):
            assert torch.equal(x, y), n
    assert fresh.dyn_opt.state_dict()["state"][0]["count"] == 1


# -- the learners' devices ----------------------------------------------------

def _meta_configs():
    rps = _league_config(AlphaStarConfig)
    es_cfg = ESConfig().environment("CartPole-v1")
    mb = MBMPOConfig().environment("CartPoleMass")
    return {"es": es_cfg, "alpha_star": rps, "mbmpo": mb}


@pytest.mark.parametrize("kind", ["es", "alpha_star", "mbmpo", "maml"])
def test_default_learner_needs_cuda(kind, monkeypatch):
    """Each learner with device code runs on the card by default and
    raises without CUDA; the CPU is used only when named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if kind == "maml":
        config = MAMLConfig().environment("CartPoleMass")
        assert config.num_gpus_per_learner == 1
        with pytest.raises(RuntimeError, match="device='cpu'"):
            config.build()
        return
    config = _meta_configs()[kind]
    assert config.num_gpus_per_learner == 1
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config.build()
    algo = config.resources(**CPU).build()
    try:
        policy = algo.get_policy()
        assert policy.device == torch.device("cpu")
        if kind == "alpha_star":
            assert all(pl.policy.device == torch.device("cpu")
                       for pl in algo.players.values())
    finally:
        algo.stop()
