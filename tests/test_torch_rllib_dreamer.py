"""The port's Dreamer against the JAX package's on the CPU, on vector
CartPole and on 8x8 PixelCatch (the conv encoder and the transposed-conv
decoder).

Both packages take the same (perturbed) weights, warmed Adam moments,
replayed sequences (with masked tails) and random draws: the port's
device draws come from ``DreamerLearner._draws``, replaced here by the
arrays the JAX package's keys give by the same splits.  The world-model
update (each loss, every tensor's move, Adam's moments), the behavior
update that follows it (both losses, the actor's and critic's moves) and
three acting steps are held: moves within UPDATE_TOL of the largest
element of the JAX package's move of each tensor, losses within
STATS_RTOL, forwards within FORWARD_TOL.  Decisions near a tie (each
imagined and acted argmax over logits + Gumbel noise, the KL's
free-nats floor) are asserted clear of it first.
"""

import copy

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from ray_tpu.rllib.algorithms import dreamer as jdreamer

from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib.algorithms import dreamer

UPDATE_TOL = 1e-3
STATS_RTOL = 1e-5
FORWARD_TOL = 1e-5
STATE_TOL = 1e-4      # posterior states after a walk of T steps
MARGIN = 1e-4         # least distance of a decision from its tie
WARM_COUNT, WARM_NU = 20, 1e-4
SIZES = {"deter_size": 16, "stoch_size": 4, "hidden_size": 16,
         "batch_size": 4, "batch_length": 8, "imagine_horizon": 3,
         "model_lr": 1e-3, "actor_lr": 1e-3, "critic_lr": 1e-3}
ENVS = {"cartpole": ("CartPole-v1", {}),
        "pixelcatch": ("PixelCatch", {"height": 8, "width": 8,
                                      "shaped": True})}


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


_BUILT = {}


def _built(key, make):
    """A JAX algorithm built once per module (flax's init and the jitted
    functions' compiles), then copied for each test."""
    if key not in _BUILT:
        _BUILT[key] = make()
    return copy.deepcopy(_BUILT[key])


def _perturbed(params, seed, scale=0.1):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x, np.float32) + scale
                              * rng.standard_normal(np.shape(x))
                              .astype(np.float32)), params)


def _warm(state):
    adam, rest = state
    return (optax.ScaleByAdamState(
        count=jnp.asarray(WARM_COUNT, jnp.int32),
        mu=jax.tree_util.tree_map(jnp.zeros_like, adam.mu),
        nu=jax.tree_util.tree_map(lambda x: jnp.full_like(x, WARM_NU),
                                  adam.nu)), rest)


def _warm_torch(opt):
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p] = {"count": WARM_COUNT, "mu": torch.zeros_like(p),
                            "nu": torch.full_like(p, WARM_NU)}


RSSM = convert.dreamer_rssm_state_dict_from_jax
HEAD = convert.dreamer_head_state_dict_from_jax


def _pair(env):
    name, env_config = ENVS[env]
    jc = jdreamer.DreamerConfig().environment(
        name, env_config=env_config).debugging(seed=0)
    tc = dreamer.DreamerConfig().environment(
        name, env_config=env_config).debugging(seed=0) \
        .resources(num_gpus_per_learner=0)
    for c in (jc, tc):
        for k, v in SIZES.items():
            setattr(c, k, v)
    def make():
        ja = jc.build()
        for name in ("_wm_update", "_behavior_update", "_policy_step"):
            setattr(ja, name, _fast(getattr(ja, name)))
        return ja
    ja, ta = _built(env, make), tc.build()
    ja.wm_params = _perturbed(ja.wm_params, 1)
    ja.actor_params = _perturbed(ja.actor_params, 2)
    ja.critic_params = _perturbed(ja.critic_params, 3)
    ja.wm_opt_state = _warm(ja.wm_opt_state)
    ja.actor_opt_state = _warm(ja.actor_opt_state)
    ja.critic_opt_state = _warm(ja.critic_opt_state)
    learner = ta.learner
    learner.wm.load_state_dict(RSSM(ja.wm_params))
    learner.actor.load_state_dict(HEAD(ja.actor_params))
    learner.critic.load_state_dict(HEAD(ja.critic_params))
    for opt in (learner.wm_opt, learner.actor_opt, learner.critic_opt):
        _warm_torch(opt)
    return ja, ta


def _np_sd(module):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


def _sd(tree, conv):
    return {k: v.numpy() for k, v in conv(tree).items()}


def _hold_moves(before, want, got, what):
    assert set(want) == set(got), what
    for name in want:
        w, g = want[name] - before[name], got[name] - before[name]
        scale = float(np.abs(w).max())
        if scale == 0.0:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=UPDATE_TOL * scale,
                                   err_msg=f"{what} {name}")


def _hold_moments(jstate, opt, module, conv, what):
    adam = jstate[0]
    names = {id(p): n for n, p in module.named_parameters()}
    for key in ("mu", "nu"):
        want = _sd(getattr(adam, key), conv)
        got = {names[id(p)]: s[key].numpy() for p, s in opt.state.items()}
        assert set(want) == set(got), (what, key)
        for name, w in want.items():
            np.testing.assert_allclose(
                got[name], w, rtol=0,
                atol=UPDATE_TOL * float(np.abs(w).max()),
                err_msg=f"{what} {key} {name}")


def _t(x):
    return torch.from_numpy(np.array(x))


def _observe_draws(key, steps, rows, stoch):
    """The JAX posterior walk's draws: one key a step, split off the
    carried key; the prior and posterior share its normal."""
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        out.append(np.asarray(jax.random.normal(k, (rows, stoch))))
    return {"normal": _t(np.stack(out))}


def _imagine_draws(key, horizon, rows, actions, stoch):
    """The JAX imagination's draws: a key a step; its first half draws
    the action's Gumbel noise, its second the prior latent's normal."""
    gumbel, normal = [], []
    for k in jax.random.split(key, horizon):
        k1, k2 = jax.random.split(k)
        gumbel.append(np.asarray(jax.random.gumbel(k1, (rows, actions))))
        normal.append(np.asarray(jax.random.normal(k2, (rows, stoch))))
    return {"gumbel": _t(np.stack(gumbel)), "normal": _t(np.stack(normal))}


def _act_draws(key, actions, stoch):
    k1, k2 = jax.random.split(key)
    return {"normal": _t(jax.random.normal(k1, (1, stoch))),
            "gumbel": _t(jax.random.gumbel(k2, (1, actions)))}


def _gap(scores):
    top2 = torch.topk(scores, 2, dim=-1).values
    return float((top2[..., 0] - top2[..., 1]).min())


def test_categorical_is_argmax_over_gumbel_noise():
    """jax.random.categorical is the argmax of the logits plus the same
    key's Gumbel draw: the port's actions take that draw as noise."""
    logits = jax.random.normal(jax.random.PRNGKey(0), (64, 3))
    for i in range(4):
        key = jax.random.PRNGKey(10 + i)
        want = jax.random.categorical(key, logits)
        got = jnp.argmax(logits + jax.random.gumbel(key, logits.shape), -1)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _episodes(algo, lengths, rng):
    """Replay episodes of the given lengths (the last step terminal)."""
    eps = []
    for t in lengths:
        dones = np.zeros(t, np.float32)
        dones[-1] = 1.0
        eps.append({"obs": rng.uniform(0, 1, (t + 1, algo.obs_dim)).astype(
                        np.float32),
                    "actions": rng.integers(0, algo.num_actions, t),
                    "rewards": rng.standard_normal(t).astype(np.float32),
                    "dones": dones})
    return eps


def _batch(ja, ta, rng):
    """One batch of sequences through both packages' samplers from the
    same episodes: equal bit for bit, with masked tails."""
    for ep in _episodes(ja, [3, 5, 12, 20], rng):
        ja._episodes.append(ep)
        ta._episodes.append(ep)
    jb = ja._sample_sequences(SIZES["batch_size"], SIZES["batch_length"])
    tb = ta._sample_sequences(SIZES["batch_size"], SIZES["batch_length"])
    assert set(jb) == set(tb)
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), tb[k], err_msg=k)
    assert 0 < tb["mask"].mean() < 1, "no masked tail in the batch"
    return jb, tb


@pytest.mark.parametrize("env", sorted(ENVS))
def test_converter_forward_is_exact(env):
    """The RSSM's prior step, posterior, decoder and heads, and the
    actor, on converted weights (the decoder's transposed convolutions
    take flax's kernels flipped)."""
    ja, ta = _pair(env)
    wm, wp, learner = ja.wm, ja.wm_params, ta.learner
    rng = np.random.default_rng(4)
    d, s = SIZES["deter_size"], SIZES["stoch_size"]
    deter = rng.standard_normal((5, d)).astype(np.float32)
    stoch = rng.standard_normal((5, s)).astype(np.float32)
    act = np.eye(ja.num_actions, dtype=np.float32)[rng.integers(0, 3, 5)]
    obs = rng.uniform(0, 1, (5, ja.obs_dim)).astype(np.float32)

    @_fast
    def forward(wp, ap, cp, deter, stoch, act, obs):
        jdeter, (jpm, jps), _ = wm.apply(wp, deter, stoch, act,
                                         jax.random.PRNGKey(3),
                                         method=wm.prior_step)
        jqm, jqs = wm.apply(wp, jdeter, obs, method=wm.posterior)
        feat = jnp.concatenate([jdeter, jqm], -1)
        return {"deter": jdeter, "pm": jpm, "ps": jps, "qm": jqm,
                "qs": jqs, "recon": wm.apply(wp, feat, method=wm.decode),
                "reward": wm.apply(wp, feat, method=wm.reward),
                "cont": wm.apply(wp, feat, method=wm.cont),
                "logits": ja.actor.apply(ap, feat),
                "value": ja.critic.apply(cp, feat)}

    want = forward(wp, ja.actor_params, ja.critic_params,
                   *map(jnp.asarray, (deter, stoch, act, obs)))
    with torch.no_grad():
        tw = learner.wm
        tdeter, (pm, ps) = tw.prior_step(_t(deter), _t(stoch), _t(act))
        qm, qs = tw.posterior(tdeter, tw.embed(_t(obs)))
        tfeat = torch.cat([tdeter, qm], -1)
        got = {"deter": tdeter, "pm": pm, "ps": ps, "qm": qm, "qs": qs,
               "recon": tw.decoder(tfeat), "reward": tw.reward(tfeat),
               "cont": tw.cont(tfeat), "logits": learner.actor(tfeat),
               "value": learner.critic(tfeat)}
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w),
                                   rtol=FORWARD_TOL, atol=FORWARD_TOL,
                                   err_msg=k)


@pytest.mark.parametrize("env", sorted(ENVS))
def test_world_model_and_behavior_updates_match_jax(env):
    """One world-model update (the posterior walk, every loss, every
    tensor, Adam's moments) and the behavior update after it, which
    imagines from the walk's states (before the world model's step) with
    the world model's weights after it."""
    ja, ta = _pair(env)
    learner = ta.learner
    rng = np.random.default_rng(5)
    jb, tb = _batch(ja, ta, rng)
    B, T = tb["mask"].shape
    S, A, H = SIZES["stoch_size"], ja.num_actions, SIZES["imagine_horizon"]
    k_wm, k_beh = jax.random.split(jax.random.PRNGKey(7))
    draws = _observe_draws(k_wm, T, B, S)
    batch = learner.tensors(tb)
    with torch.no_grad():  # the KL clear of the free-nats floor
        _, _, pm, ps, qm, qs = learner._observe(
            batch["obs"], batch["actions_onehot"], draws["normal"])
        kl = (torch.log(ps / qs) + (qs ** 2 + (qm - pm) ** 2)
              / (2 * ps ** 2) - 0.5).sum(-1)
        assert float(torch.abs(kl - 1.0).min()) > MARGIN
    wm_before = _np_sd(learner.wm)
    wp, wopt, jloss, (jrecon, jrl, jkl, jdeter, jstoch) = ja._wm_update(
        ja.wm_params, ja.wm_opt_state, jb, k_wm)
    total, recon, rloss, kl_loss, deter, stoch = learner._wm_update(
        batch, draws)
    for w, g in ((jloss, total), (jrecon, recon), (jrl, rloss),
                 (jkl, kl_loss)):
        np.testing.assert_allclose(float(g), float(w), rtol=STATS_RTOL)
    np.testing.assert_allclose(deter.numpy(), np.asarray(jdeter), rtol=0,
                               atol=STATE_TOL)
    np.testing.assert_allclose(stoch.numpy(), np.asarray(jstoch), rtol=0,
                               atol=STATE_TOL)
    _hold_moves(wm_before, _sd(wp, RSSM), _np_sd(learner.wm), "wm")
    _hold_moments(wopt, learner.wm_opt, learner.wm, RSSM, "wm adam")

    beh = _imagine_draws(k_beh, H, B * T, A, S)
    with torch.no_grad():  # every imagined action clear of its tie
        d_, s_ = deter.reshape(B * T, -1), stoch.reshape(B * T, -1)
        for h in range(H):
            scores = learner.actor(torch.cat([d_, s_], -1)) \
                + beh["gumbel"][h]
            assert _gap(scores) > MARGIN, h
            onehot = torch.nn.functional.one_hot(scores.argmax(-1), A)
            d_, (mean, std) = learner.wm.prior_step(d_, s_, onehot.float())
            s_ = mean + std * beh["normal"][h]
    actor_before, critic_before = _np_sd(learner.actor), \
        _np_sd(learner.critic)
    ap, cp, _, _, ja_loss, jc_loss = ja._behavior_update(
        wp, ja.actor_params, ja.critic_params, ja.actor_opt_state,
        ja.critic_opt_state, jdeter, jstoch, jb["mask"], k_beh)
    a_loss, c_loss = learner._behavior_update(deter, stoch, batch["mask"],
                                              beh)
    np.testing.assert_allclose(float(a_loss), float(ja_loss),
                               rtol=STATS_RTOL, atol=STATS_RTOL)
    np.testing.assert_allclose(float(c_loss), float(jc_loss),
                               rtol=STATS_RTOL)
    _hold_moves(actor_before, _sd(ap, HEAD), _np_sd(learner.actor), "actor")
    _hold_moves(critic_before, _sd(cp, HEAD), _np_sd(learner.critic),
                "critic")


@pytest.mark.parametrize("env", sorted(ENVS))
def test_policy_step_matches_jax(env):
    """Three acting steps: the posterior filter's deter and stoch, and
    the sampled actions."""
    ja, ta = _pair(env)
    learner = ta.learner
    rng = np.random.default_rng(6)
    jd, js = jnp.zeros((1, SIZES["deter_size"])), \
        jnp.zeros((1, SIZES["stoch_size"]))
    td, ts, prev = learner.initial_state()
    key = jax.random.PRNGKey(11)
    for _ in range(3):
        key, k = jax.random.split(key)
        obs = rng.uniform(0, 1, (1, ja.obs_dim)).astype(np.float32)
        draws = _act_draws(k, ja.num_actions, SIZES["stoch_size"])
        jd, js, jact = ja._policy_step(ja.wm_params, ja.actor_params, jd,
                                       js, jnp.asarray(prev.numpy()),
                                       jnp.asarray(obs), k)
        td, ts, tact = learner._policy_step(td, ts, prev, _t(obs), draws)
        with torch.no_grad():
            scores = learner.actor(torch.cat([td, ts], -1)) \
                + draws["gumbel"]
        assert _gap(scores) > MARGIN
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0,
                                   atol=FORWARD_TOL)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                                   atol=FORWARD_TOL)
        assert int(tact[0]) == int(jact[0])
        prev = torch.nn.functional.one_hot(tact, ja.num_actions).float()


def test_training_iteration_and_checkpoint(tmp_path):
    """A pixel Dreamer's train() (prefill, acting, both updates) on the
    CPU gives finite losses, and its checkpoint restores every network on
    a fresh algorithm."""
    _, ta = _pair("pixelcatch")
    ta.config["prefill_episodes"] = 2
    ta.config["train_iters_per_step"] = 2
    r = ta.train()
    for key in ("world_model_loss", "recon_loss", "reward_loss", "kl_loss",
                "actor_loss", "critic_loss"):
        assert np.isfinite(r[key]), (key, r[key])
    path = ta.save(str(tmp_path / "dreamer"))
    _, other = _pair("pixelcatch")
    other.restore(path)
    for name in ("wm", "actor", "critic"):
        for k, v in getattr(ta.learner, name).state_dict().items():
            assert torch.equal(v, getattr(other.learner, name)
                               .state_dict()[k]), (name, k)
    assert other.iteration == 1


def test_learner_needs_cuda_by_default(monkeypatch):
    """The world model, actor and critic are built on the card unless the
    config names the CPU; without CUDA the default raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dreamer.DreamerConfig().environment("CartPole-v1").build()
    algo = dreamer.DreamerConfig().environment("CartPole-v1").resources(
        num_gpus_per_learner=0).build()
    assert algo.get_policy().device == torch.device("cpu")
