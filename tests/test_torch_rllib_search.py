"""The port's Decision Transformer, AlphaZero and SlateQ against the JAX
package's, on the CPU.

Each network is converted from the JAX package's (perturbed) flax tree
and must compute its forward within MODEL_TOL.  Each learner then takes
two updates on the same batch with both Adams warmed to the same
moments (a cold Adam's first step is ``lr * sign(g)``): each tensor's
move within UPDATE_TOL of its largest element's, the Adam moments
likewise, the losses within STATS_RTOL.  Discrete choices are held by
their margins first: AlphaZero's PUCT selections (the best score above
the next by more than CHOICE_MARGIN, so the visit counts must be
equal), SlateQ's top-k slates (the k-th score above the next).
"""


import functools

import numpy as np
import pytest
import torch

import flax.linen as nn
import jax
import jax.numpy as jnp
import optax

from ray_tpu.rllib.algorithms import alpha_zero as jaz
from ray_tpu.rllib.algorithms import dt as jdt
from ray_tpu.rllib.algorithms import slateq as jslateq
from ray_tpu.rllib.env import make_env as jmake_env

from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib.algorithms import (AlphaZeroConfig, DTConfig,
                                            SlateQConfig)
from ray_tpu_torch.rllib.algorithms import alpha_zero, slateq

MODEL_TOL = 1e-5      # forward outputs, max abs, f32
UPDATE_TOL = 1e-3     # of the largest update of each tensor
STATS_RTOL = 1e-5
CHOICE_MARGIN = 1e-5  # least gap of a PUCT or top-k choice
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


def _np(tree, conv):
    return {k: v.numpy() for k, v in conv(tree).items()}


def _np_sd(module):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


def _close(got, want, tol=MODEL_TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=tol)


def _hold_moves(before, want, got, what):
    """Each tensor's move within UPDATE_TOL of the largest element of the
    JAX package's move; a tensor the JAX package leaves as it was stays
    as it was."""
    assert set(want) == set(got), what
    for name in want:
        w, g = want[name] - before[name], got[name] - before[name]
        scale = float(np.abs(w).max())
        if scale == 0.0:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=UPDATE_TOL * scale,
                                   err_msg=f"{what} {name}")


def _warm_adam(jax_state, opt):
    """Both Adams warmed to count WARM_COUNT, mu zero, nu WARM_NU; the
    JAX state's other members (adamw's decay and scale) as they were."""
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p] = {"count": WARM_COUNT, "mu": torch.zeros_like(p),
                            "nu": torch.full_like(p, WARM_NU)}
    adam = jax_state[0]
    return (optax.ScaleByAdamState(
        count=jnp.asarray(WARM_COUNT, jnp.int32),
        mu=jax.tree_util.tree_map(jnp.zeros_like, adam.mu),
        nu=jax.tree_util.tree_map(lambda x: jnp.full_like(x, WARM_NU),
                                  adam.nu)),) + tuple(jax_state[1:])


#: tensors whose gradient is zero in exact arithmetic: a key's bias adds
#: the same q . b to every logit of a query's row, which the softmax
#: cancels; both packages' gradients there are rounding
ZERO_GRAD = ("attn.key.bias",)
ROUNDING = 1e-6  # of the model's largest first moment


def _hold_adam(jax_state, learner, conv):
    """The moments within UPDATE_TOL of each tensor's largest element;
    those of ZERO_GRAD's tensors below ROUNDING of the model's largest
    first moment in both packages."""
    adam = jax_state[0]
    params = dict(learner.model.named_parameters())
    for key in ("mu", "nu"):
        want = _np(getattr(adam, key), conv)
        top = max(float(np.abs(w).max()) for w in want.values())
        for name, w in want.items():
            g = learner.opt.state[params[name]][key].numpy()
            if key == "mu" and name.endswith(ZERO_GRAD):
                assert float(np.abs(w).max()) < ROUNDING * top, name
                assert float(np.abs(g).max()) < ROUNDING * top, name
                continue
            np.testing.assert_allclose(
                g, w, rtol=0, atol=UPDATE_TOL * float(np.abs(w).max()),
                err_msg=f"adam {key} {name}")


def _stats(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=STATS_RTOL)


# -- Decision Transformer -----------------------------------------------------

DT_SIZES = dict(embed_dim=16, num_layers=2, num_heads=2, context_length=6)


def _episodes(n=6, seed=0):
    """CartPole-shaped episodes of 3 to 14 steps."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = int(rng.integers(3, 15))
        out.append({"obs": rng.standard_normal((t, 4)).astype(np.float32),
                    "actions": rng.integers(0, 2, t),
                    "rewards": np.ones(t, np.float32)})
    return out


def _dt_pair():
    episodes = _episodes()
    algos = []
    for cls in (jdt.DTConfig, DTConfig):
        config = cls().environment("CartPole-v1").debugging(seed=0)
        for k, v in dict(DT_SIZES, train_batch_size=8, lr=3e-3,
                         num_sgd_iter_per_step=2, input_=episodes).items():
            setattr(config, k, v)
        if cls is DTConfig:
            config.resources(**CPU)
        algos.append(config.build())
    ja, ta = algos
    ja._update, ja._logits = _fast(ja._update), _fast(ja._logits)
    ja.params = _perturbed(ja.params, 1)
    ta.learner.model.load_state_dict(
        convert.dt_state_dict_from_jax(ja.params))
    ja.opt_state = _warm_adam(ja.opt_state, ta.learner.opt)
    return ja, ta


def test_dt_sample_batch_logits_and_update_match_jax():
    """The numpy batch (padded tails included) is the JAX package's
    array for array; ``_logits`` on it (the converted net's forward,
    previous actions "none" (-1) at each window's start) within
    MODEL_TOL, then two masked-NLL AdamW updates: the loss, every
    tensor's move and the Adam moments."""
    ja, ta = _dt_pair()
    conv = convert.dt_state_dict_from_jax
    for _ in range(2):
        want_b = ja._sample_batch(8)
        got_b = ta._sample_batch(8)
        assert set(got_b) == set(want_b)
        for k, v in got_b.items():
            np.testing.assert_array_equal(v, np.asarray(want_b[k]), k)
        assert (got_b["mask"] == 0).any() and (got_b["mask"] == 1).any()
        tb = ta.learner.tensors(got_b)
        _close(ta.learner._logits(tb["obs"], tb["prev_act"],
                                  tb["rtg"]).numpy(),
               ja._logits(ja.params, want_b["obs"], want_b["prev_act"],
                          want_b["rtg"], want_b["mask"]))
        before = _np_sd(ta.learner.model)
        ja.params, ja.opt_state, jloss = ja._update(ja.params, ja.opt_state,
                                                    want_b)
        tloss = ta.learner._update(tb)
        _stats([tloss], [jloss])
        _hold_moves(before, _np(ja.params, conv), _np_sd(ta.learner.model),
                    "dt")
    _hold_adam(ja.opt_state, ta.learner, conv)
    ja.stop()
    ta.stop()


def test_dt_trains_and_checkpoints(tmp_path):
    """Two iterations (the loss finite, a conditioned episode each), and
    the saved weights restore into a fresh DT."""
    config = DTConfig().environment("CartPole-v1").resources(**CPU)
    for k, v in dict(DT_SIZES, train_batch_size=8,
                     num_sgd_iter_per_step=2, input_=_episodes(),
                     seed=0).items():
        setattr(config, k, v)
    ta = config.build()
    r = [ta.train() for _ in range(2)]
    assert all(np.isfinite(x["loss"]) for x in r)
    assert r[-1]["episodes_this_iter"] == 1
    ta.save(str(tmp_path))
    config = DTConfig().environment("CartPole-v1").resources(**CPU)
    for k, v in dict(DT_SIZES, input_=_episodes(), seed=4).items():
        setattr(config, k, v)
    fresh = config.build()
    fresh.restore(str(tmp_path))
    for (n, a), b in zip(ta.learner.model.state_dict().items(),
                         fresh.learner.model.state_dict().values()):
        assert torch.equal(a, b), n
    assert fresh.iteration == 2


# -- AlphaZero ----------------------------------------------------------------

AZ_ENV = {"height": 5, "width": 5, "seed": 1}


def _az_config(cls):
    config = cls().environment("PixelCatch", env_config=dict(AZ_ENV)) \
        .debugging(seed=0)
    config.num_simulations, config.lr = 12, 3e-3
    return config


@functools.lru_cache(maxsize=None)
def _jax_az():
    """One JAX AlphaZero for the module (its jitted forward and update
    compile once), with its initial state."""
    ja = _az_config(jaz.AlphaZeroConfig).build()
    ja._infer, ja._update = _fast(ja._infer), _fast(ja._update)
    return ja, (ja.params, ja.opt_state)


def _az_pair():
    """The JAX AlphaZero (reset: initial state perturbed, a fresh env and
    generator, as ``setup`` makes them) and the port's on its weights."""
    ja, (params, opt_state) = _jax_az()
    ja.params, ja.opt_state = _perturbed(params, 5, 0.3), opt_state
    ja.env = jmake_env("PixelCatch", dict(AZ_ENV))
    ja._np_rng = np.random.default_rng(0)
    ta = _az_config(AlphaZeroConfig).resources(**CPU).build()
    ta.learner.model.load_state_dict(
        convert.alpha_zero_state_dict_from_jax(ja.params))
    return ja, ta


def test_alpha_zero_infer_and_update_match_jax():
    """Priors and values of 16 boards, then two updates on visit
    distributions and returns: both losses, every tensor's move and the
    Adam moments."""
    ja, ta = _az_pair()
    ja.opt_state = _warm_adam(ja.opt_state, ta.learner.opt)
    conv = convert.alpha_zero_state_dict_from_jax
    rng = np.random.default_rng(6)
    obs = (rng.random((16, 25)) < 0.15).astype(np.float32)
    want = ja._infer(ja.params, jnp.asarray(obs))
    got = ta.learner._infer(torch.from_numpy(obs))
    for g, w in zip(got, want):
        _close(g.numpy(), w)
    pi = rng.dirichlet(np.ones(3), 16).astype(np.float32)
    z = rng.uniform(-1, 1, 16).astype(np.float32)
    batch = {"obs": obs, "pi": pi, "z": z}
    for _ in range(2):
        before = _np_sd(ta.learner.model)
        ja.params, ja.opt_state, pl, vl = ja._update(
            ja.params, ja.opt_state, {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        _stats(ta.learner.update(batch), (pl, vl))
        _hold_moves(before, _np(ja.params, conv), _np_sd(ta.learner.model),
                    "alpha_zero")
    _hold_adam(ja.opt_state, ta.learner, conv)


def test_alpha_zero_mcts_visits_match_jax(monkeypatch):
    """Three searches from three boards, with Dirichlet noise at the root
    (the same numpy draws) and without: every PUCT choice of the port
    clears CHOICE_MARGIN, and the visit distributions equal the JAX
    package's."""
    ja, ta = _az_pair()
    margins = []
    select = alpha_zero._puct_select

    def recording(node, c_puct):
        total = np.sqrt(node.visits)
        scores = sorted((child.value + c_puct * child.prior * total
                         / (1 + child.visits)
                         for child in node.children.values()),
                        reverse=True)
        margins.append(scores[0] - scores[1])
        return select(node, c_puct)
    monkeypatch.setattr(alpha_zero, "_puct_select", recording)
    for explore in (True, False, True):
        obs_j, _ = ja.env.reset()
        obs_t, _ = ta.env.reset()
        np.testing.assert_array_equal(obs_t, obs_j)
        got = ta._mcts(ta.env, np.asarray(obs_t, np.float32), explore)
        assert min(margins) > CHOICE_MARGIN, min(margins)
        want = ja._mcts(ja.env, np.asarray(obs_j, np.float32), explore)
        np.testing.assert_array_equal(got, want)
    assert ta.simulations == 3 * 12


# -- SlateQ -------------------------------------------------------------------

def _slateq_pair():
    algos = []
    for cls in (jslateq.SlateQConfig, SlateQConfig):
        config = cls().environment("SimpleRecEnv",
                                   env_config={"seed": 0}) \
            .debugging(seed=0)
        config.hiddens = (32, 32)
        config.lr = 3e-3
        if cls is SlateQConfig:
            config.resources(**CPU)
        algos.append(config.build())
    ja, ta = algos
    ja._score, ja._update = _fast(ja._score), _fast(ja._update)
    ja.params = _perturbed(ja.params, 7)
    ja.target_params = _perturbed(ja.params, 8, 0.05)
    conv = convert.item_q_state_dict_from_jax
    ta.learner.model.load_state_dict(conv(ja.params))
    ta.learner.target_model.load_state_dict(conv(ja.target_params))
    ja.opt_state = _warm_adam(ja.opt_state, ta.learner.opt)
    return ja, ta


def _slate_batch(ta, n=32, seed=9):
    """Transitions with clicked and no-click rows, and terminal ones."""
    rng = np.random.default_rng(seed)
    t, d = ta.topic_dim, ta.num_docs

    def unit(*shape):
        v = rng.standard_normal(shape + (t,))
        return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(
            np.float32)
    click = (rng.random(n) < 0.6).astype(np.float32)
    return {"state": unit(n), "clicked_doc": unit(n) * click[:, None],
            "click_mask": click,
            "reward": (rng.random(n) * click).astype(np.float32),
            "next_state": unit(n), "next_docs": unit(n, d),
            "done": (rng.random(n) < 0.1).astype(np.float32)}


def test_top_k_breaks_ties_like_jax():
    x = np.asarray([[1.0, 3.0, 3.0, 2.0, 3.0], [0.0, 0.0, 0.0, 0.0, 1.0],
                    [2.0, 2.0, 2.0, 2.0, 2.0]], np.float32)
    for k in (1, 3, 5):
        np.testing.assert_array_equal(
            slateq.top_k_indices(torch.from_numpy(x), k).numpy(),
            np.asarray(jax.lax.top_k(jnp.asarray(x), k)[1]))


def test_slateq_score_and_update_match_jax():
    """Item Qs of a batch's candidate docs, then two TD updates on the
    decomposed target (clicked and no-click rows): the loss, mean |td|,
    every tensor's move and the Adam moments; the target's top-k slates
    are held by their margin first."""
    ja, ta = _slateq_pair()
    conv = convert.item_q_state_dict_from_jax
    batch = _slate_batch(ta)
    assert 0 < batch["click_mask"].sum() < len(batch["click_mask"])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    _close(ta.learner._score(tb["next_state"], tb["next_docs"]).numpy(),
           ja._score(ja.params, batch["next_state"], batch["next_docs"]))
    with torch.no_grad():
        q = ta.learner._item_qs(ta.learner.target_model, tb["next_state"],
                                tb["next_docs"])
        aff = torch.einsum("bdt,bt->bd", tb["next_docs"], tb["next_state"])
        s = torch.sort(q * torch.sigmoid(aff), dim=1,
                       descending=True).values
    k = ta.slate_size
    gap = float((s[:, k - 1] - s[:, k]).min())
    assert gap > CHOICE_MARGIN, gap
    for _ in range(2):
        before = _np_sd(ta.learner.model)
        ja.params, ja.opt_state, loss, td = ja._update(
            ja.params, ja.target_params, ja.opt_state,
            {k: jnp.asarray(v) for k, v in batch.items()})
        _stats(ta.learner._update(tb), (loss, td))
        _hold_moves(before, _np(ja.params, conv), _np_sd(ta.learner.model),
                    "slateq")
    _hold_adam(ja.opt_state, ta.learner, conv)
    # the target network did not move
    for name, w in _np(ja.target_params, conv).items():
        np.testing.assert_array_equal(
            ta.learner.target_model.state_dict()[name].numpy(), w)


def test_slateq_trains_and_syncs_target():
    """Past the warm-up the learner updates, and its target copy is
    re-synced every ``target_network_update_freq`` steps."""
    config = SlateQConfig().environment(
        "SimpleRecEnv", env_config={"seed": 0}).debugging(seed=0) \
        .resources(**CPU)
    config.num_steps_sampled_before_learning_starts = 100
    config.target_network_update_freq = 100
    config.rollout_episodes_per_step = 4
    algo = config.build()
    results = [algo.train() for _ in range(3)]
    assert "loss" not in results[0] and np.isfinite(results[-1]["loss"])
    learner = algo.learner
    for a, b in zip(learner.model.parameters(),
                    learner.target_model.parameters()):
        assert not b.requires_grad
    assert algo._since_target < 100
    ev = algo.evaluate()
    assert np.isfinite(ev["episode_reward_mean"])


# -- the learners' devices ----------------------------------------------------

def _search_config(kind):
    if kind == "dt":
        config = DTConfig().environment("CartPole-v1")
        config.input_ = _episodes()
        return config
    if kind == "alpha_zero":
        return AlphaZeroConfig().environment("PixelCatch")
    return SlateQConfig().environment("SimpleRecEnv")


@pytest.mark.parametrize("kind", ["dt", "alpha_zero", "slateq"])
def test_default_learner_needs_cuda(kind, monkeypatch):
    """Each learner runs on the card by default and raises without CUDA;
    the CPU is used only when named."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config = _search_config(kind)
    assert config.num_gpus_per_learner == 1
    with pytest.raises(RuntimeError, match="device='cpu'"):
        config.build()
    algo = config.resources(**CPU).build()
    try:
        learner = algo.get_policy()
        assert learner.device == torch.device("cpu")
        assert all(p.device.type == "cpu"
                   for p in learner.model.parameters())
    finally:
        algo.stop()
