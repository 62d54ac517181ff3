"""The port's model-free algorithm zoo against the JAX package's, on the
CPU: V-trace, and one or two ``learn_on_batch`` calls of every policy
on the same (perturbed) weights, batch and update noise.

The JAX policies draw their update noise from threefry keys; the
port's draw theirs through one private method, ``_update_noise``,
which these tests replace with the arrays the JAX policy's key gives by
the same splits.  Each parameter's update (after minus before) is held
within UPDATE_TOL of the largest update of that parameter, target
networks' moves likewise, and the stats within STATS_RTOL relative (PR
16's tolerances for PPO).  Decisions near a tie (double-Q's argmax, the
Huber branch, APPO's clip, V-trace's ``min(rho_bar, rho)``) are held
first: the batches and perturbed weights keep every one of them away
from its tie, and the tests assert that margin.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ray_tpu.rllib.algorithms import cql as jcql
from ray_tpu.rllib.algorithms import crr as jcrr
from ray_tpu.rllib.algorithms import ddpg as jddpg
from ray_tpu.rllib.algorithms import dqn as jdqn
from ray_tpu.rllib.algorithms import impala as jimpala
from ray_tpu.rllib.algorithms import marwil as jmarwil
from ray_tpu.rllib.algorithms import pg as jpg
from ray_tpu.rllib.algorithms import r2d2 as jr2d2
from ray_tpu.rllib.algorithms import sac as jsac
from ray_tpu.rllib.env import Box as JBox
from ray_tpu.rllib.env import Discrete as JDiscrete
from ray_tpu.rllib.sample_batch import SampleBatch as JSampleBatch

from ray_tpu_torch.models import convert
from ray_tpu_torch.rllib.algorithms import cql, crr, ddpg, dqn, impala
from ray_tpu_torch.rllib.algorithms import marwil, pg, r2d2, sac
from ray_tpu_torch.rllib.env import Box, Discrete
from ray_tpu_torch.rllib.sample_batch import SampleBatch

UPDATE_TOL = 1e-3     # of the largest update of each parameter
STATS_RTOL = 1e-5
VTRACE_TOL = 1e-6
OBS_DIM, ACTIONS = 4, 3
C_OBS, C_ACT = 3, 2   # continuous: observation and action widths
MODEL = {"fcnet_hiddens": (32, 32)}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work: under the
    suite's ``-n 6`` the 256-wide learners' products would otherwise run
    six pools of a thread per core on the same cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rng(seed):
    return np.random.default_rng(seed)


def _perturbed(params, seed, scale=0.1):
    """flax's zero biases and orthogonal heads hide mapping faults (and
    put Q-values near ties): perturb every parameter."""
    rng = _rng(seed)
    return jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x, np.float32) + scale
                              * rng.standard_normal(np.shape(x))
                              .astype(np.float32)), params)


def _sd(tree, conv=convert.fcnet_state_dict_from_jax):
    """A flax tree in the port's layout, as numpy."""
    return {k: v.numpy() for k, v in conv(tree).items()}


def _np_sd(module):
    return {k: v.detach().cpu().numpy().copy()
            for k, v in module.state_dict().items()}


def _hold_moves(before, want, got, what):
    """Each tensor's move (after minus before) within UPDATE_TOL of the
    largest element of the JAX package's move; a tensor the JAX package
    leaves as it was stays exactly as it was."""
    assert set(want) == set(got), what
    for name in want:
        w, g = want[name] - before[name], got[name] - before[name]
        scale = float(np.abs(w).max())
        if scale == 0.0:
            np.testing.assert_array_equal(g, w, err_msg=f"{what} {name}")
            continue
        np.testing.assert_allclose(g, w, rtol=0, atol=UPDATE_TOL * scale,
                                   err_msg=f"{what} {name}")


def _hold_stats(want, got, keys):
    for key in keys:
        np.testing.assert_allclose(got[key], want[key], rtol=STATS_RTOL,
                                   err_msg=key)


# -- V-trace -----------------------------------------------------------------

def _discrete_pair(jcls, tcls, **cfg):
    """The JAX policy and the port's (CPU) on the JAX policy's perturbed
    weights."""
    config = {"seed": 0, "_device": "cpu", "model": MODEL, **cfg}
    jp = jcls(JBox(-1.0, 1.0, (OBS_DIM,)), JDiscrete(ACTIONS), dict(config))
    tp = tcls(Box(-1.0, 1.0, (OBS_DIM,)), Discrete(ACTIONS), dict(config))
    jp.set_weights(_perturbed(jp.get_weights(), 1))
    tp.set_weights(_sd(jp.get_weights()))
    return jp, tp


@pytest.mark.parametrize("clips", [(1.0, 1.0), (0.8, 1.5)])
def test_vtrace_matches_jax(clips):
    """Random [B, T] inputs with terminations and truncations inside the
    unroll; the rho clip never within 1e-4 of a rho."""
    rho_bar, c_bar = clips
    jp, tp = _discrete_pair(jimpala.ImpalaPolicy, impala.ImpalaPolicy,
                            vtrace_clip_rho_threshold=rho_bar,
                            vtrace_clip_c_threshold=c_bar)
    rng = _rng(20)
    B, T, gamma = 5, 12, 0.97
    vf, v_next, rew = (rng.standard_normal((B, T)).astype(np.float32)
                       for _ in range(3))
    term = rng.random((B, T)) < 0.1
    trunc = ~term & (rng.random((B, T)) < 0.1)
    assert term.any() and trunc.any()
    done = (term | trunc).astype(np.float32)
    rhos = np.exp(0.7 * rng.standard_normal((B, T))).astype(np.float32)
    for bar in clips:
        assert np.abs(rhos - bar).min() > 1e-4
    args = (vf, v_next, rew, (gamma * (1.0 - term)).astype(np.float32),
            (gamma * (1.0 - done)).astype(np.float32), done, rhos)
    want = jp._vtrace(*(jnp.asarray(a) for a in args))
    got = tp._vtrace(*(torch.from_numpy(a) for a in args))
    for g, w in zip(got, want):
        assert not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=VTRACE_TOL)


# -- the discrete learners -----------------------------------------------------

def _unroll_batch(n, seed=21):
    """n rows of CartPole-shaped transitions: random behaviour logps (so
    the rhos spread), terminations and truncations inside the unrolls."""
    rng = _rng(seed)
    term = rng.random(n) < 0.08
    return {
        "obs": rng.standard_normal((n, OBS_DIM)).astype(np.float32),
        "new_obs": rng.standard_normal((n, OBS_DIM)).astype(np.float32),
        "actions": rng.integers(0, ACTIONS, n),
        "action_logp": (np.log(1 / ACTIONS) + 0.3 * rng.standard_normal(n)
                        ).astype(np.float32),
        "rewards": rng.random(n).astype(np.float32),
        "terminateds": term,
        "truncateds": ~term & (rng.random(n) < 0.08),
        "advantages": rng.standard_normal(n).astype(np.float32),
        "value_targets": rng.standard_normal(n).astype(np.float32),
        "eps_id": np.cumsum(rng.random(n) < 0.1),
    }


def _learn_discrete(jcls, tcls, batch, calls=1, **cfg):
    jp, tp = _discrete_pair(jcls, tcls, **cfg)
    before = tp.get_weights()
    for _ in range(calls):
        jstats = jp.learn_on_batch(JSampleBatch(copy.deepcopy(batch)))
        tstats = tp.learn_on_batch(SampleBatch(copy.deepcopy(batch)))
    return jp, tp, before, jstats, tstats


def _rhos(policy, batch, T):
    """The port's rhos on ``batch`` as [B, T] unrolls, before learning."""
    B = len(batch["obs"]) // T
    with torch.no_grad():
        logits, _ = policy.model(torch.from_numpy(batch["obs"][:B * T]))
        logp = policy.dist.logp(logits,
                                torch.from_numpy(batch["actions"][:B * T]))
    return np.exp(logp.numpy() - batch["action_logp"][:B * T])


@pytest.mark.parametrize("jcls,tcls", [
    (jimpala.ImpalaPolicy, impala.ImpalaPolicy),
    (jimpala.APPOPolicy, impala.APPOPolicy)], ids=["impala", "appo"])
def test_impala_family_learn_on_batch_matches_jax(jcls, tcls):
    """Two updates on 4 unrolls of 8 (the 3 tail rows dropped)."""
    T = 8
    batch = _unroll_batch(4 * T + 3)
    jp, tp, before, jstats, tstats = _learn_discrete(
        jcls, tcls, batch, calls=2, rollout_fragment_length=T,
        entropy_coeff=0.02, clip_param=0.2)
    rhos = _rhos(_discrete_pair(jcls, tcls)[1], batch, T)
    assert np.abs(rhos - 1.0).min() > 1e-4          # the V-trace clips
    assert min(np.abs(rhos - 0.8).min(), np.abs(rhos - 1.2).min()) > 1e-4
    assert (rhos > 1.2).any() and (rhos < 0.8).any()  # APPO's clip bites
    _hold_moves(before, _sd(jp.get_weights()), tp.get_weights(), "params")
    _hold_stats(jstats, tstats, ("policy_loss", "vf_loss", "entropy",
                                 "mean_rho", "total_loss", "grad_gnorm"))


@pytest.mark.parametrize("kind", ["pg", "a2c"])
def test_pg_a2c_learn_on_batch_matches_jax(kind):
    jcls, tcls = {"pg": (jpg.PGPolicy, pg.PGPolicy),
                  "a2c": (jpg.A2CPolicy, pg.A2CPolicy)}[kind]
    batch = _unroll_batch(48, seed=22)
    jp, tp, before, jstats, tstats = _learn_discrete(jcls, tcls, batch,
                                                     calls=2)
    _hold_moves(before, _sd(jp.get_weights()), tp.get_weights(), "params")
    _hold_stats(jstats, tstats, ("policy_loss", "entropy", "total_loss",
                                 "grad_gnorm")
                + (("vf_loss",) if kind == "a2c" else ()))


@pytest.mark.parametrize("beta", [1.0, 0.0], ids=["marwil", "bc"])
def test_marwil_learn_on_batch_matches_jax(beta):
    """Returns swept on the host, the running advantage norm updated
    after each call (a rate large enough to move it)."""
    batch = _unroll_batch(64, seed=23)
    jp, tp, before, jstats, tstats = _learn_discrete(
        jmarwil.MARWILPolicy, marwil.MARWILPolicy, batch, calls=2,
        beta=beta, moving_average_sqd_adv_norm_update_rate=0.1)
    _hold_moves(before, _sd(jp.get_weights()), tp.get_weights(), "params")
    keys = ("policy_loss", "entropy", "total_loss", "grad_gnorm")
    if beta:
        keys += ("vf_loss", "mean_adv")
        assert tp._ma_sqd_adv_norm != 100.0
    np.testing.assert_allclose(tp._ma_sqd_adv_norm, jp._ma_sqd_adv_norm,
                               rtol=STATS_RTOL)
    _hold_stats(jstats, tstats, keys)


def _a2c_grads(policy, batch, micro, tree_add, tree_scale):
    """A2C's microbatch accumulation, as its training_step does it."""
    acc, total = None, len(batch)
    for start in range(0, total, micro):
        mb = batch.slice(start, min(start + micro, total))
        grads, _ = policy.compute_gradients(mb)
        weighted = tree_scale(grads, len(mb) / total)
        acc = weighted if acc is None else tree_add(acc, weighted)
    return acc


def test_a2c_microbatch_gradients_through_apply_gradients():
    """Gradients accumulated over microbatches (one of them short), then
    applied through apply_gradients (A3C's path), with a clip that
    bites."""
    jp, tp = _discrete_pair(jpg.A2CPolicy, pg.A2CPolicy, grad_clip=0.05)
    batch = _unroll_batch(50, seed=24)
    jgrads = _a2c_grads(jp, JSampleBatch(copy.deepcopy(batch)), 16,
                        jpg._tree_add, jpg._tree_scale)
    tgrads = _a2c_grads(tp, SampleBatch(copy.deepcopy(batch)), 16,
                        pg._tree_add, pg._tree_scale)
    names = [n for n, _ in tp.model.named_parameters()]
    want = _sd(jgrads)
    largest = max(float(np.abs(g).max()) for g in want.values())
    for name, g in zip(names, tgrads):
        np.testing.assert_allclose(g, want[name], rtol=0,
                                   atol=1e-5 * largest, err_msg=name)
    assert float(np.sqrt(sum(np.sum(g * g) for g in tgrads))) > 0.05
    before = tp.get_weights()
    jp.apply_gradients(jgrads)
    tp.apply_gradients(tgrads)
    _hold_moves(before, _sd(jp.get_weights()), tp.get_weights(), "params")


def test_a3c_worker_grads_on_a_host_sampler():
    """A3C's worker-side function on a CPU rollout worker: one fragment,
    standardised, its gradients as numpy in parameter order."""
    from ray_tpu_torch.rllib.env import CartPole
    from ray_tpu_torch.rllib.rollout_worker import RolloutWorker
    w = RolloutWorker(CartPole, pg.A2CPolicy,
                      {"seed": 0, "_device": "cpu", "model": MODEL,
                       "rollout_fragment_length": 20}, worker_index=1)
    grads, stats = pg._worker_grads(w)
    assert stats["batch_len"] == 20
    shapes = [tuple(p.shape) for p in w.policy.model.parameters()]
    assert [g.shape for g in grads] == shapes
    assert all(isinstance(g, np.ndarray) for g in grads)


# -- DQN and R2D2 ----------------------------------------------------------------

def _with_target(pair, conv=convert.fcnet_state_dict_from_jax):
    """A Q-learning pair whose target network differs from the online
    one."""
    jp, tp = pair
    jp.target_params = _perturbed(jp.params, 2)
    tp.target_model.load_state_dict(conv(jp.target_params))
    return jp, tp


def _dqn_batch(n, seed=25, weights=False):
    b = _unroll_batch(n, seed)
    out = {k: b[k] for k in ("obs", "new_obs", "actions", "rewards",
                             "terminateds")}
    out["rewards"] = 3 * out["rewards"]  # |td| on both Huber branches
    if weights:
        out["weights"] = _rng(seed + 1).uniform(0.2, 1.0, n).astype(
            np.float32)
    return out


def _argmax_margin(q):
    top2 = np.sort(q, axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


@pytest.mark.parametrize("double_q,weights", [(True, False), (False, True)],
                         ids=["double_q", "simple_q_prioritized"])
def test_dqn_learn_on_batch_matches_jax(double_q, weights):
    batch = _dqn_batch(64, weights=weights)
    jp, tp = _with_target(_discrete_pair(jdqn.DQNPolicy, dqn.DQNPolicy,
                                         double_q=double_q))
    with torch.no_grad():  # the argmaxes and the Huber branch, off ties
        q_next = tp.model(torch.from_numpy(batch["new_obs"]))[0].numpy()
        assert _argmax_margin(q_next) > 1e-4
    before = tp.get_weights()
    jstats = jp.learn_on_batch(JSampleBatch(copy.deepcopy(batch)))
    tstats = tp.learn_on_batch(SampleBatch(copy.deepcopy(batch)))
    td = jstats.pop("_td_error_np")
    assert (np.abs(td) < 1).any() and (np.abs(td) > 1).any()
    assert np.abs(np.abs(td) - 1).min() > 1e-4
    np.testing.assert_allclose(tstats.pop("_td_error_np"), td, rtol=0,
                               atol=1e-5 * np.abs(td).max())
    _hold_moves(before, _sd(jp.get_weights()), tp.get_weights(), "params")
    _hold_stats(jstats, tstats, ("mean_q", "td_error_abs", "total_loss",
                                 "grad_gnorm"))
    target = _np_sd(tp.target_model)
    tp.update_target()
    _hold_moves(target, _np_sd(tp.model), _np_sd(tp.target_model),
                "update_target")


R2D2_MODEL = {"use_lstm": True, "lstm_cell_size": 16, "max_seq_len": 6,
              "fcnet_hiddens": (16,)}


def _r2d2_pair(**cfg):
    config = {"seed": 0, "_device": "cpu", "model": R2D2_MODEL, **cfg}
    jp = jr2d2.R2D2Policy(JBox(-1.0, 1.0, (OBS_DIM,)), JDiscrete(ACTIONS),
                          dict(config))
    tp = r2d2.R2D2Policy(Box(-1.0, 1.0, (OBS_DIM,)), Discrete(ACTIONS),
                         dict(config))
    jp.set_weights(_perturbed(jp.get_weights(), 1))
    tp.set_weights(_sd(jp.get_weights(), convert.lstm_state_dict_from_jax))
    return jp, tp


def _sequences(S=8, L=6, seed=26):
    """[S, L] padded sequences with stored carries; some end early, some
    in a termination."""
    rng = _rng(seed)
    lens = rng.integers(2, L + 1, S)
    mask = (np.arange(L)[None] < lens[:, None]).astype(np.float32)
    term = np.zeros((S, L), bool)
    term[np.arange(S), lens - 1] = rng.random(S) < 0.5
    return {
        "obs": rng.standard_normal((S, L, OBS_DIM)).astype(np.float32)
        * mask[..., None],
        "actions": rng.integers(0, ACTIONS, (S, L)) * mask.astype(int),
        "rewards": 3 * rng.random((S, L)).astype(np.float32) * mask,
        "terminateds": term,
        "seq_mask": mask,
        "state_in_c": rng.standard_normal((S, 16)).astype(np.float32),
        "state_in_h": np.tanh(rng.standard_normal((S, 16))).astype(
            np.float32)}


@pytest.mark.parametrize("double_q", [True, False])
def test_r2d2_learn_on_sequences_matches_jax(double_q):
    seq = _sequences()
    jp, tp = _with_target(_r2d2_pair(double_q=double_q),
                          convert.lstm_state_dict_from_jax)
    with torch.no_grad():
        q, _, _ = tp.model(torch.from_numpy(seq["obs"]),
                           (torch.from_numpy(seq["state_in_c"]),
                            torch.from_numpy(seq["state_in_h"])))
        assert _argmax_margin(q.numpy()[seq["seq_mask"] > 0]) > 1e-4
    before = tp.get_weights()
    for _ in range(2):
        jstats = jp.learn_on_sequences(copy.deepcopy(seq))
        tstats = tp.learn_on_sequences(copy.deepcopy(seq))
    _hold_moves(before,
                _sd(jp.get_weights(), convert.lstm_state_dict_from_jax),
                tp.get_weights(), "params")
    _hold_stats(jstats, tstats, ("loss", "mean_q", "td_error_abs"))


def test_r2d2_epsilon_greedy_acting_matches_jax():
    """The greedy action through the carried LSTM state, and numpy's
    epsilon draws, as the JAX policy takes them."""
    jp, tp = _r2d2_pair(epsilon_timesteps=40)
    rng = _rng(27)
    state = tuple(np.asarray(s) for s in jp.get_initial_state(8))
    for explore in (False, True, True):
        obs = rng.standard_normal((8, OBS_DIM)).astype(np.float32)
        ja, jstate, _ = jp.compute_actions_rnn(obs, state, explore)
        ta, tstate, _ = tp.compute_actions_rnn(obs, state, explore)
        np.testing.assert_array_equal(ta, ja)
        for a, b in zip(tstate, jstate):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        state = tuple(np.asarray(s) for s in jstate)
    assert tp._steps == jp._steps == 16


# -- the continuous learners -----------------------------------------------------

C_LOW, C_HIGH = np.full(C_ACT, -2.0, np.float32), np.full(C_ACT, 2.0,
                                                          np.float32)


def _cont_batch(n, seed=28, weights=False):
    rng = _rng(seed)
    out = {"obs": rng.standard_normal((n, C_OBS)).astype(np.float32),
           "new_obs": rng.standard_normal((n, C_OBS)).astype(np.float32),
           "actions": rng.uniform(-1.9, 1.9, (n, C_ACT)).astype(np.float32),
           "rewards": rng.standard_normal(n).astype(np.float32),
           "terminateds": rng.random(n) < 0.1}
    if weights:
        out["weights"] = rng.uniform(0.2, 1.0, n).astype(np.float32)
    return out


def _cont_pair(jcls, tcls, **cfg):
    config = {"seed": 0, "_device": "cpu", "lr": 1e-3, **cfg}
    jp = jcls(JBox(-1.0, 1.0, (C_OBS,)), JBox(C_LOW, C_HIGH, (C_ACT,)),
              dict(config))
    tp = tcls(Box(-1.0, 1.0, (C_OBS,)), Box(C_LOW, C_HIGH, (C_ACT,)),
              dict(config))
    return jp, tp


WARM_COUNT, WARM_NU = 20, 1e-4


def _warm_adam(jax_state, opt):
    """Both packages' Adam states warmed to the same moments: ``count``
    WARM_COUNT, ``mu`` zero, ``nu`` WARM_NU everywhere.  A cold Adam's
    first step is ``lr * sign(g)`` wherever ``|g|`` is far above its
    epsilon, so an element whose gradient cancels to rounding level
    (there are some among the 256-wide critics' 130,000 weights) steps
    by ``+lr`` in one package and ``-lr`` in the other; from these
    moments an update is linear in a small gradient, so such an element
    moves by next to nothing in both."""
    import optax
    for group in opt.param_groups:
        for p in group["params"]:
            opt.state[p] = {"count": WARM_COUNT, "mu": torch.zeros_like(p),
                            "nu": torch.full_like(p, WARM_NU)}
    adam, rest = jax_state
    return (optax.ScaleByAdamState(
        count=jnp.asarray(WARM_COUNT, jnp.int32),
        mu=jax.tree_util.tree_map(jnp.zeros_like, adam.mu),
        nu=jax.tree_util.tree_map(lambda x: jnp.full_like(x, WARM_NU),
                                  adam.nu)), rest)


def _sac_pair(jcls, tcls, **cfg):
    jp, tp = _cont_pair(jcls, tcls, initial_alpha=0.5, **cfg)
    # a smaller perturbation and a log_std bias lowered by 2 keep tanh
    # out of saturation, where log(1 - tanh^2 + 1e-6) turns the last-ulp
    # difference between XLA's tanh and ATen's into a different loss
    # (_hold_unsaturated asserts the margin)
    actor = _perturbed(jp.actor_params, 3, 0.02)
    log_std = actor["params"]["log_std"]
    jp.actor_params = {"params": {**actor["params"], "log_std": {
        **log_std, "bias": log_std["bias"] - 2.0}}}
    jp.critic_params = _perturbed(jp.critic_params, 4)
    jp.target_critic_params = _perturbed(jp.critic_params, 5, 0.05)
    tp.actor.load_state_dict(
        convert.squashed_actor_state_dict_from_jax(jp.actor_params))
    tp.critic.load_state_dict(
        convert.twin_q_state_dict_from_jax(jp.critic_params))
    tp.target_critic.load_state_dict(
        convert.twin_q_state_dict_from_jax(jp.target_critic_params))
    assert float(tp.log_alpha.detach()) == float(jp.log_alpha)
    jp.actor_opt_state = _warm_adam(jp.actor_opt_state, tp.actor_opt)
    jp.critic_opt_state = _warm_adam(jp.critic_opt_state, tp.critic_opt)
    jp.alpha_opt_state = _warm_adam(jp.alpha_opt_state, tp.alpha_opt)
    return jp, tp


def _jax_noise(key, kind, B, cfg):
    """The update noise the JAX policy draws from ``key`` (its ``_rng``
    before the call), by the same splits, as the port's tensors."""
    _, rng = jax.random.split(key)
    n = lambda k, shape: torch.from_numpy(  # noqa: E731
        np.array(jax.random.normal(k, shape)))
    if kind == "ddpg":
        return {"target": n(rng, (B, C_ACT))} \
            if cfg.get("smooth_target_policy") else {}
    if kind == "sac":
        r1, r2 = jax.random.split(rng)
        return {"next": n(r1, (B, C_ACT)), "actor": n(r2, (B, C_ACT))}
    if kind == "cql":
        r1, r2, r3, r4 = jax.random.split(rng, 4)
        na = cfg.get("cql_n_actions", 4)
        return {"next": n(r1, (B, C_ACT)), "actor": n(r2, (B, C_ACT)),
                "random": torch.from_numpy(np.array(jax.random.uniform(
                    r3, (na * B, C_ACT), minval=-1.0, maxval=1.0))),
                "policy": n(r4, (na * B, C_ACT))}
    r1, r2 = jax.random.split(rng)  # crr
    m = cfg.get("advantage_samples", 4)
    return {"next": n(r1, (B, C_ACT)), "baseline": n(r2, (m * B, C_ACT))}


SATURATION_MARGIN = 1e-2  # least 1 - tanh(pre)^2 of any squashed draw


def _hold_unsaturated(tp, batch, noise):
    """Every squashed-Gaussian draw of the update (next actions on
    new_obs, the actor's and the penalty's or baseline's on obs) keeps
    1 - tanh(pre)^2 above SATURATION_MARGIN."""
    with torch.no_grad():
        for key, draws in noise.items():
            if key == "random":
                continue
            obs = torch.from_numpy(batch["new_obs" if key == "next"
                                         else "obs"])
            mean, log_std = tp.actor(obs)
            reps = draws.shape[0] // obs.shape[0]
            pre = torch.repeat_interleave(mean, reps, dim=0) \
                + torch.exp(torch.repeat_interleave(log_std, reps, dim=0)) \
                * draws
            margin = float((1 - torch.tanh(pre) ** 2).min())
            assert margin > SATURATION_MARGIN, (key, margin)


def _learn_seeded(jp, tp, kind, batch, calls, cfg):
    """``calls`` updates of both, the port's noise replaced by the JAX
    policy's."""
    B = len(batch["obs"])
    for _ in range(calls):
        noise = _jax_noise(jp._rng, kind, B, cfg)
        if kind != "ddpg":
            _hold_unsaturated(tp, batch, noise)
        tp._update_noise = lambda b, noise=noise: (
            {k: v.clone() for k, v in noise.items()} if b == B else None)
        jstats = jp.learn_on_batch(JSampleBatch(copy.deepcopy(batch)))
        tstats = tp.learn_on_batch(SampleBatch(copy.deepcopy(batch)))
    return jstats, tstats


def _sac_state(policy_or_jax, jax_side):
    """(actor, critic, target critic) in the port's layout, as numpy."""
    if jax_side:
        p = policy_or_jax
        return (_sd(p.actor_params,
                    convert.squashed_actor_state_dict_from_jax),
                _sd(p.critic_params, convert.twin_q_state_dict_from_jax),
                _sd(p.target_critic_params,
                    convert.twin_q_state_dict_from_jax))
    p = policy_or_jax
    return (_np_sd(p.actor), _np_sd(p.critic), _np_sd(p.target_critic))


SAC_FAMILY = {
    "sac": (jsac.SACPolicy, sac.SACPolicy, {},
            ("critic_loss", "actor_loss", "alpha", "mean_q")),
    "cql": (jcql.CQLPolicy, cql.CQLPolicy,
            {"cql_n_actions": 3, "cql_weight": 2.0},
            ("critic_loss", "td_loss", "cql_penalty", "actor_loss",
             "alpha")),
    "crr": (jcrr.CRRPolicy, crr.CRRPolicy,
            {"advantage_samples": 3, "beta": 2.0},
            ("critic_loss", "actor_loss", "mean_advantage",
             "mean_weight")),
    "crr_bin": (jcrr.CRRPolicy, crr.CRRPolicy,
                {"advantage_samples": 3, "weight_type": "bin"},
                ("critic_loss", "actor_loss", "mean_weight")),
}


@pytest.mark.parametrize("kind", sorted(SAC_FAMILY))
def test_sac_family_learn_on_batch_matches_jax(kind):
    """Two updates: the critic's, the actor's against the updated
    critic, the temperature's, and the Polyak target."""
    jcls, tcls, cfg, stats = SAC_FAMILY[kind]
    jp, tp = _sac_pair(jcls, tcls, tau=0.1, **cfg)
    batch = _cont_batch(32)
    before = _sac_state(tp, False)
    alpha_before = float(tp.log_alpha.detach())
    jstats, tstats = _learn_seeded(jp, tp, kind.split("_")[0], batch, 2,
                                   cfg)
    for what, b, w, g in zip(("actor", "critic", "target_critic"), before,
                             _sac_state(jp, True), _sac_state(tp, False)):
        _hold_moves(b, w, g, what)
    move = float(jp.log_alpha) - alpha_before
    if kind.startswith("crr"):
        assert move == 0.0 and float(tp.log_alpha.detach()) == alpha_before
    else:
        assert abs(float(tp.log_alpha.detach()) - alpha_before - move) \
            <= UPDATE_TOL * abs(move)
    _hold_stats(jstats, tstats, stats)


def _ddpg_pair(**cfg):
    jp, tp = _cont_pair(jddpg.DDPGPolicy, ddpg.DDPGPolicy, **cfg)
    jp.actor_params = _perturbed(jp.actor_params, 3)
    jp.critic_params = _perturbed(jp.critic_params, 4)
    jp.target_actor_params = _perturbed(jp.actor_params, 5, 0.05)
    jp.target_critic_params = _perturbed(jp.critic_params, 6, 0.05)
    for module, tree, conv in (
            (tp.actor, jp.actor_params,
             convert.det_actor_state_dict_from_jax),
            (tp.critic, jp.critic_params,
             convert.twin_q_state_dict_from_jax),
            (tp.target_actor, jp.target_actor_params,
             convert.det_actor_state_dict_from_jax),
            (tp.target_critic, jp.target_critic_params,
             convert.twin_q_state_dict_from_jax)):
        module.load_state_dict(conv(tree))
    jp.actor_opt_state = _warm_adam(jp.actor_opt_state, tp.actor_opt)
    jp.critic_opt_state = _warm_adam(jp.critic_opt_state, tp.critic_opt)
    return jp, tp


def _ddpg_state(p, jax_side):
    if jax_side:
        a, q = convert.det_actor_state_dict_from_jax, \
            convert.twin_q_state_dict_from_jax
        return (_sd(p.actor_params, a), _sd(p.critic_params, q),
                _sd(p.target_actor_params, a),
                _sd(p.target_critic_params, q))
    return (_np_sd(p.actor), _np_sd(p.critic), _np_sd(p.target_actor),
            _np_sd(p.target_critic))


DDPG_CASES = {
    "ddpg": {},
    "td3": {"twin_q": True, "policy_delay": 2,
            "smooth_target_policy": True, "target_noise": 0.3},
    "ddpg_prioritized": {},
}


@pytest.mark.parametrize("kind", sorted(DDPG_CASES))
def test_ddpg_td3_learn_on_batch_matches_jax(kind):
    """DDPG: two updates, the actor stepping on each.  TD3: three, the
    actor stepping on the second only (the host's delay counter), the
    targets moving on each; the smoothing noise's clip bites."""
    cfg = dict(DDPG_CASES[kind], tau=0.1, actor_lr=1e-3, critic_lr=2e-3)
    jp, tp = _ddpg_pair(**cfg)
    batch = _cont_batch(32, weights=kind.endswith("prioritized"))
    before = _ddpg_state(tp, False)
    calls = 3 if kind == "td3" else 2
    B = len(batch["obs"])
    for i in range(calls):
        before_actor = _np_sd(tp.actor)
        jstats, tstats = _learn_seeded(jp, tp, "ddpg", batch, 1, cfg)
        td = jstats.pop("_td_error_np")
        np.testing.assert_allclose(tstats.pop("_td_error_np"), td, rtol=0,
                                   atol=1e-5 * np.abs(td).max())
        stepped = any(not np.array_equal(v, before_actor[k])
                      for k, v in _np_sd(tp.actor).items())
        assert stepped == (kind != "td3" or i == 1), (kind, i)
        if kind == "td3" and i != 1:
            assert tstats["actor_loss"] == jstats["actor_loss"] == 0.0
        _hold_stats(jstats, tstats, ("critic_loss", "actor_loss",
                                     "mean_q_target"))
    if kind == "td3":
        eps = 0.3 * _jax_noise(jp._rng, "ddpg", B, cfg)["target"].numpy()
        assert (np.abs(eps) > 0.5).any()
    for what, b, w, g in zip(("actor", "critic", "target_actor",
                              "target_critic"), before,
                             _ddpg_state(jp, True), _ddpg_state(tp, False)):
        _hold_moves(b, w, g, what)


# -- checkpoints -------------------------------------------------------------------

def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_trees_equal(x, y, f"{path}/{i}")
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


def _discrete(tcls, **cfg):
    return tcls(Box(-1.0, 1.0, (OBS_DIM,)), Discrete(ACTIONS),
                {"seed": 0, "_device": "cpu", "model": MODEL, **cfg})


def _continuous(tcls, **cfg):
    return tcls(Box(-1.0, 1.0, (C_OBS,)), Box(C_LOW, C_HIGH, (C_ACT,)),
                {"seed": 0, "_device": "cpu", **cfg})


STATE_CASES = {
    "dqn": (lambda s: _discrete(dqn.DQNPolicy, seed=s),
            lambda p: p.learn_on_batch(SampleBatch(_dqn_batch(16)))),
    "r2d2": (lambda s: r2d2.R2D2Policy(
        Box(-1.0, 1.0, (OBS_DIM,)), Discrete(ACTIONS),
        {"seed": s, "_device": "cpu", "model": R2D2_MODEL}),
        lambda p: p.learn_on_sequences(_sequences())),
    "sac": (lambda s: _continuous(sac.SACPolicy, seed=s),
            lambda p: p.learn_on_batch(SampleBatch(_cont_batch(16)))),
    "cql": (lambda s: _continuous(cql.CQLPolicy, seed=s),
            lambda p: p.learn_on_batch(SampleBatch(_cont_batch(16)))),
    "td3": (lambda s: _continuous(ddpg.DDPGPolicy, seed=s, twin_q=True,
                                  policy_delay=2,
                                  smooth_target_policy=True),
            lambda p: p.learn_on_batch(SampleBatch(_cont_batch(16)))),
}


@pytest.mark.parametrize("kind", sorted(STATE_CASES))
def test_state_round_trip_with_targets_and_moments(kind):
    """get_state after two updates (Adam moments, target networks,
    log_alpha, counters) restores into a policy of another seed, which
    then takes the same next update."""
    make, learn = STATE_CASES[kind]
    a = make(0)
    learn(a)
    if hasattr(a, "update_target"):
        a.update_target()
    learn(a)
    state = a.get_state()
    b = make(7)
    b.set_state(copy.deepcopy(state))
    _assert_trees_equal(b.get_state(), state)
    for p in (a, b):  # the same next draws on both
        p._gen = torch.Generator().manual_seed(3)
        p._np_rng = np.random.default_rng(3)
    learn(a)
    learn(b)
    _assert_trees_equal(b.get_state(), a.get_state())
