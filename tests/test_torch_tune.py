"""The port's Tune (``ray_tpu_torch.tune``) on the CPU: counterparts of
tests/test_tune.py's cases (the orbax bridge is JAX-only), the BayesOpt
cases of tests/test_air_extras.py and a resume after the head's death;
the searchers, schedulers and stoppers of both packages driven through
one stub runner on the same seeds and result streams (equal output);
and a tiny GPT-2 trained in Tune trials against the same steps in
JAX/optax.  One port cluster for the file; every wait is bounded."""

import math
import os
import random
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import ray_tpu_torch as rt
from ray_tpu import tune as jtune
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu.tune import bohb as jbohb
from ray_tpu.tune import schedulers as jsched
from ray_tpu.tune import stopper as jstop
from ray_tpu.tune import trial as jtrial
from ray_tpu_torch import tune
from ray_tpu_torch.air import storage
from ray_tpu_torch.models.convert import gpt2_state_dict_from_jax
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import FailureConfig, RunConfig
from ray_tpu_torch.tune import bohb as tbohb
from ray_tpu_torch.tune import schedulers as tsched
from ray_tpu_torch.tune import stopper as tstop
from ray_tpu_torch.tune import trial as ttrial

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def cluster():
    rt.init(num_cpus=4, num_gpus=0, object_store_memory=256 * 2**20)
    yield
    rt.shutdown()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread for this module's torch work, as the other
    parity modules do under the suite's ``-n 6``."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- tests/test_tune.py's cases on the port ---------------------------------

def _scorer():
    """A trainable made in a function, so that it pickles by value: a
    module-level one would make each trial's worker import this file,
    and JAX with it."""
    def trainable(config):
        score = config["a"] * 10 + config.get("b", 0)
        for i in range(3):
            tune.report({"score": score + i})
    return trainable


def test_grid_search_runs_all():
    results = tune.run(
        _scorer(),
        config={"a": tune.grid_search([1, 2, 3]), "b": 5},
        metric="score", mode="max")
    assert len(results) == 3
    best = results.get_best_result()
    assert best.config["a"] == 3
    assert best.metrics["score"] == 37  # 3*10+5+2


def test_random_search_num_samples():
    results = tune.run(
        _scorer(),
        config={"a": tune.uniform(0, 1), "b": tune.randint(0, 10)},
        num_samples=4, metric="score", mode="max")
    assert len(results) == 4
    assert not results.errors
    configs = {(r.config["a"], r.config["b"]) for r in
               (results[i] for i in range(4))}
    assert len(configs) > 1


def test_asha_stops_bad_trials():
    def trainable(config):
        for i in range(20):
            tune.report({"loss": config["lr"] * (20 - i)})

    sched = tune.AsyncHyperBandScheduler(
        metric="loss", mode="min", max_t=20, grace_period=2,
        reduction_factor=2)
    results = tune.run(
        trainable, config={"lr": tune.grid_search([1.0, 2.0, 4.0, 8.0])},
        scheduler=sched, metric="loss", mode="min")
    iters = [results[i].metrics.get("training_iteration", 0)
             for i in range(len(results))]
    assert max(iters) == 20
    assert min(iters) < 20


def test_checkpoint_and_failure_recovery():
    def flaky(config):
        ckpt = tune.get_checkpoint()
        start = ckpt.to_dict()["step"] if ckpt else 0
        for step in range(start, 6):
            tune.report({"step_metric": step},
                        checkpoint=Checkpoint.from_dict({"step": step + 1}))
            if step == 2 and ckpt is None:
                raise RuntimeError("injected failure")

    tuner = tune.Tuner(
        flaky, param_space={},
        tune_config=tune.TuneConfig(metric="step_metric", mode="max"),
        run_config=RunConfig(failure_config=FailureConfig(max_failures=2)))
    results = tuner.fit()
    assert not results.errors
    assert results[0].metrics["step_metric"] == 5
    assert results[0].checkpoint.to_dict()["step"] == 6


def test_pbt_exploits():
    def trainable(config):
        ckpt = tune.get_checkpoint()
        state = ckpt.to_dict() if ckpt else {"acc": 0.0}
        acc = state["acc"]
        for _ in range(30):
            acc += config["lr"]
            tune.report({"acc": acc},
                        checkpoint=Checkpoint.from_dict({"acc": acc}))

    sched = tune.PopulationBasedTraining(
        metric="acc", mode="max", perturbation_interval=5,
        hyperparam_mutations={"lr": tune.uniform(0.1, 1.0)}, seed=0)
    results = tune.run(
        trainable, config={"lr": tune.grid_search([0.01, 0.5])},
        scheduler=sched, metric="acc", mode="max")
    assert results.get_best_result().metrics["acc"] > 1.0


def test_search_space_primitives():
    gen = tune.BasicVariantGenerator(seed=1)
    cfgs = gen.generate({
        "g": tune.grid_search(["x", "y"]),
        "u": tune.uniform(0, 1),
        "l": tune.loguniform(1e-4, 1e-1),
        "c": tune.choice([1, 2, 3]),
        "q": tune.quniform(0, 10, 2),
        "nested": {"r": tune.randint(5, 9)},
        "fixed": 42,
    }, num_samples=2)
    assert len(cfgs) == 4
    for c in cfgs:
        assert c["g"] in ("x", "y")
        assert 0 <= c["u"] <= 1
        assert 1e-4 <= c["l"] <= 1e-1
        assert c["c"] in (1, 2, 3)
        assert c["q"] % 2 == 0
        assert 5 <= c["nested"]["r"] < 9
        assert c["fixed"] == 42


def test_result_grid_dataframe():
    results = tune.run(_scorer(),
                       config={"a": tune.grid_search([1, 2])},
                       metric="score", mode="max")
    df = results.get_dataframe()
    assert len(df) == 2
    assert "config/a" in df.columns


def test_hyperband_sync_promotes_best():
    def trainable(config):
        ckpt = tune.get_checkpoint()
        start = ckpt.to_dict()["iter"] if ckpt is not None else 0
        for i in range(start, 12):
            tune.report({"score": config["q"] * (i + 1),
                         "training_iteration": i + 1},
                        checkpoint=Checkpoint.from_dict({"iter": i + 1}))

    sched = tune.HyperBandScheduler(
        metric="score", mode="max", max_t=12, grace_period=2,
        reduction_factor=3)
    results = tune.run(
        trainable, config={"q": tune.grid_search([1.0, 2.0, 3.0, 4.0])},
        scheduler=sched, metric="score", mode="max")
    iters = sorted(results[i].metrics.get("training_iteration", 0)
                   for i in range(len(results)))
    assert iters[0] == 2
    assert iters[-1] == 12
    assert results.get_best_result().config["q"] == 4.0


def test_tpe_search_converges_better_than_random():
    space = {"x": tune.uniform(-4, 4)}
    searcher = tune.TPESearch(space, metric="loss", mode="min",
                              n_initial_points=6, seed=0)
    history = []
    for i in range(40):
        cfg = searcher.suggest(f"t{i}")
        loss = (cfg["x"] - 1.0) ** 2
        history.append(loss)
        searcher.on_trial_complete(f"t{i}", {"loss": loss})
    assert min(history[20:]) < 0.1
    assert sum(history[-10:]) < sum(history[:10])


def test_tpe_with_tuner():
    def trainable(config):
        tune.report({"loss": (config["x"] - 2.0) ** 2})

    space = {"x": tune.uniform(0, 4)}
    results = tune.Tuner(
        trainable, param_space=space,
        tune_config=tune.TuneConfig(
            metric="loss", mode="min", num_samples=12,
            max_concurrent_trials=4,
            search_alg=tune.TPESearch(space, metric="loss", mode="min",
                                      n_initial_points=5, seed=0))).fit()
    assert len(results) == 12
    assert results.get_best_result().metrics["loss"] < 0.5


def test_gated_searchers_raise_with_guidance():
    with pytest.raises(ImportError, match="optuna"):
        tune.OptunaSearch()
    with pytest.raises(ImportError, match="hyperopt"):
        tune.HyperOptSearch()


def test_bohb_converges_and_uses_rung_observations():
    def trainable(config):
        for i in range(9):
            noise = 2.0 / (i + 1)
            tune.report({"loss": (config["x"] - 2.0) ** 2 + noise,
                         "training_iteration": i + 1})

    space = {"x": tune.uniform(0, 4)}
    searcher = tune.BOHBSearcher(space, metric="loss", mode="min",
                                 min_points_in_model=4, seed=0)
    sched = tune.HyperBandForBOHB(searcher, metric="loss", mode="min",
                                  max_t=9, grace_period=1,
                                  reduction_factor=3)
    results = tune.Tuner(
        trainable, param_space=space,
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    num_samples=12, search_alg=searcher,
                                    max_concurrent_trials=6,
                                    scheduler=sched)).fit()
    assert results.get_best_result().metrics["loss"] < 1.0
    assert sum(len(v) for v in searcher._obs.values()) > 10


def test_logger_callbacks_and_stopper(tmp_path):
    import json

    def trainable(config):
        for i in range(50):
            tune.report(score=i * config["lr"], training_iteration=i + 1)

    grid = tune.Tuner(trainable,
                      param_space={"lr": tune.grid_search([1.0, 2.0])},
                      tune_config=tune.TuneConfig(metric="score", mode="max"),
                      run_config=RunConfig(local_dir=str(tmp_path),
                                           stop={"score": 4.0})).fit()
    assert len(grid) == 2
    for result in grid:
        assert result.metrics["score"] >= 4.0
        assert result.metrics["training_iteration"] <= 10
    trial_dirs = [d for d in tmp_path.iterdir() if d.is_dir()]
    assert len(trial_dirs) == 2
    for d in trial_dirs:
        assert (d / "progress.csv").read_text().count("\n") >= 2
        lines = (d / "result.json").read_text().strip().splitlines()
        assert json.loads(lines[-1])["score"] >= 4.0
        assert "lr" in json.loads((d / "params.json").read_text())


def test_plateau_and_custom_stoppers():
    def flat(config):
        for i in range(60):
            tune.report(loss=1.0 if i > 3 else 10.0 - i,
                        training_iteration=i + 1)

    stopper = tune.TrialPlateauStopper("loss", std=0.001, num_results=3,
                                       grace_period=3)
    grid = tune.Tuner(flat, param_space={},
                      tune_config=tune.TuneConfig(metric="loss", mode="min"),
                      run_config=RunConfig(stop=stopper)).fit()
    assert grid[0].metrics["training_iteration"] < 20


def test_cli_reporter_output():
    import io

    from ray_tpu_torch.tune.progress_reporter import CLIReporter

    out = io.StringIO()
    reporter = CLIReporter(max_report_frequency=0.0, out=out)
    trials = [tune.Trial({"lr": 0.1}, "t1"), tune.Trial({"lr": 0.2}, "t2")]
    trials[0].status = "RUNNING"
    trials[0].last_result = {"training_iteration": 3, "score": 1.5}
    reporter.report(trials)
    text = out.getvalue()
    assert "RUNNING" in text and "t1" in text and "1.5" in text


def test_public_names_match_the_jax_package():
    want = {n for n in dir(jtune) if not n.startswith("_")}
    got = {n for n in dir(tune) if not n.startswith("_")}
    assert want <= got, sorted(want - got)


def test_tpu_resources_are_refused():
    with pytest.raises(TypeError, match='"GPU"'):
        tune.Tuner(_scorer(), resources_per_trial={"TPU": 1, "CPU": 1})
    with pytest.raises(TypeError, match='"GPU"'):
        tune.run(_scorer(), config={"a": 1},
                 resources_per_trial={"TPU": 0.5})


# --- tests/test_air_extras.py's BayesOpt cases ------------------------------

def test_bayesopt_search_converges_better_than_random():
    space = {"x": tune.uniform(0.0, 1.0)}
    searcher = tune.BayesOptSearch(space, metric="score", mode="max",
                                   n_initial_points=4, seed=0)
    xs = []
    for i in range(16):
        cfg = searcher.suggest(f"t{i}")
        searcher.on_trial_complete(f"t{i}", {"score": -(cfg["x"] - 0.7) ** 2})
        xs.append(cfg["x"])
    assert np.mean([abs(x - 0.7) for x in xs[10:]]) < 0.2, xs


def test_bayesopt_with_tuner():
    space = {"lr": tune.loguniform(1e-4, 1e-1)}

    def objective(config):
        tune.report(loss=(math.log10(config["lr"]) + 2.5) ** 2)

    results = tune.run(
        objective, config=space, num_samples=6, metric="loss", mode="min",
        search_alg=tune.BayesOptSearch(space, metric="loss", mode="min",
                                       n_initial_points=3, seed=1))
    assert results.get_best_result().metrics["loss"] < 2.0


# --- tests/test_storage_sync.py's resume after the head's death -------------

_HEAD_SCRIPT = """
import sys, time
sys.path.insert(0, {repo!r})
import ray_tpu_torch as rt
from ray_tpu_torch import tune
from ray_tpu_torch.train.config import RunConfig
from ray_tpu_torch.train.checkpoint import Checkpoint

rt.init(num_cpus=2, num_gpus=0)

def trainable(config):
    ckpt = tune.get_checkpoint()
    start = ckpt.to_dict()["iter"] if ckpt is not None else 0
    for i in range(start + 1, 11):
        tune.report({{"iter": i, "mark": config["mark"]}},
                    checkpoint=Checkpoint.from_dict({{"iter": i}}))
        time.sleep(0.35)

tune.Tuner(
    trainable,
    param_space={{"mark": tune.grid_search([1, 2])}},
    tune_config=tune.TuneConfig(metric="iter", mode="max"),
    run_config=RunConfig(name="exp", storage_path={uri!r})).fit()
print("FINISHED-UNEXPECTEDLY")
"""


def test_tuner_restore_after_head_kill(tmp_path):
    """Kill -9 a driver's whole cluster mid-experiment; this process's
    cluster resumes every trial from its last synced checkpoint."""
    import pickle

    uri = f"file://{tmp_path}/durable"
    proc = subprocess.Popen(
        [sys.executable, "-c", _HEAD_SCRIPT.format(repo=ROOT, uri=uri)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)
    try:
        state_uri = f"{uri}/exp/experiment_state.pkl"
        deadline = time.monotonic() + 120
        seen_progress = False
        while time.monotonic() < deadline and proc.poll() is None:
            if storage.exists(state_uri):
                state = pickle.loads(storage.read_bytes(state_uri))
                iters = [t["last_result"].get("iter", 0)
                         for t in state["trials"]]
                if all(3 <= i < 10 for i in iters):
                    seen_progress = True
                    break
            time.sleep(0.2)
    finally:
        # the driver and its head, raylet and workers: one session
        os.killpg(proc.pid, signal.SIGKILL)
        out = proc.communicate(timeout=30)[0]
    assert seen_progress, out[-3000:]

    resumed_from = []

    def trainable(config):
        ckpt = tune.get_checkpoint()
        start = ckpt.to_dict()["iter"] if ckpt is not None else 0
        resumed_from.append(start)
        for i in range(start + 1, 11):
            tune.report({"iter": i, "mark": config["mark"],
                         "resumed_from": start},
                        checkpoint=Checkpoint.from_dict({"iter": i}))

    grid = tune.Tuner.restore(f"{uri}/exp", trainable).fit()
    assert len(grid) == 2
    for i in range(2):
        assert grid[i].metrics["iter"] == 10
        assert grid[i].metrics["resumed_from"] >= 3


# --- decisions: both packages through one stub runner -----------------------

class _StubRunner:
    """The runner's side of the scheduler protocol, recording each call
    (trial ids, configs) so that two packages' runs can be compared."""

    def __init__(self, trial_mod, configs, ids):
        self.trials = [trial_mod.Trial(config=dict(c), trial_id=i)
                       for i, c in zip(ids, configs)]
        self.calls = []
        self._exploit = None

    def get_trial(self, trial_id):
        return next((t for t in self.trials if t.trial_id == trial_id), None)

    def exploit_trial(self, trial, donor, new_config):
        self.calls.append(("exploit", trial.trial_id, donor.trial_id,
                           sorted(new_config.items())))
        self._exploit = (trial.trial_id, donor.trial_id, new_config)

    def requeue_trial(self, trial):
        self.calls.append(("requeue", trial.trial_id))
        if trial.status == "PAUSED":
            trial.status = "PENDING"


def _drive(sched, trial_mod, configs, curve, rounds=40, ids=None):
    """Round-robin: each live trial reports its next iteration (metric
    ``curve(state, config, t)``); STOP ends it, PAUSE parks it until the
    scheduler requeues it, an exploit copies the donor's state and
    config.  Returns every decision, the runner's calls and the final
    statuses."""
    runner = _StubRunner(trial_mod, configs,
                         ids or [f"t{i}" for i in range(len(configs))])
    state = {t.trial_id: {"x": 0.0, "t": 0} for t in runner.trials}
    log = []
    for _ in range(rounds):
        live = [t for t in runner.trials if t.status in ("PENDING",
                                                         "RUNNING")]
        if not live:
            break
        for trial in live:
            trial.status = "RUNNING"
            st = state[trial.trial_id]
            st["t"] += 1
            st["x"] = curve(st["x"], trial.config, st["t"])
            result = {"m": st["x"], "training_iteration": st["t"]}
            trial.last_result = result
            trial.results.append(result)
            runner._exploit = None
            d = sched.on_trial_result(runner, trial, result)
            log.append((trial.trial_id, st["t"], d))
            if runner._exploit is not None:
                tid, donor, cfg = runner._exploit
                trial.config = cfg
                state[tid] = dict(state[donor])
                trial.status = "PENDING"
            elif d == "STOP":
                trial.status = "TERMINATED"
                sched.on_trial_complete(runner, trial, result)
            elif d == "PAUSE":
                trial.status = "PAUSED"
                sched.on_trial_paused(runner, trial)
    return log, runner.calls, [(t.trial_id, t.status) for t in runner.trials]


_CONFIGS = [{"lr": v} for v in (0.3, 1.0, 0.1, 0.7, 0.5, 0.2, 0.9, 0.4)]


def _noisy_curve(seed):
    draws = random.Random(seed)
    table = [draws.gauss(0, 0.05) for _ in range(4096)]
    it = iter(table)

    def curve(x, config, t):
        return x + config["lr"] / t + next(it)
    return curve


@pytest.mark.parametrize("name", ["asha", "median", "hyperband", "pbt",
                                  "fifo"])
def test_scheduler_decisions_equal(name):
    def make(sched_mod):
        if name == "asha":
            return sched_mod.AsyncHyperBandScheduler(
                metric="m", mode="max", max_t=12, grace_period=1,
                reduction_factor=2)
        if name == "median":
            return sched_mod.MedianStoppingRule(
                metric="m", mode="min", grace_period=2,
                min_samples_required=2)
        if name == "hyperband":
            return sched_mod.HyperBandScheduler(
                metric="m", mode="max", max_t=9, grace_period=1,
                reduction_factor=3)
        if name == "pbt":
            return sched_mod.PopulationBasedTraining(
                metric="m", mode="max", perturbation_interval=2,
                hyperparam_mutations={"lr": [0.1, 0.5, 1.0],
                                      "wd": jtune.uniform(0.0, 1.0)
                                      if sched_mod is jsched
                                      else tune.uniform(0.0, 1.0)},
                quantile_fraction=0.25, seed=3)
        return sched_mod.FIFOScheduler()

    rounds = 12 if name == "pbt" else 40
    want = _drive(make(jsched), jtrial, _CONFIGS, _noisy_curve(1), rounds)
    got = _drive(make(tsched), ttrial, _CONFIGS, _noisy_curve(1), rounds)
    assert got == want
    decisions = {d for _, _, d in want[0]}
    if name in ("asha", "median"):
        assert "STOP" in decisions
    if name == "hyperband":
        assert "PAUSE" in decisions and want[1]
    if name == "pbt":
        assert any(c[0] == "exploit" for c in want[1])


def test_bohb_scheduler_and_searcher_equal():
    space = {"x": jtune.uniform(0, 4), "k": jtune.choice([1, 2, 3])}
    tspace = {"x": tune.uniform(0, 4), "k": tune.choice([1, 2, 3])}

    def run(bohb_mod, trial_mod, space):
        searcher = bohb_mod.BOHBSearcher(space, metric="m", mode="max",
                                         min_points_in_model=3, seed=5)

        def curve(x, config, t):
            return -(config["x"] - 2.0) ** 2 - config["k"] / t

        suggestions, logs = [], []
        for wave in range(3):  # a wave of trials, as _fit_with_searcher
            sched = bohb_mod.HyperBandForBOHB(
                searcher, metric="m", mode="max", max_t=9, grace_period=1,
                reduction_factor=3)
            ids = [f"sugg_{wave}_{i}" for i in range(6)]
            configs = [searcher.suggest(sid) for sid in ids]
            suggestions += [sorted(c.items()) for c in configs]
            logs.append(_drive(sched, trial_mod, configs, curve, ids=ids))
            for sid, cfg in zip(ids, configs):
                searcher.on_trial_complete(
                    sid, {"m": curve(0, cfg, 9), "training_iteration": 9})
        return suggestions, logs, sorted(
            (b, sorted(map(tuple, (x + [s] for x, s in rows))))
            for b, rows in searcher._obs.items())

    want = run(jbohb, jtrial, space)
    got = run(tbohb, ttrial, tspace)
    assert got == want
    assert want[2], "the searcher saw no observation"


def _objective(cfg):
    x = cfg.get("x", 0.0)
    return -(x - 0.7) ** 2 + 0.1 * cfg.get("k", 1) + 0.01 * cfg.get("r", 0)


@pytest.mark.parametrize("searcher", ["tpe", "bayesopt", "bohb"])
def test_searcher_suggestions_equal(searcher):
    def make(mod):
        space = {"x": mod.uniform(0.0, 1.0),
                 "k": mod.choice([1, 2, 3]),
                 "r": mod.randint(0, 5),
                 "l": mod.loguniform(1e-4, 1e-1),
                 "q": mod.quniform(0, 10, 2), "fixed": 7}
        if searcher == "tpe":
            return mod.TPESearch(space, metric="y", mode="max",
                                 n_initial_points=5, seed=11)
        if searcher == "bayesopt":
            return mod.BayesOptSearch(space, metric="y", mode="max",
                                      n_initial_points=4, seed=11)
        return mod.BOHBSearcher(space, metric="y", mode="max",
                                min_points_in_model=4, seed=11)

    def run(s):
        out = []
        for i in range(14):
            cfg = s.suggest(f"t{i}")
            out.append(sorted(cfg.items()))
            if searcher == "bohb":
                s.observe(f"t{i}", _objective(cfg), budget=1.0)
            s.on_trial_complete(f"t{i}", {"y": _objective(cfg),
                                          "training_iteration": 3})
        return out

    assert run(make(tune)) == run(make(jtune))


def test_basic_variant_generator_equal():
    def space(mod):
        return {"g": mod.grid_search(["x", "y", "z"]),
                "u": mod.uniform(-1, 1), "l": mod.loguniform(1e-5, 1e-1),
                "c": mod.choice(["a", "b", "c", "d"]),
                "q": mod.quniform(0, 10, 0.5), "r": mod.randint(-3, 30),
                "nested": {"n": mod.uniform(0, 1),
                           "gg": mod.grid_search([1, 2, 3]),
                           "deep": {"c": mod.choice([4, 5])}},
                "fixed": [1, 2]}

    for seed in (0, 7):
        want = jtune.BasicVariantGenerator(seed=seed).generate(space(jtune), 3)
        got = tune.BasicVariantGenerator(seed=seed).generate(space(tune), 3)
        assert got == want
        assert len(got) == 9


def test_pbt_explore_equal():
    muts = {"lr": [1e-4, 3e-4, 1e-3], "wd": (0.0, 0.5), "n": 8}

    def run(mod, sched_mod):
        sched = sched_mod.PopulationBasedTraining(
            metric="m", hyperparam_mutations={
                "lr": muts["lr"], "wd": mod.uniform(*muts["wd"]),
                "n": lambda: muts["n"]},
            resample_probability=0.4, seed=0)
        out = []
        config = {"lr": 3e-4, "wd": 0.1, "n": 3, "other": "keep"}
        for i in range(40):
            config = sched._explore(dict(config))
            out.append(sorted(config.items()))
        out.append(sorted(sched._explore({"other": 1}).items()))
        return out

    assert run(tune, tsched) == run(jtune, jsched)


def test_stopper_verdicts_equal():
    def stoppers(mod):
        return [
            mod.MaximumIterationStopper(5),
            mod.FunctionStopper(lambda tid, r: r["m"] > 0.8),
            mod.TrialPlateauStopper("m", std=0.05, num_results=3,
                                    grace_period=3),
            mod.ExperimentPlateauStopper("m", mode="max", patience=2,
                                         top=3, std=0.2),
            mod.CombinedStopper(mod.MaximumIterationStopper(7),
                                mod.TrialPlateauStopper("m", std=0.01)),
            mod.resolve_stopper({"m": 0.9, "training_iteration": 6}),
            mod.TimeoutStopper(3600.0),
            mod.TimeoutStopper(0.0),
        ]

    draws = np.random.default_rng(4)
    stream = [(f"t{int(draws.integers(0, 3))}",
               {"m": float(draws.random()), "training_iteration": i + 1})
              for i in range(60)]
    stream.insert(10, ("t1", {"m": float("nan"), "training_iteration": 3}))

    def verdicts(mod):
        out = []
        for s in stoppers(mod):
            out.append([(s(tid, dict(r)), s.stop_all()) for tid, r in stream])
        return out

    want, got = verdicts(jstop), verdicts(tstop)
    assert got == want
    assert any(v for row in want for v, _ in row)


# --- the slice as a whole: a tiny GPT-2 in Tune trials against JAX/optax ----

_STEPS, _BATCH, _SEQ, _CHUNK = 3, 2, 40, 64
_LRS = (3e-4, 1e-3)


def _gpt2_trial():
    """The trial's trainable, made in a function so that it pickles by
    value."""
    def trainable(config):  # on the trial's worker
        import torch

        from ray_tpu_torch import tune as _tune
        from ray_tpu_torch.models import gpt2

        torch.set_num_threads(1)
        cfg = gpt2.GPT2Config.tiny(dtype=torch.float32)
        model = gpt2.GPT2(cfg, device="cpu")
        model.load_state_dict({k: torch.from_numpy(v)
                               for k, v in config["state"].items()})
        opt = gpt2.adamw(model.parameters(), lr=config["lr"],
                         weight_decay=0.01)
        for batch in config["batches"]:
            loss = gpt2.train_step(model, opt, torch.from_numpy(batch),
                                   head_chunk=config["chunk"])
            _tune.report({"loss": loss.item()})
    return trainable


def test_tiny_gpt2_trials_match_jax_optax(tmp_path):
    """GPT2Config.tiny in f32, flax weights converted by
    gpt2_state_dict_from_jax, 3 AdamW(lr, 0.01) steps for each lr of a
    grid, as two concurrent Tune trials under ASHA: every loss the trials
    report against the same steps in JAX/optax (f32 on both sides,
    summation order only; rtol 1e-5, as tests/test_torch_train.py)."""
    jcfg = jgpt2.GPT2Config.tiny(dtype=jnp.float32)
    jmodel = jgpt2.GPT2(jcfg)
    params = jax.jit(lambda key: jmodel.init_params(
        key, batch=1, seq=_SEQ))(jax.random.PRNGKey(0))
    params = jax.tree.map(lambda x: x.unbox() if hasattr(x, "unbox") else x,
                          params, is_leaf=lambda x: hasattr(x, "unbox"))
    rows = np.random.default_rng(0).integers(
        0, jcfg.vocab_size, (_STEPS * _BATCH, _SEQ)).astype(np.int64)
    batches = [rows[i * _BATCH:(i + 1) * _BATCH] for i in range(_STEPS)]
    tx = optax.inject_hyperparams(optax.adamw)(learning_rate=0.0,
                                               weight_decay=0.01)

    @jax.jit
    def step(p, opt_state, tokens):
        loss, grads = jax.value_and_grad(lambda q: jgpt2.loss_fn(
            jmodel, q, tokens, head_chunk=_CHUNK))(p)
        updates, opt_state = tx.update(grads, opt_state, p)
        return optax.apply_updates(p, updates), opt_state, loss

    want = {}
    for lr in _LRS:
        opt_state = tx.init(params)
        opt_state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        p, losses = params, []
        for b in batches:
            p, opt_state, loss = step(p, opt_state, jnp.asarray(b, jnp.int32))
            losses.append(float(loss))
        want[lr] = losses

    state = {k: np.asarray(v) for k, v in gpt2_state_dict_from_jax(
        jax.tree.map(np.asarray, params)).items()}
    sched = tune.AsyncHyperBandScheduler(
        metric="loss", mode="min", max_t=_STEPS, grace_period=_STEPS)
    grid = tune.Tuner(
        _gpt2_trial(),
        param_space={"lr": tune.grid_search(list(_LRS)), "state": state,
                     "batches": batches, "chunk": _CHUNK},
        tune_config=tune.TuneConfig(metric="loss", mode="min",
                                    scheduler=sched,
                                    max_concurrent_trials=2),
        run_config=RunConfig(local_dir=str(tmp_path))).fit()
    assert not grid.errors, grid.errors
    for i in range(len(grid)):
        r = grid[i]
        got = [h["loss"] for h in r.metrics_history]
        np.testing.assert_allclose(got, want[r.config["lr"]], rtol=1e-5)
    best = grid.get_best_result()
    assert best.config["lr"] == min(_LRS, key=lambda lr: min(want[lr]))
