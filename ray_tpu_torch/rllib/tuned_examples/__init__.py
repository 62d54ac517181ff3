"""Regression configs (parity: reference ``rllib/tuned_examples/`` — the
yaml files driven nightly by release/rllib_tests).  Each yaml names an
algorithm, an env, a config dict, and a pass criterion; ``load`` builds
the Algorithm and ``run`` trains until the criterion or the iteration
budget.  The learner runs on the card, as every algorithm's does by
default, unless ``device="cpu"`` names the CPU.

Yaml schema::

    run: PPO                    # algorithm name (see _algo_config)
    env: CartPole-v1            # registered env name
    env_config: {...}           # optional env kwargs
    seed: 0                     # optional; wired to config.debugging
    config: {...}               # attribute overrides on the config
    offline_input:              # optional; offline algos (BC/CQL/DT...)
      env: CartPole-v1          #   behaviour-data env
      num_steps: 4000           #   dataset size
      seed: 0
    stop:                       # pass criteria (any may be combined)
      episode_reward_mean: 120  #   pass when reward >= threshold
      metric_below: {td_loss: 1.0}   # pass when result[k] <= v (all)
      metric_decreases: [policy_loss]  # pass when last < first (all)
      training_iteration: 40    #   iteration budget
"""

from __future__ import annotations

import glob
import os
import tempfile
from typing import Any, Dict, List, Optional

import yaml

_DIR = os.path.dirname(__file__)

# generated offline datasets, keyed by (env, num_steps, seed)
_OFFLINE_CACHE: Dict[tuple, str] = {}


def _registry() -> Dict[str, Any]:
    from ray_tpu_torch.rllib import algorithms as algos

    return {
        "PPO": algos.PPOConfig, "APPO": algos.APPOConfig,
        "IMPALA": algos.ImpalaConfig, "DQN": algos.DQNConfig,
        "SimpleQ": algos.SimpleQConfig,
        "ApexDQN": algos.ApexDQNConfig, "SAC": algos.SACConfig,
        "DDPG": algos.DDPGConfig, "TD3": algos.TD3Config,
        "ApexDDPG": algos.ApexDDPGConfig,
        "PG": algos.PGConfig, "A2C": algos.A2CConfig,
        "A3C": algos.A3CConfig, "R2D2": algos.R2D2Config,
        "BC": algos.BCConfig, "MARWIL": algos.MARWILConfig,
        "CQL": algos.CQLConfig, "CRR": algos.CRRConfig,
        "ES": algos.ESConfig, "ARS": algos.ARSConfig,
        "BanditLinUCB": algos.BanditLinUCBConfig,
        "BanditLinTS": algos.BanditLinTSConfig,
        "AlphaStar": algos.AlphaStarConfig, "MAML": algos.MAMLConfig,
        "MBMPO": algos.MBMPOConfig, "DT": algos.DTConfig,
        "AlphaZero": algos.AlphaZeroConfig, "SlateQ": algos.SlateQConfig,
        "DDPPO": algos.DDPPOConfig, "QMIX": algos.QMixConfig,
        "MADDPG": algos.MADDPGConfig, "Dreamer": algos.DreamerConfig,
    }


def _algo_config(name: str):
    return _registry()[name]()


def algo_names() -> List[str]:
    """Every algorithm name runnable from a tuned-example yaml."""
    return sorted(_registry())


def list_examples() -> List[str]:
    return sorted(glob.glob(os.path.join(_DIR, "*.yaml")))


def _offline_dataset(spec: Dict[str, Any]) -> str:
    """Generate (once per process) the behaviour dataset an offline
    example asks for."""
    from ray_tpu_torch.rllib.offline import collect_offline_dataset

    env = spec["env"]
    num_steps = int(spec.get("num_steps", 4000))
    seed = int(spec.get("seed", 0))
    key = (env, num_steps, seed)
    if key not in _OFFLINE_CACHE:
        path = os.path.join(
            tempfile.mkdtemp(prefix="tuned_offline_"),
            f"{env}-{num_steps}-{seed}")
        collect_offline_dataset(env, path, num_steps=num_steps, seed=seed)
        _OFFLINE_CACHE[key] = path
    return _OFFLINE_CACHE[key]


def load(path: str, device: Optional[str] = None):
    """Build (algorithm, spec) from a tuned-example yaml, the learner on
    the card (``device`` None or "cuda") or on the CPU ("cpu")."""
    if device not in (None, "cuda", "cpu"):
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    with open(path) as f:
        spec = yaml.safe_load(f)
    config = _algo_config(spec["run"])
    config.environment(spec["env"],
                       env_config=spec.get("env_config") or {})
    if spec.get("offline_input"):
        config.input_ = _offline_dataset(spec["offline_input"])
    for key, value in (spec.get("config") or {}).items():
        setattr(config, key, value)
    if device == "cpu":
        config.resources(num_gpus_per_learner=0)
    if spec.get("seed") is not None:
        config.debugging(seed=int(spec["seed"]))
    return config.build(), spec


def _criteria_met(stop: Dict[str, Any], result: Dict[str, Any],
                  first: Dict[str, Any]) -> bool:
    """True when every configured criterion holds on ``result``."""
    checked = False
    target = stop.get("episode_reward_mean")
    if target is not None:
        checked = True
        rm = result.get("episode_reward_mean")
        if rm is None or rm != rm or rm < target:
            return False
    for key, ceil in (stop.get("metric_below") or {}).items():
        checked = True
        val = result.get(key)
        if val is None or val != val or val > ceil:
            return False
    for key, floor in (stop.get("metric_above") or {}).items():
        checked = True
        val = result.get(key)
        if val is None or val != val or val < floor:
            return False
    for key in (stop.get("metric_decreases") or []):
        checked = True
        val, ref = result.get(key), first.get(key)
        if val is None or ref is None or not (val == val and val < ref):
            return False
    return checked


def run(path: str, max_iters: Optional[int] = None,
        device: Optional[str] = None) -> Dict[str, Any]:
    """Train until the yaml's stop criteria; returns the last result
    plus ``passed``."""
    algo, spec = load(path, device)
    stop = spec.get("stop") or {}
    has_criteria = any(k in stop for k in
                       ("episode_reward_mean", "metric_below",
                        "metric_above", "metric_decreases"))
    iters = int(max_iters or stop.get("training_iteration", 50))
    result: Dict[str, Any] = {}
    first: Dict[str, Any] = {}
    passed = not has_criteria
    try:
        for i in range(iters):
            result = algo.train()
            if i == 0:
                first = dict(result)
            if has_criteria and _criteria_met(stop, result, first):
                passed = True
                break
    finally:
        algo.stop()
    result["passed"] = passed
    return result
