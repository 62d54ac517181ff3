"""Algorithm: the trainable driver object.

Parity: reference ``rllib/algorithms/algorithm.py`` (``Algorithm``:142,
``setup``:473, ``training_step``:1284) — owns the WorkerSet, runs
``training_step`` per ``train()`` call, aggregates episode metrics with
a smoothing window, checkpoints, and plugs into Tune as a trainable
(``tune.run(PPO, config=...)`` works because ``train()``/``save``/
``restore`` follow the trainable protocol).
"""

from __future__ import annotations

import os
import pickle
import time
from collections import deque
from typing import Any, Dict, Optional, Union

import numpy as np

from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.worker_set import WorkerSet


class Algorithm:
    #: overridden by subclasses
    policy_class: Optional[type] = None
    #: set True by algorithms whose training_step handles MultiAgentBatch
    supports_multi_agent: bool = False

    def __init__(self, config: Union[AlgorithmConfig, Dict[str, Any]],
                 env: Any = None, **kwargs):
        if isinstance(config, AlgorithmConfig):
            self.config = config.to_dict()
        else:
            self.config = dict(config)
        if env is not None:
            self.config["env"] = env
        if self.config.get("env") is None:
            raise ValueError("no environment specified")
        self.iteration = 0
        self._timesteps_total = 0
        self._episode_returns: deque = deque(maxlen=100)
        self._episode_lens: deque = deque(maxlen=100)
        self._start = time.time()
        self.setup()

    # ------------------------------------------------------------------
    def setup(self) -> None:
        if self.config.get("policies") and not self.supports_multi_agent:
            raise ValueError(
                f"{type(self).__name__} does not support multi-agent "
                f"training (its training_step consumes plain "
                f"SampleBatches); use PPO, or drop .multi_agent(...)")
        self.workers = WorkerSet(self.config["env"], self.policy_class,
                                 self.config)
        self.workers.sync_weights()

    def get_policy(self, policy_id: Optional[str] = None):
        worker = self.workers.local_worker
        if policy_id is not None:
            return worker.policy_map[policy_id]
        if len(worker.policy_map) > 1:
            raise ValueError(
                f"multiple policies {sorted(worker.policy_map)}: "
                f"get_policy(policy_id=...) must name one")
        return worker.policy

    def _collect_metrics(self):
        """Episode stats from the fleet; async algorithms override to use
        stats piggybacked on sample results instead of extra actor calls
        (which would queue behind in-flight sampling)."""
        return self.workers.foreach_worker(lambda w: w.metrics())

    # ------------------------------------------------------------------
    def training_step(self) -> Dict[str, Any]:
        raise NotImplementedError

    def train(self) -> Dict[str, Any]:
        """One iteration: training_step + metric aggregation."""
        if self.config.get("recreate_failed_workers"):
            self.workers.probe_and_recreate()
        t0 = time.time()
        result = self.training_step()
        episodes_this_iter = 0
        for m in self._collect_metrics():
            self._episode_returns.extend(m["episode_returns"])
            self._episode_lens.extend(m["episode_lens"])
            episodes_this_iter += len(m["episode_returns"])
        self.iteration += 1
        result.update({
            "training_iteration": self.iteration,
            "timesteps_total": self._timesteps_total,
            "episode_reward_mean":
                float(np.mean(self._episode_returns))
                if self._episode_returns else np.nan,
            "episode_len_mean":
                float(np.mean(self._episode_lens))
                if self._episode_lens else np.nan,
            "episodes_this_iter": episodes_this_iter,
            "time_this_iter_s": time.time() - t0,
            "time_total_s": time.time() - self._start,
        })
        interval = self.config.get("evaluation_interval")
        if interval and self.iteration % interval == 0:
            result["evaluation"] = self.evaluate()
        return result

    def evaluate(self) -> Dict[str, Any]:
        """Greedy-policy episodes on a fresh env (reference
        ``Algorithm.evaluate``)."""
        from ray_tpu_torch.rllib.env import MultiAgentEnv, make_env
        env = make_env(self.config["env"],
                       dict(self.config.get("env_config", {})))
        if isinstance(env, MultiAgentEnv):
            return self._evaluate_multi_agent(env)
        policy = self.get_policy()
        returns = []
        for _ in range(int(self.config.get("evaluation_duration", 10))):
            obs, _ = env.reset()
            done, total = False, 0.0
            while not done:
                action, _ = policy.compute_actions(obs[None], explore=False)
                obs, rew, term, trunc, _ = env.step(np.asarray(action)[0])
                total += rew
                done = term or trunc
            returns.append(total)
        return {"episode_reward_mean": float(np.mean(returns)),
                "episode_reward_min": float(np.min(returns)),
                "episode_reward_max": float(np.max(returns))}

    def _evaluate_multi_agent(self, env) -> Dict[str, Any]:
        worker = self.workers.local_worker
        mapping = worker.policy_mapping_fn
        returns = []
        for _ in range(int(self.config.get("evaluation_duration", 10))):
            obs, _ = env.reset()
            total, done, steps = 0.0, False, 0
            while not done and steps < 10_000:
                actions = {}
                for a, o in obs.items():
                    act, _ = worker.policy_map[mapping(a)].compute_actions(
                        np.asarray(o)[None], explore=False)
                    actions[a] = np.asarray(act)[0]
                obs, rew, term, trunc, _ = env.step(actions)
                total += float(sum(rew.values()))
                obs = {a: o for a, o in obs.items()
                       if not (term.get(a, False) or trunc.get(a, False))}
                done = term.get("__all__") or trunc.get("__all__")
                steps += 1
            returns.append(total)
        return {"episode_reward_mean": float(np.mean(returns)),
                "episode_reward_min": float(np.min(returns)),
                "episode_reward_max": float(np.max(returns))}

    def compute_single_action(self, obs: np.ndarray, explore: bool = False):
        action, _ = self.get_policy().compute_actions(
            np.asarray(obs)[None], explore=explore)
        return np.asarray(action)[0]

    # -- checkpointing (trainable protocol) -----------------------------
    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "wb") as f:
            worker = self.workers.local_worker
            pickle.dump({
                "policy_state": self.get_policy().get_state()
                if not worker.policy_map else None,
                "policy_map_state": {
                    pid: p.get_state()
                    for pid, p in worker.policy_map.items()},
                "iteration": self.iteration,
                "timesteps_total": self._timesteps_total,
                "config": {k: v for k, v in self.config.items()
                           if isinstance(v, (int, float, str, bool, list,
                                             dict, tuple, type(None)))},
            }, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "rb") as f:
            state = pickle.load(f)
        for pid, ps in state.get("policy_map_state", {}).items():
            self.get_policy(pid).set_state(ps)
        if state.get("policy_state") is not None:
            self.get_policy().set_state(state["policy_state"])
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]
        self.workers.sync_weights()

    def stop(self) -> None:
        self.workers.stop()
