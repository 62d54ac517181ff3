"""AlphaStar-style league-based self-play training.

Parity: reference ``rllib/algorithms/alpha_star/`` — a league of
learning and frozen historical policies (``league_builder.py:35``
``AlphaStarLeagueBuilder``): *main* agents train by self-play and
prioritized fictitious self-play (PFSP) against the league; *main
exploiters* attack the current main; *league exploiters* attack the
whole league; learners that get strong are snapshotted into the league
as frozen historical players, and matchmaking samples opponents from a
running payoff (win-rate) table.

Scoped design: the reference distributes the league over multi-GPU
tower actors with asynchronous inter-learner weight shipping; here each
learner is a PPO policy whose network, Adam moments and updates live on
the card (``num_gpus_per_learner=0`` names the CPU), as do the frozen
snapshots; matches are driven by the algorithm's own episode loop on a
two-player zero-sum env on the host, and the league bookkeeping (payoff
EMA, PFSP weights, snapshotting) follows the reference's league
builder.  Checkpoints hold every policy's state as numpy, so a league
saved on the card restores on the CPU and back.  The bundled
``RepeatedRPS`` env is the canonical non-transitive game where naive
self-play cycles and league training converges to the mixed Nash.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import (AlgorithmConfig,
                                                  learner_gpus)
from ray_tpu_torch.rllib.algorithms.ppo import PPOPolicy
from ray_tpu_torch.rllib.env import Box, Discrete, MultiAgentEnv, make_env
from ray_tpu_torch.rllib.sample_batch import SampleBatch, concat_samples


class RepeatedRPS(MultiAgentEnv):
    """Repeated rock-paper-scissors: ``rounds`` throws per episode, each
    player observes the one-hot of both players' previous throws.
    Zero-sum and non-transitive — any deterministic policy is beatable,
    so self-play alone cycles; a league forces the mixed Nash (uniform
    1/3).  Reference analog: ``rllib/examples/rock_paper_scissors_
    multiagent.py`` used by the league tests."""

    WIN = np.array([[0.0, -1.0, 1.0],
                    [1.0, 0.0, -1.0],
                    [-1.0, 1.0, 0.0]], np.float32)  # row beats col

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.rounds = int(config.get("rounds", 10))
        obs_space = Box(0.0, 1.0, (8,))
        self.observation_spaces = {0: obs_space, 1: obs_space}
        self.action_spaces = {0: Discrete(3), 1: Discrete(3)}

    def _obs(self, last: Optional[Tuple[int, int]]):
        def enc(mine, theirs):
            v = np.zeros(8, np.float32)
            if mine is None:
                v[6] = 1.0  # "no history yet" flag
            else:
                v[mine] = 1.0
                v[3 + theirs] = 1.0
            return v

        if last is None:
            return {0: enc(None, None), 1: enc(None, None)}
        a0, a1 = last
        return {0: enc(a0, a1), 1: enc(a1, a0)}

    def reset(self, *, seed: Optional[int] = None):
        self._round = 0
        return self._obs(None), {}

    def step(self, action_dict):
        a0, a1 = int(action_dict[0]), int(action_dict[1])
        r = float(self.WIN[a0, a1])
        self._round += 1
        done = self._round >= self.rounds
        obs = self._obs((a0, a1))
        return (obs, {0: r, 1: -r}, {"__all__": done},
                {"__all__": False}, {})


class AlphaStarConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 3e-4
        self.clip_param = 0.3
        self.vf_loss_coeff = 0.5
        self.entropy_coeff = 0.01
        self.num_sgd_iter = 4
        self.sgd_minibatch_size = 128
        self.kl_coeff = 0.0
        self.episodes_per_learner_step = 16
        self.num_main_exploiters = 1
        self.num_league_exploiters = 1
        self.snapshot_win_rate = 0.7    # freeze a copy above this
        self.min_iters_between_snapshots = 5
        self.payoff_ema = 0.1           # win-rate table update rate
        self.main_self_play_prob = 0.5  # rest is PFSP vs the league

    @property
    def algo_class(self):
        return AlphaStar


class _LeaguePlayer:
    """One league slot: a policy + its role + frozen flag."""

    def __init__(self, pid: str, policy: PPOPolicy, role: str,
                 frozen: bool = False):
        self.pid = pid
        self.policy = policy
        self.role = role      # "main" | "main_exploiter" |
        #                       "league_exploiter" | "historical"
        self.frozen = frozen


class AlphaStar(Algorithm):
    """League trainer.  ``training_step`` runs one match+update round
    for every learning player."""

    policy_class = PPOPolicy  # for single-policy surfaces (evaluate)

    def setup(self) -> None:
        # no WorkerSet: the league drives its own match loop
        cfg = self.config
        self.env = make_env(cfg["env"], dict(cfg.get("env_config", {})))
        if not isinstance(self.env, MultiAgentEnv) \
                or len(self.env.agent_ids) != 2:
            raise ValueError("AlphaStar needs a two-player "
                             "MultiAgentEnv (e.g. RepeatedRPS)")
        a0, a1 = self.env.agent_ids[:2]
        self._sides = (a0, a1)
        obs_s = self.env.observation_space_for(a0)
        act_s = self.env.action_space_for(a0)

        def new_policy(seed_off: int) -> PPOPolicy:
            pcfg = dict(cfg)
            pcfg["seed"] = int(cfg.get("seed", 0) or 0) + seed_off
            if not learner_gpus(cfg):
                pcfg.setdefault("_device", "cpu")
            return PPOPolicy(obs_s, act_s, pcfg)

        self.players: Dict[str, _LeaguePlayer] = {}
        self.players["main"] = _LeaguePlayer("main", new_policy(0),
                                             "main")
        for i in range(int(cfg.get("num_main_exploiters", 1))):
            pid = f"main_exploiter_{i}"
            self.players[pid] = _LeaguePlayer(pid, new_policy(10 + i),
                                              "main_exploiter")
        for i in range(int(cfg.get("num_league_exploiters", 1))):
            pid = f"league_exploiter_{i}"
            self.players[pid] = _LeaguePlayer(pid, new_policy(20 + i),
                                              "league_exploiter")
        #: payoff[pid][opp] = EMA win rate of pid vs opp
        self.payoff: Dict[str, Dict[str, float]] = {}
        self._np_rng = np.random.default_rng(int(cfg.get("seed", 0) or 0))
        self._snapshots = 0
        self._last_snapshot_iter: Dict[str, int] = {}
        self._timesteps_total = 0
        self._episodes_total = 0

    # -- matchmaking (reference league_builder PFSP) -------------------
    def _winrate(self, pid: str, opp: str) -> float:
        return self.payoff.get(pid, {}).get(opp, 0.5)

    def _pfsp_pick(self, pid: str, pool: List[str]) -> str:
        """Prioritized fictitious self-play: weight opponents by
        (1 - winrate)^2 — prefer the ones we lose to."""
        w = np.array([(1.0 - self._winrate(pid, o)) ** 2 + 1e-3
                      for o in pool])
        return pool[int(self._np_rng.choice(len(pool), p=w / w.sum()))]

    def _sample_opponent(self, pid: str) -> str:
        player = self.players[pid]
        historical = [p for p, pl in self.players.items() if pl.frozen]
        if player.role == "main":
            others = historical + [p for p, pl in self.players.items()
                                   if not pl.frozen and p != pid]
            if not others or self._np_rng.random() < float(
                    self.config.get("main_self_play_prob", 0.5)):
                return pid  # self-play
            return self._pfsp_pick(pid, others)
        if player.role == "main_exploiter":
            return "main"
        # league exploiter: PFSP over the historical league (falls back
        # to main while the league is empty)
        return self._pfsp_pick(pid, historical) if historical else "main"

    # -- match loop ----------------------------------------------------
    def _play_episode(self, pid: str, opp: str):
        """One episode, learner on a random side.  Returns (rows,
        learner_return, won)."""
        learner = self.players[pid].policy
        opponent = self.players[opp].policy
        side = int(self._np_rng.integers(2))
        me, them = self._sides[side], self._sides[1 - side]
        obs, _ = self.env.reset()
        rows: List[Dict[str, Any]] = []
        my_return = 0.0
        done = False
        while not done:
            my_obs = np.asarray(obs[me], np.float32)[None]
            their_obs = np.asarray(obs[them], np.float32)[None]
            act, extras = learner.compute_actions(my_obs)
            opp_act, _ = opponent.compute_actions(their_obs)
            actions = {me: act[0], them: opp_act[0]}
            obs, rew, term, trunc, _ = self.env.step(actions)
            done = bool(term.get("__all__")) or bool(trunc.get("__all__"))
            row = {SampleBatch.OBS: my_obs[0],
                   SampleBatch.ACTIONS: act[0],
                   SampleBatch.REWARDS: np.float32(rew.get(me, 0.0)),
                   SampleBatch.TERMINATEDS: done,
                   SampleBatch.TRUNCATEDS: False,
                   SampleBatch.EPS_ID: self._episodes_total}
            for key, col in extras.items():
                row[key] = col[0]
            rows.append(row)
            my_return += float(rew.get(me, 0.0))
        self._episodes_total += 1
        # outcome: 1 win / 0.5 draw / 0 loss (draws must stay symmetric
        # in the payoff table)
        outcome = 1.0 if my_return > 0 else (
            0.5 if my_return == 0 else 0.0)
        return rows, my_return, outcome

    def _update_payoff(self, pid: str, opp: str, outcome: float) -> None:
        ema = float(self.config.get("payoff_ema", 0.1))
        for a, b, w in ((pid, opp, outcome), (opp, pid, 1.0 - outcome)):
            table = self.payoff.setdefault(a, {})
            table[b] = (1 - ema) * table.get(b, 0.5) + ema * w

    def _maybe_snapshot(self, pid: str) -> Optional[str]:
        """Freeze a copy of a strong learner into the league (reference
        league_builder's add-to-league rule)."""
        cfg = self.config
        pool = [o for o in self.payoff.get(pid, {})]
        if not pool:
            return None
        mean_wr = float(np.mean([self._winrate(pid, o) for o in pool]))
        if mean_wr < float(cfg.get("snapshot_win_rate", 0.7)):
            return None
        last = self._last_snapshot_iter.get(pid, -10 ** 9)
        if self.iteration - last < int(
                cfg.get("min_iters_between_snapshots", 5)):
            return None
        self._last_snapshot_iter[pid] = self.iteration
        snap_id = f"{pid}_v{self._snapshots}"
        self._snapshots += 1
        frozen = PPOPolicy(self.players[pid].policy.observation_space,
                           self.players[pid].policy.action_space,
                           dict(self.players[pid].policy.config))
        frozen.set_weights(self.players[pid].policy.get_weights())
        self.players[snap_id] = _LeaguePlayer(snap_id, frozen,
                                              "historical", frozen=True)
        return snap_id

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        n_eps = int(cfg.get("episodes_per_learner_step", 16))
        stats: Dict[str, Any] = {}
        learners = [p for p, pl in self.players.items() if not pl.frozen]
        for pid in learners:
            batches, wins, returns = [], 0, []
            for _ in range(n_eps):
                opp = self._sample_opponent(pid)
                rows, ret, outcome = self._play_episode(pid, opp)
                batch = SampleBatch(
                    {k: np.stack([np.asarray(r[k]) for r in rows])
                     for k in rows[0]})
                policy = self.players[pid].policy
                batches.append(policy.postprocess_trajectory(batch))
                returns.append(ret)
                if opp != pid:
                    self._update_payoff(pid, opp, outcome)
                    wins += int(outcome > 0.5)
            full = concat_samples(batches)
            self._timesteps_total += len(full)
            out = self.players[pid].policy.learn_on_batch(full)
            stats[f"{pid}/policy_loss"] = out.get("policy_loss")
            stats[f"{pid}/reward_mean"] = float(np.mean(returns))
            if pid == "main":
                # feeds train()'s episode_reward_mean aggregation
                self._episode_returns.extend(returns)
                self._episode_lens.extend(
                    [len(b) for b in batches])
            snap = self._maybe_snapshot(pid)
            if snap:
                stats[f"{pid}/snapshotted"] = snap
        stats["league_size"] = len(self.players)
        stats["main_league_winrate"] = float(np.mean(
            [self._winrate("main", o) for o in self.payoff.get("main",
                                                               {})]
        )) if self.payoff.get("main") else 0.5
        return stats

    # -- Algorithm surface overrides -----------------------------------
    def get_policy(self, policy_id: Optional[str] = None):
        return self.players[policy_id or "main"].policy

    def save(self, checkpoint_dir: str) -> str:
        """Persist the whole league: player weights + roles + payoff
        table (reference league checkpoints carry the same)."""
        import os
        import pickle

        os.makedirs(checkpoint_dir, exist_ok=True)
        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "wb") as f:
            pickle.dump({
                "league": {pid: {"role": pl.role, "frozen": pl.frozen,
                                 "state": pl.policy.get_state()}
                           for pid, pl in self.players.items()},
                "payoff": self.payoff,
                "snapshots": self._snapshots,
                "iteration": self.iteration,
                "timesteps_total": self._timesteps_total,
            }, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        import os
        import pickle

        path = os.path.join(checkpoint_dir, "algorithm_state.pkl")
        with open(path, "rb") as f:
            state = pickle.load(f)
        template = self.players["main"].policy
        for pid, entry in state["league"].items():
            if pid not in self.players:
                policy = PPOPolicy(template.observation_space,
                                   template.action_space,
                                   dict(template.config))
                self.players[pid] = _LeaguePlayer(
                    pid, policy, entry["role"], entry["frozen"])
            self.players[pid].policy.set_state(entry["state"])
        self.payoff = state["payoff"]
        self._snapshots = state["snapshots"]
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]

    def _collect_metrics(self):
        return []

    def evaluate(self) -> Dict[str, Any]:
        """Main vs the uniform-random baseline: at the RPS Nash the
        expected return is 0."""
        rng = np.random.default_rng(0)
        main = self.players["main"].policy
        total = 0.0
        n = int(self.config.get("evaluation_duration", 10))
        for _ in range(n):
            obs, _ = self.env.reset()
            done = False
            while not done:
                a, _ = main.compute_actions(
                    np.asarray(obs[self._sides[0]], np.float32)[None])
                acts = {self._sides[0]: a[0],
                        self._sides[1]:
                            self.env.action_spaces[self._sides[1]]
                            .sample(rng)}
                obs, rew, term, trunc, _ = self.env.step(acts)
                total += float(rew.get(self._sides[0], 0.0))
                done = bool(term.get("__all__")) \
                    or bool(trunc.get("__all__"))
        return {"evaluation_reward_mean": total / n}

    def stop(self) -> None:
        pass
