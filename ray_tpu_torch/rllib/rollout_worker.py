"""Rollout workers: env stepping + trajectory collection.

Parity: reference ``rllib/evaluation/rollout_worker.py`` (``RolloutWorker``
:157, ``sample``:871) with the ``SyncSampler`` loop (``sampler.py``:145)
inlined.  One worker steps ``num_envs_per_worker`` environments in
lockstep so the policy forward is one batched call per tick — the
env loop stays python/numpy on host CPUs while the learner owns the
card.  Workers run as actors (created by WorkerSet); weight sync is a
plain ``set_weights`` actor call carrying numpy arrays over the object
plane.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from ray_tpu_torch.rllib.env import MultiAgentEnv, make_env
from ray_tpu_torch.rllib.sample_batch import (MultiAgentBatch,
                                              SampleBatch, concat_samples)


class EnvActor:
    """Policy-free vectorized environment actor (the Sebulba "actor"
    half — docs/rl_pipeline.md).  Steps ``rl_envs_per_actor`` envs as a
    batch, ships observation batches to the centralized
    :class:`~ray_tpu_torch.rllib.inference.InferenceActor`, receives action
    batches, and hands fixed-length trajectory fragments back over the
    object plane.  It never holds weights, so weight sync cost is flat
    in env-actor count.

    Latency hiding: the envs are split into ``rl_env_groups`` groups
    stepped round-robin — while one group's inference RPC is in flight,
    the other group steps its envs (double buffering), so the actor is
    throughput-bound, not inference-round-trip-bound.

    Advantage estimation happens HERE (batched GAE over the [T, N]
    fragment, one reversed pass over T for all N envs) because the
    inference replies carry ``vf_preds``; the learner receives
    train-ready fragments.
    """

    def __init__(self, env_spec: Any, config: Dict[str, Any],
                 actor_index: int, inference: Any):
        from ray_tpu_torch.rllib.env import as_vector_env

        self.config = dict(config)
        self.actor_index = int(actor_index)
        self._inference = inference
        n = int(config.get("rl_envs_per_actor")
                or config.get("num_envs_per_worker") or 1)
        groups = max(1, min(int(config.get("rl_env_groups", 1) or 1), n))
        seed = config.get("seed")
        env_config = dict(config.get("env_config", {}))
        sizes = [n // groups + (1 if g < n % groups else 0)
                 for g in range(groups)]
        self._groups: List[Any] = []
        base = 0
        for g, size in enumerate(sizes):
            cfg = dict(env_config)
            if seed is not None:
                cfg["seed"] = (int(seed) + actor_index) * 1000 + base
            self._groups.append(as_vector_env(env_spec, size, cfg))
            base += size
        self._gamma = float(config.get("gamma", 0.99))
        self._lambda = float(config.get("lambda_", 0.95))
        self._fragment = int(config.get("rollout_fragment_length", 200))
        self._obs = [vec.reset_all() for vec in self._groups]
        self._eps_ids = []
        self._next_eps_id = 0
        for size in sizes:
            self._eps_ids.append(np.arange(
                self._next_eps_id, self._next_eps_id + size, dtype=np.int64))
            self._next_eps_id += size
        self._ep_rew = [np.zeros(s) for s in sizes]
        self._ep_len = [np.zeros(s, np.int64) for s in sizes]
        self._completed_returns: List[float] = []
        self._completed_lens: List[int] = []
        self._seq = 0
        # announce ourselves so the batcher's admission window knows
        # the fleet size (fire-and-forget; keyed by slot so a recreated
        # actor re-registers idempotently)
        inference.register_client.remote(self.actor_index)

    # ------------------------------------------------------------------
    def collect_fragment(self) -> Dict[str, Any]:
        """One fixed-length fragment per env group, double-buffered
        across groups; returns a dict with the GAE-postprocessed
        ``batch``, piggybacked episode ``metrics``, the per-actor
        monotonic ``seq``, and the oldest weights ``version`` that
        contributed actions."""
        import ray_tpu_torch
        from ray_tpu_torch.util.failpoint import failpoint

        failpoint("rllib.env_actor.collect")
        T = self._fragment
        G = len(self._groups)
        # per-group per-tick column buffers
        cols = [{k: [] for k in ("obs", "actions", "logp", "vf", "rew",
                                 "term", "trunc", "eps")}
                for _ in range(G)]
        boot = [np.zeros((T, vec.num_envs), np.float32)
                for vec in self._groups]
        # rows pending a bootstrap value: (tick, env_i) aligned with the
        # extra obs rows appended to the group's next inference call
        pending: List[List[tuple]] = [[] for _ in range(G)]
        inflight_pending: List[List[tuple]] = [[] for _ in range(G)]
        version = None

        def submit(g: int):
            live = self._obs[g]
            extra = [row for _, _, row in pending[g]]
            stacked = np.concatenate([live, np.stack(extra)], axis=0) \
                if extra else live
            inflight_pending[g] = [(t, i) for t, i, _ in pending[g]]
            pending[g] = []
            return self._inference.infer.remote(stacked)

        refs = [submit(g) for g in range(G)]
        for t in range(T):
            for g in range(G):
                vec = self._groups[g]
                nlive = vec.num_envs
                actions, extras, ver = ray_tpu_torch.get(refs[g])
                version = ver if version is None else min(version, ver)
                vf_all = np.asarray(extras["vf_preds"], np.float32)
                for (bt, bi), v in zip(inflight_pending[g],
                                       vf_all[nlive:]):
                    boot[g][bt, bi] = v
                inflight_pending[g] = []
                acts = np.asarray(actions)[:nlive]
                obs = self._obs[g]
                obs2, rew, term, trunc = vec.step(acts)
                c = cols[g]
                c["obs"].append(obs)
                c["actions"].append(acts)
                c["logp"].append(
                    np.asarray(extras["action_logp"],
                               np.float32)[:nlive])
                c["vf"].append(vf_all[:nlive])
                c["rew"].append(np.asarray(rew, np.float32))
                c["term"].append(term)
                c["trunc"].append(trunc)
                c["eps"].append(self._eps_ids[g].copy())
                self._ep_rew[g] += rew
                self._ep_len[g] += 1
                done = term | trunc
                if done.any():
                    for i in np.nonzero(done)[0]:
                        self._completed_returns.append(
                            float(self._ep_rew[g][i]))
                        self._completed_lens.append(
                            int(self._ep_len[g][i]))
                        self._eps_ids[g][i] = self._next_eps_id
                        self._next_eps_id += 1
                        if trunc[i] and not term[i]:
                            # truncated: V(final_obs) rides the next
                            # inference call as an appended row
                            pending[g].append(
                                (t, int(i), vec.final_obs[i].copy()))
                    self._ep_rew[g][done] = 0.0
                    self._ep_len[g][done] = 0
                self._obs[g] = obs2
                refs[g] = submit(g)  # value pass doubles as next tick
        # final pass: refs[g] now carries V(current obs) for the
        # fragment-boundary bootstrap plus any last-tick truncations
        chunks: List[SampleBatch] = []
        for g in range(G):
            vec = self._groups[g]
            nlive = vec.num_envs
            _, extras, ver = ray_tpu_torch.get(refs[g])
            version = ver if version is None else min(version, ver)
            vf_all = np.asarray(extras["vf_preds"], np.float32)
            for (bt, bi), v in zip(inflight_pending[g], vf_all[nlive:]):
                boot[g][bt, bi] = v
            inflight_pending[g] = []
            chunks.append(self._postprocess_group(
                g, cols[g], boot[g], vf_all[:nlive]))
        self._seq += 1
        return {
            "batch": concat_samples(chunks),
            "metrics": self.metrics(),
            "seq": self._seq,
            "version": 0 if version is None else int(version),
            "actor_index": self.actor_index,
        }

    def _postprocess_group(self, g: int, c: Dict[str, List[np.ndarray]],
                           boot: np.ndarray, vf_last: np.ndarray
                           ) -> SampleBatch:
        """Batched GAE over one group's [T, N] fragment: a single
        reversed pass over T handles every env; episode boundaries
        (term|trunc) zero the carry and switch the bootstrap to 0
        (terminal) or V(final_obs) (truncated)."""
        T = len(c["rew"])
        rew = np.stack(c["rew"]).astype(np.float64)          # [T, N]
        vf = np.stack(c["vf"]).astype(np.float64)
        term = np.stack(c["term"])
        trunc = np.stack(c["trunc"])
        done = term | trunc
        bootv = boot.astype(np.float64)                       # 0 at term
        gamma, lam = self._gamma, self._lambda
        adv = np.zeros_like(rew)
        acc = np.zeros(rew.shape[1])
        for t in reversed(range(T)):
            vnext = np.where(done[t], bootv[t],
                             vf[t + 1] if t + 1 < T else vf_last)
            delta = rew[t] + gamma * vnext - vf[t]
            acc = delta + gamma * lam * np.where(done[t], 0.0, acc)
            adv[t] = acc
        targets = adv + vf

        def flat(x):
            # env-major so eps_id chunks stay contiguous
            arr = np.asarray(x)
            return np.swapaxes(arr, 0, 1).reshape(
                (-1,) + arr.shape[2:])

        return SampleBatch({
            SampleBatch.OBS: flat(np.stack(c["obs"])),
            SampleBatch.ACTIONS: flat(np.stack(c["actions"])),
            SampleBatch.ACTION_LOGP: flat(np.stack(c["logp"])),
            SampleBatch.VF_PREDS: flat(vf.astype(np.float32)),
            SampleBatch.REWARDS: flat(rew.astype(np.float32)),
            SampleBatch.TERMINATEDS: flat(term),
            SampleBatch.TRUNCATEDS: flat(trunc),
            SampleBatch.ADVANTAGES: flat(adv.astype(np.float32)),
            SampleBatch.VALUE_TARGETS: flat(targets.astype(np.float32)),
            SampleBatch.EPS_ID: flat(np.stack(c["eps"])),
        })

    # ------------------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        out = {"episode_returns": list(self._completed_returns),
               "episode_lens": list(self._completed_lens)}
        self._completed_returns = []
        self._completed_lens = []
        return out

    def ping(self) -> str:
        return "ok"

    def arm_failpoint(self, name: str, action: str = "raise",
                      **options) -> None:
        """Chaos tooling: arm a failpoint inside THIS actor's process
        (one env actor of the fleet can be faulted)."""
        from ray_tpu_torch.util import failpoint as _fp

        _fp.arm(name, action, **options)


class RolloutWorker:
    def __init__(self, env_spec: Any, policy_cls: type,
                 config: Dict[str, Any], worker_index: int = 0):
        self.config = dict(config)
        self.worker_index = worker_index
        # policies read this for per-worker exploration ladders (Ape-X)
        self.config["worker_index"] = worker_index
        seed = config.get("seed")
        if seed is not None:
            seed = int(seed) + worker_index
            self.config["seed"] = seed
        if worker_index > 0 and not config.get("_num_gpus_per_worker"):
            # remote samplers run on host CPUs; the card belongs to the
            # learner (reference: rollout workers get num_gpus=0) unless
            # the workers are the learners and were given a share of it
            self.config.setdefault("_device", "cpu")
        n = int(config.get("num_envs_per_worker", 1))
        env_config = dict(config.get("env_config", {}))
        first = make_env(env_spec, dict(
            env_config, **({} if seed is None else {"seed": seed * 1000})))
        self._ma = isinstance(first, MultiAgentEnv)
        if self._ma and n > 1:
            logging.getLogger(__name__).warning(
                "num_envs_per_worker=%d ignored for MultiAgentEnv "
                "(multi-agent sampling steps one env per worker)", n)
            n = 1
        self.envs = [first]
        for i in range(1, n):
            cfg = dict(env_config)
            if seed is not None:
                cfg["seed"] = seed * 1000 + i
            self.envs.append(make_env(env_spec, cfg))
        env = self.envs[0]

        self.policy_map: Dict[str, Any] = {}
        if self._ma:
            policies = config.get("policies") or {}
            if not policies:
                raise ValueError("a MultiAgentEnv needs config"
                                 ".multi_agent(policies=..., "
                                 "policy_mapping_fn=...)")
            self.policy_mapping_fn = config.get("policy_mapping_fn") \
                or (lambda agent_id: next(iter(policies)))
            for pid, spec in policies.items():
                if spec is None:
                    # infer spaces from the first agent mapped to pid
                    agent = next(
                        (a for a in env.agent_ids
                         if self.policy_mapping_fn(a) == pid), None)
                    if agent is None:
                        raise ValueError(
                            f"policy {pid!r} has spaces=None but "
                            f"policy_mapping_fn maps no agent of "
                            f"{sorted(env.agent_ids)} to it; pass "
                            f"(obs_space, act_space, overrides) "
                            f"explicitly or fix the mapping")
                    obs_s = env.observation_space_for(agent)
                    act_s = env.action_space_for(agent)
                    overrides = {}
                else:
                    obs_s, act_s, overrides = spec
                pcfg = dict(self.config, **(overrides or {}))
                self.policy_map[pid] = policy_cls(obs_s, act_s, pcfg)
            self.policy = next(iter(self.policy_map.values()))
            self._ma_env = env
            self._ma_obs, _ = env.reset()
            self._ma_buffers: Dict[Any, List[Dict[str, Any]]] = {}
            self._ma_episode_reward = 0.0
            self._ma_episode_len = 0
            self._completed_returns = []
            self._completed_lens = []
            return

        self.policy = policy_cls(env.observation_space, env.action_space,
                                 self.config)
        # connector pipelines transform at the env boundary so OBS,
        # NEXT_OBS, and bootstrap values all see the same space
        # (reference rllib/connectors agent/action connectors)
        from ray_tpu_torch.rllib.connectors import ConnectorPipeline

        self.obs_connectors = ConnectorPipeline(
            list(config.get("obs_connectors") or []))
        self.action_connectors = ConnectorPipeline(
            list(config.get("action_connectors") or []))
        self._obs = np.stack([self._connect_obs(e.reset()[0])
                              for e in self.envs])
        # external sampling input (reference input_ / InputReader
        # contract: a callable(ioctx) -> reader with .next()); e.g.
        # PolicyServerInput for client-server RL
        input_fn = config.get("input_")
        self._input_reader = input_fn(self) if callable(input_fn) else None
        self._recurrent = bool(getattr(self.policy, "recurrent", False))
        if self._recurrent:
            self._rnn_state = self.policy.get_initial_state(n)
        self._episode_buffers: List[List[Dict[str, Any]]] = \
            [[] for _ in range(n)]
        self._episode_rewards = np.zeros(n)
        self._episode_lens = np.zeros(n, dtype=np.int64)
        self._eps_ids = np.arange(n, dtype=np.int64)
        self._next_eps_id = n
        self._completed_returns: List[float] = []
        self._completed_lens: List[int] = []

    # ------------------------------------------------------------------
    def sample(self) -> SampleBatch:
        """Collect one fragment: rollout_fragment_length steps from each
        env, GAE-postprocessed per episode chunk.

        With config ``_raw_fragments`` (IMPALA-family), fragments are
        fixed-length unrolls that run *across* episode resets (dones mark
        the boundaries) and skip trajectory postprocessing — off-policy
        corrections happen learner-side (V-trace).
        """
        if self._ma:
            return self._sample_multi_agent()
        if self._input_reader is not None:
            return self._input_reader.next()
        fragment = int(self.config.get("rollout_fragment_length", 200))
        raw = bool(self.config.get("_raw_fragments", False))
        n = len(self.envs)
        chunks: List[SampleBatch] = []
        rows: List[List[Dict[str, Any]]] = self._episode_buffers

        for _ in range(fragment):
            if self._recurrent:
                actions, self._rnn_state, extras = \
                    self.policy.compute_actions_rnn(self._obs,
                                                    self._rnn_state)
            else:
                actions, extras = self.policy.compute_actions(self._obs)
            env_actions = actions
            if self.action_connectors.connectors:
                env_actions = self.action_connectors(np.asarray(actions))
            next_obs = np.empty_like(self._obs)
            for i, env in enumerate(self.envs):
                obs2, rew, term, trunc, _ = env.step(
                    env_actions[i] if np.ndim(env_actions) else env_actions)
                obs2 = self._connect_obs(obs2)
                row = {
                    SampleBatch.OBS: self._obs[i],
                    SampleBatch.NEXT_OBS: obs2,
                    SampleBatch.ACTIONS: actions[i],
                    SampleBatch.REWARDS: rew,
                    SampleBatch.TERMINATEDS: term,
                    SampleBatch.TRUNCATEDS: trunc,
                    SampleBatch.EPS_ID: self._eps_ids[i],
                }
                for key, col in extras.items():
                    row[key] = col[i]
                rows[i].append(row)
                self._episode_rewards[i] += rew
                self._episode_lens[i] += 1
                if term or trunc:
                    if raw:
                        self._note_episode_end(i)
                    else:
                        chunks.append(self._flush_episode(i, obs2, term))
                    obs2 = self._connect_obs(env.reset()[0])
                    if self._recurrent:
                        # fresh episode -> zero carry for this env
                        for arr in self._rnn_state:
                            arr[i] = 0.0
                next_obs[i] = obs2
            self._obs = next_obs

        if raw:
            # one fixed-length unroll per env, no postprocessing
            for i in range(n):
                chunks.append(SampleBatch(
                    {k: np.stack([r[k] for r in rows[i]])
                     for k in rows[i][0]}))
                rows[i] = []
        else:
            # fragment boundary: flush in-progress episodes as truncated
            # chunks (bootstrapped with V(s_last)); episode stats keep
            # accumulating
            for i in range(n):
                if rows[i]:
                    if self._recurrent:
                        # the carry that would process s_last, for the
                        # truncation bootstrap V(s_last | carry)
                        self.policy._bootstrap_state = tuple(
                            arr[i:i + 1] for arr in self._rnn_state)
                    chunks.append(self._postprocess(rows[i], self._obs[i],
                                                    truncated=True))
                    rows[i] = []
            if self._recurrent:
                self.policy._bootstrap_state = None
        return concat_samples(chunks)

    def _connect_obs(self, obs: np.ndarray) -> np.ndarray:
        if not self.obs_connectors.connectors:
            return obs
        return self.obs_connectors(np.asarray(obs)[None])[0]

    # -- multi-agent sampling -------------------------------------------
    def _sample_multi_agent(self) -> MultiAgentBatch:
        """One fragment from the multi-agent env: per-agent trajectories,
        postprocessed by each agent's mapped policy, grouped per policy
        (reference ``env_runner_v2.py`` multi-agent collection)."""
        fragment = int(self.config.get("rollout_fragment_length", 200))
        env = self._ma_env
        chunks: Dict[str, List[SampleBatch]] = {}
        env_steps = 0

        for _ in range(fragment):
            env_steps += 1
            # group live agents by policy for one batched forward each
            agents = list(self._ma_obs)
            by_pid: Dict[str, List[Any]] = {}
            for a in agents:
                by_pid.setdefault(self.policy_mapping_fn(a), []).append(a)
            actions: Dict[Any, Any] = {}
            extras_by_agent: Dict[Any, Dict[str, Any]] = {}
            for pid, members in by_pid.items():
                obs = np.stack([self._ma_obs[a] for a in members])
                acts, extras = self.policy_map[pid].compute_actions(obs)
                for j, a in enumerate(members):
                    actions[a] = np.asarray(acts)[j]
                    extras_by_agent[a] = {k: v[j]
                                          for k, v in extras.items()}
            obs2, rew, term, trunc, _ = env.step(actions)
            for a in actions:
                if a not in rew:
                    continue  # agent was already done
                row = {
                    SampleBatch.OBS: self._ma_obs[a],
                    SampleBatch.NEXT_OBS: obs2[a],
                    SampleBatch.ACTIONS: actions[a],
                    SampleBatch.REWARDS: rew[a],
                    SampleBatch.TERMINATEDS: term.get(a, False),
                    SampleBatch.TRUNCATEDS: trunc.get(a, False),
                }
                row.update(extras_by_agent[a])
                self._ma_buffers.setdefault(a, []).append(row)
                self._ma_episode_reward += float(rew[a])
                done_a = term.get(a, False) or trunc.get(a, False)
                if done_a:
                    self._flush_agent(a, obs2[a], term.get(a, False),
                                      chunks)
            self._ma_episode_len += 1
            if term.get("__all__") or trunc.get("__all__"):
                for a, rows in list(self._ma_buffers.items()):
                    if rows:
                        self._flush_agent(
                            a, obs2.get(a, rows[-1][SampleBatch.NEXT_OBS]),
                            term.get(a, False), chunks)
                self._completed_returns.append(self._ma_episode_reward)
                self._completed_lens.append(self._ma_episode_len)
                self._ma_episode_reward = 0.0
                self._ma_episode_len = 0
                self._ma_obs, _ = env.reset()
            else:
                # keep only obs for agents still alive (done agents'
                # terminal obs must not be acted on again)
                self._ma_obs = {
                    a: o for a, o in obs2.items()
                    if not (term.get(a, False) or trunc.get(a, False))}

        # fragment boundary: flush in-progress trajectories as truncated
        for a, rows in list(self._ma_buffers.items()):
            if rows:
                self._flush_agent(a, self._ma_obs.get(
                    a, rows[-1][SampleBatch.NEXT_OBS]), False, chunks,
                    truncated=True)
        return MultiAgentBatch(
            {pid: concat_samples(parts) for pid, parts in chunks.items()},
            env_steps=env_steps)

    def _flush_agent(self, agent: Any, last_obs: np.ndarray,
                     terminated: bool,
                     chunks: Dict[str, List[SampleBatch]],
                     truncated: Optional[bool] = None) -> None:
        rows = self._ma_buffers.pop(agent, [])
        if not rows:
            return
        pid = self.policy_mapping_fn(agent)
        batch = SampleBatch(
            {k: np.stack([np.asarray(r[k]) for r in rows])
             for k in rows[0]})
        if truncated is None:
            truncated = not terminated
        batch = self.policy_map[pid].postprocess_trajectory(
            batch, np.asarray(last_obs), truncated=truncated)
        chunks.setdefault(pid, []).append(batch)

    def _note_episode_end(self, i: int) -> None:
        self._completed_returns.append(float(self._episode_rewards[i]))
        self._completed_lens.append(int(self._episode_lens[i]))
        self._episode_rewards[i] = 0.0
        self._episode_lens[i] = 0
        self._eps_ids[i] = self._next_eps_id
        self._next_eps_id += 1

    def _flush_episode(self, i: int, final_obs: np.ndarray,
                       terminated: bool) -> SampleBatch:
        batch = self._postprocess(self._episode_buffers[i], final_obs,
                                  truncated=not terminated)
        self._episode_buffers[i] = []
        self._note_episode_end(i)
        return batch

    def _postprocess(self, rows: List[Dict[str, Any]],
                     last_obs: np.ndarray, truncated: bool) -> SampleBatch:
        batch = SampleBatch(
            {k: np.stack([r[k] for r in rows]) for k in rows[0]})
        return self.policy.postprocess_trajectory(batch, last_obs,
                                                  truncated=truncated)

    def sample_with_metrics(self):
        """One actor round-trip for async learners: piggybacks episode
        stats on the fragment so no separate metrics() call has to queue
        behind the next (already re-dispatched) sample()."""
        batch = self.sample()
        return batch, self.metrics()

    # ------------------------------------------------------------------
    def metrics(self) -> Dict[str, Any]:
        """Drain episode stats (reference ``collect_metrics``)."""
        out = {"episode_returns": list(self._completed_returns),
               "episode_lens": list(self._completed_lens)}
        self._completed_returns = []
        self._completed_lens = []
        return out

    def get_weights(self):
        if self.policy_map:
            return {pid: p.get_weights()
                    for pid, p in self.policy_map.items()}
        return self.policy.get_weights()

    def set_weights(self, weights) -> None:
        if self.policy_map:
            for pid, w in weights.items():
                self.policy_map[pid].set_weights(w)
        else:
            self.policy.set_weights(weights)

    def apply(self, fn: Callable, *args):
        """Run an arbitrary function on this worker (reference
        ``RolloutWorker.apply``)."""
        return fn(self, *args)
