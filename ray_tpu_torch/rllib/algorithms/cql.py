"""CQL — Conservative Q-Learning (offline continuous control).

Parity: reference ``rllib/algorithms/cql/`` — SAC machinery plus the
conservative regularizer: logsumexp of Q over sampled (random + policy)
actions minus Q on dataset actions, pushing Q down on out-of-
distribution actions.  Trains purely from offline data (no env
sampling); evaluation rolls real episodes.  The penalty is computed in
the same update as the SAC losses, on the learner's device, with the N
candidate actions of every state drawn at once (no python loop over
samples).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ray_tpu_torch.rllib.algorithms.sac import (SAC, SACConfig, SACPolicy,
                                                _sample_squashed, adam_step)
from ray_tpu_torch.rllib.offline import JsonReader
from ray_tpu_torch.rllib.replay_buffer import ReplayBuffer
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class CQLConfig(SACConfig):
    def __init__(self):
        super().__init__()
        self.input_: Any = None          # offline data path (required)
        self.cql_weight = 5.0            # alpha_prime on the penalty
        self.cql_n_actions = 4           # sampled actions per state
        self.train_batch_size = 256
        self.updates_per_iteration = 10

    def offline_data(self, *, input_: Any = None) -> "CQLConfig":
        if input_ is not None:
            self.input_ = input_
        return self

    @property
    def algo_class(self):
        return CQL


class CQLPolicy(SACPolicy):
    """SACPolicy with the critic loss replaced by TD + conservative
    penalty; actor/alpha updates unchanged."""

    def _update_noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """SAC's draws plus the penalty's candidates: ``random`` actions
        uniform in [-1, 1] and standard normals for the ``policy``
        samples, each ``[N * B, act_dim]``."""
        noise = super()._update_noise(batch_size)
        shape = (int(self.config.get("cql_n_actions", 4)) * batch_size,
                 self.act_dim)
        noise["random"] = 2 * torch.rand(shape, generator=self._gen,
                                         device=self.device) - 1
        noise["policy"] = self._normal(shape)
        return noise

    def _update_impl(self, batch, noise):
        n_act = int(self.config.get("cql_n_actions", 4))
        cql_w = float(self.config.get("cql_weight", 5.0))
        obs = batch[SampleBatch.OBS]
        acts = batch[SampleBatch.ACTIONS]
        B = obs.shape[0]
        alpha = torch.exp(self.log_alpha).detach()
        target = self._critic_target(batch, noise, alpha)

        # candidate actions for the conservative term: N uniform + N
        # current-policy samples, evaluated batched via reshape
        rand_act = noise["random"]
        with torch.no_grad():
            mean, lstd = self.actor(obs)
            pol_act, pol_logp = _sample_squashed(
                torch.repeat_interleave(mean, n_act, dim=0),
                torch.repeat_interleave(lstd, n_act, dim=0),
                noise["policy"])
        obs_r = torch.repeat_interleave(obs, n_act, dim=0)

        q1, q2 = self.critic(obs, acts)
        td = torch.mean((q1 - target) ** 2 + (q2 - target) ** 2)
        rq1, rq2 = self.critic(obs_r, rand_act)
        pq1, pq2 = self.critic(obs_r, pol_act)
        # importance-weighted logsumexp (CQL(H)): uniform density 0.5^d
        # for random actions, policy logp for policy actions
        log_u = -self.act_dim * torch.log(torch.tensor(
            2.0, device=self.device))
        log_2n = torch.log(torch.tensor(2.0 * n_act, device=self.device))
        pol_logp = pol_logp.reshape(B, n_act)
        gaps = []
        for rq, pq, q in ((rq1, pq1, q1), (rq2, pq2, q2)):
            cat = torch.cat([rq.reshape(B, n_act) - log_u,
                             pq.reshape(B, n_act) - pol_logp], dim=1)
            gaps.append(torch.logsumexp(cat, dim=1) - log_2n - q)
        penalty = torch.mean(gaps[0]) + torch.mean(gaps[1])
        c_loss = td + cql_w * penalty
        adam_step(self.critic_opt, list(self.critic.parameters()), c_loss)

        # SAC actor + alpha updates (unchanged)
        a_loss = self._actor_alpha_step(batch, noise, alpha)
        return {"critic_loss": c_loss.detach(), "td_loss": td.detach(),
                "cql_penalty": penalty.detach(), "actor_loss": a_loss,
                "alpha": torch.exp(self.log_alpha).detach()}


class CQL(SAC):
    policy_class = CQLPolicy

    def setup(self) -> None:
        if not self.config.get("input_"):
            raise ValueError("CQL requires offline data: "
                             "config.offline_data(input_=path)")
        super().setup()
        # preload the entire offline dataset into the replay buffer
        reader = JsonReader(self.config["input_"])
        data = reader.read()
        self.replay = ReplayBuffer(max(len(data), 1),
                                   seed=self.config.get("seed"))
        self.replay.add(data)

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        policy: CQLPolicy = self.workers.local_worker.policy
        bs = int(cfg.get("train_batch_size", 256))
        stats: Dict[str, Any] = {"replay_size": len(self.replay)}
        for _ in range(int(cfg.get("updates_per_iteration", 10))):
            stats.update(policy.learn_on_batch(self.replay.sample(bs)))
            self._timesteps_total += bs
        self.workers.sync_weights()
        return stats

    def _collect_metrics(self):
        return []  # offline: no env episodes
