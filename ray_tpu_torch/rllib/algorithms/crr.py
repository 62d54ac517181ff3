"""CRR — Critic-Regularized Regression (offline continuous control).

Parity: reference ``rllib/algorithms/crr/`` (Wang et al. 2020) — an
offline actor-critic where the actor is trained by *advantage-weighted
behavioral cloning*: maximize ``f(A(s,a)) · log π(a|s)`` on dataset
actions, with ``A(s,a) = Q(s,a) − E_{a'∼π} Q(s,a')`` and ``f`` either
``exp(A/β)`` clipped (``weight_type="exp"``) or the binary indicator
``A > 0`` (``weight_type="bin"``).  The critic is plain TD with a
Polyak target — no conservatism penalty needed because the actor never
strays from dataset actions.

Reuses SAC's squashed-Gaussian actor and twin critic; the dataset
action's log-prob inverts the tanh squash, and the m policy samples for
the advantage baseline are one batched draw.  Plugs into SACPolicy's
update (log_alpha is carried but unused — CRR has no temperature).
"""

from __future__ import annotations

from typing import Dict

import torch

from ray_tpu_torch.rllib.algorithms.cql import CQL, CQLConfig
from ray_tpu_torch.rllib.algorithms.sac import (_HALF_LOG_2PI, SACPolicy,
                                                _sample_squashed, adam_step)
from ray_tpu_torch.rllib.sample_batch import SampleBatch


class CRRConfig(CQLConfig):
    def __init__(self):
        super().__init__()
        self.weight_type = "exp"   # "exp" | "bin"
        self.beta = 1.0            # temperature for the exp weights
        self.weight_clip = 20.0    # cap on exp weights (paper's CWP)
        self.advantage_samples = 4  # m policy samples for the baseline

    @property
    def algo_class(self):
        return CRR


def _squashed_logp(mean, log_std, actions):
    """log π(a|s) of a tanh-squashed Gaussian at given (dataset) actions:
    invert the squash, then Gaussian logp + tanh Jacobian."""
    a = torch.clamp(actions, -1.0 + 1e-5, 1.0 - 1e-5)
    pre = torch.atanh(a)
    std = torch.exp(log_std)
    eps = (pre - mean) / std
    return torch.sum(
        -0.5 * (eps ** 2) - log_std - _HALF_LOG_2PI
        - torch.log(1 - a ** 2 + 1e-6), dim=-1)


class CRRPolicy(SACPolicy):
    """SACPolicy scaffolding with the CRR update."""

    def __init__(self, observation_space, action_space, config):
        super().__init__(observation_space, action_space, config)
        weight_type = config.get("weight_type", "exp")
        if weight_type not in ("exp", "bin"):
            raise ValueError(f"weight_type must be 'exp' or 'bin', got "
                             f"{weight_type!r}")

    def _update_noise(self, batch_size: int) -> Dict[str, torch.Tensor]:
        """Standard normals for the critic target's next action
        (``[B, act_dim]``) and the baseline's m policy samples
        (``[m * B, act_dim]``)."""
        m = int(self.config.get("advantage_samples", 4))
        return {"next": self._normal((batch_size, self.act_dim)),
                "baseline": self._normal((m * batch_size, self.act_dim))}

    def _update_impl(self, batch, noise):
        cfg = self.config
        m = int(cfg.get("advantage_samples", 4))
        beta = float(cfg.get("beta", 1.0))
        clip = float(cfg.get("weight_clip", 20.0))
        obs = batch[SampleBatch.OBS]
        acts = batch[SampleBatch.ACTIONS]
        B = obs.shape[0]

        # critic: TD toward the target net, next action from π
        target = self._critic_target(batch, noise, None)
        q1, q2 = self.critic(obs, acts)
        c_loss = torch.mean((q1 - target) ** 2 + (q2 - target) ** 2)
        adam_step(self.critic_opt, list(self.critic.parameters()), c_loss)

        # advantage of the DATASET action vs the policy baseline, read
        # from the updated critic
        with torch.no_grad():
            mean, lstd = self.actor(obs)
            pol_act, _ = _sample_squashed(
                torch.repeat_interleave(mean, m, dim=0),
                torch.repeat_interleave(lstd, m, dim=0), noise["baseline"])
            bq1, bq2 = self.critic(torch.repeat_interleave(obs, m, dim=0),
                                   pol_act)
            baseline = torch.minimum(bq1, bq2).reshape(B, m).mean(dim=1)
            dq1, dq2 = self.critic(obs, acts)
            adv = torch.minimum(dq1, dq2) - baseline
            if cfg.get("weight_type", "exp") == "bin":
                weights = (adv > 0).float()
            else:
                weights = torch.clamp(torch.exp(adv / beta), max=clip)

        # actor: advantage-weighted behavioral cloning
        am, als = self.actor(obs)
        a_loss = -torch.mean(weights * _squashed_logp(am, als, acts))
        adam_step(self.actor_opt, list(self.actor.parameters()), a_loss)
        return {"critic_loss": c_loss.detach(),
                "actor_loss": a_loss.detach(),
                "mean_advantage": torch.mean(adv),
                "mean_weight": torch.mean(weights)}


class CRR(CQL):
    """Same offline training loop as CQL (preloaded replay, no env
    sampling)."""

    policy_class = CRRPolicy
