"""Decision Transformer: offline RL as return-conditioned sequence
modeling.

Parity: reference ``rllib/algorithms/dt/`` — a causal transformer over
(return-to-go, state, action) tokens, trained on offline trajectories
with an action-prediction loss; acting conditions on a target return
and consumes its own action predictions autoregressively.  The context
window is a fixed-size rolling buffer; the torso is two of
``models.AttentionNet``'s GTrXL blocks with a memory of width 0.  The
network, its AdamW (optax's ``adamw`` defaults: weight decay 1e-4 on
every tensor) and each update live on the learner's device (the card
unless ``num_gpus_per_learner=0``); batches are cut on the host.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import (AlgorithmConfig,
                                                  learner_gpus)
from ray_tpu_torch.rllib.env import Discrete, make_env
from ray_tpu_torch.rllib.models import (LN_EPS, _dense, _generator,
                                        _GatedTransformerBlock)
from ray_tpu_torch.rllib.policy import Adam, _to_numpy, _to_tensors
from ray_tpu_torch.rllib.sample_batch import SampleBatch

#: optax ``adamw``'s default weight decay
ADAMW_DECAY = 1e-4


class DTConfig(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.train_batch_size = 64
        self.context_length = 20  # K timesteps in the attention window
        self.embed_dim = 64
        self.num_layers = 2
        self.num_heads = 4
        self.target_return: Optional[float] = None  # default: best in data
        self.num_sgd_iter_per_step = 50
        #: offline dataset (JSON episode files) — reference input_ config
        self.input_ = None

    @property
    def algo_class(self):
        return DT


class _DTNet(nn.Module):
    """(rtg, obs, act) token triples -> next-action logits per step.
    flax's names: ``pos_embed``, ``obs_embed``, ``act_embed`` (an
    embedding of ``A + 1`` rows: slot 0 is "no previous action"),
    ``rtg_embed``, ``block_<i>``, ``ln_f``, ``head``."""

    def __init__(self, num_actions: int, obs_dim: int, embed_dim: int = 64,
                 num_layers: int = 2, num_heads: int = 4,
                 context_length: int = 20, seed: int = 0):
        super().__init__()
        gen = _generator(seed)
        self.num_layers = int(num_layers)
        self.pos_embed = nn.Parameter(0.02 * torch.randn(
            (1, context_length, embed_dim), generator=gen))
        self.obs_embed = _dense(obs_dim, embed_dim, gen)
        self.act_embed = nn.Embedding(num_actions + 1, embed_dim)
        with torch.no_grad():  # flax Embed: variance 1 / features
            self.act_embed.weight.normal_(0.0, embed_dim ** -0.5,
                                          generator=gen)
        self.rtg_embed = _dense(1, embed_dim, gen)
        for layer in range(self.num_layers):
            self.add_module(f"block_{layer}",
                            _GatedTransformerBlock(embed_dim, num_heads,
                                                   gen))
        self.ln_f = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.head = _dense(embed_dim, num_actions, gen)

    def forward(self, obs, actions, rtg):
        """obs [B,K,obs_dim], actions [B,K] int (shifted: a_{t-1} slot,
        -1 for none), rtg [B,K,1] — returns action logits [B,K,A].  The
        attention is causal, so a padded tail leaves the steps before it
        as they are (the JAX package's ``mask`` argument, unused there
        too, is left out)."""
        b, k = actions.shape
        # one fused token per timestep (sum of the three modality
        # embeddings, as the JAX package's)
        x = (self.obs_embed(obs) + self.act_embed(actions.long() + 1)
             + self.rtg_embed(rtg)) + self.pos_embed[:, :k]
        mem = x.new_zeros((b, 0, x.shape[-1]))
        mem_mask = torch.zeros((b, 0), dtype=torch.bool, device=x.device)
        for layer in range(self.num_layers):
            x = getattr(self, f"block_{layer}")(x, mem, mem_mask)
        return self.head(self.ln_f(x))


class DTLearner:
    """The network, its AdamW and the masked-NLL update on one device."""

    def __init__(self, num_actions: int, obs_dim: int,
                 config: Dict[str, Any], device=None):
        self.config = config
        self.device = resolve_device(device)
        self.model = _DTNet(
            num_actions, obs_dim,
            embed_dim=int(config.get("embed_dim", 64)),
            num_layers=int(config.get("num_layers", 2)),
            num_heads=int(config.get("num_heads", 4)),
            context_length=int(config.get("context_length", 20)),
            seed=int(config.get("seed", 0) or 0)).to(self.device)
        self.opt = Adam(self.model.parameters(),
                        lr=float(config.get("lr", 1e-3)),
                        weight_decay=ADAMW_DECAY)

    def tensors(self, batch: Dict[str, np.ndarray]
                ) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device)
                for k, v in batch.items()}

    def _update(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """One AdamW step on the masked action NLL; returns the loss."""
        logits = self.model(batch["obs"], batch["prev_act"], batch["rtg"])
        logp = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1,
                            batch["act"].long()[..., None])[..., 0]
        mask = batch["mask"]
        loss = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
        self.opt.zero_grad(set_to_none=False)
        loss.backward()
        self.opt.step()
        return loss.detach()

    def update(self, batch: Dict[str, np.ndarray]) -> torch.Tensor:
        """:meth:`_update` on numpy columns; the loss stays on the
        device."""
        return self._update(self.tensors(batch))

    def _logits(self, obs, prev_act, rtg) -> torch.Tensor:
        with torch.no_grad():
            return self.model(obs, prev_act, rtg)

    def get_state(self) -> Dict[str, Any]:
        return {"weights": _to_numpy(self.model.state_dict()),
                "opt_state": _to_numpy(self.opt.state_dict())}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(_to_tensors(state["weights"]))
        if "opt_state" in state:
            self.opt.load_state_dict(_to_tensors(state["opt_state"]))


class DT(Algorithm):
    """Offline trainer + return-conditioned evaluator."""

    def setup(self) -> None:
        cfg = self.config
        self.env = make_env(cfg["env"], dict(cfg.get("env_config", {})))
        if not isinstance(self.env.action_space, Discrete):
            raise ValueError("this DT supports Discrete action spaces")
        self.num_actions = int(self.env.action_space.n)
        self.obs_dim = int(np.prod(self.env.observation_space.shape))
        self.K = int(cfg.get("context_length", 20))

        self.episodes = self._load_offline(cfg.get("input_"))
        returns = [float(sum(ep["rewards"])) for ep in self.episodes]
        self.target_return = float(
            cfg.get("target_return") or (max(returns) if returns else 0.0))

        self.learner = DTLearner(
            self.num_actions, self.obs_dim, cfg,
            device=None if learner_gpus(cfg) else "cpu")
        self._np_rng = np.random.default_rng(int(cfg.get("seed", 0) or 0))
        self._pending_returns: List[float] = []
        self._pending_lens: List[int] = []

    def get_policy(self, policy_id: Optional[str] = None) -> DTLearner:
        return self.learner

    # -- offline data ---------------------------------------------------
    def _load_offline(self, input_) -> List[Dict[str, np.ndarray]]:
        if input_ is None:
            raise ValueError(
                "DT is offline-only: pass config.input_ (a directory of "
                "JSON episodes from rllib.offline.JsonWriter, or a list "
                "of episode dicts)")
        if isinstance(input_, (list, tuple)):
            return [dict(ep) for ep in input_]
        from ray_tpu_torch.rllib.offline import JsonReader

        reader = JsonReader(input_)
        episodes: List[Dict[str, np.ndarray]] = []
        for batch in reader.read_all_batches():
            # split batches on episode boundaries
            dones = np.asarray(batch[SampleBatch.TERMINATEDS]) | \
                np.asarray(batch.get(SampleBatch.TRUNCATEDS,
                                     np.zeros(len(batch), bool)))
            start = 0
            for i, d in enumerate(dones):
                if d:
                    episodes.append({
                        "obs": np.asarray(
                            batch[SampleBatch.OBS][start:i + 1]),
                        "actions": np.asarray(
                            batch[SampleBatch.ACTIONS][start:i + 1]),
                        "rewards": np.asarray(
                            batch[SampleBatch.REWARDS][start:i + 1]),
                    })
                    start = i + 1
        return episodes

    def _sample_batch(self, bs: int) -> Dict[str, np.ndarray]:
        K = self.K
        obs = np.zeros((bs, K, self.obs_dim), np.float32)
        act = np.zeros((bs, K), np.int32)
        prev = np.full((bs, K), -1, np.int32)
        rtg = np.zeros((bs, K, 1), np.float32)
        mask = np.zeros((bs, K), np.float32)
        for b in range(bs):
            ep = self.episodes[self._np_rng.integers(len(self.episodes))]
            T = len(ep["rewards"])
            end = int(self._np_rng.integers(1, T + 1))
            start = max(0, end - K)
            seg = slice(start, end)
            n = end - start
            rewards = np.asarray(ep["rewards"], np.float32)
            # return-to-go at each step of the segment
            rtg_full = np.cumsum(rewards[::-1])[::-1]
            obs[b, :n] = ep["obs"][seg].reshape(n, -1)
            act[b, :n] = ep["actions"][seg]
            prev[b, 1:n] = ep["actions"][seg][:-1]
            rtg[b, :n, 0] = rtg_full[seg]
            mask[b, :n] = 1.0
        return {"obs": obs, "act": act, "prev_act": prev, "rtg": rtg,
                "mask": mask}

    # -- training -------------------------------------------------------
    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        bs = int(cfg.get("train_batch_size", 64))
        loss = None
        for _ in range(int(cfg.get("num_sgd_iter_per_step", 50))):
            loss = self.learner.update(self._sample_batch(bs))
            self._timesteps_total += bs
        # periodic conditioned rollout for the reward metric
        ret, length = self._conditioned_episode()
        self._pending_returns.append(ret)
        self._pending_lens.append(length)
        return {"loss": float(loss) if loss is not None else None,
                "target_return": self.target_return,
                "num_offline_episodes": len(self.episodes)}

    def _conditioned_episode(self) -> Tuple[float, int]:
        obs, _ = self.env.reset()
        K = self.K
        obs_hist = np.zeros((K, self.obs_dim), np.float32)
        act_hist = np.full((K,), -1, np.int32)
        rtg_hist = np.zeros((K, 1), np.float32)
        used = 0
        rtg = self.target_return
        total, steps = 0.0, 0
        done = False
        learner = self.learner
        while not done and steps < 1000:
            if used < K:
                obs_hist[used] = np.asarray(obs, np.float32).ravel()
                rtg_hist[used, 0] = rtg
                used += 1
            else:
                obs_hist[:-1] = obs_hist[1:]
                act_hist[:-1] = act_hist[1:]
                rtg_hist[:-1] = rtg_hist[1:]
                obs_hist[-1] = np.asarray(obs, np.float32).ravel()
                rtg_hist[-1, 0] = rtg
            t = learner.tensors({"obs": obs_hist[None],
                                 "prev_act": act_hist[None],
                                 "rtg": rtg_hist[None]})
            logits = learner._logits(t["obs"], t["prev_act"],
                                     t["rtg"])[0].cpu().numpy()
            action = int(np.argmax(logits[min(used, K) - 1]))
            obs, rew, term, trunc, _ = self.env.step(action)
            if used <= K:
                act_hist[used - 1] = action
            else:
                act_hist[-1] = action
            rtg -= float(rew)
            total += float(rew)
            steps += 1
            done = bool(term or trunc)
        return total, steps

    def evaluate(self) -> Dict[str, Any]:
        returns = [self._conditioned_episode()[0] for _ in range(
            int(self.config.get("evaluation_duration", 10)))]
        return {"episode_reward_mean": float(np.mean(returns)),
                "episode_reward_min": float(np.min(returns)),
                "episode_reward_max": float(np.max(returns))}

    # -- Algorithm plumbing without a worker fleet ----------------------
    def _collect_metrics(self):
        out = [{"episode_returns": list(self._pending_returns),
                "episode_lens": list(self._pending_lens)}]
        self._pending_returns.clear()
        self._pending_lens.clear()
        return out

    def save(self, checkpoint_dir: str) -> str:
        os.makedirs(checkpoint_dir, exist_ok=True)
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "wb") as f:
            pickle.dump({
                "params": _to_numpy(self.learner.model.state_dict()),
                "iteration": self.iteration,
                "timesteps_total": self._timesteps_total,
                "target_return": self.target_return,
            }, f)
        return checkpoint_dir

    def restore(self, checkpoint_dir: str) -> None:
        with open(os.path.join(checkpoint_dir, "algorithm_state.pkl"),
                  "rb") as f:
            state = pickle.load(f)
        self.learner.model.load_state_dict(_to_tensors(state["params"]))
        self.iteration = state["iteration"]
        self._timesteps_total = state["timesteps_total"]
        self.target_return = state["target_return"]

    def stop(self) -> None:
        pass
