"""R2D2 — Recurrent Replay Distributed DQN.

Parity: reference ``rllib/algorithms/r2d2/`` — an LSTM Q-network
trained on replayed SEQUENCES with stored recurrent states (the
"stored state" strategy of the R2D2 paper; burn-in length 0), double-Q
targets from a target network run over the same sequences, and
epsilon-greedy acting with the carry threaded through the sampler.
The sequence update (both unrolls, the TD loss and Adam) runs on the
learner's device over ``[S, L]`` sequences; the sequence replay stays on
the host.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ray_tpu_torch.rllib.algorithm import Algorithm
from ray_tpu_torch.rllib.algorithm_config import AlgorithmConfig
from ray_tpu_torch.rllib.algorithms.dqn import epsilon_greedy, huber
from ray_tpu_torch.rllib.execution import synchronous_parallel_sample
from ray_tpu_torch.rllib.policy import TorchPolicy, _to_numpy, _to_tensors
from ray_tpu_torch.rllib.sample_batch import SampleBatch, build_sequences


class R2D2Config(AlgorithmConfig):
    def __init__(self):
        super().__init__()
        self.lr = 1e-3
        self.train_batch_size = 32          # sequences per update
        self.rollout_fragment_length = 40
        self.replay_buffer_capacity = 2000  # sequences
        self.num_steps_sampled_before_learning_starts = 200
        self.target_network_update_freq = 800  # env steps
        self.double_q = True
        self.epsilon_initial = 1.0
        self.epsilon_final = 0.05
        self.epsilon_timesteps = 8000
        self.training_intensity = 1.0
        self.model = {"use_lstm": True, "lstm_cell_size": 64,
                      "max_seq_len": 20, "fcnet_hiddens": (64,)}

    @property
    def algo_class(self):
        return R2D2


class _SequenceReplay:
    """Uniform replay over fixed-length padded sequences."""

    def __init__(self, capacity: int, seed: Optional[int] = None):
        self.capacity = capacity
        self._seqs: List[Dict[str, np.ndarray]] = []
        self._next = 0
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self._seqs)

    def add_batch(self, batch: SampleBatch, max_seq_len: int) -> None:
        seq = build_sequences(batch, max_seq_len)
        for i in range(seq["seq_mask"].shape[0]):
            item = {k: v[i] for k, v in seq.items()}
            if len(self._seqs) < self.capacity:
                self._seqs.append(item)
            else:
                self._seqs[self._next] = item
                self._next = (self._next + 1) % self.capacity

    def sample(self, n: int) -> Dict[str, np.ndarray]:
        idx = self._rng.integers(0, len(self._seqs), n)
        return {k: np.stack([self._seqs[i][k] for i in idx])
                for k in self._seqs[0]}


class R2D2Policy(TorchPolicy):
    """LSTM Q-network policy; the TorchPolicy recurrent surface provides
    carry-threaded sampling, this class swaps acting to epsilon-greedy
    over Q and the update to sequence double-Q TD."""

    def __init__(self, observation_space, action_space, config):
        config = dict(config)
        model_cfg = dict(config.get("model") or {})
        model_cfg["use_lstm"] = True
        config["model"] = model_cfg
        super().__init__(observation_space, action_space, config)
        self.target_model = copy.deepcopy(self.model).requires_grad_(False)
        self._steps = 0

    # -- epsilon-greedy recurrent acting -------------------------------
    def _epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._steps
                   / float(cfg.get("epsilon_timesteps", 8000)))
        e0 = float(cfg.get("epsilon_initial", 1.0))
        e1 = float(cfg.get("epsilon_final", 0.05))
        return e0 + frac * (e1 - e0)

    def compute_actions_rnn(self, obs, state, explore: bool = True):
        with torch.no_grad():
            q, _, (c2, h2) = self.model(
                self._tensor(obs)[:, None],
                (self._tensor(state[0]), self._tensor(state[1])))
        actions = epsilon_greedy(self, q[:, 0].cpu().numpy(), explore)
        extras = {"state_in_c": np.asarray(state[0]),
                  "state_in_h": np.asarray(state[1])}
        # writable copies: the sampler zeroes per-env rows on resets
        return (actions, (c2.cpu().numpy().copy(), h2.cpu().numpy().copy()),
                extras)

    def postprocess_trajectory(self, batch, last_obs=None,
                               truncated=False):
        return batch  # raw transitions; targets come from the replay

    # -- learning -------------------------------------------------------
    def loss(self, batch):
        gamma = float(self.config.get("gamma", 0.99))
        carry = (batch["state_in_c"], batch["state_in_h"])
        q_online, _, _ = self.model(batch[SampleBatch.OBS], carry)
        with torch.no_grad():
            q_target, _, _ = self.target_model(batch[SampleBatch.OBS],
                                               carry)
            # shift within the sequence: step t bootstraps t+1
            q_next_t = q_target[:, 1:]
            if self.config.get("double_q", True):
                best = torch.argmax(q_online[:, 1:], dim=-1)
                q_next = torch.gather(q_next_t, -1, best[..., None])[..., 0]
            else:
                q_next = q_next_t.max(dim=-1).values
            rew = batch[SampleBatch.REWARDS][:, :-1]
            done = batch[SampleBatch.TERMINATEDS][:, :-1].float()
            target = rew + gamma * (1.0 - done) * q_next
            # a real (t+1) step is needed for the bootstrap — except at
            # terminals, where the target is just r (q_next is already
            # zeroed by (1-done)), so terminal rewards still train Q
            mask = batch["seq_mask"][:, :-1] * torch.maximum(
                batch["seq_mask"][:, 1:], done)
            denom = torch.clamp(mask.sum(), min=1.0)
        acts = batch[SampleBatch.ACTIONS][:, :-1].long()
        q_taken = torch.gather(q_online[:, :-1], -1, acts[..., None])[..., 0]
        td = (q_taken - target) * mask
        loss = huber(td).sum() / denom
        return loss, {"mean_q": (torch.sum(q_taken * mask) / denom).detach(),
                      "td_error_abs": (torch.sum(torch.abs(td))
                                       / denom).detach()}

    def learn_on_sequences(self, seq: Dict[str, np.ndarray]
                           ) -> Dict[str, float]:
        """One update on ``[S, L]`` sequences (``build_sequences``'s
        layout, with the stored carries)."""
        stats = self._update(self._device_batch(seq))
        stats["loss"] = stats.pop("total_loss")
        return {k: float(v) for k, v in stats.items()}

    def update_target(self) -> None:
        self.target_model.load_state_dict(self.model.state_dict())

    def get_state(self):
        state = super().get_state()
        state["target_params"] = _to_numpy(self.target_model.state_dict())
        state["steps"] = self._steps
        return state

    def set_state(self, state):
        super().set_state(state)
        if "target_params" in state:
            self.target_model.load_state_dict(
                _to_tensors(state["target_params"]))
        self._steps = int(state.get("steps", 0))


class R2D2(Algorithm):
    policy_class = R2D2Policy

    def setup(self) -> None:
        super().setup()
        cfg = self.config
        self.replay = _SequenceReplay(
            int(cfg.get("replay_buffer_capacity", 2000)),
            seed=cfg.get("seed"))
        self._since_target_update = 0
        self._max_seq_len = int(
            (cfg.get("model") or {}).get("max_seq_len", 20))

    def training_step(self) -> Dict[str, Any]:
        cfg = self.config
        policy: R2D2Policy = self.workers.local_worker.policy
        fragment = int(cfg.get("rollout_fragment_length", 40)) \
            * max(1, int(cfg.get("num_envs_per_worker", 1)))
        batch = synchronous_parallel_sample(self.workers,
                                            max_env_steps=fragment)
        self.replay.add_batch(batch, self._max_seq_len)
        self._timesteps_total += len(batch)
        self._since_target_update += len(batch)
        stats: Dict[str, Any] = {"replay_sequences": len(self.replay)}
        warmup = int(cfg.get("num_steps_sampled_before_learning_starts",
                             200))
        n_seq = int(cfg.get("train_batch_size", 32))
        if len(self.replay) * self._max_seq_len >= warmup \
                and len(self.replay) >= n_seq:
            updates = max(1, round(float(cfg.get("training_intensity",
                                                 1.0))))
            for _ in range(updates):
                stats.update(policy.learn_on_sequences(
                    self.replay.sample(n_seq)))
            if self._since_target_update >= int(
                    cfg.get("target_network_update_freq", 800)):
                policy.update_target()
                self._since_target_update = 0
            self.workers.sync_weights()
        return stats
