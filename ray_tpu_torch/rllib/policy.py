"""Policy: parameters + the action and update computations.

Parity: reference ``rllib/policy/policy.py`` (:166) and
``torch_policy_v2.py`` — ``compute_actions``, ``learn_on_batch``,
``postprocess_trajectory``, weight get/set.  The model is an
``nn.Module`` on the policy's ``torch.device``: the learner's is the
card unless its config names the CPU, samplers pin theirs to the host
(config ``"_device": "cpu"``).  Acting is one forward under
``torch.no_grad()`` per env tick, sampling from the policy's own
``torch.Generator``; an update is one forward, backward and Adam step.

The optimizer is optax's ``adam`` (b1 0.9, b2 0.999, eps 1e-8 outside
the square root), written out in optax's order of operations
(:class:`Adam`), behind optax's ``clip_by_global_norm``, which scales by
``c / norm`` only when ``norm >= c``; ``grad_gnorm`` is the norm before
the clip.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch._device import resolve_device
from ray_tpu_torch.core import device_telemetry as _dt
from ray_tpu_torch.rllib.env import Box, Discrete
from ray_tpu_torch.rllib.models import Categorical, DiagGaussian, FCNet
from ray_tpu_torch.rllib.postprocessing import compute_gae
from ray_tpu_torch.rllib.sample_batch import SampleBatch


def rescale_actions(act: np.ndarray, low: np.ndarray, high: np.ndarray
                    ) -> np.ndarray:
    """tanh-scale [-1, 1] -> env scale (no-op for unbounded spaces)."""
    if np.all(np.isfinite(low)) and np.all(np.isfinite(high)):
        return (low + (act + 1.0) * 0.5 * (high - low)).astype(np.float32)
    return act


def normalize_actions(act: np.ndarray, low: np.ndarray, high: np.ndarray
                      ) -> np.ndarray:
    """Env scale -> tanh-scale [-1, 1]: actors/critics operate entirely
    in [-1, 1]; replay stores what the env consumed."""
    if np.all(np.isfinite(low)) and np.all(np.isfinite(high)):
        return (2.0 * (act - low) / (high - low) - 1.0).astype(np.float32)
    return act


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    """optax ``global_norm``: the l2 norm of all tensors together."""
    return torch.sqrt(sum(torch.sum(t * t) for t in tensors))


def clip_by_global_norm_(tensors: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax ``clip_by_global_norm`` in place: unchanged while
    ``norm < max_norm``, else ``t / norm * max_norm`` (no epsilon, unlike
    ``torch.nn.utils.clip_grad_norm_``).  No host sync."""
    keep = norm < max_norm
    for t in tensors:
        t.copy_(torch.where(keep, t, t / norm * max_norm))


class Adam(torch.optim.Optimizer):
    """optax's ``adam`` in its own order of operations: ``mu = (1 - b1) g
    + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, each divided by its bias
    correction ``1 - b^t`` (in f32), the update ``mu_hat / (sqrt(nu_hat)
    + eps)`` scaled by ``-lr`` and added.  ``torch.optim.Adam`` computes
    the same formula in another order (a lerp for ``mu``, the corrections
    folded into the step size); over PPO's 64 updates at the CPU tests'
    size its stats then drifted from the JAX package's by up to 1.5e-5
    relative, this order's by 3e-7.  One multi-tensor (``_foreach``)
    launch per operation across all parameters.  ``weight_decay`` makes
    it optax's ``adamw``: ``weight_decay * p`` added to each update
    before the ``-lr`` scale (every tensor decays, optax's default)."""

    def __init__(self, params, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None) -> None:
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            lr, b1, b2, eps = (group[k] for k in ("lr", "b1", "b2", "eps"))
            for p in params:
                if not self.state[p]:
                    self.state[p].update(count=0, mu=torch.zeros_like(p),
                                         nu=torch.zeros_like(p))
            grads = [p.grad for p in params]
            mu = torch._foreach_add(
                torch._foreach_mul(grads, 1 - b1),
                torch._foreach_mul([self.state[p]["mu"] for p in params],
                                   b1))
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2),
                torch._foreach_mul([self.state[p]["nu"] for p in params],
                                   b2))
            count = self.state[params[0]]["count"] + 1
            one = np.float32(1)
            bc1 = float(one - np.float32(b1) ** np.float32(count))
            bc2 = float(one - np.float32(b2) ** np.float32(count))
            denom = torch._foreach_add(
                torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
            updates = torch._foreach_div(torch._foreach_div(mu, bc1), denom)
            decay = group.get("weight_decay", 0.0)
            if decay:
                updates = torch._foreach_add(
                    updates, torch._foreach_mul(params, decay))
            updates = torch._foreach_mul(updates, -lr)
            torch._foreach_add_(params, updates)
            for p, m, n in zip(params, mu, nu):
                self.state[p].update(count=count, mu=m, nu=n)


def _to_numpy(tree: Any) -> Any:
    """Tensors in a (nested) state dict as numpy copies on the host."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True).numpy()
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_numpy(v) for v in tree)
    return tree


def _to_tensors(tree: Any) -> Any:
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_tensors(v) for v in tree)
    return tree


class TorchPolicy:
    """Base class; algorithms override :meth:`loss` (and optionally
    :meth:`learn_on_batch` for multi-epoch schemes)."""

    def __init__(self, observation_space, action_space,
                 config: Dict[str, Any]):
        self.observation_space = observation_space
        self.action_space = action_space
        self.config = config
        if isinstance(action_space, Discrete):
            self.dist = Categorical
            num_outputs = action_space.n
        elif isinstance(action_space, Box):
            self.dist = DiagGaussian
            num_outputs = 2 * int(np.prod(action_space.shape))
        else:
            raise ValueError(f"unsupported action space {action_space!r}")
        # samplers pin to host CPU (config "_device": "cpu") so rollout
        # actor fleets never contend for the card; the learner takes
        # the card unless its config names the CPU
        self.device = resolve_device(config.get("_device"))
        seed = int(config.get("seed", 0) or 0)
        obs_dim = int(np.prod(observation_space.shape))
        model_cfg = config.get("model", {})
        self.recurrent = bool(model_cfg.get("use_lstm", False)
                              or model_cfg.get("use_attention", False))
        if model_cfg.get("use_attention", False):
            from ray_tpu_torch.rllib.models import AttentionNet

            self.model = AttentionNet(
                obs_dim, num_outputs,
                dim=int(model_cfg.get("attention_dim", 64)),
                num_layers=int(model_cfg.get(
                    "attention_num_transformer_units", 2)),
                memory_len=int(model_cfg.get("attention_memory_inference",
                                             16)),
                heads=int(model_cfg.get("attention_num_heads", 4)),
                seed=seed)
        elif self.recurrent:
            from ray_tpu_torch.rllib.models import LSTMNet

            self.model = LSTMNet(
                obs_dim, num_outputs,
                cell_size=int(model_cfg.get("lstm_cell_size", 64)),
                embed_size=int(model_cfg.get("fcnet_hiddens",
                                             (64,))[-1]),
                activation=model_cfg.get("fcnet_activation", "tanh"),
                seed=seed)
        else:
            self.model = FCNet(
                obs_dim, num_outputs,
                hiddens=tuple(model_cfg.get("fcnet_hiddens", (64, 64))),
                activation=model_cfg.get("fcnet_activation", "tanh"),
                vf_share_layers=bool(model_cfg.get("vf_share_layers",
                                                   False)),
                seed=seed)
        self.model.to(self.device)
        self._gen = torch.Generator(device=self.device).manual_seed(seed)
        self.opt = self._make_optimizer()
        self._np_rng = np.random.default_rng(seed)
        if self.recurrent:
            #: set by the sampler before postprocess_trajectory so the
            #: truncation bootstrap evaluates V(s_last | carry)
            self._bootstrap_state: Optional[Tuple] = None
            self._act_rnn = _dt.instrument_step(
                self._act_rnn_impl, name="torch_policy.act_rnn")
            self._values_rnn = _dt.instrument_step(
                self._values_rnn_impl, name="torch_policy.values_rnn")
        else:
            self._act = _dt.instrument_step(self._act_impl,
                                            name="torch_policy.act")
            self._values = _dt.instrument_step(
                self._values_impl, name="torch_policy.values")
        self._update = _dt.instrument_step(self._update_impl,
                                           name="torch_policy.update")
        self._grads = _dt.instrument_step(self._grads_impl,
                                          name="torch_policy.grads")

    # -- overridables ---------------------------------------------------
    def _make_optimizer(self) -> torch.optim.Optimizer:
        """optax's ``adam(lr)`` (the clip is :meth:`_clip_gradients`)."""
        return Adam(self.model.parameters(),
                    lr=float(self.config.get("lr", 5e-4)))

    def loss(self, batch: Dict[str, torch.Tensor]
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        raise NotImplementedError

    # -- acting (eager forwards under no_grad) ---------------------------
    def _greedy(self, dist_inputs: torch.Tensor) -> torch.Tensor:
        if self.dist is Categorical:
            return torch.argmax(dist_inputs, dim=-1)
        return torch.chunk(dist_inputs, 2, dim=-1)[0]

    def _heads(self, dist_inputs, vf, explore: bool):
        if not explore:
            return self._greedy(dist_inputs), None, vf
        actions = self.dist.sample(dist_inputs, self._gen)
        return actions, self.dist.logp(dist_inputs, actions), vf

    def _act_impl(self, obs: torch.Tensor, explore: bool):
        with torch.no_grad():
            dist_inputs, vf = self.model(obs)
            return self._heads(dist_inputs, vf, explore)

    def _act_rnn_impl(self, obs: torch.Tensor, carry, explore: bool):
        with torch.no_grad():
            dist_inputs, vf, carry = self.model(obs[:, None], carry)
            return self._heads(dist_inputs[:, 0], vf[:, 0],
                               explore) + (carry,)

    def _values_impl(self, obs: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return self.model(obs)[1]

    def _values_rnn_impl(self, obs: torch.Tensor, carry) -> torch.Tensor:
        with torch.no_grad():
            return self.model(obs[:, None], carry)[1][:, 0]

    def _tensor(self, x, dtype=torch.float32) -> torch.Tensor:
        # a copy: arrays from the object store are read-only
        return torch.as_tensor(np.array(x, dtype=np.float32), dtype=dtype,
                               device=self.device)

    # -- recurrent surface ----------------------------------------------
    def get_initial_state(self, batch: int) -> Tuple[np.ndarray, ...]:
        """Zero recurrent carry for ``batch`` parallel envs (reference
        ``Policy.get_initial_state``) — LSTM (c, h) or attention
        (memory, count); both are pairs of per-env arrays."""
        return tuple(c.numpy() for c in self.model.initial_carry(batch))

    def compute_actions_rnn(self, obs: np.ndarray, state: Tuple,
                            explore: bool = True):
        """One env tick with carry: returns (actions, state_out, extras);
        extras carry the *input* state columns for sequence training."""
        carry = (self._tensor(state[0]), self._tensor(state[1]))
        actions, logp, vf, (c2, h2) = self._act_rnn(
            self._tensor(obs), carry, explore)
        extras = {SampleBatch.VF_PREDS: vf.cpu().numpy(),
                  "state_in_c": np.asarray(state[0]),
                  "state_in_h": np.asarray(state[1])}
        if explore:
            extras = {SampleBatch.ACTION_LOGP: logp.cpu().numpy(), **extras}
        # writable copies: the sampler zeroes per-env rows on resets
        return (actions.cpu().numpy(),
                (c2.cpu().numpy().copy(), h2.cpu().numpy().copy()), extras)

    # -- acting ---------------------------------------------------------
    def compute_actions(self, obs: np.ndarray, explore: bool = True
                        ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        actions, logp, vf = self._act(self._tensor(obs), explore)
        extras = {SampleBatch.VF_PREDS: vf.cpu().numpy()}
        if explore:
            extras = {SampleBatch.ACTION_LOGP: logp.cpu().numpy(), **extras}
        return actions.cpu().numpy(), extras

    def compute_values(self, obs: np.ndarray) -> np.ndarray:
        return self._values(self._tensor(obs)).cpu().numpy()

    # -- learning -------------------------------------------------------
    def _params(self) -> List[torch.nn.Parameter]:
        return [p for p in self.model.parameters() if p.requires_grad]

    def _loss_and_grads(self, batch):
        self.opt.zero_grad(set_to_none=False)
        loss, stats = self.loss(batch)
        loss.backward()
        stats = dict(stats)
        stats["total_loss"] = loss.detach()
        for p in self._params():
            if p.grad is None:  # outside this loss: a zero gradient, as
                p.grad = torch.zeros_like(p)  # optax gives it
        return [p.grad for p in self._params()], stats

    def _clip_gradients(self, grads: List[torch.Tensor],
                        norm: Optional[torch.Tensor] = None) -> None:
        clip = float(self.config.get("grad_clip", 0) or 0)
        if clip:
            norm = global_norm(grads) if norm is None else norm
            clip_by_global_norm_(grads, clip, norm)

    def _update_impl(self, batch):
        grads, stats = self._loss_and_grads(batch)
        stats["grad_gnorm"] = global_norm(grads)
        self._clip_gradients(grads, stats["grad_gnorm"])
        self.opt.step()
        return stats

    def _grads_impl(self, batch):
        grads, stats = self._loss_and_grads(batch)
        return [g.detach().clone() for g in grads], stats

    def compute_gradients(self, batch: SampleBatch):
        """Gradients without applying them (reference
        ``Policy.compute_gradients`` — the A3C path where workers compute
        grads and the driver applies them asynchronously): one numpy
        array per trainable parameter, in ``named_parameters`` order."""
        grads, stats = self._grads(self._device_batch(batch))
        return ([g.cpu().numpy() for g in grads],
                {k: float(v) for k, v in stats.items()})

    def apply_gradients(self, grads) -> None:
        """Clip and one optimizer step on ``grads``, one array or tensor
        per trainable parameter in :meth:`_params` order."""
        for p, g in zip(self._params(), grads):
            if not isinstance(g, torch.Tensor):
                g = np.asarray(g)
            p.grad = torch.as_tensor(g, dtype=p.dtype,
                                     device=self.device).clone()
        self._clip_gradients([p.grad for p in self._params()])
        self.opt.step()

    def _device_batch(self, batch) -> Dict[str, torch.Tensor]:
        """The batch's columns as tensors on the policy's device; f64
        columns become f32, as the JAX package's arrays are."""
        out = {}
        for k, v in batch.items():
            v = np.asarray(v)
            if v.dtype == object:
                continue
            if v.dtype == np.float64:
                v = v.astype(np.float32)
            elif not v.flags.writeable:  # from the object store
                v = v.copy()
            out[k] = torch.as_tensor(v, device=self.device)
        return out

    def learn_on_batch(self, batch: SampleBatch) -> Dict[str, float]:
        """One SGD step on the whole batch; PPO-style algorithms override
        with epoch/minibatch schedules."""
        stats = self._update(self._device_batch(batch))
        return {k: float(v) for k, v in stats.items()}

    # -- trajectory postprocessing -------------------------------------
    def postprocess_trajectory(self, batch: SampleBatch,
                               last_obs: Optional[np.ndarray] = None,
                               truncated: bool = False) -> SampleBatch:
        """Default: GAE advantages (reference ``postprocessing.py``)."""
        if truncated and last_obs is not None:
            if self.recurrent:
                state = self._bootstrap_state or self.get_initial_state(1)
                last_value = float(self._values_rnn(
                    self._tensor(last_obs[None]),
                    (self._tensor(state[0]), self._tensor(state[1])))[0])
            else:
                last_value = float(self.compute_values(last_obs[None])[0])
        else:
            last_value = 0.0
        return compute_gae(
            batch, last_value,
            gamma=float(self.config.get("gamma", 0.99)),
            lambda_=float(self.config.get("lambda_", 0.95)),
            use_gae=bool(self.config.get("use_gae", True)))

    # -- weights --------------------------------------------------------
    def get_weights(self) -> Dict[str, np.ndarray]:
        """The model's ``state_dict`` as numpy arrays on the host."""
        return _to_numpy(self.model.state_dict())

    def set_weights(self, weights) -> None:
        self.model.load_state_dict(_to_tensors(dict(weights)))

    def get_state(self) -> Dict[str, Any]:
        return {"weights": self.get_weights(),
                "opt_state": _to_numpy(self.opt.state_dict())}

    def set_state(self, state: Dict[str, Any]) -> None:
        self.set_weights(state["weights"])
        # load_state_dict moves each moment to its parameter's device
        self.opt.load_state_dict(_to_tensors(state["opt_state"]))
