"""Environment API and built-in envs.

Parity: reference ``rllib/env/`` — RLlib consumes gym-style envs
(``reset() -> (obs, info)``, ``step(a) -> (obs, reward, terminated,
truncated, info)``).  gym/gymnasium is not a dependency here: any object
with that interface works, and we ship pure-python reference envs
(CartPole — the classic control benchmark used by the reference's tuned
examples — and a RandomEnv for plumbing tests).

Spaces are the minimal ``Discrete``/``Box`` pair the policies need.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class Discrete:
    n: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return ()

    def sample(self, rng: np.random.Generator):
        return int(rng.integers(self.n))


@dataclasses.dataclass(frozen=True)
class Box:
    low: Any
    high: Any
    shape: Tuple[int, ...]
    dtype: Any = np.float32

    def sample(self, rng: np.random.Generator):
        return rng.uniform(self.low, self.high, size=self.shape) \
            .astype(self.dtype)


class CartPole:
    """Classic cart-pole balancing (standard Barto-Sutton-Anderson
    dynamics, Euler integration, same constants as the gym version so
    learning curves are comparable)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.length = 0.5  # half pole length
        self.force_mag = 10.0
        self.tau = 0.02
        self.x_threshold = 2.4
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.max_episode_steps = int(config.get("max_episode_steps", 500))
        self.observation_space = Box(-np.inf, np.inf, (4,), np.float32)
        self.action_space = Discrete(2)
        self._rng = np.random.default_rng(config.get("seed"))
        self._state = None
        self._steps = 0

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform(-0.05, 0.05, size=(4,))
        self._steps = 0
        return self._state.astype(np.float32).copy(), {}

    def step(self, action):
        x, x_dot, theta, theta_dot = self._state
        force = self.force_mag if action == 1 else -self.force_mag
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot ** 2 * sintheta) \
            / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0
                           - self.masspole * costheta ** 2 / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self._state = np.array([x, x_dot, theta, theta_dot])
        self._steps += 1
        terminated = bool(abs(x) > self.x_threshold
                          or abs(theta) > self.theta_threshold)
        truncated = self._steps >= self.max_episode_steps
        return (self._state.astype(np.float32).copy(), 1.0, terminated,
                truncated, {})


class Pendulum:
    """Classic pendulum swing-up (standard dynamics, same constants as
    the gym version) — the canonical continuous-control smoke env."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.max_speed = 8.0
        self.max_torque = 2.0
        self.mass = 1.0
        self.dt = 0.05
        self.observation_space = Box(-np.inf, np.inf, (3,), np.float32)
        self.action_space = Box(-self.max_torque, self.max_torque, (1,),
                                np.float32)
        self._rng = np.random.default_rng(config.get("seed"))
        self.max_episode_steps = int(config.get("max_episode_steps", 200))

    def _obs(self):
        th, thdot = self._state
        return np.array([np.cos(th), np.sin(th), thdot], np.float32)

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._state = self._rng.uniform([-np.pi, -1.0], [np.pi, 1.0])
        self._steps = 0
        return self._obs(), {}

    def step(self, action):
        th, thdot = self._state
        u = float(np.clip(np.asarray(action).reshape(-1)[0],
                          -self.max_torque, self.max_torque))
        norm_th = ((th + np.pi) % (2 * np.pi)) - np.pi
        cost = norm_th ** 2 + 0.1 * thdot ** 2 + 0.001 * u ** 2
        # thdot += (3g/(2l) sin th + 3/(m l^2) u) dt with g=10, l=1
        thdot = np.clip(
            thdot + (3 * 10.0 / 2 * np.sin(th)
                     + 3.0 / self.mass * u) * self.dt,
            -self.max_speed, self.max_speed)
        th = th + thdot * self.dt
        self._state = (th, thdot)
        self._steps += 1
        return (self._obs(), -cost, False,
                self._steps >= self.max_episode_steps, {})


class RandomEnv:
    """Uniform-random observations/rewards; for plumbing tests."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.observation_space = Box(-1.0, 1.0,
                                     tuple(config.get("obs_shape", (4,))),
                                     np.float32)
        self.action_space = Discrete(int(config.get("num_actions", 2)))
        self.episode_len = int(config.get("episode_len", 10))
        self._rng = np.random.default_rng(config.get("seed"))
        self._steps = 0

    def reset(self, *, seed: Optional[int] = None):
        self._steps = 0
        return self.observation_space.sample(self._rng), {}

    def step(self, action):
        self._steps += 1
        return (self.observation_space.sample(self._rng),
                float(self._rng.random()),
                False, self._steps >= self.episode_len, {})


class MultiAgentEnv:
    """Base class for multi-agent environments (reference
    ``rllib/env/multi_agent_env.py``): dict-keyed observations/actions
    per agent id; ``step`` returns per-agent dicts plus the ``__all__``
    key in the terminated/truncated dicts.  Agents may appear and
    disappear between steps (only act for agents present in obs)."""

    #: per-agent spaces; override or fill in __init__
    observation_spaces: Dict[Any, Any]
    action_spaces: Dict[Any, Any]

    def observation_space_for(self, agent_id) -> Any:
        return self.observation_spaces[agent_id]

    def action_space_for(self, agent_id) -> Any:
        return self.action_spaces[agent_id]

    @property
    def agent_ids(self):
        return list(self.observation_spaces)

    def reset(self, *, seed: Optional[int] = None):
        raise NotImplementedError

    def step(self, action_dict: Dict[Any, Any]):
        raise NotImplementedError


class MultiAgentCartPole(MultiAgentEnv):
    """N independent cart-poles, one per agent (the reference's standard
    multi-agent smoke env, ``rllib/examples/env/multi_agent.py``)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.num_agents = int(config.get("num_agents", 2))
        seed = config.get("seed")
        self._envs = {
            i: CartPole(dict(config,
                             seed=None if seed is None else seed + i))
            for i in range(self.num_agents)}
        self.observation_spaces = {
            i: e.observation_space for i, e in self._envs.items()}
        self.action_spaces = {
            i: e.action_space for i, e in self._envs.items()}

    def reset(self, *, seed: Optional[int] = None):
        self._done = {i: False for i in self._envs}
        obs, infos = {}, {}
        for i, e in self._envs.items():
            obs[i], infos[i] = e.reset(seed=seed)
        return obs, infos

    def step(self, action_dict):
        obs, rew, term, trunc, info = {}, {}, {}, {}, {}
        for i, a in action_dict.items():
            if self._done[i]:
                continue
            obs[i], rew[i], term[i], trunc[i], info[i] = \
                self._envs[i].step(a)
            if term[i] or trunc[i]:
                self._done[i] = True
        term["__all__"] = all(self._done.values())
        trunc["__all__"] = False
        return obs, rew, term, trunc, info


class TwoStepGame(MultiAgentEnv):
    """Cooperative 2-agent matrix game with a state transition (the QMIX
    paper's didactic env; reference ``rllib/examples/env/two_step_game.py``).

    Step 1: agent_0's action picks the second-stage game (0 -> 2A,
    1 -> 2B).  Step 2A: any joint action pays 7.  Step 2B: payoff
    [[0, 1], [1, 8]] — the global optimum (8) needs coordinated (1, 1),
    which value-decomposition without a state-conditioned mixer cannot
    represent.  Team reward is shared; per-agent obs is the one-hot
    state plus the agent id.
    """

    PAYOFF_2B = [[0.0, 1.0], [1.0, 8.0]]

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        self.state = 0  # 0 = step1, 1 = 2A, 2 = 2B
        obs_space = Box(0.0, 1.0, (4,))
        act_space = Discrete(2)
        self.observation_spaces = {0: obs_space, 1: obs_space}
        self.action_spaces = {0: act_space, 1: act_space}

    def _obs(self):
        out = {}
        for aid in (0, 1):
            v = np.zeros(4, np.float32)
            v[self.state] = 1.0
            v[3] = float(aid)
            out[aid] = v
        return out

    def global_state(self) -> np.ndarray:
        v = np.zeros(3, np.float32)
        v[self.state] = 1.0
        return v

    def reset(self, *, seed: Optional[int] = None):
        self.state = 0
        return self._obs(), {0: {}, 1: {}}

    def step(self, action_dict):
        a0, a1 = int(action_dict[0]), int(action_dict[1])
        if self.state == 0:
            self.state = 1 if a0 == 0 else 2
            rew, done = 0.0, False
        elif self.state == 1:
            rew, done = 7.0, True
        else:
            rew, done = self.PAYOFF_2B[a0][a1], True
        obs = self._obs()
        rews = {0: rew / 2.0, 1: rew / 2.0}  # shared team reward
        terms = {0: done, 1: done, "__all__": done}
        truncs = {0: False, 1: False, "__all__": False}
        return obs, rews, terms, truncs, {0: {}, 1: {}}


class PixelCatch:
    """Catch on an HxW pixel grid: a ball falls one row per step, the
    paddle on the bottom row moves left/stay/right; +1 for catching,
    -1 for missing.  The tiny standard pixel-control smoke benchmark
    (bsuite catch) — observations are IMAGES [H, W, 1], exercising conv
    encoder/decoder paths."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.h = int(config.get("height", 8))
        self.w = int(config.get("width", 8))
        #: dense per-step alignment reward (smoke-test mode); the
        #: classic game keeps only the terminal +-1
        self.shaped = bool(config.get("shaped", False))
        self._rng = np.random.default_rng(int(config.get("seed", 0) or 0))
        self.observation_space = Box(0.0, 1.0, (self.h, self.w, 1))
        self.action_space = Discrete(3)  # left, stay, right
        self._ball = (0, 0)
        self._paddle = 0

    def _obs(self) -> np.ndarray:
        img = np.zeros((self.h, self.w, 1), np.float32)
        img[self._ball[0], self._ball[1], 0] = 1.0
        img[self.h - 1, self._paddle, 0] = 1.0
        return img

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._ball = (0, int(self._rng.integers(self.w)))
        self._paddle = self.w // 2
        return self._obs(), {}

    def step(self, action: int):
        self._paddle = int(np.clip(self._paddle + int(action) - 1,
                                   0, self.w - 1))
        row, col = self._ball
        self._ball = (row + 1, col)
        if self._ball[0] >= self.h - 1:
            rew = 1.0 if self._ball[1] == self._paddle else -1.0
            self._ball = (self.h - 1, self._ball[1])
            return self._obs(), rew, True, False, {}
        rew = 0.0
        if self.shaped:
            rew = 0.1 if self._paddle == col else -0.1
        return self._obs(), rew, False, False, {}


class RepeatPrevEnv:
    """Reward for repeating the PREVIOUS observation's bit — unsolvable
    without memory; the standard recurrent-policy benchmark (reference
    ``rllib/examples/env/repeat_after_me_env.py``)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.observation_space = Box(0.0, 1.0, (2,), np.float32)
        self.action_space = Discrete(2)
        self._rng = np.random.default_rng(int(config.get("seed", 0) or 0))
        self.episode_len = int(config.get("episode_len", 20))

    def _obs(self):
        onehot = np.zeros(2, np.float32)
        onehot[self._bit] = 1.0
        return onehot

    def reset(self, *, seed: Optional[int] = None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._bit = int(self._rng.integers(2))
        self._prev = None
        self._steps = 0
        return self._obs(), {}

    def step(self, action):
        rew = 1.0 if self._prev is not None and int(action) == self._prev \
            else 0.0
        self._prev = self._bit
        self._bit = int(self._rng.integers(2))
        self._steps += 1
        return self._obs(), rew, False, self._steps >= self.episode_len, {}


class TaskSettableEnv:
    """Meta-RL task interface (reference
    ``rllib/env/apis/task_settable_env.py``): an env family indexed by a
    task parameter; MAML/MBMPO sample a task batch per meta-iteration."""

    def sample_tasks(self, n_tasks: int):
        raise NotImplementedError

    def set_task(self, task) -> None:
        raise NotImplementedError

    def get_task(self):
        raise NotImplementedError


class CartPoleMass(CartPole, TaskSettableEnv):
    """CartPole with the cart mass as the task (reference
    ``rllib/examples/env/cartpole_mass.py``) — the standard MAML
    adaptation benchmark: dynamics change across tasks, the reward
    structure does not."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        super().__init__(config)
        config = config or {}
        self._task_rng = np.random.default_rng(
            int(config.get("task_seed", 0) or 0))
        self._task_low = float(config.get("mass_low", 0.5))
        self._task_high = float(config.get("mass_high", 2.0))

    def sample_tasks(self, n_tasks: int):
        return list(self._task_rng.uniform(
            self._task_low, self._task_high, size=n_tasks))

    def set_task(self, task) -> None:
        self.masscart = float(task)

    def get_task(self):
        return self.masscart


class PendulumMass(Pendulum, TaskSettableEnv):
    """Pendulum with the pole mass as the task (reference
    ``rllib/examples/env/pendulum_mass.py``)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        super().__init__(config)
        config = config or {}
        self._task_rng = np.random.default_rng(
            int(config.get("task_seed", 0) or 0))
        self._task_low = float(config.get("mass_low", 0.5))
        self._task_high = float(config.get("mass_high", 1.5))

    def sample_tasks(self, n_tasks: int):
        return list(self._task_rng.uniform(
            self._task_low, self._task_high, size=n_tasks))

    def set_task(self, task) -> None:
        self.mass = float(task)

    def get_task(self):
        return self.mass


class ContextBandit:
    """Contextual bandit: reward 1 when the chosen arm matches the
    argmax context feature; every step is its own (truncated) episode.
    The standard smoke env for the bandit algorithms (reference
    ``rllib/examples/env/bandit_envs_discrete.py``)."""

    def __init__(self, config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.k = int(config.get("arms", 3))
        self.observation_space = Box(0.0, 1.0, (self.k,), np.float32)
        self.action_space = Discrete(self.k)
        self._rng = np.random.default_rng(int(config.get("seed", 0) or 0))
        self._ctx: Optional[np.ndarray] = None

    def reset(self, *, seed: Optional[int] = None, options=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._ctx = self._rng.random(self.k).astype(np.float32)
        return self._ctx, {}

    def step(self, action: int):
        rew = 1.0 if int(action) == int(self._ctx.argmax()) else 0.0
        self._ctx = self._rng.random(self.k).astype(np.float32)
        return self._ctx, rew, False, True, {}


class VectorEnv:
    """Batched environment surface for the decoupled RL pipeline
    (docs/rl_pipeline.md): N sub-environments step as ONE call over
    stacked arrays, so a vectorized env actor's per-tick host cost is a
    few numpy passes instead of N python loops.

    Contract (auto-reset semantics, the Podracer/EnvPool shape):

    ``reset_all() -> obs [N, ...]``
        (Re)start every sub-env.
    ``step(actions [N]) -> (obs, rewards, terminateds, truncateds)``
        One tick for all N sub-envs.  A done sub-env resets
        *immediately* and ``obs`` carries the FIRST observation of its
        next episode; its final observation is in ``final_obs`` rows
        where ``terminateds | truncateds``.
    ``final_obs [N, ...]``
        Valid only at rows that finished this tick (bootstrap source
        for truncated episodes).
    """

    num_envs: int
    observation_space: Any
    action_space: Any
    final_obs: np.ndarray

    def reset_all(self) -> np.ndarray:
        raise NotImplementedError

    def step(self, actions: np.ndarray):
        raise NotImplementedError


class SyncVectorEnv(VectorEnv):
    """Generic fallback: wraps N scalar gym-style envs in a python loop.
    Correct for any registered env; CartPoleVector shows the fully
    vectorized fast path."""

    def __init__(self, envs: List[Any]):
        self.envs = envs
        self.num_envs = len(envs)
        self.observation_space = envs[0].observation_space
        self.action_space = envs[0].action_space
        obs_shape = tuple(self.observation_space.shape)
        self.final_obs = np.zeros((self.num_envs,) + obs_shape, np.float32)

    def reset_all(self) -> np.ndarray:
        return np.stack([e.reset()[0] for e in self.envs])

    def step(self, actions: np.ndarray):
        n = self.num_envs
        obs = [None] * n
        rew = np.zeros(n, np.float32)
        term = np.zeros(n, bool)
        trunc = np.zeros(n, bool)
        for i, env in enumerate(self.envs):
            o, r, te, tr, _ = env.step(actions[i])
            rew[i], term[i], trunc[i] = r, te, tr
            if te or tr:
                self.final_obs[i] = o
                o = env.reset()[0]
            obs[i] = o
        return np.stack(obs), rew, term, trunc


class CartPoleVector(VectorEnv):
    """CartPole dynamics over [N, 4] state arrays: one numpy pass steps
    every sub-env (same constants as :class:`CartPole`, so learning
    curves are comparable)."""

    def __init__(self, num_envs: int,
                 config: Optional[Dict[str, Any]] = None):
        config = config or {}
        self.num_envs = int(num_envs)
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.length = 0.5
        self.force_mag = 10.0
        self.tau = 0.02
        self.x_threshold = 2.4
        self.theta_threshold = 12 * 2 * np.pi / 360
        self.max_episode_steps = int(config.get("max_episode_steps", 500))
        self.observation_space = Box(-np.inf, np.inf, (4,), np.float32)
        self.action_space = Discrete(2)
        self._rng = np.random.default_rng(config.get("seed"))
        self._state = np.zeros((self.num_envs, 4))
        self._steps = np.zeros(self.num_envs, np.int64)
        self.final_obs = np.zeros((self.num_envs, 4), np.float32)

    def reset_all(self) -> np.ndarray:
        self._state = self._rng.uniform(-0.05, 0.05,
                                        size=(self.num_envs, 4))
        self._steps[:] = 0
        return self._state.astype(np.float32)

    def step(self, actions: np.ndarray):
        x, x_dot, theta, theta_dot = self._state.T
        force = np.where(np.asarray(actions).reshape(-1) == 1,
                         self.force_mag, -self.force_mag)
        costheta, sintheta = np.cos(theta), np.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = (force + polemass_length * theta_dot ** 2 * sintheta) \
            / total_mass
        thetaacc = (self.gravity * sintheta - costheta * temp) / (
            self.length * (4.0 / 3.0
                           - self.masspole * costheta ** 2 / total_mass))
        xacc = temp - polemass_length * thetaacc * costheta / total_mass
        x = x + self.tau * x_dot
        x_dot = x_dot + self.tau * xacc
        theta = theta + self.tau * theta_dot
        theta_dot = theta_dot + self.tau * thetaacc
        self._state = np.stack([x, x_dot, theta, theta_dot], axis=1)
        self._steps += 1
        term = (np.abs(x) > self.x_threshold) \
            | (np.abs(theta) > self.theta_threshold)
        trunc = (~term) & (self._steps >= self.max_episode_steps)
        rew = np.ones(self.num_envs, np.float32)
        done = term | trunc
        if done.any():
            obs = self._state.astype(np.float32)
            self.final_obs[done] = obs[done]
            k = int(done.sum())
            self._state[done] = self._rng.uniform(-0.05, 0.05, size=(k, 4))
            self._steps[done] = 0
        return self._state.astype(np.float32), rew, term, trunc


#: env name/class -> natively vectorized implementation
_VECTOR_REGISTRY: Dict[Any, Any] = {}


def register_vector_env(env: Any, vector_cls: Any) -> None:
    """Register a natively vectorized implementation for an env name or
    class: ``vector_cls(num_envs, config)`` -> :class:`VectorEnv`."""
    _VECTOR_REGISTRY[env] = vector_cls


def as_vector_env(env_spec: Any, num_envs: int,
                  config: Optional[Dict[str, Any]] = None) -> VectorEnv:
    """Best vectorized form of ``env_spec``: a registered native
    :class:`VectorEnv` when one exists, else N scalar instances behind
    :class:`SyncVectorEnv`.  Seeds fan out per sub-env like
    RolloutWorker does."""
    config = dict(config or {})
    vec = _VECTOR_REGISTRY.get(env_spec)
    if vec is None and isinstance(env_spec, str):
        vec = _VECTOR_REGISTRY.get(_ENV_REGISTRY.get(env_spec))
    if vec is None and not isinstance(env_spec, str):
        vec = _VECTOR_REGISTRY.get(getattr(env_spec, "__name__", None))
    if vec is not None:
        return vec(num_envs, config)
    seed = config.get("seed")
    envs = []
    for i in range(num_envs):
        cfg = dict(config)
        if seed is not None:
            cfg["seed"] = int(seed) + i
        envs.append(make_env(env_spec, cfg))
    return SyncVectorEnv(envs)


_ENV_REGISTRY: Dict[str, Any] = {
    "CartPole-v1": CartPole,
    "Pendulum-v1": Pendulum,
    "RandomEnv": RandomEnv,
    "MultiAgentCartPole": MultiAgentCartPole,
    "TwoStepGame": TwoStepGame,
    "PixelCatch": PixelCatch,
    "ContextBandit": ContextBandit,
    "CartPoleMass": CartPoleMass,
    "PendulumMass": PendulumMass,
    "RepeatPrevEnv": RepeatPrevEnv,
}

register_vector_env(CartPole, CartPoleVector)


def _register_extra_envs():
    """Late registration for envs defined in algorithm modules."""
    try:
        from ray_tpu_torch.rllib.algorithms.maddpg import SimpleTargetChase
        _ENV_REGISTRY.setdefault("SimpleTargetChase", SimpleTargetChase)
    except ImportError:
        pass
    try:
        from ray_tpu_torch.rllib.algorithms.alpha_star import RepeatedRPS
        _ENV_REGISTRY.setdefault("RepeatedRPS", RepeatedRPS)
    except ImportError:
        pass
    try:
        from ray_tpu_torch.rllib.algorithms.slateq import SimpleRecEnv
        _ENV_REGISTRY.setdefault("SimpleRecEnv", SimpleRecEnv)
    except ImportError:
        pass


def register_env(name: str, creator) -> None:
    """Register an env creator callable(config) -> env (parity:
    ``ray.tune.registry.register_env``)."""
    _ENV_REGISTRY[name] = creator


def make_env(env: Any, config: Optional[Dict[str, Any]] = None):
    """Instantiate from a registered name, a class, or a callable."""
    if isinstance(env, str):
        if env not in _ENV_REGISTRY:
            _register_extra_envs()
        if env not in _ENV_REGISTRY:
            raise ValueError(f"unknown env {env!r}; register_env() it "
                             f"(known: {sorted(_ENV_REGISTRY)})")
        env = _ENV_REGISTRY[env]
    return env(config or {})
