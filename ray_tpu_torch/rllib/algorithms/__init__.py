"""Algorithm zoo (reference ``rllib/algorithms/``).

PPO is ported.  The JAX package's other algorithms are not yet: their
names raise ``NotImplementedError`` naming the ROADMAP.md item that
brings them (queue 1, item 6).
"""

from ray_tpu_torch import _port
from ray_tpu_torch.rllib.algorithms.ppo import (  # noqa: F401
    PPO,
    PPOConfig,
    PPOPolicy,
)

#: the JAX package's algorithm names that later slices bring, by module
_LATER = {
    "A2C": "pg",
    "A2CConfig": "pg",
    "A2CPolicy": "pg",
    "A3C": "pg",
    "A3CConfig": "pg",
    "APPO": "impala",
    "APPOConfig": "impala",
    "APPOPolicy": "impala",
    "ARS": "es",
    "ARSConfig": "es",
    "AlphaStar": "alpha_star",
    "AlphaStarConfig": "alpha_star",
    "AlphaZero": "alpha_zero",
    "AlphaZeroConfig": "alpha_zero",
    "ApexDDPG": "ddpg",
    "ApexDDPGConfig": "ddpg",
    "ApexDQN": "dqn",
    "ApexDQNConfig": "dqn",
    "BC": "marwil",
    "BCConfig": "marwil",
    "BanditLinTS": "bandit",
    "BanditLinTSConfig": "bandit",
    "BanditLinUCB": "bandit",
    "BanditLinUCBConfig": "bandit",
    "CQL": "cql",
    "CQLConfig": "cql",
    "CQLPolicy": "cql",
    "CRR": "crr",
    "CRRConfig": "crr",
    "CRRPolicy": "crr",
    "DDPG": "ddpg",
    "DDPGConfig": "ddpg",
    "DDPGPolicy": "ddpg",
    "DDPPO": "ddppo",
    "DDPPOConfig": "ddppo",
    "DQN": "dqn",
    "DQNConfig": "dqn",
    "DQNPolicy": "dqn",
    "DT": "dt",
    "DTConfig": "dt",
    "Dreamer": "dreamer",
    "DreamerConfig": "dreamer",
    "ES": "es",
    "ESConfig": "es",
    "IMPALA": "impala",
    "ImpalaConfig": "impala",
    "ImpalaPolicy": "impala",
    "MADDPG": "maddpg",
    "MADDPGConfig": "maddpg",
    "MAML": "maml",
    "MAMLConfig": "maml",
    "MAMLPolicy": "maml",
    "MARWIL": "marwil",
    "MARWILConfig": "marwil",
    "MARWILPolicy": "marwil",
    "MBMPO": "mbmpo",
    "MBMPOConfig": "mbmpo",
    "MBMPOPolicy": "mbmpo",
    "PG": "pg",
    "PGConfig": "pg",
    "PGPolicy": "pg",
    "QMix": "qmix",
    "QMixConfig": "qmix",
    "R2D2": "r2d2",
    "R2D2Config": "r2d2",
    "R2D2Policy": "r2d2",
    "RepeatedRPS": "alpha_star",
    "SAC": "sac",
    "SACConfig": "sac",
    "SACPolicy": "sac",
    "SimpleQ": "dqn",
    "SimpleQConfig": "dqn",
    "SimpleRecEnv": "slateq",
    "SimpleTargetChase": "maddpg",
    "SlateQ": "slateq",
    "SlateQConfig": "slateq",
    "TD3": "ddpg",
    "TD3Config": "ddpg",
}


def __getattr__(name: str):
    if name in _LATER:
        raise _port.not_ported(
            f"ray_tpu_torch.rllib.algorithms.{name} "
            f"(algorithms/{_LATER[name]}.py)", "queue 1, item 6")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
