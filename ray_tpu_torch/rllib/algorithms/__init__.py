"""Algorithm zoo (reference ``rllib/algorithms/``).

Ported: PPO, IMPALA/APPO, PG/A2C/A3C, MARWIL/BC, DQN/SimpleQ/Ape-X DQN,
R2D2, SAC, DDPG/TD3/Ape-X DDPG, CQL and CRR.  The JAX package's other
algorithms are not yet: their names raise ``NotImplementedError`` naming
the ROADMAP.md item that brings them (queue 1, item 6).
"""

from ray_tpu_torch import _port
from ray_tpu_torch.rllib.algorithms.cql import (  # noqa: F401
    CQL,
    CQLConfig,
    CQLPolicy,
)
from ray_tpu_torch.rllib.algorithms.crr import (  # noqa: F401
    CRR,
    CRRConfig,
    CRRPolicy,
)
from ray_tpu_torch.rllib.algorithms.ddpg import (  # noqa: F401
    DDPG,
    TD3,
    ApexDDPG,
    ApexDDPGConfig,
    DDPGConfig,
    DDPGPolicy,
    TD3Config,
)
from ray_tpu_torch.rllib.algorithms.dqn import (  # noqa: F401
    DQN,
    ApexDQN,
    ApexDQNConfig,
    DQNConfig,
    DQNPolicy,
    SimpleQ,
    SimpleQConfig,
)
from ray_tpu_torch.rllib.algorithms.impala import (  # noqa: F401
    APPO,
    IMPALA,
    APPOConfig,
    APPOPolicy,
    ImpalaConfig,
    ImpalaPolicy,
)
from ray_tpu_torch.rllib.algorithms.marwil import (  # noqa: F401
    BC,
    MARWIL,
    BCConfig,
    MARWILConfig,
    MARWILPolicy,
)
from ray_tpu_torch.rllib.algorithms.pg import (  # noqa: F401
    A2C,
    A3C,
    PG,
    A2CConfig,
    A2CPolicy,
    A3CConfig,
    PGConfig,
    PGPolicy,
)
from ray_tpu_torch.rllib.algorithms.ppo import (  # noqa: F401
    PPO,
    PPOConfig,
    PPOPolicy,
)
from ray_tpu_torch.rllib.algorithms.r2d2 import (  # noqa: F401
    R2D2,
    R2D2Config,
    R2D2Policy,
)
from ray_tpu_torch.rllib.algorithms.sac import (  # noqa: F401
    SAC,
    SACConfig,
    SACPolicy,
)

#: the JAX package's algorithm names that later slices bring, by module
_LATER = {
    "ARS": "es",
    "ARSConfig": "es",
    "AlphaStar": "alpha_star",
    "AlphaStarConfig": "alpha_star",
    "AlphaZero": "alpha_zero",
    "AlphaZeroConfig": "alpha_zero",
    "BanditLinTS": "bandit",
    "BanditLinTSConfig": "bandit",
    "BanditLinUCB": "bandit",
    "BanditLinUCBConfig": "bandit",
    "DDPPO": "ddppo",
    "DDPPOConfig": "ddppo",
    "DT": "dt",
    "DTConfig": "dt",
    "Dreamer": "dreamer",
    "DreamerConfig": "dreamer",
    "ES": "es",
    "ESConfig": "es",
    "MADDPG": "maddpg",
    "MADDPGConfig": "maddpg",
    "MAML": "maml",
    "MAMLConfig": "maml",
    "MAMLPolicy": "maml",
    "MBMPO": "mbmpo",
    "MBMPOConfig": "mbmpo",
    "MBMPOPolicy": "mbmpo",
    "QMix": "qmix",
    "QMixConfig": "qmix",
    "RepeatedRPS": "alpha_star",
    "SimpleRecEnv": "slateq",
    "SimpleTargetChase": "maddpg",
    "SlateQ": "slateq",
    "SlateQConfig": "slateq",
}


def __getattr__(name: str):
    if name in _LATER:
        raise _port.not_ported(
            f"ray_tpu_torch.rllib.algorithms.{name} "
            f"(algorithms/{_LATER[name]}.py)", "queue 1, item 6")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
