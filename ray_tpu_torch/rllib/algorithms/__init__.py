"""Algorithm zoo (reference ``rllib/algorithms/``).

Every algorithm of the JAX package: PPO, DD-PPO, IMPALA/APPO,
PG/A2C/A3C, MARWIL/BC, DQN/SimpleQ/Ape-X DQN, R2D2, SAC, DDPG/TD3/Ape-X
DDPG, CQL, CRR, ES/ARS, the linear bandits (LinUCB, LinTS), AlphaStar,
MAML, MBMPO, Decision Transformer, AlphaZero, SlateQ, MADDPG, QMIX and
Dreamer.
"""

from ray_tpu_torch.rllib.algorithms.alpha_star import (  # noqa: F401
    AlphaStar,
    AlphaStarConfig,
    RepeatedRPS,
)
from ray_tpu_torch.rllib.algorithms.alpha_zero import (  # noqa: F401
    AlphaZero,
    AlphaZeroConfig,
)
from ray_tpu_torch.rllib.algorithms.bandit import (  # noqa: F401
    BanditLinTS,
    BanditLinTSConfig,
    BanditLinUCB,
    BanditLinUCBConfig,
)
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
from ray_tpu_torch.rllib.algorithms.ddppo import (  # noqa: F401
    DDPPO,
    DDPPOConfig,
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
from ray_tpu_torch.rllib.algorithms.dreamer import (  # noqa: F401
    Dreamer,
    DreamerConfig,
)
from ray_tpu_torch.rllib.algorithms.dt import DT, DTConfig  # noqa: F401
from ray_tpu_torch.rllib.algorithms.es import (  # noqa: F401
    ARS,
    ES,
    ARSConfig,
    ESConfig,
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
from ray_tpu_torch.rllib.algorithms.maddpg import (  # noqa: F401
    MADDPG,
    MADDPGConfig,
    SimpleTargetChase,
)
from ray_tpu_torch.rllib.algorithms.maml import (  # noqa: F401
    MAML,
    MAMLConfig,
    MAMLPolicy,
)
from ray_tpu_torch.rllib.algorithms.mbmpo import (  # noqa: F401
    MBMPO,
    MBMPOConfig,
    MBMPOPolicy,
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
from ray_tpu_torch.rllib.algorithms.qmix import (  # noqa: F401
    QMix,
    QMixConfig,
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
from ray_tpu_torch.rllib.algorithms.slateq import (  # noqa: F401
    SimpleRecEnv,
    SlateQ,
    SlateQConfig,
)

#: the JAX package's algorithm names that later slices bring: none
_LATER: dict = {}
