"""RLTrainer: run an RLlib algorithm under the Train fit contract.

Parity: reference ``python/ray/train/rl/rl_trainer.py`` — wraps an
RLlib ``Algorithm`` so ``fit()`` returns a train ``Result`` with the
usual metrics/checkpoint surface, and Tune can schedule it like any
trainable.  The algorithm's own actor fleet does the distribution; the
trainer is the driver-side lifecycle shim.  The algorithm's learner goes
where its config says: the card unless ``num_gpus_per_learner`` is 0.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Dict, Optional, Type, Union

from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig


class RLTrainer:
    def __init__(self, *, algorithm: Union[str, Type],
                 config: Optional[Dict[str, Any]] = None,
                 stop: Optional[Dict[str, float]] = None,
                 run_config: Optional[RunConfig] = None):
        self._algorithm = algorithm
        self._config = dict(config or {})
        self._stop = dict(stop or {"training_iteration": 10})
        self.run_config = run_config or RunConfig()

    def _algo_class(self):
        if not isinstance(self._algorithm, str):
            return self._algorithm
        import ray_tpu_torch.rllib.algorithms as algos

        cls = getattr(algos, self._algorithm, None)
        if cls is None:
            raise ValueError(f"unknown algorithm {self._algorithm!r} "
                             f"(known: PPO, IMPALA, APPO, DQN, SAC, ...)")
        return cls

    def fit(self):
        from ray_tpu_torch.train.trainer import Result

        algo = self._algo_class()(self._config)
        history = []
        try:
            while True:
                result = algo.train()
                history.append(result)
                if any(result.get(k, float("-inf")) >= v
                       for k, v in self._stop.items()):
                    break
            ckpt_dir = self.run_config.storage_path or tempfile.mkdtemp(
                prefix="rl_trainer_")
            algo.save(os.path.join(ckpt_dir, "final"))
            checkpoint = Checkpoint.from_directory(
                os.path.join(ckpt_dir, "final"))
            return Result(metrics=history[-1], checkpoint=checkpoint,
                          metrics_history=history)
        finally:
            algo.stop()
