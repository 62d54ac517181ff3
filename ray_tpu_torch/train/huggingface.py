"""HuggingFaceTrainer: distributed ``transformers.Trainer`` fine-tuning.

Parity: reference ``train/huggingface/huggingface_trainer.py`` — the
user supplies ``trainer_init_per_worker(train_dataset, eval_dataset,
**config) -> transformers.Trainer``; each gang worker builds the HF
trainer against its dataset shard under the torch process group
installed by the backend, HF log events stream back through
``session.report``, and the final model lands in an AIR checkpoint
loadable with ``HuggingFacePredictor``/``from_pretrained``.

On a GPU worker ``transformers.Trainer`` picks its device itself
(``cuda:0`` without ``LOCAL_RANK``: with one card, the lease);
``TrainingArguments(use_cpu=True)`` keeps it on the host.
"""

from __future__ import annotations

import os
import tempfile
from typing import Any, Callable, Dict, Optional

from ray_tpu_torch.train import session
from ray_tpu_torch.train.checkpoint import Checkpoint
from ray_tpu_torch.train.config import RunConfig, ScalingConfig
from ray_tpu_torch.train.trainer import TorchTrainer


def _hf_train_loop(config: Dict[str, Any]) -> None:
    import transformers

    trainer_init = config["_trainer_init_per_worker"]
    init_config = dict(config.get("_trainer_init_config") or {})
    train_ds = session.get_dataset_shard("train")
    eval_ds = session.get_dataset_shard("evaluation")
    trainer: "transformers.Trainer" = trainer_init(train_ds, eval_ds,
                                                   **init_config)

    class _ReportCallback(transformers.TrainerCallback):
        """HF log events -> session.report (reference
        ``huggingface/_huggingface_utils.py`` TrainReportCallback)."""

        def on_log(self, args, state, control, logs=None, **kwargs):
            if logs and state.is_world_process_zero:
                metrics = {k: v for k, v in logs.items()
                           if isinstance(v, (int, float))}
                metrics["step"] = state.global_step
                metrics["epoch"] = float(state.epoch or 0)
                session.report(metrics)

    trainer.add_callback(_ReportCallback())
    trainer.train()
    # final checkpoint: serialized model + tokenizer dir (rank 0)
    if session.get_world_rank() == 0:
        out = tempfile.mkdtemp(prefix="hf_ckpt_")
        trainer.save_model(out)
        if trainer.tokenizer is not None:
            trainer.tokenizer.save_pretrained(out)
        session.report({"done": 1.0},
                       checkpoint=Checkpoint.from_directory(out))


class HuggingFaceTrainer(TorchTrainer):
    """``transformers``-native trainer on the torch gang backend."""

    def __init__(self, *, trainer_init_per_worker: Callable[..., Any],
                 trainer_init_config: Optional[Dict[str, Any]] = None,
                 scaling_config: Optional[ScalingConfig] = None,
                 run_config: Optional[RunConfig] = None,
                 datasets: Optional[Dict[str, Any]] = None,
                 resume_from_checkpoint: Optional[Checkpoint] = None):
        if datasets is None or "train" not in datasets:
            raise ValueError("HuggingFaceTrainer requires "
                             "datasets={'train': ...}")
        super().__init__(
            _hf_train_loop,
            train_loop_config={
                "_trainer_init_per_worker": trainer_init_per_worker,
                "_trainer_init_config": trainer_init_config,
            },
            scaling_config=scaling_config,
            run_config=run_config,
            datasets=datasets,
            resume_from_checkpoint=resume_from_checkpoint)
