"""Kernels of the port, each beside its plain PyTorch version."""

from ray_tpu_torch.ops.flash_attention import (  # noqa: F401
    attention_reference,
    fit_block,
    flash_attention,
    flash_attention_fwd,
    kernel_block_for,
)
from ray_tpu_torch.ops.fused import fused_rmsnorm, rmsnorm_reference  # noqa: F401
