"""Kernels of the port, each beside its plain PyTorch version."""

from ray_tpu_torch.ops.flash_attention import (  # noqa: F401
    attention_backward_reference,
    attention_reference,
    fit_block,
    flash_attention,
    flash_attention_bwd,
    flash_attention_fwd,
    flash_attention_hm_bwd,
    flash_attention_hm_fwd,
    kernel_block_for,
)
from ray_tpu_torch.ops.fused import (  # noqa: F401
    chunked_lm_loss,
    fused_rmsnorm,
    fused_softmax_cross_entropy,
    rmsnorm_reference,
)
