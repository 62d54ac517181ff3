"""PyTorch/CUDA port of ray_tpu, for one NVIDIA H100.

The JAX package ``ray_tpu`` is the reference this package is held
against; nothing here imports it.  Plain tensor code is PyTorch, and
every Pallas kernel on a ported path is a CUDA C++ kernel under
``ray_tpu_torch/ops/csrc`` built for ``sm_90a`` at first use.

Entry points run on CUDA unless the caller passes ``device="cpu"``
(``ray_tpu_torch._device.resolve_device``); on CPU tensors the kernel
wrappers compute their plain PyTorch versions.
"""

__version__ = "0.1.0"

from ray_tpu_torch._device import resolve_device  # noqa: E402

__all__ = ["__version__", "resolve_device"]
