"""Models of the port: the JAX package's model zoo
(``ray_tpu.models``), the same five models and their configurations."""

from ray_tpu_torch.models.gpt2 import GPT2, GPT2Config  # noqa: F401
from ray_tpu_torch.models.llama import Llama, LlamaConfig  # noqa: F401
from ray_tpu_torch.models.moe import (  # noqa: F401
    MoEConfig,
    MoETransformer,
    SparseMoEMLP,
)
from ray_tpu_torch.models.resnet import ResNet, ResNetConfig  # noqa: F401
from ray_tpu_torch.models.vit import ViT, ViTConfig  # noqa: F401
