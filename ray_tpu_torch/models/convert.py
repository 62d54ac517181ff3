"""Weights from the JAX package's Llama into the port's ``state_dict``."""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

_DENSE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_NORMS = ("attn_norm", "mlp_norm")


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def llama_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax ``Llama`` parameter tree (nested dicts of arrays, after
    ``unbox()``) onto :class:`ray_tpu_torch.models.llama.Llama`'s names.

    A Dense ``kernel [in, out]`` becomes ``weight [out, in]``; ``*/scale``
    becomes the RMSNorm ``weight``; ``embedding`` copies as-is.  Tensors
    come out f32 (the flax ``param_dtype``); ``Llama.load_state_dict``
    stores each in its parameter's dtype, so dense weights land in
    ``cfg.dtype`` — the cast flax ``Dense(dtype=...)`` makes before its
    product — and the embedding and norm scales stay f32.
    """
    sd = {"embedding": _tensor(params["embedding"]),
          "final_norm.weight": _tensor(params["final_norm"]["scale"])}
    i = 0
    while f"layer{i}" in params:
        layer = params[f"layer{i}"]
        for name in _NORMS:
            sd[f"layers.{i}.{name}.weight"] = _tensor(layer[name]["scale"])
        for name in _DENSE:
            sd[f"layers.{i}.{name}.weight"] = \
                _tensor(layer[name]["kernel"]).T.contiguous()
        i += 1
    return sd
