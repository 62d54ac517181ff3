"""Weights from the JAX package's models into the port's ``state_dict``."""

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


_GPT2_DENSE = ("attn_qkv", "attn_proj", "mlp_up", "mlp_down")
_GPT2_NORMS = ("ln_1", "ln_2")


def gpt2_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax ``GPT2`` parameter tree (after ``unbox()``) onto
    :class:`ray_tpu_torch.models.gpt2.GPT2`'s names: ``h{i}`` becomes
    ``h.{i}``, a Dense ``kernel [in, out]`` becomes ``weight [out, in]``,
    a LayerNorm ``scale`` becomes ``weight``; ``wte``, ``wpe`` and biases
    copy as-is, in f32.  A gradient tree has the same structure, so the
    same map puts JAX gradients beside the port's ``param.grad``."""
    sd = {"wte": _tensor(params["wte"]), "wpe": _tensor(params["wpe"]),
          "ln_f.weight": _tensor(params["ln_f"]["scale"]),
          "ln_f.bias": _tensor(params["ln_f"]["bias"])}
    i = 0
    while f"h{i}" in params:
        block = params[f"h{i}"]
        for name in _GPT2_NORMS:
            sd[f"h.{i}.{name}.weight"] = _tensor(block[name]["scale"])
            sd[f"h.{i}.{name}.bias"] = _tensor(block[name]["bias"])
        for name in _GPT2_DENSE:
            sd[f"h.{i}.{name}.weight"] = \
                _tensor(block[name]["kernel"]).T.contiguous()
            sd[f"h.{i}.{name}.bias"] = _tensor(block[name]["bias"])
        i += 1
    return sd
