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


def _dense(sd: Dict[str, torch.Tensor], name: str, tree: Mapping) -> None:
    """A flax Dense (``kernel [in, out]``, ``bias``) as ``name.weight
    [out, in]`` and ``name.bias``."""
    sd[f"{name}.weight"] = _tensor(tree["kernel"]).T.contiguous()
    sd[f"{name}.bias"] = _tensor(tree["bias"])


def _norm(sd: Dict[str, torch.Tensor], name: str, tree: Mapping) -> None:
    """A flax LayerNorm or BatchNorm (``scale``, ``bias``)."""
    sd[f"{name}.weight"] = _tensor(tree["scale"])
    sd[f"{name}.bias"] = _tensor(tree["bias"])


def _conv(tree: Mapping) -> torch.Tensor:
    """A flax Conv ``kernel [kh, kw, in, out]`` as ``[out, in, kh, kw]``."""
    return _tensor(tree["kernel"]).permute(3, 2, 0, 1).contiguous()


_GPT2_DENSE = ("attn_qkv", "attn_proj", "mlp_up", "mlp_down")
_GPT2_NORMS = ("ln_1", "ln_2")


def gpt2_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax ``GPT2`` parameter tree (after ``unbox()``) onto
    :class:`ray_tpu_torch.models.gpt2.GPT2`'s names: ``h{i}`` becomes
    ``h.{i}``, a Dense ``kernel [in, out]`` becomes ``weight [out, in]``,
    a LayerNorm ``scale`` becomes ``weight``; ``wte``, ``wpe`` and biases
    copy as-is, in f32.  A gradient tree has the same structure, so the
    same map puts JAX gradients beside the port's ``param.grad``."""
    sd = {"wte": _tensor(params["wte"]), "wpe": _tensor(params["wpe"])}
    _norm(sd, "ln_f", params["ln_f"])
    i = 0
    while f"h{i}" in params:
        block = params[f"h{i}"]
        for name in _GPT2_NORMS:
            _norm(sd, f"h.{i}.{name}", block[name])
        for name in _GPT2_DENSE:
            _dense(sd, f"h.{i}.{name}", block[name])
        i += 1
    return sd


def vit_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax ``ViT`` parameter tree (after ``unbox()``) onto
    :class:`ray_tpu_torch.models.vit.ViT`'s names: ``h{i}`` becomes
    ``h.{i}``, Dense and LayerNorm as in :func:`gpt2_state_dict_from_jax`,
    the patch embedding's conv kernel ``[kh, kw, in, out]`` becomes
    ``[out, in, kh, kw]``; ``cls``, ``pos_embed`` and biases copy as-is.
    A gradient tree maps the same way."""
    sd = {"patch_embed.weight": _conv(params["patch_embed"]),
          "patch_embed.bias": _tensor(params["patch_embed"]["bias"]),
          "cls": _tensor(params["cls"]),
          "pos_embed": _tensor(params["pos_embed"])}
    _norm(sd, "ln_f", params["ln_f"])
    _dense(sd, "head", params["head"])
    i = 0
    while f"h{i}" in params:
        block = params[f"h{i}"]
        for name in _GPT2_NORMS:
            _norm(sd, f"h.{i}.{name}", block[name])
        for name in _GPT2_DENSE:
            _dense(sd, f"h.{i}.{name}", block[name])
        i += 1
    return sd


def moe_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax ``MoETransformer`` parameter tree (after ``unbox()``)
    onto :class:`ray_tpu_torch.models.moe.MoETransformer`'s names: as
    GPT-2's for the embeddings, norms and attention; ``moe/router`` is a
    Dense; the stacked experts ``moe/up [E, D, M]`` and ``moe/down [E, M,
    D]`` copy as-is.  A gradient tree maps the same way."""
    sd = {"wte": _tensor(params["wte"]), "wpe": _tensor(params["wpe"])}
    _norm(sd, "ln_f", params["ln_f"])
    i = 0
    while f"h{i}" in params:
        block = params[f"h{i}"]
        for name in _GPT2_NORMS:
            _norm(sd, f"h.{i}.{name}", block[name])
        for name in ("attn_qkv", "attn_proj"):
            _dense(sd, f"h.{i}.{name}", block[name])
        moe = block["moe"]
        _dense(sd, f"h.{i}.moe.router", moe["router"])
        sd[f"h.{i}.moe.up"] = _tensor(moe["up"])
        sd[f"h.{i}.moe.down"] = _tensor(moe["down"])
        i += 1
    return sd


def resnet_state_dict_from_jax(params: Mapping, batch_stats: Mapping
                               ) -> Dict[str, torch.Tensor]:
    """Map a flax ``ResNet``'s ``params`` and ``batch_stats`` onto
    :class:`ray_tpu_torch.models.resnet.ResNet`'s names.  flax names the
    layers itself: ``stem`` and ``BatchNorm_0`` (the stem's norm),
    ``BasicBlock_{i}`` with ``Conv_0``/``BatchNorm_0`` (first conv),
    ``Conv_1``/``BatchNorm_1`` (second) and, where the block projects its
    input, ``Conv_2``/``BatchNorm_2``; ``Dense_0`` is the head.  Kernels
    become ``[out, in, kh, kw]``; BatchNorm ``scale``/``bias`` become
    ``weight``/``bias`` and the running ``mean``/``var`` the
    ``running_mean``/``running_var`` buffers.  A gradient tree maps the
    same way (pass its ``params``-shaped tree and the same
    ``batch_stats``)."""
    sd = {"stem.weight": _conv(params["stem"])}

    def bn(name, p, stats):
        _norm(sd, name, p)
        sd[f"{name}.running_mean"] = _tensor(stats["mean"])
        sd[f"{name}.running_var"] = _tensor(stats["var"])

    bn("stem_bn", params["BatchNorm_0"], batch_stats["BatchNorm_0"])
    _dense(sd, "head", params["Dense_0"])
    i = 0
    while f"BasicBlock_{i}" in params:
        p, s = params[f"BasicBlock_{i}"], batch_stats[f"BasicBlock_{i}"]
        for j, (conv, norm) in enumerate((("conv1", "bn1"), ("conv2", "bn2"),
                                          ("proj", "proj_bn"))):
            if f"Conv_{j}" in p:
                sd[f"blocks.{i}.{conv}.weight"] = _conv(p[f"Conv_{j}"])
                bn(f"blocks.{i}.{norm}", p[f"BatchNorm_{j}"],
                   s[f"BatchNorm_{j}"])
        i += 1
    return sd
