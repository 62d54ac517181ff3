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


# -- RL models (ray_tpu_torch.rllib.models) ---------------------------------

def _rl_params(params: Mapping) -> Mapping:
    """A flax ``init`` result (``{"params": ...}``) or the tree itself."""
    return params["params"] if "params" in params else params


def _dense_tree(sd: Dict[str, torch.Tensor], prefix: str,
                tree: Mapping) -> None:
    """Every Dense of ``tree`` under its own name."""
    for name, sub in tree.items():
        _dense(sd, f"{prefix}{name}", sub)


def fcnet_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax ``FCNet`` tree (shared torso or a separate value
    branch) onto :class:`ray_tpu_torch.rllib.models.FCNet`, whose Dense
    names are flax's."""
    sd: Dict[str, torch.Tensor] = {}
    _dense_tree(sd, "", _rl_params(params))
    return sd


def twin_q_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax ``TwinQNetwork`` tree (``q1_fc_0`` ... ``q2_out``)."""
    return fcnet_state_dict_from_jax(params)


def squashed_actor_state_dict_from_jax(params: Mapping
                                       ) -> Dict[str, torch.Tensor]:
    """Map a flax SAC ``_SquashedActor`` tree (``fc_<i>``, ``mean``,
    ``log_std``) onto ``rllib.algorithms.sac._SquashedActor``."""
    return fcnet_state_dict_from_jax(params)


def det_actor_state_dict_from_jax(params: Mapping
                                  ) -> Dict[str, torch.Tensor]:
    """Map a flax DDPG ``_DetActor`` tree (``fc_<i>``, ``out``) onto
    ``rllib.algorithms.ddpg._DetActor``."""
    return fcnet_state_dict_from_jax(params)


_LSTM_GATES = ("i", "f", "g", "o")


def lstm_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax ``LSTMNet`` tree: ``embed``, ``out``, ``vf_out`` as
    Denses, and the ``OptimizedLSTMCell``'s per-gate Denses (``ii`` ...
    ``io`` without bias, ``hi`` ... ``ho`` with) stacked in gate order
    i, f, g, o into ``lstm.ih.weight`` and ``lstm.hh.weight`` /
    ``lstm.hh.bias``."""
    p = dict(_rl_params(params))
    cell = p.pop("lstm")
    sd: Dict[str, torch.Tensor] = {}
    _dense_tree(sd, "", p)
    sd["lstm.ih.weight"] = torch.cat(
        [_tensor(cell[f"i{g}"]["kernel"]) for g in _LSTM_GATES],
        dim=1).T.contiguous()
    sd["lstm.hh.weight"] = torch.cat(
        [_tensor(cell[f"h{g}"]["kernel"]) for g in _LSTM_GATES],
        dim=1).T.contiguous()
    sd["lstm.hh.bias"] = torch.cat(
        [_tensor(cell[f"h{g}"]["bias"]) for g in _LSTM_GATES])
    return sd


def attention_state_dict_from_jax(params: Mapping
                                  ) -> Dict[str, torch.Tensor]:
    """Map a flax ``AttentionNet`` tree: ``embed``, ``out``, ``vf_out``
    and each ``block_<i>``'s Denses and LayerNorms by name; the
    attention's per-head kernels (q/k/v ``[D, H, D/H]``, out ``[H, D/H,
    D]``) flatten the heads into ``[D, D]`` before the transpose."""
    sd: Dict[str, torch.Tensor] = {}
    for name, tree in _rl_params(params).items():
        if name.startswith("block_"):
            _gtrxl_block(sd, name, tree)
        else:
            _dense(sd, name, tree)
    return sd


def _gtrxl_block(sd: Dict[str, torch.Tensor], name: str,
                 tree: Mapping) -> None:
    """One flax ``_GatedTransformerBlock``: LayerNorms and Denses by
    name, the attention's per-head kernels flattened."""
    for part, sub in tree.items():
        key = f"{name}.{part}"
        if part.startswith("ln_"):
            _norm(sd, key, sub)
        elif part == "attn":
            for proj in ("query", "key", "value"):
                k = _tensor(sub[proj]["kernel"])
                sd[f"{key}.{proj}.weight"] = \
                    k.reshape(k.shape[0], -1).T.contiguous()
                sd[f"{key}.{proj}.bias"] = \
                    _tensor(sub[proj]["bias"]).reshape(-1)
            k = _tensor(sub["out"]["kernel"])
            sd[f"{key}.out.weight"] = \
                k.reshape(-1, k.shape[-1]).T.contiguous()
            sd[f"{key}.out.bias"] = _tensor(sub["out"]["bias"])
        else:
            _dense(sd, key, sub)


def dt_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax Decision Transformer ``_DTNet`` tree onto
    ``rllib.algorithms.dt._DTNet``: ``pos_embed`` as-is, the action
    embedding's ``embedding`` as ``act_embed.weight``, ``ln_f`` as a
    LayerNorm, each ``block_<i>`` as :func:`attention_state_dict_from_jax`
    maps it, the rest as Denses."""
    sd: Dict[str, torch.Tensor] = {}
    for name, tree in _rl_params(params).items():
        if name == "pos_embed":
            sd[name] = _tensor(tree)
        elif name == "act_embed":
            sd["act_embed.weight"] = _tensor(tree["embedding"])
        elif name == "ln_f":
            _norm(sd, name, tree)
        elif name.startswith("block_"):
            _gtrxl_block(sd, name, tree)
        else:
            _dense(sd, name, tree)
    return sd


def item_q_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map a flax SlateQ ``_ItemQNet`` tree (``fc_<i>``, ``out``) onto
    ``rllib.algorithms.slateq._ItemQNet``."""
    return fcnet_state_dict_from_jax(params)


def alpha_zero_state_dict_from_jax(params: Mapping
                                   ) -> Dict[str, torch.Tensor]:
    """Map AlphaZero's flax ``FCNet`` (shared torso: ``fc_0``, ``fc_1``,
    ``out``, ``vf_out``) onto the learner's FCNet."""
    return fcnet_state_dict_from_jax(params)


def mbmpo_ensemble_state_dict_from_jax(params: Mapping
                                       ) -> Dict[str, torch.Tensor]:
    """Map MBMPO's vmapped flax ``_DynamicsNet`` tree, every leaf with a
    leading ensemble axis ``[K]``, onto
    ``rllib.algorithms.mbmpo._DynamicsEnsemble``: flax's ``Dense_<i>``
    become ``fc_<i>``, ``delta`` and ``reward`` keep their names; a
    kernel ``[K, in, out]`` becomes ``weight [K, out, in]``, a bias
    ``[K, out]`` copies as-is."""
    sd: Dict[str, torch.Tensor] = {}
    for name, tree in _rl_params(params).items():
        key = name.replace("Dense_", "fc_")
        sd[f"{key}.weight"] = \
            _tensor(tree["kernel"]).transpose(1, 2).contiguous()
        sd[f"{key}.bias"] = _tensor(tree["bias"])
    return sd


def maddpg_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map MADDPG's flax ``_PerAgentNets`` tree (``actors_<i>``,
    ``critics_<i>``, each ``fc_<j>`` and ``out``) onto
    ``rllib.algorithms.maddpg._PerAgentNets`` (``actors.<i>``,
    ``critics.<i>``)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, tree in _rl_params(params).items():
        group, index = name.rsplit("_", 1)
        _dense_tree(sd, f"{group}.{index}.", tree)
    return sd


_GRU_INPUT = ("ir", "iz", "in")
_GRU_HIDDEN = ("hr", "hz", "hn")


def _gru(sd: Dict[str, torch.Tensor], name: str, tree: Mapping) -> None:
    """flax's ``GRUCell`` (``ir``, ``iz``, ``in`` with bias; ``hr``,
    ``hz`` without, ``hn`` with) onto ``rllib.models.GRUCell``: the input
    Denses stacked in gate order r, z, n into ``ih``, the hidden ones
    into ``hh``, ``hn``'s bias as ``hn_bias``."""
    sd[f"{name}.ih.weight"] = torch.cat(
        [_tensor(tree[g]["kernel"]) for g in _GRU_INPUT],
        dim=1).T.contiguous()
    sd[f"{name}.ih.bias"] = torch.cat(
        [_tensor(tree[g]["bias"]) for g in _GRU_INPUT])
    sd[f"{name}.hh.weight"] = torch.cat(
        [_tensor(tree[g]["kernel"]) for g in _GRU_HIDDEN],
        dim=1).T.contiguous()
    sd[f"{name}.hn_bias"] = _tensor(tree["hn"]["bias"])


def qmix_state_dict_from_jax(params: Mapping) -> Dict[str, torch.Tensor]:
    """Map either QMIX model's flax tree onto its port: the agent
    (``agent``: the recurrent one's ``fc_in``, scanned ``gru`` and
    ``q_out``, or the feed-forward one's ``fc_<i>`` and ``q_out``) and
    the mixer's hypernetwork Denses (``mixer``)."""
    p = _rl_params(params)
    agent = dict(p["agent"])
    gru = agent.pop("gru", None)
    sd: Dict[str, torch.Tensor] = {}
    _dense_tree(sd, "agent.", agent)
    if gru is not None:
        _gru(sd, "agent.gru", gru)
    _dense_tree(sd, "mixer.", p["mixer"])
    return sd


def _conv_transpose(tree: Mapping) -> torch.Tensor:
    """A flax ``ConvTranspose`` kernel ``[kh, kw, in, out]`` as
    ``conv_transpose2d``'s ``[in, out, kh, kw]``, flipped in both
    spatial axes (``lax.conv_transpose`` does not flip the kernel)."""
    return _tensor(tree["kernel"]).permute(2, 3, 0, 1).flip(2, 3) \
        .contiguous()


def dreamer_rssm_state_dict_from_jax(params: Mapping
                                     ) -> Dict[str, torch.Tensor]:
    """Map Dreamer's flax ``_RSSM`` tree onto
    ``rllib.algorithms.dreamer._RSSM``: ``gru`` as :func:`_gru` maps it,
    the Denses and the heads' ``layers_<i>`` by name, and on images the
    encoder's ``conv<i>`` (kernels ``[out, in, kh, kw]``) and the
    decoder's ``deconv<i>`` (kernels flipped, :func:`_conv_transpose`)."""
    sd: Dict[str, torch.Tensor] = {}
    for name, tree in _rl_params(params).items():
        if name == "gru":
            _gru(sd, name, tree)
        elif "kernel" in tree:
            _dense(sd, name, tree)
        else:
            for part, sub in tree.items():
                key = f"{name}.{part}"
                if part.startswith("conv"):
                    sd[f"{key}.weight"] = _conv(sub)
                    sd[f"{key}.bias"] = _tensor(sub["bias"])
                elif part.startswith("deconv"):
                    sd[f"{key}.weight"] = _conv_transpose(sub)
                    sd[f"{key}.bias"] = _tensor(sub["bias"])
                else:
                    _dense(sd, key, sub)
    return sd


def dreamer_head_state_dict_from_jax(params: Mapping
                                     ) -> Dict[str, torch.Tensor]:
    """Map Dreamer's flax actor or critic ``_Head`` (``Dense_0`` ...
    ``Dense_2``) onto ``rllib.algorithms.dreamer._Head``."""
    return fcnet_state_dict_from_jax(params)
