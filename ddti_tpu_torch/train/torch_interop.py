"""Flax parameters -> the port's ``state_dict``, in numpy alone.

The key rules of ``ddti_tpu/train/torch_interop.py`` (flax module path ->
the torch reference's key) for every model ``models/zoo.py:create_model``
builds. The seven active models: encoder, decoder and bottleneck blocks
through each model's block map (``ConvBNAct``, its PReLU form for VNet2D,
``ResidualBlock``), transposed convs (``upconvs``, ``up_convs``), plain
convs (``down_convs``, ``ds_heads``, ``final_conv``), attention gates, the
ASPP bottleneck and the transformer bottleneck. The fixed architectures:
LegacyUNet and MoresUNet by the reference's ``nn.Sequential`` layout
(``_legacy_unet_key``), MoresVNet2D by its ModuleLists
(``_mores_vnet_key``), the other five by the generic rule, which joins
the flax names with dots but for a ``bottleneck`` block's indices and the
``trans.`` prefix of ``patchify``. A transposed conv is any module named
``upconvs_i``, ``up_convs_i``, ``middle_up``, ``decoderN_up`` or
``up{i}``. ``state_dict_from_flax`` applies them to a flat
``{"params/..." | "batch_stats/...": array}`` dict, which is what
``np.load`` of a ``ddti_tpu.train.checkpoint.save_params_npz`` file
yields; ``flat_flax_from_state_dict`` is its inverse, for the ``.npz`` the
port's Trainer writes in that same format.

Weight layouts: Conv2d HWIO -> OIHW; ConvTranspose2d HWIO -> IOHW with a
spatial flip (torch applies the kernel in gradient orientation); Linear
(in, out) -> (out, in); a PReLU slope () -> (1,).
"""

from __future__ import annotations

import numpy as np
import torch

from ddti_tpu_torch.models.zoo import ALL_MODELS

# flax child name -> torch suffix, per block kind: ConvBNAct's
# nn.Sequential indices (with the PReLU slopes at 2 and 5 in VNet2D),
# ResidualBlock's ``conv`` Sequential and ``skip``
_CONVBN = {"conv1": "0", "bn1": "1", "conv2": "3", "bn2": "4"}
_CONVBN_PRELU = {**_CONVBN, "prelu1": "2", "prelu2": "5"}
_RES = {"conv1": "conv.0", "bn1": "conv.1", "conv2": "conv.3",
        "bn2": "conv.4", "skip": "skip"}
_GATE = {"w_g": "W_g.0", "w_g_bn": "W_g.1", "w_x": "W_x.0",
         "w_x_bn": "W_x.1", "psi": "psi.0", "psi_bn": "psi.1"}
_ASPP_PROJECT = {"project": "project.0", "project_bn": "project.1"}
_TRANS_LAYER = {"qkv": "self_attn.in_proj", "out_proj": "self_attn.out_proj",
                "fc1": "linear1", "fc2": "linear2",
                "ln1": "norm1", "ln2": "norm2"}
# the reference's legacy conv_block: Conv(0) ReLU(1) BN(2) Conv(3) ReLU(4)
# BN(5)
_CONV_RELU_BN = {"conv1": "0", "bn1": "2", "conv2": "3", "bn2": "5"}
_LEGACY_UNETS = ("LegacyUNet", "MoresUNet")
_BLOCK_STEMS = ("encoders", "decoders", "enc_blocks", "dec_blocks")
_INDEXED = _BLOCK_STEMS + ("upconvs", "up_convs", "down_convs", "ds_heads")


def _block_map(model_type: str) -> dict:
    """The block map of every encoder, decoder and bottleneck block of a
    model (JAX ``_block_map``; ImprovedVNet's blocks, its bottleneck
    included, are plain ConvBNAct)."""
    return {"ResUNet": _RES, "VNet2D": _CONVBN_PRELU}.get(model_type,
                                                          _CONVBN)


def _legacy_unet_key(path: tuple[str, ...]) -> str:
    """LegacyUNet / MoresUNet: ``encoderN`` blocks; ``middle`` = (pool 0,
    block 1, transposed conv 2); ``decoderN`` = (block 0, transposed conv
    1); ``final`` = (block 0, 1x1 conv 1)."""
    p, child = path[0], path[1:]
    inner = [_CONV_RELU_BN[c] for c in child]
    if p.startswith("encoder"):
        out = [p]
    elif p == "middle_block":
        out = ["middle", "1"]
    elif p == "middle_up":
        out = ["middle", "2"]
    elif p.startswith("decoder"):
        stem, _, part = p.rpartition("_")
        out = [stem, "0" if part == "block" else "1"]
    elif p == "final_block":
        out = ["final", "0"]
    elif p == "final_conv":
        out = ["final", "1"]
    else:
        out = [p]
    return ".".join(out + inner)


def _mores_vnet_key(path: tuple[str, ...]) -> str:
    """MoresVNet2D: ``enc{i}`` / ``dec{i}`` / ``down{i}`` / ``up{i}`` onto
    its ModuleLists, the blocks (and ``bottleneck``) through the PReLU
    block map."""
    p, child = path[0], path[1:]
    stem = p.rstrip("0123456789")
    idx = p[len(stem):]
    lists = {"enc": "enc_blocks", "dec": "dec_blocks", "down": "down_convs",
             "up": "up_convs"}
    out = [lists[stem], idx] if idx and stem in lists else [p]
    return ".".join(out + [_CONVBN_PRELU[c] for c in child])


def _torch_key(model_type: str, path: tuple[str, ...]) -> str:
    """Translate a flax module path to the torch key prefix (without the
    .weight/.bias leaf suffix)."""
    if model_type in _LEGACY_UNETS:
        return _legacy_unet_key(path)
    if model_type == "MoresVNet2D":
        return _mores_vnet_key(path)
    block = _block_map(model_type)
    out: list[str] = []
    i = 0
    while i < len(path):
        p = path[i]
        nxt = path[i + 1] if i + 1 < len(path) else None
        stem, _, idx = p.rpartition("_")
        if stem == "trans_layers" and idx.isdigit():
            out.append(f"trans.layers.{idx}.{_TRANS_LAYER[nxt]}")
            i += 2
        elif stem == "attn_gates" and idx.isdigit():
            out.append(f"attn_gates.{idx}.{_GATE[nxt]}")
            i += 2
        elif stem in _INDEXED and idx.isdigit():
            out.append(f"{stem}.{idx}")
            if stem in _BLOCK_STEMS and nxt in block:
                out.append(block[nxt])
                i += 1
            i += 1
        elif p == "bottleneck" and nxt in block:
            out.append(f"bottleneck.{block[nxt]}")
            i += 2
        elif p == "aspp":  # branch<k> or project / project_bn
            out.append("aspp." + _ASPP_PROJECT.get(
                nxt, f"branches.{nxt[len('branch'):]}"))
            i += 2
        else:
            out.append("trans.patchify" if p == "patchify" else p)
            i += 1
    return ".".join(out)


def _is_bn(path) -> bool:
    return any(p.startswith("bn") or p.endswith("_bn") for p in path)


def _is_layernorm(path) -> bool:
    return any(p in ("ln1", "ln2") for p in path)


def _is_transpose_conv(path) -> bool:
    def is_up(p: str) -> bool:
        if p.startswith(("upconvs_", "up_convs_")) or p == "middle_up":
            return True
        if p.startswith("decoder") and p.endswith("_up"):
            return True
        stem = p.rstrip("0123456789")
        return stem == "up" and len(p) > len(stem)

    return any(is_up(p) for p in path)


def _leaf_suffix(leaf: str, kind: str) -> str:
    if kind == "bn":
        return {"scale": "weight", "bias": "bias",
                "mean": "running_mean", "var": "running_var"}[leaf]
    if leaf in ("kernel", "negative_slope"):
        return "weight"
    return leaf  # bias


def flax_to_torch_key(model_type: str, path: tuple[str, ...]) -> str:
    """Full torch key for one flax leaf path."""
    *mods, leaf = path
    if leaf == "pos_emb" and not mods:
        return "trans.pos_emb"  # the parameter itself
    prefix = _torch_key(model_type, tuple(mods))
    if _is_layernorm(mods):
        suffix = {"scale": "weight", "bias": "bias"}[leaf]
    elif _is_bn(mods):
        suffix = _leaf_suffix(leaf, "bn")
    else:
        suffix = _leaf_suffix(leaf, "other")
    # torch MHA names its packed projection in_proj_weight / in_proj_bias
    if prefix.endswith("in_proj"):
        return f"{prefix}_{suffix}"
    return f"{prefix}.{suffix}"


def _legacy_unet_mods(parts: list) -> list:
    """The inverse of ``_legacy_unet_key``."""
    inv = {v: k for k, v in _CONV_RELU_BN.items()}
    p = parts[0]
    if p.startswith("encoder"):
        return [p, inv[parts[1]]]
    stage = {"middle": ("middle_block", "middle_up"),
             "final": ("final_block", "final_conv")}.get(
        p, (f"{p}_block", f"{p}_up"))
    if parts[1] == ("1" if p == "middle" else "0"):
        return [stage[0], inv[parts[2]]]
    return [stage[1]]


def _mores_vnet_mods(parts: list) -> list:
    """The inverse of ``_mores_vnet_key``."""
    inv = {v: k for k, v in _CONVBN_PRELU.items()}
    lists = {"enc_blocks": "enc", "dec_blocks": "dec", "down_convs": "down",
             "up_convs": "up"}
    if parts[0] in lists:
        return [lists[parts[0]] + parts[1], *(inv[c] for c in parts[2:])]
    return [parts[0], *(inv[c] for c in parts[1:])]


def flax_key_from_torch(model_type: str, key: str) -> str:
    """The inverse of ``flax_to_torch_key``: a torch ``state_dict`` key ->
    ``"params/<flax path>"`` or ``"batch_stats/<flax path>"``."""
    if key == "trans.pos_emb":
        return "params/pos_emb"
    parts = key.split(".")
    leaf = parts.pop()
    if model_type in _LEGACY_UNETS:
        return _flax_leaf(_legacy_unet_mods(parts), leaf)
    if model_type == "MoresVNet2D":
        return _flax_leaf(_mores_vnet_mods(parts), leaf)
    inv_layer = {v: k for k, v in _TRANS_LAYER.items()}
    # the rest of the key after a module with children -> its flax child
    inv_child = {
        **{v: k for k, v in _block_map(model_type).items()},
        **{f"attn_gates.{v}": k for k, v in _GATE.items()},
        **{v: k for k, v in _ASPP_PROJECT.items()}}
    mods: list[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        rest = ".".join(parts[i + 2:])
        if p == "trans" and parts[i + 1] == "layers":
            name = ".".join(parts[i + 3:])
            if leaf.startswith("in_proj_"):  # torch MHA's packed projection
                name, leaf = f"{name}.in_proj", leaf[len("in_proj_"):]
            mods += [f"trans_layers_{parts[i + 2]}", inv_layer[name]]
            break
        if p == "trans" and parts[i + 1] == "patchify":
            mods.append("patchify")
            break
        if p == "attn_gates":
            mods += [f"{p}_{parts[i + 1]}", inv_child[f"{p}.{rest}"]]
            break
        if p == "aspp":
            mods.append(p)
            sub = ".".join(parts[i + 1:])
            mods.append(inv_child.get(sub, f"branch{parts[-1]}"))
            break
        if p in _INDEXED:
            mods.append(f"{p}_{parts[i + 1]}")
            if rest:
                mods.append(inv_child[rest])
            break
        mods.append(p)
        if p == "bottleneck":  # a block's indices; skip, branch<k>, ...
            rest = ".".join(parts[i + 1:])
            mods.append(inv_child.get(rest, rest))
            break
        i += 1
    return _flax_leaf(mods, leaf)


def _flax_leaf(mods: list, leaf: str) -> str:
    """``"<collection>/<mods>/<flax leaf>"`` for a torch leaf name."""
    if _is_layernorm(mods):
        collection, leaf = "params", {"weight": "scale", "bias": "bias"}[leaf]
    elif _is_bn(mods):
        collection = ("batch_stats" if leaf.startswith("running_")
                      else "params")
        leaf = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                "running_var": "var"}[leaf]
    elif mods[-1].startswith("prelu"):
        collection, leaf = "params", "negative_slope"
    else:
        collection, leaf = "params", {"weight": "kernel"}.get(leaf, leaf)
    return "/".join([collection, *mods, leaf])


def _from_flax_array(path, a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
    if path[-1] == "negative_slope":
        return a.reshape(1)
    if path[-1] == "kernel":
        if a.ndim == 4:
            if _is_transpose_conv(path[:-1]):
                a = a.transpose(2, 3, 0, 1)[:, :, ::-1, ::-1]
            else:
                a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:
            a = a.T
    return a


def state_dict_from_flax(model_type: str, flat: dict) -> dict:
    """Flat ``{"params/<path>" | "batch_stats/<path>": array}`` -> the
    port's ``state_dict`` (float32 tensors). Other collections (for
    example QAT ``qstats/``) carry no weights and are skipped."""
    _check_ported(model_type)
    sd = {}
    for key, arr in flat.items():
        collection, *path = key.split("/")
        if collection not in ("params", "batch_stats"):
            continue
        a = _from_flax_array(tuple(path), arr)
        sd[flax_to_torch_key(model_type, tuple(path))] = torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32))
    return sd


def flat_flax_from_state_dict(model_type: str, sd: dict) -> dict:
    """The port's ``state_dict`` -> the flat ``{"params/..." |
    "batch_stats/...": float32 array}`` dict that ``np.savez`` turns into a
    ``save_params_npz`` file (flax layouts: HWIO kernels, (in, out)
    dense, scalar PReLU slopes)."""
    _check_ported(model_type)
    flat = {}
    for key, t in sd.items():
        fk = flax_key_from_torch(model_type, key)
        a = t.detach().to("cpu", torch.float32).numpy()
        if fk.endswith("/negative_slope"):
            a = a.reshape(())
        elif fk.endswith("/kernel"):
            if a.ndim == 4:
                if _is_transpose_conv(fk.split("/")):
                    a = a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
                else:
                    a = a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                a = a.T
        flat[fk] = np.array(a, order="C")  # ascontiguousarray makes 0-d 1-d
    return flat


def _check_ported(model_type: str) -> None:
    if model_type not in ALL_MODELS:
        raise NotImplementedError(f"no key rules for {model_type!r}")
