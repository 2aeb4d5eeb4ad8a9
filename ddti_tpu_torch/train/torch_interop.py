"""Flax parameters -> the port's ``state_dict``, in numpy alone.

The key rules of ``ddti_tpu/train/torch_interop.py`` (flax module path ->
the torch reference's key), restricted to the module kinds the port has so
far: ``ConvBNAct`` and ``ResidualBlock`` encoders/decoders/bottleneck,
transposed-conv ``upconvs``, the transformer bottleneck and plain leaves.
``state_dict_from_flax`` applies them to a flat ``{"params/..." |
"batch_stats/...": array}`` dict, which is what ``np.load`` of a
``ddti_tpu.train.checkpoint.save_params_npz`` file yields;
``flat_flax_from_state_dict`` is its inverse, for the ``.npz`` the port's
Trainer writes in that same format.

Weight layouts: Conv2d HWIO -> OIHW; ConvTranspose2d HWIO -> IOHW with a
spatial flip (torch applies the kernel in gradient orientation); Linear
(in, out) -> (out, in).
"""

from __future__ import annotations

import numpy as np
import torch

from ddti_tpu_torch.models.zoo import MODEL_REGISTRY

# flax child name -> torch suffix, per block kind: ConvBNAct's
# nn.Sequential indices, ResidualBlock's ``conv`` Sequential and ``skip``
_CONVBN = {"conv1": "0", "bn1": "1", "conv2": "3", "bn2": "4"}
_RES = {"conv1": "conv.0", "bn1": "conv.1", "conv2": "conv.3",
        "bn2": "conv.4", "skip": "skip"}
_BLOCKS = {"ResUNet": _RES, "TransUNet": _CONVBN}
_TRANS_LAYER = {"qkv": "self_attn.in_proj", "out_proj": "self_attn.out_proj",
                "fc1": "linear1", "fc2": "linear2",
                "ln1": "norm1", "ln2": "norm2"}


def _torch_key(model_type: str, path: tuple[str, ...]) -> str:
    """Translate a flax module path to the torch key prefix (without the
    .weight/.bias leaf suffix)."""
    block = _BLOCKS[model_type]
    out: list[str] = []
    i = 0
    while i < len(path):
        p = path[i]
        if "_" in p and p.rsplit("_", 1)[-1].isdigit():
            stem, idx = p.rsplit("_", 1)
            if stem == "trans_layers":
                out.append(f"trans.layers.{idx}.{_TRANS_LAYER[path[i + 1]]}")
                i += 2
                continue
            out.append(f"{stem}.{idx}")
            if stem in ("encoders", "decoders") and i + 1 < len(path) \
                    and path[i + 1] in block:
                out.append(block[path[i + 1]])
                i += 1
            i += 1
            continue
        if p == "bottleneck" and i + 1 < len(path) and path[i + 1] in block:
            out.append(f"bottleneck.{block[path[i + 1]]}")
            i += 2
            continue
        out.append("trans.patchify" if p == "patchify" else p)
        i += 1
    return ".".join(out)


def _is_bn(path) -> bool:
    return any(p.startswith("bn") or p.endswith("_bn") for p in path)


def _is_layernorm(path) -> bool:
    return any(p in ("ln1", "ln2") for p in path)


def _is_transpose_conv(path) -> bool:
    return any(p.startswith("upconvs_") for p in path)


def _leaf_suffix(leaf: str, kind: str) -> str:
    if kind == "bn":
        return {"scale": "weight", "bias": "bias",
                "mean": "running_mean", "var": "running_var"}[leaf]
    if leaf == "kernel":
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


def flax_key_from_torch(model_type: str, key: str) -> str:
    """The inverse of ``flax_to_torch_key``: a torch ``state_dict`` key ->
    ``"params/<flax path>"`` or ``"batch_stats/<flax path>"``."""
    parts = key.split(".")
    inv_block = {v: k for k, v in _BLOCKS[model_type].items()}
    inv_layer = {v: k for k, v in _TRANS_LAYER.items()}
    if key == "trans.pos_emb":
        return "params/pos_emb"
    leaf = parts.pop()
    mods: list[str] = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p == "trans" and parts[i + 1] == "layers":
            name = ".".join(parts[i + 3:])
            if leaf.startswith("in_proj_"):  # torch MHA's packed projection
                name, leaf = f"{name}.in_proj", leaf[len("in_proj_"):]
            mods += [f"trans_layers_{parts[i + 2]}", inv_layer[name]]
            break
        if p == "trans" and parts[i + 1] == "patchify":
            mods.append("patchify")
            i += 2
            continue
        if p in ("encoders", "decoders", "upconvs"):
            mods.append(f"{p}_{parts[i + 1]}")
            i += 2
        elif p == "bottleneck":
            mods.append(p)
            i += 1
        else:
            mods.append(p)
            i += 1
            continue
        rest = ".".join(parts[i:])
        if rest:
            mods.append(inv_block[rest])
            break
    if _is_layernorm(mods):
        collection, leaf = "params", {"weight": "scale", "bias": "bias"}[leaf]
    elif _is_bn(mods):
        collection = ("batch_stats" if leaf.startswith("running_")
                      else "params")
        leaf = {"weight": "scale", "bias": "bias", "running_mean": "mean",
                "running_var": "var"}[leaf]
    else:
        collection, leaf = "params", {"weight": "kernel"}.get(leaf, leaf)
    return "/".join([collection, *mods, leaf])


def _from_flax_array(path, a: np.ndarray) -> np.ndarray:
    a = np.asarray(a)
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
    dense)."""
    _check_ported(model_type)
    flat = {}
    for key, t in sd.items():
        fk = flax_key_from_torch(model_type, key)
        a = t.detach().to("cpu", torch.float32).numpy()
        if fk.endswith("/kernel"):
            if a.ndim == 4:
                if _is_transpose_conv(fk.split("/")):
                    a = a[:, :, ::-1, ::-1].transpose(2, 3, 0, 1)
                else:
                    a = a.transpose(2, 3, 1, 0)
            elif a.ndim == 2:
                a = a.T
        flat[fk] = np.ascontiguousarray(a)
    return flat


def _check_ported(model_type: str) -> None:
    if model_type not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"no key rules for {model_type!r} yet (ROADMAP.md Queue 1)")
