"""Flax parameters -> the port's ``state_dict``, in numpy alone.

The key rules of ``ddti_tpu/train/torch_interop.py`` (flax module path ->
the torch reference's key), restricted to the module kinds the port has so
far: ``ConvBNAct`` encoders/decoders, transposed-conv ``upconvs``, the
transformer bottleneck and plain leaves. ``state_dict_from_flax`` applies
them to a flat ``{"params/..." | "batch_stats/...": array}`` dict, which is
what ``np.load`` of a ``ddti_tpu.train.checkpoint.save_params_npz`` file
yields.

Weight layouts: Conv2d HWIO -> OIHW; ConvTranspose2d HWIO -> IOHW with a
spatial flip (torch applies the kernel in gradient orientation); Linear
(in, out) -> (out, in).
"""

from __future__ import annotations

import numpy as np
import torch

from ddti_tpu_torch.models.zoo import MODEL_REGISTRY

# flax child name -> torch nn.Sequential index (ConvBNAct)
_CONVBN = {"conv1": "0", "bn1": "1", "conv2": "3", "bn2": "4"}
_TRANS_LAYER = {"qkv": "self_attn.in_proj", "out_proj": "self_attn.out_proj",
                "fc1": "linear1", "fc2": "linear2",
                "ln1": "norm1", "ln2": "norm2"}


def _torch_key(path: tuple[str, ...]) -> str:
    """Translate a flax module path to the torch key prefix (without the
    .weight/.bias leaf suffix)."""
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
                    and path[i + 1] in _CONVBN:
                out.append(_CONVBN[path[i + 1]])
                i += 1
            i += 1
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


def flax_to_torch_key(path: tuple[str, ...]) -> str:
    """Full torch key for one flax leaf path."""
    *mods, leaf = path
    if leaf == "pos_emb" and not mods:
        return "trans.pos_emb"  # the parameter itself
    prefix = _torch_key(tuple(mods))
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
    if model_type not in MODEL_REGISTRY:
        raise NotImplementedError(
            f"no key rules for {model_type!r} yet (ROADMAP.md Queue 1)")
    sd = {}
    for key, arr in flat.items():
        collection, *path = key.split("/")
        if collection not in ("params", "batch_stats"):
            continue
        a = _from_flax_array(tuple(path), arr)
        sd[flax_to_torch_key(tuple(path))] = torch.from_numpy(
            np.ascontiguousarray(a, dtype=np.float32))
    return sd
