"""Weight checkpoints, ported from ``ddti_tpu/train/checkpoint.py``
(``load_checkpoint_into``, ``save_params_npz``).

Two formats load and save: a torch ``.pth`` state_dict (the reference's
own files and ``ddti_tpu.train.torch_interop.save_pth`` exports) and a flat
``.npz`` in the layout of ``ddti_tpu.train.checkpoint.save_params_npz``
(flax key paths and layouts), so either package reads the other's
weights. Orbax checkpoint directories are a JAX format and are refused
(ROADMAP.md lists a counterpart).
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from .torch_interop import flat_flax_from_state_dict, state_dict_from_flax

_BF16_MARKER = "::bf16"


def _bf16_bits_to_f32(bits: np.ndarray) -> np.ndarray:
    """Raw bfloat16 bits (stored as uint16 because npz cannot hold
    bfloat16) -> float32, exactly."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def load_npz_flat(path: str) -> dict:
    """``save_params_npz`` file -> flat ``{"params/...": float array}``,
    with ``::bf16`` raw-bit entries decoded."""
    with np.load(path) as data:
        return {(k[:-len(_BF16_MARKER)] if k.endswith(_BF16_MARKER) else k):
                (_bf16_bits_to_f32(data[k]) if k.endswith(_BF16_MARKER)
                 else data[k])
                for k in data.files}


def load_checkpoint_into(path: str, model_type: str,
                         model: nn.Module) -> nn.Module:
    """Load ``path`` into ``model`` with ``strict=True`` and return it."""
    if path.endswith(".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
    elif path.endswith(".npz"):
        sd = state_dict_from_flax(model_type, load_npz_flat(path))
    elif os.path.isdir(path):
        raise ValueError(
            f"{path} is a directory (an Orbax checkpoint?): Orbax is a JAX "
            f"format the port does not read. Export the weights with "
            f"ddti_tpu.train.checkpoint.save_params_npz or "
            f"ddti_tpu.train.torch_interop.save_pth")
    else:
        raise ValueError(f"unknown checkpoint format: {path} "
                         f"(expected .pth or .npz)")
    model.load_state_dict(sd, strict=True)
    return model


def save_weights(base: str, model_type: str, model: nn.Module,
                 state_dict: dict | None = None) -> None:
    """Write ``base + ".npz"`` (``save_params_npz`` layout) and
    ``base + ".pth"`` (the reference's ``state_dict``) of ``model``, or of
    ``state_dict`` where given (the Trainer's EMA weights), each through a
    temporary file so a reader never sees a torn one."""
    if state_dict is None:
        state_dict = model.state_dict()
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    tmp = base + ".tmp.npz"
    np.savez(tmp, **flat_flax_from_state_dict(model_type, sd))
    os.replace(tmp, base + ".npz")
    torch.save(sd, base + ".tmp.pth")
    os.replace(base + ".tmp.pth", base + ".pth")
