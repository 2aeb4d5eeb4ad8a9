"""Checkpoints, ported from ``ddti_tpu/train/checkpoint.py``: weight files,
the full train state with save, restore and a rotating manager, and the
weights-only loader.

Weights load and save in two formats: a torch ``.pth`` state_dict (the
reference's own files and ``ddti_tpu.train.torch_interop.save_pth``
exports) and a flat ``.npz`` in the layout of
``ddti_tpu.train.checkpoint.save_params_npz`` (flax key paths and
layouts), so either package reads the other's weights.

The full train state (``TrainState.full_state_dict``: parameters and
BatchNorm statistics, AdamW's moments by parameter name, the step and the
EMA shadow) is the port's own format, where the JAX package writes Orbax:
a directory (``<Model>_last``, ``<Model>_best`` under --best_full_state,
``periodic/<epoch>``) holding one ``train_state.pt`` written by
``torch.save`` through a temporary file and ``os.replace``, read with
``weights_only=True``; under ``--qat`` it carries the activation ranges.

Orbax is not read: it needs tensorstore and JAX. The JAX Trainer writes an
``.npz`` (with its ``qstats/`` ranges) beside every best and last Orbax
checkpoint, and that file loads here; for a lone Orbax directory, JAX's
own ``python -m ddti_tpu.cli.average --checkpoints <dir> --output w.npz``,
run where JAX is installed, writes one. A JAX optimizer state does not
resume in the port, nor the port's in JAX (ROADMAP.md).

Also the serving bundles' tensors (``save_variables_npz`` /
``load_variables_npz``: any flat dict of tensors, bf16 as raw bits under
JAX's ``::bf16`` marker) and QAT ranges (``qstats/<path>`` entries of an
``.npz``, ``load_qstats``), in the layouts the JAX package reads.
"""

from __future__ import annotations

import concurrent.futures
import json
import os
import shutil

import numpy as np
import torch
from torch import nn

_BF16_MARKER = "::bf16"
STATE_FILE = "train_state.pt"
_FORMAT = "ddti_tpu_torch.train_state"


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


def map_tensors(tree, fn):
    """``tree`` (nested dicts) with ``fn`` applied to every tensor."""
    if isinstance(tree, dict):
        return {k: map_tensors(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def to_host(tree):
    """A copy of ``tree`` with every tensor on the CPU."""
    return map_tensors(tree, lambda t: t.detach().to("cpu", copy=True))


def is_full_state(path: str) -> bool:
    return os.path.isfile(os.path.join(path, STATE_FILE))


def save_checkpoint(path: str, state) -> None:
    """Write a ``TrainState``'s full state (or such a tree, as
    ``full_state_dict`` returns it) into the directory ``path``: a
    temporary file, then ``os.replace``, so a reader sees the old state
    or the new one, never a torn file."""
    tree = state if isinstance(state, dict) else state.full_state_dict()
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, STATE_FILE + ".tmp")
    torch.save({"format": _FORMAT, **to_host(tree)}, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))


def read_checkpoint(path: str) -> dict:
    """The full-state tree saved in the directory ``path`` (CPU tensors).
    A directory without one (an Orbax checkpoint of the JAX package)
    raises ValueError."""
    if not is_full_state(path):
        raise ValueError(
            f"{path} is a directory without the port's {STATE_FILE} (an "
            f"Orbax checkpoint?): Orbax is a JAX format the port does not "
            f"read. Load the .npz the JAX Trainer writes beside it "
            f"(<Model>_best.npz / <Model>_last.npz, QAT ranges included), "
            f"or write one where JAX is installed: python -m "
            f"ddti_tpu.cli.average --checkpoints {path} --output w.npz")
    tree = torch.load(os.path.join(path, STATE_FILE), map_location="cpu",
                      weights_only=True)
    if tree.get("format") != _FORMAT:
        raise ValueError(f"{path}: not a {_FORMAT} file")
    return tree


def restore_checkpoint(path: str, state):
    """Restore the full state in ``path`` into ``state`` (in place) and
    return it; any structure mismatch raises ValueError."""
    state.load_full_state_dict(read_checkpoint(path))
    return state


class ManagedCheckpointer:
    """Rotating full-state checkpoints (JAX ``ManagedCheckpointer``): one
    numeric step directory each under ``directory``, the newest
    ``max_to_keep`` kept, and ``restore_latest`` for resuming. As with the
    JAX package's Orbax manager, ``save`` copies the state to the host in
    the caller and, with ``async_save``, writes it on a background thread
    while training goes on; ``wait``/``close`` raise a failed write."""

    def __init__(self, directory: str, max_to_keep: int = 3,
                 async_save: bool = True):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max(int(max_to_keep), 1)
        os.makedirs(self.directory, exist_ok=True)
        self._pool = (concurrent.futures.ThreadPoolExecutor(
            1, thread_name_prefix="periodic-saver") if async_save else None)
        self._pending: list = []

    def steps(self) -> list[int]:
        return sorted(int(d) for d in os.listdir(self.directory)
                      if d.isdigit() and is_full_state(
                          os.path.join(self.directory, d)))

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def _write(self, step: int, tree: dict, metrics: dict | None) -> None:
        path = os.path.join(self.directory, str(step))
        save_checkpoint(path, tree)
        if metrics:
            with open(os.path.join(path, "metrics.json"), "w") as f:
                json.dump(metrics, f)
        for old in self.steps()[:-self.max_to_keep]:
            shutil.rmtree(os.path.join(self.directory, str(old)))

    def save(self, step: int, state, metrics: dict | None = None) -> bool:
        """Save the full state at ``step`` (the JAX Trainer passes the
        epoch number) and rotate."""
        tree = to_host(state if isinstance(state, dict)
                       else state.full_state_dict())
        if self._pool is None:
            self._write(int(step), tree, metrics)
        else:
            self._pending.append(self._pool.submit(
                self._write, int(step), tree, metrics))
        return True

    def restore_latest(self, state):
        """``(state, step)`` with the newest checkpoint restored into
        ``state``, or None when there is none."""
        self.wait()
        step = self.latest_step()
        if step is None:
            return None
        return restore_checkpoint(os.path.join(self.directory, str(step)),
                                  state), step

    def wait(self) -> None:
        pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    def close(self) -> None:
        try:
            self.wait()
        finally:
            if self._pool is not None:
                self._pool.shutdown()


def load_checkpoint_into(path: str, model_type: str, model: nn.Module,
                         prefer_ema: bool = True) -> nn.Module:
    """Load the weights of ``path`` (``.pth``, ``.npz`` or a full-state
    directory) into ``model`` with ``strict=True`` and return it. For a
    full state, ``prefer_ema`` (the serving default) takes an --ema_decay
    run's shadow, the weights its metrics describe; training warm starts
    pass False and continue from the live weights (JAX's rule)."""
    if path.endswith(".pth"):
        sd = torch.load(path, map_location="cpu", weights_only=True)
    elif path.endswith(".npz"):
        from .torch_interop import state_dict_from_flax

        sd = state_dict_from_flax(model_type, load_npz_flat(path))
    elif os.path.isdir(path):
        tree = read_checkpoint(path)
        sd = dict(tree["model"])
        if prefer_ema and tree.get("ema"):
            sd.update(tree["ema"])
    else:
        raise ValueError(f"unknown checkpoint format: {path} "
                         f"(expected .pth, .npz or a full-state directory)")
    model.load_state_dict(sd, strict=True)
    return model


def _qstats_entries(qstats: dict | None) -> dict:
    """``{"qstats/<path>": float32 ()}`` of QAT ranges (JAX's layout)."""
    return {f"qstats/{p}": np.asarray(
        v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v,
        np.float32).reshape(()) for p, v in (qstats or {}).items()}


def save_params_npz(path: str, model_type: str, state_dict: dict,
                    qstats: dict | None = None) -> None:
    """``state_dict`` as a ``save_params_npz`` ``.npz`` at ``path``, with
    the QAT ranges ``qstats`` ({path: float}) as ``qstats/<path>`` entries
    where given, through a temporary file."""
    from .torch_interop import flat_flax_from_state_dict

    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat_flax_from_state_dict(model_type, sd),
             **_qstats_entries(qstats))
    os.replace(tmp, path)


def load_qstats(path: str) -> dict | None:
    """QAT activation ranges a checkpoint carries (JAX ``load_qstats``):
    ``qstats/<path>`` entries of an ``.npz`` (either package's) or the
    ``qstats`` of the port's full state. ``{"module/path": float}``, or
    None (a ``.pth`` never carries them)."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            out = {k.split("/", 1)[1]: float(data[k]) for k in data.files
                   if k.startswith("qstats/")}
        return out or None
    if os.path.isdir(path) and is_full_state(path):
        q = read_checkpoint(path).get("qstats") or {}
        return {p: float(v) for p, v in q.items()} or None
    return None


def save_variables_npz(path: str, variables: dict) -> None:
    """A flat dict of tensors as an ``.npz`` keyed by name (JAX
    ``save_variables_npz``): bf16 tensors as their raw bits (uint16) under
    ``<name>::bf16``, which numpy cannot hold otherwise."""
    flat = {}
    for k, v in variables.items():
        t = v.detach().cpu()
        if t.dtype == torch.bfloat16:
            flat[k + _BF16_MARKER] = t.view(torch.int16).numpy().view(
                np.uint16)
        else:
            flat[k] = t.numpy()
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_variables_npz(path: str) -> dict:
    """``save_variables_npz``'s file (or JAX's) -> ``{name: CPU tensor}``,
    bf16 entries restored bit for bit."""
    out = {}
    with np.load(path) as data:
        for k in data.files:
            a = data[k]
            if k.endswith(_BF16_MARKER):
                out[k[:-len(_BF16_MARKER)]] = torch.from_numpy(
                    a.astype(np.uint16).view(np.int16).copy()).view(
                        torch.bfloat16)
            else:
                out[k] = torch.from_numpy(np.array(a))
    return out


def save_weights(base: str, model_type: str, model: nn.Module,
                 state_dict: dict | None = None,
                 qstats: dict | None = None) -> None:
    """Write ``base + ".npz"`` (``save_params_npz`` layout, with the QAT
    ranges ``qstats`` where given) and ``base + ".pth"`` (the reference's
    ``state_dict``) of ``model``, or of ``state_dict`` where given (the
    Trainer's EMA weights), each through a temporary file so a reader
    never sees a torn one."""
    if state_dict is None:
        state_dict = model.state_dict()
    sd = {k: v.detach().cpu() for k, v in state_dict.items()}
    save_params_npz(base + ".npz", model_type, sd, qstats)
    torch.save(sd, base + ".tmp.pth")
    os.replace(base + ".tmp.pth", base + ".pth")
