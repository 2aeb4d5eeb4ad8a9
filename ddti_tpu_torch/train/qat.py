"""Quantization-aware training (QAT) for the int8 serving path, ported from
``ddti_tpu/train/qat.py``.

Every tracked conv (the set ``train/quantize.py`` quantizes, filtered by
``--quant_min_channels``) runs its training forward through
fake-quantization: per-output-channel symmetric int8 rounding of its
weight and per-tensor symmetric int8 rounding of its input, with JAX's
clipped straight-through estimator, so the weights learn to sit on the
int8 grid. Activation ranges are an amax EMA over the whole run
(``TrainState.qstats``: one float32 scalar per conv, keyed by its
'/'-joined flax path), which the int8 export takes in place of one-batch
calibration (``quantize_serving(amax=qstats_amax(...))``).

The forward swap is ``train/quantize.py``'s (``swapped_forwards``); a
forward returns the batch amax of each tracked conv's input through the
``observed`` dict it is given (stop-gradient float32 tensors on the
device, combined by max: under ``--grad_accum`` over the microbatches, as
JAX's accumulation scan does). Under ``--remat`` a rematerialised block's
recomputation (``models/blocks.py:recomputing``) reuses the forward's
scale and records nothing, so an observation is neither lost nor counted
twice (JAX threads them through a flax collection; ``013a289``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ddti_tpu_torch.models.blocks import DownConv2x2, recomputing

from .quantize import (
    RECIP_127,
    _autocast_bf16,
    conv_modules,
    flax_kernel,
)


def fake_quant(x: torch.Tensor, scale: torch.Tensor,
               bound: torch.Tensor | None = None) -> torch.Tensor:
    """Symmetric int8 fake-quantization with the clipped straight-through
    estimator (JAX ``fake_quant``): forward ``clip(round(x / s), -127,
    127) * s``, as ``x + sg(q - x)`` inside |x| <= 127 s (or ``bound``),
    where the gradient passes unchanged, and ``sg(q)`` outside, where it
    is zero. ``scale`` broadcasts and takes no gradient."""
    scale = scale.detach()
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0) * scale
    inside = x.abs() <= (127.0 * scale if bound is None else bound)
    return torch.where(inside, x + (q - x).detach(), q.detach())


# 127 * RECIP_127 in float32, the factor of XLA's folded activation bound
_ONE_127 = float(np.float32(127) * np.float32(RECIP_127))


def _weight_scale_shape(mod: nn.Module, weight: torch.Tensor) -> list:
    """Broadcast shape of a per-output-channel scale on a torch weight:
    dim 0 of a Conv2d's (O, I, kh, kw), dim 1 of a ConvTranspose2d's (I,
    O, kh, kw)."""
    shape = [1] * weight.dim()
    shape[1 if isinstance(mod, nn.ConvTranspose2d) else 0] = -1
    return shape


def _fq_conv(mod: nn.Module, x: torch.Tensor,
             amax: torch.Tensor) -> torch.Tensor:
    """One conv forward with fake-quantized weight and input (JAX
    ``_fq_conv``, its scales and clip bounds as XLA compiles them: / 127
    as * RECIP_127, the activations' bound folded):
    the serving graph's roundings, differentiable, computed at the
    module's dtype (bf16 under bf16 autocast)."""
    w = mod.weight.to(torch.float32)
    dims = (0, 2, 3) if isinstance(mod, nn.ConvTranspose2d) else (1, 2, 3)
    sw = torch.clamp_min(w.abs().amax(dim=dims) * RECIP_127, 1e-12)
    wq = fake_quant(w, sw.view(_weight_scale_shape(mod, w)))
    a = torch.clamp_min(amax, 1e-12)
    # XLA folds the clip bound 127 * (a * (1/127)) into a * (127 * (1/127))
    xq = fake_quant(x.to(torch.float32), a * RECIP_127,
                    bound=(a * _ONE_127).detach())
    cd = torch.bfloat16 if _autocast_bf16(x.device.type) else x.dtype
    xq, wq = xq.to(cd), wq.to(cd)
    with torch.autocast(x.device.type, enabled=False):
        if isinstance(mod, nn.ConvTranspose2d):
            y = F.conv_transpose2d(xq, wq, None, mod.stride, mod.padding,
                                   mod.output_padding, mod.groups,
                                   mod.dilation)
        else:
            if isinstance(mod, DownConv2x2):  # flax SAME on odd sides
                h, wd = xq.shape[-2:]
                if h % 2 or wd % 2:
                    xq = F.pad(xq, (0, wd % 2, 0, h % 2))
            y = F.conv2d(xq, wq, None, mod.stride, mod.padding,
                         mod.dilation, mod.groups)
        if mod.bias is not None:
            y = y + mod.bias.to(cd).view(1, -1, 1, 1)
    return y


def tracked_paths(model: nn.Module, input_shape, min_channels: int = 0,
                  model_type: str | None = None) -> list:
    """The flax paths of the quantizable convs an eval forward of an input
    of ``input_shape`` (NCHW) runs, filtered by ``min_channels`` on
    max(cin, cout), sorted (JAX ``init_qstats``' set). JAX traces that
    forward abstractly; here it runs, once, on a zero frame (a TransUNet's
    launches its flash kernels)."""
    mods = conv_modules(model, model_type)
    seen: set = set()
    hooks = [m.register_forward_pre_hook(
        lambda mod, args, path=path: seen.add(path))
        for path, (_, m) in mods.items()]
    was_training = model.training
    p = next(model.parameters())
    try:
        model.eval()
        with torch.no_grad():
            model(torch.zeros(tuple(input_shape), device=p.device))
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    return sorted(
        path for path in seen
        if not min_channels or max(flax_kernel(
            mods[path][1], mods[path][1].weight).shape[2:]) >= min_channels)


def init_qstats(model: nn.Module, input_shape, min_channels: int = 0,
                model_type: str | None = None) -> dict:
    """The activation-range EMA: ``{"path/to/conv": float32 0-d tensor}``
    on the model's device, zero meaning unobserved (the first QAT step
    seeds each entry from its own batch)."""
    dev = next(model.parameters()).device
    return {p: torch.zeros((), dtype=torch.float32, device=dev)
            for p in tracked_paths(model, input_shape, min_channels,
                                   model_type)}


def qat_forwards(model: nn.Module, qstats: dict, observed: dict,
                 model_type: str | None = None) -> dict:
    """``{module: forward}`` for ``swapped_forwards``: every conv tracked
    in ``qstats`` fake-quantized, its batch amax maxed into
    ``observed[path]``; an unobserved entry (0.0) scales by the batch's
    own amax. Convs not in ``qstats`` run their float forward."""
    mods = conv_modules(model, model_type)
    swaps = {}
    for path, ema in qstats.items():
        if path not in mods:
            continue
        m = mods[path][1]

        def forward(x, m=m, path=path, ema=ema):
            fresh = x.detach().to(torch.float32).abs().amax()
            if not recomputing():  # a recomputation observes nothing
                prev = observed.get(path)
                observed[path] = (fresh if prev is None
                                  else torch.maximum(prev, fresh))
            return _fq_conv(m, x, torch.where(ema > 0, ema, fresh))

        swaps[m] = forward
    return swaps


@torch.no_grad()
def update_qstats(qstats: dict, observed: dict, decay: float) -> None:
    """The amax EMA in place (JAX ``TrainState.update_qstats``): ``ema <-
    d * ema + (1 - d) * batch_amax`` in float32, an unobserved entry (0)
    seeded by the batch; entries without an observation keep their
    value. Device-side, no host read (a CUDA graph captures it)."""
    d = np.float32(decay)
    keep, take = float(d), float(np.float32(1) - d)  # JAX's float32 d, 1-d
    for p, old in qstats.items():
        a = observed.get(p)
        if a is None:
            continue
        old.copy_(torch.where(old > 0, old * keep + a * take, a))


def qstats_amax(qstats: dict) -> dict:
    """Learned ranges -> the ``{path: float}`` that ``quantize_serving(
    amax=...)`` takes; zero (unobserved) entries are dropped, so those
    convs stay float, as they trained."""
    out = {}
    for p, v in (qstats or {}).items():
        f = float(v)
        if f > 0.0:
            out[p] = f
    return out
