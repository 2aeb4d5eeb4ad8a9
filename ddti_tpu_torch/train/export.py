"""The serving computation, ported from ``ddti_tpu/train/export.py``
(``serve_body`` and ``make_serve_fn``, with ``tta``; the StableHLO bundle
export is JAX only). uint8 NHWC frames in, uint8 NHWC {0, 1} masks out, as
in JAX."""

from __future__ import annotations

import torch
from torch import nn

from ddti_tpu_torch.eval.tta import tta_probs


def nhwc_logits(model: nn.Module, images: torch.Tensor,
                bf16: bool = False) -> torch.Tensor:
    """NHWC float images -> the model's NHWC float32 logits, under bf16
    autocast when ``bf16`` (parameters stay float32); a deep-supervision
    model's heads are dropped, its main logits returned."""
    with torch.autocast(images.device.type, dtype=torch.bfloat16,
                        enabled=bf16):
        out = model(images.permute(0, 3, 1, 2))
    if isinstance(out, tuple):
        out = out[0]
    return out.permute(0, 2, 3, 1).float()


def serve_body(model: nn.Module, images: torch.Tensor,
               threshold: float = 0.5,
               compute_dtype: torch.dtype = torch.float32,
               tta: bool = False) -> torch.Tensor:
    """``images``: (B, S, S, C) uint8 in [0, 255] or float in [0, 1], on the
    model's device. Returns (B, S, S, out_channels) uint8 masks. With
    ``compute_dtype=torch.bfloat16`` the model runs under bf16 autocast:
    parameters and BatchNorm statistics stay float32, as in JAX. A
    deep-supervision model's heads are dropped inside each forward: its
    main logits decide. ``tta=True`` thresholds the mean probability of the
    4-way flip ensemble (``eval/tta.py``, four forwards)."""
    if images.dtype == torch.uint8:
        images = images.to(compute_dtype) / 255.0

    def fwd(x):
        return nhwc_logits(model, x, compute_dtype == torch.bfloat16)

    probs = tta_probs(fwd, images) if tta else torch.sigmoid(fwd(images))
    return (probs > threshold).to(torch.uint8)


def make_serve_fn(model: nn.Module, threshold: float = 0.5,
                  compute_dtype: torch.dtype = torch.float32,
                  tta: bool = False):
    """Closed-over inference function -> uint8 masks, run in eval mode
    under ``torch.inference_mode``."""
    model.eval()

    @torch.inference_mode()
    def serve(images: torch.Tensor) -> torch.Tensor:
        return serve_body(model, images, threshold, compute_dtype, tta)

    return serve
