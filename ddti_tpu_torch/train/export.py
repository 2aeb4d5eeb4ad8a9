"""The serving computation, ported from ``ddti_tpu/train/export.py``
(``serve_body`` and ``make_serve_fn``; the StableHLO bundle export is JAX
only). uint8 NHWC frames in, uint8 NHWC {0, 1} masks out, as in JAX."""

from __future__ import annotations

import torch
from torch import nn


def serve_body(model: nn.Module, images: torch.Tensor,
               threshold: float = 0.5,
               compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``images``: (B, S, S, C) uint8 in [0, 255] or float in [0, 1], on the
    model's device. Returns (B, S, S, out_channels) uint8 masks. With
    ``compute_dtype=torch.bfloat16`` the model runs under bf16 autocast:
    parameters and BatchNorm statistics stay float32, as in JAX. A
    deep-supervision model's heads are dropped: its main logits decide."""
    x = images.permute(0, 3, 1, 2)
    if images.dtype == torch.uint8:
        x = x.to(compute_dtype) / 255.0
    with torch.autocast(x.device.type, dtype=torch.bfloat16,
                        enabled=compute_dtype == torch.bfloat16):
        logits = model(x)
    if isinstance(logits, tuple):
        logits = logits[0]
    probs = torch.sigmoid(logits.float())
    return (probs > threshold).to(torch.uint8).permute(0, 2, 3, 1)


def make_serve_fn(model: nn.Module, threshold: float = 0.5,
                  compute_dtype: torch.dtype = torch.float32):
    """Closed-over inference function -> uint8 masks, run in eval mode
    under ``torch.inference_mode``."""
    model.eval()

    @torch.inference_mode()
    def serve(images: torch.Tensor) -> torch.Tensor:
        return serve_body(model, images, threshold, compute_dtype)

    return serve
