"""Geometric warps of the training augmentation, ported from
``ddti_tpu/ops/resample.py``: the default recipe's Paeth three-shear
flip + rotate and the bilinear resize.

The JAX package works on one (H, W) image under ``vmap``; here every
function takes a batch and per-image parameters as tensors. The exact
PIL-map warp (``fused_flip_rotate``, ``--aug_exact_warp``), ``remap`` and
the Gaussian blur of the elastic branch are still to port (ROADMAP.md
Queue 1).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _barrel_roll_x(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """t (N, P, H, W), s (N, H) int -> out[n, p, y, x] = t[n, p, y,
    x + s[n, y]], zero outside [0, W). The JAX package shifts whole rows
    with log2(W) conditional rolls; a gather of the same indices moves the
    same pixels."""
    w = t.shape[-1]
    src = torch.arange(w, device=t.device) + s[:, None, :, None]
    valid = (src >= 0) & (src < w)
    out = torch.gather(t, -1, src.clamp(0, w - 1).expand_as(t))
    return torch.where(valid, out, torch.zeros((), dtype=t.dtype,
                                               device=t.device))


def _barrel_roll_y(t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """t (N, P, H, W), s (N, W) int -> out[n, p, y, x] = t[n, p,
    y + s[n, x], x], zero outside [0, H) (per-column shifts)."""
    h = t.shape[-2]
    src = torch.arange(h, device=t.device)[:, None] + s[:, None, None, :]
    valid = (src >= 0) & (src < h)
    out = torch.gather(t, -2, src.clamp(0, h - 1).expand_as(t))
    return torch.where(valid, out, torch.zeros((), dtype=t.dtype,
                                               device=t.device))


def paeth_shifts(angle_deg: torch.Tensor, n: int):
    """Per-image exact quarter turns and Paeth shear shifts, in float32 as
    the JAX package computes them: (k4 (N,), s_x (N, n), s_y (N, n))."""
    theta = -angle_deg.to(torch.float32) * (math.pi / 180.0)
    k = torch.round(theta / (math.pi / 2))
    resid = theta - k * (math.pi / 2)
    k4 = torch.remainder(k.to(torch.int64), 4)
    tx = torch.tan(resid / 2.0)
    ty = -torch.sin(resid)
    centered = (torch.arange(n, dtype=torch.float32, device=theta.device)
                + 0.5 - (n / 2.0))
    s_x = torch.floor(tx[:, None] * centered + 0.5).to(torch.int64)
    s_y = torch.floor(ty[:, None] * centered + 0.5).to(torch.int64)
    return k4, s_x, s_y


def paeth_flip_rotate(img: torch.Tensor, mask: torch.Tensor,
                      flip_h: torch.Tensor, flip_v: torch.Tensor,
                      angle_deg: torch.Tensor) -> tuple:
    """Flip(s) then a PIL-convention counter-clockwise nearest rotation
    about the centre, zero fill, as a Paeth three-shear warp: an exact
    quarter-turn pre-rotation selected on k = round(angle / 90) and a
    residual rotation of at most 45 degrees as shear_x . shear_y . shear_x
    with integer per-row/column shifts (QUIRKS #23: a sub-pixel
    nearest-rounding divergence from the direct PIL map).

    img, mask: (N, H, W) float with H == W; flip_h, flip_v: (N,) bool;
    angle_deg: (N,) float. Returns the warped (img, mask)."""
    n, h, w = img.shape
    if h != w:
        raise ValueError(
            "paeth_flip_rotate requires square images; the exact warp for "
            "other frames (fused_flip_rotate) is not ported yet (ROADMAP.md "
            "Queue 1)")
    t = torch.stack([img, mask], dim=1)  # (N, 2, H, W): one shift plan
    # flips happen before the rotation in the sequential chain
    t = torch.where(flip_h[:, None, None, None], t.flip(-1), t)
    t = torch.where(flip_v[:, None, None, None], t.flip(-2), t)
    k4, s_x, s_y = paeth_shifts(angle_deg, h)
    tt = t.transpose(-1, -2)
    k4 = k4[:, None, None, None]
    t = torch.where(k4 == 1, tt.flip(-1),              # 90
                    torch.where(k4 == 2, t.flip(-2, -1),  # 180
                                torch.where(k4 == 3, tt.flip(-2), t)))  # 270
    t = _barrel_roll_x(t, s_x)
    t = _barrel_roll_y(t, s_y)
    t = _barrel_roll_x(t, s_x)
    return t[:, 0], t[:, 1]


def resize_bilinear_hw(img: torch.Tensor, h: int, w: int, *,
                       antialias: bool = True) -> torch.Tensor:
    """Bilinear resize of (..., H, W) to (..., h, w), half-pixel centres.
    ``antialias=True`` widens the triangle filter by the downscale ratio
    (PIL ``BILINEAR``, the JAX default); ``antialias=False`` samples source
    points (``F.interpolate(align_corners=False)``). The two agree on
    upscale."""
    lead = img.shape[:-2]
    x = img.reshape(-1, 1, *img.shape[-2:])
    out = F.interpolate(x, size=(h, w), mode="bilinear", align_corners=False,
                        antialias=antialias)
    return out.reshape(*lead, h, w)
