"""Segmentation loss suite, ported from ``ddti_tpu/losses/losses.py``.

Every function takes raw ``logits`` and float targets in [0, 1] of the same
shape, the JAX package's NHWC ``(N, H, W, C)`` (or ``(N, H, W)``), and
returns a float32 scalar; computation is promoted to float32 so bf16
activations keep their reductions. ``boundary_loss``'s distance map comes
from ``ops/edt.py`` (the CUDA kernel for CUDA tensors) and carries no
gradient, like the reference's detached numpy map.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ddti_tpu_torch.ops.edt import edt_batch


def _f32(x):
    return x.to(torch.float32)


def dice_loss(logits, targets, smooth: float = 1.0):
    """1 - mean per-sample soft dice on sigmoid probabilities."""
    probs = torch.sigmoid(_f32(logits))
    n = probs.shape[0]
    p = probs.reshape(n, -1)
    t = _f32(targets).reshape(n, -1)
    inter = (p * t).sum(1)
    union = p.sum(1) + t.sum(1)
    dice = (2.0 * inter + smooth) / (union + smooth)
    return 1.0 - dice.mean()


def bce_with_logits_loss(logits, targets):
    """Mean binary cross-entropy on logits (numerically stable form)."""
    x = _f32(logits)
    t = _f32(targets)
    # max(x,0) - x*t + log(1+exp(-|x|))
    return (F.relu(x) - x * t + torch.log1p(torch.exp(-x.abs()))).mean()


def focal_tversky_loss(logits, targets, alpha: float = 0.4,
                       beta: float = 0.6, gamma: float = 2.0,
                       smooth: float = 1e-6):
    """(1 - TI)^gamma on the globally flattened Tversky index."""
    probs = torch.sigmoid(_f32(logits)).reshape(-1)
    t = _f32(targets).reshape(-1)
    tp = (probs * t).sum()
    fp = (probs * (1.0 - t)).sum()
    fn = ((1.0 - probs) * t).sum()
    ti = (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)
    return (1.0 - ti) ** gamma


def boundary_loss(logits, targets):
    """mean(|p - t| * EDT(1 - t)) averaged over the batch. The distance map
    comes from the target cast to uint8 exactly as the reference casts to
    np.uint8 (soft mixup targets truncate toward 0)."""
    probs = torch.sigmoid(_f32(logits))
    t = _f32(targets)
    gt = t.to(torch.uint8)  # truncation, same as .numpy().astype(uint8)
    if gt.dim() == 4:
        dist = edt_batch(1 - gt[..., 0])[..., None]
    else:
        dist = edt_batch(1 - gt)
    per_sample = ((probs - t).abs() * dist).mean(
        dim=tuple(range(1, probs.dim())))
    return per_sample.mean()


def composite_loss(logits, targets, lam_ft: float = 1.0, lam_b: float = 0.5,
                   lam_bce: float = 0.0, lam_dice: float = 0.0):
    """lam_ft * FocalTversky(0.3, 0.7, 0.75) + lam_b * Boundary
    [+ optional BCE/Dice]: the reference's CompositeLoss, with Tversky
    parameters that differ from the standalone focal loss (QUIRKS #6)."""
    loss = lam_ft * focal_tversky_loss(logits, targets, alpha=0.3, beta=0.7,
                                       gamma=0.75)
    loss = loss + lam_b * boundary_loss(logits, targets)
    if lam_bce > 0:
        loss = loss + lam_bce * bce_with_logits_loss(logits, targets)
    if lam_dice > 0:
        loss = loss + lam_dice * dice_loss(logits, targets)
    return loss


class LossTerms(NamedTuple):
    total: torch.Tensor
    bce: torch.Tensor
    dice: torch.Tensor
    focal: torch.Tensor
    boundary: torch.Tensor


def weighted_loss(logits, targets, *, bce_ratio: float = 1.0,
                  dice_ratio: float = 0.0, focal_ratio: float = 1.0,
                  boundary_ratio: float = 0.0,
                  compute_unused: bool = True) -> LossTerms:
    """The Trainer's 4-term weighted sum, returning every component for
    logging. With ``compute_unused=False`` zero-weighted terms are skipped
    (the reference always computes all four, the boundary term's EDT
    included)."""
    zero = torch.zeros((), dtype=torch.float32, device=logits.device)
    bce = (bce_with_logits_loss(logits, targets)
           if compute_unused or bce_ratio else zero)
    dce = (dice_loss(logits, targets)
           if compute_unused or dice_ratio else zero)
    foc = (focal_tversky_loss(logits, targets)
           if compute_unused or focal_ratio else zero)
    bnd = (boundary_loss(logits, targets)
           if compute_unused or boundary_ratio else zero)
    total = (bce_ratio * bce + dice_ratio * dce + focal_ratio * foc
             + boundary_ratio * bnd)
    return LossTerms(total=total, bce=bce, dice=dce, focal=foc, boundary=bnd)
