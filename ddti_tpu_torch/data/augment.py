"""Batched training augmentation, ported from ``ddti_tpu/data/augment.py``:
the default chain Flip(.5 h, .5 v) -> Rotate(.5, U(-180, 180), nearest,
Paeth three-shear) -> AdjustBrightness(.5, U(0.5, 1.5)) -> Resize(out_size,
bilinear, image AND mask: soft mask targets, QUIRKS #8), then batch mixup.

Inputs are float32 NHWC in [0, 1]. Every random choice arrives as an
explicit tensor (``AugmentDraws``, ``MixupDraws``): the JAX package's
threefry keys and torch's generators never give the same numbers, so the
tests feed both packages the same draws, and the Trainer draws them with
``sample_draws`` / ``sample_mixup`` from an explicit ``torch.Generator``.
The elastic, speckle, TGC, CLAHE and crop branches, the batch-shared
geometry and the exact PIL-map warp raise when enabled (ROADMAP.md
Queue 1).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ddti_tpu_torch.ops.resample import paeth_flip_rotate, resize_bilinear_hw

from .dataset import to_device


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Augmentation switches and probabilities (JAX ``AugmentConfig``; the
    unported branches' switches stay so that a request for them raises)."""

    use_elastic: bool = False
    use_speckle: bool = False
    use_tgc: bool = False
    use_clahe: bool = False
    p_crop: float = 0.0
    p_flip: float = 0.5
    p_rotate: float = 0.5
    p_brightness: float = 0.5
    brightness: tuple = (0.5, 1.5)
    out_size: tuple = (512, 512)
    shared_geometry: bool = False
    fast_warp: bool = True

    def check_ported(self) -> None:
        unported = [name for name, on in (
            ("use_elastic", self.use_elastic),
            ("use_speckle", self.use_speckle), ("use_tgc", self.use_tgc),
            ("use_clahe", self.use_clahe), ("p_crop", self.p_crop > 0),
            ("shared_geometry", self.shared_geometry),
            ("exact warp (fast_warp=False)", not self.fast_warp)) if on]
        if unported:
            raise NotImplementedError(
                f"augmentation {', '.join(unported)} is not ported yet "
                f"(ROADMAP.md Queue 1, item 8)")


class AugmentDraws(NamedTuple):
    """Per-image draws of the default chain, each (N,)."""

    flip_h: torch.Tensor   # bool
    flip_v: torch.Tensor   # bool
    angle: torch.Tensor    # float32 degrees, 0 where the rotate gate is off
    bright_on: torch.Tensor  # bool
    bright: torch.Tensor   # float32 factor

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(*(to_device(t, device) for t in self))


class MixupDraws(NamedTuple):
    lam: torch.Tensor      # float32 scalar, 1.0 where the mixup gate is off
    perm: torch.Tensor     # int64 (N,)

    def to(self, device) -> "MixupDraws":
        return MixupDraws(*(to_device(t, device) for t in self))


def _uniform(g, n, lo, hi):
    return lo + (hi - lo) * torch.rand(n, generator=g)


def sample_draws(g: torch.Generator, n: int,
                 cfg: AugmentConfig) -> AugmentDraws:
    """The chain's draws for ``n`` images from ``g`` (a CPU generator, so
    the same seed gives the same draws whatever device trains)."""
    flip_h = torch.rand(n, generator=g) < cfg.p_flip
    flip_v = torch.rand(n, generator=g) < cfg.p_flip
    rot_on = torch.rand(n, generator=g) < cfg.p_rotate
    angle = _uniform(g, n, -180.0, 180.0) * rot_on
    bright_on = torch.rand(n, generator=g) < cfg.p_brightness
    bright = _uniform(g, n, *cfg.brightness)
    return AugmentDraws(flip_h, flip_v, angle, bright_on, bright)


def _beta(g: torch.Generator, a: float, b: float) -> float:
    """One Beta(a, b) draw from uniforms (Johnk's method, in log space)."""
    while True:
        u, v = torch.rand(2, generator=g, dtype=torch.float64).tolist()
        if u == 0.0 or v == 0.0:
            continue
        lx, ly = math.log(u) / a, math.log(v) / b
        m = max(lx, ly)
        ls = m + math.log(math.exp(lx - m) + math.exp(ly - m))
        if ls <= 0.0:  # X + Y <= 1: accept X / (X + Y)
            return math.exp(lx - ls)


def sample_mixup(g: torch.Generator, n: int, alpha: float,
                 prob: float) -> MixupDraws:
    """With probability ``prob`` one lambda ~ Beta(alpha, alpha) for the
    whole batch, else 1.0; a random permutation of the batch."""
    on = torch.rand((), generator=g).item() < prob
    lam = _beta(g, alpha, alpha)
    perm = torch.randperm(n, generator=g)
    return MixupDraws(torch.tensor(lam if on else 1.0, dtype=torch.float32),
                      perm)


def augment_batch(images: torch.Tensor, masks: torch.Tensor,
                  draws: AugmentDraws, cfg: AugmentConfig):
    """images/masks: (N, H, W, 1) float32 in [0, 1] -> (N, out_h, out_w,
    1): flips + Paeth rotate (image and mask alike), brightness (image),
    then the resize to ``cfg.out_size`` (both; elided when equal)."""
    cfg.check_ported()
    img, mask = paeth_flip_rotate(images[..., 0], masks[..., 0],
                                  draws.flip_h, draws.flip_v, draws.angle)
    f = draws.bright[:, None, None]
    img = torch.where(draws.bright_on[:, None, None],
                      torch.clamp(img * f, 0.0, 1.0), img)
    oh, ow = cfg.out_size
    if (oh, ow) != tuple(img.shape[1:3]):
        img = resize_bilinear_hw(img, oh, ow)
        mask = resize_bilinear_hw(mask, oh, ow)
    return img[..., None], mask[..., None]


def eval_preprocess(images: torch.Tensor, masks: torch.Tensor,
                    out_size: tuple = (512, 512)):
    """The test/val transform: the bilinear resize alone."""
    oh, ow = out_size
    if (oh, ow) == tuple(images.shape[1:3]):
        return images, masks
    return (resize_bilinear_hw(images[..., 0], oh, ow)[..., None],
            resize_bilinear_hw(masks[..., 0], oh, ow)[..., None])


def mixup(images: torch.Tensor, masks: torch.Tensor, draws: MixupDraws):
    """Blend the batch with a permutation of itself, images AND masks
    (soft labels), as the reference Trainer applies mixup."""
    lam, perm = draws
    return (lam * images + (1.0 - lam) * images[perm],
            lam * masks + (1.0 - lam) * masks[perm])
