"""Batched training augmentation, ported from ``ddti_tpu/data/augment.py``:
the chain in the JAX package's order, [Crop(p_crop)] -> [Elastic(.25)] ->
Flip(.5 h, .5 v) + Rotate(.5, U(-180, 180), nearest) -> AdjustBrightness(
.5, U(0.5, 1.5)) -> [Speckle(.3)] -> [TGC(.25)] -> [CLAHE(.3)] ->
Resize(out_size, bilinear, image AND mask: soft mask targets, QUIRKS #8),
then batch mixup. The flip + rotate is the Paeth three-shear warp
(``fast_warp``, the training default) or the exact PIL map
(``--aug_exact_warp``, and every non-square frame); ``shared_geometry``
draws one flip/rotation for the whole batch.

Inputs are float32 NHWC in [0, 1]. Every random choice arrives as an
explicit tensor (``AugmentDraws``, ``MixupDraws``): the JAX package's
threefry keys and torch's generators never give the same numbers, so the
tests feed both packages the same draws, and the Trainer draws them with
``sample_draws`` / ``sample_mixup``: the per-image scalars from an explicit
CPU ``torch.Generator``, the frame-sized fields (elastic's two uniform
fields, speckle's normal one) from a generator on the training device, and
only for the images whose gate is on. The elastic, speckle and CLAHE
branches work on those images alone (their indices are known on the host
when the draws are made, so no step reads the device).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch

from ddti_tpu_torch.ops.clahe import clahe_float
from ddti_tpu_torch.ops.resample import (
    fused_flip_rotate,
    gaussian_blur_17,
    paeth_flip_rotate,
    remap_pair,
    resize_bilinear_hw,
)

from .dataset import to_device


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """Augmentation switches, probabilities and ranges (JAX
    ``AugmentConfig``; ``fast_warp`` defaults on here, the training
    Config's default, where the JAX dataclass defaults it off)."""

    use_elastic: bool = False
    use_speckle: bool = False
    use_tgc: bool = False
    use_clahe: bool = False
    p_crop: float = 0.0
    crop_frac: float = 0.8   # crop window as a fraction of H and W
    p_elastic: float = 0.25
    p_flip: float = 0.5
    p_rotate: float = 0.5
    p_brightness: float = 0.5
    p_speckle: float = 0.3
    p_tgc: float = 0.25
    p_clahe: float = 0.3
    elastic_alpha: tuple = (20.0, 40.0)
    elastic_sigma: tuple = (6.0, 10.0)
    speckle_sigma: tuple = (0.05, 0.15)
    tgc_bins: int = 10
    tgc_gain: tuple = (0.8, 1.2)
    clahe_clip: float = 2.0
    clahe_grid: tuple = (4, 4)
    brightness: tuple = (0.5, 1.5)
    out_size: tuple = (512, 512)
    shared_geometry: bool = False
    fast_warp: bool = True

    def crop_window(self, h: int, w: int) -> tuple:
        return max(int(h * self.crop_frac), 1), max(int(w * self.crop_frac), 1)


class AugmentDraws(NamedTuple):
    """Per-image draws of the chain. The default chain's are (N,) each;
    a branch's are None while the branch is off. ``*_idx`` (K,) int64 are
    the images whose gate is on, and the fields hold those K images
    alone; or, in the dense form (``dense_draws``: the fixed shapes a CUDA
    graph replays), ``*_idx`` is the (N,) bool gate itself, the fields
    hold every image, and the branch runs on all N and keeps the gated
    ones."""

    flip_h: torch.Tensor   # bool
    flip_v: torch.Tensor   # bool
    angle: torch.Tensor    # float32 degrees, 0 where the rotate gate is off
    bright_on: torch.Tensor  # bool
    bright: torch.Tensor   # float32 factor
    crop_on: Optional[torch.Tensor] = None     # bool (N,)
    crop_top: Optional[torch.Tensor] = None    # int64 (N,)
    crop_left: Optional[torch.Tensor] = None   # int64 (N,)
    elastic_idx: Optional[torch.Tensor] = None    # int64 (K,)
    elastic_alpha: Optional[torch.Tensor] = None  # float32 (N,)
    elastic_sigma: Optional[torch.Tensor] = None  # float32 (N,)
    elastic_dx: Optional[torch.Tensor] = None     # U(-1, 1) (K, H, W)
    elastic_dy: Optional[torch.Tensor] = None     # U(-1, 1) (K, H, W)
    speckle_idx: Optional[torch.Tensor] = None    # int64 (K,)
    speckle_sigma: Optional[torch.Tensor] = None  # float32 (N,)
    speckle_noise: Optional[torch.Tensor] = None  # N(0, 1) (K, H, W)
    tgc_on: Optional[torch.Tensor] = None     # bool (N,)
    tgc_gains: Optional[torch.Tensor] = None  # float32 (N, tgc_bins)
    clahe_idx: Optional[torch.Tensor] = None  # int64 (K,)

    def to(self, device) -> "AugmentDraws":
        return AugmentDraws(*(None if t is None else to_device(t, device)
                              for t in self))


class MixupDraws(NamedTuple):
    lam: torch.Tensor      # float32 scalar, 1.0 where the mixup gate is off
    perm: torch.Tensor     # int64 (N,)

    def to(self, device) -> "MixupDraws":
        return MixupDraws(*(to_device(t, device) for t in self))


_GATED = (("elastic_idx", ("elastic_dx", "elastic_dy")),
          ("speckle_idx", ("speckle_noise",)), ("clahe_idx", ()))


def dense_draws(draws: AugmentDraws, n: int) -> AugmentDraws:
    """``draws`` with every gated branch in the dense form: ``*_idx`` the
    (N,) bool gate, each field (N, H, W), zeros where the gate is off.
    ``augment_batch`` gives each image the same values from either form,
    bit for bit: every op of those branches is per image."""
    out = {}
    for name, fields in _GATED:
        idx = getattr(draws, name)
        if idx is None or idx.dtype == torch.bool:
            continue
        out[name] = torch.zeros(n, dtype=torch.bool,
                                device=idx.device).index_fill_(0, idx, True)
        for f in fields:
            k = getattr(draws, f)
            out[f] = k.new_zeros((n, *k.shape[1:])).index_copy_(
                0, idx.to(k.device), k)
    return draws._replace(**out)


def take_rows(draws: AugmentDraws, rows: torch.Tensor) -> AugmentDraws:
    """The draws of the images at positions ``rows`` (int64, a subset of
    the batch in any order), in that order: a data-parallel rank's part of
    the global batch's draws. Per-image tensors are indexed; a gated
    branch keeps its gated images among ``rows``, renumbered (the sparse
    form) or its gate and fields indexed (the dense form)."""
    rows = rows.to(torch.int64).cpu()
    gated = {name for name, _ in _GATED} | {
        f for _, fields in _GATED for f in fields}
    out = {}
    for name, t in zip(AugmentDraws._fields, draws):
        if t is not None and name not in gated:
            out[name] = t[rows.to(t.device)]
    pos = {int(r): i for i, r in enumerate(rows)}
    for name, fields in _GATED:
        idx = getattr(draws, name)
        if idx is None:
            continue
        if idx.dtype == torch.bool:
            out[name] = idx[rows.to(idx.device)]
            for f in fields:
                t = getattr(draws, f)
                out[f] = t[rows.to(t.device)]
            continue
        hit = sorted((pos[int(g)], j) for j, g in enumerate(idx)
                     if int(g) in pos)
        out[name] = torch.tensor([p for p, _ in hit], dtype=torch.int64,
                                 device=idx.device)
        which = torch.tensor([j for _, j in hit], dtype=torch.int64)
        for f in fields:
            t = getattr(draws, f)
            out[f] = t[which.to(t.device)]
    return AugmentDraws(**out)


def shard_draws(draws: AugmentDraws | None, mix: MixupDraws | None,
                rows: torch.Tensor):
    """A data-parallel rank's share of one global train step: ``rows`` are
    its images of the global batch (``parallel.mesh.local_rows``), in the
    order its microbatches take them. Returns ``(keep, draws, mix)``:
    ``keep`` the global positions whose frames the rank augments, ``rows``
    first, then the mixup partners of ``rows`` held by other ranks (mixup
    permutes across the global batch, and augmenting a frame is per image,
    so the rank augments those partners itself instead of fetching them);
    the chain's draws of ``keep`` (None where ``draws`` is); and mixup's
    draws with ``perm`` giving each of ``rows`` its partner's position in
    ``keep``, so ``mixup`` returns the rank's ``len(rows)`` images (None
    where ``mix`` is)."""
    rows = rows.to(torch.int64).cpu()
    keep = [int(r) for r in rows]
    if mix is not None:
        pos = {g: i for i, g in enumerate(keep)}
        partners = []
        for p in mix.perm.cpu()[rows].tolist():
            if p not in pos:
                pos[p] = len(keep)
                keep.append(p)
            partners.append(pos[p])
        mix = MixupDraws(mix.lam, torch.tensor(partners, dtype=torch.int64,
                                               device=mix.perm.device))
    keep = torch.tensor(keep, dtype=torch.int64)
    return keep, None if draws is None else take_rows(draws, keep), mix


def _uniform(g, n, lo, hi):
    return lo + (hi - lo) * torch.rand(n, generator=g)


def gate_index(on: torch.Tensor) -> torch.Tensor:
    """The indices (K,) int64 of the images whose gate ``on`` (N,) is set."""
    return torch.nonzero(on.cpu())[:, 0]


def _field(field_gen: torch.Generator | None, g: torch.Generator,
           shape: tuple, normal: bool = False) -> torch.Tensor:
    """A frame-sized draw, on ``field_gen``'s device when one is given."""
    gen = field_gen if field_gen is not None else g
    out = torch.empty(shape, device=gen.device)
    return (out.normal_(generator=gen) if normal
            else out.uniform_(-1.0, 1.0, generator=gen))


def sample_draws(g: torch.Generator, n: int, cfg: AugmentConfig,
                 hw: tuple | None = None,
                 field_gen: torch.Generator | None = None) -> AugmentDraws:
    """The chain's draws for ``n`` frames of ``hw`` (H, W) from ``g`` (a
    CPU generator, so the same seed gives the same per-image draws
    whatever device trains); the elastic and speckle fields from
    ``field_gen`` (a generator on the training device) or else from ``g``.
    ``hw`` is needed only by the crop, elastic and speckle branches."""
    m = 1 if cfg.shared_geometry else n
    flip_h = torch.rand(m, generator=g) < cfg.p_flip
    flip_v = torch.rand(m, generator=g) < cfg.p_flip
    rot_on = torch.rand(m, generator=g) < cfg.p_rotate
    angle = _uniform(g, m, -180.0, 180.0) * rot_on
    if cfg.shared_geometry:  # one draw for the batch
        flip_h, flip_v, angle = (t.expand(n).clone()
                                 for t in (flip_h, flip_v, angle))
    bright_on = torch.rand(n, generator=g) < cfg.p_brightness
    bright = _uniform(g, n, *cfg.brightness)
    extra = {}
    if cfg.p_crop > 0:
        h, w = hw
        ch, cw = cfg.crop_window(h, w)
        extra.update(
            crop_on=torch.rand(n, generator=g) < cfg.p_crop,
            crop_top=torch.randint(0, h - ch + 1, (n,), generator=g),
            crop_left=torch.randint(0, w - cw + 1, (n,), generator=g))
    if cfg.use_elastic:
        idx = gate_index(torch.rand(n, generator=g) < cfg.p_elastic)
        extra.update(
            elastic_idx=idx,
            elastic_alpha=_uniform(g, n, *cfg.elastic_alpha),
            elastic_sigma=_uniform(g, n, *cfg.elastic_sigma),
            elastic_dx=_field(field_gen, g, (len(idx), *hw)),
            elastic_dy=_field(field_gen, g, (len(idx), *hw)))
    if cfg.use_speckle:
        idx = gate_index(torch.rand(n, generator=g) < cfg.p_speckle)
        extra.update(
            speckle_idx=idx,
            speckle_sigma=_uniform(g, n, *cfg.speckle_sigma),
            speckle_noise=_field(field_gen, g, (len(idx), *hw), True))
    if cfg.use_tgc:
        extra.update(
            tgc_on=torch.rand(n, generator=g) < cfg.p_tgc,
            tgc_gains=_uniform(g, (n, cfg.tgc_bins), *cfg.tgc_gain))
    if cfg.use_clahe:
        extra.update(clahe_idx=gate_index(
            torch.rand(n, generator=g) < cfg.p_clahe))
    return AugmentDraws(flip_h, flip_v, angle, bright_on, bright, **extra)


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


def _need(draws: AugmentDraws, *names) -> list:
    vals = [getattr(draws, k) for k in names]
    if any(v is None for v in vals):
        raise ValueError(f"the config enables a branch whose draws "
                         f"{names} are missing (sample_draws makes them)")
    return vals


def _crop(img, mask, draws: AugmentDraws, cfg: AugmentConfig):
    """RandomCrop analogue (JAX ``_crop_one``): a (crop_frac H, crop_frac
    W) window at the drawn offset, resized back to (H, W), image and
    mask."""
    on, top, left = _need(draws, "crop_on", "crop_top", "crop_left")
    n, h, w = img.shape
    ch, cw = cfg.crop_window(h, w)
    dev = img.device
    rows = top[:, None] + torch.arange(ch, device=dev)
    cols = left[:, None] + torch.arange(cw, device=dev)
    t = torch.stack([img, mask], 1)
    t = t[torch.arange(n, device=dev)[:, None, None, None],
          torch.arange(2, device=dev)[None, :, None, None],
          rows[:, None, :, None], cols[:, None, None, :]]
    t = torch.where(on[:, None, None, None], resize_bilinear_hw(t, h, w),
                    torch.stack([img, mask], 1))
    return t[:, 0], t[:, 1]


def _elastic(img, mask, draws: AugmentDraws):
    """ElasticDeform (JAX ``_elastic_one``) of the gated images: two
    uniform fields blurred by a 17-tap Gaussian of sigma, scaled by alpha,
    displace a cv2.remap (image bilinear, mask nearest, reflected)."""
    idx, alpha, sigma, fdx, fdy = _need(
        draws, "elastic_idx", "elastic_alpha", "elastic_sigma", "elastic_dx",
        "elastic_dy")
    dense = idx.dtype == torch.bool
    if not dense and not len(idx):
        return img, mask
    if not dense:
        alpha, sigma = alpha[idx], sigma[idx]
    h, w = img.shape[-2:]
    a = alpha[:, None, None]
    dx = gaussian_blur_17(fdx, sigma) * a
    dy = gaussian_blur_17(fdy, sigma) * a
    yy = torch.arange(h, dtype=torch.float32, device=img.device)[:, None]
    xx = torch.arange(w, dtype=torch.float32, device=img.device)[None, :]
    if dense:
        i2, m2 = remap_pair(img, mask, yy + dy, xx + dx)
        return _keep(idx, i2, img), _keep(idx, m2, mask)
    i2, m2 = remap_pair(img[idx], mask[idx], yy + dy, xx + dx)
    return img.index_copy(0, idx, i2), mask.index_copy(0, idx, m2)


def _keep(on, new, old):
    """The dense form's select: ``new`` where the (N,) gate is on."""
    return torch.where(on[:, None, None], new, old)


def _speckle(img, draws: AugmentDraws):
    """Multiplicative speckle (JAX ``_speckle_one``): clip(x + x * n *
    sigma) on the gated images."""
    idx, sigma, field = _need(draws, "speckle_idx", "speckle_sigma",
                              "speckle_noise")
    if idx.dtype == torch.bool:
        noise = field * sigma[:, None, None]
        return _keep(idx, torch.clamp(img + img * noise, 0.0, 1.0), img)
    if not len(idx):
        return img
    x = img[idx]
    noise = field * sigma[idx][:, None, None]
    return img.index_copy(0, idx, torch.clamp(x + x * noise, 0.0, 1.0))


def _tgc(img, draws: AugmentDraws, bins: int):
    """Per-depth-band gain (JAX ``_tgc_one``): rows [i bin_h, (i + 1)
    bin_h) take gain i; the remainder strip below bins * bin_h keeps gain
    1, the reference's quirk."""
    on, gains = _need(draws, "tgc_on", "tgc_gains")
    h = img.shape[1]
    rows = torch.arange(h, device=img.device) // max(h // bins, 1)
    g = torch.where(rows < bins, gains[:, rows.clamp(0, bins - 1)],
                    torch.ones((), device=img.device))
    out = torch.clamp(img * g[:, :, None], 0.0, 1.0)
    return torch.where(on[:, None, None], out, img)


def augment_batch(images: torch.Tensor, masks: torch.Tensor,
                  draws: AugmentDraws, cfg: AugmentConfig):
    """images/masks: (N, H, W, 1) float32 in [0, 1] -> (N, out_h, out_w,
    1), through the enabled branches in the JAX chain's order: crop,
    elastic, flips + rotate (Paeth on square frames with ``fast_warp``,
    else the exact map), brightness, speckle, TGC, CLAHE, then the resize
    to ``cfg.out_size`` (image and mask; elided when equal)."""
    img, mask = images[..., 0], masks[..., 0]
    h, w = img.shape[1:3]
    if cfg.p_crop > 0:
        img, mask = _crop(img, mask, draws, cfg)
    if cfg.use_elastic:
        img, mask = _elastic(img, mask, draws)
    warp = (paeth_flip_rotate if cfg.fast_warp and h == w
            else fused_flip_rotate)
    img, mask = warp(img, mask, draws.flip_h, draws.flip_v, draws.angle)
    f = draws.bright[:, None, None]
    img = torch.where(draws.bright_on[:, None, None],
                      torch.clamp(img * f, 0.0, 1.0), img)
    if cfg.use_speckle:
        img = _speckle(img, draws)
    if cfg.use_tgc:
        img = _tgc(img, draws, cfg.tgc_bins)
    if cfg.use_clahe:
        (idx,) = _need(draws, "clahe_idx")
        if idx.dtype == torch.bool:
            img = _keep(idx, clahe_float(img, cfg.clahe_clip,
                                         tuple(cfg.clahe_grid)), img)
        elif len(idx):
            img = img.index_copy(0, idx, clahe_float(
                img[idx], cfg.clahe_clip, tuple(cfg.clahe_grid)))
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
    (soft labels), as the reference Trainer applies mixup. A ``perm``
    shorter than the batch (``shard_draws``) blends its first
    ``len(perm)`` images with the ones it names and returns those."""
    lam, perm = draws
    n = perm.shape[0]
    return (lam * images[:n] + (1.0 - lam) * images[perm],
            lam * masks[:n] + (1.0 - lam) * masks[perm])
