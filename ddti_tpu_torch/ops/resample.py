"""Geometric warps of the training augmentation, ported from
``ddti_tpu/ops/resample.py``: the Paeth three-shear flip + rotate (the
default), the exact PIL-map flip + rotate (``fused_flip_rotate``,
``--aug_exact_warp`` and every non-square frame), PIL's ``rotate``,
cv2's ``remap`` with BORDER_REFLECT (``remap``, ``remap_pair``), the
elastic branch's 17-tap Gaussian blur and the bilinear resize.

The JAX package works on one (H, W) image under ``vmap``; here every
function takes a batch and per-image parameters as tensors. Coordinates
are float32 and built in the JAX package's order, so the floors that pick
a nearest source pixel agree with it except where a one-ulp difference of
sin/cos moves a coordinate across an integer. The TPU gather layouts of
the JAX docstrings (pair and octuple stacking) are XLA lowering choices:
one flat ``torch.gather`` a tap gives the same values.
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
        raise ValueError("paeth_flip_rotate requires square images; "
                         "fused_flip_rotate warps any frame")
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


def _reflect_index(i: torch.Tensor, n: int) -> torch.Tensor:
    """Edge-inclusive reflection (cv2 BORDER_REFLECT, scipy 'reflect'):
    ... 2 1 0 | 0 1 2 ... n-1 | n-1 n-2 ...; period 2n."""
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * n
    j = torch.remainder(i, period)  # non-negative, as jnp.mod
    return torch.where(j >= n, period - 1 - j, j)


def _take(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor):
    """img (N, H, W)[n, yi, xi] for in-range (N, h, w) index tensors, by
    one flat gather a image."""
    n, h, w = img.shape
    lin = (yi * w + xi).reshape(n, -1)
    return torch.gather(img.reshape(n, -1), 1, lin).reshape(yi.shape)


def _source_coords(angle_deg: torch.Tensor, h: int, w: int):
    """PIL's inverse rotation map about the centre, per image: the float32
    source coordinates (xs, ys), each (N, H, W), of every output pixel
    centre, in the JAX package's order of operations."""
    theta = -angle_deg.to(torch.float32) * (math.pi / 180.0)
    c = torch.cos(theta)[:, None, None]
    s = torch.sin(theta)[:, None, None]
    cx, cy = w / 2.0, h / 2.0
    dev = theta.device
    yy = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5
    xx = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
    xs = c * (xx - cx) + s * (yy - cy) + cx
    ys = -s * (xx - cx) + c * (yy - cy) + cy
    return xs, ys


def _nearest_constant(img: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor):
    """Nearest sample at floor(xs), floor(ys), zero outside the frame."""
    h, w = img.shape[-2:]
    xi = torch.floor(xs).to(torch.int64)
    yi = torch.floor(ys).to(torch.int64)
    valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    out = _take(img, yi.clamp(0, h - 1), xi.clamp(0, w - 1))
    return torch.where(valid, out, torch.zeros((), dtype=img.dtype,
                                               device=img.device))


def _bilinear_constant(img: torch.Tensor, ys: torch.Tensor,
                       xs: torch.Tensor) -> torch.Tensor:
    """Bilinear sample at (ys, xs) (pixel-corner coordinates), zero fill."""
    h, w = img.shape[-2:]
    x0 = torch.floor(xs).to(torch.int64)
    y0 = torch.floor(ys).to(torch.int64)
    fx = xs - x0
    fy = ys - y0
    zero = torch.zeros((), dtype=img.dtype, device=img.device)

    def tap(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        return torch.where(valid, _take(img, yi.clamp(0, h - 1),
                                        xi.clamp(0, w - 1)), zero)

    top = tap(y0, x0) * (1 - fx) + tap(y0, x0 + 1) * fx
    bot = tap(y0 + 1, x0) * (1 - fx) + tap(y0 + 1, x0 + 1) * fx
    return top * (1 - fy) + bot * fy


def rotate(img: torch.Tensor, angle_deg: torch.Tensor, *,
           method: str = "nearest") -> torch.Tensor:
    """Rotate each (H, W) image of ``img`` (N, H, W) counter-clockwise by
    its ``angle_deg`` (N,), PIL conventions (centre (w/2, h/2), pixel
    centres at +0.5, nearest = floor of the source coordinate), zero fill
    outside; ``method="bilinear"`` samples with the same centre
    convention."""
    h, w = img.shape[-2:]
    xs, ys = _source_coords(angle_deg, h, w)
    if method == "nearest":
        return _nearest_constant(img, xs, ys)
    return _bilinear_constant(img, ys - 0.5, xs - 0.5)


def fused_flip_rotate(img: torch.Tensor, mask: torch.Tensor,
                      flip_h: torch.Tensor, flip_v: torch.Tensor,
                      angle_deg: torch.Tensor) -> tuple:
    """Flip(s) then PIL-convention nearest rotation as one warp, for any
    H x W: the flips mirror the source coordinate of the composed map
    (they come before the rotation in the chain), and image and mask take
    the same source pixel. Angle 0 without flips is the identity.

    img, mask: (N, H, W) float; flip_h, flip_v: (N,) bool; angle_deg: (N,)
    float. Returns the warped (img, mask)."""
    n, h, w = img.shape
    xs, ys = _source_coords(angle_deg, h, w)
    xs = torch.where(flip_h[:, None, None], w - xs, xs)
    ys = torch.where(flip_v[:, None, None], h - ys, ys)
    out = _nearest_constant(torch.stack([img, mask], 1).reshape(
        2 * n, h, w), xs.repeat_interleave(2, 0), ys.repeat_interleave(2, 0))
    out = out.reshape(n, 2, h, w)
    return out[:, 0], out[:, 1]


def _remap_cell(map_y: torch.Tensor, map_x: torch.Tensor, h: int, w: int):
    """The reflected bilinear taps and weights of cv2.remap: (ry0, ry1,
    rx0, rx1, fy, fx). Reflection may reverse a tap pair or fold it onto
    one row or column; indexing each tap by its own reflected index keeps
    both cases exact."""
    x0 = torch.floor(map_x).to(torch.int64)
    y0 = torch.floor(map_y).to(torch.int64)
    fx = map_x - x0
    fy = map_y - y0
    return (_reflect_index(y0, h), _reflect_index(y0 + 1, h),
            _reflect_index(x0, w), _reflect_index(x0 + 1, w), fy, fx)


def _remap_nearest(img, map_y, map_x):
    """cv2 nearest: floor(x + 0.5) (coordinates here are >= -H), reflected."""
    h, w = img.shape[-2:]
    xi = _reflect_index(torch.floor(map_x + 0.5).to(torch.int64), w)
    yi = _reflect_index(torch.floor(map_y + 0.5).to(torch.int64), h)
    return _take(img, yi, xi)


def _remap_linear(img, cell):
    ry0, ry1, rx0, rx1, fy, fx = cell
    t = _take(img, ry0, rx0) * (1 - fx) + _take(img, ry0, rx1) * fx
    b = _take(img, ry1, rx0) * (1 - fx) + _take(img, ry1, rx1) * fx
    return t * (1 - fy) + b * fy


def remap(img: torch.Tensor, map_y: torch.Tensor, map_x: torch.Tensor, *,
          method: str = "linear") -> torch.Tensor:
    """cv2.remap of each image of ``img`` (N, H, W): out[n, y, x] =
    img[n, map_y[n, y, x], map_x[n, y, x]] with BORDER_REFLECT, bilinear
    (``"linear"``) or nearest sampling; maps (N, H, W) float32 absolute
    source coordinates."""
    h, w = img.shape[-2:]
    if method == "nearest":
        return _remap_nearest(img, map_y, map_x)
    return _remap_linear(img, _remap_cell(map_y, map_x, h, w))


def remap_pair(img: torch.Tensor, mask: torch.Tensor, map_y: torch.Tensor,
               map_x: torch.Tensor) -> tuple:
    """cv2.remap of a pair through one map, the elastic branch's warp: the
    image bilinear and the mask nearest (whose tap is always a corner of
    the image's reflected cell)."""
    h, w = img.shape[-2:]
    return (_remap_linear(img, _remap_cell(map_y, map_x, h, w)),
            _remap_nearest(mask, map_y, map_x))


def gaussian_kernel_17(sigma: torch.Tensor) -> torch.Tensor:
    """Normalised 17-tap Gaussians, (N, 17) for per-image ``sigma`` (N,):
    cv2.getGaussianKernel's formula at ksize 17."""
    i = torch.arange(17, dtype=torch.float32, device=sigma.device) - 8.0
    s = sigma.to(torch.float32)[:, None]
    k = torch.exp(-(i * i) / (2.0 * s * s))
    return k / k.sum(1, keepdim=True)


def _taps_17(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """x (N, R, C + 16), k (N, 17) -> (N, R, C): the 17-tap correlation
    along the last axis as 17 fused multiply-adds (float32 on every
    device: a cuDNN convolution would run in TF32 where it is allowed)."""
    c = x.shape[-1] - 16
    out = x[..., :c] * k[:, 0, None, None]
    for t in range(1, 17):
        out = torch.addcmul(out, x[..., t:t + c], k[:, t, None, None])
    return out


def gaussian_blur_17(img: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Separable 17 x 17 Gaussian blur of each image of ``img`` (N, H, W)
    with its own ``sigma`` (N,) and mirror padding (BORDER_REFLECT_101),
    as cv2.GaussianBlur's defaults: rows, then columns."""
    k = gaussian_kernel_17(sigma)
    x = _taps_17(F.pad(img, (8, 8), mode="reflect"), k)
    x = F.pad(x, (0, 0, 8, 8), mode="reflect")
    return _taps_17(x.transpose(1, 2), k).transpose(1, 2)


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
