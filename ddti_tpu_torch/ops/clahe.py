"""CLAHE (contrast-limited adaptive histogram equalisation), ported from
``ddti_tpu/ops/clahe.py``: cv2.createCLAHE(clipLimit, tileGridSize).apply
on uint8 frames, batched over N.

1. a 256-bin histogram of every tile (integer counts);
2. cv2's integer clip and redistribution: the excess shared evenly, then
   its residual one count a bin at bins 0, step, 2 step, ... (step = 256
   // residual) for the first ``residual`` of them;
3. LUT = round(cdf * 255 / tile area) per tile, in float32;
4. each pixel's value through the four surrounding tiles' LUTs, blended
   bilinearly between tile centres (clamped at the border tiles).

The counts are integers, so the histograms, clips and cdfs are exact on
any device; the LUTs and the blend are float32 operations in cv2's order,
so the uint8 result is cv2's bit for bit. Where a tile side is a power of
two (the training frames: 256 and 512 px on a 4 x 4 grid) the JAX
package's blend weights are the same floats and so is its result; at
other sides its weights (the even sides' (y + th / 2) mod th / th, XLA's
fused forms of the odd sides') can differ from cv2's by an ulp, and a
pixel at a rounding tie by one gray level. H and W must be multiples of
the grid, as JAX asserts.
"""

from __future__ import annotations

import numpy as np
import torch

HIST_SIZE = 256
_INV_255 = float(np.float32(1.0) / np.float32(255.0))


def _tile_luts(img: torch.Tensor, clip_limit: float, gy: int, gx: int):
    """(N, H, W) uint8 -> (N, gy, gx, 256) float32 LUTs."""
    n, h, w = img.shape
    th, tw = h // gy, w // gx
    area = th * tw
    limit = max(int(clip_limit * area / HIST_SIZE), 1)
    tiles = (img.reshape(n, gy, th, gx, tw).permute(0, 1, 3, 2, 4)
             .reshape(n * gy * gx, area).to(torch.int64))
    hist = torch.zeros(n * gy * gx, HIST_SIZE, dtype=torch.int64,
                       device=img.device)
    hist.scatter_add_(1, tiles, torch.ones_like(tiles))
    excess = (hist - limit).clamp(min=0).sum(1, keepdim=True)
    batch = excess // HIST_SIZE
    residual = excess - batch * HIST_SIZE
    clipped = hist.clamp(max=limit) + batch
    step = (HIST_SIZE // residual.clamp(min=1)).clamp(min=1)
    idx = torch.arange(HIST_SIZE, device=img.device)[None, :]
    clipped = clipped + ((idx % step == 0) & (idx // step < residual))
    cdf = clipped.cumsum(1).to(torch.float32)
    scale = float(np.float32(HIST_SIZE - 1) / np.float32(area))
    luts = torch.clamp(torch.round(cdf * scale), 0, 255)
    return luts.reshape(n, gy, gx, HIST_SIZE)


def _axis_taps(size: int, tile: int, grid: int, device):
    """Per row (or column): the two tiles blended and the second's weight,
    cv2's ``f = x * inv_tw - 0.5`` with its float32 reciprocal."""
    inv = float(np.float32(1.0) / np.float32(tile))
    f = torch.arange(size, dtype=torch.float32, device=device) * inv - 0.5
    t0f = torch.floor(f)
    t0 = t0f.to(torch.int64)
    return t0.clamp(0, grid - 1), (t0 + 1).clamp(0, grid - 1), f - t0f


def clahe_u8(img: torch.Tensor, clip_limit: float = 2.0,
             grid: tuple = (4, 4)) -> torch.Tensor:
    """CLAHE of each (H, W) uint8 image of ``img`` (N, H, W); uint8 out."""
    n, h, w = img.shape
    gy, gx = grid
    if (h // gy) * gy != h or (w // gx) * gx != w:
        raise ValueError("image must tile evenly")
    luts = _tile_luts(img, clip_limit, gy, gx).reshape(-1)
    y0, y1, fy = _axis_taps(h, h // gy, gy, img.device)
    x0, x1, fx = _axis_taps(w, w // gx, gx, img.device)
    fy, fx = fy[:, None], fx[None, :]
    v = img.to(torch.int64)
    base = torch.arange(n, device=img.device)[:, None, None] * gy

    def lut(ty, tx):
        i = (((base + ty[:, None]) * gx + tx[None, :]) * HIST_SIZE) + v
        return luts[i.reshape(-1)].reshape(n, h, w)

    top = lut(y0, x0) * (1 - fx) + lut(y0, x1) * fx
    bot = lut(y1, x0) * (1 - fx) + lut(y1, x1) * fx
    out = top * (1 - fy) + bot * fy
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def clahe_float(img: torch.Tensor, clip_limit: float = 2.0,
                grid: tuple = (4, 4)) -> torch.Tensor:
    """CLAHE of float [0, 1] images (N, H, W) through uint8, as the
    reference always applies it. Back to float as XLA lowers the JAX
    package's ``/ 255.0``: a product with float32(1 / 255)."""
    u8 = torch.clamp(torch.round(img * 255.0), 0, 255).to(torch.uint8)
    return clahe_u8(u8, clip_limit, grid).to(torch.float32) * _INV_255
