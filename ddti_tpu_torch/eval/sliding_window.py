"""Tiled (sliding-window) inference over full-resolution frames, ported from
``ddti_tpu/eval/sliding_window.py``.

The model runs over overlapping tiles at the frame's native resolution
and the tile logits are blended with an importance map:

 1. reflect-pad the frame so an integer grid of (window, stride) tiles
    covers it, the last tile of each axis clamped flush to the edge;
 2. cut the tiles into one (T, window, window, C) batch;
 3. run the model on chunks of ``tile_batch`` tiles. JAX zero-pads the
    tile count to a multiple of ``tile_batch`` for its static shapes; here
    the last chunk runs as it is (eval BatchNorm is per sample, so padding
    would change nothing but the work);
 4. add logits x weight into a float32 canvas, divide by the summed
    weight, crop to (H, W).

The weight is a separable squared-sine (Hann) window floored at 1e-3, so
tile seams vanish and the corners keep a nonzero weight.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F


def _tile_positions(size: int, window: int, stride: int) -> np.ndarray:
    """Start offsets covering [0, size), the final tile clamped flush to
    the edge."""
    if size <= window:
        return np.array([0])
    starts = list(range(0, size - window + 1, stride))
    if starts[-1] != size - window:
        starts.append(size - window)
    return np.array(starts)


def _reflect_once(frame: torch.Tensor, pad_h: int, pad_w: int):
    # F.pad's reflect mode wants (C, H, W): move the channels first
    x = frame[None] if frame.dim() == 2 else frame.permute(2, 0, 1)
    x = F.pad(x, (0, pad_w, 0, pad_h), mode="reflect")
    return x[0] if frame.dim() == 2 else x.permute(1, 2, 0)


def reflect_pad_2d(frame: torch.Tensor, pad_h: int, pad_w: int):
    """Right/bottom reflect-pad of an (H, W[, C]) tensor that works for any
    pad: a reflect pad cannot exceed dim - 1, so a large pad (a frame
    smaller than about half the window) reflects in passes, each of at most
    the current size - 1."""
    while pad_h > 0 or pad_w > 0:
        h, w = frame.shape[0], frame.shape[1]
        step_h = min(pad_h, h - 1)
        step_w = min(pad_w, w - 1)
        if step_h == 0 and step_w == 0:
            raise ValueError(f"cannot reflect-pad a {tuple(frame.shape)} "
                             f"frame")
        frame = _reflect_once(frame, step_h, step_w)
        pad_h -= step_h
        pad_w -= step_w
    return frame


def _importance(window: int) -> np.ndarray:
    """Separable squared-sine (Hann) importance map, floored to keep the
    corners nonzero."""
    w1 = np.sin(np.pi * (np.arange(window) + 0.5) / window) ** 2
    w = np.outer(w1, w1)
    return np.maximum(w, 1e-3).astype(np.float32)


def tile_coords(h: int, w: int, window: int, stride: int):
    """(padded height, padded width, [(y, x), ...]) of the tile grid over an
    (h, w) frame."""
    ph = h + max(window - h, (-h) % stride if h > window else 0)
    pw = w + max(window - w, (-w) % stride if w > window else 0)
    return ph, pw, [(int(y), int(x))
                    for y in _tile_positions(ph, window, stride)
                    for x in _tile_positions(pw, window, stride)]


@torch.no_grad()
def sliding_window_logits(apply_fn: Callable[[torch.Tensor], torch.Tensor],
                          frame: torch.Tensor, *, window: int = 512,
                          stride: int = 256,
                          tile_batch: int = 8) -> torch.Tensor:
    """Full-resolution float32 logits (H, W, C_out) of one (H, W, C) frame.

    ``apply_fn`` maps (N, window, window, C) NHWC tiles to (N, window,
    window, C_out) logits (JAX's ``apply_fn(variables, images)`` with the
    weights closed over)."""
    h, w, _ = frame.shape
    ph, pw, coords = tile_coords(h, w, window, stride)
    padded = reflect_pad_2d(frame, ph - h, pw - w)
    tiles = torch.stack([padded[y:y + window, x:x + window]
                         for y, x in coords])
    logits = torch.cat([apply_fn(tiles[i:i + tile_batch])
                        for i in range(0, len(coords), tile_batch)])

    weight = torch.from_numpy(_importance(window)).to(frame.device)[..., None]
    acc = torch.zeros((ph, pw, logits.shape[-1]), dtype=torch.float32,
                      device=frame.device)
    norm = torch.zeros((ph, pw, 1), dtype=torch.float32, device=frame.device)
    for (y, x), lg in zip(coords, logits):
        acc[y:y + window, x:x + window] += lg.to(torch.float32) * weight
        norm[y:y + window, x:x + window] += weight
    return (acc / norm)[:h, :w]


def sliding_window_predict(apply_fn, frame, *, window=512, stride=256,
                           tile_batch=8, threshold=0.5) -> torch.Tensor:
    """uint8 {0, 1} mask (H, W, C_out) of one full-resolution frame."""
    logits = sliding_window_logits(apply_fn, frame, window=window,
                                   stride=stride, tile_batch=tile_batch)
    return (torch.sigmoid(logits) > threshold).to(torch.uint8)
