"""Sliding-window inference (ddti_tpu_torch/eval/sliding_window.py) against
the JAX package's ``eval/sliding_window.py``, on the CPU in float32: the
tile walk, the iterative reflect pad (pads beyond dim - 1 included), the
Hann importance map, and the blended logits of one UNet (base filters 8,
depth 3, a 32² window) on frames smaller than, equal to and larger than
the window, non-square ones among them, with tile counts that are not a
multiple of ``tile_batch``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.eval import sliding_window as jsw
from ddti_tpu_torch.eval import sliding_window as sw

from test_torch_zoo import jax_model, port_model

# blended float32 logits, max |port - JAX| / max |JAX|: measured 2.3e-7 -
# 2.9e-7
LOGIT_RTOL = 1e-4
WINDOW, STRIDE = 32, 16


@pytest.mark.parametrize("size, window, stride", [
    (10, 32, 16), (32, 32, 16), (33, 32, 16), (64, 32, 16), (70, 32, 16),
    (100, 32, 24), (512, 512, 256), (768, 512, 256), (1024, 512, 256),
    (600, 512, 256), (97, 40, 40), (41, 40, 7)])
def test_tile_positions_equal_jax(size, window, stride):
    np.testing.assert_array_equal(sw._tile_positions(size, window, stride),
                                  jsw._tile_positions(size, window, stride))


@pytest.mark.parametrize("shape, pad_h, pad_w", [
    ((20, 28), 12, 4), ((5, 7), 20, 30), ((2, 3), 9, 0), ((1, 6), 0, 11),
    ((6, 4, 3), 17, 2), ((33, 47, 1), 31, 17)])
def test_reflect_pad_equals_jax(shape, pad_h, pad_w):
    """(H, W[, C]) tensors, including pads larger than dim - 1 (several
    passes), against JAX's numpy path."""
    frame = np.random.default_rng(0).random(shape).astype(np.float32)
    want = jsw.reflect_pad_2d(frame, pad_h, pad_w)
    assert want.shape[:2] == (shape[0] + pad_h, shape[1] + pad_w)
    got = sw.reflect_pad_2d(torch.from_numpy(frame), pad_h, pad_w)
    np.testing.assert_array_equal(got.numpy(), want)


def test_reflect_pad_of_one_pixel_raises():
    with pytest.raises(ValueError, match="cannot reflect-pad"):
        sw.reflect_pad_2d(torch.zeros(1, 1), 3, 3)


@pytest.mark.parametrize("window", [1, 7, 32, 512])
def test_importance_equals_jax(window):
    np.testing.assert_array_equal(sw._importance(window),
                                  jsw._importance(window))


_JAX_MODEL = jax_model("UNet")


def _jax_apply(variables, x):  # a static argument of JAX's jitted blend
    return _JAX_MODEL[0].apply(variables, x, train=False)


@pytest.mark.parametrize("h, w, tile_batch", [
    (20, 28, 8),   # smaller than the window: reflect-padded up to it
    (32, 32, 8),   # one tile
    (50, 70, 5),   # 3 x 4 = 12 tiles in chunks of 5
    (45, 33, 4),   # 2 x 2 = 4 tiles, non-square
    (96, 40, 7),   # 5 x 2 = 10 tiles
])
def test_sliding_window_logits_match_jax(h, w, tile_batch):
    _, params, stats = _JAX_MODEL
    frame = np.random.default_rng(h * w).random((h, w, 1), dtype=np.float32)
    want = np.asarray(jsw.sliding_window_logits(
        _jax_apply, {"params": params, "batch_stats": stats},
        jnp.asarray(frame), window=WINDOW, stride=STRIDE,
        tile_batch=tile_batch))
    m = port_model("UNet").eval()
    calls = []

    def apply_fn(x):
        calls.append(x.shape[0])
        return m(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    got = sw.sliding_window_logits(apply_fn, torch.from_numpy(frame),
                                   window=WINDOW, stride=STRIDE,
                                   tile_batch=tile_batch)
    assert got.dtype == torch.float32 and got.shape == (h, w, 1)
    assert float(np.abs(got.numpy() - want).max()
                 / np.abs(want).max()) <= LOGIT_RTOL
    _, _, coords = sw.tile_coords(h, w, WINDOW, STRIDE)
    # the last chunk runs short, as it is
    assert sum(calls) == len(coords) and max(calls) <= tile_batch
    assert len(calls) == -(-len(coords) // tile_batch)
    mask = sw.sliding_window_predict(apply_fn, torch.from_numpy(frame),
                                     window=WINDOW, stride=STRIDE,
                                     tile_batch=tile_batch)
    assert mask.dtype == torch.uint8
    assert torch.equal(mask, (torch.sigmoid(got) > 0.5).to(torch.uint8))


def test_tile_coords_count_the_slice_frames():
    """A 1024 x 768 frame at window 512, stride 256 is 3 x 2 = 6 tiles; a
    600 x 480 frame (wider than the window, shorter than it) is 2 x 1."""
    assert len(sw.tile_coords(768, 1024, 512, 256)[2]) == 6
    ph, pw, coords = sw.tile_coords(480, 600, 512, 256)
    assert (ph, pw, len(coords)) == (512, 768, 2)
