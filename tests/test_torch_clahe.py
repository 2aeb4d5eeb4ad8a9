"""The port's CLAHE (ddti_tpu_torch/ops/clahe.py) against the JAX
package's ``clahe_u8`` / ``clahe_float`` and against OpenCV's
``cv2.createCLAHE(2.0, (4, 4)).apply``, on the CPU.

Histograms, clips, residual walks and cdfs are integers; the LUTs and the
bilinear blend are float32 in cv2's order. At tile sides that are powers
of two (64² and 128² frames on a 4 x 4 grid, as 256² and 512² training
frames are) all three agree bit for bit. At other sides the JAX package's
blend weights are other floats than cv2's (its even-tile formula and
XLA's fused reciprocals), so there the port is held to cv2 alone.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.ops import clahe as jc
from ddti_tpu_torch.ops import clahe as tc

cv2 = pytest.importorskip("cv2")


def _frames(kind, n, h, w, seed):
    """Uniform noise; a narrow histogram (deep clipping and a long
    residual walk); flat blocks (whole tiles of one value)."""
    rng = np.random.default_rng(seed)
    if kind == "noise":
        return rng.integers(0, 256, (n, h, w), dtype=np.uint8)
    if kind == "narrow":
        return rng.normal(100, 6, (n, h, w)).clip(0, 255).astype(np.uint8)
    img = np.zeros((n, h, w), np.uint8)
    img[:, h // 3:, : w // 2] = 200
    img[:, : h // 5, w // 2:] = rng.integers(0, 256, (n, 1, 1))
    return img


def _cv2(img):
    return np.stack([cv2.createCLAHE(2.0, (4, 4)).apply(x) for x in img])


@pytest.mark.parametrize("size", [64, 128])
@pytest.mark.parametrize("kind", ["noise", "narrow", "blocks"])
def test_clahe_u8_bit_equal_to_jax_and_cv2(size, kind):
    img = _frames(kind, 3, size, size, seed=size)
    got = tc.clahe_u8(torch.from_numpy(img)).numpy()
    jax_out = np.stack([np.asarray(jc.clahe_u8(jnp.asarray(x)))
                        for x in img])
    np.testing.assert_array_equal(got, jax_out)
    np.testing.assert_array_equal(got, _cv2(img))


@pytest.mark.parametrize("h, w", [(60, 84), (36, 36), (96, 64), (64, 32)])
def test_clahe_u8_bit_equal_to_cv2_at_other_tiles(h, w):
    img = np.concatenate([_frames(k, 2, h, w, seed=h + w)
                          for k in ("noise", "narrow", "blocks")])
    np.testing.assert_array_equal(tc.clahe_u8(torch.from_numpy(img)).numpy(),
                                  _cv2(img))


@pytest.mark.parametrize("clip, grid", [(1.0, (4, 4)), (4.0, (2, 8)),
                                        (40.0, (8, 8))])
def test_clahe_u8_other_clip_limits_and_grids(clip, grid):
    img = _frames("narrow", 2, 64, 64, seed=3)
    got = tc.clahe_u8(torch.from_numpy(img), clip, grid).numpy()
    want = np.stack([cv2.createCLAHE(clip, grid[::-1]).apply(x)
                     for x in img])
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, np.stack([np.asarray(
        jc.clahe_u8(jnp.asarray(x), clip, grid)) for x in img]))


def test_clahe_float_bit_equal_to_jax():
    """Under jit, as the JAX package's augmentation runs it: XLA lowers its
    ``/ 255.0`` to a product with float32(1 / 255), as the port does."""
    img = np.random.default_rng(4).random((3, 64, 64)).astype(np.float32)
    got = tc.clahe_float(torch.from_numpy(img)).numpy()
    want = np.stack([np.asarray(jax.jit(jc.clahe_float)(jnp.asarray(x)))
                     for x in img])
    np.testing.assert_array_equal(got, want)


def test_clahe_rejects_frames_the_grid_does_not_tile():
    with pytest.raises(ValueError, match="tile evenly"):
        tc.clahe_u8(torch.zeros(1, 30, 32, dtype=torch.uint8))
