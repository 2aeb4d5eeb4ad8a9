"""The port's EDT (ddti_tpu_torch/ops/edt.py) against the JAX package's and
scipy's, on the CPU, where the port runs its plain version.

Every value before the square root is an integer below 2^24, so all of
them must agree bit for bit: the port's plain version with the JAX Pallas
kernel in interpret mode, with JAX's plain path (ragged W), and with
scipy on frames that have a zero.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import ndimage

from ddti_tpu.ops import edt as jedt
from ddti_tpu_torch.ops import edt


def _masks(n, h, w, seed, p=0.15):
    """Blobby random masks: a few ellipses plus salt."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = rng.random((n, h, w)) < p * 0.1
    for i in range(n):
        for _ in range(3):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            ry = rng.uniform(1, max(2, h / 3))
            rx = rng.uniform(1, max(2, w / 3))
            out[i] |= ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
    return out.astype(np.uint8)


def _port(masks):
    return edt.edt_batch(torch.from_numpy(masks)).numpy()


@pytest.mark.parametrize("h,w", [(16, 128), (24, 256)])
def test_plain_matches_pallas_kernel_in_interpret_mode(h, w):
    m = _masks(2, h, w, seed=h)
    for img in m:
        g = jedt._column_pass(jnp.asarray(img) == 0)
        d2 = jedt._minplus_pallas(g * g, interpret=True)
        want = np.asarray(jnp.sqrt(jnp.minimum(d2, float((h + w) ** 2))))
        got = _port(img[None])[0]
        np.testing.assert_array_equal(got, want)
    # and the row pass alone, on the same squared column distances
    g = jedt._column_pass(jnp.asarray(m[0]) == 0)
    want = np.asarray(jedt._minplus_pallas(g * g, interpret=True))
    tg = edt._column_pass(torch.from_numpy(m[:1]) == 0)[0]
    np.testing.assert_array_equal(np.asarray(g), tg.numpy())
    np.testing.assert_array_equal(
        edt._minplus_reference(tg * tg).numpy(), want)


@pytest.mark.parametrize("h,w", [(33, 100), (17, 333), (1, 7), (9, 1)])
def test_plain_matches_jax_plain_path_on_ragged_shapes(h, w):
    m = _masks(3, h, w, seed=w)
    want = np.stack([np.asarray(jedt.distance_transform_edt(
        jnp.asarray(img), use_pallas=False)) for img in m])
    np.testing.assert_array_equal(_port(m), want)


@pytest.mark.parametrize("dtype", [np.uint8, np.bool_, np.float32])
def test_plain_matches_scipy(dtype):
    m = _masks(4, 40, 52, seed=7)
    m[1] = 1
    m[1, 20, 30] = 0  # a single zero
    got = _port(m.astype(dtype))
    for i in range(len(m)):
        want = ndimage.distance_transform_edt(m[i]).astype(np.float32)
        np.testing.assert_array_equal(got[i], want)


def test_plain_square_root_is_correctly_rounded():
    """A single zero in a corner of a 512^2 frame: every sum of two squares
    below 2 * 511^2 appears as a squared distance, and the float32 root of
    each must be the correctly rounded one (scipy's, JAX's, the kernel's)."""
    m = np.ones((1, 512, 512), np.uint8)
    m[0, 0, 0] = 0
    want = ndimage.distance_transform_edt(m[0]).astype(np.float32)
    np.testing.assert_array_equal(_port(m)[0], want)


def test_all_foreground_caps_at_h_plus_w():
    m = np.ones((2, 12, 20), np.uint8)
    m[1, 3, 4] = 0
    got = _port(m)
    assert (got[0] == 32.0).all()
    want = ndimage.distance_transform_edt(m[1]).astype(np.float32)
    np.testing.assert_array_equal(got[1], want)
    # JAX caps the same way
    np.testing.assert_array_equal(
        got[0], np.asarray(jedt.distance_transform_edt(
            jnp.asarray(m[0]), use_pallas=False)))


def test_edt_batch_layouts():
    m = _masks(3, 20, 24, seed=3)
    flat = _port(m)
    four = edt.edt_batch(torch.from_numpy(m)[..., None])
    assert four.shape == (3, 20, 24, 1) and four.dtype == torch.float32
    np.testing.assert_array_equal(four[..., 0].numpy(), flat)
    want = np.asarray(jedt.edt_batch(jnp.asarray(m)[..., None]))
    np.testing.assert_array_equal(four.numpy(), want)
    one = edt.distance_transform_edt(torch.from_numpy(m[1]))
    np.testing.assert_array_equal(one.numpy(), flat[1])


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        edt.edt_cuda(torch.zeros(1, 4, 4, dtype=torch.uint8))
