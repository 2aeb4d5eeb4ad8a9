"""The port's host chain (ddti_tpu_torch/data/host_transforms.py) against the
JAX package's, bit for bit, on the CPU.

Both sides draw their probabilities and scalars from a ``random.Random`` of
the same seed. JAX draws the elastic and speckle fields from the global
``np.random`` (seeded with ``np.random.seed(s)``), the port from an explicit
``np.random.RandomState(s)``: the same Mersenne Twister stream.
"""

import itertools
import random

import numpy as np
import pytest
from PIL import Image

from ddti_tpu.data import host_transforms as J
from ddti_tpu_torch.data import host_transforms as T


def _pair(seed, w=40, h=36):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w), dtype=np.uint8)
    yy, xx = np.mgrid[0:h, 0:w]
    mask = (((yy - h / 2) ** 2 + (xx - w / 2) ** 2) < (h / 4) ** 2)
    return (Image.fromarray(img, "L"),
            Image.fromarray((mask * 255).astype(np.uint8), "L"))


def _run(fn_j, fn_t, seed, *args, np_fields=False, **kw):
    """(JAX result, port result) from one seed."""
    img, mask = _pair(seed)
    np.random.seed(seed)
    j = fn_j(img, mask, random.Random(seed), *args, **kw)
    extra = (np.random.RandomState(seed),) if np_fields else ()
    t = fn_t(img, mask, random.Random(seed), *extra, *args, **kw)
    return j, t


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("name, kw, fields", [
    ("elastic_deform", dict(p=1.0), True),
    ("speckle_noise", dict(p=1.0), True),
    ("tgc_augment", dict(p=1.0), False),
    ("clahe", dict(p=1.0), False),
    ("adjust_brightness", dict(p=1.0), False),
    ("flip", dict(p=0.5), False),
    ("rotate", dict(p=1.0), False),
    ("random_crop", dict(p=1.0, crop_w=24, crop_h=20), False),
    ("elastic_deform", {}, True),   # the default probabilities
    ("speckle_noise", {}, True),
])
def test_each_transform_bit_equal_to_jax(name, kw, fields, seed):
    j, t = _run(getattr(J, name), getattr(T, name), seed, np_fields=fields,
                **kw)
    _equal(j, t)


def test_resize_and_to_arrays_bit_equal_to_jax():
    img, mask = _pair(7, 53, 29)
    _equal(J.resize(img, mask, (24, 32)), T.resize(img, mask, (24, 32)))
    a, b = J.to_arrays(img, mask), T.to_arrays(img, mask)
    _equal(a, b)
    assert b[0].dtype == np.float32 and b[0].shape == (29, 53, 1)


@pytest.mark.parametrize("flags", list(itertools.product((False, True),
                                                         repeat=4)),
                         ids=lambda f: "".join("estc"[i] if on else "-"
                                               for i, on in enumerate(f)))
def test_train_chain_bit_equal_to_jax_on_every_flag_combination(flags):
    """Sixteen (elastic, speckle, tgc, clahe) settings, five images each
    from one stream of draws, as the host iterator feeds the chain."""
    jc = J.build_train_chain(*flags, out_size=(24, 24))
    tc = T.build_train_chain(*flags, out_size=(24, 24))
    seed = sum(f << i for i, f in enumerate(flags))
    np.random.seed(seed)
    jr, tr = random.Random(seed), random.Random(seed)
    nprng = np.random.RandomState(seed)
    for k in range(5):
        img, mask = _pair(100 + k)
        j = jc(img, mask, jr)
        t = tc(img, mask, tr, nprng)
        _equal(j, t)
        assert t[0].shape == (24, 24, 1) and t[0].dtype == np.float32


def test_eval_chain_bit_equal_to_jax():
    img, mask = _pair(3)
    _equal(J.build_eval_chain((32, 16))(img, mask),
           T.build_eval_chain((32, 16))(img, mask))
