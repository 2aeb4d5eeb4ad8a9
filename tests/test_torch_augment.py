"""The port's augmentation, warps, resize and LR schedule
(ddti_tpu_torch/{data/augment,ops/resample,train/schedule}.py) against the
JAX package's, on the CPU.

The JAX package draws with threefry keys; the port takes its draws as
tensors. So the draws here are derived from JAX's own key layout
(``augment_batch`` splits one key per image, ``_augment_one`` eight per
image: flips and angle from keys 1-2 via ``_draw_warp``, brightness from
key 3 via ``_brightness_one``) and fed to the port.

The Paeth warp is pure data movement once its integer shifts are known,
and the shifts come from float32 tan/sin; both packages compute them in
float32, so the warped frames must be bit-equal except where a one-ulp
difference of tan/sin moves a ``floor(... + 0.5)`` across an integer. Such
a flip displaces whole rows or columns of one image by one pixel, so the
test allows it in at most one image of the batch, and counts it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.data import augment as ja
from ddti_tpu.ops import resample as jr
from ddti_tpu.train.schedule import cosine_warm_restarts as jsched
from ddti_tpu_torch.data import augment as ta
from ddti_tpu_torch.ops import resample as tr
from ddti_tpu_torch.train.schedule import cosine_warm_restarts as tsched


def jax_draws(key, n: int, cfg=ja.AugmentConfig()) -> ta.AugmentDraws:
    """The draws ``ddti_tpu.data.augment.augment_batch(key, ...)`` makes
    for ``n`` images, as the port's ``AugmentDraws``."""
    fh, fv, ang, on, f = [], [], [], [], []
    for k in jax.random.split(key, n):
        keys = jax.random.split(k, 8)
        a, b, c = ja._draw_warp(keys[1], keys[2], cfg)
        k_gate, k_f = jax.random.split(keys[3])
        fh.append(bool(a))
        fv.append(bool(b))
        ang.append(float(c))
        f.append(float(ja._u(k_f, *cfg.brightness)))
        on.append(bool(ja._gate(k_gate, cfg.p_brightness)))
    return ta.AugmentDraws(torch.tensor(fh), torch.tensor(fv),
                           torch.tensor(ang, dtype=torch.float32),
                           torch.tensor(on),
                           torch.tensor(f, dtype=torch.float32))


def _frames(n, size, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((n, size, size)).astype(np.float32)
    mask = (rng.random((n, size, size)) < 0.4).astype(np.float32)
    return img, mask


def _images_off_by_a_shift(a, b):
    return int(sum(not np.array_equal(x, y) for x, y in zip(a, b)))


def test_paeth_flip_rotate_matches_jax():
    n, size = 24, 64
    img, mask = _frames(n, size)
    rng = np.random.default_rng(1)
    fh = rng.random(n) < 0.5
    fv = rng.random(n) < 0.5
    ang = rng.uniform(-180, 180, n).astype(np.float32)
    ang[:6] = [0.0, 90.0, -90.0, 180.0, 45.0, -135.0]  # exact turns, ties
    ti, tm = tr.paeth_flip_rotate(torch.from_numpy(img),
                                  torch.from_numpy(mask),
                                  torch.from_numpy(fh), torch.from_numpy(fv),
                                  torch.from_numpy(ang))
    ji, jm = jax.vmap(jr.paeth_flip_rotate)(jnp.asarray(img),
                                            jnp.asarray(mask),
                                            jnp.asarray(fh), jnp.asarray(fv),
                                            jnp.asarray(ang))
    off = _images_off_by_a_shift(ti.numpy(), np.asarray(ji))
    assert off <= 1, f"{off} of {n} images differ"
    np.testing.assert_array_equal(ti.numpy()[:4], np.asarray(ji)[:4])
    assert _images_off_by_a_shift(tm.numpy(), np.asarray(jm)) <= 1


def test_paeth_shifts_match_jax():
    """The integer shear shifts themselves, over 4000 angles."""
    ang = np.random.default_rng(2).uniform(-180, 180, 4000).astype(
        np.float32)
    k4, s_x, s_y = tr.paeth_shifts(torch.from_numpy(ang), 64)
    theta = -jnp.asarray(ang) * (jnp.pi / 180.0)
    k = jnp.round(theta / (jnp.pi / 2)).astype(jnp.int32)
    resid = theta - k.astype(jnp.float32) * (jnp.pi / 2)
    centered = jnp.arange(64, dtype=jnp.float32) + 0.5 - 32.0
    jx = jnp.floor(jnp.tan(resid / 2.0)[:, None] * centered + 0.5)
    jy = jnp.floor(-jnp.sin(resid)[:, None] * centered + 0.5)
    np.testing.assert_array_equal(k4.numpy(), np.asarray(jnp.mod(k, 4)))
    rows_x = (s_x.numpy() != np.asarray(jx)).any(1).mean()
    rows_y = (s_y.numpy() != np.asarray(jy)).any(1).mean()
    # a one-ulp tan/sin difference at a rounding tie: rare, never more
    # than this share of angles
    assert rows_x <= 2e-3 and rows_y <= 2e-3, (rows_x, rows_y)


def test_paeth_rejects_non_square():
    with pytest.raises(ValueError, match="square"):
        tr.paeth_flip_rotate(torch.zeros(1, 4, 6), torch.zeros(1, 4, 6),
                             torch.zeros(1, dtype=torch.bool),
                             torch.zeros(1, dtype=torch.bool),
                             torch.zeros(1))


@pytest.mark.parametrize("src,dst", [(64, 32), (48, 64), (64, 40)])
@pytest.mark.parametrize("antialias", [True, False])
def test_resize_bilinear_matches_jax(src, dst, antialias):
    img, _ = _frames(3, src, seed=src)
    got = tr.resize_bilinear_hw(torch.from_numpy(img), dst, dst,
                                antialias=antialias)
    want = jr.resize_bilinear_hw(jnp.asarray(img), dst, dst,
                                 antialias=antialias)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("out", [64, 32])
def test_augment_batch_matches_jax_with_its_draws(out):
    n = 16
    img, mask = _frames(n, 64, seed=3)
    key = jax.random.PRNGKey(7)
    cfg = ja.AugmentConfig(fast_warp=True, out_size=(out, out))
    ji, jm = ja.augment_batch(key, jnp.asarray(img)[..., None],
                              jnp.asarray(mask)[..., None], cfg)
    draws = jax_draws(key, n, cfg)
    assert draws.flip_h.any() and draws.bright_on.any()
    ti, tm = ta.augment_batch(torch.from_numpy(img)[..., None],
                              torch.from_numpy(mask)[..., None], draws,
                              ta.AugmentConfig(out_size=(out, out)))
    assert ti.shape == (n, out, out, 1) and tm.shape == ti.shape
    same = [np.allclose(a, b, atol=1e-5) for a, b in
            zip(ti.numpy(), np.asarray(ji))]
    assert sum(not s for s in same) <= 1, same
    same = [np.allclose(a, b, atol=1e-5) for a, b in
            zip(tm.numpy(), np.asarray(jm))]
    assert sum(not s for s in same) <= 1, same


def test_brightness_matches_jax():
    img, _ = _frames(8, 16, seed=4)
    key = jax.random.PRNGKey(3)
    cfg = ja.AugmentConfig()
    want = [np.asarray(ja._brightness_one(k, jnp.asarray(i), cfg))
            for k, i in zip(jax.random.split(key, 8), img)]
    on, f = [], []
    for k in jax.random.split(key, 8):
        kg, kf = jax.random.split(k)
        on.append(bool(ja._gate(kg, 0.5)))
        f.append(float(ja._u(kf, 0.5, 1.5)))
    ident = ta.AugmentDraws(torch.zeros(8, dtype=torch.bool),
                            torch.zeros(8, dtype=torch.bool), torch.zeros(8),
                            torch.tensor(on), torch.tensor(f))
    got, _ = ta.augment_batch(torch.from_numpy(img)[..., None],
                              torch.from_numpy(img)[..., None], ident,
                              ta.AugmentConfig(out_size=(16, 16)))
    np.testing.assert_array_equal(got[..., 0].numpy(), np.stack(want))


def test_mixup_matches_jax_with_fed_draws():
    img, mask = _frames(6, 8, seed=5)
    key = jax.random.PRNGKey(11)
    ji, jm = ja.mixup(key, jnp.asarray(img), jnp.asarray(mask), 0.2, 1.0)
    k_gate, k_lam, k_perm = jax.random.split(key, 3)
    lam = float(jax.random.beta(k_lam, 0.2, 0.2))
    perm = np.asarray(jax.random.permutation(k_perm, 6))
    draws = ta.MixupDraws(torch.tensor(lam, dtype=torch.float32),
                          torch.from_numpy(perm).long())
    ti, tm = ta.mixup(torch.from_numpy(img), torch.from_numpy(mask), draws)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), atol=1e-6)


def test_samplers_follow_their_probabilities():
    g = torch.Generator().manual_seed(0)
    d = ta.sample_draws(g, 4000, ta.AugmentConfig())
    for gate in (d.flip_h, d.flip_v, d.bright_on, d.angle != 0):
        assert abs(gate.float().mean().item() - 0.5) < 0.03
    assert d.angle.abs().max() <= 180 and d.bright.min() >= 0.5
    lams = [ta.sample_mixup(g, 4, 0.2, 0.3).lam.item() for _ in range(2000)]
    off = np.mean([x == 1.0 for x in lams])
    assert abs(off - 0.7) < 0.04
    mixed = np.array([x for x in lams if x != 1.0])
    # Beta(0.2, 0.2): mean 1/2, variance 1/(4 * 1.4)
    assert abs(mixed.mean() - 0.5) < 0.05
    assert abs(mixed.var() - 1 / 5.6) < 0.03


@pytest.mark.parametrize("steps_per_epoch", [1, 7])
def test_schedule_matches_jax_over_200_epochs(steps_per_epoch):
    j = jsched(1e-3, steps_per_epoch)
    t = tsched(1e-3)
    for e in range(201):
        a = float(j(e * steps_per_epoch + steps_per_epoch - 1))
        assert t(e) == pytest.approx(a, rel=1e-7), e
