"""The port's augmentation branches (ddti_tpu_torch/{data/augment,
ops/resample}.py) against the JAX package's, on the CPU: crop, elastic
(remap, remap_pair, the 17-tap blur), the exact PIL-map warp on square and
non-square frames, speckle, TGC with its remainder strip, CLAHE, shared
geometry, and all of them chained.

The JAX package draws inside its functions from threefry keys; the port
takes its draws as tensors. The draws here are JAX's own, read from its
key layout (``_augment_one`` splits eight keys an image: elastic 0, flips
1, angle 2, brightness 3, speckle 4, TGC 5, CLAHE 6, crop 7) and fed to
the port.

Nearest sampling floors a float32 coordinate built from sin/cos (the exact
warp) or from a blurred field (elastic). XLA's and torch's sin, cos, exp
and sums can differ by an ulp, so a pixel whose coordinate lies within
~1e-5 of an integer may take the neighbouring source pixel. The tests
find those pixels from JAX's own coordinates: every pixel that differs
must lie within ``TIE`` of an integer, ties may be at most ``TIE_SHARE``
of the frame, and every other pixel agrees (masks bit for bit, images to
the stated tolerance).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.data import augment as ja
from ddti_tpu.ops import resample as jr
from ddti_tpu_torch.data import augment as ta
from ddti_tpu_torch.ops import resample as tr

TIE = 1e-4          # a tie: a floored coordinate this close to an integer
TIE_SHARE = 5e-4    # at most this share of a frame's pixels differ by ties
IMG_TOL = 1e-6      # a single resampling function's image values
CHAIN_TOL = 1e-5    # images after a chain of branches


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _frames(n, h, w, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.random((n, h, w)).astype(np.float32)
    yy, xx = np.mgrid[0:h, 0:w]
    mask = np.zeros((n, h, w), np.float32)
    for i in range(n):
        c = rng.uniform(0.3, 0.7, 2) * (h, w)
        mask[i] = ((yy - c[0]) ** 2 + (xx - c[1]) ** 2
                   < (rng.uniform(0.15, 0.3) * min(h, w)) ** 2)
    return img, mask


def _near_integer(v):
    v = np.asarray(v, np.float64)
    return np.abs(v - np.round(v)) < TIE


def _warp_ties(h, w, fh, fv, ang):
    """(N, H, W) bool: JAX's exact-warp source coordinate of the pixel is
    within TIE of an integer in x or y."""
    def coords(f1, f2, a):
        theta = -a * (jnp.pi / 180.0)
        c, s = jnp.cos(theta), jnp.sin(theta)
        yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0) + 0.5
        xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1) + 0.5
        xs = c * (xx - w / 2.0) + s * (yy - h / 2.0) + w / 2.0
        ys = -s * (xx - w / 2.0) + c * (yy - h / 2.0) + h / 2.0
        return jnp.where(f1, w - xs, xs), jnp.where(f2, h - ys, ys)

    xs, ys = jax.vmap(coords)(jnp.asarray(fh), jnp.asarray(fv),
                              jnp.asarray(ang, jnp.float32))
    return _near_integer(xs) | _near_integer(ys)


def _assert_ties_only(got, want, ties, tol, what):
    """Pixels off a tie agree to ``tol`` (0: bit for bit); those that differ
    lie on ties, at most TIE_SHARE of the frames."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got - want) > tol
    assert not (diff & ~ties).any(), (what, int((diff & ~ties).sum()))
    assert diff.sum() <= TIE_SHARE * diff.size, (what, int(diff.sum()))
    return int(diff.sum())


# ---------------------------------------------------------------- resample


def test_reflect_index_matches_jax():
    i = np.arange(-300, 300)
    for n in (1, 2, 7, 64):
        np.testing.assert_array_equal(
            tr._reflect_index(_t(i), n).numpy(),
            np.asarray(jr._reflect_index(jnp.asarray(i), n)))


def _maps(n, h, w, seed):
    """Source coordinates from -H to 2H (and -W to 2W), with planted exact
    integers and half-integers, where reflection folds and reverses taps."""
    rng = np.random.default_rng(seed)
    my = rng.uniform(-h, 2 * h, (n, h, w)).astype(np.float32)
    mx = rng.uniform(-w, 2 * w, (n, h, w)).astype(np.float32)
    my[:, 0, :8] = [-h, -1, -0.5, 0, h - 1, h - 0.5, h, 2 * h - 1]
    mx[:, 1, :8] = [-w, -1, -0.5, 0, w - 1, w - 0.5, w, 2 * w - 1]
    return my, mx


@pytest.mark.parametrize("h, w", [(32, 32), (40, 56), (33, 17)])
@pytest.mark.parametrize("method", ["linear", "nearest"])
def test_remap_matches_jax(h, w, method):
    img, _ = _frames(3, h, w, seed=h + w)
    my, mx = _maps(3, h, w, seed=h)
    got = tr.remap(_t(img), _t(my), _t(mx), method=method).numpy()
    want = jax.vmap(lambda a, b, c: jr.remap(a, b, c, method=method))(
        img, my, mx)
    np.testing.assert_allclose(got, np.asarray(want), atol=IMG_TOL, rtol=0)


@pytest.mark.parametrize("h, w", [(32, 32), (48, 40)])
def test_remap_pair_matches_jax(h, w):
    img, mask = _frames(4, h, w, seed=1)
    my, mx = _maps(4, h, w, seed=2)
    ti, tm = tr.remap_pair(_t(img), _t(mask), _t(my), _t(mx))
    ji, jm = jax.vmap(jr.remap_pair)(img, mask, my, mx)
    np.testing.assert_allclose(ti.numpy(), np.asarray(ji), atol=IMG_TOL,
                               rtol=0)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("h, w", [(32, 32), (24, 72)])
def test_gaussian_blur_17_matches_jax(h, w):
    img, _ = _frames(4, h, w, seed=3)
    field = img * 2 - 1
    sigma = np.array([6.0, 7.5, 9.25, 10.0], np.float32)
    np.testing.assert_allclose(
        tr.gaussian_kernel_17(_t(sigma)).numpy(),
        np.asarray(jax.vmap(jr.gaussian_kernel_17)(sigma)), atol=1e-7,
        rtol=0)
    got = tr.gaussian_blur_17(_t(field), _t(sigma)).numpy()
    want = jax.vmap(jr.gaussian_blur_17)(field, sigma)
    np.testing.assert_allclose(got, np.asarray(want), atol=IMG_TOL, rtol=0)


@pytest.mark.parametrize("method", ["nearest", "bilinear"])
@pytest.mark.parametrize("h, w", [(32, 32), (40, 56)])
def test_rotate_matches_jax(method, h, w):
    n = 12
    img, _ = _frames(n, h, w, seed=4)
    ang = np.random.default_rng(5).uniform(-180, 180, n).astype(np.float32)
    ang[:4] = [0.0, 90.0, -180.0, 45.0]
    got = tr.rotate(_t(img), _t(ang), method=method).numpy()
    want = np.asarray(jax.vmap(lambda a, b: jr.rotate(a, b, method=method))(
        img, ang))
    if method == "bilinear":
        np.testing.assert_allclose(got, want, atol=IMG_TOL, rtol=0)
    else:
        ties = _warp_ties(h, w, np.zeros(n, bool), np.zeros(n, bool), ang)
        _assert_ties_only(got, want, ties, 0.0, "rotate")


@pytest.mark.parametrize("h, w", [(64, 64), (40, 56), (96, 33)])
def test_fused_flip_rotate_matches_jax(h, w):
    n = 16
    img, mask = _frames(n, h, w, seed=6)
    rng = np.random.default_rng(7)
    fh, fv = rng.random(n) < 0.5, rng.random(n) < 0.5
    ang = rng.uniform(-180, 180, n).astype(np.float32)
    ang[:5] = [0.0, 90.0, -90.0, 180.0, -135.0]
    ti, tm = tr.fused_flip_rotate(_t(img), _t(mask), _t(fh), _t(fv), _t(ang))
    ji, jm = jax.vmap(jr.fused_flip_rotate)(img, mask, fh, fv, ang)
    ties = _warp_ties(h, w, fh, fv, ang)
    _assert_ties_only(ti.numpy(), ji, ties, 0.0, "image")
    _assert_ties_only(tm.numpy(), jm, ties, 0.0, "mask")
    # the identity and the flips alone are exact
    np.testing.assert_array_equal(ti.numpy()[0], np.asarray(ji)[0])


# ------------------------------------------------------- the chain's draws


def jax_chain_draws(key, n: int, h: int, w: int,
                    cfg: ja.AugmentConfig) -> ta.AugmentDraws:
    """Every draw ``ddti_tpu.data.augment.augment_batch(key, ...)`` makes
    for ``n`` (h, w) frames under ``cfg``, as the port's ``AugmentDraws``
    (fields for the gated images alone)."""
    d = {k: [] for k in ("fh", "fv", "ang", "b_on", "b", "c_on", "top",
                         "left", "e_on", "alpha", "sigma", "dx", "dy", "s_on",
                         "s_sig", "noise", "t_on", "gains", "cl_on")}
    shared = None
    if cfg.shared_geometry:
        kf1, kf2 = jax.random.split(jax.random.fold_in(key, 1))
        shared = ja._draw_warp(kf1, kf2, cfg)
    ch, cw = max(int(h * cfg.crop_frac), 1), max(int(w * cfg.crop_frac), 1)
    for k in jax.random.split(key, n):
        keys = jax.random.split(k, 8)
        fh, fv, ang = shared or ja._draw_warp(keys[1], keys[2], cfg)
        d["fh"].append(bool(fh))
        d["fv"].append(bool(fv))
        d["ang"].append(float(ang))
        kg, kf = jax.random.split(keys[3])
        d["b_on"].append(bool(ja._gate(kg, cfg.p_brightness)))
        d["b"].append(float(ja._u(kf, *cfg.brightness)))
        kg, kt, kl = jax.random.split(keys[7], 3)
        d["c_on"].append(bool(ja._gate(kg, cfg.p_crop)))
        d["top"].append(int(jax.random.randint(kt, (), 0, h - ch + 1)))
        d["left"].append(int(jax.random.randint(kl, (), 0, w - cw + 1)))
        kg, ka, ks, kdx, kdy = jax.random.split(keys[0], 5)
        d["e_on"].append(bool(ja._gate(kg, cfg.p_elastic)))
        d["alpha"].append(float(ja._u(ka, *cfg.elastic_alpha)))
        d["sigma"].append(float(ja._u(ks, *cfg.elastic_sigma)))
        d["dx"].append(np.asarray(ja._u(kdx, -1.0, 1.0, (h, w))))
        d["dy"].append(np.asarray(ja._u(kdy, -1.0, 1.0, (h, w))))
        kg, ks, kn = jax.random.split(keys[4], 3)
        d["s_on"].append(bool(ja._gate(kg, cfg.p_speckle)))
        d["s_sig"].append(float(ja._u(ks, *cfg.speckle_sigma)))
        d["noise"].append(np.asarray(jax.random.normal(kn, (h, w))))
        kg, kgn = jax.random.split(keys[5])
        d["t_on"].append(bool(ja._gate(kg, cfg.p_tgc)))
        d["gains"].append(np.asarray(ja._u(kgn, *cfg.tgc_gain,
                                           (cfg.tgc_bins,))))
        d["cl_on"].append(bool(ja._gate(keys[6], cfg.p_clahe)))

    def f32(v):
        return torch.tensor(np.asarray(v, np.float32))

    def gated(on, field):
        idx = ta.gate_index(torch.tensor(on))
        return idx, f32(np.stack(field))[idx]

    e_idx, dx = gated(d["e_on"], d["dx"])
    _, dy = gated(d["e_on"], d["dy"])
    s_idx, noise = gated(d["s_on"], d["noise"])
    return ta.AugmentDraws(
        torch.tensor(d["fh"]), torch.tensor(d["fv"]), f32(d["ang"]),
        torch.tensor(d["b_on"]), f32(d["b"]),
        crop_on=torch.tensor(d["c_on"]), crop_top=torch.tensor(d["top"]),
        crop_left=torch.tensor(d["left"]), elastic_idx=e_idx,
        elastic_alpha=f32(d["alpha"]), elastic_sigma=f32(d["sigma"]),
        elastic_dx=dx, elastic_dy=dy, speckle_idx=s_idx,
        speckle_sigma=f32(d["s_sig"]), speckle_noise=noise,
        tgc_on=torch.tensor(d["t_on"]), tgc_gains=f32(np.stack(d["gains"])),
        clahe_idx=ta.gate_index(torch.tensor(d["cl_on"])))


def _port_cfg(jcfg: ja.AugmentConfig) -> ta.AugmentConfig:
    return ta.AugmentConfig(**{f: getattr(jcfg, f) for f in (
        "use_elastic", "use_speckle", "use_tgc", "use_clahe", "p_crop",
        "crop_frac", "p_elastic", "p_flip", "p_rotate", "p_brightness",
        "p_speckle", "p_tgc", "p_clahe", "tgc_bins", "out_size",
        "shared_geometry", "fast_warp")})


def _run_both(jcfg, n, h, w, seed, key_seed):
    img, mask = _frames(n, h, w, seed=seed)
    key = jax.random.PRNGKey(key_seed)
    ji, jm = ja.augment_batch(key, jnp.asarray(img)[..., None],
                              jnp.asarray(mask)[..., None], jcfg)
    draws = jax_chain_draws(key, n, h, w, jcfg)
    ti, tm = ta.augment_batch(_t(img)[..., None], _t(mask)[..., None],
                              draws, _port_cfg(jcfg))
    return (ti[..., 0].numpy(), tm[..., 0].numpy(), np.asarray(ji)[..., 0],
            np.asarray(jm)[..., 0], draws, img, mask)


def _elastic_ties(img_shape, draws):
    """(N, H, W) bool: ties of the elastic branch's nearest mask sample,
    from JAX's own blur of the same fields."""
    n, h, w = img_shape
    ties = np.zeros(img_shape, bool)
    idx = draws.elastic_idx.numpy()
    for j, i in enumerate(idx):
        a = float(draws.elastic_alpha[i])
        s = jnp.float32(draws.elastic_sigma[i])
        dx = jr.gaussian_blur_17(jnp.asarray(draws.elastic_dx[j]), s) * a
        dy = jr.gaussian_blur_17(jnp.asarray(draws.elastic_dy[j]), s) * a
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        ties[i] = (_near_integer(np.asarray(yy + dy) + 0.5)
                   | _near_integer(np.asarray(xx + dx) + 0.5))
    return ties


def _cfg(**kw):
    """Every gate that a test does not switch off, off."""
    base = dict(p_flip=0.0, p_rotate=0.0, p_brightness=0.0, fast_warp=False)
    base.update(kw)
    h = base.pop("h", 64)
    return ja.AugmentConfig(out_size=(h, base.pop("w", h)), **base)


@pytest.mark.parametrize("h, w", [(64, 64), (48, 80)])
def test_crop_branch_matches_jax(h, w):
    cfg = _cfg(p_crop=0.6, h=h, w=w)
    ti, tm, ji, jm, d, *_ = _run_both(cfg, 8, h, w, 10, 1)
    assert d.crop_on.any() and not d.crop_on.all()
    np.testing.assert_allclose(ti, ji, atol=CHAIN_TOL, rtol=0)
    np.testing.assert_allclose(tm, jm, atol=CHAIN_TOL, rtol=0)


@pytest.mark.parametrize("h, w", [(64, 64), (48, 80)])
def test_elastic_branch_matches_jax(h, w):
    cfg = _cfg(use_elastic=True, p_elastic=0.6, h=h, w=w)
    ti, tm, ji, jm, d, *_ = _run_both(cfg, 8, h, w, 11, 2)
    assert 0 < len(d.elastic_idx) < 8
    assert tuple(d.elastic_dx.shape) == (len(d.elastic_idx), h, w)
    ties = _elastic_ties(ti.shape, d)
    _assert_ties_only(tm, jm, ties, 0.0, "elastic mask")
    np.testing.assert_allclose(ti, ji, atol=CHAIN_TOL, rtol=0)


@pytest.mark.parametrize("h, w", [(64, 64), (40, 72)])
def test_exact_warp_in_the_chain_matches_jax(h, w):
    """``fast_warp=False`` (``--aug_exact_warp``), and any non-square frame
    whatever ``fast_warp`` says, takes the exact PIL map."""
    cfg = _cfg(p_flip=0.5, p_rotate=0.9, fast_warp=h != w, h=h, w=w)
    ti, tm, ji, jm, d, *_ = _run_both(cfg, 12, h, w, 12, 3)
    ties = _warp_ties(h, w, d.flip_h.numpy(), d.flip_v.numpy(),
                      d.angle.numpy())
    _assert_ties_only(ti, ji, ties, 0.0, "image")
    _assert_ties_only(tm, jm, ties, 0.0, "mask")


def test_speckle_branch_matches_jax():
    cfg = _cfg(use_speckle=True, p_speckle=0.6, p_brightness=0.5)
    ti, tm, ji, jm, d, *_ = _run_both(cfg, 8, 64, 64, 13, 4)
    assert 0 < len(d.speckle_idx) < 8
    np.testing.assert_allclose(ti, ji, atol=CHAIN_TOL, rtol=0)
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("h", [64, 47])
def test_tgc_branch_matches_jax(h):
    """At H = 47 and 10 bands of 4 rows, rows 40-46 keep gain 1."""
    cfg = _cfg(use_tgc=True, p_tgc=0.7, h=h, w=64)
    ti, tm, ji, jm, d, img, _ = _run_both(cfg, 8, h, 64, 14, 5)
    assert d.tgc_on.any() and not d.tgc_on.all()
    np.testing.assert_allclose(ti, ji, atol=CHAIN_TOL, rtol=0)
    if h % cfg.tgc_bins:
        strip = (h // cfg.tgc_bins) * cfg.tgc_bins
        np.testing.assert_array_equal(ti[:, strip:], img[:, strip:])
        on = d.tgc_on.numpy()
        assert not np.array_equal(ti[on, :strip], img[on, :strip])


@pytest.mark.parametrize("h, w", [(64, 64), (64, 32)])
def test_clahe_branch_matches_jax(h, w):
    """Tiles of 16 x 16 and 16 x 8: powers of two, where JAX's blend
    weights are cv2's floats, so bit for bit."""
    cfg = _cfg(use_clahe=True, p_clahe=0.6, h=h, w=w)
    ti, tm, ji, jm, d, *_ = _run_both(cfg, 8, h, w, 15, 6)
    assert 0 < len(d.clahe_idx) < 8
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("fast_warp", [True, False])
def test_shared_geometry_matches_jax(fast_warp):
    cfg = _cfg(p_flip=0.5, p_rotate=1.0, p_brightness=0.5,
               shared_geometry=True, fast_warp=fast_warp)
    ti, tm, ji, jm, d, *_ = _run_both(cfg, 8, 64, 64, 16, 7)
    assert len(set(d.angle.tolist())) == 1 and float(d.angle[0]) != 0
    if fast_warp:  # the Paeth warp: a tie shifts a whole row or column
        np.testing.assert_allclose(ti, ji, atol=CHAIN_TOL, rtol=0)
        np.testing.assert_array_equal(tm, jm)
    else:
        ties = _warp_ties(64, 64, d.flip_h.numpy(), d.flip_v.numpy(),
                          d.angle.numpy())
        _assert_ties_only(tm, jm, ties, 0.0, "mask")


def _all_on(**kw):
    return _cfg(use_elastic=True, use_speckle=True, use_tgc=True,
                use_clahe=True, p_crop=0.5, p_elastic=0.5, p_flip=0.5,
                p_rotate=0.5, p_brightness=0.5, p_speckle=0.5, p_tgc=0.5,
                p_clahe=0.5, **kw)


@pytest.mark.parametrize("h, w, fast_warp, out", [
    (64, 64, True, 64), (64, 64, False, 32), (64, 32, False, 48)])
def test_all_branches_chained_match_jax(h, w, fast_warp, out):
    """Every branch on, at once, in the chain's order, and the resize.
    Image by image: masks bit for bit (to CHAIN_TOL once resized: soft
    targets) and images to CHAIN_TOL, in all but at most one image, where
    an elastic or exact-warp tie may move a pixel (and CLAHE then
    re-quantise a frame whose histogram that pixel changed); ties at most
    TIE_SHARE of the pixels where the frame is not resized."""
    cfg = _all_on(fast_warp=fast_warp, h=h, w=w)
    cfg = ja.AugmentConfig(**{**cfg.__dict__, "out_size": (out, out)})
    ti, tm, ji, jm, d, *_ = _run_both(cfg, 16, h, w, 17, 8)
    assert len(d.elastic_idx) and len(d.speckle_idx) and len(d.clahe_idx)
    assert d.tgc_on.any() and d.crop_on.any()
    resized = (out, out) != (h, w)  # then masks are soft: compare values
    n_mask = np.abs(tm - jm).max(axis=(1, 2)) > (CHAIN_TOL if resized else 0)
    n_img = np.abs(ti - ji).max(axis=(1, 2)) > CHAIN_TOL
    assert n_mask.sum() <= 1 and n_img.sum() <= 1, (n_mask, n_img)
    if out == h == w:
        diff = tm != jm
        assert diff.sum() <= TIE_SHARE * diff.size, int(diff.sum())


def test_branch_draws_fail_loudly_when_missing():
    d = ta.sample_draws(torch.Generator().manual_seed(0), 2,
                        ta.AugmentConfig(out_size=(8, 8)))
    with pytest.raises(ValueError, match="elastic"):
        ta.augment_batch(torch.zeros(2, 8, 8, 1), torch.zeros(2, 8, 8, 1), d,
                         ta.AugmentConfig(use_elastic=True, out_size=(8, 8)))


def test_sample_draws_shapes_and_gates():
    """Fields only for the gated images, on the field generator's device;
    one shared flip/rotation under shared_geometry; the probabilities."""
    n, hw = 4000, (6, 5)
    cfg = ta.AugmentConfig(use_elastic=True, use_speckle=True, use_tgc=True,
                           use_clahe=True, p_crop=0.4)
    g = torch.Generator().manual_seed(0)
    d = ta.sample_draws(g, n, cfg, hw, torch.Generator().manual_seed(1))
    for idx, p in ((d.elastic_idx, 0.25), (d.speckle_idx, 0.3),
                   (d.clahe_idx, 0.3)):
        assert abs(len(idx) / n - p) < 0.03
    assert abs(d.tgc_on.float().mean().item() - 0.25) < 0.03
    assert abs(d.crop_on.float().mean().item() - 0.4) < 0.03
    assert d.elastic_dx.shape == (len(d.elastic_idx), *hw)
    assert d.speckle_noise.shape == (len(d.speckle_idx), *hw)
    assert d.crop_top.max() <= 6 - 4 and d.crop_left.max() <= 5 - 4
    assert d.elastic_alpha.min() >= 20 and d.elastic_sigma.max() <= 10
    assert d.tgc_gains.shape == (n, 10)
    assert abs(d.speckle_noise.std().item() - 1) < 0.02
    assert d.elastic_dx.abs().max() <= 1
    s = ta.sample_draws(g, 8, ta.AugmentConfig(shared_geometry=True))
    assert len(set(s.angle.tolist())) == 1
    assert len(set(s.flip_h.tolist())) == 1
    # the default chain's draws are those of the chain without branches
    a = ta.sample_draws(torch.Generator().manual_seed(3), 8, cfg, hw)
    b = ta.sample_draws(torch.Generator().manual_seed(3), 8,
                        ta.AugmentConfig())
    for x, y in zip(a[:5], b):
        assert torch.equal(x, y)
