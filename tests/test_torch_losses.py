"""The port's losses, confusion counts and surface metrics
(ddti_tpu_torch/{losses,eval}) against the JAX package's, on the CPU.

Inputs come from a numpy seed: logits, and soft (mixup-like) targets with
exact 0s and 1s among them, so both binarization conventions and the
boundary term's uint8 truncation are exercised. Float32 on both sides:
the loss terms agree to 1e-6 relative (summation order only); counts are
integers and agree exactly; surface distances to 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.eval import metrics as jm
from ddti_tpu.eval import surface as js
from ddti_tpu.losses import losses as jl
from ddti_tpu_torch.eval import metrics as tm
from ddti_tpu_torch.eval import surface as ts
from ddti_tpu_torch.losses import losses as tl

RTOL = 1e-6


def _batch(seed=0, shape=(3, 24, 20, 1)):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0.0, 2.0, shape).astype(np.float32)
    hard = (rng.random(shape) < 0.3).astype(np.float32)
    lam = np.float32(0.7)
    soft = lam * hard + (1 - lam) * hard[::-1]  # mixup-like: 0, .3, .7, 1
    return logits, soft


def _both(fn_j, fn_t, logits, targets, **kw):
    a = float(fn_j(jnp.asarray(logits), jnp.asarray(targets), **kw))
    b = float(fn_t(torch.from_numpy(logits), torch.from_numpy(targets),
                   **kw))
    return a, b


@pytest.mark.parametrize("name,kw", [
    ("dice_loss", {}), ("bce_with_logits_loss", {}),
    ("focal_tversky_loss", {}),
    ("focal_tversky_loss", dict(alpha=0.3, beta=0.7, gamma=0.75)),
    ("boundary_loss", {}), ("composite_loss", {}),
    ("composite_loss", dict(lam_bce=0.5, lam_dice=0.25)),
])
@pytest.mark.parametrize("layout", ["nhwc", "nhw"])
def test_loss_terms_match_jax(name, kw, layout):
    logits, soft = _batch()
    if layout == "nhw":
        logits, soft = logits[..., 0], soft[..., 0]
    a, b = _both(getattr(jl, name), getattr(tl, name), logits, soft, **kw)
    assert b == pytest.approx(a, rel=RTOL), (name, a, b)


def test_boundary_loss_truncates_soft_targets():
    """Soft targets below 1 truncate to 0 in the distance map: a target of
    all 0.7 has no foreground, so every pixel sits at the cap h + w."""
    logits = np.zeros((1, 6, 5, 1), np.float32)
    soft = np.full((1, 6, 5, 1), 0.7, np.float32)
    got = float(tl.boundary_loss(torch.from_numpy(logits),
                                 torch.from_numpy(soft)))
    assert got == pytest.approx(abs(0.5 - 0.7) * 11, rel=RTOL)


@pytest.mark.parametrize("compute_unused", [True, False])
def test_weighted_loss_matches_jax(compute_unused):
    logits, soft = _batch(seed=1)
    kw = dict(bce_ratio=1.0, dice_ratio=0.0, focal_ratio=1.0,
              boundary_ratio=0.0, compute_unused=compute_unused)
    j = jl.weighted_loss(jnp.asarray(logits), jnp.asarray(soft), **kw)
    t = tl.weighted_loss(torch.from_numpy(logits), torch.from_numpy(soft),
                         **kw)
    for a, b, name in zip(j, t, t._fields):
        assert float(b) == pytest.approx(float(a), rel=RTOL), name
    if not compute_unused:
        assert float(t.dice) == 0.0 and float(t.boundary) == 0.0
    else:
        assert float(t.boundary) > 0.0


@pytest.mark.parametrize("per_image", [False, True])
def test_confusion_counts_match_jax(per_image):
    logits, soft = _batch(seed=2)
    j = jm.confusion_counts(jnp.asarray(logits), jnp.asarray(soft),
                            per_image=per_image)
    t = tm.confusion_counts(torch.from_numpy(logits),
                            torch.from_numpy(soft), per_image=per_image)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # the two conventions differ on soft targets
    assert float(t.tp.sum()) < float(t.inter.sum())
    if per_image:
        whole = tm.confusion_counts(torch.from_numpy(logits),
                                    torch.from_numpy(soft))
        for v, s in zip(t, whole):
            assert float(v.sum()) == float(s)


def test_metrics_from_counts_match_jax():
    logits, soft = _batch(seed=3)
    c = tm.confusion_counts(torch.from_numpy(logits), torch.from_numpy(soft))
    assert tm.metrics_from_counts(*c[:4]) == pytest.approx(
        jm.metrics_from_counts(*(float(x) for x in c[:4])))
    assert tm.epoch_metrics_from_counts(c) == pytest.approx(
        jm.epoch_metrics_from_counts(jm.ConfusionCounts(
            *(jnp.float32(float(x)) for x in c))))
    added = c + c
    assert float(added.union) == 2 * float(c.union)


def _mask_pairs(seed=0, n=6, size=32):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    preds, gts = [], []
    for _ in range(n):
        c = rng.uniform(8, 24, 2)
        r = rng.uniform(3, 9)
        gts.append(((yy - c[0]) ** 2 + (xx - c[1]) ** 2 < r * r))
        c2 = c + rng.normal(0, 2, 2)
        preds.append(((yy - c2[0]) ** 2 + (xx - c2[1]) ** 2
                      < (r + rng.normal(0, 1)) ** 2)
                     | (rng.random((size, size)) < 0.01))
    preds[1][:] = False  # an empty prediction: undefined, NaN
    gts[2][:] = True     # a full mask: surface = its border
    return np.stack(preds).astype(np.uint8), np.stack(gts).astype(np.float32)


def test_surface_metrics_match_jax_and_the_oracle():
    preds, gts = _mask_pairs()
    t = ts.surface_metrics_batch(torch.from_numpy(preds)[..., None],
                                 torch.from_numpy(gts)[..., None])
    j = js.surface_metrics_batch(jnp.asarray(preds)[..., None],
                                 jnp.asarray(gts)[..., None])
    for k in ("hd", "hd95", "assd", "valid"):
        np.testing.assert_allclose(t[k].numpy(), np.asarray(j[k]),
                                   rtol=1e-5, equal_nan=True)
    assert t["valid"].tolist() == [1, 0, 1, 1, 1, 1]
    for i in range(len(preds)):
        o = js.surface_distance_stats_oracle(preds[i], gts[i] > 0)
        for k in ("hd", "hd95", "assd"):
            np.testing.assert_allclose(float(t[k][i]), o[k], rtol=1e-5,
                                       equal_nan=True)


def test_boundary_map_and_percentile_match_jax():
    preds, _ = _mask_pairs(seed=4)
    got = ts.boundary_map(torch.from_numpy(preds).bool())
    for i in range(len(preds)):
        np.testing.assert_array_equal(
            got[i].numpy(), np.asarray(js.boundary_map(jnp.asarray(preds[i]))))
    vals = np.sort(np.random.default_rng(5).random((3, 40)).astype(
        np.float32), axis=1)
    n = np.array([1, 17, 40])
    t = ts._percentile_sorted(torch.from_numpy(vals), torch.from_numpy(n),
                              95.0)
    for i in range(3):
        j = js._percentile_sorted(jnp.asarray(vals[i]), jnp.int32(n[i]), 95.0)
        assert float(t[i]) == pytest.approx(float(j), rel=1e-6)
        assert float(t[i]) == pytest.approx(
            float(np.percentile(vals[i, :n[i]], 95)), rel=1e-5)
