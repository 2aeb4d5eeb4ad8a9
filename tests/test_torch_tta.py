"""Flip TTA (ddti_tpu_torch/eval/tta.py) and its callers against the JAX
package, on the CPU in float32: ``tta_probs``/``tta_logits`` of one model
and weights on both sides (a plain UNet and ImprovedVNet with deep
supervision), the clamp on a saturated forward, ``make_infer_step`` with
``tta`` against JAX's, ``serve_body(..., tta=True)`` against JAX's, and the
training CLI's ``--tta`` in ``test_metrics.json``.

Weights and BatchNorm statistics come from ``test_torch_zoo``'s JAX models
(base filters 8, depth 3, 32²); tolerances are stated beside the values
measured here.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.core import Config as JConfig
from ddti_tpu.eval import tta as jtta
from ddti_tpu.train import create_train_state
from ddti_tpu.train import make_infer_step as jmake_infer_step
from ddti_tpu.train.export import serve_body as jserve_body
from ddti_tpu_torch.cli import main as tmain
from ddti_tpu_torch.core.config import Config
from ddti_tpu_torch.eval import tta
from ddti_tpu_torch.train.export import serve_body
from ddti_tpu_torch.train.state import TrainState
from ddti_tpu_torch.train.steps import make_infer_step

from test_torch_zoo import SIZE, jax_model, port_model

# float32 TTA logits, max |port - JAX| / max |JAX|: measured 2.7e-6 (UNet)
# and 6.3e-6 (ImprovedVNet); the logits are small (0.1-0.3)
LOGIT_RTOL = 1e-4
# a pixel may be classified differently only where the probability lies
# this close to the threshold
PROB_MARGIN = 1e-5
TTA_CASES = ["UNet", "ImprovedVNet-ds"]


def _frames(n=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, SIZE, SIZE, 1), dtype=np.float32)


def _port_fwd(m):
    m.eval()

    def fwd(x):
        out = m(x.permute(0, 3, 1, 2))
        return (out[0] if isinstance(out, tuple) else out).permute(0, 2, 3, 1)

    return fwd


def _jax_fwd(case):
    jm, params, stats = jax_model(case)

    def fwd(x):
        out = jm.apply({"params": params, "batch_stats": stats}, x,
                       train=False)
        return out[0] if isinstance(out, tuple) else out

    return fwd


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("case", TTA_CASES)
def test_tta_matches_jax(case):
    x = _frames()
    with torch.no_grad():
        fwd = _port_fwd(port_model(case))
        probs = tta.tta_probs(fwd, torch.from_numpy(x)).numpy()
        logits = tta.tta_logits(fwd, torch.from_numpy(x)).numpy()
    jfwd = jax.jit(_jax_fwd(case))
    jprobs = np.asarray(jtta.tta_probs(jfwd, jnp.asarray(x)))
    jlogits = np.asarray(jtta.tta_logits(jfwd, jnp.asarray(x)))
    assert probs.dtype == logits.dtype == np.float32
    assert logits.shape == jlogits.shape == (3, SIZE, SIZE, 1)
    assert np.abs(probs - jprobs).max() <= 1e-6
    assert _rel(logits, jlogits) <= LOGIT_RTOL
    # the ensemble differs from one forward on these weights
    with torch.no_grad():
        one = fwd(torch.from_numpy(x)).numpy()
    assert _rel(one, logits) > 10 * LOGIT_RTOL


def test_flip_axes_match_jax():
    assert tta.FLIP_AXES == jtta.FLIP_AXES


@pytest.mark.parametrize("sign", [1.0, -1.0])
def test_saturated_forward_stays_finite(sign):
    """A forward whose sigmoid saturates to exactly 0 or 1 in float32 gives
    the clamp's finite logit, JAX's to the last bit."""
    x = _frames(1)

    def sat(t):
        return sign * 1e4 * (1.0 + t)

    got = tta.tta_logits(sat, torch.from_numpy(x)).numpy()
    want = np.asarray(jtta.tta_logits(sat, jnp.asarray(x)))
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, want)
    assert np.sign(got).min() == np.sign(got).max() == sign
    assert 15.0 < np.abs(got).min() < 17.0


def _masks(n, seed=3):
    rng = np.random.default_rng(seed)
    return ((rng.random((n, SIZE, SIZE, 1)) > 0.5) * 255).astype(np.uint8)


def _median_threshold(jprob):
    """A threshold that splits the ensembled probabilities in half: these
    random-weight models put nearly every logit a little above 0, so 0.5
    would test all-foreground masks alone."""
    return float(np.median(jprob))


@pytest.mark.parametrize("case", TTA_CASES)
def test_infer_step_tta_matches_jax(case):
    """``make_infer_step`` with ``tta``: the predictions and the confusion
    counts equal JAX's, but at pixels whose ensembled probability lies
    within PROB_MARGIN of the threshold; without ``tta`` the step predicts
    once, and differs."""
    jm, params, stats = jax_model(case)
    images = (_frames(4, seed=1) * 255).astype(np.uint8)
    masks = _masks(4)
    jprob = np.asarray(jtta.tta_probs(jax.jit(_jax_fwd(case)),
                                      jnp.asarray(images / 255.0,
                                                  jnp.float32)))
    thr = _median_threshold(jprob)
    jcfg = JConfig(batch_size=4, image_size=SIZE, store_size=SIZE, tta=True)
    jstate = create_train_state(jm, jax.random.PRNGKey(0),
                                (1, SIZE, SIZE, 1), 1e-3, steps_per_epoch=2)
    jstate = jstate.replace(params=params, batch_stats=stats)
    _, _, jpreds, jcounts, _ = jmake_infer_step(jcfg, thr)(
        jstate, jnp.asarray(images), jnp.asarray(masks))

    cfg = Config(batch_size=4, image_size=SIZE, store_size=SIZE, tta=True)
    state = TrainState(port_model(case), 1e-3, 2)
    _, _, preds, counts, per_img = make_infer_step(cfg, thr)(
        state, torch.from_numpy(images), torch.from_numpy(masks))

    near = np.abs(jprob - thr) < PROB_MARGIN
    differ = preds.numpy() != np.asarray(jpreds)
    assert not np.any(differ & ~near)
    for name in ("tp", "fp", "fn", "tn"):
        assert abs(float(getattr(counts, name))
                   - float(getattr(jcounts, name))) <= near.sum(), name
    assert float(counts.tp + counts.fp) == float(preds.sum())
    assert 0.3 < float(preds.float().mean()) < 0.7
    assert per_img[0].shape == (4,)

    cfg.tta = False
    _, _, preds0, _, _ = make_infer_step(cfg, thr)(
        state, torch.from_numpy(images), torch.from_numpy(masks))
    assert np.any(preds0.numpy() != preds.numpy())


@pytest.mark.parametrize("case", TTA_CASES)
def test_serve_body_tta_matches_jax(case):
    """``serve_body(..., tta=True)`` on uint8 frames: JAX's masks, but at
    pixels whose probability lies within PROB_MARGIN of the threshold; a
    deep-supervision model's heads are dropped inside each flip."""
    jm, params, stats = jax_model(case)
    frames = (_frames(2, seed=4) * 255).astype(np.uint8)
    jprob = np.asarray(jtta.tta_probs(jax.jit(_jax_fwd(case)),
                                      jnp.asarray(frames / 255.0,
                                                  jnp.float32)))
    thr = _median_threshold(jprob)
    want = np.asarray(jserve_body(jm, {"params": params,
                                       "batch_stats": stats},
                                  jnp.asarray(frames), thr, tta=True))
    with torch.inference_mode():
        got = serve_body(port_model(case).eval(), torch.from_numpy(frames),
                         thr, tta=True).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert 0.3 < got.mean() < 0.7
    assert not np.any((got != want) & (np.abs(jprob - thr) >= PROB_MARGIN))


def test_cli_tta_writes_tta_true(tmp_path):
    """``cli/main.py --tta``: a 1-epoch CPU run's ``test_metrics.json``
    records ``"tta": true``; without the flag, false."""
    common = ["--mode", "both", "--synthetic", "--device", "cpu",
              "--model_type", "UNet", "--base_filters", "8", "--depth", "3",
              "--image_size", "32", "--store_size", "32", "--batch_size",
              "16", "--epochs", "1", "--log_every", "0"]
    got = {}
    for flag in (True, False):
        base = tmp_path / str(flag)
        assert tmain.main(common + ["--base_dir", str(base)]
                          + (["--tta"] if flag else [])) == 0
        (run,) = base.iterdir()
        with open(run / "result" / "test_metrics.json") as f:
            got[flag] = json.load(f)
    assert got[True]["tta"] is True and got[False]["tta"] is False
    assert got[True]["total_images"] == got[False]["total_images"] == 16

