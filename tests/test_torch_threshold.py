"""The port's threshold sweep (ddti_tpu_torch/train/steps.py:
make_threshold_sweep_step, Trainer.tune_threshold, --tune_threshold)
against the JAX package's on the CPU, at UNet and AttentionUNet bf8 d3,
32^2, JAX's weights (their 1x1 head rescaled, so that the logits spread
over the grid) loaded into the port.

Tolerances: the port's sweep counts equal the port's own
``confusion_counts`` at every threshold exactly (as JAX's
``test_sweep_counts_match_per_threshold_counts``). Against JAX's sweep on
the same weights and frames, each count differs by at most 0.01% of the
pixels at any threshold (float32 logits that differ by rounding flip
pixels whose probability lies at a threshold), and the argmax threshold
is the same.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.core import Config as JConfig
from ddti_tpu.core import create_logger as jcreate_logger
from ddti_tpu.data import DeviceDataSource as JDeviceDataSource
from ddti_tpu.train import create_train_state
from ddti_tpu.train import make_threshold_sweep_step as jmake_sweep
from ddti_tpu.train.engine import Trainer as JTrainer
from ddti_tpu.train.torch_interop import export_state_dict
from ddti_tpu_torch.core.config import Config
from ddti_tpu_torch.core.logging import create_logger
from ddti_tpu_torch.data.dataset import DeviceDataSource
from ddti_tpu_torch.data.synthetic import generate_ddti_like
from ddti_tpu_torch.eval.metrics import confusion_counts
from ddti_tpu_torch.eval.tta import tta_logits
from ddti_tpu_torch.train.engine import Trainer
from ddti_tpu_torch.train.state import TrainState
from ddti_tpu_torch.train.steps import make_threshold_sweep_step

from test_torch_zoo import CASES, SIZE, jax_model, port_model

GRID = np.round(np.arange(0.05, 0.951, 0.05), 2)
PIXEL_SHARE = 1e-4   # counts vs JAX: 0.01% of the pixels
N = 6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: xdist runs six of these processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def spread_model(case):
    """``jax_model(case)`` with its 1x1 head rescaled so that the logits
    on ``_frames()`` span about [-2.5, 2.5] around 0: the random weights'
    logits lie within 0.2 of each other, a flat IoU curve over the grid.
    Returns (flax module, params, batch_stats, port model)."""
    jm, params, stats = jax_model(case)
    model = port_model(case)
    lo, med, hi = np.percentile(_logits(model, _frames()[0]).numpy(),
                                [10, 50, 90])
    a = np.float32(5.0 / (hi - lo))
    head = params["final_conv"]
    params = {**params, "final_conv": {
        "kernel": np.asarray(head["kernel"]) * a,
        "bias": (np.asarray(head["bias"]) - np.float32(med)) * a}}
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in export_state_dict(
                               CASES[case][0], params, stats).items()})
    return jm, params, stats, model


def _frames(n=N, seed=3):
    im, ma = generate_ddti_like(n, (SIZE, SIZE), seed)
    return im, ma


def _logits(model, images_u8, tta=False):
    x = torch.from_numpy(images_u8).float().div(255.0)
    model.eval()

    def fwd(t):
        with torch.no_grad():
            return model(t.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)

    return tta_logits(fwd, x) if tta else fwd(x)


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
def test_sweep_counts_match_per_threshold_counts(tta, weighted):
    """Each threshold's counts equal confusion_counts at that threshold
    (per image, weighted by ``valid`` where given), exactly."""
    model = spread_model("UNet")[3]
    im, ma = _frames()
    cfg = Config(image_size=SIZE, store_size=SIZE, tta=tta)
    valid = (torch.tensor([1, 1, 0, 1, 0, 1], dtype=torch.float32)
             if weighted else None)
    got = make_threshold_sweep_step(cfg, GRID)(
        TrainState(model, 1e-3, 2), torch.from_numpy(im),
        torch.from_numpy(ma), valid)
    assert got.tp.shape == (len(GRID),)
    logits = _logits(model, im, tta)
    masks_f = torch.from_numpy(ma).float().div(255.0)
    for j, t in enumerate(GRID):
        want = confusion_counts(logits, masks_f, threshold=float(t),
                                per_image=weighted)
        if weighted:
            want = [(v * valid).sum() for v in want]
        for a, b in zip(got, want):
            assert float(a[j]) == float(b), (t, a[j], b)


def test_sweep_scores_the_ema_shadow():
    """Under --ema_decay the sweep scores the shadow, as the test path."""
    model = spread_model("UNet")[3]
    state = TrainState(model, 1e-3, 2, ema=True)
    with torch.no_grad():
        for v in state.ema.values():
            v.mul_(0.5)
    im, ma = _frames()
    cfg = Config(image_size=SIZE, store_size=SIZE, ema_decay=0.9)
    got = make_threshold_sweep_step(cfg, GRID)(
        state, torch.from_numpy(im), torch.from_numpy(ma))
    shadow = spread_model("UNet")[3]
    shadow.load_state_dict(state.eval_state_dict())
    logits = _logits(shadow, im)
    masks_f = torch.from_numpy(ma).float().div(255.0)
    for j, t in enumerate(GRID):
        want = confusion_counts(logits, masks_f, threshold=float(t))
        assert float(got.inter[j]) == float(want.inter)
        assert float(got.union[j]) == float(want.union)


@pytest.mark.parametrize("case", ["UNet", "AttentionUNet"])
@pytest.mark.parametrize("tta", [False, True])
def test_sweep_matches_jax(case, tta):
    jm, params, stats, model = spread_model(case)
    im, ma = _frames()
    jcfg = JConfig(batch_size=N, image_size=SIZE, store_size=SIZE, tta=tta)
    jstate = create_train_state(jm, jax.random.PRNGKey(0),
                                (1, SIZE, SIZE, 1), 1e-3, steps_per_epoch=2)
    jstate = jstate.replace(params=params, batch_stats=stats)
    valid = np.asarray([1, 1, 1, 0, 1, 1], np.float32)
    jgot = jmake_sweep(jcfg, GRID)(jstate, jnp.asarray(im), jnp.asarray(ma),
                                   jnp.asarray(valid))
    cfg = Config(image_size=SIZE, store_size=SIZE, tta=tta)
    got = make_threshold_sweep_step(cfg, GRID)(
        TrainState(model, 1e-3, 2), torch.from_numpy(im),
        torch.from_numpy(ma), torch.from_numpy(valid))
    limit = PIXEL_SHARE * N * SIZE * SIZE
    for name in got._fields:
        diff = np.abs(getattr(got, name).numpy()
                      - np.asarray(getattr(jgot, name), np.float64))
        assert diff.max() <= limit, (name, diff.max(), limit)
    iou = got.inter.numpy() / np.maximum(got.union.numpy(), 1e-8)
    jiou = np.asarray(jgot.inter) / np.maximum(np.asarray(jgot.union), 1e-8)
    assert GRID[int(np.argmax(iou))] == GRID[int(np.argmax(jiou))]
    assert len(set(np.round(iou, 6))) > 2  # the curve is not flat


def _port_trainer(tmp_path, weights, **kw):
    cfg = Config(batch_size=4, image_size=SIZE, store_size=SIZE, lr=1e-3,
                 epochs=1, model_type="UNet", base_dir=str(tmp_path),
                 tune_threshold=True, **kw)
    cfg.make_dirs()
    logger = create_logger(os.path.join(cfg.log_dir, "train_log.log"),
                           console=False)
    # a val split of 6 at batch 4: its last batch carries 2 wraparound
    # duplicates, which the sweep weights out (QUIRKS #22)
    srcs = tuple(DeviceDataSource(*generate_ddti_like(n, (SIZE, SIZE), s))
                 for n, s in ((4, 0), (6, 1), (4, 2)))
    model = spread_model("UNet")[3]
    if weights is not None:
        model.load_state_dict(weights)
    return Trainer(cfg, srcs, logger, model), srcs


def test_trainer_tunes_and_tests_at_argmax(tmp_path):
    """JAX's test_trainer_tunes_and_tests_at_argmax on the port: the pick
    is the argmax of the val IoU curve computed by hand, and test() runs
    at it and records it in test_metrics.json."""
    tr, srcs = _port_trainer(tmp_path, None)
    t = tr.tune_threshold()
    assert 0.05 <= t <= 0.95
    probs = torch.sigmoid(_logits(tr.model, srcs[1].images.numpy())).numpy()
    gt = srcs[1].masks.numpy() > 0
    ious = [np.logical_and(probs > g, gt).sum()
            / max(np.logical_or(probs > g, gt).sum(), 1e-8) for g in GRID]
    assert t == float(GRID[int(np.argmax(ious))])
    m = tr.test(visualize=False)
    with open(os.path.join(tr.config.result_dir, "test_metrics.json")) as f:
        assert json.load(f)["threshold"] == t
    assert 0.0 <= m["iou"] <= 1.0
    with open(os.path.join(tr.config.log_dir, "train_log.log")) as f:
        assert f"-> using {t:.2f}" in f.read()


def test_trainer_tunes_the_threshold_jax_tunes(tmp_path):
    """The JAX Trainer and the port's, on one set of weights and splits,
    pick the same threshold from the same val IoU curve (within 1e-4)."""
    jcfg = JConfig(batch_size=4, image_size=SIZE, store_size=SIZE, lr=1e-3,
                   epochs=1, model_type="UNet", base_dir=str(tmp_path / "j"),
                   use_data_parallel=False, tune_threshold=True)
    jcfg.make_dirs()
    jsrcs = tuple(JDeviceDataSource(*generate_ddti_like(n, (SIZE, SIZE), s))
                  for n, s in ((4, 0), (6, 1), (4, 2)))
    jm, params, stats, _ = spread_model("UNet")
    jtr = JTrainer(jcfg, jsrcs, jcreate_logger(
        os.path.join(jcfg.log_dir, "train_log.log")), jm)
    jtr.state = jtr.state.replace(params=params, batch_stats=stats)
    jt = jtr.tune_threshold()
    tr, _ = _port_trainer(tmp_path / "p", {
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in export_state_dict("UNet", params, stats).items()})
    assert tr.tune_threshold() == jt

    def curve(path):
        with open(path) as f:
            line = next(ln for ln in f if "Threshold sweep" in ln)
        return [float(p.split(":")[1]) for p in
                line.split("Threshold sweep (val IoU): ")[1]
                .split(" -> ")[0].split(", ")]

    np.testing.assert_allclose(
        curve(os.path.join(tr.config.log_dir, "train_log.log")),
        curve(os.path.join(jcfg.log_dir, "train_log.log")), atol=1e-4)
