"""The port's train-step options (ddti_tpu_torch/train/{steps,state,
engine}.py, models/zoo.py) against the JAX package's, on the CPU in
float32: ``grad_accum``, ``clip_grad_norm`` alone and with ``freeze``,
``freeze`` with ``freeze_bn_stats``, ``ema_decay`` (the shadow and the
eval weights), ``nan_guard`` (the whole state kept) with the Trainer's
patience stop, ``remat`` (whole and by level), and the training CLI with
each of ``test.sh``'s six augmentation settings and with every option.

Both sides start from the same weights (the JAX export loaded into the
port) and the same batch, the port fed JAX's draws; JAX runs with
two-pass BatchNorm variance, the port's. Gradients are read from AdamW's
first moment after one step (optax's ``mu`` and torch's ``exp_avg`` are
both 0.1 g), so they are compared directly, not through AdamW's
sign-like first update.
"""

import fcntl
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddti_tpu.core import Config as JConfig
from ddti_tpu.data.augment import AugmentConfig as JAugmentConfig
from ddti_tpu.models import blocks as jblocks
from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.train.state import create_train_state, freeze_labels
from ddti_tpu.train.state import parse_freeze as jparse_freeze
from ddti_tpu.train.steps import _build_train_step_impl, make_eval_step
from ddti_tpu.train.torch_interop import export_state_dict, flax_to_torch_key
from ddti_tpu_torch.cli import main as tmain
from ddti_tpu_torch.data.augment import AugmentConfig
from ddti_tpu_torch.data.dataset import DeviceDataSource
from ddti_tpu_torch.models import blocks, create_model
from ddti_tpu_torch.train import steps as tsteps
from ddti_tpu_torch.train.state import TrainState
from ddti_tpu_torch.train.steps import make_train_step
from ddti_tpu_torch.train.torch_interop import _from_flax_array

from test_torch_augment import jax_draws

SMALL = dict(in_channels=1, out_channels=1, base_filters=4, depth=3)
SIZE, BATCH, LR = 32, 4, 1e-3
NORM_TOL = 1e-5     # loss terms, parameters, statistics, EMA: normwise
GRAD_TOL = 3e-5     # gradients (first moments), normwise over all


@pytest.fixture(scope="module")
def two_pass_bn():
    # both packages in two passes: flax's use_fast_variance=False and
    # the port's BatchNorm2d.exact_variance (--bn_exact_variance)
    jblocks.set_bn_fast_variance(False)
    blocks.BatchNorm2d.exact_variance = True
    yield
    jblocks.set_bn_fast_variance(True)
    blocks.BatchNorm2d.exact_variance = False


@pytest.fixture(scope="module")
def jax_init():
    jm = jcreate_model("ResUNet", **SMALL)
    v = jax.jit(lambda k: jm.init({"params": k},
                                  jnp.zeros((1, SIZE, SIZE, 1)),
                                  train=False))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(
        np.float32), v["batch_stats"])
    return jm, v["params"], stats


def _port_model(params, stats, **kw):
    m = create_model("ResUNet", **SMALL, **kw)
    m.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in export_state_dict(
                           "ResUNet", params, stats).items()}, strict=True)
    return m


def _batch(seed=0, n=BATCH):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (n, SIZE, SIZE, 1), dtype=np.uint8)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    masks = np.zeros((n, SIZE, SIZE, 1), np.uint8)
    for i in range(n):
        c = rng.uniform(10, 22, 2)
        masks[i, ..., 0] = 255 * (((yy - c[0]) ** 2 + (xx - c[1]) ** 2)
                                  < rng.uniform(4, 8) ** 2)
    return images, masks


def _jcfg(**kw):
    return JConfig(image_size=SIZE, batch_size=BATCH, lr=LR,
                   bn_exact_variance=True, **kw)


ACFG = JAugmentConfig(fast_warp=True, out_size=(SIZE, SIZE))


def _both(jax_init, jcfg, batches):
    """Run ``batches`` [(images, masks, key)] through JAX's step and the
    port's from the same start. Returns (jax state, its metrics, port
    state, port metrics, port model)."""
    jm, params, stats = jax_init
    freeze = jparse_freeze(jcfg)
    ema = jcfg.ema_decay > 0
    state = create_train_state(jm, jax.random.PRNGKey(0), (1, SIZE, SIZE, 1),
                               LR, 16, 1e-2, ema=ema,
                               clip_norm=jcfg.clip_grad_norm, freeze=freeze)
    state = state.replace(params=params, batch_stats=stats,
                          ema_params=params if ema else None)
    jstep = jax.jit(_build_train_step_impl(jcfg, ACFG))
    m = _port_model(params, stats)
    tstate = TrainState(m, LR, 16, 1e-2, model_type="ResUNet",
                        freeze=freeze, clip_norm=jcfg.clip_grad_norm, ema=ema)
    step = make_train_step(jcfg, AugmentConfig(out_size=(SIZE, SIZE)))
    jmets, tmets = [], []
    for images, masks, key in batches:
        state, jmet = jstep(state, jnp.asarray(images), jnp.asarray(masks),
                            key)
        k_aug = jax.random.split(key, 3)[0]
        tmets.append(step(tstate, torch.from_numpy(np.asarray(images)),
                          torch.from_numpy(np.asarray(masks)),
                          jax_draws(k_aug, images.shape[0], ACFG), None))
        jmets.append(jmet)
    return state, jmets, tstate, tmets, m


def _normwise(got: dict, want: dict, keys) -> float:
    t = np.concatenate([np.asarray(got[k]).ravel() for k in keys])
    w = np.concatenate([np.asarray(want[k]).ravel() for k in keys])
    return float(np.linalg.norm(t - w) / np.linalg.norm(w))


def _torch_dict(params, stats=None):
    return export_state_dict("ResUNet", params, stats or {})


def _adam_mu(opt_state) -> dict:
    """optax's first moment as a torch-keyed dict in torch layouts (the
    frozen leaves, masked out of AdamW, absent)."""
    (adam,) = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)]
    flat = {}
    for kp, v in jax.tree_util.tree_leaves_with_path(
            adam.mu, is_leaf=lambda x: isinstance(x, optax.MaskedNode)):
        if isinstance(v, optax.MaskedNode):
            continue
        path = tuple(str(getattr(k, "key", k)) for k in kp)
        flat[flax_to_torch_key("ResUNet", path)] = _from_flax_array(
            path, np.asarray(v))
    return flat


def _check_step(jstate, jmet, tstate, tmet, m, mu_keys=None):
    """Loss terms to NORM_TOL; BN statistics per tensor and parameters
    over all to NORM_TOL normwise; gradients (first moments) to GRAD_TOL."""
    for name in ("loss", "bce", "dice", "focal", "boundary"):
        assert float(getattr(tmet, name)) == pytest.approx(
            float(getattr(jmet, name)), rel=NORM_TOL), name
    want = _torch_dict(jstate.params, jstate.batch_stats)
    got = {k: v.detach().numpy() for k, v in m.state_dict().items()}
    for k in got:
        if "running_" in k:
            assert _normwise(got, want, [k]) < NORM_TOL, k
    pkeys = [k for k, _ in m.named_parameters()]
    assert _normwise(got, want, pkeys) < NORM_TOL
    jmu = _adam_mu(jstate.opt_state)
    tmu = {k: tstate.optimizer.state[p]["exp_avg"].numpy()
           for k, p in m.named_parameters() if p in tstate.optimizer.state}
    assert sorted(tmu) == sorted(mu_keys or pkeys)
    assert sorted(jmu) == sorted(tmu)
    assert _normwise(tmu, jmu, sorted(tmu)) < GRAD_TOL


# ------------------------------------------------------------ grad_accum


def test_grad_accum_matches_jax(two_pass_bn, jax_init):
    """Two microbatches of two: BatchNorm per microbatch with its running
    statistics chained, the mean gradient, one update; the EDT (the
    boundary term) runs once a microbatch."""
    images, masks = _batch(1)
    jstate, (jmet,), tstate, (tmet,), m = _both(
        jax_init, _jcfg(grad_accum=2), [(images, masks,
                                         jax.random.PRNGKey(3))])
    _check_step(jstate, jmet, tstate, tmet, m)
    one = TrainState(_port_model(*jax_init[1:]), LR, 16)
    draws = jax_draws(jax.random.split(jax.random.PRNGKey(3), 3)[0], BATCH,
                      ACFG)
    met = make_train_step(_jcfg(), AugmentConfig(out_size=(SIZE, SIZE)))(
        one, torch.from_numpy(images), torch.from_numpy(masks), draws, None)
    assert float(met.loss) != pytest.approx(float(tmet.loss), rel=1e-4)


def test_grad_accum_refuses_an_indivisible_batch(jax_init):
    images, masks = _batch(2, n=3)
    step = make_train_step(_jcfg(grad_accum=2),
                           AugmentConfig(out_size=(SIZE, SIZE)))
    state = TrainState(_port_model(*jax_init[1:]), LR, 16)
    draws = jax_draws(jax.random.PRNGKey(0), 3, ACFG)
    with pytest.raises(ValueError, match="not divisible by grad_accum 2"):
        step(state, torch.from_numpy(images), torch.from_numpy(masks),
             draws, None)


# ------------------------------------------------------- clip and freeze


def _frozen_keys(jax_init, prefixes):
    """The torch keys of the parameters JAX's ``freeze_labels`` freezes."""
    labels, _ = freeze_labels(jax_init[1], prefixes)
    out = []
    for kp, lab in jax.tree_util.tree_leaves_with_path(labels):
        if lab == "frozen":
            path = tuple(str(getattr(k, "key", k)) for k in kp)
            out.append(flax_to_torch_key("ResUNet", path))
    return sorted(out)


@pytest.mark.parametrize("freeze", ["", "encoders,bottleneck/conv2"])
def test_clip_grad_norm_and_freeze_match_optax_chain(two_pass_bn, jax_init,
                                                     freeze):
    """A clip limit far below the gradients' global norm, so the step
    clips. With --freeze (and --freeze_bn_stats) the frozen gradients are
    zeroed before the norm (JAX ``compose_mask_clip``), so only the
    trainable ones count; the frozen parameters, and their modules'
    BatchNorm statistics, keep their bits and hold no AdamW state; the
    port freezes exactly the tensors JAX's ``freeze_labels`` does."""
    images, masks = _batch(4)
    jcfg = _jcfg(clip_grad_norm=1e-3, freeze=freeze,
                 freeze_bn_stats=bool(freeze))
    before = {k: v.clone() for k, v in _port_model(
        *jax_init[1:]).state_dict().items()}
    jstate, (jmet,), tstate, (tmet,), m = _both(
        jax_init, jcfg, [(images, masks, jax.random.PRNGKey(5))])
    frozen = _frozen_keys(jax_init, jparse_freeze(jcfg))
    assert sorted(tstate.frozen) == frozen and bool(frozen) == bool(freeze)
    trainable = [k for k, _ in m.named_parameters() if k not in frozen]
    _check_step(jstate, jmet, tstate, tmet, m, mu_keys=trainable)
    g = np.sqrt(sum(float((tstate.optimizer.state[p]["exp_avg"] / 0.1)
                          .square().sum()) for p in tstate.trainable))
    assert g == pytest.approx(1e-3, rel=1e-4)  # clipped to the limit
    pinned = ("encoders.", "bottleneck.conv.3.")  # bottleneck/conv2: no BN
    for k, v in m.state_dict().items():
        keep = bool(freeze) and k.startswith(pinned)
        assert torch.equal(v, before[k]) == keep, k
    assert not any(p in tstate.optimizer.state for k, p in
                   m.named_parameters() if k in frozen)
    assert all(p.grad is None and not p.requires_grad
               for k, p in m.named_parameters() if k in frozen)


def test_frozen_parameters_take_gradients_only_under_nan_guard(jax_init):
    """Frozen tensors leave autograd (no weight gradient is computed for
    them) unless --nan_guard, whose finiteness check counts every
    gradient as JAX's ``finite_all`` does; a later state without
    --freeze makes every parameter trainable again."""
    m = _port_model(*jax_init[1:])
    images, masks = _batch(8)
    draws = jax_draws(jax.random.PRNGKey(1), BATCH, ACFG)
    for nan_guard in (False, True):
        state = TrainState(m, LR, 16, model_type="ResUNet",
                           freeze=("encoders_0",), nan_guard=nan_guard)
        step = make_train_step(_jcfg(freeze="encoders_0",
                                     nan_guard=nan_guard),
                               AugmentConfig(out_size=(SIZE, SIZE)))
        met = step(state, torch.from_numpy(images), torch.from_numpy(masks),
                   draws, None)
        assert float(met.skipped) == 0.0 and state.frozen
        for k, p in m.named_parameters():
            got = p.grad is not None
            assert got == p.requires_grad == (nan_guard
                                              or k not in state.frozen), k
    TrainState(m, LR, 16)
    assert all(p.requires_grad for p in m.parameters())


def test_freeze_without_bn_stats_lets_statistics_adapt(jax_init):
    m = _port_model(*jax_init[1:])
    before = {k: v.clone() for k, v in m.state_dict().items()}
    state = TrainState(m, LR, 16, model_type="ResUNet",
                       freeze=("encoders_0",))
    step = make_train_step(_jcfg(freeze="encoders_0"),
                           AugmentConfig(out_size=(SIZE, SIZE)))
    images, masks = _batch(8)
    step(state, torch.from_numpy(images), torch.from_numpy(masks),
         jax_draws(jax.random.PRNGKey(1), BATCH, ACFG), None)
    for k, v in m.state_dict().items():
        if k.startswith("encoders.0."):
            assert torch.equal(v, before[k]) == ("running_" not in k), k


def test_freeze_matching_nothing_raises(jax_init):
    with pytest.raises(ValueError, match="matched no parameters"):
        TrainState(_port_model(*jax_init[1:]), LR, 16, model_type="ResUNet",
                   freeze=("encoders_9",))


# ------------------------------------------------------------------- EMA


def test_ema_shadow_and_eval_weights_match_jax(two_pass_bn, jax_init):
    """The shadow after 3 steps at decay 0.9; validation with it (the EMA
    weights, the live statistics), against JAX's make_eval_step."""
    batches = [(*_batch(10 + i), jax.random.PRNGKey(20 + i))
               for i in range(3)]
    jcfg = _jcfg(ema_decay=0.9)
    jstate, jmets, tstate, tmets, m = _both(jax_init, jcfg, batches)
    for jmet, tmet in zip(jmets, tmets):
        assert float(tmet.loss) == pytest.approx(float(jmet.loss),
                                                 rel=NORM_TOL)
    want = _torch_dict(jstate.ema_params)
    got = {k: v.numpy() for k, v in tstate.ema.items()}
    assert _normwise(got, want, sorted(got)) < NORM_TOL
    live = {k: p.detach().numpy() for k, p in m.named_parameters()}
    assert _normwise(got, live, sorted(got)) > 1e-4  # the shadow lags

    images, masks = _batch(30)
    jval = make_eval_step(jcfg)(jstate, jnp.asarray(images),
                                jnp.asarray(masks))
    tval = tsteps.make_eval_step(jcfg)(tstate, torch.from_numpy(images),
                                       torch.from_numpy(masks))
    assert float(tval.loss) == pytest.approx(float(jval.loss), rel=NORM_TOL)
    plain = tsteps.make_eval_step(_jcfg())(tstate, torch.from_numpy(images),
                                           torch.from_numpy(masks))
    assert float(plain.loss) != pytest.approx(float(tval.loss), rel=1e-6)
    sd = tstate.eval_state_dict()
    for k, v in m.state_dict().items():
        assert torch.equal(sd[k], tstate.ema[k] if k in tstate.ema else v)


# ------------------------------------------------------------- nan_guard


def _full_state(tstate):
    return ({k: v.clone() for k, v in tstate.model.state_dict().items()},
            {id(p): {k: v.clone() if torch.is_tensor(v) else v
                     for k, v in s.items()}
             for p, s in tstate.optimizer.state.items()},
            tstate.step,
            {k: v.clone() for k, v in (tstate.ema or {}).items()})


def _assert_state_equal(a, b):
    (sd_a, opt_a, step_a, ema_a), (sd_b, opt_b, step_b, ema_b) = a, b
    assert step_a == step_b and sorted(sd_a) == sorted(sd_b)
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
    assert opt_a.keys() == opt_b.keys()
    for p in opt_a:
        for k in opt_a[p]:
            assert torch.equal(torch.as_tensor(opt_a[p][k]),
                               torch.as_tensor(opt_b[p][k])), k
    for k in ema_a:
        assert torch.equal(ema_a[k], ema_b[k]), k


@pytest.mark.parametrize("grad_accum", [1, 2])
def test_nan_guard_keeps_the_whole_state(jax_init, grad_accum):
    """A finite step, then a batch with a NaN planted in one image (one
    microbatch under grad_accum 2): the whole state is kept bit for bit
    (parameters, BN statistics, AdamW's moments and step, the EMA, the
    step count), the metrics are zeros and ``skipped`` is 1, as JAX's
    ``guarded_update`` keeps it; the next finite step applies."""
    jcfg = _jcfg(nan_guard=True, grad_accum=grad_accum, ema_decay=0.99)
    images, masks = _batch(40)
    bad = images.astype(np.float32) / 255.0
    bad[-1, 5, 7, 0] = np.nan
    fmasks = masks.astype(np.float32) / 255.0
    m = _port_model(*jax_init[1:])
    tstate = TrainState(m, LR, 16, ema=True)
    step = make_train_step(jcfg, AugmentConfig(out_size=(SIZE, SIZE)))
    draws = jax_draws(jax.random.PRNGKey(41), BATCH, ACFG)
    met = step(tstate, torch.from_numpy(images), torch.from_numpy(masks),
               draws, None)
    assert float(met.skipped) == 0.0 and tstate.step == 1
    kept = _full_state(tstate)
    met = step(tstate, torch.from_numpy(bad), torch.from_numpy(fmasks),
               draws, None)
    assert float(met.skipped) == 1.0
    assert float(met.n) == 0.0 and float(met.loss) == 0.0
    assert all(float(c) == 0.0 for c in met.counts)
    assert tstate.step == 1
    _assert_state_equal(_full_state(tstate), kept)
    met = step(tstate, torch.from_numpy(images), torch.from_numpy(masks),
               draws, None)
    assert float(met.skipped) == 0.0 and tstate.step == 2
    assert not torch.equal(m.state_dict()["final_conv.weight"],
                           kept[0]["final_conv.weight"])


def test_nan_guard_skips_as_jax_does(two_pass_bn, jax_init):
    """JAX's guarded step on the same planted batch skips too."""
    jcfg = _jcfg(nan_guard=True)
    images, masks = _batch(40)
    bad = images.astype(np.float32) / 255.0
    bad[-1, 5, 7, 0] = np.nan
    jstate, (jmet,), tstate, (tmet,), m = _both(
        jax_init, jcfg, [(bad, masks.astype(np.float32) / 255.0,
                          jax.random.PRNGKey(42))])
    assert float(jmet.skipped) == 1.0 == float(tmet.skipped)
    assert int(jstate.step) == 0 == tstate.step


def test_trainer_stops_after_the_nan_guard_patience(tmp_path, monkeypatch):
    """Every batch non-finite: the Trainer stops after --nan_guard_patience
    consecutive skipped steps, validates nothing, and still saves the
    last weights, unchanged from the start."""
    gather = DeviceDataSource.gather

    def poisoned(self, idx):
        images, masks = gather(self, idx)
        images = images.to(torch.float32) / 255.0
        images[:, 0, 0, 0] = float("nan")
        return images, masks.to(torch.float32) / 255.0

    monkeypatch.setattr(DeviceDataSource, "gather", poisoned)
    assert tmain.main(
        ["--mode", "train", "--synthetic", "--device", "cpu",
         "--base_filters", "4", "--depth", "2", "--image_size", "32",
         "--store_size", "32", "--epochs", "3", "--log_every", "0",
         "--nan_guard", "--nan_guard_patience", "2",
         "--base_dir", str(tmp_path)]) == 0
    (run,) = tmp_path.iterdir()
    log = (run / "log" / "train_log.log").read_text()
    assert log.count("update skipped") == 2
    assert "training has diverged; stopping" in log
    assert "Train Epoch: 1" in log and "Validate" not in log
    assert "Train Epoch: 2" not in log
    assert (run / "models" / "ResUNet_last.npz").exists()
    assert not (run / "models" / "ResUNet_best.npz").exists()


# ----------------------------------------------------------------- remat


@pytest.mark.parametrize("model_type, extra", [
    ("ResUNet", {}), ("AttentionUNet", {}), ("VNet2D", {}),
    ("ImprovedVNet", {"deep_supervision": True}),
    ("TransUNet", {"image_size": SIZE, "embed_dim": 8, "num_heads": 2,
                   "num_transformer_layers": 1, "dropout_rate": 0.0})])
@pytest.mark.parametrize("remat", [True, (0, 1)])
def test_remat_matches_the_plain_step(model_type, extra, remat, monkeypatch):
    """Loss and gradients within 1e-6 of the step without remat, running
    statistics equal, and the recomputation really ran (BatchNorm was
    called inside it, and left the statistics alone)."""
    recomputed = []
    forward = blocks.BatchNorm2d.forward

    def counting(self, x):
        recomputed.append(blocks.recomputing())
        return forward(self, x)

    monkeypatch.setattr(blocks.BatchNorm2d, "forward", counting)
    x = torch.from_numpy(np.random.default_rng(0).random(
        (2, 1, SIZE, SIZE)).astype(np.float32))
    out = {}
    for r in (False, remat):
        torch.manual_seed(0)
        m = create_model(model_type, **SMALL, **extra, remat=r).train()
        logits = m(x)
        logits = logits[0] if isinstance(logits, tuple) else logits
        loss = logits.square().mean()
        recomputed.clear()
        loss.backward()
        out[r] = (loss.item(), {k: p.grad for k, p in m.named_parameters()
                                if p.grad is not None},
                  {k: b for k, b in m.named_buffers()}, sum(recomputed))
    (l0, g0, b0, n0), (l1, g1, b1, n1) = out[False], out[remat]
    assert n0 == 0 and n1 > 0
    assert l1 == pytest.approx(l0, rel=1e-6)
    assert sorted(g0) == sorted(g1)
    for k in g0:
        assert torch.allclose(g1[k], g0[k], rtol=0,
                              atol=1e-6 * g0[k].abs().max().item()), k
    for k in b0:
        assert torch.equal(b0[k], b1[k]), k


def test_remat_out_of_range_level_raises_as_jax():
    with pytest.raises(ValueError, match=r"remat level\(s\) \[3\] out of "
                                         r"range for depth 3"):
        create_model("ResUNet", **SMALL, remat=(0, 3))
    jm = jcreate_model("ResUNet", **SMALL, remat=(0, 3))
    with pytest.raises(ValueError, match=r"out of range for depth 3"):
        jm.init({"params": jax.random.PRNGKey(0)},
                jnp.zeros((1, SIZE, SIZE, 1)))


@pytest.mark.parametrize("arg, want", [(True, True), ("0,1", (0, 1)),
                                       ("2", (2,)), ("1,0,1", (0, 1))])
def test_parse_remat_arg_as_jax(arg, want):
    """A bare --remat is True; a comma list its sorted set of levels."""
    from ddti_tpu.cli.main import parse_remat_arg as jparse
    assert tmain.parse_remat_arg(arg) == want == jparse(arg)
    argv = ["--remat"] + ([arg] if isinstance(arg, str) else [])
    assert tmain.get_parser().parse_args(argv).remat == want
    assert tmain.get_parser().parse_args([]).remat is False
    with pytest.raises(SystemExit):
        tmain.get_parser().parse_args(["--remat", ","])


def test_only_qat_and_distillation_still_raise():
    """Neither raises any more: QAT and distillation are ported (a config
    with qat or naming a teacher checkpoint builds its step;
    tests/test_torch_qat.py and tests/test_torch_distill.py hold them
    against JAX)."""
    make_train_step(_jcfg(qat=True), AugmentConfig())
    make_train_step(_jcfg(qat=True, grad_accum=2, nan_guard=True),
                    AugmentConfig())
    make_train_step(_jcfg(distill_checkpoint="t.npz"), AugmentConfig())
    make_train_step(_jcfg(grad_accum=2, nan_guard=True, ema_decay=0.9,
                          clip_grad_norm=1.0), AugmentConfig())


# ------------------------------------------------------------------- CLI

TEST_SH = {"plain": [], "speckle": ["--use_speckle"], "tgc": ["--use_tgc"],
           "clahe": ["--use_clahe"], "mixup": ["--use_mixup"],
           "elastic": ["--use_elastic"],
           "every option": ["--p_crop", "0.5", "--use_elastic",
                            "--use_speckle", "--use_tgc", "--use_clahe",
                            "--aug_shared_geometry", "--aug_exact_warp",
                            "--grad_accum", "2", "--clip_grad_norm", "1.0",
                            "--ema_decay", "0.999", "--nan_guard",
                            "--freeze", "encoders_0", "--freeze_bn_stats",
                            "--remat", "0,1"]}


def _run_cli_settings(root_dir):
    """Every setting's CLI run under ``root_dir``, all started at once
    (each a few seconds of a single-threaded process) and waited for:
    {setting: [exit code, stdout, stderr, base dir]}."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = {}
    try:
        for setting, flags in TEST_SH.items():
            base = root_dir / setting.replace(" ", "_")
            base.mkdir(parents=True)
            cmd = [sys.executable, "-m", "ddti_tpu_torch.cli.main", "--mode",
                   "both", "--synthetic", "--device", "cpu",
                   "--base_filters", "4", "--depth", "2", "--image_size",
                   "32", "--store_size", "32", "--epochs", "1",
                   "--log_every", "0", "--base_dir", str(base), *flags]
            procs[setting] = (subprocess.Popen(
                cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True), base)
        runs = {}
        for setting, (proc, base) in procs.items():
            out, err = proc.communicate(timeout=300)
            runs[setting] = [proc.returncode, out, err, str(base)]
        return runs
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The CLI runs, made once a session: under xdist the first worker to
    ask runs them, holding a lock in the session's shared temporary
    directory, and the others read its results."""
    shared = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        shared = shared.parent
    done = shared / "cli_runs.json"
    with open(shared / "cli_runs.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            done.write_text(json.dumps(_run_cli_settings(shared / "cli")))
    return json.loads(done.read_text())


@pytest.mark.parametrize("setting", list(TEST_SH))
def test_cli_runs_each_test_sh_setting(setting, cli_runs):
    """``python -m ddti_tpu_torch.cli.main --device cpu`` with each of
    test.sh's six augmentation settings (and every new option at once), at
    toy size: exit 0, finite epoch lines, the run tree."""
    rc, out, err, base = cli_runs[setting]
    assert rc == 0, err[-3000:]
    assert out.splitlines()[-1].startswith("[KERNELS] edt_minplus=0")
    (run,) = pathlib.Path(base).iterdir()
    log = (run / "log" / "train_log.log").read_text()
    assert "Train Epoch: 1, Avg Loss: " in log
    assert "nan" not in log.split("Test Metrics")[0].lower()
    for name in ("ResUNet_best.npz", "ResUNet_last.pth"):
        assert (run / "models" / name).exists()
    if setting == "every option":
        assert "Freezing encoders_0:" in log
