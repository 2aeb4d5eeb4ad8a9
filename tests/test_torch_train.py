"""The port's training slice against the JAX package's, on the CPU in
float32: train-mode BatchNorm, the weight initialisers, the ResUNet key
rules, one train step (loss terms, gradients, the AdamW update, BN
statistics) and a 2-epoch synthetic run through both CLIs.

The JAX side runs with two-pass BatchNorm variance
(``set_bn_fast_variance(False)``, ``--bn_exact_variance``), the variance
the port computes; the draws are derived from JAX's own key layout and fed
to the port (``test_torch_augment.jax_draws``).
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.cli import main as jmain
from ddti_tpu.core import Config as JConfig
from ddti_tpu.data.augment import AugmentConfig as JAugmentConfig
from ddti_tpu.data.augment import augment_batch as jaugment_batch
from ddti_tpu.losses import weighted_loss as jweighted_loss
from ddti_tpu.models import blocks as jblocks
from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.train.checkpoint import save_params_npz
from ddti_tpu.train.state import create_train_state
from ddti_tpu.train.steps import _build_train_step_impl
from ddti_tpu.train.torch_interop import export_state_dict
from ddti_tpu.utils import weight_init as jinit
from ddti_tpu_torch.cli import main as tmain
from ddti_tpu_torch.data.augment import AugmentConfig
from ddti_tpu_torch.losses.losses import weighted_loss
from ddti_tpu_torch.models import blocks, create_model
from ddti_tpu_torch.train import engine
from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
from ddti_tpu_torch.train.state import TrainState
from ddti_tpu_torch.train.steps import make_train_step
from ddti_tpu_torch.train.torch_interop import (
    flat_flax_from_state_dict,
    flax_key_from_torch,
)
from ddti_tpu_torch.utils import weight_init

from test_torch_augment import jax_draws

SMALL = dict(in_channels=1, out_channels=1, base_filters=8, depth=3)
SIZE, BATCH, LR = 64, 4, 1e-5  # the CLI's default learning rate


@pytest.fixture(scope="module")
def two_pass_bn():
    jblocks.set_bn_fast_variance(False)
    yield
    jblocks.set_bn_fast_variance(True)


def test_bn_running_stats_match_flax_two_pass(two_pass_bn):
    """Batch 2 at 2x2: n = 8 per channel, where torch's own train-mode
    update would store the unbiased variance (a factor 8/7 off)."""
    rng = np.random.default_rng(0)
    x = rng.normal(2.0, 3.0, (2, 2, 2, 5)).astype(np.float32)  # NHWC
    mean0 = rng.normal(0, 1, 5).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bias = rng.normal(0, 1, 5).astype(np.float32)
    bn = jblocks.batch_norm(train=True)
    y, upd = bn.apply({"params": {"scale": scale, "bias": bias},
                       "batch_stats": {"mean": mean0, "var": var0}},
                      jnp.asarray(x), mutable=["batch_stats"])
    tb = blocks.BatchNorm2d(5)
    tb.load_state_dict({"weight": torch.from_numpy(scale),
                        "bias": torch.from_numpy(bias),
                        "running_mean": torch.from_numpy(mean0),
                        "running_var": torch.from_numpy(var0)})
    out = tb.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(tb.running_mean.numpy(),
                               np.asarray(upd["batch_stats"]["mean"]),
                               rtol=1e-6)
    np.testing.assert_allclose(tb.running_var.numpy(),
                               np.asarray(upd["batch_stats"]["var"]),
                               rtol=1e-6)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).detach().numpy(),
                               np.asarray(y), rtol=1e-5, atol=1e-5)
    # eval mode normalises with the stored statistics
    tb.eval()
    ye = jblocks.batch_norm(train=False).apply(
        {"params": {"scale": scale, "bias": bias},
         "batch_stats": upd["batch_stats"]}, jnp.asarray(x))
    np.testing.assert_allclose(
        tb(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        .detach().numpy(), np.asarray(ye), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["kaiming", "xavier", "lecun"])
def test_initialisers_match_flax_statistics(kind):
    """Std within 5% of flax's draw of the same shape, and flax's
    truncation (at 2 std of the underlying normal) where it truncates."""
    key = jax.random.PRNGKey(0)
    if kind == "kaiming":  # conv HWIO (3, 3, 32, 64) <-> OIHW
        j = np.asarray(jinit.kaiming_conv(key, (3, 3, 32, 64)))
        t = weight_init.kaiming_conv_(torch.empty(64, 32, 3, 3),
                                      generator=torch.Generator()
                                      .manual_seed(0))
    elif kind == "xavier":  # dense (in 300, out 200) <-> (out, in)
        j = np.asarray(jinit.xavier_dense(key, (300, 200)))
        t = weight_init.xavier_dense_(torch.empty(200, 300),
                                      torch.Generator().manual_seed(0))
    else:  # flax's default conv kernel initialiser
        j = np.asarray(jax.nn.initializers.lecun_normal()(
            key, (3, 3, 32, 64)))
        t = weight_init.lecun_normal_(torch.empty(64, 32, 3, 3),
                                      generator=torch.Generator()
                                      .manual_seed(0))
    t = t.numpy()
    assert t.std() == pytest.approx(j.std(), rel=0.05)
    ratio_j, ratio_t = np.abs(j).max() / j.std(), np.abs(t).max() / t.std()
    if kind == "kaiming":  # a plain normal: tails past 3 std
        assert ratio_j > 3.5 and ratio_t > 3.5
    else:  # truncated at 2 std of the unit normal = 2.27 of the result
        assert ratio_j < 2.3 and ratio_t < 2.3
        assert ratio_t == pytest.approx(ratio_j, rel=0.03)


def test_init_like_flax_and_apply_init_cover_every_kernel():
    m = create_model("ResUNet", **SMALL)
    weight_init.init_like_flax(m, 0)
    assert float(m.final_conv.bias.detach().abs().sum()) == 0.0
    up = m.upconvs[0].weight  # (in 64, out 32, 2, 2): fan_in = 64 * 4
    assert float(up.std()) == pytest.approx((1 / 256) ** 0.5, rel=0.1)
    before = m.encoders[0].conv[0].weight.clone()
    weight_init.apply_init(m, 1)
    assert not torch.equal(before, m.encoders[0].conv[0].weight)
    # kaiming fan_out of the (8, 1, 3, 3) first conv: 8 * 9
    assert float(m.encoders[1].conv[0].weight.std()) == pytest.approx(
        (2 / (16 * 9)) ** 0.5, rel=0.1)


def _jax_variables(jm, seed):
    """flax init in one compiled program (eager init dispatches op by op)."""
    return jax.jit(lambda k: jm.init({"params": k},
                                     jnp.zeros((1, SIZE, SIZE, 1)),
                                     train=False))(jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def jax_init():
    jm = jcreate_model("ResUNet", **SMALL)
    v = _jax_variables(jm, 0)
    rng = np.random.default_rng(0)
    # BN statistics away from (0, 1), so their update is visible
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(
        np.float32), v["batch_stats"])
    return jm, v["params"], stats


def _port_model(params, stats):
    m = create_model("ResUNet", **SMALL)
    m.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in export_state_dict(
                           "ResUNet", params, stats).items()}, strict=True)
    return m


@pytest.mark.parametrize("model_type, extra", [
    pytest.param(name, extra, id=name) for name, extra in (
        ("ResUNet", {}), ("TransUNet", {"image_size": SIZE}), ("UNet", {}),
        ("ASPPUNet", {}), ("AttentionUNet", {}), ("VNet2D", {}),
        ("ImprovedVNet", {"deep_supervision": True}))])
def test_key_rules_round_trip(model_type, extra, tmp_path):
    """Every key of the JAX package's export maps back to its flax path,
    and the port's .npz holds the key set and layouts of
    ``save_params_npz``: all seven models, ImprovedVNet with its gates and
    deep-supervision heads."""
    kw = dict(SMALL, **extra)
    jm = jcreate_model(model_type, **kw)
    v = jax.jit(lambda k: jm.init({"params": k},
                                  jnp.zeros((1, SIZE, SIZE, 1)),
                                  train=False))(jax.random.PRNGKey(1))
    save_params_npz(str(tmp_path / "j.npz"), v["params"], v["batch_stats"])
    want = dict(np.load(tmp_path / "j.npz"))
    m = load_checkpoint_into(str(tmp_path / "j.npz"), model_type,
                             create_model(model_type, **kw))
    got = flat_flax_from_state_dict(model_type, m.state_dict())
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for k in m.state_dict():
        assert flax_key_from_torch(model_type, k) in want


def _jax_cfg(**kw):
    return JConfig(image_size=SIZE, batch_size=BATCH, lr=LR,
                   bn_exact_variance=True, **kw)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (BATCH, SIZE, SIZE, 1), dtype=np.uint8)
    yy, xx = np.mgrid[0:SIZE, 0:SIZE]
    masks = np.zeros((BATCH, SIZE, SIZE, 1), np.uint8)
    for i in range(BATCH):
        c = rng.uniform(20, 44, 2)
        masks[i, ..., 0] = 255 * (((yy - c[0]) ** 2 + (xx - c[1]) ** 2)
                                  < rng.uniform(6, 14) ** 2)
    return images, masks


def test_gradients_match_jax(two_pass_bn, jax_init):
    """Gradients of the weighted loss on one augmented batch, normwise per
    parameter as in tests/test_train_parity.py (per parameter against a
    floor of 1% of the largest parameter's norm). Measured here: global
    7.1e-6, worst parameter 5.3e-5; held to 3e-5 and 2e-4. That test
    allows 5e-3 and 2e-2 against the torch reference, where one side used
    one-pass variance."""
    jm, params, stats = jax_init
    images, masks = _batch()
    key = jax.random.PRNGKey(5)
    cfg = JAugmentConfig(fast_warp=True, out_size=(SIZE, SIZE))
    x, y = jaugment_batch(key, jnp.asarray(images, jnp.float32) / 255.0,
                          jnp.asarray(masks, jnp.float32) / 255.0, cfg)

    def loss_fn(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                          mutable=["batch_stats"])
        return jweighted_loss(out, y).total

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    m = _port_model(params, stats).train()
    logits = m(torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2))
    tloss = weighted_loss(logits.permute(0, 2, 3, 1),
                          torch.from_numpy(np.asarray(y))).total
    tloss.backward()
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    jg = export_state_dict("ResUNet", jgrads, {})
    tg = {k: p.grad.numpy() for k, p in m.named_parameters()}
    assert sorted(tg) == sorted(jg)
    tall = np.concatenate([g.ravel() for g in tg.values()])
    jall = np.concatenate([np.asarray(jg[k]).ravel() for k in tg])
    assert np.linalg.norm(jall - tall) / np.linalg.norm(tall) < 3e-5
    gmax = max(float(np.linalg.norm(g)) for g in tg.values())
    for k, g in tg.items():
        denom = max(float(np.linalg.norm(g)), 1e-2 * gmax)
        assert float(np.linalg.norm(np.asarray(jg[k]) - g)) / denom < 2e-4, k


def test_one_train_step_matches_jax(two_pass_bn, jax_init):
    """One full step from the same weights and batch with JAX's draws:
    loss terms to 1e-5; BN running statistics to 1e-5 normwise per tensor
    (measured worst 1.5e-7); parameters after the AdamW update to 1e-5
    normwise over all of them, every update within 5% of lr of JAX's
    except where a near-zero gradient flips or shrinks it (measured at
    about 0.3% of a tensor; at most 0.5%, or two elements, allowed)."""
    jm, params, stats = jax_init
    images, masks = _batch(seed=1)
    key = jax.random.PRNGKey(9)
    jcfg = _jax_cfg()
    acfg = JAugmentConfig(fast_warp=True, out_size=(SIZE, SIZE))
    state = create_train_state(jm, jax.random.PRNGKey(0),
                               (1, SIZE, SIZE, 1), LR, 16, 1e-2)
    state = state.replace(params=params, batch_stats=stats)
    jstep = jax.jit(_build_train_step_impl(jcfg, acfg))
    jstate, jmet = jstep(state, jnp.asarray(images), jnp.asarray(masks), key)

    m = _port_model(params, stats)
    tstate = TrainState(m, LR, 16, 1e-2)
    step = make_train_step(jcfg, AugmentConfig(out_size=(SIZE, SIZE)))
    k_aug = jax.random.split(key, 3)[0]
    tmet = step(tstate, torch.from_numpy(images), torch.from_numpy(masks),
                jax_draws(k_aug, BATCH, acfg), None)
    for name in ("loss", "bce", "dice", "focal", "boundary"):
        assert float(getattr(tmet, name)) == pytest.approx(
            float(getattr(jmet, name)), rel=1e-5), name
    assert float(tmet.boundary) > 0
    for a, b in zip(jmet.counts, tmet.counts):  # threshold flips only
        assert abs(float(a) - float(b)) <= 2
    assert tstate.step == 1 and int(jstate.step) == 1
    want = export_state_dict("ResUNet", jstate.params, jstate.batch_stats)
    before = export_state_dict("ResUNet", params, stats)
    moved, t_all, w_all = 0, [], []
    for k, t in m.state_dict().items():
        t, w, b = t.numpy(), np.asarray(want[k]), before[k]
        if "running_" in k:
            err = np.linalg.norm(t - w) / np.linalg.norm(w)
            assert err < 1e-5, (k, err)
        else:
            # AdamW's first update is lr * g / (|g| + eps), about the
            # gradient's sign. Where |g| lies within the two packages'
            # float32 difference, or near eps, it can flip or shrink (up to
            # a 2 lr gap); elsewhere the updates agree to 5% of lr.
            gap = np.abs((t - b) - (w - b))
            assert gap.max() <= 2.001 * LR, (k, gap.max())
            assert np.sum(gap > 0.05 * LR) <= max(2, 5e-3 * gap.size), k
            t_all.append(t.ravel())
            w_all.append(w.ravel())
        moved += not np.array_equal(w, b)
    t_all, w_all = np.concatenate(t_all), np.concatenate(w_all)
    assert np.linalg.norm(t_all - w_all) / np.linalg.norm(w_all) < 1e-5
    assert moved == len(want)  # every parameter and statistic updated


def _epoch_lines(log_path):
    text = open(log_path).read()
    train = [float(v) for v in re.findall(
        r"Train Epoch: \d+, Avg Loss: ([\d.]+)", text)]
    ious = [float(v) for v in re.findall(r"IoU: ([\d.]+)\n", text)]
    return train, ious[1::2]  # train, validate alternate per epoch


def test_two_epoch_cli_runs_agree(tmp_path, monkeypatch, jax_init):
    """Slice acceptance: the same 2-epoch synthetic run through the JAX CLI
    (``--cpu``) and the port's (``--device cpu``) from shared initial
    weights, with the port fed JAX's draws. Per-epoch train loss and val
    IoU agree within 2e-3 (the logs print 4 decimals; measured: losses
    1.4153/1.3167 vs 1.4153/1.3166, IoU 0.0/0.0829 vs 0.0/0.0832); both
    run trees exist and the best .pth loads strictly."""
    jm, params, stats = jax_init
    init = str(tmp_path / "init.npz")
    save_params_npz(init, params, stats)
    common = ["--mode", "both", "--synthetic", "--model_type", "ResUNet",
              "--base_filters", "8", "--depth", "3", "--image_size", "64",
              "--store_size", "64", "--batch_size", "16", "--epochs", "2",
              "--lr", "1e-3", "--log_every", "0", "--checkpoint_path", init]
    assert jmain.main(common + ["--cpu", "--use_data_parallel", "false",
                                "--bn_exact_variance",
                                "--compilation_cache", "off",
                                "--base_dir", str(tmp_path / "jax")]) == 0

    root = jax.random.PRNGKey(42)
    acfg = JAugmentConfig(fast_warp=True, out_size=(64, 64))

    def draws(self, epoch, step, n):
        k = jax.random.fold_in(jax.random.fold_in(root, epoch), step)
        return jax_draws(jax.random.split(k, 3)[0], n, acfg), None

    monkeypatch.setattr(engine.Trainer, "_draws", draws)
    assert tmain.main(common + ["--device", "cpu",
                                "--base_dir", str(tmp_path / "port")]) == 0

    runs = {}
    for name in ("jax", "port"):
        (run,) = (tmp_path / name).iterdir()
        for sub in ("models", "log/train_log.log", "result", "config.yaml"):
            assert (run / sub).exists(), (name, sub)
        runs[name] = _epoch_lines(run / "log" / "train_log.log")
        assert len(runs[name][0]) == 2 and len(runs[name][1]) == 2
    for a, b in zip(runs["jax"][0] + runs["jax"][1],
                    runs["port"][0] + runs["port"][1]):
        assert abs(a - b) <= 2e-3, runs
    (run,) = (tmp_path / "port").iterdir()
    m = load_checkpoint_into(str(run / "models" / "ResUNet_best.pth"),
                             "ResUNet", create_model("ResUNet", **SMALL))
    assert sorted(m.state_dict()) == sorted(
        export_state_dict("ResUNet", params, stats))
