"""The port's TransUNet training path against the JAX package's, on the CPU
in float32: the initialisers of the attention projection and the positional
embedding, the gradients of the weighted loss, one full train step, and the
training CLI with a model YAML.

A small TransUNet (base_filters 8, depth 2, 64x64 input -> 256 tokens,
embed 32, 4 heads of 8, 2 layers, dropout 0) takes the flash path on both
sides (``use_flash_attention=True``): the port's autograd Function with the
plain versions of its kernels (``flash_forward_reference``,
``flash_backward_reference``) against JAX's ``flash_attention``, whose
custom VJP falls back to its plain reference on the CPU. The Pallas
kernels themselves are held against the same plain versions in interpret
mode by tests/test_torch_attention.py. JAX runs with two-pass BatchNorm
variance, the variance the port computes; the draws are JAX's own, fed to
the port (``test_torch_augment.jax_draws``).
"""

import json
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

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
from ddti_tpu_torch.cli import main as tmain
from ddti_tpu_torch.data.augment import AugmentConfig
from ddti_tpu_torch.losses.losses import weighted_loss
from ddti_tpu_torch.models import blocks, create_model
from ddti_tpu_torch.ops import attention as tattn
from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
from ddti_tpu_torch.train.state import TrainState
from ddti_tpu_torch.train.steps import make_train_step
from ddti_tpu_torch.utils import weight_init

from test_torch_augment import jax_draws

SIZE, BATCH, LR = 64, 4, 1e-5
SMALL = dict(in_channels=1, out_channels=1, base_filters=8, depth=2,
             image_size=SIZE, embed_dim=32, num_heads=4,
             num_transformer_layers=2, dropout_rate=0.0,
             use_flash_attention=True)


def test_init_like_flax_covers_attention_projection_and_pos_emb():
    """flax initialises the qkv Dense with lecun-normal (std sqrt(1/E),
    truncated at 2 std of the unit normal = 2.27 of the result) and
    pos_emb with a standard normal; both come from init_like_flax's seeded
    generator, whatever torch's global state. apply_init gives the packed
    projection flax's Xavier-normal, as JAX's does every dense kernel."""
    e = 256
    m = create_model("TransUNet", base_filters=8, depth=2, image_size=64,
                     embed_dim=e, num_heads=8, num_transformer_layers=2)
    got = []
    for state in (1, 2):
        torch.manual_seed(state)
        weight_init.init_like_flax(m, 42)
        got.append({k: v.detach().clone() for k, v in m.named_parameters()
                    if "in_proj" in k or k.endswith("pos_emb")})
    assert len(got[0]) == 5  # two layers' weight and bias, pos_emb
    for k in got[0]:
        assert torch.equal(got[0][k], got[1][k]), k
    for layer in m.trans.layers:
        w = layer.self_attn.in_proj_weight.detach()
        assert float(w.std()) == pytest.approx((1 / e) ** 0.5, rel=0.05)
        assert float(w.abs().max() / w.std()) < 2.3
        assert not layer.self_attn.in_proj_bias.detach().any()
    pos = m.trans.pos_emb.detach()
    assert float(pos.std()) == pytest.approx(1.0, rel=0.05)
    assert float(pos.abs().max()) > 3.0  # an untruncated normal

    pos = pos.clone()
    weight_init.apply_init(m, 7)
    w = m.trans.layers[0].self_attn.in_proj_weight.detach()
    assert float(w.std()) == pytest.approx((2 / (e + 3 * e)) ** 0.5,
                                           rel=0.05)
    assert torch.equal(m.trans.pos_emb.detach(), pos)


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
    jm = jcreate_model("TransUNet", **SMALL)
    v = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros(
        (1, SIZE, SIZE, 1)), train=False))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    # BN statistics away from (0, 1), so their update is visible
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(
        np.float32), v["batch_stats"])
    return jm, v["params"], stats


def _port_model(params, stats):
    m = create_model("TransUNet", **SMALL)
    m.load_state_dict({k: torch.from_numpy(np.array(v, np.float32))
                       for k, v in export_state_dict(
                           "TransUNet", params, stats).items()}, strict=True)
    return m


def _batch(seed):
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
    """Gradients of the weighted loss on one augmented batch through the
    flash path, normwise per parameter against a floor of 1% of the largest
    parameter's norm. Measured: loss equal, global 1.5e-6, worst parameter
    1.8e-5; held to 1e-5, 3e-5 and 2e-4 (the ResUNet test's bounds)."""
    jm, params, stats = jax_init
    images, masks = _batch(0)
    cfg = JAugmentConfig(fast_warp=True, out_size=(SIZE, SIZE))
    x, y = jaugment_batch(jax.random.PRNGKey(5),
                          jnp.asarray(images, jnp.float32) / 255.0,
                          jnp.asarray(masks, jnp.float32) / 255.0, cfg)

    def loss_fn(p):
        out, _ = jm.apply({"params": p, "batch_stats": stats}, x, train=True,
                          mutable=["batch_stats"])
        return jweighted_loss(out, y).total

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    m = _port_model(params, stats).train()
    bwd = tattn.flash_backward_cuda
    before = (tattn.flash_forward_cuda.launches, bwd.launches_dkdv)
    logits = m(torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2))
    tloss = weighted_loss(logits.permute(0, 2, 3, 1),
                          torch.from_numpy(np.asarray(y))).total
    tloss.backward()
    # the CPU tensors ran the kernels' plain versions
    assert (tattn.flash_forward_cuda.launches, bwd.launches_dkdv) == before
    assert tloss.item() == pytest.approx(float(jloss), rel=1e-5)
    jg = export_state_dict("TransUNet", jgrads, {})
    tg = {k: p.grad.numpy() for k, p in m.named_parameters()}
    assert sorted(tg) == sorted(jg)
    tall = np.concatenate([g.ravel() for g in tg.values()])
    jall = np.concatenate([np.asarray(jg[k]).ravel() for k in tg])
    assert np.linalg.norm(jall - tall) / np.linalg.norm(tall) < 3e-5
    gmax = max(float(np.linalg.norm(g)) for g in tg.values())
    for k, g in tg.items():
        denom = max(float(np.linalg.norm(g)), 1e-2 * gmax)
        assert float(np.linalg.norm(np.asarray(jg[k]) - g)) / denom < 2e-4, k
    # the attention's own parameters received gradients through flash
    assert np.abs(tg["trans.layers.0.self_attn.in_proj_weight"]).max() > 0


def test_one_train_step_matches_jax(two_pass_bn, jax_init):
    """One full step from the same weights and batch with JAX's draws, as
    the ResUNet test holds it: loss terms to 1e-5 (measured 6e-7); BN
    running statistics to 1e-5 normwise per tensor (measured 9e-8);
    parameters after the AdamW update to 1e-5 normwise over all of them
    (measured 4e-8), every update within 5% of lr of JAX's except where a
    near-zero gradient flips or shrinks it (at most 0.5% of a tensor, or
    two elements; measured none)."""
    jm, params, stats = jax_init
    images, masks = _batch(1)
    key = jax.random.PRNGKey(9)
    jcfg = JConfig(image_size=SIZE, batch_size=BATCH, lr=LR,
                   bn_exact_variance=True)
    acfg = JAugmentConfig(fast_warp=True, out_size=(SIZE, SIZE))
    state = create_train_state(jm, jax.random.PRNGKey(0),
                               (1, SIZE, SIZE, 1), LR, 16, 1e-2)
    state = state.replace(params=params, batch_stats=stats)
    jstate, jmet = jax.jit(_build_train_step_impl(jcfg, acfg))(
        state, jnp.asarray(images), jnp.asarray(masks), key)

    m = _port_model(params, stats)
    tstate = TrainState(m, LR, 16, 1e-2)
    step = make_train_step(jcfg, AugmentConfig(out_size=(SIZE, SIZE)))
    tmet = step(tstate, torch.from_numpy(images), torch.from_numpy(masks),
                jax_draws(jax.random.split(key, 3)[0], BATCH, acfg), None)
    for name in ("loss", "bce", "dice", "focal", "boundary"):
        assert float(getattr(tmet, name)) == pytest.approx(
            float(getattr(jmet, name)), rel=1e-5), name
    assert float(tmet.boundary) > 0
    want = export_state_dict("TransUNet", jstate.params, jstate.batch_stats)
    before = export_state_dict("TransUNet", params, stats)
    moved, t_all, w_all = 0, [], []
    for k, t in m.state_dict().items():
        t, w, b = t.numpy(), np.asarray(want[k]), before[k]
        if "running_" in k:
            assert np.linalg.norm(t - w) / np.linalg.norm(w) < 1e-5, k
        else:
            gap = np.abs((t - b) - (w - b))
            assert gap.max() <= 2.001 * LR, (k, gap.max())
            assert np.sum(gap > 0.05 * LR) <= max(2, 5e-3 * gap.size), k
            t_all.append(t.ravel())
            w_all.append(w.ravel())
        moved += not np.array_equal(w, b)
    t_all, w_all = np.concatenate(t_all), np.concatenate(w_all)
    assert np.linalg.norm(t_all - w_all) / np.linalg.norm(w_all) < 1e-5
    assert moved == len(want)  # every parameter and statistic updated


# 128^2 at depth 2 is a 32 x 32 = 1024-token bottleneck: the auto gate's
# smallest flash sequence, so the CLI takes flash at dropout 0 and the plain
# path with probability dropout at the default 0.1
CLI_MODEL = dict(in_channels=1, out_channels=1, base_filters=4, depth=2,
                 embed_dim=16, num_heads=2, num_transformer_layers=1)


@pytest.fixture(scope="module")
def jax_npz_keys(tmp_path_factory):
    """The key set of JAX's ``save_params_npz`` for CLI_MODEL at 128^2."""
    jm = jcreate_model("TransUNet", **CLI_MODEL, image_size=128)
    v = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, 128, 128, 1)),
                                  train=False))(jax.random.PRNGKey(0))
    path = str(tmp_path_factory.mktemp("jax") / "j.npz")
    save_params_npz(path, v["params"], v["batch_stats"])
    with np.load(path) as z:
        return sorted(z.files)


@pytest.mark.parametrize("dropout", [0.0, None], ids=["flash", "default"])
def test_cli_trains_transunet_from_model_yaml(tmp_path, dropout, capsys,
                                              jax_npz_keys, monkeypatch):
    """The port's CLI with ``--config_path``: one epoch on the CPU; the run
    tree, finite loss terms, a strict ``.pth`` and an ``.npz`` with the key
    set of JAX's ``save_params_npz`` for the same model."""
    kwargs = dict(CLI_MODEL)
    if dropout is not None:
        kwargs["dropout_rate"] = dropout
    cfg = tmp_path / "transunet.yaml"
    cfg.write_text(yaml.safe_dump({"model": {"model_type": "TransUNet",
                                             "kwargs": kwargs}}))
    took = []
    real = tattn.flash_attention

    def spy(q, k, v):
        took.append(q.shape[2])
        return real(q, k, v)

    monkeypatch.setattr(blocks, "flash_attention", spy)
    assert tmain.main([
        "--mode", "both", "--synthetic", "--config_path", str(cfg),
        "--image_size", "128", "--store_size", "128", "--batch_size", "32",
        "--epochs", "1", "--log_every", "0", "--device", "cpu",
        "--base_dir", str(tmp_path / "runs")]) == 0
    out = capsys.readouterr().out
    assert "[PARAMS] TransUNet," in out
    assert re.search(r"\[KERNELS\] edt_minplus=0 flash_fwd=0 "
                     r"flash_bwd_dkdv=0 flash_bwd_dq=0", out)
    # flash at dropout 0 (train, val and test batches); never at 0.1 in
    # training, and in eval only
    assert all(s == 1024 for s in took)
    assert len(took) == (4 if dropout == 0.0 else 2)

    (run,) = (tmp_path / "runs").iterdir()
    for sub in ("models", "log/train_log.log", "result", "config.yaml"):
        assert (run / sub).exists(), sub
    log = (run / "log" / "train_log.log").read_text()
    terms = [float(v) for v in re.findall(
        r"(?:Avg Loss|BCE Loss|Dice Loss|Focal Loss|Boundary Loss): "
        r"([-\d.naif]+)", log)]
    assert len(terms) == 10 and all(math.isfinite(t) for t in terms)
    assert json.loads((run / "result" / "test_metrics.json").read_text())[
        "total_images"] == 16

    best = run / "models" / "TransUNet_best"
    load_checkpoint_into(str(best) + ".pth", "TransUNet",
                         create_model("TransUNet", **kwargs,
                                      image_size=128))  # strict
    with np.load(str(best) + ".npz") as got:
        assert sorted(got.files) == jax_npz_keys
