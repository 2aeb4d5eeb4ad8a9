"""The rest of the zoo (UNet, ASPPUNet, AttentionUNet, VNet2D and
ImprovedVNet) against the JAX package, on the CPU in float32, at base
filters 8 and depth 3.

JAX initialises each model, its BatchNorm statistics are drawn from a numpy
seed (means N(0, 0.2), variances U(0.5, 1.5)), and it is exported both
ways (``save_params_npz`` and ``torch_interop.save_pth``); the port loads
each strictly. Train-mode comparisons run JAX with two-pass BatchNorm
variance (``set_bn_fast_variance(False)``), the variance the port computes.
Tolerances are stated beside the values measured here.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from ddti_tpu.core import Config as JConfig
from ddti_tpu.data.augment import AugmentConfig as JAugmentConfig
from ddti_tpu.losses import weighted_loss as jweighted_loss
from ddti_tpu.models import blocks as jblocks
from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.ops.resample import resize_bilinear_hw as jresize_hw
from ddti_tpu.train.checkpoint import save_params_npz
from ddti_tpu.train.export import serve_body as jserve_body
from ddti_tpu.train.state import create_train_state
from ddti_tpu.train.steps import _build_train_step_impl
from ddti_tpu.train.steps import _ds_aux_loss as jds_aux_loss
from ddti_tpu.train.torch_interop import export_state_dict, save_pth
from ddti_tpu_torch.cli import main as tmain
from ddti_tpu_torch.cli.serve import get_parser as serve_parser
from ddti_tpu_torch.cli.serve import load_predictor
from ddti_tpu_torch.data.augment import AugmentConfig
from ddti_tpu_torch.losses.losses import weighted_loss
from ddti_tpu_torch.models import blocks, create_model
from ddti_tpu_torch.ops.resample import resize_bilinear_hw
from ddti_tpu_torch.train import steps
from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
from ddti_tpu_torch.train.export import serve_body
from ddti_tpu_torch.train.state import TrainState, count_params
from ddti_tpu_torch.utils import weight_init

from test_models import GOLDEN_BF16_D3, GOLDEN_BF32_D4
from test_torch_augment import jax_draws

SMALL = dict(in_channels=1, out_channels=1, base_filters=8, depth=3)
SIZE, BATCH, LR = 32, 4, 1e-5
# id -> (model_type, kwargs beyond SMALL)
CASES = {
    "UNet": ("UNet", {}),
    "ASPPUNet": ("ASPPUNet", {}),
    "AttentionUNet": ("AttentionUNet", {}),
    "VNet2D": ("VNet2D", {}),
    "ImprovedVNet-ds": ("ImprovedVNet", {"deep_supervision": True}),
    "ImprovedVNet-noattn": ("ImprovedVNet", {"use_attention": False}),
}
LOSS_KW = dict(bce_ratio=1.0, dice_ratio=0.0, focal_ratio=1.0,
               boundary_ratio=0.0, compute_unused=True)
ALPHA = 2.0
# float32 eval logits, max |port - JAX| / max |JAX|: measured 2.3e-7 -
# 7.4e-7 over every model, head and size here
LOGIT_RTOL = 1e-5


@pytest.fixture(scope="module")
def two_pass_bn():
    jblocks.set_bn_fast_variance(False)
    yield
    jblocks.set_bn_fast_variance(True)


@functools.lru_cache(maxsize=None)
def jax_model(case: str):
    """(flax module, params, batch_stats) of a case, the statistics drawn
    from a numpy seed."""
    model_type, kw = CASES[case]
    jm = jcreate_model(model_type, **SMALL, **kw)
    v = jax.jit(lambda k: jm.init({"params": k},
                                  jnp.zeros((1, SIZE, SIZE, 1)),
                                  train=False))(jax.random.PRNGKey(1))
    rng = np.random.default_rng(0)

    def draw(kp, a):
        if kp[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0.0, 0.2, a.shape).astype(np.float32)

    stats = jax.tree_util.tree_map_with_path(draw, v["batch_stats"])
    return jm, v["params"], stats


def port_model(case: str, fmt: str = "pth", tmp_path=None):
    """The port's model of a case with JAX's weights: through a JAX
    ``save_pth`` or ``save_params_npz`` file when ``tmp_path`` is given,
    else straight from ``export_state_dict``."""
    model_type, kw = CASES[case]
    _, params, stats = jax_model(case)
    m = create_model(model_type, **SMALL, **kw)
    if tmp_path is None:
        m.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in export_state_dict(
                               model_type, params, stats).items()},
                          strict=True)
        return m
    path = str(tmp_path / f"{case}.{fmt}")
    if fmt == "pth":
        save_pth(path, model_type, params, stats)
    else:
        save_params_npz(path, params, stats)
    return load_checkpoint_into(path, model_type, m)


def _outputs(out):
    """[main logits, head logits...] as NHWC numpy arrays."""
    if isinstance(out, tuple):
        return [out[0], *out[1]]
    return [out]


def _port_eval(m, x):
    m.eval()
    with torch.no_grad():
        out = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    return [t.permute(0, 2, 3, 1).numpy() for t in _outputs(out)]


def _jax_eval(case, x):
    jm, params, stats = jax_model(case)
    out = jm.apply({"params": params, "batch_stats": stats},
                   jnp.asarray(x), train=False)
    return [np.asarray(t) for t in _outputs(out)]


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _frames(n=2, size=SIZE, seed=0):
    return np.random.default_rng(seed).normal(
        0.0, 1.0, (n, size, size, 1)).astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_eval_logits_match_jax(case, tmp_path):
    """Eval logits (and every deep-supervision head) of the port loaded
    from JAX's .pth and from its .npz; the two loads hold the same
    tensors."""
    x = _frames()
    want = _jax_eval(case, x)
    pth = port_model(case, "pth", tmp_path)
    npz = port_model(case, "npz", tmp_path)
    for k, v in pth.state_dict().items():
        assert torch.equal(v, npz.state_dict()[k]), k
    got = _port_eval(pth, x)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert _rel(g, w) < LOGIT_RTOL


def test_deep_supervision_heads_and_targets():
    """ImprovedVNet's heads take the decoders' widths, deepest first (32,
    16, 8 channels at 8^2, 16^2, 32^2); the targets downscaled to each head
    agree with JAX's (measured max |difference| 6.0e-8; held to 1e-6) and
    so does the auxiliary loss on the same heads (measured relative 1.1e-7;
    held to 1e-5)."""
    m = port_model("ImprovedVNet-ds")
    assert [h.in_channels for h in m.ds_heads] == [32, 16, 8]
    x = _frames(BATCH)
    got = _port_eval(m, x)
    assert [g.shape[1] for g in got] == [32, 8, 16, 32]
    rng = np.random.default_rng(3)
    masks = (rng.random((BATCH, SIZE, SIZE, 1)) < 0.3).astype(np.float32)
    for g in got[1:]:
        h = g.shape[1]
        t = resize_bilinear_hw(torch.from_numpy(masks[..., 0]), h, h)
        j = np.asarray(jresize_hw(jnp.asarray(masks[..., 0]), h, h))
        assert np.abs(t.numpy() - j).max() < 1e-6
    heads = [torch.from_numpy(g) for g in got[1:]]
    taux = steps._ds_aux_loss((None, heads), torch.from_numpy(masks),
                              LOSS_KW, ALPHA)
    jaux = jds_aux_loss((None, [jnp.asarray(g) for g in got[1:]]),
                        jnp.asarray(masks), LOSS_KW, ALPHA)
    assert float(taux) == pytest.approx(float(jaux), rel=1e-5)
    assert float(taux) > 0


@pytest.mark.parametrize("case", ["UNet", "VNet2D", "ImprovedVNet-noattn"])
def test_odd_side_matches_jax(case):
    """At 36^2 the strided models pad their 2x2 down-convs as flax's SAME
    does (36 -> 18 -> 9 -> 5, where torch's own padding gives 4) and then
    resize the 10^2 upsampled bottleneck DOWN to the 9^2 skip, antialiased
    as jax.image.resize is; UNet's pools floor 9 to 4 and resize up."""
    x = _frames(size=36)
    m = port_model(case)
    if case != "UNet":
        sizes = []
        hooks = [d.register_forward_hook(
            lambda mod, i, o: sizes.append(o.shape[-1]))
            for d in m.down_convs]
        _port_eval(m, x)
        for h in hooks:
            h.remove()
        assert sizes == [18, 9, 5]
    for g, w in zip(_port_eval(m, x), _jax_eval(case, x)):
        assert g.shape == w.shape == (2, 36, 36, 1)
        assert _rel(g, w) < LOGIT_RTOL


def test_improved_vnet_gate_refuses_odd_side_on_both_sides():
    """ImprovedVNet gates the skip before matching sizes: at 36^2 the 10^2
    upsampled map meets a 9^2 skip and both packages refuse the input."""
    x = _frames(size=36)
    with pytest.raises(TypeError, match="broadcast"):
        _jax_eval("ImprovedVNet-ds", x)
    with pytest.raises(RuntimeError, match="size of tensor"):
        _port_eval(port_model("ImprovedVNet-ds"), x)


@pytest.mark.parametrize("shape, size", [
    ((2, 10, 10, 3), (9, 9)), ((2, 36, 36, 2), (17, 17)),
    ((1, 12, 5, 2), (5, 7)), ((2, 9, 9, 3), (10, 10))])
def test_match_spatial_matches_jax_resize(shape, size):
    """``match_spatial`` against JAX's (``jax.image.resize`` "linear",
    antialias on): downscales, a mixed one and an upscale. Measured max
    |difference| 6.0e-8 - 6.0e-7; held to 1e-6. On upsample the port's
    resize is still the plain bilinear one, bit for bit."""
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    skip = np.zeros((shape[0], *size, shape[3]), np.float32)
    want = np.asarray(jblocks.match_spatial(jnp.asarray(x),
                                            jnp.asarray(skip)))
    tx = torch.from_numpy(x).permute(0, 3, 1, 2)
    got = blocks.match_spatial(tx, torch.from_numpy(skip).permute(0, 3, 1, 2))
    assert np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() < 1e-6
    if size[0] > shape[1] and size[1] > shape[2]:
        plain = torch.nn.functional.interpolate(
            tx, size=size, mode="bilinear", align_corners=False)
        assert torch.equal(got, plain)


def _loss(out, y, aux_fn, loss_fn):
    logits = out[0] if isinstance(out, tuple) else out
    total = loss_fn(logits, y, **LOSS_KW).total
    if isinstance(out, tuple):
        total = total + aux_fn(out, y, LOSS_KW, ALPHA)
    return total


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_match_jax(two_pass_bn, case):
    """Train-mode gradients of the weighted loss (with the heads' term for
    the deep-supervision case), normwise over all parameters and per
    parameter against a floor of 1% of the largest gradient's norm, as in
    ``test_torch_train.py``, held against JAX's gradients computed in
    float64 (the model's dtype, parameters and batch; the loss terms cast
    logits to float32 on both sides). JAX's own float32 gradients are not
    the reference: for ASPPUNet they lie 7.3e-3 normwise from its float64
    ones (1.1e-6 - 7.2e-6 for the other models), where the port's float32
    ones lie 7.1e-7 from them. Measured here: global 5.2e-7 - 2.0e-6, worst
    parameter 2.2e-6 - 7.7e-6; held to 3e-5 and 2e-4, as there."""
    model_type, kw = CASES[case]
    _, params, stats = jax_model(case)
    rng = np.random.default_rng(2)
    x = rng.random((BATCH, SIZE, SIZE, 1)).astype(np.float32)
    y = (rng.random((BATCH, SIZE, SIZE, 1)) < 0.3).astype(np.float32)

    with jax.enable_x64(True):
        jm = jcreate_model(model_type, **SMALL, **kw, dtype=jnp.float64)
        f64 = functools.partial(jax.tree.map,
                                lambda a: jnp.asarray(a, jnp.float64))

        def loss_fn(p):
            out, _ = jm.apply({"params": p, "batch_stats": f64(stats)},
                              jnp.asarray(x, jnp.float64), train=True,
                              mutable=["batch_stats"])
            return _loss(out, jnp.asarray(y), jds_aux_loss, jweighted_loss)

        jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(f64(params))
        jg = {k: np.asarray(v, np.float64) for k, v in
              export_state_dict(model_type, jgrads, {}).items()}
    m = port_model(case).train()
    out = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    out = (out.permute(0, 2, 3, 1) if not isinstance(out, tuple) else
           (out[0].permute(0, 2, 3, 1), [h.permute(0, 2, 3, 1)
                                         for h in out[1]]))
    tloss = _loss(out, torch.from_numpy(y), steps._ds_aux_loss,
                  weighted_loss)
    tloss.backward()
    assert float(tloss.detach()) == pytest.approx(float(jloss), rel=1e-5)
    tg = {k: p.grad.double().numpy() for k, p in m.named_parameters()}
    assert sorted(tg) == sorted(jg)
    tall = np.concatenate([g.ravel() for g in tg.values()])
    jall = np.concatenate([jg[k].ravel() for k in tg])
    assert np.linalg.norm(jall - tall) / np.linalg.norm(jall) < 3e-5
    gmax = max(float(np.linalg.norm(g)) for g in jg.values())
    for k, g in jg.items():
        denom = max(float(np.linalg.norm(g)), 1e-2 * gmax)
        assert float(np.linalg.norm(tg[k] - g)) / denom < 2e-4, k


def test_deep_supervision_train_step_matches_jax(two_pass_bn):
    """One full step of ImprovedVNet with deep_supervision, alpha 2, from
    the same weights and batch with JAX's draws, against JAX's
    ``_build_train_step_impl``: loss terms (the total with the heads' term)
    to 1e-5, BN statistics to 1e-5 normwise per tensor, parameters to 1e-5
    normwise and every update within 5% of lr of JAX's but where a
    near-zero gradient flips it (measured: terms 3.0e-7, statistics 7.9e-7,
    parameters 3.4e-6 normwise; the heads' term 2.31 of the total)."""
    case = "ImprovedVNet-ds"
    model_type, _ = CASES[case]
    jm, params, stats = jax_model(case)
    rng = np.random.default_rng(4)
    images = rng.integers(0, 256, (BATCH, SIZE, SIZE, 1), dtype=np.uint8)
    masks = (255 * (rng.random((BATCH, SIZE, SIZE, 1)) < 0.3)).astype(
        np.uint8)
    key = jax.random.PRNGKey(9)
    jcfg = JConfig(image_size=SIZE, batch_size=BATCH, lr=LR,
                   bn_exact_variance=True, alpha=ALPHA)
    acfg = JAugmentConfig(fast_warp=True, out_size=(SIZE, SIZE))
    state = create_train_state(jm, jax.random.PRNGKey(0),
                               (1, SIZE, SIZE, 1), LR, 16, 1e-2)
    state = state.replace(params=params, batch_stats=stats)
    jstate, jmet = jax.jit(_build_train_step_impl(jcfg, acfg))(
        state, jnp.asarray(images), jnp.asarray(masks), key)

    m = port_model(case)
    tstate = TrainState(m, LR, 16, 1e-2)
    step = steps.make_train_step(jcfg, AugmentConfig(out_size=(SIZE, SIZE)))
    tmet = step(tstate, torch.from_numpy(images), torch.from_numpy(masks),
                jax_draws(jax.random.split(key, 3)[0], BATCH, acfg), None)
    for name in ("loss", "bce", "dice", "focal", "boundary"):
        assert float(getattr(tmet, name)) == pytest.approx(
            float(getattr(jmet, name)), rel=1e-5), name
    # the total carries the heads' term beyond BCE + focal on both sides
    aux = float(tmet.loss) - float(tmet.bce) - float(tmet.focal)
    assert aux > 1e-3
    assert aux == pytest.approx(
        float(jmet.loss) - float(jmet.bce) - float(jmet.focal), rel=1e-4)
    want = export_state_dict(model_type, jstate.params, jstate.batch_stats)
    before = export_state_dict(model_type, params, stats)
    t_all, w_all = [], []
    for k, t in m.state_dict().items():
        t, w, b = t.numpy(), np.asarray(want[k]), before[k]
        if "running_" in k:
            assert np.linalg.norm(t - w) / np.linalg.norm(w) < 1e-5, k
        elif re.fullmatch(r"attn_gates\.\d\.(W_g|W_x|psi)\.0\.bias", k):
            # a conv bias right before a train-mode BatchNorm: its exact
            # gradient is zero (the batch mean takes it out), so both
            # sides' first AdamW updates are float32 noise over eps
            assert np.abs(t - b).max() <= 1.001 * LR
            assert np.abs(w - b).max() <= 1.001 * LR
        else:
            gap = np.abs((t - b) - (w - b))
            assert gap.max() <= 2.001 * LR, (k, gap.max())
            assert np.sum(gap > 0.05 * LR) <= max(2, 5e-3 * gap.size), k
            t_all.append(t.ravel())
            w_all.append(w.ravel())
        assert not np.array_equal(w, b), k  # every tensor moved
    t_all, w_all = np.concatenate(t_all), np.concatenate(w_all)
    assert np.linalg.norm(t_all - w_all) / np.linalg.norm(w_all) < 1e-5


def test_serve_body_takes_the_main_logits():
    """A tuple-output model serves its main head's masks, as JAX's
    ``serve_body`` does: uint8 frames in, masks equal to JAX's but where a
    logit lies within 1e-5 of the threshold."""
    case = "ImprovedVNet-ds"
    jm, params, stats = jax_model(case)
    frames = np.random.default_rng(5).integers(
        0, 256, (2, SIZE, SIZE, 1), dtype=np.uint8)
    want = np.asarray(jserve_body(jm, {"params": params,
                                       "batch_stats": stats},
                                  jnp.asarray(frames)))
    m = port_model(case).eval()
    with torch.inference_mode():
        got = serve_body(m, torch.from_numpy(frames)).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    logits = _jax_eval(case, frames.astype(np.float32) / 255.0)[0]
    assert np.all(np.abs(logits[got != want]) < 1e-5)
    assert 0 < want.mean() < 1  # the check is not vacuous


@pytest.mark.parametrize("name", sorted(GOLDEN_BF16_D3))
def test_param_counts_match_golden(name):
    """The port's parameter counts equal the JAX package's golden counts
    (``tests/test_models.py``) at base 16 / depth 3 and base 32 / depth
    4."""
    extra = {"image_size": 512} if name == "TransUNet" else {}
    for base, depth, golden in ((16, 3, GOLDEN_BF16_D3),
                                (32, 4, GOLDEN_BF32_D4)):
        m = create_model(name, in_channels=1, out_channels=1,
                         base_filters=base, depth=depth, **extra)
        assert count_params(m) == golden[name], (base, depth)


def _jax_count(model_type, **kw):
    shapes = jax.eval_shape(
        lambda: jcreate_model(model_type, **kw).init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 1)),
            train=False))
    return sum(int(np.prod(a.shape)) for a in
               jax.tree.leaves(shapes["params"]))


def test_create_model_rules_match_jax():
    """The ``features=[...]`` doubling adapter, the reference's ctor
    aliases, the warning for unknown kwargs, the fixed-architecture names
    (built with JAX's parameter counts, on the meta device) and an unknown
    name, on both sides."""
    for kw in (dict(features=[8, 16, 32]),
               dict(num_classes=2, base_num_filters=8, depth=3),
               dict(features=(4, 8), use_attention=False,
                    deep_supervision=True)):
        model_type = "ImprovedVNet" if "use_attention" in kw else "UNet"
        m = create_model(model_type, **dict(kw))
        assert count_params(m) == _jax_count(model_type, **dict(kw))
    assert create_model("UNet", num_classes=2).final_conv.out_channels == 2
    assert create_model("VNet2D", features=[8, 16]).depth == 2
    for make in (create_model, jcreate_model):
        with pytest.raises(ValueError, match="doubling"):
            make("UNet", features=[8, 12])
        with pytest.warns(UserWarning, match="ignores kwargs"):
            make("ASPPUNet", base_filters=8, depth=2, bogus=1)
    for name in ("LegacyUNet", "TripleBranchImprovedVNet", "MoresUNet",
                 "MoresImprovedVNet"):
        with torch.device("meta"):
            m = create_model(name)
        assert count_params(m) == _jax_count(name), name
    for make in (create_model, jcreate_model):
        with pytest.raises(NotImplementedError, match="Unknown model_type"):
            make("NoSuchNet")
    aspp = create_model("ASPPUNet", **SMALL, aspp_dilations=[1, 2, 3])
    assert [b.dilation for b in aspp.aspp.branches] == [(1, 1), (2, 2),
                                                       (3, 3)]


def _std_close(w: torch.Tensor, expected: float) -> bool:
    """A sample std within 4 of its own standard errors (~1/sqrt(2 n))."""
    rel = abs(float(w.detach().std()) / expected - 1)
    return rel < 4 / (2 * w.numel()) ** 0.5


def test_init_covers_every_new_module_kind():
    """``init_like_flax``: lecun-normal for ASPP's dilated branches, the
    gates' 1x1 convs, the projection, the strided down-convs and the
    heads (std sqrt(1 / fan_in), fans as for any conv), zero biases (gates,
    heads), PReLU slopes at 0.25. ``apply_init``: Kaiming (std sqrt(2 /
    fan_out)) on the same kernels; biases and slopes stay."""
    models = {n: weight_init.init_like_flax(
        create_model(n, in_channels=1, out_channels=1, base_filters=32,
                     depth=3, **kw), 0)
        for n, kw in (("ASPPUNet", {}), ("AttentionUNet", {}),
                      ("VNet2D", {}),
                      ("ImprovedVNet", {"deep_supervision": True}))}
    kernels = {
        "aspp branch": models["ASPPUNet"].aspp.branches[3],
        "aspp project": models["ASPPUNet"].aspp.project[0],
        "gate W_x": models["AttentionUNet"].attn_gates[0].W_x[0],
        "gate psi": models["AttentionUNet"].attn_gates[0].psi[0],
        "down conv": models["VNet2D"].down_convs[2],
        "ds head": models["ImprovedVNet"].ds_heads[0],
    }
    for name, conv in kernels.items():
        w = conv.weight
        assert _std_close(w, (w.shape[1] * w[0, 0].numel()) ** -0.5), name
        if conv.bias is not None:
            assert float(conv.bias.abs().sum()) == 0.0, name
    slopes = [m.weight for m in models["VNet2D"].modules()
              if isinstance(m, blocks.PReLU)]
    assert len(slopes) == 2 * (3 + 1 + 3)
    assert all(float(s) == 0.25 for s in slopes)
    for m in models.values():
        weight_init.apply_init(m, 1)
    for name, conv in kernels.items():
        w = conv.weight
        assert _std_close(w, (2 / (w.shape[0] * w[0, 0].numel())) ** 0.5), \
            name
        if conv.bias is not None:
            assert float(conv.bias.abs().sum()) == 0.0, name
    assert all(float(s) == 0.25 for s in slopes)


def test_cli_trains_and_serves_deep_supervision_from_yaml(tmp_path):
    """A tiny ``--device cpu`` run of ImprovedVNet with deep supervision
    from a model YAML, ``--alpha`` parsed (default 2): the run tree, a best
    .pth that loads strictly with its heads, an .npz with JAX's key set,
    and the served masks of that .pth through ``load_predictor`` with the
    same YAML."""
    assert tmain.get_parser().parse_args([]).alpha == 2
    cfg = tmp_path / "ivnet.yaml"
    kw = dict(SMALL, base_filters=4, deep_supervision=True)
    cfg.write_text(yaml.safe_dump({"model": {"model_type": "ImprovedVNet",
                                             "kwargs": kw}}))
    assert tmain.main([
        "--mode", "both", "--synthetic", "--device", "cpu",
        "--config_path", str(cfg), "--image_size", "32", "--store_size",
        "32", "--batch_size", "32", "--epochs", "1", "--alpha", "3",
        "--log_every", "0", "--base_dir", str(tmp_path / "runs")]) == 0
    (run,) = (tmp_path / "runs").iterdir()
    assert run.name.startswith("ImprovedVNet_")
    snap = yaml.safe_load((run / "config.yaml").read_text())
    assert snap["alpha"] == 3.0 and snap["model_kwargs"] == kw
    log = (run / "log" / "train_log.log").read_text()
    assert len(re.findall(r"Validate Epoch: 1", log)) == 1
    best = run / "models" / "ImprovedVNet_best"
    m = load_checkpoint_into(str(best) + ".pth", "ImprovedVNet",
                             create_model("ImprovedVNet", **kw))
    assert len(m.ds_heads) == 3
    jm = jcreate_model("ImprovedVNet", **kw)
    v = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((1, 32, 32, 1)), train=False)))
    jpath = str(tmp_path / "j.npz")
    save_params_npz(jpath, v["params"], v["batch_stats"])
    with np.load(str(best) + ".npz") as got, np.load(jpath) as want:
        assert sorted(got.files) == sorted(want.files)
    args = serve_parser().parse_args([
        "--checkpoint", str(best) + ".pth", "--config_path", str(cfg),
        "--image_size", "32", "--batch_size", "2", "--device", "cpu"])
    predict, batch_n, size, info = load_predictor(args)
    assert info["model"] == "ImprovedVNet" and (batch_n, size) == (2, 32)
    frames = np.random.default_rng(0).integers(0, 256, (2, 32, 32, 1),
                                               dtype=np.uint8)
    masks = predict(frames)
    assert masks.dtype == np.uint8 and masks.shape == (2, 32, 32, 1)
    with torch.inference_mode():
        want = serve_body(m.eval(), torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(masks, want)
