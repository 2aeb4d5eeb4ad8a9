"""The legacy fixed-architecture models (models/legacy.py: LegacyUNet,
TripleBranchImprovedVNet; models/mores.py: the seven ``Mores*`` models)
against the JAX package's, on the CPU in float32.

Each case is small where the class has a width to cut (``features`` of 4,
8, 16; base 4), 32 x 32 frames; LegacyUNet and MoresUNet have fixed widths
(64..1024). JAX initialises each model, its BatchNorm statistics are drawn
from a numpy seed (means N(0, 0.2), variances U(0.5, 1.5)), and it is
exported both ways (``save_params_npz`` and ``torch_interop.save_pth``);
the port loads each strictly. The triple-branch nets run at dropout 0 on
both sides. Train-mode comparisons run JAX with two-pass BatchNorm
variance, the variance the port computes, and in float64.

MoresTransUNet's dropouts are fixed at 0.1 and JAX has no switch to turn
them off in training, so its draws and the port's can never meet: its
parity is held with eval logits and parameter counts here, and on the card
with statistics (finite terms, launch counts; ``chip_smoke.py``'s legacy
phase). Tolerances are stated beside the values measured here.
"""

import functools
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

from ddti_tpu.models import blocks as jblocks
from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.ops import attention as jattn
from ddti_tpu.train.checkpoint import save_params_npz
from ddti_tpu.train.torch_interop import export_state_dict, save_pth
from ddti_tpu_torch.models import blocks, create_model
from ddti_tpu_torch.models.blocks import PReLU
from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
from ddti_tpu_torch.train.fold_bn import fold_batchnorm
from ddti_tpu_torch.train.state import count_params
from ddti_tpu_torch.train.torch_interop import (
    flat_flax_from_state_dict,
    state_dict_from_flax,
)
from ddti_tpu_torch.utils.weight_init import init_like_flax

SIZE, BATCH = 32, 4
TRANS = dict(features=(4, 8), trans_dim=16, num_heads=2, num_layers=2,
             image_size=SIZE)
# id -> kwargs; the model type is the id
CASES = {
    "LegacyUNet": {},
    "TripleBranchImprovedVNet": dict(base_num_filters=4, dropout_rate=0.0),
    "MoresUNet": {},
    "MoresVNet2D": dict(features=(4, 8, 16)),
    "MoresAttentionUNet": dict(features=(4, 8, 16)),
    "MoresResUNet": dict(features=(4, 8, 16)),
    "MoresASPPUNet": dict(features=(4, 8, 16)),
    "MoresTransUNet": TRANS,
    "MoresImprovedVNet": dict(base_filters=4, dropout_rate=0.0),
}
# the JAX package's counts at the default ctors (cli/params.py's first
# section for the reference set; the two others from jax.eval_shape)
DEFAULT_COUNTS = {
    "LegacyUNet": 31_042_369, "MoresVNet2D": 8_127_031,
    "TripleBranchImprovedVNet": 160_435_681, "MoresTransUNet": 20_560_449,
    "MoresResUNet": 32_429_185, "MoresASPPUNet": 39_947_329,
    "MoresAttentionUNet": 31_388_013, "MoresUNet": 31_042_369,
    "MoresImprovedVNet": 160_435_681,
}
# float32 eval logits, max |port - JAX| / max |JAX|: measured 1.5e-7 -
# 1.0e-6 over the nine models and both loads (4.9e-7 at MoresVNet2D's odd
# side)
LOGIT_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: xdist runs six of these processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_pass_bn():
    # both packages in two passes: flax's use_fast_variance=False and
    # the port's BatchNorm2d.exact_variance (--bn_exact_variance)
    jblocks.set_bn_fast_variance(False)
    blocks.BatchNorm2d.exact_variance = True
    yield
    jblocks.set_bn_fast_variance(True)
    blocks.BatchNorm2d.exact_variance = False


def _draw_stats(stats, seed=0):
    rng = np.random.default_rng(seed)

    def draw(kp, a):
        if kp[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0.0, 0.2, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, stats)


@functools.lru_cache(maxsize=None)
def jax_model(case: str, size: int = SIZE):
    """(flax module, params, batch_stats) of a case, the statistics drawn
    from a numpy seed."""
    jm = jcreate_model(case, **CASES[case])
    v = jax.jit(lambda k: jm.init({"params": k},
                                  jnp.zeros((1, size, size, 1)),
                                  train=False))(jax.random.PRNGKey(1))
    return jm, v["params"], _draw_stats(v["batch_stats"])


def _state_dict(case):
    _, params, stats = jax_model(case)
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in export_state_dict(case, params, stats).items()}


def port_model(case: str, fmt: str | None = None, tmp_path=None):
    """The port's model of a case with JAX's weights, through JAX's
    ``save_pth`` or ``save_params_npz`` file when ``fmt`` is given."""
    m = create_model(case, **CASES[case])
    if fmt is None:
        m.load_state_dict(_state_dict(case), strict=True)
        return m
    _, params, stats = jax_model(case)
    path = str(tmp_path / f"{case}.{fmt}")
    if fmt == "pth":
        save_pth(path, case, params, stats)
    else:
        save_params_npz(path, params, stats)
    return load_checkpoint_into(path, case, m)


def _frames(n=2, size=SIZE, seed=0):
    return np.random.default_rng(seed).normal(
        0.0, 1.0, (n, size, size, 1)).astype(np.float32)


def _port_eval(m, x):
    m.eval()
    with torch.no_grad():
        out = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    return out.permute(0, 2, 3, 1).numpy()


def _jax_apply(jm, params, stats, x):
    apply = jax.jit(functools.partial(jm.apply, train=False))
    return np.asarray(apply({"params": params, "batch_stats": stats},
                            jnp.asarray(x)))


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


def _jax_count(case, **kw):
    shapes = jax.eval_shape(
        lambda: jcreate_model(case, **kw).init(
            {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 32, 32, 1)),
            train=False))
    return sum(int(np.prod(a.shape)) for a in
               jax.tree.leaves(shapes["params"]))


@pytest.mark.parametrize("case", list(CASES))
def test_param_counts_match_jax(case):
    """At the default ctor (the JAX counts, held as constants, that
    ``cli/params.py`` prints) and at the case's small size."""
    with warnings.catch_warnings(), torch.device("meta"):
        warnings.simplefilter("error")  # the default ctor drops nothing
        assert count_params(create_model(case)) == DEFAULT_COUNTS[case]
    assert _jax_count(case) == DEFAULT_COUNTS[case]
    assert count_params(create_model(case, **CASES[case])) == _jax_count(
        case, **CASES[case])


@pytest.mark.parametrize("case", list(CASES))
def test_eval_logits_match_jax(case, tmp_path):
    """Eval logits of the port loaded from JAX's .pth and from its .npz;
    the two loads hold the same tensors and the state_dict keys are JAX's
    export's."""
    x = _frames()
    jm, params, stats = jax_model(case)
    want = _jax_apply(jm, params, stats, x)
    pth = port_model(case, "pth", tmp_path)
    npz = port_model(case, "npz", tmp_path)
    assert set(pth.state_dict()) == set(export_state_dict(case, params,
                                                          stats))
    for k, v in pth.state_dict().items():
        assert torch.equal(v, npz.state_dict()[k]), k
    got = _port_eval(pth, x)
    assert got.shape == want.shape == (2, SIZE, SIZE, 1)
    assert _rel(got, want) < LOGIT_RTOL


@pytest.mark.parametrize("case", list(CASES))
def test_flax_round_trip_and_port_weights_in_jax(case):
    """``state_dict_from_flax`` and ``flat_flax_from_state_dict`` invert
    each other on JAX's tree, bit for bit, and a port model's own weights
    (``init_like_flax``, statistics from a seed) carried to flax give
    JAX's apply the port's logits (measured relative 3.2e-7 - 1.0e-6)."""
    _, params, stats = jax_model(case)
    flat = {f"{c}/{k}": np.asarray(a) for c, tree in (
        ("params", params), ("batch_stats", stats))
        for k, a in flatten_dict(tree, sep="/").items()}
    sd = state_dict_from_flax(case, flat)
    back = flat_flax_from_state_dict(case, sd)
    assert sorted(back) == sorted(flat)
    for k, a in flat.items():
        assert back[k].shape == a.shape and np.array_equal(back[k], a), k

    m = init_like_flax(create_model(case, **CASES[case]), 7)
    rng = np.random.default_rng(8)
    with torch.no_grad():
        for name, buf in m.named_buffers():
            if name.endswith("running_var"):
                buf.copy_(torch.from_numpy(rng.uniform(
                    0.5, 1.5, buf.shape).astype(np.float32)))
            elif name.endswith("running_mean"):
                buf.copy_(torch.from_numpy(rng.normal(
                    0.0, 0.2, buf.shape).astype(np.float32)))
    tree = unflatten_dict({tuple(k.split("/")): jnp.asarray(a) for k, a in
                           flat_flax_from_state_dict(
                               case, m.state_dict()).items()})
    x = _frames(seed=3)
    jm = jax_model(case)[0]
    want = _jax_apply(jm, tree["params"], tree["batch_stats"], x)
    assert _rel(_port_eval(m, x), want) < LOGIT_RTOL


def test_mores_vnet_odd_sides():
    """flax's SAME padding of the 2x2 strided down-convs: one down-conv on
    an odd 9 x 9 map (ceil -> 5, padded at the bottom and right) against
    flax's conv with the same kernel; the model at 36^2 (36 -> 18 -> 9: an
    odd bottleneck) against JAX; at 36^2 with a third level (9 -> 5, whose
    upsampled 10^2 meets a 9^2 skip) both packages refuse the input, as
    neither resizes a decoder input."""
    case = "MoresVNet2D"
    m = port_model(case)
    sizes = []
    hooks = [d.register_forward_hook(
        lambda mod, i, o: sizes.append(o.shape[-1])) for d in m.down_convs]
    x = np.random.default_rng(4).normal(size=(2, 9, 9, 4)).astype(np.float32)
    _, params, _ = jax_model(case)
    kernel = params["down0"]["kernel"]
    from flax import linen as fnn
    want = np.asarray(fnn.Conv(4, (2, 2), strides=(2, 2), use_bias=False)
                      .apply({"params": {"kernel": kernel}}, jnp.asarray(x)))
    with torch.no_grad():
        got = m.down_convs[0](torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape[-2:] == (5, 5) and want.shape[1:3] == (5, 5)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=1e-6, atol=1e-6)
    sizes.clear()

    two = dict(features=(4, 8))
    jm = jcreate_model(case, **two)
    v = jm.init({"params": jax.random.PRNGKey(2)}, jnp.zeros((1, 36, 36, 1)),
                train=False)
    stats = _draw_stats(v["batch_stats"], 5)
    tm = create_model(case, **two)
    tm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(a)) for k, a
                        in export_state_dict(case, v["params"],
                                             stats).items()})
    hooks += [d.register_forward_hook(
        lambda mod, i, o: sizes.append(o.shape[-1])) for d in tm.down_convs]
    x = _frames(size=36)
    got = _port_eval(tm, x)
    assert sizes == [18, 9]
    assert _rel(got, _jax_apply(jm, v["params"], stats, x)) < LOGIT_RTOL
    for h in hooks:
        h.remove()

    three = jax_model(case)
    with pytest.raises(TypeError):
        _jax_apply(*three, x)
    with pytest.raises(RuntimeError, match="Sizes of tensors must match"):
        _port_eval(m, x)


def test_mores_transunet_flash_path_matches_jax_pallas_interpret(
        monkeypatch):
    """MoresTransUNet at 128^2 with features (4, 8): a 32 x 32 = 1024-token
    bottleneck, heads of 8, so both packages' gates take flash in eval. The
    port's flash_attention (its plain version here, on the CPU) against
    JAX's Pallas forward in interpret mode (the head-packed kernel), on the
    same weights: logits within 1e-5 of the largest (measured 3.9e-7), and
    the port went through flash_attention once a layer."""
    kw = dict(TRANS, image_size=128)
    jm = jcreate_model("MoresTransUNet", **kw)
    v = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, 128, 128, 1)),
                                  train=False))(jax.random.PRNGKey(3))
    stats = _draw_stats(v["batch_stats"], 6)
    interpret = []

    def pallas(q, k, v):
        interpret.append(q.shape)
        return jattn._flash_forward_packed(
            q, k, v, *jattn._auto_blocks(q.shape[-2], None, None, q.dtype),
            jattn._packing(q), True)[0]

    monkeypatch.setattr(jattn, "flash_attention", pallas)
    x = _frames(n=1, size=128, seed=9)
    want = _jax_apply(jm, v["params"], stats, x)
    assert [s for s in interpret] == [(1, 2, 1024, 8)] * kw["num_layers"]

    calls = []
    real = blocks.flash_attention
    monkeypatch.setattr(blocks, "flash_attention",
                        lambda q, k, v: calls.append(q.shape) or real(q, k,
                                                                      v))
    m = create_model("MoresTransUNet", **kw)
    m.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(a)) for k, a
                       in export_state_dict("MoresTransUNet", v["params"],
                                            stats).items()})
    got = _port_eval(m, x)
    assert calls == [(1, 2, 1024, 8)] * kw["num_layers"]
    assert _rel(got, want) < LOGIT_RTOL
    # training at the fixed dropout 0.1 stays on the plain path
    calls.clear()
    m.train()
    with torch.no_grad():
        out = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert calls == [] and torch.isfinite(out).all()


def test_alias_rule_is_jax():
    """``num_classes`` / ``base_num_filters`` are TripleBranchImprovedVNet's
    own fields: they build 2 outputs, 16 wide, on both sides (the rename
    to out_channels / base_filters would drop them and build the default
    1-class, 64-wide net); on a model with the canonical fields they
    rename."""
    kw = dict(num_classes=2, base_num_filters=16)
    m = create_model("TripleBranchImprovedVNet", **kw)
    assert m.final_conv.out_channels == 2
    assert m.enc_b0_l0.conv1.out_channels == 16
    jm = jcreate_model("TripleBranchImprovedVNet", **kw)
    assert (jm.num_classes, jm.base_num_filters) == (2, 16)
    assert count_params(m) == _jax_count("TripleBranchImprovedVNet", **kw)
    iv = create_model("MoresImprovedVNet", **kw)
    assert (iv.final_conv.out_channels, iv.enc_b0_l0.conv0.out_channels) \
        == (2, 16)
    assert count_params(iv) == _jax_count("MoresImprovedVNet", **kw)
    for make in (create_model, jcreate_model):
        with pytest.warns(UserWarning, match="ignores kwargs.*depth.*remat"):
            make("MoresUNet", base_filters=8, depth=3, remat=True)
        with pytest.warns(UserWarning, match=r"ignores kwargs \['out_"):
            make("TripleBranchImprovedVNet", out_channels=2)


def _std_close(w: torch.Tensor, expected: float) -> bool:
    """A sample std within 4 of its own standard errors (~1/sqrt(2 n))."""
    rel = abs(float(w.detach().std()) / expected - 1)
    return rel < 4 / (2 * w.numel()) ** 0.5


def test_init_covers_the_fixed_models_kinds():
    """``init_like_flax``: MoresTransUNet's own ``pos_emb`` a standard
    normal; lecun-normal (std sqrt(1 / fan_in)) and zero biases for the SE
    gates' 1x1 convs, the strided 3x3 down-convs, the biased transposed
    convs (fan_in = in x 4) and the 2x2 down-convs; MoresVNet2D's PReLU
    slopes at 0.25."""
    trans = init_like_flax(create_model("MoresTransUNet", image_size=256), 0)
    assert _std_close(trans.trans.pos_emb, 1.0)
    assert abs(float(trans.trans.pos_emb.mean())) < 4 / 256 ** 0.5 / 16
    tb = init_like_flax(create_model("TripleBranchImprovedVNet",
                                     base_num_filters=16), 1)
    vnet = init_like_flax(create_model("MoresVNet2D"), 2)
    convs = {"se fc1": tb.se_b1_l3.fc1, "se fc2": tb.dec_se_final.fc2,
             "strided 3x3": tb.down_b2_l1, "transposed": tb.up7,
             "2x2 down": vnet.down_convs[1], "1x1 res_proj": tb.dec_block8
             .res_proj}
    for name, conv in convs.items():
        w = conv.weight
        fan_in = (w.shape[0] if isinstance(conv, torch.nn.ConvTranspose2d)
                  else w.shape[1]) * w[0, 0].numel()
        assert _std_close(w, fan_in ** -0.5), name
        if conv.bias is not None:
            assert float(conv.bias.abs().sum()) == 0.0, name
    slopes = [m.weight for m in vnet.modules() if isinstance(m, PReLU)]
    assert len(slopes) == 2 * (5 + 1 + 5)
    assert all(float(s) == 0.25 for s in slopes)


@pytest.mark.parametrize("case", ["MoresResUNet", "MoresAttentionUNet",
                                  "MoresImprovedVNet"])
def test_mores_models_fold_within_tolerance(case):
    """Conv -> BN blocks fold: ``fold_batchnorm`` returns a folded copy
    whose logits lie within its own tolerance of the model's (measured
    1.9e-7 - 5.1e-7 of the largest logit here)."""
    m = port_model(case).eval()
    folded = fold_batchnorm(m, case)
    assert folded is not m
    x = _frames(seed=11)
    a, b = _port_eval(m, x), _port_eval(folded, x)
    assert np.abs(a - b).max() <= 1e-3 + 0.01 * np.abs(a).max()
