"""BatchNorm folding (ddti_tpu_torch/train/fold_bn.py) against the JAX
package's ``train/fold_bn.py``, on the CPU in float32, for the seven zoo
models at base filters 8, depth 3 (32², TransUNet 64² with 64 tokens).

JAX initialises each model; its parameters are perturbed and its
BatchNorm statistics drawn from a numpy seed (means N(0, 0.2), variances
U(0.5, 1.5)), so every fold factor and bias differs from the identity. The
port loads JAX's export strictly. Tolerances are stated beside the values
measured here.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util
from torch import nn

from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.train import fold_bn as jfold
from ddti_tpu.train.torch_interop import export_state_dict
from ddti_tpu_torch.models import create_model
from ddti_tpu_torch.models.blocks import BatchNorm2d
from ddti_tpu_torch.train import fold_bn
from ddti_tpu_torch.train.checkpoint import load_checkpoint_into, save_weights
from ddti_tpu_torch.train.torch_interop import (
    flat_flax_from_state_dict,
    flax_key_from_torch,
)

SMALL = dict(in_channels=1, out_channels=1, base_filters=8, depth=3)
MODELS = {
    "UNet": {}, "ResUNet": {}, "ASPPUNet": {}, "AttentionUNet": {},
    "VNet2D": {}, "ImprovedVNet": {"deep_supervision": True},
    "TransUNet": dict(image_size=64, embed_dim=64, num_heads=2,
                      num_transformer_layers=2),
}
# folded weights exported to flax against JAX's folded params, max |d| /
# max |JAX| of a tensor: measured 1.2e-7 - 3.4e-7 (XLA computes the factor
# its own way: a float32 rounding or two)
WEIGHT_RTOL = 1e-6
# folded vs unfolded float32 logits, max |d| / max |logit|: measured
# 1.0e-6 - 2.7e-6
FOLD_RTOL = 1e-5


def _side(model_type):
    return MODELS[model_type].get("image_size", 32)


@functools.lru_cache(maxsize=None)
def jax_variables(model_type):
    """(flax module, params, batch_stats): JAX's init, parameters
    perturbed by N(0, 0.1), statistics drawn from a numpy seed."""
    jm = jcreate_model(model_type, **SMALL, **MODELS[model_type])
    side = _side(model_type)
    v = jax.jit(lambda k: jm.init({"params": k},
                                  jnp.zeros((1, side, side, 1)),
                                  train=False))(jax.random.PRNGKey(2))
    rng = np.random.default_rng(0)

    def perturb(_, a):
        return (np.asarray(a) + rng.normal(0.0, 0.1, np.shape(a))
                ).astype(np.float32)

    def draw(kp, a):
        if kp[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0.0, 0.2, a.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(perturb, v["params"])
    stats = jax.tree_util.tree_map_with_path(draw, v["batch_stats"])
    return jm, params, stats


def port_model(model_type):
    _, params, stats = jax_variables(model_type)
    m = create_model(model_type, **SMALL, **MODELS[model_type])
    m.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in
                       export_state_dict(model_type, params,
                                         stats).items()}, strict=True)
    return m.eval()


def _jax_pair_paths(params, stats):
    """Full flax paths of the BatchNorms JAX folds: its own ``_classify``
    over its own tree, with the path kept."""
    out = []

    def walk(p, s, prefix):
        for name, child in p.items():
            if not isinstance(child, dict):
                continue
            kind, conv = jfold._classify(p, s, name)
            if kind == "fold":
                out.append(("/".join(prefix + (conv,)),
                            "/".join(prefix + (name,))))
            elif kind == "recurse":
                sub = s.get(name)
                walk(child, sub if isinstance(sub, dict) else {},
                     prefix + (name,))

    walk(params, stats, ())
    return out


def _flax_module(model_type, torch_module, leaf):
    """The flax module path of a torch module name, through one of its
    leaves' keys."""
    key = flax_key_from_torch(model_type, f"{torch_module}.{leaf}")
    return key.split("/", 1)[1].rsplit("/", 1)[0]


@pytest.mark.parametrize("model_type", MODELS)
def test_fold_pairs_equal_jax(model_type):
    """The port's pairs, mapped to flax names, are JAX's: the same (conv,
    BN) module paths, and their BN names are JAX's ``fold_pairs``."""
    _, params, stats = jax_variables(model_type)
    pairs = fold_bn.fold_pairs(port_model(model_type))
    got = sorted((_flax_module(model_type, c, "weight"),
                  _flax_module(model_type, b, "weight")) for c, b in pairs)
    want = sorted(_jax_pair_paths(params, stats))
    assert got == want and len(got) >= 12
    assert sorted(b.rsplit("/", 1)[-1] for _, b in got) == sorted(
        jfold.fold_pairs(params, stats))
    if model_type in ("AttentionUNet", "ImprovedVNet"):
        names = {b.rsplit("/", 1)[-1] for _, b in got}
        assert {"w_g_bn", "w_x_bn", "psi_bn"} <= names
    if model_type == "ASPPUNet":
        assert any(b.endswith("aspp/project_bn") for _, b in got)


@pytest.mark.parametrize("model_type", MODELS)
def test_folded_weights_equal_jax(model_type):
    """The folded state dict exported to flax equals JAX's folded params
    and statistics, key for key, within WEIGHT_RTOL of each tensor's
    largest value; the unfolded model is left as it was."""
    _, params, stats = jax_variables(model_type)
    fparams, fstats = jfold.fold_batchnorm(None, params, stats)
    want = {f"params/{k}": np.asarray(v) for k, v in
            traverse_util.flatten_dict(fparams, sep="/").items()}
    want.update({f"batch_stats/{k}": np.asarray(v) for k, v in
                 traverse_util.flatten_dict(fstats, sep="/").items()})
    m = port_model(model_type)
    before = {k: v.clone() for k, v in m.state_dict().items()}
    got = flat_flax_from_state_dict(model_type,
                                    fold_bn.fold_batchnorm(m).state_dict())
    assert set(got) == set(want)
    for k, v in want.items():
        scale = max(float(np.abs(v).max()), 1e-30)
        assert float(np.abs(got[k] - v).max()) <= WEIGHT_RTOL * scale, k
    for k, v in m.state_dict().items():
        assert torch.equal(v, before[k]), k


@pytest.mark.parametrize("model_type", MODELS)
def test_folded_logits_match_unfolded(model_type, tmp_path):
    """Folded and unfolded eval logits agree within FOLD_RTOL; the folded
    state dict loads with ``strict=True`` and survives ``save_weights`` /
    ``load_checkpoint_into`` in both formats; every folded BN is scale 1,
    mean 0, var 1 - eps."""
    m = port_model(model_type)
    folded = fold_bn.fold_batchnorm(m)
    side = _side(model_type)
    x = torch.from_numpy(np.random.default_rng(5).random(
        (2, 1, side, side), dtype=np.float32))
    with torch.no_grad():
        a, b = m(x), folded.eval()(x)
    a, b = (o[0] if isinstance(o, tuple) else o for o in (a, b))
    assert float((a - b).abs().max() / a.abs().max()) <= FOLD_RTOL
    for _, bn in fold_bn.fold_pairs(m):
        mod = folded.get_submodule(bn)
        assert torch.all(mod.weight == 1) and torch.all(mod.running_mean == 0)
        assert torch.all(mod.running_var == torch.tensor(1.0 - 1e-5))

    fresh = create_model(model_type, **SMALL, **MODELS[model_type])
    fresh.load_state_dict(folded.state_dict(), strict=True)
    base = str(tmp_path / "folded")
    save_weights(base, model_type, folded)
    for ext in (".pth", ".npz"):
        twin = load_checkpoint_into(base + ext, model_type, create_model(
            model_type, **SMALL, **MODELS[model_type]))
        for k, v in folded.state_dict().items():
            assert torch.equal(v, twin.state_dict()[k]), (ext, k)


class _ConvBN(nn.Module):
    """Test-only pairs named as the zoo names them: ``conv1`` (with a bias,
    a Conv2d or a ConvTranspose2d) -> ``bn1``; with ``relu_between`` a ReLU
    between them, the order of the JAX package's LegacyUNet blocks."""

    def __init__(self, transpose=False, relu_between=False):
        super().__init__()
        conv = nn.ConvTranspose2d if transpose else nn.Conv2d
        self.conv1 = conv(3, 4, 2, stride=2 if transpose else 1, bias=True)
        self.bn1 = BatchNorm2d(4)
        self.relu_between = relu_between
        g = torch.Generator().manual_seed(0)
        with torch.no_grad():
            for t in (self.conv1.weight, self.conv1.bias, self.bn1.weight,
                      self.bn1.bias, self.bn1.running_mean):
                t.copy_(torch.randn(t.shape, generator=g))
            self.bn1.running_var.copy_(torch.rand(4, generator=g) + 0.5)

    def forward(self, x):
        y = self.conv1(x)
        return self.bn1(torch.relu(y) if self.relu_between else y)


@pytest.mark.parametrize("transpose", [False, True],
                         ids=["conv", "conv_transpose"])
def test_conv_bias_rides_through_the_fold(transpose):
    """A conv bias passes through the factor into the BN's bias and is
    zeroed (JAX ``_fold_tree``); the factor lies on dim 0 of a Conv2d
    weight and on dim 1 of a ConvTranspose2d weight."""
    m = _ConvBN(transpose).eval()
    assert fold_bn.fold_pairs(m, "UNet") == [("conv1", "bn1")]
    x = torch.rand(2, 3, 8, 8, generator=torch.Generator().manual_seed(1))
    folded = fold_bn.fold_batchnorm(m, "UNet", example=x)
    bn, conv = m.bn1, m.conv1
    factor = bn.weight / torch.sqrt(bn.running_var + 1e-5)
    want_bias = bn.bias - bn.running_mean * factor + conv.bias * factor
    torch.testing.assert_close(folded.bn1.bias, want_bias)
    assert torch.all(folded.conv1.bias == 0)
    dim = 1 if transpose else 0
    shape = [1, 1, 1, 1]
    shape[dim] = -1
    torch.testing.assert_close(folded.conv1.weight,
                               conv.weight * factor.view(shape))
    with torch.no_grad():
        torch.testing.assert_close(folded.eval()(x), m(x), rtol=1e-5,
                                   atol=1e-5)


def test_conv_relu_bn_is_refused():
    """Conv -> ReLU -> BN named ``conv1``/``bn1`` pairs by name, but folding
    through the ReLU changes the output: ``ValueError``, as JAX refuses
    LegacyUNet (``tests/test_fold_bn.py``)."""
    m = _ConvBN(relu_between=True).eval()
    assert fold_bn.fold_pairs(m, "UNet") == [("conv1", "bn1")]
    x = torch.rand(2, 3, 8, 8, generator=torch.Generator().manual_seed(1))
    with pytest.raises(ValueError, match="folding changed"):
        fold_bn.fold_batchnorm(m, "UNet", example=x)


def test_default_example_takes_the_model_size():
    """Without an example the check runs a 32² frame, or a TransUNet's own
    ``image_size`` (its positional embedding fixes the size)."""
    m = port_model("TransUNet")
    assert m.image_size == 64
    folded = fold_bn.fold_batchnorm(m)
    assert folded is not m


def test_nothing_to_fold_returns_the_model():
    m = nn.Sequential(nn.Conv2d(1, 2, 3))
    assert fold_bn.fold_pairs(m, "UNet") == []
    assert fold_bn.fold_batchnorm(m, "UNet") is m
