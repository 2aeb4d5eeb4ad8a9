"""A TransUNet with one attention head a layer, the configuration whose
head width is the whole embedding (configs/config.yaml:337-343 with
``num_heads: 1`` gives D = 256), against the JAX package's on identical
weights, on the CPU: seeded weights in flax's layout go through
``export_state_dict`` into the port with ``load_state_dict(strict=True)``,
and eval logits and the gradients of a loss through the flash path agree.
Widths past one kernel tile (D = 136) and one that is not a multiple of 8
(D = 12, padded by the CUDA wrappers, JAX's ``_fallback``) are both taken.
The port's own initialiser builds the same key set at those widths.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.train.torch_interop import export_state_dict
from ddti_tpu_torch.models import create_model
from ddti_tpu_torch.ops import attention as tattn
from ddti_tpu_torch.utils import weight_init

SIZE = 32


def _kw(embed):
    return dict(in_channels=1, out_channels=1, base_filters=4, depth=2,
                image_size=SIZE, embed_dim=embed, num_heads=1,
                num_transformer_layers=1, dropout_rate=0.0,
                use_flash_attention=True)


def _shapes(jm):
    """The flax variables' shapes (no initialisation run: flax's init of
    this model takes seconds)."""
    return jax.eval_shape(lambda k: jm.init({"params": k}, jnp.zeros(
        (1, SIZE, SIZE, 1)), train=False), jax.random.PRNGKey(0))


def _draw(rng, shapes):
    """Seeded weights for both packages: kernels normal at fan_in^-1/2,
    vectors near zero (scales near one), BatchNorm variances in [0.5,
    1.5]."""
    def one(path, a):
        name = path[-1].key
        if name == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        if len(a.shape) == 1:
            base = 1.0 if name == "scale" else 0.0
            return (base + rng.normal(0, 0.1, a.shape)).astype(np.float32)
        fan_in = int(np.prod(a.shape[:-1])) or 1
        return rng.normal(0, fan_in ** -0.5, a.shape).astype(np.float32)
    v = jax.tree_util.tree_map_with_path(one, shapes)
    return v["params"], v["batch_stats"]


@pytest.mark.parametrize("embed", [136, 12])
def test_one_head_transunet_matches_jax(embed):
    """Eval logits to 1e-4 (float32 summation order), and the gradients
    of sum(logits * w) through the flash path (the port's autograd
    Function with the kernels' plain versions; JAX's custom VJP) to 1e-4
    normwise over all parameters."""
    kw = _kw(embed)
    jm = jcreate_model("TransUNet", **kw)
    rng = np.random.default_rng(embed)
    params, stats = _draw(rng, _shapes(jm))
    x = rng.random((2, SIZE, SIZE, 1)).astype(np.float32)
    w = rng.standard_normal((2, SIZE, SIZE, 1)).astype(np.float32)

    def loss(p):
        out = jm.apply({"params": p, "batch_stats": stats}, jnp.asarray(x),
                       train=False)
        return jnp.sum(out * w), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        params)

    m = create_model("TransUNet", **kw).eval()
    m.load_state_dict({k: torch.from_numpy(np.array(a, np.float32))
                       for k, a in export_state_dict(
                           "TransUNet", params, stats).items()}, strict=True)
    before = tattn.flash_forward_cuda.launches
    got = m(torch.from_numpy(x).permute(0, 3, 1, 2))
    (got * torch.from_numpy(w).permute(0, 3, 1, 2)).sum().backward()
    assert tattn.flash_forward_cuda.launches == before  # the plain versions
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), atol=1e-4, rtol=1e-4)
    jg = export_state_dict("TransUNet", jgrads, {})
    tg = {k: p.grad.numpy() for k, p in m.named_parameters()}
    assert sorted(tg) == sorted(jg)
    tall = np.concatenate([g.ravel() for g in tg.values()])
    jall = np.concatenate([np.asarray(jg[k]).ravel() for k in tg])
    assert np.linalg.norm(jall - tall) / np.linalg.norm(tall) < 1e-4
    attn = tg["trans.layers.0.self_attn.in_proj_weight"]
    assert attn.shape == (3 * embed, embed) and np.abs(attn).max() > 0


@pytest.mark.parametrize("embed", [136, 256])
def test_init_like_flax_one_head(embed):
    """The port's seeded initialiser at one head of the whole embedding:
    JAX's key set and shapes, the packed projection lecun-normal at
    std sqrt(1 / E)."""
    kw = _kw(embed)
    v = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype),
                     _shapes(jcreate_model("TransUNet", **kw)))
    want = {k: tuple(np.shape(a)) for k, a in export_state_dict(
        "TransUNet", v["params"], v["batch_stats"]).items()}
    m = create_model("TransUNet", **kw)
    weight_init.init_like_flax(m, 42)
    got = {k: tuple(t.shape) for k, t in m.state_dict().items()}
    assert got == want
    w = m.trans.layers[0].self_attn.in_proj_weight.detach()
    assert float(w.std()) == pytest.approx((1 / embed) ** 0.5, rel=0.1)
