"""The port's TransUNet against the JAX package's, on the CPU in float32.

One small TransUNet (base_filters 8, depth 3, 64x64 input, embed 64, two
heads -> head dim 32, two layers) is initialised by JAX, its weights and
BatchNorm statistics perturbed from a numpy seed, and exported both as
``.npz`` (save_params_npz) and as ``.pth`` (save_pth). Both load into the
port; its eval logits and serving masks must match JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.models import create_model as jax_create_model
from ddti_tpu.models.blocks import (
    TransformerEncoderLayer as JaxTransformerEncoderLayer,
)
from ddti_tpu.train.checkpoint import save_params_npz
from ddti_tpu.train.export import serve_body as jax_serve_body
from ddti_tpu.train.torch_interop import export_state_dict, save_pth
from ddti_tpu_torch.models import blocks, create_model
from ddti_tpu_torch.ops import attention as tattn
from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
from ddti_tpu_torch.train.export import serve_body

SMALL = dict(in_channels=1, out_channels=1, base_filters=8, depth=3,
             image_size=64, embed_dim=64, num_heads=2,
             num_transformer_layers=2)
# f32 on one CPU: the two frameworks differ only in summation order and
# LayerNorm's variance formula
ATOL = RTOL = 1e-4
LOGIT_MARGIN = 1e-3


def _perturb(tree, rng, stats=False):
    def one(path, a):
        a = np.asarray(a)
        if stats and path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + rng.normal(0.0, 0.1, a.shape)).astype(np.float32)
    return jax.tree_util.tree_map_with_path(one, tree)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    jm = jax_create_model("TransUNet", **SMALL)
    v = jm.init({"params": jax.random.PRNGKey(0)},
                jnp.zeros((1, 64, 64, 1)), train=False)
    rng = np.random.default_rng(0)
    params = _perturb(v["params"], rng)
    stats = _perturb(v["batch_stats"], rng, stats=True)
    d = tmp_path_factory.mktemp("transunet")
    paths = {"npz": str(d / "w.npz"), "pth": str(d / "w.pth")}
    save_params_npz(paths["npz"], params, stats)
    save_pth(paths["pth"], "TransUNet", params, stats)
    frames = rng.integers(0, 256, (2, 64, 64, 1), dtype=np.uint8)
    return dict(params=params, stats=stats, paths=paths, frames=frames,
                x=frames.astype(np.float32) / 255.0)


def _port_model(ckpt, fmt, **kw):
    m = create_model("TransUNet", **SMALL, **kw)
    return load_checkpoint_into(ckpt["paths"][fmt], "TransUNet", m).eval()


def _jax_logits(ckpt, **kw):
    jm = jax_create_model("TransUNet", **SMALL, **kw)
    return np.asarray(jm.apply({"params": ckpt["params"],
                                "batch_stats": ckpt["stats"]},
                               jnp.asarray(ckpt["x"]), train=False))


def test_state_dict_keys_equal_jax_export(ckpt):
    want = set(export_state_dict("TransUNet", ckpt["params"], ckpt["stats"]))
    got = set(create_model("TransUNet", **SMALL).state_dict())
    assert got == want


@pytest.mark.parametrize("fmt", ["npz", "pth"])
@pytest.mark.parametrize("kw", [
    dict(use_flash_attention=True),
    dict(use_flash_attention=False),
    # the reference's quirk: attention over the batch axis
    dict(batch_axis_attention=True),
], ids=["flash", "plain", "batch_axis"])
def test_eval_logits_match_jax(ckpt, fmt, kw):
    want = _jax_logits(ckpt, **kw)
    m = _port_model(ckpt, fmt, **kw)
    with torch.inference_mode():
        got = m(torch.from_numpy(ckpt["x"]).permute(0, 3, 1, 2))
    got = got.permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (2, 64, 64, 1)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_serving_masks_match_jax(ckpt):
    jm = jax_create_model("TransUNet", **SMALL)
    want = np.asarray(jax_serve_body(
        jm, {"params": ckpt["params"], "batch_stats": ckpt["stats"]},
        jnp.asarray(ckpt["frames"])))
    m = _port_model(ckpt, "pth")
    with torch.inference_mode():
        got = serve_body(m, torch.from_numpy(ckpt["frames"])).numpy()
    assert got.dtype == np.uint8 and got.shape == want.shape
    logits = _jax_logits(ckpt)
    differ = got != want
    assert np.all(np.abs(logits[differ]) < LOGIT_MARGIN)
    assert 0 < want.mean() < 1  # the check is not vacuous


@pytest.mark.parametrize("s,hd,train,dropout", [
    (1024, 32, False, 0.1),   # the serving slice's bottleneck
    (1024, 16, False, 0.1),   # every hd % 8 == 0 takes flash, as in JAX
    (1024, 24, False, 0.1),
    (1024, 264, False, 0.1),  # wider than the kernel: flash all the same
    (1024, 12, False, 0.1),   # hd % 8 != 0 -> plain
    (1280, 32, False, 0.1),
    (1000, 32, False, 0.1),   # S % 256 != 0 -> plain
    (768, 32, False, 0.1),    # S < 1024 -> plain
    (1024, 32, True, 0.1),    # training with dropout -> plain
    (1024, 32, True, 0.0),
])
def test_flash_gate_matches_jax(monkeypatch, s, hd, train, dropout):
    """The auto gate picks flash exactly where the JAX layer does."""
    import ddti_tpu.ops.attention as jattn
    from ddti_tpu_torch.ops import attention as tattn

    took = {}

    def jax_spy(q, k, v):
        took["jax"] = True
        return jattn.attention_reference(q, k, v)

    def port_spy(q, k, v):
        took["port"] = True
        return tattn.attention_reference(q, k, v)

    monkeypatch.setattr(jattn, "flash_attention", jax_spy)
    monkeypatch.setattr(blocks, "flash_attention", port_spy)
    x = np.random.default_rng(0).standard_normal((1, s, hd), np.float32)
    jl = JaxTransformerEncoderLayer(embed_dim=hd, num_heads=1,
                                    dropout=dropout)
    rngs = {"params": jax.random.PRNGKey(0),
            "dropout": jax.random.PRNGKey(1)}
    jl.init_with_output(rngs, jnp.asarray(x), train=train)
    tl = blocks.TransformerEncoderLayer(hd, 1, dropout=dropout)
    tl.train(train)
    with torch.no_grad():
        tl(torch.from_numpy(x))
    assert took.get("port", False) == took.get("jax", False)


def test_attention_probability_dropout():
    """The plain path's training dropout acts on the probabilities: with
    v = I the output is the dropped probability matrix itself. Eval is the
    identity, p = 0 is bit-equal to the no-dropout path, and at p = 0.5
    about half the probabilities are kept (65536 of them: 2% is ~10 sigma),
    each scaled by exactly 2."""
    rng = np.random.default_rng(0)
    s = 64
    q, k = (torch.from_numpy(rng.standard_normal((4, 4, s, s), np.float32))
            for _ in range(2))
    v = torch.eye(s).expand(4, 4, s, s)
    a = tattn.attention_reference(q, k, v)  # softmax(q k^T / sqrt(d))
    assert torch.equal(blocks.attention_dropout(q, k, v, 0.0), a)
    torch.manual_seed(0)
    y = blocks.attention_dropout(q, k, v, 0.5)
    kept = y != 0
    assert abs(kept.float().mean().item() - 0.5) < 0.02
    assert torch.equal(y[kept], 2 * a[kept])

    layer = blocks.TransformerEncoderLayer(32, 4, dropout=0.5)
    x = torch.from_numpy(rng.standard_normal((2, 16, 32), np.float32))
    with torch.no_grad():
        layer.eval()
        sa = layer.self_attn
        qkv = torch.nn.functional.linear(x, sa.in_proj_weight,
                                         sa.in_proj_bias)
        qh, kh, vh = (t.reshape(2, 16, 4, 8).transpose(1, 2)
                      for t in qkv.chunk(3, dim=-1))
        plain = sa.out_proj(tattn.attention_reference(qh, kh, vh)
                            .transpose(1, 2).reshape(2, 16, 32))
        assert torch.equal(sa(x), plain)
        layer.train()
        assert not torch.equal(sa(x), plain)


def test_gated_layer_raises_on_head_dim_the_kernel_cannot_take():
    """A width the gate sends to flash but the kernel does not take
    raises on a non-CPU tensor (meta stands in for CUDA) rather than
    running the plain attention."""
    tl = blocks.TransformerEncoderLayer(264, 1).to("meta").eval()
    with pytest.raises(ValueError, match="head dim 264"):
        tl(torch.empty((1, 1024, 264), device="meta"))


def test_bf16_npz_loads_exactly(ckpt, tmp_path):
    """``::bf16`` raw-bit entries (save_params_npz of bf16 leaves) decode
    to the same values JAX holds."""
    to_bf16 = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: jnp.asarray(a, jnp.bfloat16), t)
    params, stats = to_bf16(ckpt["params"]), to_bf16(ckpt["stats"])
    path = str(tmp_path / "bf16.npz")
    save_params_npz(path, params, stats)
    m = load_checkpoint_into(path, "TransUNet",
                             create_model("TransUNet", **SMALL))
    want = export_state_dict(
        "TransUNet",
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params),
        jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), stats))
    for k, v in m.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_unported_model_and_orbax_dir_raise(tmp_path):
    """An unknown model name and an Orbax directory raise; MoresUNet, once
    unported, builds with the JAX package's parameter count."""
    with pytest.raises(NotImplementedError, match="Unknown model_type"):
        create_model("NoSuchNet")
    with torch.device("meta"):
        mores = create_model("MoresUNet")
    assert sum(p.numel() for p in mores.parameters()) == 31_042_369
    with pytest.raises(ValueError, match="Orbax"):
        load_checkpoint_into(str(tmp_path), "TransUNet",
                             create_model("TransUNet", **SMALL))
