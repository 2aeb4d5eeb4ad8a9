"""Int8 post-training quantization (``ddti_tpu_torch/train/quantize.py``)
and the int8 conv's plain version (``ddti_tpu_torch/ops/conv_s8.py``)
against the JAX package's ``train/quantize.py`` and XLA's s32 convs, on
the CPU.

Every model of ``create_model`` at a small size (base 4, depth 2-3, 32 x
32 frames; LegacyUNet and MoresUNet at their fixed widths): JAX
initialises it, its BatchNorm statistics are drawn from a numpy seed, the
port loads the same weights through ``export_state_dict``; both fold BN,
calibrate on the same seeded frames and quantize. Held: the set of
quantized paths (JAX's ``_quant_paths``), ``wq`` bit for bit from the same
float kernels, ``sw`` and ``sx`` to 1e-6 relative; the int8 graph's logits on JAX's tables within
1e-4 of max|logit| (measured: bit-equal), and on the port's own tables
>= 99.9% of mask pixels agreeing. An ``sx`` an ulp apart (the calibration
forward's float activations differ by ulps between the packages) moves
every x / sx of its conv, and the ones near a rounding tie land on the
other int8 level: measured 3 of 2048 ResUNet logits above 1e-4 (max
6.8e-3) and LegacyUNet's 2.9e-2 (its first conv's range); OWN_LOGIT_TOL
bounds that at 5e-2. Masks on the own tables agree on >= 99.9% of the
pixels whose logit lies beyond that shift, and on >= 99% of all (an
untrained MoresVNet2D's logits crowd 0: 11 of 2048 flip). JAX folds BatchNorm
under jit, where XLA's CPU rsqrt, not correctly rounded, takes the place
of 1 / sqrt (JAX's folded kernels are bit-equal to ``k * gamma *
lax.rsqrt(var + eps)``): the port's folded kernels sit an ulp away on
some elements, and where kernel / sw is that close to a tie its ``wq``
is one level off: measured 24 of 31,023,744 (LegacyUNet), bounded by
WQ_FLIP_FRACTION. The port's quantizer on JAX's folded kernels gives
JAX's ``wq`` bit for bit. The conv's
plain version is bit-equal to ``lax.conv_general_dilated`` /
``lax.conv_transpose`` with int32 accumulation at every zoo geometry, and
a numpy model of ``csrc/conv_s8.cu``'s packed implicit GEMM (its gather of
A, ``pack_weights``' B at both routes' channel padding, the transposed
conv's parity GEMMs) to both. The float-input form (x in bf16 or float32,
quantized inside the conv) is bit-equal to JAX's quantize and XLA's s32
conv on constructed half-way ties, and the exported int8 program
quantizes inside its ``ddti.conv_s8`` calls.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.train import quantize as jq
from ddti_tpu.train.torch_interop import export_state_dict
from ddti_tpu_torch.models import create_model
from ddti_tpu_torch.ops import conv_s8 as C
from ddti_tpu_torch.train import quantize as Q

SIZE = 32
SMALL = dict(in_channels=1, out_channels=1, base_filters=4, depth=2)
TRANS = dict(features=(4, 8), trans_dim=16, num_heads=2, num_layers=2,
             image_size=SIZE)
# id -> (model_type, kwargs): all 16 names of create_model, the active zoo
# at base 4 and the fixed architectures at their smallest widths
CASES = {
    "UNet": ("UNet", SMALL),
    "ResUNet": ("ResUNet", SMALL),
    "ASPPUNet": ("ASPPUNet", SMALL),
    "AttentionUNet": ("AttentionUNet", SMALL),
    "TransUNet": ("TransUNet", dict(SMALL, embed_dim=16, num_heads=2,
                                    num_transformer_layers=1,
                                    dropout_rate=0.0, image_size=SIZE)),
    "VNet2D": ("VNet2D", dict(SMALL, depth=3)),
    "ImprovedVNet": ("ImprovedVNet", dict(SMALL, depth=3,
                                          deep_supervision=True)),
    "LegacyUNet": ("LegacyUNet", {}),
    "TripleBranchImprovedVNet": ("TripleBranchImprovedVNet",
                                 dict(base_num_filters=4, dropout_rate=0.0)),
    "MoresUNet": ("MoresUNet", {}),
    "MoresVNet2D": ("MoresVNet2D", dict(features=(4, 8, 16))),
    "MoresAttentionUNet": ("MoresAttentionUNet", dict(features=(4, 8, 16))),
    "MoresResUNet": ("MoresResUNet", dict(features=(4, 8, 16))),
    "MoresASPPUNet": ("MoresASPPUNet", dict(features=(4, 8, 16))),
    "MoresTransUNet": ("MoresTransUNet", TRANS),
    "MoresImprovedVNet": ("MoresImprovedVNet",
                          dict(base_filters=4, dropout_rate=0.0)),
}
LOGIT_TOL = 1e-4   # of max |logit|, on JAX's tables
OWN_LOGIT_TOL = 5e-2  # on the port's own tables: sx an ulp apart
MASK_AGREE = 0.999
OWN_MASK_AGREE = 0.99  # every pixel, own tables: measured 0.9946
SCALE_RTOL = 1e-6
WQ_FLIP_FRACTION = 1e-5  # own folding: one-level flips, measured 7.7e-7


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: xdist runs six of these processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _draw_stats(stats, seed=0):
    rng = np.random.default_rng(seed)

    def draw(kp, a):
        if kp[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return rng.normal(0.0, 0.2, a.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, stats)


@functools.lru_cache(maxsize=None)
def pair(case: str):
    """(flax module, params, batch_stats, the port's model with them)."""
    mt, kw = CASES[case]
    jm = jcreate_model(mt, **kw)
    v = jax.jit(lambda k: jm.init({"params": k},
                                  jnp.zeros((1, SIZE, SIZE, 1)),
                                  train=False))(jax.random.PRNGKey(1))
    params, stats = v["params"], _draw_stats(v.get("batch_stats", {}))
    pm = create_model(mt, **kw)
    pm.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(a))
                        for k, a in export_state_dict(mt, params,
                                                      stats).items()},
                       strict=True)
    return jm, params, stats, pm.eval()


def frames(n=2, seed=0):
    return np.random.default_rng(seed).uniform(
        0.0, 1.0, (n, SIZE, SIZE, 1)).astype(np.float32)


def jax_tables(qtree) -> dict:
    return {"/".join(p): jax.tree.map(np.asarray, functools.reduce(
        lambda t, k: t[k], p, qtree)) for p in jq._quant_paths(qtree)}


def _main(out):
    return out[0] if isinstance(out, tuple) else out


def _rel(a, b):
    return np.abs(np.asarray(a, np.float64) - b) / np.abs(b).max()


def jax_folded(jm, params, stats):
    """JAX's folded params as its ``quantize_serving`` folds them (the
    unfolded ones where its fold refuses)."""
    from ddti_tpu.train.fold_bn import fold_batchnorm

    try:
        return fold_batchnorm(jm, params, stats)[0]
    except ValueError:
        return params


def check_tables(mine: dict, theirs: dict, folded=None) -> None:
    """Paths equal; sw and sx to SCALE_RTOL; wq one level off on at most
    WQ_FLIP_FRACTION of the elements and, from JAX's own float kernels
    (``folded``), bit for bit."""
    assert set(mine) == set(theirs)
    flips = total = 0
    for p, t in theirs.items():
        got = {k: v.numpy() for k, v in mine[p].items()}
        assert got["wq"].dtype == np.int8 and got["wq"].shape == \
            t["wq"].shape, p
        diff = np.abs(got["wq"].astype(np.int32) - t["wq"])
        assert diff.max() <= 1, p
        flips += int((diff > 0).sum())
        total += diff.size
        if folded is not None:
            kernel = functools.reduce(lambda n, k: n[k], p.split("/"),
                                      folded)["kernel"]
            wq, _ = Q.quantize_kernel(torch.from_numpy(np.array(kernel)))
            assert np.array_equal(wq.numpy(), t["wq"]), p
        assert _rel(got["sw"], t["sw"]).max() <= SCALE_RTOL, p
        assert _rel(got["sx"], t["sx"]).max() <= SCALE_RTOL, p
    assert flips <= WQ_FLIP_FRACTION * total, (flips, total)


@pytest.mark.parametrize("case", list(CASES))
def test_ptq_tables_and_int8_logits_match_jax(case):
    """The quantized paths are JAX's, the tables JAX's, and the int8
    graph's logits JAX's ``quantized_apply``'s: on JAX's tables to
    LOGIT_TOL, on the port's own in the masks."""
    mt = CASES[case][0]
    jm, params, stats, pm = pair(case)
    x = frames()
    jv = jq.quantize_serving(jm, params, stats, jnp.asarray(x))
    pv = Q.quantize_serving(pm, torch.from_numpy(x), model_type=mt)
    theirs = jax_tables(jv["quant"])
    assert theirs, "JAX quantized no conv"
    check_tables(Q.quant_tables(pv), theirs, jax_folded(jm, params, stats))
    want = np.asarray(_main(jq.quantized_apply(jm, jv, jnp.asarray(x),
                                               train=False)))
    on_jax = dict(pv)
    for p, t in theirs.items():
        for k in ("wq", "sw", "sx"):
            on_jax[f"quant/{p}/{k}"] = torch.from_numpy(np.array(t[k]))

    def logits(v):
        with torch.no_grad():
            out = Q.quantized_apply(pm, v, torch.from_numpy(x).permute(
                0, 3, 1, 2), model_type=mt)
        return _main(out).permute(0, 2, 3, 1).numpy()

    got = logits(on_jax)
    assert got.shape == want.shape
    assert _rel(got, want).max() <= LOGIT_TOL
    assert ((got > 0) == (want > 0)).mean() >= MASK_AGREE
    own = logits(pv)
    assert _rel(own, want).max() <= OWN_LOGIT_TOL
    # a pixel whose logit lies within the tolerated shift of 0 may flip
    decided = np.abs(want) > OWN_LOGIT_TOL * np.abs(want).max()
    assert ((own > 0) == (want > 0))[decided].mean() >= MASK_AGREE
    assert ((own > 0) == (want > 0)).mean() >= OWN_MASK_AGREE


@pytest.mark.parametrize("min_channels", [8, 16])
def test_min_channels_keeps_jax_paths(min_channels):
    jm, params, stats, pm = pair("ResUNet")
    x = frames()
    jv = jq.quantize_serving(jm, params, stats, jnp.asarray(x),
                             min_channels=min_channels)
    pv = Q.quantize_serving(pm, torch.from_numpy(x),
                            min_channels=min_channels)
    theirs = jax_tables(jv["quant"])
    assert 0 < len(theirs) < len(jax_tables(jq.quantize_serving(
        jm, params, stats, jnp.asarray(x))["quant"]))
    check_tables(Q.quant_tables(pv), theirs)


@pytest.mark.parametrize("case", ["ResUNet", "MoresVNet2D"])
def test_learned_ranges_build_jax_tables(case):
    """``amax=`` (QAT's ranges as Python floats): sx through float64 as
    ``build_quant_tree`` rounds it; a range of a conv the model lacks is
    dropped."""
    jm, params, stats, pm = pair(case)
    paths = list(jax_tables(jq.quantize_serving(
        jm, params, stats, jnp.asarray(frames()))["quant"]))
    rng = np.random.default_rng(3)
    amax = {p: float(rng.uniform(0.1, 4.0)) for p in paths}
    jv = jq.quantize_serving(jm, params, stats,
                             amax={tuple(p.split("/")): a
                                   for p, a in amax.items()})
    pv = Q.quantize_serving(pm, amax={**amax, "no/such/conv": 1.0},
                            model_type=CASES[case][0])
    mine, theirs = Q.quant_tables(pv), jax_tables(jv["quant"])
    check_tables(mine, theirs)
    for p in theirs:
        assert mine[p]["sx"].numpy() == theirs[p]["sx"], p


def test_unfoldable_model_quantizes_unfolded():
    """LegacyUNet's Conv -> ReLU -> BN does not fold: both packages
    quantize the unfolded graph (its tables were held above); its kernels
    are the raw weights."""
    jm, params, stats, pm = pair("LegacyUNet")
    pv = Q.quantize_serving(pm, torch.from_numpy(frames()))
    path = "encoder1/conv1"
    k = params["encoder1"]["conv1"]["kernel"]
    wq, _ = Q.quantize_kernel(torch.from_numpy(np.asarray(k)))
    assert torch.equal(Q.quant_tables(pv)[path]["wq"], wq)


def test_stripped_kernels_and_float_convs():
    """Quantized convs' float kernels become (1,) placeholders (the int8
    graph never reads them); a conv without a table keeps its kernel and
    runs the float path."""
    _, _, _, pm = pair("ResUNet")
    pv = Q.quantize_serving(pm, torch.from_numpy(frames()), min_channels=8)
    mods = Q.conv_modules(pm)
    tables = Q.quant_tables(pv)
    for path, (name, m) in mods.items():
        w = pv[f"{name}.weight"]
        if path in tables:
            assert w.shape == (1,)
        else:
            assert w.shape == m.weight.shape


# ---------------------------------------------------------------------------
# the int8 conv: plain version and the kernel's GEMM vs XLA
# ---------------------------------------------------------------------------


def _case(geo, hw, seed):
    name, k, s, d, pad, c, cout = geo
    rng = np.random.default_rng(seed)
    h, w = hw
    x = rng.integers(-127, 128, (2, h, w, c)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, k, c, cout)).astype(np.int8)
    return x, wq, C.conv_geometry(h, w, k, s, d, pad)


def _xla_s32(x, wq, geo):
    _, k, s, d, pad, _, _ = geo
    if pad == "T":
        y = lax.conv_transpose(jnp.asarray(x), jnp.asarray(wq), (2, 2),
                               "VALID", transpose_kernel=False,
                               preferred_element_type=jnp.int32)
    else:
        padding = pad if isinstance(pad, str) else [(pad, pad)] * 2
        y = lax.conv_general_dilated(
            jnp.asarray(x), jnp.asarray(wq), (s, s), padding,
            rhs_dilation=(d, d), dimension_numbers=("NHWC", "HWIO", "NHWC"),
            preferred_element_type=jnp.int32)
    return np.asarray(y)


def kernel_model(x, wq, geo, pads, c_align):
    """The s32 sums as csrc/conv_s8.cu's routes compute them: channels
    padded to ``c_align`` (route "mma": 4; route "wgmma": 64, its chunk,
    which never straddles two taps), ``pack_weights``' (taps, Cout, Kp) B,
    A gathered per (pixel, k) with k = tap * Cp + ci and zero outside the
    frame, one GEMM (four, one per output parity, for the transposed
    conv)."""
    _, k, s, d, pad, c, cout = geo
    pt, pl, oh, ow = pads
    n, h, w, _ = x.shape
    cp = -(-c // c_align) * c_align
    xp = np.zeros((n, h, w, cp), np.int64)
    xp[..., :c] = x
    packed, kp = C.pack_weights(torch.from_numpy(wq), cp, pad == "T")
    b = packed.numpy().astype(np.int64)
    out = np.zeros((n, oh, ow, cout), np.int64)
    if pad == "T":
        for p in range(4):
            ry, rx = p // 2, p % 2
            a = np.zeros((n, h, w, kp), np.int64)
            a[..., :cp] = xp
            out[:, ry::2, rx::2] = a @ b[p].T
        return out
    a = np.zeros((n, oh, ow, kp), np.int64)
    for kk in range(0, k * k * cp, 4):
        tap, ci = divmod(kk, cp)
        oy = np.arange(oh)[:, None] * s - pt + (tap // k) * d
        ox = np.arange(ow)[None, :] * s - pl + (tap % k) * d
        ok = (oy >= 0) & (oy < h) & (ox >= 0) & (ox < w)
        vals = xp[:, np.clip(oy, 0, h - 1), np.clip(ox, 0, w - 1),
                  ci:ci + 4]
        a[..., kk:kk + 4] = np.where(ok[None, ..., None], vals, 0)
    return a @ b[0].T


@pytest.mark.parametrize("hw", [(9, 10), (16, 16)])
@pytest.mark.parametrize("geo", C.ZOO_GEOMETRIES, ids=lambda g: g[0])
def test_conv_s8_plain_is_xla_s32_conv(geo, hw):
    """The plain version's int32 sums bit-equal XLA's s32 conv, its
    float32 and bf16 outputs JAX's epilogue, and the kernel's GEMM
    model both, at every zoo geometry, odd and even sides."""
    x, wq, pads = _case(geo, hw, seed=sum(map(ord, geo[0])))
    want = _xla_s32(x, wq, geo)
    s, d, pad = geo[2], geo[3], geo[4]
    acc = C.conv_s8_int32(torch.from_numpy(x), torch.from_numpy(wq), s, d,
                          *pads, pad == "T").numpy()
    assert acc.shape == want.shape and np.array_equal(acc, want)
    for c_align in (4, 64):
        assert np.array_equal(kernel_model(x, wq, geo, pads, c_align), want)
    rng = np.random.default_rng(1)
    cout = wq.shape[3]
    sx = np.float32(0.0137)
    sw = rng.uniform(1e-4, 2e-2, cout).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    ref = want.astype(np.float32) * (sx * sw) + bias
    args = (torch.from_numpy(x), torch.from_numpy(wq), torch.tensor(sx),
            torch.from_numpy(sw), torch.from_numpy(bias), s, d, *pads,
            pad == "T")
    assert np.array_equal(C.conv_s8(*args, False).numpy(), ref)
    got16 = C.conv_s8(*args, True)
    assert got16.dtype == torch.bfloat16
    ref16 = jnp.asarray(ref).astype(jnp.bfloat16).astype(jnp.float32)
    assert np.array_equal(got16.float().numpy(), np.asarray(ref16))


@pytest.mark.parametrize("form", ["bf16", "float32"])
@pytest.mark.parametrize("geo", C.ZOO_GEOMETRIES, ids=lambda g: g[0])
def test_conv_s8_float_input_is_jax_quantize_then_s32_conv(geo, form):
    """The float-input form (x in bf16 or float32, quantized by sx inside
    conv_s8) bit-equal to JAX's ``_quant_interceptor`` arithmetic:
    ``jnp.clip(jnp.rint(x / sx), -127, 127)`` in int8, XLA's s32 conv, the
    epilogue, float32 and bf16 out; at sx = 1/4 with x / sx planted on
    exact half-way ties (rint rounds them to even) and at sx = 0.0137,
    where the correctly rounded division decides; a tenth of x beyond
    +-127 sx."""
    name, k, s, d, pad, c, cout = geo
    rng = np.random.default_rng(sum(map(ord, name)) + len(form))
    x8, wq, pads = _case(geo, (9, 10), seed=len(name))
    cout = wq.shape[3]
    sw = rng.uniform(1e-4, 2e-2, cout).astype(np.float32)
    bias = rng.normal(size=cout).astype(np.float32)
    dt = torch.bfloat16 if form == "bf16" else torch.float32
    jdt = jnp.bfloat16 if form == "bf16" else jnp.float32
    for sx in (np.float32(0.25), np.float32(0.0137)):
        xf = rng.normal(0.0, 75.0, x8.shape) * sx
        tie = rng.random(x8.shape) < 0.2
        xf[tie] = (rng.integers(-128, 128, tie.sum()) + 0.5) * sx
        x = torch.from_numpy(xf.astype(np.float32)).to(dt)
        xn = x.float().numpy()
        if sx == 0.25:  # the ties survive the cast to x's type
            assert np.all(np.abs(xn[tie] / sx) % 1 == 0.5)
        xq = np.asarray(jnp.clip(jnp.rint(
            jnp.asarray(xn).astype(jdt).astype(jnp.float32) / sx),
            -127, 127).astype(jnp.int8))
        assert np.array_equal(C.quantize_activation(
            x, torch.tensor(sx)).numpy(), xq)
        acc = jnp.asarray(_xla_s32(xq, wq, geo)).astype(jnp.float32)
        ref = acc * (jnp.float32(sx) * jnp.asarray(sw)) + jnp.asarray(bias)
        args = (x, torch.from_numpy(wq), torch.tensor(sx),
                torch.from_numpy(sw), torch.from_numpy(bias), s, d, *pads,
                pad == "T")
        assert np.array_equal(C.conv_s8(*args, False).numpy(),
                              np.asarray(ref))
        got16 = C.conv_s8(*args, True).float().numpy()
        assert np.array_equal(got16, np.asarray(
            ref.astype(jnp.bfloat16).astype(jnp.float32)))


def test_int8_program_quantizes_inside_conv_s8():
    """A small UNet's exported int8 program: one ``ddti.conv_s8`` node per
    table, each fed the float activation (bf16 under bf16 compute), and no
    rounding, clamping or int8 cast anywhere in the graph."""
    m = create_model("UNet", **SMALL)
    torch.manual_seed(0)
    calib = torch.rand((2, SIZE, SIZE, 1))
    program, v = Q.export_serving_int8(m, 2, SIZE, calib_images=calib,
                                       input_dtype=torch.uint8, bf16=True,
                                       model_type="UNet")
    nodes = [n for _, g in program.graph_module.named_modules()
             for n in g.graph.nodes if n.op == "call_function"]
    convs = [n for n in nodes if str(n.target) == "ddti.conv_s8.default"]
    assert len(convs) == len(Q.quant_tables(v)) > 0
    assert all(n.args[0].meta["val"].dtype in (torch.bfloat16,
                                               torch.float32)
               for n in convs)
    targets = {str(n.target) for n in nodes}
    assert not targets & {"aten.round.default", "aten.clamp.default",
                          "aten.clip.default"}
    assert not [n for n in nodes if n.kwargs.get("dtype") == torch.int8]


def test_conv_s8_refuses_what_it_does_not_take():
    x = torch.zeros((1, 4, 4, 8), dtype=torch.int8)
    w = torch.zeros((3, 3, 8, 4), dtype=torch.int8)
    one, sw = torch.ones(()), torch.ones(4)
    with pytest.raises(ValueError, match="int8"):
        C.conv_s8(x.double(), w, one, sw, None, 1, 1, 1, 1, 4, 4, False,
                  False)
    with pytest.raises(ValueError, match="k = 2, s = 2"):
        C.conv_s8(x, w, one, sw, None, 1, 1, 0, 0, 8, 8, True, False)
    with pytest.raises(ValueError, match="disagree"):
        C.conv_s8(x[..., :4], w, one, sw, None, 1, 1, 1, 1, 4, 4, False,
                  False)


@pytest.mark.parametrize("transpose", [False, True], ids=["conv", "convT"])
def test_conv_s8_weights_are_packed_once_per_table(transpose):
    """The kernel's packed B is made once per weight table and kept on it,
    equal to ``pack_weights``; writing the table in place repacks it, and
    an inference tensor (no version count) is packed every call."""
    k = 2 if transpose else 3
    rng = np.random.default_rng(3)
    wq = torch.from_numpy(rng.integers(-127, 128, (k, k, 6, 5),
                                       dtype=np.int8))
    first, kp = C.packed_weights(wq, 8, transpose)
    want, want_kp = C.pack_weights(wq, 8, transpose)
    assert kp == want_kp and torch.equal(first, want)
    assert C.packed_weights(wq, 8, transpose)[0] is first
    wq[0, 0, 0, 0] = -wq[0, 0, 0, 0] - 1
    again, _ = C.packed_weights(wq, 8, transpose)
    assert again is not first
    assert torch.equal(again, C.pack_weights(wq, 8, transpose)[0])
    with torch.inference_mode():
        wi = wq.clone()
    a, _ = C.packed_weights(wi, 8, transpose)
    assert C.packed_weights(wi, 8, transpose)[0] is not a
    assert torch.equal(a, again)
