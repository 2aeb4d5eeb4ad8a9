"""The ports of the conv3x3 and warp-gather probes (ddti_tpu_torch/probes:
pallas_conv_probe, gather_probe, gather_probe2, gather_probe3) against the
JAX probes of ``benchmarks/`` on the CPU.

The conv probe is loaded from ``benchmarks/`` by file path (the port never
imports it) and its Pallas kernel runs in interpret mode. The gather
probes' builders are closures inside their ``main()``, so this file carries
a verbatim copy of each Pallas kernel body, citing its file and line, and
runs it through ``pl.pallas_call(..., interpret=True)`` with the probes'
own block specs at toy sizes. Inputs come from numpy with a fixed seed and
go to both sides. The CUDA kernels are held against the same plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke as C
from ddti_tpu_torch.probes import gather_probe as G
from ddti_tpu_torch.probes import gather_probe2 as G2
from ddti_tpu_torch.probes import gather_probe3 as G3
from ddti_tpu_torch.probes import pallas_conv_probe as P

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_probe(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_probe_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_conv_probe():
    return _load_probe("pallas_conv_probe")


# ---------------------------------------------------------------------------
# conv3x3 + bias + ReLU

def _conv_inputs(n, s, c, co, seed):
    """x, wk rounded to bf16 (as float32 numpy, exact in both frameworks)
    and b float32, the probe's distributions."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, s, s, c), np.float32)
    wk = rng.standard_normal((3, 3, c, co), np.float32) * np.float32(0.05)
    b = rng.standard_normal(co, np.float32)
    bf = lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16), np.float32)
    return bf(x), bf(wk), b


def _bf16_ulp(a):
    a = np.maximum(np.abs(a), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(a)) - 7)


def _assert_within_one_ulp(got, want):
    """Every element within one bf16 ulp of the larger of the two values,
    or within 2^-8 max|want| absolute (the ReLU edge, where one side rounds
    to a small positive value and the other to zero)."""
    d = np.abs(got - want)
    ok = (d <= _bf16_ulp(np.maximum(np.abs(got), np.abs(want)))) \
        | (d <= 2.0 ** -8 * np.abs(want).max())
    assert ok.all(), (d.max(), (~ok).sum())


@pytest.mark.parametrize("n, s, c, co, ht", [(2, 16, 128, 128, 8),
                                             (1, 12, 16, 24, 4)])
def test_conv3x3_reference_matches_pallas_interpret(n, s, c, co, ht,
                                                    jax_conv_probe):
    """The plain version against the JAX probe's Pallas kernel in interpret
    mode, at the probe's CPU shape (HT 8) and a narrow one (HT 4)."""
    x, wk, b = _conv_inputs(n, s, c, co, seed=s + c)
    want = jax_conv_probe.conv3x3_relu_pallas(
        jnp.asarray(x, jnp.bfloat16), jnp.asarray(wk, jnp.bfloat16),
        jnp.asarray(b), ht=ht, interpret=True)
    want = np.asarray(want, np.float32)
    got = P.conv3x3_relu_reference(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(wk).bfloat16(),
        torch.from_numpy(b)).float().numpy()
    assert got.shape == (n, s, s, co)
    _assert_within_one_ulp(got, want)


def test_conv3x3_reference_matches_xla_where_pallas_leaves_rows(
        jax_conv_probe):
    """At H = 10, HT = 4 the Pallas grid (n, H // HT) writes rows 0-7 only,
    so rows 8-9 of its output are whatever the buffer held: the plain
    version, which computes every row, is held to the probe's XLA
    convolution instead (conv3x3_relu_xla), and to the Pallas kernel on the
    rows it writes."""
    x, wk, b = _conv_inputs(2, 10, 32, 16, seed=3)
    xj, wj = jnp.asarray(x, jnp.bfloat16), jnp.asarray(wk, jnp.bfloat16)
    got = P.conv3x3_relu_reference(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(wk).bfloat16(),
        torch.from_numpy(b)).float().numpy()
    want = np.asarray(jax_conv_probe.conv3x3_relu_xla(xj, wj, jnp.asarray(b)),
                      np.float32)
    _assert_within_one_ulp(got, want)
    pallas = np.asarray(jax_conv_probe.conv3x3_relu_pallas(
        xj, wj, jnp.asarray(b), ht=4, interpret=True), np.float32)
    _assert_within_one_ulp(got[:, :8], pallas[:, :8])


def test_conv3x3_pack_weights_layout():
    """The kernel's weight layout: wt[o, (3 dy + dx) C + c] = wk[dy, dx, c,
    o], bf16, contiguous."""
    wk = torch.arange(3 * 3 * 4 * 2, dtype=torch.float32).reshape(3, 3, 4, 2)
    wt = P.pack_weights(wk)
    assert wt.shape == (2, 36) and wt.dtype == torch.bfloat16
    assert wt.is_contiguous()
    for dy, dx, c, o in [(0, 0, 0, 0), (1, 2, 3, 1), (2, 1, 2, 0)]:
        assert wt[o, (3 * dy + dx) * 4 + c] == wk[dy, dx, c, o]


def test_conv3x3_dispatch_and_tolerance_on_cpu():
    """On CPU tensors the dispatcher is the plain version; the wrapper
    refuses CPU tensors before any build; ``within_tolerance`` accepts the
    ReLU edge and one ulp, and refuses two ulps."""
    x, wk, b = (torch.from_numpy(a) for a in _conv_inputs(1, 8, 32, 8, 5))
    x, wk = x.bfloat16(), wk.bfloat16()
    y = P.conv3x3_relu(x, wk, b)
    assert torch.equal(y, P.conv3x3_relu_reference(x, wk, b))
    before = P.conv3x3_relu_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        P.conv3x3_relu_cuda(x, P.pack_weights(wk), b)
    assert P.conv3x3_relu_cuda.launches == before
    # max|want| 2: the ReLU edge's allowance is 2^-7
    want = torch.tensor([1.0, 2.0, 0.0, 1.5]).bfloat16()
    one_ulp = torch.tensor([1.0078125, 2.015625, 0.0078125, 1.5078125])
    assert P.within_tolerance(one_ulp.bfloat16(), want)[0]
    two_ulp = torch.tensor([1.0, 2.03125, 0.0, 1.5]).bfloat16()
    assert not P.within_tolerance(two_ulp, want)[0]
    edge = torch.tensor([1.0, 2.0, 0.015625, 1.5]).bfloat16()
    assert not P.within_tolerance(edge, want)[0]


def test_conv_probe_main_on_cpu(capsys):
    """The probe's lines at its CPU shape through the plain version: HT
    accepted and ignored, plain vs the CPU's F.conv2d, no time."""
    assert P.main(["16", "32", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("HT 4 accepted and ignored")
    assert float(out[1].split("= ")[1]) < 0.25  # the probe's interpret bar
    assert "within tolerance True" in out[2]
    assert "not measured" in out[-1]


# ---------------------------------------------------------------------------
# the warp gathers

TOY_N, TOY_H, TOY_W = 2, 16, 16


def _vmem(block, index_map):
    return pl.BlockSpec(block, index_map, memory_space=pltpu.VMEM)


def _per_image_call(kern, src, idx):
    """The probes' per-image pallas_call (gather_probe.py:61-72): grid (N,),
    one image and the shared index a program, VMEM specs, interpreted."""
    n, h, w = src.shape
    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct((n, h, w), src.dtype),
        grid=(n,),
        in_specs=[_vmem((1, h, w), lambda i: (i, 0, 0)),
                  _vmem((h, w), lambda i: (0, 0))],
        out_specs=_vmem((1, h, w), lambda i: (i, 0, 0)),
        interpret=True)(src, idx))


def _one_block_call(kern, src, idx):
    """The probes' one-block pallas_call (gather_probe2.py:110-115,
    gather_probe3.py:104-109), interpreted."""
    return np.asarray(pl.pallas_call(
        kern, out_shape=jax.ShapeDtypeStruct(src.shape, src.dtype),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(src, idx))


# verbatim kernel bodies: benchmarks/gather_probe.py:56-59 (A), :78-79 (B),
# :100-101 (C), at the toy image size
def _kern_a(src_ref, idx_ref, out_ref):
    flat = src_ref[0].reshape(-1)
    out_ref[0] = jnp.take(flat, idx_ref[:].reshape(-1),
                          axis=0).reshape(TOY_H, TOY_W)


def _kern_b(src_ref, yi_ref, out_ref):
    out_ref[0] = jnp.take_along_axis(src_ref[0], yi_ref[:], axis=0)


def _kern_c(src_ref, xi_ref, out_ref):
    out_ref[0] = jnp.take_along_axis(src_ref[0], xi_ref[:], axis=1)


# benchmarks/gather_probe2.py:76-78 (B2)
def _kern_b2(src_ref, yi_ref, out_ref):
    out_ref[0] = jnp.take_along_axis(src_ref[0], yi_ref[:], axis=0,
                                     mode="promise_in_bounds")


# benchmarks/gather_probe2.py:105-107 (F), gather_probe3.py:100-102 (P4),
# :119-121 (P5)
def _kern_f(src_ref, idx_ref, out_ref):
    out_ref[:] = jnp.take_along_axis(src_ref[:], idx_ref[:], axis=0,
                                     mode="promise_in_bounds")


# benchmarks/gather_probe3.py:138-140 (P6)
def _kern_p6(s_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(s_ref[:], i_ref[:], axis=1,
                                   mode="promise_in_bounds")


def _plain(src, idx, mode):
    return G.gather_reference(torch.from_numpy(src), torch.from_numpy(idx),
                              mode).numpy()


def _assert_same(got, want):
    """NaN at the same places, every other value bit for bit."""
    assert got.shape == want.shape
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert np.array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def _toy_fields():
    src = G.make_src((TOY_N, TOY_H, TOY_W), seed=1)
    yi, xi = G.rotation_fields(G.THETA, TOY_H, TOY_W)
    return src, yi, xi


def _plant_edges(idx, length):
    """idx with its first elements set to -1 and -length (which wrap) and
    length and -length - 1 (out of range)."""
    idx = idx.copy()
    idx.reshape(-1)[:4] = [-1, -length, length, -length - 1]
    return idx


@pytest.mark.parametrize("body, mode", [(_kern_a, "flat"), (_kern_b, 0),
                                        (_kern_c, 1)])
@pytest.mark.parametrize("edges", [False, True])
def test_gather_reference_matches_pallas_interpret(body, mode, edges):
    """Builders A, B and C (JAX's default gather mode): the plain version
    against the probe's kernel body in interpret mode and against the
    probe's numpy want; with edges, negative indices wrap and the rest out
    of range give NaN on both sides."""
    src, yi, xi = _toy_fields()
    idx = {"flat": yi * TOY_W + xi, 0: yi, 1: xi}[mode]
    if edges:
        idx = _plant_edges(idx, TOY_H * TOY_W if mode == "flat" else TOY_H)
    got = _plain(src, idx, mode)
    want = _per_image_call(body, jnp.asarray(src), jnp.asarray(idx))
    _assert_same(got, want)
    assert edges == bool(np.isnan(got).any())
    if not edges:
        numpy_want = {"flat": src[:, yi, xi],
                      0: np.take_along_axis(src, yi[None], 1),
                      1: np.take_along_axis(src, xi[None], 2)}[mode]
        assert np.array_equal(got, numpy_want)


@pytest.mark.parametrize("name", ["B2", "F", "P4", "P5", "P6"])
def test_promise_in_bounds_builders_match_pallas_interpret(name):
    """B2, F and P4-P6 (promise_in_bounds: in-range indices only) against
    their kernel bodies in interpret mode, at toy sizes for B2 and F and at
    the probes' own sizes for P4-P6."""
    rng = np.random.default_rng(7)
    if name == "B2":
        src, yi, _ = _toy_fields()
        got = _plain(src, yi, 0)
        want = _per_image_call(_kern_b2, jnp.asarray(src), jnp.asarray(yi))
    else:
        shape, axis, body = {"F": ((64, 8), 0, _kern_f),
                             "P4": ((8, 128), 0, _kern_f),
                             "P5": ((512, 128), 0, _kern_f),
                             "P6": ((256, 256), 1, _kern_p6)}[name]
        src = G.make_src(shape, seed=2)
        idx = rng.integers(0, shape[axis], shape).astype(np.int32)
        got = _plain(src, idx, axis)
        want = _one_block_call(body, jnp.asarray(src), jnp.asarray(idx))
        assert np.array_equal(got, np.take_along_axis(src, idx, axis=axis))
    _assert_same(got, want)


@pytest.mark.parametrize("mode", ["flat", 0, 1])
def test_gather_reference_fill_and_wrap_match_jnp(mode):
    """Every index from -len - 3 to len + 2, per image and shared, against
    jnp.take / jnp.take_along_axis in their default mode: exactly."""
    src = G.make_src((3, 5, 7), seed=4)
    r, c = 5, 7
    length = r * c if mode == "flat" else (r, c)[mode]
    rng = np.random.default_rng(5)
    for shared in (True, False):
        shape = (5, 7) if shared else (3, 5, 7)
        idx = rng.integers(-length - 3, length + 3, shape).astype(np.int32)
        got = _plain(src, idx, mode)
        s = jnp.asarray(src)
        i = jnp.asarray(idx if not shared else np.broadcast_to(
            idx, (3, 5, 7)))
        if mode == "flat":
            want = jax.vmap(lambda im, ix: jnp.take(im.reshape(-1),
                                                    ix.reshape(-1))
                            .reshape(ix.shape))(s, i)
        else:
            want = jnp.take_along_axis(s, i, axis=1 + mode)
        _assert_same(got, np.asarray(want))


def test_gather_reference_shapes_and_refusals():
    """A 2-D src takes a 2-D idx (the one-block builders); an index plane
    of another size than the image gives the index's shape; the wrapper
    refuses CPU tensors before any build, and every version refuses an idx
    that does not fit its axis."""
    src = torch.rand(4, 6)
    idx = torch.randint(0, 4, (9, 6), dtype=torch.int32)
    assert G.gather(src, idx, 0).shape == (9, 6)
    assert G.gather(src[None].expand(2, -1, -1), idx, 0).shape == (2, 9, 6)
    before = G.gather_cuda.launches
    with pytest.raises(ValueError, match="CUDA device"):
        G.gather_cuda(src, idx, 0)
    assert G.gather_cuda.launches == before
    with pytest.raises(ValueError, match="axis 1"):
        G.gather_reference(src, idx, 1)
    with pytest.raises(ValueError, match="mode"):
        G.gather_reference(src, idx, 2)


def test_index_fields_equal_the_probes():
    """The port's numpy index fields equal the probes' bit for bit: the
    lines of benchmarks/gather_probe.py:42-48 (theta a Python float, so
    float64 arithmetic), gather_probe2.py:39-49 and gather_probe3.py:45-55
    (float32 thetas from default_rng(0)), copied here verbatim; F's and
    P4-P6's random indices from the same generator afterwards."""
    H = W = 256
    N = 128
    # benchmarks/gather_probe.py:42-48
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    th = 0.3
    ys = (-np.sin(th) * (xx - W / 2) + np.cos(th) * (yy - H / 2) + H / 2)
    xs = (np.cos(th) * (xx - W / 2) + np.sin(th) * (yy - H / 2) + W / 2)
    yi = np.clip(np.floor(ys).astype(np.int32), 0, H - 1)
    xi = np.clip(np.floor(xs).astype(np.int32), 0, W - 1)
    src = G.builders(1)
    assert np.array_equal(src["A pallas flat take   "][1], yi * W + xi)
    assert np.array_equal(src["B pallas taa axis0   "][1], yi)
    assert np.array_equal(src["C pallas taa axis1   "][1], xi)
    assert src["A pallas flat take   "][1].dtype == np.int32
    # benchmarks/gather_probe2.py:39-49, and build_f's index (:102-103)
    rng = np.random.default_rng(0)
    ths = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    yis, xis = [], []
    for th in ths:
        ys = (-np.sin(th) * (xx - W / 2) + np.cos(th) * (yy - H / 2) + H / 2)
        xs = (np.cos(th) * (xx - W / 2) + np.sin(th) * (yy - H / 2) + W / 2)
        yis.append(np.clip(np.floor(ys), 0, H - 1).astype(np.int32))
        xis.append(np.clip(np.floor(xs), 0, W - 1).astype(np.int32))
    yi = np.stack(yis)
    xi = np.stack(xis)
    hw_t = 2048
    idx_f = rng.integers(0, hw_t, (hw_t, N)).astype(np.int32)
    kernel, calls = G2.builders()
    assert np.array_equal(kernel["B2 pallas taa ax0 promise  "][1], yi[0])
    assert np.array_equal(kernel["F  pallas dyn_gather lanes "][1], idx_f)
    assert np.array_equal(calls["E  xla take idx-input      "][1][1],
                          yi * W + xi)
    # benchmarks/gather_probe3.py:45-55, then P4, P5, P6's indices
    # (:97-98, :116-117, :135-136) in that order
    rng = np.random.default_rng(0)
    ths = rng.uniform(-np.pi, np.pi, N).astype(np.float32)
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    lins = []
    for th in ths:
        ys = (-np.sin(th) * (xx - W / 2) + np.cos(th) * (yy - H / 2) + H / 2)
        xs = (np.cos(th) * (xx - W / 2) + np.sin(th) * (yy - H / 2) + W / 2)
        yi = np.clip(np.floor(ys), 0, H - 1).astype(np.int32)
        xi = np.clip(np.floor(xs), 0, W - 1).astype(np.int32)
        lins.append(yi * W + xi)
    lin = np.stack(lins)
    idx4 = rng.integers(0, 8, (8, 128)).astype(np.int32)
    idx5 = rng.integers(0, 512, (512, 128)).astype(np.int32)
    idx6 = rng.integers(0, 256, (256, 256)).astype(np.int32)
    calls3, kernel3 = G3.builders()
    assert np.array_equal(calls3["P2 u8 xla           "][1][1],
                          lin.reshape(N, -1))
    for name, idx in zip(kernel3, (idx4, idx5, idx6)):
        assert np.array_equal(kernel3[name][1], idx), name


@pytest.mark.parametrize("module, names", [
    (G, ["A pallas flat take", "B pallas taa axis0", "C pallas taa axis1",
         "D xla flat take"]),
    (G2, ["E  xla take idx-input", "E2 xla taa batched",
          "B2 pallas taa ax0 promise", "F  pallas dyn_gather lanes",
          "G  xla taa (HW,N) lanes"]),
    (G3, ["P1 u16 packed xla", "P2 u8 xla", "P3 f32 xla",
          "P4 pallas dyn_gather 8x128", "P5 pallas dyn_gather 512",
          "P6 pallas dyn_gather ax1"]),
])
def test_gather_probe_main_on_cpu(module, names, capsys):
    """Each probe's lines at a toy size through the plain versions and the
    torch calls: the probe's builders in its order, every one matching its
    numpy want, no time."""
    assert module.main(["--device", "cpu", "--batch", "2", "--size",
                        "32"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [l.split(":")[0].strip() for l in out] == names
    assert all(": OK match=True not measured" in l for l in out)


def _sequential_sum(terms, step, truncate):
    """A float32 sum of (K, CO) terms in one accumulator, ``step`` terms at
    a time (each step's own sum exact), rounded to nearest or toward zero
    (as the tensor cores' float32 accumulation rounds)."""
    acc = np.zeros(terms.shape[1], np.float32)
    for k0 in range(0, len(terms), step):
        v = acc.astype(np.float64) + terms[k0:k0 + step].sum(0)
        f = v.astype(np.float32)
        if truncate:
            too_far = np.abs(f.astype(np.float64)) > np.abs(v)
            f = np.where(too_far, np.nextafter(f, np.float32(0)), f)
        acc = f
    return acc


@pytest.mark.parametrize("c", [64, 512])
def test_conv3x3_cancelling_inputs_expose_a_truncating_sum(c):
    """The card's growth check (``cancelling_inputs``): b cancels a sum of
    9 C positive products, so an interior output is ~1 and shows the
    float32 sum's error. Within ``CANCEL_LIMIT`` at every C: the plain
    version, and a model of the kernel's sum (exact chunks of 32 added in
    order, rounded to nearest: 7.5e-3 at C = 512, which the card
    reproduced to the bit). A model of one accumulator that truncates at
    every k16 step drifts past the limit at C = 512 and not yet at C = 64:
    the check sees growth."""
    x, wk, b, exact = P.cancelling_inputs(1, 6, c, seed=c, device="cpu")
    y = P.conv3x3_relu_reference(x, wk, b).float()
    assert (y[:, 1:-1, 1:-1] - exact.float()).abs().max() <= P.CANCEL_LIMIT
    assert (y[:, 0] == 0).all() and (y[:, :, 0] == 0).all()
    terms = (x[0, 0, 0].double().repeat(9)[:, None]
             * wk.double().reshape(9 * c, c)).numpy()

    def drift(step, truncate):
        acc = _sequential_sum(terms, step, truncate)
        return np.abs(acc + b.numpy() - exact.numpy()).max()

    assert drift(32, False) <= P.CANCEL_LIMIT / 4
    assert (drift(16, True) > P.CANCEL_LIMIT) == (c == 512)


def _chunked_sum(terms, chunk, k16=16):
    """The redesigned kernel's float32 sum of (K, CO) terms: fresh chunks
    of ``chunk`` terms, each summed on the tensor cores k16 terms a step
    (a step's own sum exact, added to the chunk's sum rounding toward
    zero), and each chunk added to the running sum rounded to nearest."""
    acc = np.zeros(terms.shape[1], np.float32)
    for k0 in range(0, len(terms), chunk):
        fresh = _sequential_sum(terms[k0:k0 + chunk], k16, truncate=True)
        acc = (acc.astype(np.float64) + fresh).astype(np.float32)
    return acc


def _kernel_order(terms, c, cb):
    """(9 C, CO) terms in tap-major order (k = (3 dy + dx) C + ci) in the
    order csrc/conv3x3.cu sums them: channel box, then dx, then dy."""
    t = terms.reshape(3, 3, c // cb, cb, -1)          # dy, dx, box, ci, o
    return t.transpose(2, 1, 0, 3, 4).reshape(9 * c, -1)


@pytest.mark.parametrize("design", ["mma.sync: exact chunks of 32",
                                    "chunks of 32 truncating per k16",
                                    "chunks of 64 truncating per k16"])
def test_conv3x3_chunk_models_stay_within_cancel_limit(design):
    """The float32 sum's error where the bias cancels 9 C positive products
    (``cancelling_inputs``) at C = 512, in numpy models of the kernels'
    arithmetic: the mma.sync version's (exact chunks of 32 added rounded
    to nearest, which the card reproduced to the bit) and the redesign's
    (fresh chunks of one tap and 32 or 64 channels, each truncating at
    every k16 step, added rounded to nearest, in the kernel's order). Each
    stays within CANCEL_LIMIT / 2, so a chunk of 64 (one 128-byte box) is
    safe."""
    c = 512
    x, wk, b, exact = P.cancelling_inputs(1, 6, c, seed=c, device="cpu")
    terms = (x[0, 0, 0].double().repeat(9)[:, None]
             * wk.double().reshape(9 * c, c)).numpy()
    if design.startswith("mma.sync"):
        acc = _sequential_sum(terms, 32, False)
    else:
        cb = int(design.split()[2])
        acc = _chunked_sum(_kernel_order(terms, c, cb), cb)
    drift = np.abs(acc + b.numpy() - exact.numpy()).max()
    assert drift <= P.CANCEL_LIMIT / 2, drift


def _tile_walk(n, h, w, co, blocks):
    """csrc/conv3x3.cu's persistent schedule, in Python, at the kernel's own
    tile (kBH x kBW pixels, kBN channels, read from the source): for each
    block of a grid of min(blocks, tiles) blocks, the tiles it computes in
    order, as ((image, first row, first column), first output channel).
    Tile q is pixel tile q % P of channel tile q // P; block b takes q = b,
    b + grid, ..."""
    k = C.kernel_constants("conv3x3.cu", "kBH", "kBW", "kBN")
    bh, bw, bn = k["kBH"], k["kBW"], k["kBN"]
    th, tw = -(-h // bh), -(-w // bw)
    p = n * th * tw
    tiles = p * -(-co // bn)
    grid = min(blocks, tiles)
    walk = {}
    for b in range(grid):
        walk[b] = []
        for q in range(b, tiles, grid):
            img, rest = divmod(q % p, th * tw)
            walk[b].append(((img, rest // tw * bh, rest % tw * bw),
                            q // p * bn))
    return walk, (bh, bw, bn)


# the card tests' ragged conv shapes (tests/test_torch_cuda.py CONV_SHAPES)
WALK_SHAPES = [(3, 10, 12, 96), (1, 1, 1, 8), (2, 33, 7, 200), (2, 16, 5, 64),
               (3, 21, 13, 64), (2, 9, 1, 64), (1, 4, 300, 64),
               (2, 16, 16, 8), (2, 16, 16, 136), (3, 16, 24, 64),
               (128, 128, 128, 128)]


@pytest.mark.parametrize("blocks", [132, 6, 1])
@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_conv3x3_tile_walk_writes_every_output_once(shape, blocks):
    """The kernel's persistent schedule (``_tile_walk``): every output pixel
    of every channel is written exactly once, by a grid of at most
    ``blocks`` blocks, each taking every grid-th tile."""
    n, h, w, co = shape
    walk, (bh, bw, bn) = _tile_walk(n, h, w, co, blocks)
    assert 0 < len(walk) <= blocks
    written = np.zeros((n, h, w, -(-co // bn)), np.int64)
    for tiles in walk.values():
        for (img, h0, w0), co0 in tiles:
            written[img, h0:h0 + bh, w0:w0 + bw, co0 // bn] += 1
    assert (written == 1).all()
    sizes = [len(t) for t in walk.values()]
    assert max(sizes) - min(sizes) <= 1  # the grid's blocks share evenly


def test_conv3x3_l2_bytes_count_the_designs():
    """Bytes from L2 into the SMs a call at the probe's shape
    (``chip_smoke.conv_l2_bytes``): the mma.sync design 9.66 GB (16,384
    tiles of 576 KB), the redesign's 6.64 GB (x reused over three taps of
    18 x 8 pixel boxes: 108 KB of x and 288 KB of weights a tile)."""
    shape = (P.N, P.SPATIAL, P.SPATIAL, P.CHANNELS, P.CHANNELS)
    got = C.conv_l2_bytes(*shape)
    assert got["old"] == 16384 * 9 * 128 * 256 * 2
    assert got["new"] == 16384 * (3 * 128 * 18 * 8 + 9 * 128 * 128) * 2
    assert 6.6e9 < got["new"] < 6.7e9
    assert C.conv_l2_bytes(1, 16, 8, 64, 64)["new"] == (3 * 64 * 18 * 8 +
                                                        9 * 64 * 128) * 2


def test_kernel_constants_read_the_source():
    """The models take the kernels' tiling from their sources, and a name
    the source does not define raises."""
    assert C.kernel_constants("conv3x3.cu", "kBH", "kBW", "kBN") == dict(
        kBH=16, kBW=8, kBN=128)
    assert C.kernel_constants("gather_probe.cu", "kTile", "kStageCap") == \
        dict(kTile=G.TILE, kStageCap=G.STAGE_CAP)
    with pytest.raises(ValueError):
        C.kernel_constants("conv3x3.cu", "kNoSuchTile")


def _all_builders():
    table = dict(G.builders(2))
    table.update(G2.builders(2)[0])
    table.update(G3.builders(2)[1])
    return table


def _probe_batch(src):
    """The batch of the probes' call of a builder: N images, or one."""
    return G.N if src.ndim == 3 else 1


def test_gather_plan_stages_the_rotations_and_not_the_scatters():
    """The window plan on the probes' builders at the probes' batch: A, B
    and B2 (rotations of 128 images) stage every tile; C (the column mode)
    and F, P4, P5 (one image: fewer tiles than SMs) none, nor would F and
    P5 (random rows over 2048 and 512) at any batch; every staged window
    within the cap."""
    staged = {}
    for name, (src, idx, mode, _) in _all_builders().items():
        plan = G.plan_windows(idx, *src.shape[-2:], mode,
                              n=_probe_batch(src))
        assert (plan["bytes"][plan["staged"]] <= G.STAGE_CAP).all()
        staged[name.split()[0]] = (int(plan["staged"].sum()),
                                   plan["staged"].size)
        if name.split()[0] in ("F", "P5"):
            assert not G.plan_windows(idx, *src.shape[-2:], mode,
                                      n=10 ** 4)["staged"].any()
    for key in ("A", "B", "B2"):
        assert staged[key] == (16, 16), key
    for key in ("C", "F", "P4", "P5", "P6"):
        assert staged[key][0] == 0, key


def _windows_hold_their_indices(idx, r, c, mode, n):
    """Every in-range index (negatives wrapped) of a staged tile lies
    inside its window."""
    plan = G.plan_windows(idx, r, c, mode, n=n)
    assert plan["staged"].any()
    i = np.asarray(idx, np.int64)
    i = i[None] if i.ndim == 2 else i
    length = r * c if mode == "flat" else r
    for p, tr, tc in zip(*np.nonzero(plan["staged"])):
        tile = i[p, tr * G.TILE:(tr + 1) * G.TILE,
                 tc * G.TILE:(tc + 1) * G.TILE]
        k = np.where(tile < 0, tile + length, tile)
        k = k[(k >= 0) & (k < length)]
        if mode == "flat":
            rows, cols = k // c, k % c
        else:
            rows = k
            cols = np.arange(tc * G.TILE, tc * G.TILE + tile.shape[1])
        lo, clo = plan["rlo"][p, tr, tc], plan["clo"][p, tr, tc]
        assert (rows >= lo).all() \
            and (rows < lo + plan["rows"][p, tr, tc]).all()
        assert (cols >= clo).all() \
            and (cols < clo + plan["cols"][p, tr, tc]).all()
        assert plan["cols"][p, tr, tc] % 4 == 0 and clo % 4 == 0


def test_gather_plan_windows_hold_every_in_range_index():
    """On every builder and every edge case of the staged path."""
    for name, (src, idx, mode, _) in _all_builders().items():
        if name.split()[0] in ("A", "B", "B2"):
            _windows_hold_their_indices(idx, *src.shape[-2:], mode, G.N)
    for name, (src, idx, mode) in G.window_cases().items():
        if "past cap" not in name:
            _windows_hold_their_indices(idx, *src.shape[-2:], mode,
                                        src.shape[0])


def test_gather_plan_edges_of_the_cap():
    """A window of exactly STAGE_CAP bytes stages, the next size past it
    does not; a misaligned image or a row of a width that is not a
    multiple of 4 never stages; per-image planes count each image's own
    tiles, a shared plane its tiles once per image."""
    cases = G.window_cases()
    for name, (src, idx, mode) in cases.items():
        n = src.shape[0]
        plan = G.plan_windows(idx, *src.shape[-2:], mode, n=n)
        if "at cap" in name:
            assert (plan["bytes"] == G.STAGE_CAP).all()
            assert plan["staged"].all()
        if "past cap" in name:
            assert (plan["bytes"] > G.STAGE_CAP).all()
            assert not plan["staged"].any()
        assert not G.plan_windows(idx, *src.shape[-2:], mode, False,
                                  n)["staged"].any()
        # a call of fewer (tile, image) pairs than SMs takes no window
        assert not G.plan_windows(idx, *src.shape[-2:], mode, n=n,
                                  sms=plan["staged"].size * n + 1)[
                                      "staged"].any()
    src, idx, mode = cases["flat per-image"]
    per = G.plan_windows(idx, *src.shape[-2:], mode)["staged"]
    assert G.planned_staged(idx, 9, *src.shape[-2:], mode) == per.sum()
    assert 0 < per.sum() < per.size  # this case mixes both paths
    src, idx, mode = cases["rows at cap"]
    assert G.planned_staged(idx, 17, *src.shape[-2:], mode) == 17 * 8
    assert G.planned_staged(idx, 16, *src.shape[-2:], mode) == 0  # 128
    odd = np.zeros((8, 6), np.int32)
    assert not G.plan_windows(odd, 8, 6, 0, n=10 ** 4)["staged"].any()


def test_gather_l2_bytes_of_the_builders():
    """Sectors a call moves from L2 into the SMs at the probes' shape
    (``chip_smoke.gather_l2_bytes``): the staged windows cut A, B and B2's
    by 5-7x against the per-element design (a rotated warp row's 32 loads
    touch up to 32 sectors); the column mode keeps its path and its
    count."""
    table = dict(G.builders(1))
    table.update(G2.builders(1)[0])
    for key in ("A", "B", "B2", "C"):
        _, idx, mode, _ = next(v for k, v in table.items()
                               if k.split()[0] == key)
        got = C.gather_l2_bytes(idx, G.N, G.H, G.W, mode, G.SMS)
        if key == "C":
            assert got["new"] == got["old"]
        else:
            assert 5 * got["new"] < got["old"] < 8 * got["new"], (key, got)
            assert got["new"] > G.N * G.H * G.W * 4  # a window per image


def test_gather_bank_wavefronts_of_the_builders():
    """The shared-memory bank model (``chip_smoke.gather_bank_wavefronts``):
    row mode's lanes own a column each and read without conflict (B, B2:
    1.0); flat mode's rotated rows cross banks (A: between 2 and 4
    wavefronts a load), fewer with a window row padded by 12 floats; the
    column mode stages nothing (None). A hand case: 32 lanes down one
    column of a 32-float window row all hit one bank."""
    table = dict(G.builders(1))
    table.update(G2.builders(1)[0])
    got = {}
    for key in ("A", "B", "B2", "C"):
        _, idx, mode, _ = next(v for k, v in table.items()
                               if k.split()[0] == key)
        got[key] = C.gather_bank_wavefronts(idx, G.H, G.W, mode)
    assert got["B"] == got["B2"] == 1.0 and got["C"] is None
    assert 2.0 < got["A"] < 4.0
    _, idx, mode, _ = next(v for k, v in table.items() if k.startswith("A"))
    assert C.gather_bank_wavefronts(idx, G.H, G.W, mode, pad=12) < got["A"]
    # flat index over a (64, 32) image: output column j reads source row j,
    # column 0 or 31 by output row, so the window rows are 32 floats and a
    # warp's 32 lanes read one column down 32 rows: one bank
    rows = np.broadcast_to(np.arange(64), (64, 64))
    idx = (rows * 32 + (np.arange(64)[:, None] % 2) * 31).astype(np.int32)
    assert C.gather_bank_wavefronts(idx, 64, 32, "flat") == 32.0


def test_gather_phases_instruments_the_kernel_source():
    """The diagnostic ``probes/gather_phases.py`` still finds each of its
    anchors in csrc/gather_probe.cu exactly once and adds its nine clock
    reads; a source that lost an anchor raises."""
    from ddti_tpu_torch.probes import gather_phases as GP

    text = (GP.PKG / "csrc" / "gather_probe.cu").read_text()
    assert "clock64" not in text
    assert GP.instrumented_source(text).count("clock64()") == 9
    with pytest.raises(ValueError):
        GP.instrumented_source(text.replace("cp_async_wait<kBufs - 1>();",
                                            ""))
