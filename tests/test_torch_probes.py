"""The ports of the softmax probes (ddti_tpu_torch/probes) and the flash
path's polynomial exp2 (DDTI_POLY_EXP2) against the JAX package on the CPU.

The JAX probes are loaded from ``benchmarks/`` by file path (the port never
imports them); their Pallas kernels run in interpret mode, as the JAX
package's own tests run them. Inputs come from numpy with a fixed seed and
go to both sides. The CUDA kernels are held against the same plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import importlib.util
import math
import os
import pathlib
import re
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as C
from ddti_tpu.ops import attention as jattn
from ddti_tpu_torch.ops import attention as tattn
from ddti_tpu_torch.probes import exp2_probe as E2
from ddti_tpu_torch.probes import flash_mskip_ab as MS
from ddti_tpu_torch.probes import flash_poly_ab as PA

ROOT = pathlib.Path(__file__).resolve().parents[1]
MODES = list(E2.MODES)
# the JAX package's CPU backend flushes subnormal float32 results to zero
MIN_NORMAL = 2.0 ** -126


def _load_probe(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_probe_{name}", ROOT / "benchmarks" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_exp2_probe():
    return _load_probe("exp2_probe")


def _ulps(a, b):
    """Largest ulp distance of two arrays of non-negative float32."""
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return int(np.abs(a - b).max())


def _ftz(a):
    return np.where(a < MIN_NORMAL, np.float32(0), a).astype(np.float32)


def _uniform(shape, seed=0, low=E2.LOW, high=E2.HIGH):
    return np.random.default_rng(seed).uniform(low, high, shape).astype(
        np.float32)


@pytest.mark.parametrize("mode", MODES)
def test_exp2_probe_reference_matches_jax_functions(mode, jax_exp2_probe):
    """The plain version against the JAX probe's functions on the probe's
    range: the polynomials (exp2_probe.py:_poly_exp2) to 2 ulp (measured:
    0-1; the port rounds its coefficients from float64, the probe chains
    float32 powers), the copy bit for bit; the builtin within 1 ulp of the
    correctly rounded exp2 and within XLA's own exp2 error (5.7e-7 relative
    on the CPU, up to 9 ulp) of jnp.exp2."""
    x = _uniform(1 << 18, seed=1)
    got = E2.exp2_probe_reference(torch.from_numpy(x), mode).numpy()
    if mode == "copy":
        assert np.array_equal(got.view(np.int32), x.view(np.int32))
    elif mode == "builtin":
        exact = np.exp2(x.astype(np.float64))
        assert _ulps(got, exact.astype(np.float32)) <= 1
        want = np.asarray(jnp.exp2(jnp.asarray(x)), np.float64)
        assert np.max(np.abs(got - want) / want) <= 1e-6
    else:
        want = jax_exp2_probe._poly_exp2(jnp.asarray(x), int(mode[4:]))
        assert _ulps(got, want) <= 2


@pytest.mark.parametrize("mode", MODES)
def test_exp2_probe_reference_matches_pallas_interpret(mode, monkeypatch,
                                                       jax_exp2_probe):
    """The plain version against the TPU probe's kernel
    (benchmarks/exp2_probe.py:make_kernel) in interpret mode, cut to one
    256 x 1024 block: 2 ulp for the polynomials (measured 1), the copy bit
    for bit, the builtin within XLA's exp2 error."""
    for name, val in (("ROWS", 256), ("COLS", 1024), ("BR", 256),
                      ("BC", 1024)):
        monkeypatch.setattr(jax_exp2_probe, name, val)
    x = _uniform((256, 1024), seed=2)
    want = np.asarray(jax_exp2_probe.make_kernel(mode)(jnp.asarray(x)))
    got = E2.exp2_probe_reference(torch.from_numpy(x), mode).numpy()
    if mode == "copy":
        assert np.array_equal(got.view(np.int32), want.view(np.int32))
    elif mode == "builtin":
        assert np.max(np.abs(got - want) / want) <= 1e-6
    else:
        assert _ulps(got, want) <= 2


def test_exp2_poly_matches_jax_attention():
    """The flash path's polynomial against ddti_tpu.ops.attention._exp2_poly
    on [-130, 127] (the clamp's both ends) to 2 ulp (measured: 0) where
    XLA's CPU backend keeps the result normal (it flushes subnormal results,
    the port keeps them); equal at the -1e30 sentinel; 2^-126 at -inf, where
    JAX's gives NaN (the kernels' running max starts at -inf)."""
    x = np.linspace(-130.0, 127.0, 400_001, dtype=np.float32)
    got = tattn._exp2_poly(torch.from_numpy(x)).numpy()
    want = np.asarray(jattn._exp2_poly(jnp.asarray(x)))
    assert _ulps(_ftz(got), want) <= 2
    assert not np.isnan(got).any()
    edge = tattn._exp2_poly(torch.tensor([-1e30, -math.inf])).numpy()
    assert edge[0] == np.asarray(jattn._exp2_poly(jnp.float32(-1e30)))
    assert edge[0] == edge[1] == np.float32(MIN_NORMAL)


def _coeff_literals():
    src = (ROOT / "ddti_tpu_torch" / "csrc" / "sm90.cuh").read_text()
    body = src[src.index("exp2_coeff(int k)"):]
    body = body[:body.index("}")]
    lits = dict(re.findall(r"k == (\d) +\? +(0x[0-9a-f.p+-]+)f", body))
    return {int(k): float.fromhex(v) for k, v in lits.items()}


def _kernel_poly_model(x, order):
    """csrc/sm90.cuh:exp2_poly's arithmetic in numpy: the clamp at -2^22,
    the rounding by adding 1.5 * 2^23 (i read from the sum's low bits, no
    conversion), Horner with one FMA a term (modelled as the float64
    product-sum rounded once to float32), 2^i from its exponent bits."""
    f32 = np.float32
    x = np.maximum(x.astype(f32), f32(-2.0 ** 22))
    big = f32(1.5 * 2.0 ** 23)
    r = (x + big).astype(f32)
    f = (x - (r - big).astype(f32)).astype(f32)
    i = np.clip(r.view(np.int32) - 0x4B400000, -126, 127)
    c = tattn.EXP2_POLY_COEFFS
    p = np.full_like(f, c[order])
    for k in range(order - 1, -1, -1):
        p = (p.astype(np.float64) * f + c[k]).astype(f32)
    return (p * ((i + 127) << 23).astype(np.int32).view(f32)).astype(f32)


@pytest.mark.parametrize("order", [4, 5, 6])
def test_kernel_polynomial_arithmetic_matches_plain(order):
    """The CUDA polynomial's literals are the plain version's coefficients,
    and its arithmetic (modelled on the CPU) gives what the plain version
    gives to 2 ulp, subnormal results included: the magic-number rounding is
    round-half-even (halves of both parities), and -inf and -1e30 give
    2^-126, never NaN."""
    assert _coeff_literals() == {k: tattn.EXP2_POLY_COEFFS[k]
                                 for k in range(1, 7)}
    x = np.concatenate([
        np.linspace(-130.0, 127.0, 200_001, dtype=np.float32),
        _uniform(1 << 16, seed=order),
        np.float32([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, -126.5, -125.5, 126.5,
                    -0.0, 0.0, 3.0, -20.0, -1e30, -np.inf])])
    model = _kernel_poly_model(x, order)
    plain = tattn._exp2_poly(torch.from_numpy(x), order).numpy()
    assert not np.isnan(model).any()
    assert _ulps(model, plain) <= 2
    assert model[-1] == model[-2] == np.float32(MIN_NORMAL)
    halves = np.float32([0.5, 1.5, 2.5, -0.5, -1.5, -2.5])
    big = np.float32(1.5 * 2.0 ** 23)
    assert np.array_equal(((halves + big).astype(np.float32) - big),
                          np.round(halves))


POLY_HDG = [(8, 32, 4), (3, 32, 1), (2, 128, 1)]


@pytest.fixture()
def poly_mode(monkeypatch):
    """Both packages' flash paths with the polynomial exp2; JAX reads its
    flag at trace time, so its caches are cleared around the flip."""
    jax.clear_caches()
    monkeypatch.setattr(jattn, "USE_POLY_EXP2", True)
    monkeypatch.setattr(tattn, "USE_POLY_EXP2", True)
    yield
    jax.clear_caches()


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("h,d,G", POLY_HDG)
def test_flash_reference_poly_matches_pallas_interpret(h, d, G, poly_mode):
    """With DDTI_POLY_EXP2 on both sides, the plain forward against the
    Pallas forward in interpret mode (packed and unpacked), at the limits
    of the builtin-exp2 test (tests/test_torch_attention.py)."""
    q, k, v = _qkv((2, h, 256, d))
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    assert jattn._packing(jq) == G
    o_jax = np.asarray(jattn.flash_attention(jq, jk, jv, 64, 64, True))
    if G > 1:
        _, lse = jattn._flash_forward_packed(jq, jk, jv, 64, 64, G,
                                             interpret=True)
        lse = np.asarray(lse).reshape(2, h // G, 256, G).transpose(
            0, 1, 3, 2).reshape(2, h, 256)
    else:
        _, lse = jattn._flash_forward(jq, jk, jv, 64, 64, interpret=True)
        lse = np.asarray(lse).reshape(2, h, 256)
    o, lse_t = tattn.flash_forward_reference(*map(torch.from_numpy,
                                                  (q, k, v)))
    np.testing.assert_allclose(o.numpy(), o_jax, atol=2e-5)
    np.testing.assert_allclose(lse_t.numpy(), lse, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,d,G", POLY_HDG[:2])
def test_flash_backward_reference_poly_matches_pallas_interpret(h, d, G,
                                                                dtype,
                                                                poly_mode):
    """With DDTI_POLY_EXP2 on both sides, dq, dk, dv of the plain backward
    against the Pallas dK/dV and dQ kernels in interpret mode, relative to
    each gradient's max |value|: float32 2e-5, bf16 2e-2 (the builtin
    test's limits)."""
    q, k, v = _qkv((1, h, 128, d), seed=4)
    g = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    jq, jk, jv, jg = (jnp.asarray(t).astype(getattr(jnp, dtype))
                      for t in (q, k, v, g))
    if G > 1:
        o, lse = jattn._flash_forward_packed(jq, jk, jv, 64, 64, G,
                                             interpret=True)
        want = jattn._flash_backward_packed(jq, jk, jv, o, lse, jg, 64, 64,
                                            G, interpret=True)
        lse_t = np.asarray(lse).reshape(1, h // G, 128, G).transpose(
            0, 1, 3, 2).reshape(1, h, 128)
    else:
        o, lse = jattn._flash_forward(jq, jk, jv, 64, 64, interpret=True)
        want = jattn._flash_backward(jq, jk, jv, o, lse, jg, 64, 64,
                                     interpret=True)
        lse_t = np.asarray(lse).reshape(1, h, 128)

    def t(a):
        return torch.from_numpy(np.array(a, np.float32)).to(
            getattr(torch, dtype))

    got = tattn.flash_backward_reference(t(jq), t(jk), t(jv), t(o),
                                         torch.from_numpy(lse_t.copy()), t(jg))
    rtol = {"float32": 2e-5, "bfloat16": 2e-2}[dtype]
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b, np.float32)
        err = np.abs(a.float().numpy() - b).max() / np.abs(b).max()
        assert err <= rtol, (name, err)


def test_poly_mode_changes_the_plain_flash_path(poly_mode):
    """The switch reaches the plain versions: in poly mode the forward's
    probabilities come from _exp2_poly (bits differ from torch.exp2's
    somewhere), and the result stays within float32 noise of the builtin's."""
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 128, 32), seed=9))
    o_poly, lse_poly = tattn.flash_forward_reference(q, k, v)
    tattn.USE_POLY_EXP2 = False
    o_b, lse_b = tattn.flash_forward_reference(q, k, v)
    assert not torch.equal(o_poly, o_b)
    assert (o_poly - o_b).abs().max().item() <= 2e-6
    assert (lse_poly - lse_b).abs().max().item() <= 2e-6


@pytest.mark.parametrize("dtype, atol", [("float32", 1e-5),
                                         ("bfloat16", None)])
def test_mskip_reference_matches_jax_probe(dtype, atol):
    """The m-skip forward's plain version against the TPU probe
    (benchmarks/flash_mskip_ab.py:build(True)) in interpret mode at (1, 2,
    512, 32), with the probe's 256-key tiles and 256-row vote, and with the
    kernel's 64-key tiles and 16-row vote against the port's plain forward:
    float32 to 1e-5, bf16 to one bf16 ulp of max|o| (measured: 2.4e-4 and
    2.0e-3 with max|o| 0.52, one ulp 3.9e-3). The stale branch is taken on
    some (rows, tile) pairs and not on others."""
    probe = _load_probe("flash_mskip_ab")
    q, k, v = _qkv((1, 2, 512, 32), seed=3)
    jq, jk, jv = (jnp.asarray(t).astype(getattr(jnp, dtype))
                  for t in (q, k, v))
    want = np.asarray(probe.build(True, interpret=True)(jq, jk, jv),
                      np.float32)
    tq, tk, tv = (torch.from_numpy(np.array(t, np.float32)).to(
        getattr(torch, dtype)) for t in (jq, jk, jv))
    if atol is None:
        atol = 2.0 ** (math.floor(math.log2(np.abs(want).max())) - 7)
    o256, _ = MS.flash_forward_mskip_reference(tq, tk, tv, 256, 256)
    np.testing.assert_allclose(o256.float().numpy(), want, atol=atol)
    o, lse = MS.flash_forward_mskip_reference(tq, tk, tv)
    stale = MS.flash_forward_mskip_reference.stale_share
    assert 0.0 < stale < 1.0
    o_ref, lse_ref = tattn.flash_forward_reference(tq, tk, tv)
    assert o.dtype == tq.dtype and lse.shape == (1, 2, 512)
    np.testing.assert_allclose(o.float().numpy(), o_ref.float().numpy(),
                               atol=atol)
    np.testing.assert_allclose(lse.numpy(), lse_ref.numpy(), atol=1e-5)


def test_mskip_reference_ragged_and_poly(poly_mode):
    """A ragged S (the last key tile and the last vote group short) in poly
    mode: o and lse2 within float32 noise of the plain forward."""
    q, k, v = map(torch.from_numpy, _qkv((1, 3, 200, 24), seed=11))
    o, lse = MS.flash_forward_mskip_reference(q, k, v)
    o_ref, lse_ref = tattn.flash_forward_reference(q, k, v)
    assert torch.isfinite(o).all() and torch.isfinite(lse).all()
    assert (o - o_ref).abs().max().item() <= 1e-5
    assert (lse - lse_ref).abs().max().item() <= 1e-5


def test_probe_wrappers_refuse_cpu_tensors():
    """On a CPU tensor the dispatchers take the plain versions and the
    kernels' wrappers raise, before any build; a mode the kernel lacks
    raises everywhere."""
    x = torch.zeros(16)
    before = E2.exp2_probe_cuda.launches
    assert torch.equal(E2.exp2_probe(x, "poly6"),
                       E2.exp2_probe_reference(x, "poly6"))
    with pytest.raises(ValueError, match="CUDA device"):
        E2.exp2_probe_cuda(x, "poly6")
    with pytest.raises(ValueError, match="mode"):
        E2.exp2_probe_reference(x, "poly3")
    with pytest.raises(ValueError, match="float32"):
        E2.exp2_probe_cuda(x.double(), "copy")
    assert E2.exp2_probe_cuda.launches == before
    q = torch.zeros((1, 1, 64, 32), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        MS.flash_forward_mskip_cuda(q, q, q)
    assert MS.flash_forward_mskip_cuda.launches == 0


def _exp2_tile_walk(n):
    """csrc/exp2_probe.cu's grid in numpy, at the kernel's own tile
    (kThreads x kVecs 16-byte vectors, read from the source): ceil(n /
    tile floats) blocks; a block whose tile holds only whole vectors loads
    and stores all of them, the last block only its vectors below n // 4
    and, one a thread, the n % 4 elements past them. Returns the times each
    element was written and the number of blocks."""
    k = C.kernel_constants("exp2_probe.cu", "kThreads", "kVecs")
    threads, vecs = k["kThreads"], k["kVecs"]
    tile = threads * vecs
    blocks = -(-n // (4 * tile))
    n4 = n >> 2
    written = np.zeros(n, np.int64)
    # thread t's k-th vector in a tile: k * threads + t, every slot once
    slots = (np.arange(vecs)[:, None] * threads
             + np.arange(threads)[None]).ravel()
    assert np.array_equal(np.sort(slots), np.arange(tile))
    for b in range(blocks):
        first, left = b * tile, n4 - b * tile
        v = first + (slots if left >= tile else slots[slots < max(left, 0)])
        np.add.at(written, (4 * v[:, None] + np.arange(4)).ravel(), 1)
        if left < tile:
            at = (n & ~3) + np.arange(threads)
            np.add.at(written, at[at < n], 1)
    return written, blocks


@pytest.mark.parametrize("n", [1, 3, 4, 5, 4095, 4096, 4097, 4099, 8192,
                               8195, 12287, 16388, 4 * 1024 * 1024 + 2,
                               E2.ROWS * E2.COLS])
def test_exp2_probe_tile_walk_writes_every_element_once(n):
    """The kernel's grid (``_exp2_tile_walk``): every element written
    exactly once, for n around the 4,096-float tile and at the probe's
    8,388,608, with no block left without work."""
    written, blocks = _exp2_tile_walk(n)
    assert (written == 1).all()
    assert blocks == max(1, -(-n // 4096))
    assert C.kernel_constants("exp2_probe.cu", "kThreads", "kVecs") == dict(
        kThreads=256, kVecs=4)


def test_exp2_probe_main_on_cpu(capsys):
    """The probe's lines at a toy shape through the plain versions: every
    mode, its error against float64 as on the CPU figures, no time."""
    assert E2.main(["--device", "cpu", "--rows", "64", "--cols", "1024"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [l.split(":")[0].strip() for l in out] == MODES
    errs = {l.split(":")[0].strip():
            float(l.split("max rel err ")[1].split()[0]) for l in out}
    assert errs["copy"] == 0.0 and errs["builtin"] <= 1.2e-7
    assert 1e-5 < errs["poly4"] <= 6e-5 and 1e-6 < errs["poly5"] <= 4e-6
    assert errs["poly6"] <= 3e-7
    assert all("not measured" in l for l in out)


def test_flash_mskip_main_on_cpu(capsys):
    assert MS.main(["--device", "cpu", "--shape", "1", "2", "256", "32"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [l.split()[0] for l in out] == ["baseline", "m-skip"]
    assert all("not measured" in l for l in out)
    assert all(float(l.split("max|err| ")[1]) < 2e-2 for l in out)


def test_flash_poly_main_on_cpu(capsys):
    """One subprocess per setting of DDTI_POLY_EXP2, each printing the TPU
    probe's line from its own setting."""
    assert PA.main(["--device", "cpu", "--shape", "1", "2", "256", "32"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [l.split()[0] for l in out] == ["poly=False", "poly=True"]
    assert all("fwd_ms=not measured" in l and "finite=True" in l
               for l in out)


def test_poly_flag_reaches_the_build_and_the_plain_versions():
    """DDTI_POLY_EXP2=1, read once at import: the nvcc flags gain the
    define and the library its own hashed name; unset, the flags are the
    default build's as before."""
    code = ("from ddti_tpu_torch.ops import _build, attention as A; "
            "print(_build.USE_POLY_EXP2, A.USE_POLY_EXP2, "
            "'-DDDTI_POLY_EXP2=1' in _build.NVCC_FLAGS, "
            "_build.library_path().name)")
    out = {}
    for flag in ("0", "1"):
        res = subprocess.run(
            [sys.executable, "-c", code], cwd=ROOT, check=True, timeout=120,
            capture_output=True, text=True,
            env={**os.environ, "DDTI_POLY_EXP2": flag})
        out[flag] = res.stdout.split()
    assert out["0"][:3] == ["False", "False", "False"]
    assert out["1"][:3] == ["True", "True", "True"]
    assert out["0"][3] != out["1"][3]
