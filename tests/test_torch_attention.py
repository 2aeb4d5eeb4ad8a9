"""ddti_tpu_torch.ops.attention against ddti_tpu.ops.attention on the CPU.

The port's plain versions (the CPU side of its flash kernels) are held
against the JAX Pallas flash kernels run in interpret mode, packed (G heads
per 128-lane group) and unpacked: the forward's output and base-2
logsumexp, and the backward's dq, dk, dv. The CUDA kernels themselves are
held against the same plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py). Inputs come from numpy with a fixed seed and go to both
packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.ops import attention as jattn
from ddti_tpu_torch.ops import attention as tattn


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax_forward(q, k, v, G):
    """The JAX interpret forward: o, its lse residual in the JAX layout,
    and that lse reshaped to the port's (B, H, S)."""
    b, h, s, _ = q.shape
    if G > 1:
        o, lse = jattn._flash_forward_packed(q, k, v, 64, 64, G,
                                             interpret=True)
        # (B*H/G, S, G) -> (B, H/G, S, G) -> (B, H/G, G, S) -> (B, H, S)
        return o, lse, np.asarray(lse).reshape(b, h // G, s, G).transpose(
            0, 1, 3, 2).reshape(b, h, s)
    o, lse = jattn._flash_forward(q, k, v, 64, 64, interpret=True)
    return o, lse, np.asarray(lse).reshape(b, h, s)


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(getattr(torch,
                                                                  dtype))


def _assert_close_rel(got, want, rtol, names=("dq", "dk", "dv")):
    """Each gradient within ``rtol`` of its max |value|."""
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        scale = np.abs(b).max()
        assert scale > 0, name
        err = np.abs(a - b).max() / scale
        assert err <= rtol, (name, err)


HDG = [
    (8, 32, 4),   # TransUNet: embed 256 / 8 heads -> packed kernel, G = 4
    (3, 32, 1),   # odd head count -> unpacked kernel
    (2, 128, 1),  # full-width heads -> unpacked kernel
    (8, 16, 8),   # narrow heads -> packed kernel, G = 8
    (2, 24, 1),   # 128 % 24 != 0 -> unpacked kernel
    # heads wider than one Hopper tile: the wide kernels' output slices
    (1, 136, 1),  # a ragged second slice of 8 columns
    (1, 256, 1),  # TransUNet's embed_dim 256 in one head
    (1, 264, 1),  # three slices backward, two forward (bf16: past 256)
]
# backward vs the Pallas backward, relative to each gradient's max |value|:
# float32 differs by summation order; bf16 also by where the kernels round
# P and dS, which both sides do alike, and by the order of bf16 products
BWD_RTOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("h,d,G", HDG)
def test_flash_reference_matches_pallas_interpret(h, d, G):
    q, k, v = _qkv((2, h, 256, d))
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    assert jattn._packing(jq) == G
    o_jax = np.asarray(jattn.flash_attention(jq, jk, jv, 64, 64, True))
    lse_jax = _jax_forward(jq, jk, jv, G)[2]

    o, lse = tattn.flash_forward_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(o.numpy(), o_jax, atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), lse_jax, atol=1e-5)


@pytest.mark.parametrize("shape", [(2, 4, 64, 32), (1, 1, 128, 136),
                                   (1, 1, 128, 256), (1, 1, 128, 264)])
def test_flash_reference_bf16_matches_pallas_interpret(shape):
    q, k, v = _qkv(shape, seed=1)
    jb = [jnp.asarray(t).astype(jnp.bfloat16) for t in (q, k, v)]
    o_jax = np.asarray(jattn.flash_attention(*jb, 16, 16, True), np.float32)
    tb = [torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v)]
    o, _ = tattn.flash_forward_reference(*tb)
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(o.float().numpy(), o_jax, atol=2e-2)


@pytest.mark.parametrize("dtype,atol", [("float32", 1e-5),
                                        ("bfloat16", 2e-2)])
def test_attention_reference_matches_jax(dtype, atol):
    q, k, v = _qkv((2, 3, 48, 32), seed=2)
    want = jattn.attention_reference(
        *(jnp.asarray(t).astype(getattr(jnp, dtype)) for t in (q, k, v)))
    got = tattn.attention_reference(
        *(torch.from_numpy(t).to(getattr(torch, dtype)) for t in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("h,d,G", HDG)
def test_flash_backward_reference_matches_pallas_interpret(h, d, G, dtype):
    """dq, dk, dv of the plain version against the Pallas dK/dV and dQ
    kernels in interpret mode, from the JAX interpret forward's o and lse.
    Measured worst relative error over these cases: float32 5.3e-7,
    bf16 1.7e-3."""
    q, k, v = _qkv((1, h, 128, d), seed=4)
    g = np.random.default_rng(5).standard_normal(q.shape).astype(np.float32)
    jq, jk, jv, jg = (jnp.asarray(t).astype(getattr(jnp, dtype))
                      for t in (q, k, v, g))
    assert jattn._packing(jq) == G
    o, lse, lse_port = _jax_forward(jq, jk, jv, G)
    if G > 1:
        want = jattn._flash_backward_packed(jq, jk, jv, o, lse, jg, 64, 64,
                                            G, interpret=True)
    else:
        want = jattn._flash_backward(jq, jk, jv, o, lse, jg, 64, 64,
                                     interpret=True)
    got = tattn.flash_backward_reference(
        *(_to_torch(t, dtype) for t in (jq, jk, jv, o)),
        torch.from_numpy(lse_port), _to_torch(jg, dtype))
    assert all(t.dtype == getattr(torch, dtype) for t in got)
    _assert_close_rel([t.float().numpy() for t in got], want,
                      BWD_RTOL[dtype])


def test_flash_attention_grad_matches_jax_custom_vjp():
    """The whole custom VJP: jax.grad through the Pallas flash attention
    (interpret mode) against torch.autograd through the port's
    flash_attention on CPU tensors."""
    q, k, v = _qkv((2, 4, 64, 32), seed=6)
    want = jax.grad(
        lambda *t: jnp.sum(jnp.sin(jattn.flash_attention(*t, 16, 16, True))),
        argnums=(0, 1, 2))(*(jnp.asarray(t) for t in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    got = torch.autograd.grad(torch.sin(tattn.flash_attention(tq, tk,
                                                              tv)).sum(),
                              (tq, tk, tv))
    _assert_close_rel([t.numpy() for t in got], want, BWD_RTOL["float32"])


def test_flash_attention_cpu_path_without_nvcc():
    """The module imports and the CPU path runs with no CUDA toolkit; the
    forward and the backward run their plain versions on inputs that
    require grad, with attention_reference's autograd gradients; the
    kernels' wrappers refuse CPU tensors."""
    from ddti_tpu_torch.ops import _build  # noqa: F401  (no build at import)

    q, k, v = (torch.from_numpy(t).requires_grad_()
               for t in _qkv((1, 2, 64, 32), seed=3))
    bwd = tattn.flash_backward_cuda
    before = (tattn.flash_forward_cuda.launches, bwd.launches_dkdv,
              bwd.launches_dq)
    o = tattn.flash_attention(q, k, v)
    want = tattn.attention_reference(q, k, v)
    np.testing.assert_allclose(o.detach().numpy(), want.detach().numpy(),
                               atol=1e-5)
    w = torch.from_numpy(np.random.default_rng(7).standard_normal(
        o.shape).astype(np.float32))
    got = torch.autograd.grad((o * w).sum(), (q, k, v))
    ref = torch.autograd.grad((want * w).sum(), (q, k, v))
    _assert_close_rel([t.numpy() for t in got], [t.numpy() for t in ref],
                      BWD_RTOL["float32"])
    # the plain versions ran
    assert (tattn.flash_forward_cuda.launches, bwd.launches_dkdv,
            bwd.launches_dq) == before
    with pytest.raises(ValueError, match="CUDA device"):
        tattn.flash_forward_cuda(q.detach(), k.detach(), v.detach())
    lse = torch.zeros(q.shape[:3])
    with pytest.raises(ValueError, match="CUDA device"):
        bwd(*(t.detach() for t in (q, k, v, o)), lse, w)


@pytest.mark.parametrize("d", [4, 12, 136, 256, 264, 512])
def test_flash_wrappers_take_every_head_width(d):
    """No head width is refused: on a non-CPU tensor (meta stands in for
    CUDA) flash_attention with grad, the forward and the backward wrapper
    all reach the device check, which raises before anything is padded,
    built or launched."""
    q = torch.empty((1, 2, 64, d), device="meta", requires_grad=True)
    lse = torch.empty((1, 2, 64), device="meta")
    with pytest.raises(ValueError, match="one CUDA device"):
        tattn.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="one CUDA device"):
        tattn.flash_forward_cuda(*(q.detach(),) * 3)
    with pytest.raises(ValueError, match="one CUDA device"):
        tattn.flash_backward_cuda(*(q.detach(),) * 4, lse, q.detach())


@pytest.mark.parametrize("case", ["float64", "shapes", "dtypes"])
def test_flash_wrappers_still_reject(case):
    """What the kernels do not take still raises, before the device check:
    float64, q, k, v of different shapes, or of different dtypes."""
    q = torch.empty((1, 2, 64, 16), device="meta")
    args, match = {
        "float64": ((q.double(),) * 3, "float32 or bfloat16"),
        "shapes": ((q, q[..., :8], q), "one .B, H, S, D. shape"),
        "dtypes": ((q, q.bfloat16(), q), "float32 or bfloat16"),
    }[case]
    with pytest.raises(ValueError, match=match):
        tattn.flash_forward_cuda(*args)
    lse = torch.empty((1, 2, 64), device="meta")
    with pytest.raises(ValueError, match=match):
        tattn.flash_backward_cuda(*args, args[0], lse, args[0])


@pytest.mark.parametrize("d,width", [(4, 8), (12, 16), (130, 136),
                                     (256, 256)])
def test_pad_head_keeps_the_function(d, width):
    """The CUDA wrappers' padding of a head width to a multiple of 8: zero
    columns of q and k leave q k^T as it is, those of v add zero columns
    to o and the gradients, and the scores scaled by the true width (what
    the kernels take as scale_d; here, q scaled by sqrt(width / d) before
    the plain version scales by width^-1/2) give the unpadded result."""
    assert tattn._padded_width(d) == width
    q, k, v = map(torch.from_numpy, _qkv((1, 2, 64, d), seed=8))
    do = torch.from_numpy(_qkv((1, 2, 64, d), seed=9)[0])
    o, lse = tattn.flash_forward_reference(q, k, v)
    want = tattn.flash_backward_reference(q, k, v, o, lse, do)
    qp, kp, vp, op, dop = (tattn._pad_head(t, width)
                           for t in (q, k, v, o, do))
    assert qp.shape[-1] == width and (qp[..., d:] == 0).all()
    qs = qp * (width / d) ** 0.5
    o2, lse2 = tattn.flash_forward_reference(qs, kp, vp)
    np.testing.assert_allclose(o2[..., :d].numpy(), o.numpy(), atol=1e-5)
    assert (o2[..., d:] == 0).all()
    np.testing.assert_allclose(lse2.numpy(), lse.numpy(), atol=1e-5)
    got = tattn.flash_backward_reference(qs, kp, vp, op, lse, dop)
    # dq of the scaled q: the chain rule's factor back
    got = (got[0] * (width / d) ** 0.5, got[1], got[2])
    for a, b in zip(got, want):
        assert (a[..., d:] == 0).all()
    _assert_close_rel([t[..., :d].numpy() for t in got],
                      [t.numpy() for t in want], BWD_RTOL["float32"])


def test_flash_attention_unaligned_head_matches_jax_fallback():
    """A head width that is not a multiple of 8 (D = 12): JAX's
    flash_attention returns its exact plain attention there (_fallback);
    the port's flash_attention, o and all three gradients, against it."""
    q, k, v = _qkv((1, 2, 128, 12), seed=10)
    w = np.random.default_rng(11).standard_normal(q.shape).astype(np.float32)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    assert jattn._fallback(jq, 64, 64, True)
    o_jax = np.asarray(jattn.flash_attention(jq, jk, jv, 64, 64, True))
    want = jax.grad(
        lambda *t: jnp.sum(jattn.flash_attention(*t, 64, 64, True) * w),
        argnums=(0, 1, 2))(jq, jk, jv)
    tq, tk, tv = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    o = tattn.flash_attention(tq, tk, tv)
    np.testing.assert_allclose(o.detach().numpy(), o_jax, atol=2e-5)
    got = torch.autograd.grad((o * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    _assert_close_rel([t.numpy() for t in got], want, BWD_RTOL["float32"])


@pytest.mark.parametrize("needle", ["scaled_dot_product_attention",
                                    "torch.nn.attention",
                                    "_scaled_dot_product_"])
def test_port_calls_no_library_attention(needle):
    """Every attention of the port is its own kernel or plain version:
    no module of ddti_tpu_torch names PyTorch's fused attention
    (chip_smoke.py, outside the package, times it as a yardstick)."""
    import pathlib

    root = pathlib.Path(tattn.__file__).resolve().parents[1]
    files = sorted(root.rglob("*.py"))
    assert len(files) > 20
    hits = [str(p.relative_to(root)) for p in files
            if needle in p.read_text(encoding="utf-8")]
    assert not hits, f"{needle} in {hits}"


def _tf32(x):
    """float32 rounded to TF32 (10 explicit mantissa bits), to nearest with
    ties to even, in int32 bit operations on the float32 pattern."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF).view(torch.float32)


def _matmul_3xtf32(a, b):
    """a @ b as the float32 backward kernels form it on the tensor cores:
    x = hi + lo with hi = tf32(x), lo = tf32(x - hi), and a b = a_lo b_hi +
    a_hi b_lo + a_hi b_hi (each TF32 product exact in float32, summed in
    float32); a_lo b_lo is dropped."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    return al @ bh + ah @ bl + ah @ bh


def _backward_with(q, k, v, o, lse2, do, matmul):
    """flash_backward_reference's float32 function with every product
    taken by ``matmul``."""
    scale = 1.0 / np.sqrt(q.shape[-1])
    p = torch.exp2(matmul(q, k.transpose(-1, -2)) * (tattn.LOG2E * scale)
                   - lse2.unsqueeze(-1))
    delta = (do * o).sum(-1, keepdim=True)
    dv = matmul(p.transpose(-1, -2), do)
    ds = p * (matmul(do, v.transpose(-1, -2)) - delta)
    return (matmul(ds, k) * scale, matmul(ds.transpose(-1, -2), q) * scale,
            dv)


@pytest.mark.parametrize("x, want", [
    (1 + 2 ** -11, 1.0),                  # a tie: to even
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),      # a tie: to even, upwards
    (1 + 2 ** -11 + 2 ** -20, 1 + 2 ** -10),  # above the tie
    (-(1 + 2 ** -12), -1.0),              # below the tie
])
def test_tf32_rounding_model(x, want):
    assert _tf32(torch.tensor([x], dtype=torch.float32)).item() == want


def test_3xtf32_backward_keeps_float32_accuracy():
    """The float32 backward kernels' arithmetic, modelled on the CPU: every
    product as three TF32 products. Against a float64 backward of the same
    inputs, and against flash_backward_reference (float32 products), each
    of dq, dk, dv stays within 4e-6 of its max |value| (measured: 9.6e-7 and
    1.2e-6, the float32 reference itself 1.0e-6 from float64): 3xTF32 leaves
    about 2^-21 of each term, float32 summation about as much, so the card's
    limit of 1e-4 keeps a margin of ~100x. One TF32 product alone misses it
    (~1e-3), which is why the kernels take three."""
    rng = np.random.default_rng(8)
    q, k, v, do = (torch.from_numpy(rng.standard_normal(
        (2, 2, 130, 32)).astype(np.float32)) for _ in range(4))
    o, lse2 = tattn.flash_forward_reference(q, k, v)
    args = (q, k, v, o, lse2, do)
    split = _backward_with(*args, _matmul_3xtf32)
    exact = _backward_with(*(t.double() for t in args), torch.matmul)
    ref = tattn.flash_backward_reference(*args)
    one_pass = _backward_with(*args, lambda a, b: _tf32(a) @ _tf32(b))
    for name, s, e, r, t in zip(("dq", "dk", "dv"), split, exact, ref,
                                one_pass):
        scale = e.abs().max().item()
        assert (s.double() - e).abs().max().item() <= 4e-6 * scale, name
        assert (s - r).abs().max().item() <= 4e-6 * scale, name
        assert (t.double() - e).abs().max().item() > 1e-4 * scale, name


def _forward_with(q, k, v, matmul, chunk=None):
    """flash_forward_reference's float32 function with both products taken
    by ``matmul``: S = q K^T, and P V with the unnormalised float32 P. With
    ``chunk``, S sums the products of q's and K's column chunks of that
    width one after another, in float32, as the float32 kernel past D = 128
    sums each 64 columns of D in a fresh accumulator."""
    d = q.shape[-1]
    width = chunk or d
    s = matmul(q[..., :width], k[..., :width].transpose(-1, -2))
    for c in range(width, d, width):
        s = s + matmul(q[..., c:c + width],
                       k[..., c:c + width].transpose(-1, -2))
    s = s * (tattn.LOG2E / np.sqrt(d))
    m = s.amax(-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(-1, keepdim=True)
    return matmul(p, v) / l, (m + torch.log2(l)).squeeze(-1)


@pytest.mark.parametrize("shape", [(2, 2, 130, 32), (1, 2, 200, 128),
                                   (1, 1, 130, 264)])
def test_3xtf32_forward_keeps_float32_accuracy(shape):
    """The float32 forward kernels' arithmetic, modelled on the CPU: q K^T
    and P V as three TF32 products each, P split into hi and lo as the
    kernels split it, and past D = 128 the scores summed 64 columns of D at
    a time, as the wide kernel sums them. Against a float64 forward of the
    same inputs and against flash_forward_reference (float32 products), o
    stays within 4e-6 of max |o| (measured: 3.4e-7 / 8.0e-7 / 6.2e-7 from
    float64, 5.7e-7 / 1.6e-6 / 1.1e-6 from the reference at D = 32 / 128 /
    264) and lse2 within 4e-6 (7.7e-7 / 8.7e-7 / 5.7e-7): the card's limits
    of 1e-4 and 1e-3 keep a margin of ~25x and more. One TF32 product alone
    misses it (o 3.5e-4 to 5.4e-4 off)."""
    rng = np.random.default_rng(8)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for _ in range(3))
    chunk = 64 if shape[-1] > 128 else None
    o3, lse3 = _forward_with(q, k, v, _matmul_3xtf32, chunk)
    exact_o, exact_lse = _forward_with(q.double(), k.double(), v.double(),
                                       torch.matmul)
    ref_o, ref_lse = tattn.flash_forward_reference(q, k, v)
    one_o, one_lse = _forward_with(q, k, v, lambda a, b: _tf32(a) @ _tf32(b),
                                   chunk)
    scale = exact_o.abs().max().item()
    assert (o3.double() - exact_o).abs().max().item() <= 4e-6 * scale
    assert (o3 - ref_o).abs().max().item() <= 4e-6 * scale
    assert (lse3.double() - exact_lse).abs().max().item() <= 4e-6
    assert (lse3 - ref_lse).abs().max().item() <= 4e-6
    assert (one_o.double() - exact_o).abs().max().item() > 1e-4 * scale
    assert (one_lse.double() - exact_lse).abs().max().item() > 1e-4


@pytest.mark.parametrize("x, want", [
    (1 + 2 ** -11, 1 + 2 ** -10),             # a tie: away from zero
    (-(1 + 2 ** -11), -(1 + 2 ** -10)),
    (1 + 3 * 2 ** -11, 1 + 2 ** -9),          # a tie: away from zero
    (1 + 2 ** -11 - 2 ** -20, 1.0),           # below the tie
])
def test_tf32_rna_rounding(x, want):
    """The float32 kernels split with cvt.rna (ties away from zero), which
    the pre-pass's plain version models bit for bit."""
    got = tattn._tf32_rna(torch.tensor([x], dtype=torch.float32))
    assert got.item() == want


@pytest.mark.parametrize("shape", [(1, 2, 100, 32), (2, 1, 64, 8),
                                   (1, 1, 1, 16), (1, 1, 130, 128),
                                   (1, 1, 70, 136), (1, 1, 65, 264)])
def test_forward_split_reference_layout(shape):
    """The plain version of the float32 forward's pre-pass, held against
    numpy: q's and K's TF32 hi and lo planes as they are; V^T's with
    position p of each group of 8 holding key {0, 2, 4, 6, 1, 3, 5, 7}[p %
    8] (the order in which P's accumulator columns meet a TF32 A fragment)
    and zeros past S; hi is x rounded to TF32 and hi + lo is x to 2^-21 of
    |x|. The card holds the kernel's pre-pass bit for bit against it."""
    b, h, s, d = shape
    bh, sp = b * h, -(-s // 64) * 64
    q, k, v = _qkv(shape, seed=s + d)
    flat = tattn.flash_forward_split_reference(
        *(torch.from_numpy(t) for t in (q, k, v))).numpy()
    n = bh * 2 * s * d
    assert flat.shape == (2 * n + bh * 2 * d * sp,)
    qp, kp = flat[:n].reshape(bh, 2, s, d), flat[n:2 * n].reshape(bh, 2, s, d)
    vt = flat[2 * n:].reshape(bh, 2, d, sp)
    want_vt = np.zeros((bh, d, sp), np.float32)
    for p in range(sp):
        key = 8 * (p // 8) + (0, 2, 4, 6, 1, 3, 5, 7)[p % 8]
        if key < s:
            want_vt[:, :, p] = v.reshape(bh, s, d)[:, key]
    for planes, want in ((qp, q.reshape(bh, s, d)), (kp, k.reshape(bh, s, d)),
                         (vt, want_vt)):
        hi, lo = planes[:, 0], planes[:, 1]
        assert (hi.view(np.int32) & 0x1FFF == 0).all()
        assert (lo.view(np.int32) & 0x1FFF == 0).all()
        assert (np.abs(want - hi) <= 2.0 ** -11 * np.abs(want)).all()
        assert (np.abs(want - (hi + lo)) <= 2.0 ** -21 * np.abs(want)).all()
