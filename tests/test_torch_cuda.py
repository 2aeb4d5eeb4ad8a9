"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one. The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from ddti_tpu_torch.ops import attention as A
from ddti_tpu_torch.ops import edt as E

pytestmark = pytest.mark.cuda

# bf16 outputs differ from the plain version by bf16 rounding of the
# probability tile (running vs final max); f32 only by summation order
O_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
LSE_TOL = 1e-3
# backward kernels vs plain, relative to each gradient's max |value|: f32
# by summation order, bf16 also by the P and dS roundings landing an ulp
# apart where the two sides' float32 values straddle a bf16 boundary
G_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(shape, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(device, dtype)
            for _ in range(3)]


SHAPES = [
    (2, 8, 1024, 32),   # TransUNet bottleneck at 512^2, depth 4
    (1, 3, 100, 32),    # ragged last query and key tiles
    (2, 2, 333, 64),
    (1, 2, 1000, 128),
    (1, 1, 1, 32),      # a single token
    (2, 4, 65, 32),     # one key past a tile edge
    (2, 4, 200, 8),     # head widths below their padded kernel width
    (1, 8, 1024, 16),
    (2, 3, 300, 24),
    (1, 2, 257, 48),
    (1, 2, 130, 256),   # the widest head
]
# the backward kernels take D <= 128: the forward's shapes but the widest,
# and the widths between
BWD_SHAPES = [s for s in SHAPES if s[3] <= 128] + [
    (1, 2, 190, 40), (1, 2, 130, 56), (1, 2, 200, 72), (1, 2, 129, 80),
    (1, 2, 64, 96), (2, 1, 300, 112), (2, 8, 4096, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", SHAPES)
def test_flash_kernel_matches_plain(cuda, shape, dtype):
    q, k, v = _qkv(shape, dtype, cuda)
    before = A.flash_forward_cuda.launches
    o, lse = A.flash_forward_cuda(q, k, v)
    torch.cuda.synchronize()
    assert A.flash_forward_cuda.launches == before + 1
    o_ref, lse_ref = A.flash_forward_reference(q, k, v)
    assert o.dtype == dtype and o.shape == q.shape
    assert lse.shape == shape[:3] and lse.dtype == torch.float32
    assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
    assert (o.float() - o_ref.float()).abs().max().item() <= O_TOL[dtype]
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL


def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    q, k, v = _qkv((1, 2, 64, 32), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        A.flash_forward_cuda(q.transpose(2, 3).contiguous().transpose(2, 3),
                             k, v)
    for d in (12, 264):
        with pytest.raises(ValueError, match="head dim"):
            A.flash_forward_cuda(*_qkv((1, 2, 64, d), torch.float32, cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        A.flash_forward_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="one CUDA device"):
        A.flash_forward_cuda(q, k.cpu(), v)
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        A.flash_forward_cuda(shifted, k, v)


@pytest.mark.parametrize("shape", [(1, 2, 100, 32), (2, 2, 333, 64),
                                   (1, 2, 130, 128), (2, 4, 200, 8),
                                   (1, 1, 1, 16)])
def test_flash_forward_split_kernel_bit_equal_to_plain(cuda, shape):
    """The float32 forward's pre-pass writes, bit for bit, what its plain
    version builds: q's and K's TF32 hi and lo planes, V^T's in the key
    order {0, 2, 4, 6, 1, 3, 5, 7} with zeros past S (every element of the
    scratch, which starts as NaN)."""
    from ddti_tpu_torch.ops._build import launch

    q, k, v = _qkv(shape, torch.float32, cuda)
    b, h, s, d = shape
    scratch = torch.full((A._split_scratch_size(b * h, s, d),), float("nan"),
                         device=cuda)
    launch("flash_fwd_split_f32", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           scratch.data_ptr(), b * h, s, d, cuda.index or 0,
           A._stream(cuda.index or 0))
    torch.cuda.synchronize()
    assert torch.equal(scratch, A.flash_forward_split_reference(q, k, v))


@pytest.mark.parametrize("shape, key, col", [
    ((1, 1, 100, 32), 45, 3),
    ((1, 1, 70, 64), 66, 60),
    ((1, 1, 130, 128), 121, 127),
    ((1, 1, 100, 128), 14, 64),
])
def test_flash_forward_f32_fragment_layout(cuda, shape, key, col):
    """The float32 forward's TF32 fragment layout, held with V zero but for
    one entry (key ``key``, column ``col``; key % 8 in 1..6, as 0 and 7 are
    where the order {0, 2, 4, 6, 1, 3, 5, 7} keeps a key in place): o's
    column col is then P's column key times that entry and every other
    column is zero, so a key met in the wrong k position of a fragment
    shows as a misplaced probability, not as noise."""
    g = torch.Generator().manual_seed(11)
    q, k = (torch.randn(shape, generator=g) for _ in range(2))
    v = torch.zeros(shape)
    v[0, 0, key, col] = 2.0
    q, k, v = (t.to(cuda) for t in (q, k, v))
    o, lse = A.flash_forward_cuda(q, k, v)
    torch.cuda.synchronize()
    o_ref, lse_ref = A.flash_forward_reference(q, k, v)
    others = torch.ones(shape[-1], dtype=torch.bool)
    others[col] = False
    assert (o[..., others.to(cuda)] == 0).all()
    scale = o_ref.abs().max().item()
    assert scale > 0
    # 3xTF32 products: about 2^-21 of each term
    assert (o - o_ref).abs().max().item() <= 1e-5 * scale
    assert (lse - lse_ref).abs().max().item() <= 1e-5


@pytest.mark.parametrize("shape", [(1, 4, 4096, 32), (1, 2, 2048, 128)])
def test_flash_forward_f32_error_does_not_grow_with_s(cuda, shape):
    """The float32 forward sums each key tile's 3xTF32 P V product in a
    fresh wgmma accumulator and adds it to the output on the CUDA cores, as
    the backward does (the tensor cores' float32 sums round toward zero and
    would drift with S): o within 1e-5 of max |o| and lse2 within 1e-5 at
    S = 4096, as at short S (a CPU model of the arithmetic gives ~1e-6)."""
    q, k, v = _qkv(shape, torch.float32, cuda)
    o, lse = A.flash_forward_cuda(q, k, v)
    torch.cuda.synchronize()
    o_ref, lse_ref = A.flash_forward_reference(q, k, v)
    scale = o_ref.abs().max().item()
    assert (o - o_ref).abs().max().item() <= 1e-5 * scale
    assert (lse - lse_ref).abs().max().item() <= 1e-5


def _edt_masks(n, h, w, seed):
    g = torch.Generator().manual_seed(seed)
    m = torch.rand((n, h, w), generator=g) < 0.02
    yy = torch.arange(h).view(1, h, 1)
    xx = torch.arange(w).view(1, 1, w)
    for i in range(n):
        cy, cx, r = (torch.rand(3, generator=g) * torch.tensor(
            [h, w, max(h, w) / 3.0])).tolist()
        m[i] |= (yy[0] - cy) ** 2 + (xx[0] - cx) ** 2 < r * r
    return m


@pytest.mark.parametrize("shape", [(16, 512, 512), (3, 100, 100),
                                   (2, 333, 333), (4, 64, 100),
                                   (3, 17, 333), (2, 1, 2048), (2, 2048, 1),
                                   (1, 1, 1)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bool, torch.float32])
def test_edt_kernel_bit_equal_to_plain(cuda, shape, dtype):
    m = _edt_masks(*shape, seed=shape[1] + shape[2])
    m[0] = True      # no zero at all: the cap h + w
    if shape[0] > 2:
        m[1] = False  # no foreground: all zeros
    m = m.to(dtype)
    before = E.edt_cuda.launches
    got = E.edt_cuda(m.to(cuda))
    torch.cuda.synchronize()
    assert E.edt_cuda.launches == before + 1
    want = E.edt_reference(m.to(cuda)).cpu()
    assert got.dtype == torch.float32 and got.shape == m.shape
    assert torch.equal(got.cpu(), want)
    assert (want[0] == shape[1] + shape[2]).all()


# csrc/edt.cu's tiling edges: the row pass takes 32 / L rows a warp, four
# warps a block, L lanes a row of a band of columns each (W = 2048: 32
# lanes of 64, a row a warp; W = 512: 16 of 32, two rows; W = 256: 8 of
# 32, four rows; W = 48, 16, 17: 4 of 16, eight rows, lanes without a
# column, odd W), and the frames below give every remainder of N H rows
# by rows a block; the column pass 32 segments of ceil(H / 32) rows (every
# H % 32 from 32 to 63, and 64 rows, 64-bit words, past H = 1024), with
# 4, 2 or 1 mask bytes a thread (the widest whose grid reaches three
# quarters of the SMs: on an H100's 132 SMs, 4 at 40 and 26 frames of 512
# columns, 2 at 20 and 13 and at 5 of 2048, 1 below)
EDT_EDGE_SHAPES = ([(5, 16 + r, 2048) for r in range(16)]
                   + [(5, 32 + r, 48) for r in range(32)]
                   + [(3, 60 + r, 512) for r in range(8)]
                   + [(3, 100 + r, 256) for r in range(16)]
                   + [(5, 2048 - r, w) for r in (0, 1, 31, 33, 63)
                      for w in (16, 17)]
                   + [(5, 2048, 2048), (5, 1025, 2047)]
                   + [(40, 32 + r, 512) for r in (1, 2, 31)]
                   + [(26, 1057, 512), (20, 33, 512), (13, 1057, 512)])


@pytest.mark.parametrize("shape", EDT_EDGE_SHAPES)
def test_edt_kernel_bit_equal_at_its_tiling_edges(cuda, shape):
    """The kernel bit-equal to its plain version on chip_smoke's EDT frames
    (the edge frames first: all zeros, all ones, one zero, one nonzero
    pixel) at every remainder of its row and column tiling."""
    import chip_smoke

    m = chip_smoke.edt_masks(*shape, seed=sum(shape)).to(cuda)
    got = E.edt_cuda(m)
    torch.cuda.synchronize()
    assert torch.equal(got, E.edt_reference(m))


def test_edt_kernel_rejects_what_it_does_not_take(cuda):
    with pytest.raises(ValueError, match="H = 4096"):
        E.edt_cuda(torch.zeros((1, 4096, 8), dtype=torch.uint8, device=cuda))
    with pytest.raises(ValueError, match=r"\(N, H, W\)"):
        E.edt_cuda(torch.zeros((8, 8), dtype=torch.uint8, device=cuda))
    before = E.edt_cuda.launches
    assert E.edt_batch(torch.zeros((0, 8, 8), device=cuda)).shape == (0, 8, 8)
    assert E.edt_cuda.launches == before


def test_flash_attention_dispatches_to_kernel(cuda):
    q, k, v = _qkv((2, 8, 256, 32), torch.bfloat16, cuda)
    before = A.flash_forward_cuda.launches
    with torch.inference_mode():
        o = A.flash_attention(q, k, v)
    assert A.flash_forward_cuda.launches == before + 1
    ref = A.attention_reference(q, k, v)
    assert (o.float() - ref.float()).abs().max().item() <= 2e-2


def _bwd_inputs(shape, dtype, device, seed=0):
    q, k, v = _qkv(shape, dtype, device, seed)
    o, lse = A.flash_forward_reference(q, k, v)
    g = torch.Generator().manual_seed(seed + 1)
    do = torch.randn(shape, generator=g).to(device, dtype)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", BWD_SHAPES)
def test_flash_backward_kernels_match_plain(cuda, shape, dtype):
    args = _bwd_inputs(shape, dtype, cuda)
    bwd = A.flash_backward_cuda
    before = (bwd.launches_dkdv, bwd.launches_dq)
    got = bwd(*args)
    torch.cuda.synchronize()
    assert (bwd.launches_dkdv, bwd.launches_dq) == (before[0] + 1,
                                                    before[1] + 1)
    want = A.flash_backward_reference(*args)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype and a.shape == args[0].shape, name
        assert torch.isfinite(a.float()).all(), name
        scale = b.float().abs().max().item()
        err = (a.float() - b.float()).abs().max().item()
        # an absolute floor for gradients that vanish (a single key: dq = 0)
        assert err <= G_TOL[dtype] * scale + 1e-6, (name, err, scale)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 8, 1024, 32), (1, 2, 1000, 128),
                                   (2, 2, 333, 64)])
def test_flash_kernels_are_deterministic(cuda, shape, dtype):
    """No atomics: two calls give bit-identical o, lse2, dq, dk and dv."""
    q, k, v, _, _, do = _bwd_inputs(shape, dtype, cuda)
    first, again = (A.flash_forward_cuda(q, k, v) for _ in range(2))
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    o, lse = first
    first, again = (A.flash_backward_cuda(q, k, v, o, lse, do)
                    for _ in range(2))
    for a, b in zip(first, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape, row, c_q, c_do", [
    ((1, 1, 64, 32), 5, 3, 7),
    ((1, 1, 100, 32), 90, 30, 1),
    ((1, 1, 70, 64), 63, 17, 60),
    ((1, 1, 100, 128), 42, 127, 64),
])
def test_flash_backward_f32_fragment_layout(cuda, shape, row, c_q, c_do):
    """The float32 kernels' TF32 fragment layout, held with one non-zero
    entry of q and of dO in the same row: dS is then non-zero in that row
    alone, so dV's column c_do is P's row, dK's column c_q is dS's row, and
    dQ's row is dS's row times K; a key placed in the wrong k position of a
    fragment shows as a misplaced value, not as noise."""
    g = torch.Generator().manual_seed(7)
    q = torch.zeros(shape)
    q[0, 0, row, c_q] = 3.0
    do = torch.zeros(shape)
    do[0, 0, row, c_do] = 1.0
    k, v = (torch.randn(shape, generator=g) for _ in range(2))
    q, k, v, do = (t.to(cuda) for t in (q, k, v, do))
    o, lse = A.flash_forward_reference(q, k, v)
    got = A.flash_backward_cuda(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    want = A.flash_backward_reference(q, k, v, o, lse, do)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = b.abs().max().item()
        assert scale > 0, name
        # 3xTF32 products: about 2^-21 of each term
        assert (a - b).abs().max().item() <= 1e-5 * scale, name


@pytest.mark.parametrize("shape", [(1, 4, 4096, 32), (1, 2, 2048, 128)])
def test_flash_backward_f32_error_does_not_grow_with_s(cuda, shape):
    """The float32 kernels sum each streamed tile's 3xTF32 product in a
    fresh wgmma accumulator and add it to the running sum on the CUDA
    cores: the tensor cores' float32 sums round toward zero, and summed
    over a whole long sequence in one accumulator they drift by about
    4e-5 of max |g| at S = 4096 (against about 3e-6 this way)."""
    args = _bwd_inputs(shape, torch.float32, cuda)
    got = A.flash_backward_cuda(*args)
    torch.cuda.synchronize()
    want = A.flash_backward_reference(*args)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        scale = b.abs().max().item()
        assert (a - b).abs().max().item() <= 1e-5 * scale, name


def test_flash_backward_kernels_reject_what_they_do_not_take(cuda):
    args = _bwd_inputs((1, 2, 64, 32), torch.float32, cuda)
    q, k, v, o, lse, do = args
    bwd = A.flash_backward_cuda
    with pytest.raises(ValueError, match="contiguous"):
        bwd(q, k, v, o, lse, do.transpose(2, 3).contiguous().transpose(2, 3))
    for d in (12, 136):
        with pytest.raises(ValueError, match=f"head dim {d}"):
            bwd(*_bwd_inputs((1, 2, 64, d), torch.float32, cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        bwd(q, k, v, o, lse, do.bfloat16())
    with pytest.raises(ValueError, match="lse2"):
        bwd(q, k, v, o, lse.bfloat16(), do)
    with pytest.raises(ValueError, match="one CUDA device"):
        bwd(q, k, v, o.cpu(), lse, do)
    shifted = torch.empty(q.numel() + 1, device=cuda)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        bwd(q, k, v, o, lse, shifted)
    # a width the forward takes but the backward does not fails before the
    # forward when a backward may follow, and passes under no_grad
    wide = [t.requires_grad_() for t in _qkv((1, 2, 64, 256), torch.float32,
                                             cuda)]
    with pytest.raises(ValueError, match="head dim 256: the flash backward"):
        A.flash_attention(*wide)
    with torch.no_grad():
        assert A.flash_attention(*wide).shape == wide[0].shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_dispatches_to_kernels(cuda, dtype):
    """loss.backward() through flash_attention launches each backward
    kernel once, with the gradients of the plain attention's autograd."""
    q, k, v = (t.requires_grad_() for t in _qkv((2, 8, 256, 32), dtype,
                                                cuda))
    w = torch.randn(q.shape, generator=torch.Generator().manual_seed(3)).to(
        cuda, dtype)
    bwd = A.flash_backward_cuda
    before = (A.flash_forward_cuda.launches, bwd.launches_dkdv,
              bwd.launches_dq)
    (A.flash_attention(q, k, v).float() * w.float()).sum().backward()
    torch.cuda.synchronize()
    assert (A.flash_forward_cuda.launches, bwd.launches_dkdv,
            bwd.launches_dq) == tuple(n + 1 for n in before)
    got = [t.grad for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (A.attention_reference(q, k, v).float() * w.float()).sum().backward()
    for a, t in zip(got, (q, k, v)):
        scale = t.grad.float().abs().max().item()
        assert (a.float() - t.grad.float()).abs().max().item() <= \
            2 * G_TOL[dtype] * scale


# ---------------------------------------------------------------------------
# the softmax probes (ddti_tpu_torch/probes) and the DDTI_POLY_EXP2 build

EXP2_EDGES = [0.0, -0.0, float("-inf"), -1e30, -126.5, 127.0, 0.5, 1.5, 2.5,
              -0.5, -1.5, -2.5, -125.5, -127.5, -130.0, 126.5, 1e-40, 3.0,
              -20.0]


@pytest.mark.parametrize("n", [512 * 1024, 4097, 3])
@pytest.mark.parametrize("mode", ["copy", "builtin", "poly4", "poly5",
                                  "poly6"])
def test_exp2_probe_kernel_matches_plain(cuda, mode, n):
    """csrc/exp2_probe.cu against its plain version on the probe's range
    and on edge values (signed zeros, -inf, the -1e30 sentinel, halves,
    both ends of the clamp, a subnormal), with a ragged tail: within 2 ulp,
    the copy bit for bit, no NaN."""
    from ddti_tpu_torch.probes import exp2_probe as E2

    x = torch.cat([torch.tensor(EXP2_EDGES),
                   E2.make_input(1, n, seed=n, device="cpu")[0]])[:n]
    x = x.to(cuda)
    before = E2.exp2_probe_cuda.launches
    y = E2.exp2_probe_cuda(x, mode)
    torch.cuda.synchronize()
    assert E2.exp2_probe_cuda.launches == before + 1
    want = E2.exp2_probe_reference(x, mode)
    assert not torch.isnan(y).any()
    if mode == "copy":
        assert torch.equal(y.view(torch.int32), x.view(torch.int32))
    else:
        assert E2.ulp_distance(y, want) <= 2


@pytest.mark.parametrize("n", [1, 3, 4095, 4096, 4097, 512 * 16384])
@pytest.mark.parametrize("mode", ["copy", "builtin", "poly4", "poly5",
                                  "poly6"])
def test_exp2_probe_kernel_at_its_tile_edges(cuda, mode, n):
    """The kernel at n around the 4,096-float tile and at the probe's
    size: within 2 ulp of the plain version, the copy bit for bit,
    one launch a call."""
    from ddti_tpu_torch.probes import exp2_probe as E2

    x = E2.make_input(1, n, seed=n, device="cpu")[0].to(cuda)
    before = E2.exp2_probe_cuda.launches
    y = E2.exp2_probe_cuda(x, mode)
    torch.cuda.synchronize()
    assert E2.exp2_probe_cuda.launches == before + 1
    if mode == "copy":
        assert torch.equal(y.view(torch.int32), x.view(torch.int32))
    else:
        assert not torch.isnan(y).any()
        assert E2.ulp_distance(y, E2.exp2_probe_reference(x, mode)) <= 2


def test_exp2_probe_rejects_what_it_does_not_take(cuda):
    from ddti_tpu_torch.probes import exp2_probe as E2

    x = torch.zeros(64, device=cuda)
    with pytest.raises(ValueError, match="mode"):
        E2.exp2_probe_cuda(x, "poly7")
    with pytest.raises(ValueError, match="float32"):
        E2.exp2_probe_cuda(x.half(), "copy")
    with pytest.raises(ValueError, match="contiguous"):
        E2.exp2_probe_cuda(x.view(8, 8).t(), "copy")


MSKIP_SHAPES = [(1, 4, 4096, 32), (1, 3, 1000, 32), (2, 2, 333, 64),
                (1, 2, 1000, 128), (1, 2, 130, 256), (1, 1, 1, 32)]


@pytest.mark.parametrize("shape", MSKIP_SHAPES)
def test_mskip_kernel_bit_equal_to_forward(cuda, shape):
    """The m-skip forward's o and lse2 are the production forward's bit for
    bit (exp2(0) == 1), at S = 4096, ragged S and every padded head width;
    within the forward's limits of its plain version."""
    from ddti_tpu_torch.probes import flash_mskip_ab as MS

    q, k, v = _qkv(shape, torch.bfloat16, cuda)
    before = MS.flash_forward_mskip_cuda.launches
    o, lse = MS.flash_forward_mskip_cuda(q, k, v)
    o0, lse0 = A.flash_forward_cuda(q, k, v)
    torch.cuda.synchronize()
    assert MS.flash_forward_mskip_cuda.launches == before + 1
    assert torch.equal(o, o0) and torch.equal(lse, lse0)
    o_ref, lse_ref = MS.flash_forward_mskip_reference(q, k, v)
    assert (o.float() - o_ref.float()).abs().max().item() <= \
        O_TOL[torch.bfloat16]
    assert (lse - lse_ref).abs().max().item() <= LSE_TOL


def test_mskip_kernel_rejects_float32(cuda):
    from ddti_tpu_torch.probes import flash_mskip_ab as MS

    q, k, v = _qkv((1, 2, 64, 32), torch.float32, cuda)
    with pytest.raises(ValueError, match="bfloat16"):
        MS.flash_forward_mskip_cuda(q, k, v)


POLY_CHECK = """
import torch
torch.backends.cuda.matmul.allow_tf32 = False
from ddti_tpu_torch.ops import _build, attention as A
assert _build.USE_POLY_EXP2 and A.USE_POLY_EXP2
O_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
for shape in [(2, 8, 1024, 32), (1, 3, 100, 32), (1, 2, 1000, 128),
              (2, 2, 333, 64), (1, 2, 130, 256)]:
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator().manual_seed(0)
        q, k, v, do = (torch.randn(shape, generator=g).to("cuda", dtype)
                       for _ in range(4))
        o, lse = A.flash_forward_cuda(q, k, v)
        o_ref, lse_ref = A.flash_forward_reference(q, k, v)
        assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
        assert (o.float() - o_ref.float()).abs().max() <= O_TOL[dtype]
        assert (lse - lse_ref).abs().max() <= 1e-3
        if shape[3] > 128:
            continue
        got = A.flash_backward_cuda(q, k, v, o, lse, do)
        want = A.flash_backward_reference(q, k, v, o, lse, do)
        for a, b in zip(got, want):
            assert torch.isfinite(a.float()).all()
            err = (a.float() - b.float()).abs().max()
            assert err <= O_TOL[dtype] * b.float().abs().max() + 1e-6
print("poly ok")
"""


def test_poly_build_kernels_match_plain_in_poly_mode(cuda):
    """With DDTI_POLY_EXP2=1 (a process of its own: the flag is read at
    import and picks its own library) the flash forward and backward
    kernels meet today's limits against their plain versions in poly mode,
    with no NaN, at the slice's shape, ragged S and every head width."""
    import os
    import pathlib
    import subprocess
    import sys

    res = subprocess.run(
        [sys.executable, "-c", POLY_CHECK], capture_output=True, text=True,
        cwd=pathlib.Path(__file__).resolve().parents[1], timeout=900,
        env={**os.environ, "DDTI_POLY_EXP2": "1"})
    assert res.returncode == 0 and "poly ok" in res.stdout, \
        res.stdout[-2000:] + res.stderr[-4000:]


# the warp-gather probes (probes/gather_probe*.py, csrc/gather_probe.cu)

def _bits(t):
    return t.contiguous().view(torch.int32)


# (src shape, idx shape, mode): the builders' shapes (A-C and B2 shared
# across a batch, F and P4-P6 2-D), per-image indices, an index plane of
# another size than the image, and odd sizes that take the scalar path
GATHER_CASES = [
    ((16, 256, 256), (256, 256), "flat"),
    ((16, 256, 256), (256, 256), 0),
    ((16, 256, 256), (256, 256), 1),
    ((2048, 128), (2048, 128), 0),
    ((8, 128), (8, 128), 0),
    ((512, 128), (512, 128), 0),
    ((256, 256), (256, 256), 1),
    ((3, 40, 24), (3, 40, 24), "flat"),
    ((3, 40, 24), (3, 17, 24), 0),
    ((3, 40, 24), (3, 40, 9), 1),
    ((5, 7, 5), (7, 5), 0),
    ((5, 7, 5), (3, 3), "flat"),
]


def _gather_inputs(src_shape, idx_shape, mode, seed=0):
    g = torch.Generator().manual_seed(seed)
    src = torch.rand(src_shape, generator=g)
    r, c = src_shape[-2:]
    length = r * c if mode == "flat" else (r, c)[mode]
    idx = torch.randint(0, length, idx_shape, generator=g,
                        dtype=torch.int32)
    return src, idx, length


@pytest.mark.parametrize("src_shape, idx_shape, mode", GATHER_CASES)
def test_gather_kernel_bit_equal_to_plain(cuda, src_shape, idx_shape, mode):
    """csrc/gather_probe.cu against its plain version, bit for bit, with
    edge indices planted: -1 and -len wrap, len and -len - 1 give NaN (the
    NaN's bits included); two calls give equal bits."""
    from ddti_tpu_torch.probes import gather_probe as G

    src, idx, length = _gather_inputs(src_shape, idx_shape, mode)
    flat = idx.view(-1)
    edges = torch.tensor([-1, -length, length, -length - 1, length - 1, 0],
                         dtype=torch.int32)
    flat[:min(len(edges), flat.numel())] = edges[:flat.numel()]
    s, i = src.to(cuda), idx.to(cuda)
    before = G.gather_cuda.launches
    out = G.gather_cuda(s, i, mode)
    again = G.gather_cuda(s, i, mode)
    torch.cuda.synchronize()
    assert G.gather_cuda.launches == before + 2
    want = G.gather_reference(src, idx, mode)
    assert out.shape == want.shape
    assert torch.equal(_bits(out).cpu(), _bits(want))
    assert torch.equal(_bits(out), _bits(again))
    assert torch.isnan(out).sum().item() == torch.isnan(want).sum().item()


def test_gather_builders_through_the_kernel(cuda):
    """Every kernel builder of the three probes (A, B, C, B2, F, P4, P5,
    P6) at a batch of 4 equals the probes' numpy want."""
    from ddti_tpu_torch.probes import gather_probe as G
    from ddti_tpu_torch.probes import gather_probe2 as G2
    from ddti_tpu_torch.probes import gather_probe3 as G3

    table = dict(G.builders(4))
    table.update(G2.builders(4)[0])
    table.update(G3.builders(4)[1])
    assert len(table) == 8
    for name, (src, idx, mode, want) in table.items():
        out = G.gather_cuda(torch.from_numpy(src).to(cuda),
                            torch.from_numpy(idx).to(cuda), mode)
        assert np.array_equal(out.cpu().numpy(), want), name


@pytest.mark.parametrize("name", [
    "rows at cap", "rows past cap", "flat at cap", "flat past cap",
    "0 edges staged", "flat edges staged", "0 per-image", "flat per-image"])
def test_gather_staged_path_edges(cuda, name):
    """The flat and row modes' staged path at its edges
    (``gather_probe.window_cases``): a window of exactly the cap in every
    tile stages and one a step past it does not; wrapping and out-of-range
    indices inside a staged tile; per-image index planes. Bit for bit
    against the plain version, and the kernel's count of staged (tile,
    image) pairs equal to ``plan_windows``'."""
    from ddti_tpu_torch.probes import gather_probe as G

    src, idx, mode = G.window_cases()[name]
    s, i = torch.from_numpy(src).to(cuda), torch.from_numpy(idx).to(cuda)
    out, count = G.staged_count(s, i, mode)
    want = G.gather_reference(s, i, mode)
    assert torch.equal(_bits(out), _bits(want))
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    plan = G.planned_staged(idx, src.shape[0], *src.shape[-2:], mode,
                            sms=sms)
    assert count == plan
    assert (plan > 0) == ("past cap" not in name)


def test_gather_builders_staged_as_planned(cuda):
    """Every kernel builder at a batch of 9 (16 tiles x 9 images, more
    pairs than SMs) and F at the probe's own (2048, 128): the kernel's
    staged (tile, image) pairs equal the plan; A, B and B2 stage every
    tile, C, F and P4-P6 none."""
    from ddti_tpu_torch.probes import gather_probe as G
    from ddti_tpu_torch.probes import gather_probe2 as G2
    from ddti_tpu_torch.probes import gather_probe3 as G3

    table = dict(G.builders(9))
    table.update(G2.builders(9)[0])
    table.update(G3.builders(9)[1])
    f = "F  pallas dyn_gather lanes "
    table[f] = G2.builders()[0][f]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    counts = {}
    for name, (src, idx, mode, want) in table.items():
        s, i = torch.from_numpy(src).to(cuda), torch.from_numpy(idx).to(cuda)
        out, counts[name.split()[0]] = G.staged_count(s, i, mode)
        assert np.array_equal(out.cpu().numpy(), want), name
        n = src.shape[0] if src.ndim == 3 else 1
        assert counts[name.split()[0]] == G.planned_staged(
            idx, n, *src.shape[-2:], mode, sms=sms), name
    assert counts["A"] == counts["B"] == counts["B2"] == 16 * 9
    assert all(counts[k] == 0 for k in ("C", "F", "P4", "P5", "P6"))


def test_gather_kernel_rejects_what_it_does_not_take(cuda):
    from ddti_tpu_torch.probes import gather_probe as G

    src = torch.rand((2, 8, 8), device=cuda)
    idx = torch.zeros((8, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        G.gather_cuda(src.double(), idx, 0)
    with pytest.raises(ValueError, match="int32"):
        G.gather_cuda(src, idx.long(), 0)
    with pytest.raises(ValueError, match="contiguous"):
        G.gather_cuda(src.transpose(1, 2), idx, 0)
    with pytest.raises(ValueError, match="CUDA"):
        G.gather_cuda(src, idx.cpu(), 0)
    with pytest.raises(ValueError, match="axis"):
        G.gather_cuda(src, idx[:, :5].contiguous(), 0)
    with pytest.raises(ValueError, match="mode"):
        G.gather_cuda(src, idx, 2)


# the conv3x3 + bias + ReLU probe (probes/pallas_conv_probe.py,
# csrc/conv3x3.cu)

CONV_SHAPES = [
    (2, 16, 16, 128, 128),   # the TPU probe's CPU shape
    (8, 128, 128, 128, 128),  # the probe's level at a batch of 8
    (3, 10, 12, 64, 96),     # ragged: H, W off every tile, CO = 96
    (1, 1, 1, 32, 8),        # one pixel: only the centre tap
    (2, 33, 7, 64, 200),     # CO past a 128-channel tile, odd W
    (2, 16, 5, 64, 64),      # W below the kernel's 8-column tile
    (3, 21, 13, 64, 64),     # H and W off every tile
    (2, 9, 1, 64, 64),       # W = 1
    (1, 4, 300, 64, 64),     # one image, 300 wide
    (2, 20, 20, 32, 64),     # C = 32: the 32-channel box
    (2, 20, 20, 96, 128),    # C = 96: the 32-channel box, three of them
    (2, 16, 16, 64, 8),      # CO = 8
    (2, 16, 16, 64, 136),    # CO = 136
    (3, 16, 24, 64, 64),     # 9 pixel tiles, an odd count
]


@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv3x3_kernel_matches_plain(cuda, shape):
    """csrc/conv3x3.cu against its plain version: every element within one
    bf16 ulp of the larger value or 2^-8 max|y| (the ReLU edge); two calls
    give equal bits."""
    from ddti_tpu_torch.probes import pallas_conv_probe as P

    n, h, w, c, co = shape
    torch.backends.cuda.matmul.allow_tf32 = False
    x, wk, b = P.make_inputs(n, max(h, w), c, co, device=cuda)
    x = x[:, :h, :w].contiguous()
    wt = P.pack_weights(wk)
    before = P.conv3x3_relu_cuda.launches
    y = P.conv3x3_relu_cuda(x, wt, b)
    again = P.conv3x3_relu_cuda(x, wt, b)
    torch.cuda.synchronize()
    assert P.conv3x3_relu_cuda.launches == before + 2
    assert y.shape == (n, h, w, co) and y.dtype == torch.bfloat16
    want = P.conv3x3_relu_reference(x, wk, b)
    ok, err, share = P.within_tolerance(y, want)
    assert ok, (err, share)
    assert torch.equal(y, again)
    assert torch.isfinite(y.float()).all()


def test_conv3x3_error_does_not_grow_with_c(cuda, capsys):
    """K = 9 C reaches 4608 at C = 512, and the tensor cores' float32
    accumulation rounds toward zero: the kernel sums each chunk of 32 in a
    fresh accumulator and adds it on the CUDA cores. On inputs whose bias
    cancels a sum of K positive products (``cancelling_inputs``) every
    interior output is ~1 and carries the sum's whole float32 error: within
    CANCEL_LIMIT (2^-5) of the exact value at every C, as the plain version
    is: the chunks' rounded sum wanders by up to 7.5e-3 at C = 512, one
    truncating accumulator would drift by ~0.07. On the probe's random
    inputs every C stays within the tolerance."""
    from ddti_tpu_torch.probes import pallas_conv_probe as P

    torch.backends.cuda.matmul.allow_tf32 = False
    for c in (64, 128, 256, 512):
        x, wk, b, exact = P.cancelling_inputs(2, 16, c, seed=c, device=cuda)
        y = P.conv3x3_relu_cuda(x, P.pack_weights(wk), b).float()
        plain = P.conv3x3_relu_reference(x, wk, b).float()
        err = (y[:, 1:-1, 1:-1] - exact.float()).abs().max().item()
        err_plain = (plain[:, 1:-1, 1:-1] - exact.float()).abs().max().item()
        assert max(err, err_plain) <= P.CANCEL_LIMIT, (c, err, err_plain)
        # a border pixel misses at least three taps: its sum lies below -b
        assert (y[:, 0] == 0).all() and (y[:, :, -1] == 0).all()
        x, wk, b = P.make_inputs(4, 32, c, device=cuda, seed=c)
        ok, d, share = P.within_tolerance(
            P.conv3x3_relu_cuda(x, P.pack_weights(wk), b),
            P.conv3x3_relu_reference(x, wk, b))
        with capsys.disabled():
            print(f"conv3x3 C = CO = {c}: cancelling sum off exact by "
                  f"{err:.3e} (plain {err_plain:.3e}); random inputs max|d| "
                  f"{d:.3e}, {share:.3e} of elements differ")
        assert ok, (c, d)


def test_conv3x3_kernel_rejects_unaligned_pointers(cuda):
    """TMA reads x and the weights: the wrapper refuses a pointer that is
    not 16-byte aligned."""
    from ddti_tpu_torch.probes import pallas_conv_probe as P

    x, wk, b = P.make_inputs(1, 8, 64, device=cuda)
    wt = P.pack_weights(wk)
    xs = torch.empty(x.numel() + 8, dtype=x.dtype, device=cuda)
    xs = xs[8:].view(x.shape)  # 16 bytes in: aligned
    assert P.conv3x3_relu_cuda(xs.copy_(x), wt, b).shape == (1, 8, 8, 64)
    xu = torch.empty(x.numel() + 1, dtype=x.dtype, device=cuda)[1:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        P.conv3x3_relu_cuda(xu.view(x.shape).copy_(x), wt, b)
    wu = torch.empty(wt.numel() + 4, dtype=wt.dtype, device=cuda)[4:]
    with pytest.raises(ValueError, match="16-byte aligned"):
        P.conv3x3_relu_cuda(x, wu.view(wt.shape).copy_(wt), b)


def test_conv3x3_kernel_rejects_what_it_does_not_take(cuda):
    from ddti_tpu_torch.probes import pallas_conv_probe as P

    x, wk, b = P.make_inputs(1, 8, 64, device=cuda)
    wt = P.pack_weights(wk)
    with pytest.raises(ValueError, match="C % 32"):
        x48, wk48, b48 = P.make_inputs(1, 8, 48, device=cuda)
        P.conv3x3_relu_cuda(x48, P.pack_weights(wk48), b48)
    with pytest.raises(ValueError, match="CO % 8"):
        xc, wkc, bc = P.make_inputs(1, 8, 64, 60, device=cuda)
        P.conv3x3_relu_cuda(xc, P.pack_weights(wkc), bc)
    with pytest.raises(ValueError, match="bfloat16"):
        P.conv3x3_relu_cuda(x.float(), wt, b)
    with pytest.raises(ValueError, match="float32"):
        P.conv3x3_relu_cuda(x, wt, b.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        P.conv3x3_relu_cuda(x.transpose(1, 2), wt, b)
    with pytest.raises(ValueError, match="CUDA"):
        P.conv3x3_relu_cuda(x, wt.cpu(), b)
    with pytest.raises(ValueError, match="do not fit"):
        P.conv3x3_relu_cuda(x, wt[:, :-32].contiguous(), b)


# the rest of the zoo at a small width: float32 on the card (TF32 off) vs
# the CPU, relative to the largest logit; summation order alone differs
ZOO_CASES = [("UNet", {}), ("ASPPUNet", {}), ("AttentionUNet", {}),
             ("VNet2D", {}), ("ImprovedVNet", {"deep_supervision": True}),
             ("ImprovedVNet", {"use_attention": False})]
ZOO_RTOL = 1e-4


def _zoo_model(model_type, kw):
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    m = init_like_flax(create_model(model_type, base_filters=8, depth=3,
                                    **kw), 0)
    g = torch.Generator().manual_seed(1)
    for name, buf in m.named_buffers():  # BN statistics off (0, 1)
        if name.endswith("running_mean"):
            buf.copy_(torch.randn(buf.shape, generator=g) * 0.2)
        elif name.endswith("running_var"):
            buf.copy_(torch.rand(buf.shape, generator=g) + 0.5)
    return m.eval()


def _outs(out):
    return [out[0], *out[1]] if isinstance(out, tuple) else [out]


@pytest.mark.parametrize("size", [64, 36])
@pytest.mark.parametrize("model_type, kw", ZOO_CASES)
def test_zoo_forward_on_card_matches_cpu(cuda, model_type, kw, size):
    """Each zoo model's float32 eval forward (every deep-supervision head
    too) on the card against its CPU forward; at 36^2 the strided models
    pad their down-convs and resize down, and ImprovedVNet's gates refuse
    the 10^2 map against a 9^2 skip on both devices."""
    m = _zoo_model(model_type, kw)
    x = torch.randn(2, 1, size, size, generator=torch.Generator()
                    .manual_seed(2))
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            if (size % 8 and model_type == "ImprovedVNet"
                    and kw.get("use_attention", True)):
                for dev in ("cpu", "cuda"):
                    with pytest.raises(RuntimeError, match="size of tensor"):
                        m.to(dev)(x.to(dev))
                return
            want = _outs(m(x))
            got = _outs(m.to(cuda)(x.to(cuda)))
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_cuda
        rel = float((g.cpu() - w).abs().max() / w.abs().max())
        assert rel < ZOO_RTOL, rel


# the inference path: BatchNorm folding and flip TTA on the card against
# the CPU, float32 with TF32 off; the TransUNet at 1024 bottleneck tokens
# takes the flash kernel on the card and the plain path on the CPU
INFER_CASES = [("AttentionUNet", {}, 64),
               ("ImprovedVNet", {"deep_supervision": True}, 64),
               ("TransUNet", dict(image_size=128, embed_dim=64, num_heads=2,
                                  num_transformer_layers=1), 128)]


def _infer_model(model_type, kw):
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    depth = 2 if model_type == "TransUNet" else 3
    m = init_like_flax(create_model(model_type, base_filters=8, depth=depth,
                                    **kw), 0)
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, t in m.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(torch.rand(t.shape, generator=g) + 0.5)
            elif name.endswith(("running_mean", "bias")):
                t.copy_(torch.randn(t.shape, generator=g) * 0.2)
    return m.eval()


@pytest.mark.parametrize("model_type, kw, size", INFER_CASES)
def test_fold_batchnorm_on_card_matches_cpu(cuda, model_type, kw, size):
    """``fold_batchnorm`` on the card (its own check runs there) gives the
    CPU's folded weights to float32 rounding, and logits within ZOO_RTOL
    of the CPU's folded model."""
    from ddti_tpu_torch.ops import attention
    from ddti_tpu_torch.train.fold_bn import fold_batchnorm

    m = _infer_model(model_type, kw)
    cpu = fold_batchnorm(m)
    launches = attention.flash_forward_cuda.launches
    card = fold_batchnorm(m.to(cuda))
    if model_type == "TransUNet":  # its check ran both models on the card
        assert attention.flash_forward_cuda.launches == launches + 2
    for k, v in cpu.state_dict().items():
        w = card.state_dict()[k]
        assert w.is_cuda
        torch.testing.assert_close(w.cpu(), v, rtol=1e-6, atol=1e-7)
    x = torch.rand(2, 1, size, size, generator=torch.Generator()
                   .manual_seed(3))
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = _outs(cpu(x))[0]
            got = _outs(card(x.to(cuda)))[0]
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    rel = float((got.cpu() - want).abs().max() / want.abs().max())
    assert rel < ZOO_RTOL, rel


@pytest.mark.parametrize("model_type, kw, size", INFER_CASES)
def test_tta_logits_on_card_match_cpu(cuda, model_type, kw, size):
    """``tta_logits`` of one model on the card (four forwards; the
    TransUNet's through the flash kernel, 1 launch a forward) against the
    CPU's, within ZOO_RTOL of the largest."""
    from ddti_tpu_torch.eval.tta import tta_logits
    from ddti_tpu_torch.ops import attention

    m = _infer_model(model_type, kw)
    x = torch.rand(2, size, size, 1, generator=torch.Generator()
                   .manual_seed(4))

    def fwd(model):
        return lambda t: _outs(model(t.permute(0, 3, 1, 2)))[0].permute(
            0, 2, 3, 1)

    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            want = tta_logits(fwd(m), x)
            launches = attention.flash_forward_cuda.launches
            got = tta_logits(fwd(m.to(cuda)), x.to(cuda))
            n = attention.flash_forward_cuda.launches - launches
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    assert n == (4 if model_type == "TransUNet" else 0)
    assert got.is_cuda and torch.isfinite(got).all()
    rel = float((got.cpu() - want).abs().max() / want.abs().max())
    assert rel < ZOO_RTOL, rel


# ---------------------------------------------------------------- lifecycle

def _cuda_state(cuda, seed, ema=True):
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.state import TrainState
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    m = init_like_flax(create_model("UNet", base_filters=8, depth=3),
                       seed).to(cuda)
    return TrainState(m, 1e-3, 4, model_type="UNet", ema=ema)


def _step_all(state, seed):
    g = torch.Generator().manual_seed(seed)
    for p in state.trainable:
        p.grad = torch.randn(p.shape, generator=g).to(p.device)
    state.apply_gradients()
    state.update_ema(0.9)


def _tensors(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tensors(v, f"{prefix}/{k}")
        elif isinstance(v, torch.Tensor):
            yield f"{prefix}/{k}", v


@pytest.mark.parametrize("ema", [False, True])
def test_full_state_roundtrip_on_cuda(cuda, tmp_path, ema):
    """A train state on the card saved and restored into another: every
    parameter, statistic, AdamW moment, step and EMA tensor bit-equal,
    the moments and the shadow on the card, AdamW's step where torch keeps
    it (the CPU); one more update equal on both."""
    from ddti_tpu_torch.train import checkpoint as ck

    st = _cuda_state(cuda, 0, ema)
    for i in range(3):
        _step_all(st, i)
    ck.save_checkpoint(str(tmp_path / "s"), st)
    fresh = ck.restore_checkpoint(str(tmp_path / "s"),
                                  _cuda_state(cuda, 1, ema))
    want = dict(_tensors(st.full_state_dict()))
    got = dict(_tensors(fresh.full_state_dict()))
    assert want.keys() == got.keys() and fresh.step == st.step == 3
    for k, v in want.items():
        assert got[k].device == v.device, k
        assert torch.equal(got[k], v), k
    assert any(k.endswith("/exp_avg") and v.is_cuda for k, v in got.items())
    _step_all(st, 9)
    _step_all(fresh, 9)
    for k, v in dict(_tensors(st.full_state_dict())).items():
        assert torch.equal(dict(_tensors(fresh.full_state_dict()))[k], v), k


def test_best_save_snapshot_on_cuda():
    """The async best saver's copies are made on the training stream before
    the next in-place update and read back on a side stream: the values at
    the save, not after."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ddti_tpu_torch.train.engine import _DeviceSnapshot

    x = torch.arange(1 << 20, device="cuda", dtype=torch.float32)
    snap = _DeviceSnapshot({"w": x, "nested": {"v": x * 2}})
    torch.cuda._sleep(10_000_000)  # the stream still busy at the update
    x.add_(1.0)
    host = snap.to_host()
    assert not host["w"].is_cuda
    assert torch.equal(host["w"], torch.arange(1 << 20, dtype=torch.float32))
    assert torch.equal(host["nested"]["v"], 2 * host["w"])


# the legacy slice: MoresTransUNet's 1024-token bottleneck through
# the flash kernel in eval, and LegacyUNet's train step through the EDT
MORES_TRANS = dict(features=(8, 16), trans_dim=64, num_heads=2, num_layers=2,
                   image_size=128)


def test_mores_transunet_forward_flash_kernel_matches_plain(cuda):
    """MoresTransUNet at 128^2 with features (8, 16): 32 x 32 = 1024
    tokens, heads of 32, so its eval forward takes the gate; float32 (TF32
    off) through the flash kernel, one launch a layer, against the same
    weights on the plain attention path on the card and on the CPU, within
    1e-4 of the largest logit (the serving limit is 1e-3)."""
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    m = init_like_flax(create_model("MoresTransUNet", **MORES_TRANS), 0)
    plain = create_model("MoresTransUNet", use_flash_attention=False,
                         **MORES_TRANS)
    plain.load_state_dict(m.state_dict())
    x = torch.rand(2, 1, 128, 128, generator=torch.Generator().manual_seed(3))
    cudnn_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            want_cpu = plain.eval()(x)
            want = plain.to(cuda)(x.to(cuda))
            before = A.flash_forward_cuda.launches
            got = m.eval().to(cuda)(x.to(cuda))
            launched = A.flash_forward_cuda.launches - before
    finally:
        torch.backends.cudnn.allow_tf32 = cudnn_tf32
    assert launched == MORES_TRANS["num_layers"]
    for w in (want.cpu(), want_cpu):
        rel = float((got.cpu() - w).abs().max() / w.abs().max())
        assert rel < 1e-4, rel


def test_legacy_unet_step_edt_kernel_matches_plain(cuda):
    """One float32 LegacyUNet train step at 64^2, batch 2, from one state
    and batch with the kernel EDT (one launch) and with the plain EDT:
    bit-equal boundary terms and updated parameters within 1e-6
    (deterministic cuDNN, so only the EDT route differs)."""
    from ddti_tpu_torch.core.config import Config
    from ddti_tpu_torch.data.augment import AugmentConfig, sample_draws
    from ddti_tpu_torch.data.dataset import synthetic_source
    from ddti_tpu_torch.losses import losses
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.state import TrainState
    from ddti_tpu_torch.train.steps import make_train_step
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    size, batch = 64, 2
    cfg = Config(image_size=size, store_size=size, batch_size=batch)
    aug = AugmentConfig(out_size=(size, size))
    model = init_like_flax(create_model("LegacyUNet"), 0).to(cuda)
    images, masks = synthetic_source(batch, (size, size), 0,
                                     device=cuda).gather([0, 1])
    draws = sample_draws(torch.Generator().manual_seed(0), batch, aug,
                         (size, size)).to(cuda)
    step = make_train_step(cfg, aug)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for route in ("kernel", "plain"):
            model.load_state_dict(sd0)
            before = E.edt_cuda.launches
            if route == "plain":
                losses.edt_batch = E.edt_reference
            m = step(TrainState(model, 1e-5, 4), images, masks, draws, None)
            torch.cuda.synchronize()
            assert E.edt_cuda.launches - before == (route == "kernel")
            out[route] = (m.boundary.clone(), {
                k: v.clone() for k, v in model.state_dict().items()})
    finally:
        losses.edt_batch = E.edt_batch
        torch.backends.cudnn.deterministic = det
    (bk, pk), (bp, pp) = out["kernel"], out["plain"]
    assert torch.equal(bk, bp) and float(bk) > 0
    for k in pk:
        rel = float((pk[k] - pp[k]).abs().max()
                    / pp[k].abs().max().clamp(min=1e-30))
        assert rel <= 1e-6, (k, rel)


def _tiny_trainer(tmp_path, name, sd0, remat=False, **kw):
    """A ResUNet (base 4, depth 2; ``remat`` its kwarg) Trainer on the
    card over a 12-frame 32^2 store: 3 steps of 4 an epoch."""
    import os

    from ddti_tpu_torch.core.config import Config
    from ddti_tpu_torch.core.logging import create_logger
    from ddti_tpu_torch.data.dataset import synthetic_source
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.engine import Trainer

    cfg = Config(model_type="ResUNet", image_size=32, store_size=32,
                 batch_size=4, epochs=2, log_every=0, lr=1e-3,
                 base_dir=str(tmp_path / name), **kw)
    cfg.make_dirs()
    src = synthetic_source(12, (32, 32), 3, device="cuda")
    model = create_model("ResUNet", base_filters=4, depth=2, remat=remat)
    model.load_state_dict(sd0)
    return Trainer(cfg, (src, src, src), create_logger(
        os.path.join(cfg.log_dir, "log.txt"), console=False),
        model.to("cuda"))


@pytest.mark.parametrize("kw", [
    {}, dict(grad_accum=2, ema_decay=0.9, clip_grad_norm=0.5, nan_guard=True,
             use_mixup=True, mixup_prob=1.0, p_crop=0.5, use_tgc=True),
    dict(remat=True, freeze="encoders_0", freeze_bn_stats=True),
    dict(use_elastic=True, use_speckle=True, use_clahe=True)],
    ids=["default", "options", "remat", "gated branches"])
def test_fused_epoch_is_the_stepwise_loop_on_the_card(cuda, tmp_path, kw):
    """Two epochs as CUDA graphs (an eager step, then replays) against the
    stepwise loop, cuDNN deterministic: every parameter and statistic bit
    for bit, the replays counted; the EDT's wrapper counts the eager
    step's launch and the capture's, a replay none."""
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    sd0 = init_like_flax(create_model("ResUNet", base_filters=4, depth=2),
                         0).state_dict()
    torch.backends.cudnn.deterministic = True
    try:
        ends = []
        for name, fused in (("fused", True), ("loop", False)):
            tr = _tiny_trainer(tmp_path, name, sd0, fused_epoch=fused, **kw)
            assert tr.fused == fused and tr.state.capturable
            before = E.edt_cuda.launches
            for epoch in range(2):
                tr.train_one_epoch(epoch)
            torch.cuda.synchronize()
            assert E.edt_cuda.launches - before == (4 if fused else 6) * int(
                kw.get("grad_accum", 1))
            if fused:
                assert tr.fused_stats == {"captured": 1, "replays": 2}
            ends.append({k: v.clone() for k, v in
                         tr.model.state_dict().items()})
            assert tr.state.step == 6
    finally:
        torch.backends.cudnn.deterministic = False
    for k in ends[0]:
        assert torch.equal(ends[0][k], ends[1][k]), k


@pytest.mark.parametrize("exact", [False, True])
def test_batchnorm_on_card_matches_cpu(cuda, exact):
    """Train-mode BatchNorm of a channels-last bf16 activation (as cuDNN's
    convolutions leave it) on the card against the CPU's float32 input:
    output, running statistics and input gradient."""
    from ddti_tpu_torch.models import blocks

    g = torch.Generator().manual_seed(1)
    x = (torch.randn(4, 16, 12, 12, generator=g) * 2 + 1).bfloat16()
    r = torch.randn(4, 16, 12, 12, generator=g)
    outs = []
    for dev, xin in (("cuda", x.to("cuda").contiguous(
            memory_format=torch.channels_last)), ("cpu", x.float())):
        bn = blocks.BatchNorm2d(16).to(dev)
        bn.exact_variance = exact
        xin = xin.detach().requires_grad_()
        y = bn.train()(xin)
        (y.float() * r.to(dev)).sum().backward()
        outs.append([t.detach().float().cpu() for t in (
            y, bn.running_mean, bn.running_var, xin.grad)])
    (yc, mc, vc, gc), (y0, m0, v0, g0) = outs
    assert (yc - y0).abs().max() <= 2 ** -7 * y0.abs().max()
    torch.testing.assert_close(mc, m0, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(vc, v0, rtol=1e-5, atol=1e-6)
    assert (gc - g0).norm() <= 1e-2 * g0.norm()


def test_autobatch_probe_counts_the_fused_graph_pool(cuda):
    """Under --fused_epoch the probe also captures its step: its peak is
    at least the eager step's, which the stepwise probe reports."""
    import dataclasses

    from ddti_tpu_torch.core.config import Config
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.autobatch import measured_step_peak_bytes

    model = create_model("ResUNet", base_filters=4, depth=2).to("cuda")
    cfg = Config(model_type="ResUNet", image_size=32, store_size=32,
                 batch_size=8, use_elastic=True)
    eager = measured_step_peak_bytes(cfg, model, 8)
    fused = measured_step_peak_bytes(
        dataclasses.replace(cfg, fused_epoch=True), model, 8)
    assert 0 < eager <= fused


# ---------------------------------------------------------------------------
# the int8 serving conv (csrc/conv_s8.cu)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("geo", [g[0] for g in __import__(
    "ddti_tpu_torch.ops.conv_s8", fromlist=["x"]).ZOO_GEOMETRIES])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("hw", [(17, 16), (32, 32)])
def test_conv_s8_kernel_is_its_plain_version(cuda, geo, bf16, hw):
    """Every zoo geometry, odd and even sides: s32 sums and the dequantized
    output bit for bit, two calls bit-equal."""
    from ddti_tpu_torch.ops import conv_s8 as Q

    name, k, s, d, pad, c, cout = next(g for g in Q.ZOO_GEOMETRIES
                                       if g[0] == geo)
    rng = np.random.default_rng(sum(map(ord, geo)))
    h, w = hw
    x = torch.from_numpy(rng.integers(-127, 128, (2, h, w, c)
                                      ).astype(np.int8))
    wq = torch.from_numpy(rng.integers(-127, 128, (k, k, c, cout)
                                       ).astype(np.int8))
    sx = torch.tensor(np.float32(0.0137))
    sw = torch.from_numpy(rng.uniform(1e-4, 2e-2, cout).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=cout).astype(np.float32))
    pt, pl, oh, ow = Q.conv_geometry(h, w, k, s, d, pad)
    geo_args = (s, d, pt, pl, oh, ow, pad == "T", bf16)
    want = Q.conv_s8_reference(x, wq, sx, sw, bias, *geo_args)
    dev = [t.to(cuda) for t in (x, wq, sx, sw, bias)]
    got = Q.conv_s8(*dev, *geo_args)
    again = Q.conv_s8(*dev, *geo_args)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, again)
    # the exact sums: unit scales, no bias, float32 out
    one = torch.ones((), device=cuda)
    acc = Q.conv_s8(dev[0], dev[1], one, torch.ones(cout, device=cuda), None,
                    s, d, pt, pl, oh, ow, pad == "T", False)
    ref = Q.conv_s8_int32(x, wq, s, d, pt, pl, oh, ow, pad == "T")
    assert torch.equal(acc.cpu(), ref.to(torch.float32))
