"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card (marker ``cuda``) and skips without
one. The file imports no JAX, so it also runs where JAX is absent:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py
"""

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
