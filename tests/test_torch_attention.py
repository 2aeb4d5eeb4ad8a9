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
    (1, 256, 1),  # the widest head the Hopper forward kernel takes
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


def test_flash_reference_bf16_matches_pallas_interpret():
    q, k, v = _qkv((2, 4, 64, 32), seed=1)
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


@pytest.mark.parametrize("d", [136, 256])
def test_flash_attention_rejects_backward_head_dims_at_forward(d):
    """A width the forward kernel takes but the backward kernels do not
    raises before the forward runs when grad is enabled on a non-CPU tensor
    (meta stands in for CUDA), and not under no_grad."""
    q = torch.empty((1, 2, 64, d), device="meta", requires_grad=True)
    with pytest.raises(ValueError, match=f"head dim {d}: the flash backward"):
        tattn.flash_attention(q, q, q)
    with pytest.raises(ValueError, match=f"head dim {d}: the backward"):
        tattn.flash_backward_cuda(*(q.detach(),) * 4,
                                  torch.empty((1, 2, 64), device="meta"),
                                  q.detach())


@pytest.mark.parametrize("d", [12, 264])
def test_flash_forward_cuda_rejects_head_dims_before_launch(d):
    """Head widths the kernel does not take raise on any non-CPU tensor
    (meta tensors stand in for CUDA ones here), before the library is
    built."""
    q = torch.empty((1, 2, 64, d), device="meta")
    with pytest.raises(ValueError, match=f"head dim {d}"):
        tattn.flash_forward_cuda(q, q, q)
