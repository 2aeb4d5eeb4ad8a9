"""ddti_tpu_torch.ops.attention against ddti_tpu.ops.attention on the CPU.

The port's plain versions (the CPU side of its flash kernel) are held
against the JAX Pallas flash kernels run in interpret mode, packed (G heads
per 128-lane group) and unpacked, for both the output and the base-2
logsumexp. The CUDA kernel itself is held against the same plain version on
the card (tests/test_torch_cuda.py, chip_smoke.py). Inputs come from numpy
with a fixed seed and go to both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.ops import attention as jattn
from ddti_tpu_torch.ops import attention as tattn


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax_lse(q, k, v, G):
    """The JAX kernels' lse residual, reshaped to the port's (B, H, S)."""
    b, h, s, _ = q.shape
    if G > 1:
        lse = jattn._flash_forward_packed(q, k, v, 64, 64, G,
                                          interpret=True)[1]
        # (B*H/G, S, G) -> (B, H/G, S, G) -> (B, H/G, G, S) -> (B, H, S)
        return np.asarray(lse).reshape(b, h // G, s, G).transpose(
            0, 1, 3, 2).reshape(b, h, s)
    lse = jattn._flash_forward(q, k, v, 64, 64, interpret=True)[1]
    return np.asarray(lse).reshape(b, h, s)


@pytest.mark.parametrize("h,d,G", [
    (8, 32, 4),   # TransUNet: embed 256 / 8 heads -> packed kernel, G = 4
    (3, 32, 1),   # odd head count -> unpacked kernel
    (2, 128, 1),  # full-width heads -> unpacked kernel
    (8, 16, 8),   # narrow heads -> packed kernel, G = 8
    (2, 24, 1),   # 128 % 24 != 0 -> unpacked kernel
    (1, 256, 1),  # the widest head the Hopper kernel takes
])
def test_flash_reference_matches_pallas_interpret(h, d, G):
    q, k, v = _qkv((2, h, 256, d))
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    assert jattn._packing(jq) == G
    o_jax = np.asarray(jattn.flash_attention(jq, jk, jv, 64, 64, True))
    lse_jax = _jax_lse(jq, jk, jv, G)

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


def test_flash_attention_cpu_path_without_nvcc():
    """The module imports and the CPU path runs with no CUDA toolkit; the
    forward works on inputs that require grad, and the backward (not
    ported) says where it is queued."""
    from ddti_tpu_torch.ops import _build  # noqa: F401  (no build at import)

    q, k, v = (torch.from_numpy(t).requires_grad_()
               for t in _qkv((1, 2, 64, 32), seed=3))
    before = tattn.flash_forward_cuda.launches
    o = tattn.flash_attention(q, k, v)
    assert tattn.flash_forward_cuda.launches == before  # plain version ran
    want = tattn.attention_reference(q.detach(), k.detach(), v.detach())
    np.testing.assert_allclose(o.detach().numpy(), want.numpy(), atol=1e-5)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        o.sum().backward()
    with pytest.raises(ValueError, match="CUDA device"):
        tattn.flash_forward_cuda(q.detach(), k.detach(), v.detach())


@pytest.mark.parametrize("d", [12, 264])
def test_flash_forward_cuda_rejects_head_dims_before_launch(d):
    """Head widths the kernel does not take raise on any non-CPU tensor
    (meta tensors stand in for CUDA ones here), before the library is
    built."""
    q = torch.empty((1, 2, 64, d), device="meta")
    with pytest.raises(ValueError, match=f"head dim {d}"):
        tattn.flash_forward_cuda(q, q, q)
