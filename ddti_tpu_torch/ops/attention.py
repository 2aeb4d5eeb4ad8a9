"""Attention for the TransUNet bottleneck.

``attention_reference``: plain attention, two float32-accumulated products
and a softmax; the short-sequence path.

``flash_attention``: tiled online-softmax attention that never writes the
(S, S) score matrix. On a CUDA tensor it launches the hand-written Hopper
kernel in ``csrc/flash_fwd.cu``; on a CPU tensor it runs
``flash_forward_reference``, the same function in plain PyTorch. There is no
other route: a CUDA tensor the kernel does not take raises.

Layout: q, k, v are (B, H, S, D), the JAX package's layout. The kernel also
returns the base-2 logsumexp ``lse2`` (B, H, S) float32, the residual the
backward kernels will consume.
"""

from __future__ import annotations

import math

import torch

LOG2E = 1.4426950408889634
# the kernel takes every head width d with d % 8 == 0 up to this bound
MAX_HEAD_DIM = 256
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def attention_reference(q, k, v):
    """softmax(q k^T / sqrt(d)) v with float32 accumulation; probabilities
    are cast to v's dtype before the PV product. Autocast is off inside, so
    the scores stay float32 whatever the caller's autocast policy."""
    with torch.autocast(q.device.type, enabled=False):
        s = q.float() @ k.float().transpose(-1, -2)
        p = torch.softmax(s / math.sqrt(q.shape[-1]), dim=-1).to(v.dtype)
        return (p.float() @ v.float()).to(q.dtype)


def flash_forward_reference(q, k, v):
    """The flash kernel's function in plain PyTorch: returns ``o`` (q's
    dtype) and ``lse2`` = m + log2(l) as (B, H, S) float32, with the scale
    folded into base-2 scores as the kernel does. Unnormalised
    probabilities are rounded to v's dtype before PV; l sums them
    unrounded."""
    with torch.autocast(q.device.type, enabled=False):
        s = (q.float() @ k.float().transpose(-1, -2)) * (
            LOG2E / math.sqrt(q.shape[-1]))
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = (p.to(v.dtype).float() @ v.float()) / l
        return o.to(q.dtype), (m + torch.log2(l)).squeeze(-1)


def flash_forward_cuda(q, k, v):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors: returns (o, lse2).
    Raises on anything the kernel does not take. Adds one to
    ``flash_forward_cuda.launches`` per launch."""
    if q.shape != k.shape or q.shape != v.shape or q.dim() != 4:
        raise ValueError(f"q, k, v must share one (B, H, S, D) shape; got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.dtype not in _KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    b, h, s, d = q.shape
    if d % 8 or not 8 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"head dim {d}: the kernel takes multiples of 8 "
                         f"up to {MAX_HEAD_DIM} (wider heads are a "
                         f"ROADMAP.md Queue 2 item)")
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("q, k, v must lie on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned")
    if not 0 < b * h <= 65535 or s == 0:
        raise ValueError(f"B*H = {b * h} must lie in [1, 65535] and S > 0")
    from ._build import launch

    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), device=q.device, dtype=torch.float32)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launch("flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           o.data_ptr(), lse.data_ptr(), b * h, s, d,
           _KERNEL_DTYPES[q.dtype], q.device.index, stream)
    flash_forward_cuda.launches += 1
    return o, lse


flash_forward_cuda.launches = 0


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        # the plain version for CPU tensors; any other device takes the
        # kernel, which raises on what it cannot take
        fwd = (flash_forward_reference if q.device.type == "cpu"
               else flash_forward_cuda)
        o, lse = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        raise NotImplementedError(
            "flash attention backward is not ported yet: the dK/dV and dQ "
            "kernels (ddti_tpu/ops/attention.py _dkdv_kernel[_packed], "
            "_dq_kernel[_packed]) are ROADMAP.md Queue 2 items")


def flash_attention(q, k, v):
    """Flash attention forward on (B, H, S, D) q/k/v; returns o."""
    return _FlashAttention.apply(q, k, v)
