"""Attention for the TransUNet bottleneck.

``attention_reference``: plain attention, two float32-accumulated products
and a softmax; the short-sequence path.

``flash_attention``: tiled online-softmax attention that never writes the
(S, S) score matrix, in either direction. On a CUDA tensor the forward
launches the hand-written Hopper kernel in ``csrc/flash_fwd.cu`` and the
backward the dK/dV and dQ kernels in ``csrc/flash_bwd.cu``; on a CPU tensor
each runs its plain PyTorch version (``flash_forward_reference``,
``flash_backward_reference``). There is no other route: a CUDA tensor a
kernel does not take raises.

Layout: q, k, v are (B, H, S, D), the JAX package's layout. The forward
also returns the base-2 logsumexp ``lse2`` (B, H, S) float32, the residual
from which the backward recomputes the probabilities.
"""

from __future__ import annotations

import math

import torch

LOG2E = 1.4426950408889634
# the forward kernel takes every head width d with d % 8 == 0 up to this
# bound, the backward kernels up to MAX_BWD_HEAD_DIM
MAX_HEAD_DIM = 256
MAX_BWD_HEAD_DIM = 128
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


def flash_backward_reference(q, k, v, o, lse2, do):
    """The backward kernels' function in plain PyTorch: (dq, dk, dv) in the
    inputs' dtype. The probabilities are recomputed from (q, k, lse2), not
    from a fresh softmax; P is rounded to dO's dtype before dV = P^T dO and
    dS = P * (dO V^T - delta) to q's dtype before dK and dQ, as the kernels
    (and the TPU kernels) round them; every product accumulates in
    float32."""
    with torch.autocast(q.device.type, enabled=False):
        scale = 1.0 / math.sqrt(q.shape[-1])
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        s = (qf @ kf.transpose(-1, -2)) * (LOG2E * scale)
        p = torch.exp2(s - lse2.unsqueeze(-1))
        delta = (dof * o.float()).sum(-1, keepdim=True)
        dv = p.to(do.dtype).float().transpose(-1, -2) @ dof
        ds = (p * (dof @ vf.transpose(-1, -2) - delta)).to(q.dtype).float()
        dk = (ds.transpose(-1, -2) @ qf) * scale
        dq = (ds @ kf) * scale
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_cuda(q, k, v, o, lse2, do):
    """Launch ``csrc/flash_bwd.cu`` on CUDA tensors: the delta pre-pass with
    the dK/dV kernel, then the dQ kernel; returns (dq, dk, dv). Raises on
    anything the kernels do not take. Adds one to
    ``flash_backward_cuda.launches_dkdv`` and to ``.launches_dq`` per launch
    of each kernel."""
    ts = (q, k, v, o, do)
    if q.dim() != 4 or any(t.shape != q.shape for t in ts):
        raise ValueError(f"q, k, v, o, do must share one (B, H, S, D) shape; "
                         f"got {[tuple(t.shape) for t in ts]}")
    if q.dtype not in _KERNEL_DTYPES or any(t.dtype != q.dtype for t in ts):
        raise ValueError(f"q, k, v, o, do must all be float32 or bfloat16; "
                         f"got {[t.dtype for t in ts]}")
    b, h, s, d = q.shape
    if d % 8 or not 8 <= d <= MAX_BWD_HEAD_DIM:
        raise ValueError(f"head dim {d}: the backward kernels take multiples "
                         f"of 8 up to {MAX_BWD_HEAD_DIM} (wider heads are a "
                         f"ROADMAP.md Queue 2 item)")
    if lse2.shape != (b, h, s) or lse2.dtype != torch.float32:
        raise ValueError(f"lse2 must be (B, H, S) float32; got "
                         f"{tuple(lse2.shape)} {lse2.dtype}")
    ts += (lse2,)
    if not (q.is_cuda and all(t.device == q.device for t in ts)):
        raise ValueError("q, k, v, o, lse2, do must lie on one CUDA device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("q, k, v, o, lse2, do must be contiguous")
    if any(t.data_ptr() % 16 for t in ts):
        raise ValueError("q, k, v, o, lse2, do must be 16-byte aligned")
    if not 0 < b * h <= 65535 or s == 0:
        raise ValueError(f"B*H = {b * h} must lie in [1, 65535] and S > 0")
    from ._build import launch

    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(lse2)
    dev, bf16 = q.device.index, _KERNEL_DTYPES[q.dtype]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    launch("flash_bwd_dkdv", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           o.data_ptr(), do.data_ptr(), lse2.data_ptr(), delta.data_ptr(),
           dk.data_ptr(), dv.data_ptr(), b * h, s, d, bf16, dev, stream)
    flash_backward_cuda.launches_dkdv += 1
    launch("flash_bwd_dq", q.data_ptr(), k.data_ptr(), v.data_ptr(),
           do.data_ptr(), lse2.data_ptr(), delta.data_ptr(), dq.data_ptr(),
           b * h, s, d, bf16, dev, stream)
    flash_backward_cuda.launches_dq += 1
    return dq, dk, dv


flash_backward_cuda.launches_dkdv = 0
flash_backward_cuda.launches_dq = 0


class _FlashAttention(torch.autograd.Function):
    # the plain versions for CPU tensors; any other device takes the
    # kernels, which raise on what they cannot take

    @staticmethod
    def forward(ctx, q, k, v):
        fwd = (flash_forward_reference if q.device.type == "cpu"
               else flash_forward_cuda)
        o, lse = fwd(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        # do arrives as the gradient of a transposed view, and under
        # autocast possibly in another dtype than o
        do = do.contiguous().to(o.dtype)
        bwd = (flash_backward_reference if q.device.type == "cpu"
               else flash_backward_cuda)
        return bwd(q, k, v, o, lse, do)


def flash_attention(q, k, v):
    """Flash attention on (B, H, S, D) q/k/v; returns o. Where a backward
    may follow (grad enabled, an input requiring grad) on a non-CPU device,
    a head width the backward kernels do not take raises here, before the
    forward runs, rather than in the middle of ``backward()``."""
    d = q.shape[-1]
    if (d > MAX_BWD_HEAD_DIM and q.device.type != "cpu"
            and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        raise ValueError(f"head dim {d}: the flash backward kernels take "
                         f"multiples of 8 up to {MAX_BWD_HEAD_DIM} (wider "
                         f"heads are a ROADMAP.md Queue 2 item); run it "
                         f"under torch.no_grad() or with narrower heads")
    return _FlashAttention.apply(q, k, v)
