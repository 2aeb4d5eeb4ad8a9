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

``DDTI_POLY_EXP2=1`` in the environment (``USE_POLY_EXP2``, read once as
the JAX package reads it) swaps every exponential of the kernels and of
their plain versions for the polynomial ``_exp2_poly``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ._build import USE_POLY_EXP2

LOG2E = 1.4426950408889634
# the forward kernel takes every head width d with d % 8 == 0 up to this
# bound, the backward kernels up to MAX_BWD_HEAD_DIM
MAX_HEAD_DIM = 256
MAX_BWD_HEAD_DIM = 128
# float32 forwards up to this width run on the tensor cores (3xTF32), fed
# by a pre-pass that splits q, K and V^T into TF32 hi and lo planes; wider
# heads on FMAs
MAX_SPLIT_HEAD_DIM = 128
# the order in which the transposed TF32 planes store each group of 8 keys:
# position i holds key KEY_ORDER[i], so that P, an accumulator, is a TF32 A
# fragment as it stands (csrc/sm90.cuh)
KEY_ORDER = (0, 2, 4, 6, 1, 3, 5, 7)
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the Taylor coefficients ln2^k / k! of 2^f = e^(f ln2), k = 0..6, rounded
# to float32, as csrc/sm90.cuh:exp2_coeff writes them
EXP2_POLY_COEFFS = tuple(float(np.float32(math.log(2.0) ** k
                                          / math.factorial(k)))
                         for k in range(7))


def _exp2_poly(x, order=6):
    """2^x as the TPU kernels' polynomial (ddti_tpu/ops/attention.py:
    _exp2_poly; order 4-6 as benchmarks/exp2_probe.py:_poly_exp2) and
    csrc/sm90.cuh:exp2_poly compute it on float32: 2^round(x) * P(f), x
    rounded half to even, f = x - round(x), P the Taylor polynomial of
    ``order`` by Horner, round(x) clamped to [-126, 127] and 2^round(x)
    built from its exponent bits. x is first clamped to >= -2^22 (exact
    above), so -inf and the -1e30 sentinel give 2^-126, not NaN. The kernel
    fuses each Horner step into one FMA; here the multiply and the add
    round apart, as in JAX: the two differ by at most an ulp or two."""
    x = torch.fmax(x.float(), x.new_tensor(-2.0 ** 22, dtype=torch.float32))
    i = torch.round(x)
    f = x - i
    p = torch.zeros_like(f)
    for c in EXP2_POLY_COEFFS[order:0:-1]:
        p = (p + c) * f
    p = p + 1.0
    ii = i.clamp(-126.0, 127.0).to(torch.int32)
    return p * ((ii + 127) << 23).view(torch.float32)


def _exp2(x):
    """The flash kernels' exponential: torch.exp2, or the polynomial where
    DDTI_POLY_EXP2=1 (ops/_build.py:USE_POLY_EXP2) builds the kernels with
    it."""
    return _exp2_poly(x) if USE_POLY_EXP2 else torch.exp2(x)


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
        p = _exp2(s - m)
        l = p.sum(dim=-1, keepdim=True)
        o = (p.to(v.dtype).float() @ v.float()) / l
        return o.to(q.dtype), (m + torch.log2(l)).squeeze(-1)


def _tf32_rna(x):
    """float32 rounded to TF32 as ``cvt.rna.tf32.f32`` rounds it: to
    nearest, ties away from zero, the 13 low bits cleared (an integer add
    on the sign-magnitude bit pattern)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _split_tf32(x):
    """(hi, lo) with hi = tf32(x), lo = tf32(x - hi)."""
    hi = _tf32_rna(x)
    return hi, _tf32_rna(x - hi)


def _round_up_tile(s):
    return -(-s // 64) * 64


def _split_scratch_size(bh, s, d):
    """Float32 elements of the forward pre-pass's scratch: the hi and lo
    planes of q and K, (2, bh, 2, s, d), then of V^T, (bh, 2, d, sp) with
    sp = s rounded up to 64."""
    return 4 * bh * s * d + 2 * bh * d * _round_up_tile(s)


def flash_forward_split_reference(q, k, v):
    """What the float32 forward's pre-pass (``flash_fwd_split_f32_kernel``)
    writes, in plain PyTorch, as one flat float32 tensor: q's and K's TF32
    hi and lo planes as they are, then V^T's, zero past S, each group of 8
    keys in the order KEY_ORDER."""
    b, h, s, d = q.shape
    bh, sp = b * h, _round_up_tile(s)
    vt = v.new_zeros((bh, sp, d))
    vt[:, :s] = v.reshape(bh, s, d)
    order = torch.arange(sp).view(-1, 8)[:, list(KEY_ORDER)].reshape(-1)
    vt = vt[:, order].transpose(1, 2)
    planes = [torch.stack(_split_tf32(t), 1)
              for t in (q.reshape(bh, s, d), k.reshape(bh, s, d), vt)]
    return torch.cat([p.reshape(-1) for p in planes])


def _stream(index):
    """The current CUDA stream of device ``index`` as a raw pointer: the
    call PyTorch's own kernel launchers make, without building the Stream
    object of torch.cuda.current_stream, which costs a fifth of the forward
    wrapper's host time."""
    return torch._C._cuda_getCurrentRawStream(index)


def check_forward_inputs(q, k, v):
    """Raise ValueError on q, k, v that the forward kernels do not take:
    one (B, H, S, D) shape, float32 or bfloat16 alike, D % 8 == 0 up to
    MAX_HEAD_DIM, contiguous and 16-byte aligned on one CUDA device."""
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
    dev = q.device
    if not (q.is_cuda and k.device == dev and v.device == dev):
        raise ValueError("q, k, v must lie on one CUDA device")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k, v must be contiguous")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr())
    if any(p % 16 for p in ptrs):
        raise ValueError("q, k, v must be 16-byte aligned")
    if not 0 < b * h <= 65535 or s == 0:
        raise ValueError(f"B*H = {b * h} must lie in [1, 65535] and S > 0")


def flash_forward_cuda(q, k, v):
    """Launch ``csrc/flash_fwd.cu`` on CUDA tensors: returns (o, lse2). In
    float32 with d <= MAX_SPLIT_HEAD_DIM the pre-pass that splits q, K and
    V^T into TF32 planes runs first. Raises on anything the kernel does not
    take. Adds one to ``flash_forward_cuda.launches`` per forward."""
    check_forward_inputs(q, k, v)
    from ._build import launch

    b, h, s, d = q.shape
    dev, ptrs = q.device, (q.data_ptr(), k.data_ptr(), v.data_ptr())
    o = torch.empty_like(q)
    lse = q.new_empty((b, h, s), dtype=torch.float32)
    stream, scratch, pscratch = _stream(dev.index), None, None
    if q.dtype == torch.float32 and d <= MAX_SPLIT_HEAD_DIM:
        scratch = lse.new_empty(_split_scratch_size(b * h, s, d))
        pscratch = scratch.data_ptr()
        launch("flash_fwd_split_f32", *ptrs, pscratch, b * h, s, d,
               dev.index, stream)
    launch("flash_fwd", *ptrs, o.data_ptr(), lse.data_ptr(), pscratch,
           b * h, s, d, _KERNEL_DTYPES[q.dtype], dev.index, stream)
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
        p = _exp2(s - lse2.unsqueeze(-1))
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
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in ts)):
        raise ValueError("q, k, v, o, lse2, do must lie on one CUDA device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("q, k, v, o, lse2, do must be contiguous")
    pq, pk, pv, po, pdo, plse = ptrs = [t.data_ptr() for t in ts]
    if any(p % 16 for p in ptrs):
        raise ValueError("q, k, v, o, lse2, do must be 16-byte aligned")
    if not 0 < b * h <= 65535 or s == 0:
        raise ValueError(f"B*H = {b * h} must lie in [1, 65535] and S > 0")
    from ._build import launch

    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty_like(lse2)
    bf16 = _KERNEL_DTYPES[q.dtype]
    # the dK/dV kernel's TMA loads read lse2 and delta from a (B*H, 2, S
    # rounded up to 64) buffer that the pre-pass pads with +inf and 0
    sp = _round_up_tile(s)
    rows = lse2.new_empty((b * h, 2, sp))
    # float32: the pre-pass splits q, K, V, dO into TF32 hi and lo planes,
    # row-major and (q, dO, K) transposed, for both kernels' TMA loads
    scratch = (None if bf16 else
               lse2.new_empty(8 * b * h * s * d + 6 * b * h * d * sp))
    pscratch = None if bf16 else scratch.data_ptr()
    stream = _stream(dev.index)
    launch("flash_bwd_dkdv", pq, pk, pv, po, pdo, plse, delta.data_ptr(),
           rows.data_ptr(), pscratch, dk.data_ptr(), dv.data_ptr(), b * h, s,
           d, bf16, dev.index, stream)
    flash_backward_cuda.launches_dkdv += 1
    launch("flash_bwd_dq", pq, pk, pv, pdo, plse, delta.data_ptr(), pscratch,
           dq.data_ptr(), b * h, s, d, bf16, dev.index, stream)
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


@torch.library.custom_op("ddti::flash_fwd", mutates_args=())
def flash_fwd(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The flash forward as ``torch.ops.ddti.flash_fwd``: (o, lse2), the
    plain version for CPU tensors, the kernel for any other device. An
    exported serving program (``train/export.py``) holds it."""
    fwd = (flash_forward_reference if q.device.type == "cpu"
           else flash_forward_cuda)
    return fwd(q, k, v)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v):
    return (torch.empty_like(q),
            q.new_empty(q.shape[:3], dtype=torch.float32))


def flash_attention(q, k, v):
    """Flash attention on (B, H, S, D) q/k/v; returns o. Where a backward
    may follow (grad enabled, an input requiring grad) it runs through
    ``_FlashAttention``, and on a non-CPU device a head width the backward
    kernels do not take raises here, before the forward runs, rather than
    in the middle of ``backward()``; otherwise through the registered
    forward ``flash_fwd``, which ``torch.export`` can trace."""
    d = q.shape[-1]
    if not (torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))):
        return flash_fwd(q, k, v)[0]
    if d > MAX_BWD_HEAD_DIM and q.device.type != "cpu":
        raise ValueError(f"head dim {d}: the flash backward kernels take "
                         f"multiples of 8 up to {MAX_BWD_HEAD_DIM} (wider "
                         f"heads are a ROADMAP.md Queue 2 item); run it "
                         f"under torch.no_grad() or with narrower heads")
    return _FlashAttention.apply(q, k, v)
