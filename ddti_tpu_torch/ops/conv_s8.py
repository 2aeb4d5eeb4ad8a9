"""The int8 convolution of the int8 serving graph: s8 x s8 -> exact s32,
then JAX's dequantizing epilogue.

``conv_s8(xq, wq, sx, sw, bias, ...)`` computes, on NHWC int8 activations
``xq`` and int8 weights ``wq`` in flax's HWIO layout (the ``"quant"``
tables of ``train/quantize.py``, as the JAX package stores them),

    y = float32(conv(xq, wq) in int32) * (sx * sw[co]) (+ bias[co])

cast to float32 or bfloat16: ``ddti_tpu/train/quantize.py:
_quant_interceptor``'s arithmetic in its order. Geometries: a plain conv
with a square stride, dilation and any zero padding (3x3 SAME, 1x1,
ASPPUNet's dilated branches, the strided down-convs with flax's
asymmetric SAME), and the decoders' transposed conv (k = 2, s = 2, VALID,
flax's kernel orientation). Anything else raises.

On a CUDA tensor it launches the hand-written kernel in
``csrc/conv_s8.cu``; on a CPU tensor it runs ``conv_s8_reference``, the
same function in plain PyTorch: the conv in float64 on the int-valued
tensors, exact because |sum| <= 9 * 1024 * 127^2 < 2^53, cast to int32.
There is no other route. It is registered as ``torch.ops.ddti.conv_s8``
with a fake implementation, so an exported serving program
(``train/export.py``) holds it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# the kernel's k-step (bytes); the packed weights' K is a multiple of it
_KSTEP = 32


# every geometry of a quantizable conv in the 16 models of create_model, at
# a small size: (kh = kw, stride, dilation, padding), padding an int
# (symmetric), "SAME" (flax's, asymmetric where the stride leaves a
# remainder) or "T" for the decoders' transposed conv; with the channel
# counts (C, Cout) that reach the kernel's edges: the first conv's single
# input channel, the heads' single output channel, and C % 16 != 0
ZOO_GEOMETRIES = (
    ("3x3 first conv", 3, 1, 1, 1, 1, 64),
    ("3x3", 3, 1, 1, 1, 64, 64),
    ("3x3 C%16", 3, 1, 1, 1, 24, 40),
    ("1x1 skip", 1, 1, 1, "SAME", 32, 64),
    ("1x1 head", 1, 1, 1, "SAME", 64, 1),
    ("ASPP d6", 3, 1, 6, 6, 64, 32),
    ("3x3 s2 down", 3, 2, 1, 1, 32, 64),
    ("2x2 s2 SAME down", 2, 2, 1, "SAME", 32, 64),
    ("transposed 2x2 s2", 2, 2, 1, "T", 64, 32),
)


def conv_geometry(h: int, w: int, k: int, stride: int, dilation: int,
                  padding) -> tuple[int, int, int, int]:
    """(pad_top, pad_left, out_h, out_w) of a conv on an h x w frame as
    flax computes it: ``padding`` an int p (symmetric), "SAME" (out =
    ceil(in / stride), the low side padded by half the total, rounded
    down), "VALID", or "T" (the k = 2, s = 2 transposed conv: 2h x 2w)."""
    if padding == "T":
        return 0, 0, 2 * h, 2 * w

    def side(n):
        if padding == "SAME":
            out = -(-n // stride)
            total = max((out - 1) * stride + (k - 1) * dilation + 1 - n, 0)
            return total // 2, out
        p = 0 if padding == "VALID" else int(padding)
        return p, (n + 2 * p - dilation * (k - 1) - 1) // stride + 1

    (pt, oh), (pl, ow) = side(h), side(w)
    return pt, pl, oh, ow


def _out_dtype(bf16: bool) -> torch.dtype:
    return torch.bfloat16 if bf16 else torch.float32


def epilogue(acc: torch.Tensor, sx: torch.Tensor, sw: torch.Tensor,
             bias: Optional[torch.Tensor], bf16: bool) -> torch.Tensor:
    """int32 sums -> float32 * (sx * sw) (+ bias) -> float32 or bf16, each
    step rounded as JAX's graph rounds it."""
    y = acc.to(torch.float32) * (sx.to(torch.float32) * sw.to(torch.float32))
    if bias is not None:
        y = y + bias.to(torch.float32)
    return y.to(_out_dtype(bf16))


def conv_s8_int32(xq: torch.Tensor, wq: torch.Tensor, stride: int,
                  dilation: int, pad_top: int, pad_left: int, out_h: int,
                  out_w: int, transpose: bool) -> torch.Tensor:
    """The exact int32 sums, (N, out_h, out_w, Cout), in float64 on the
    int-valued tensors (plain PyTorch)."""
    x = xq.permute(0, 3, 1, 2).to(torch.float64)
    if transpose:  # flax HWIO -> torch (I, O, kh, kw), spatially flipped
        w = wq.permute(2, 3, 0, 1).flip(2, 3).to(torch.float64)
        y = F.conv_transpose2d(x, w, stride=2)
    else:
        kh, kw = wq.shape[:2]
        w = wq.permute(3, 2, 0, 1).to(torch.float64)
        h, wd = x.shape[-2:]
        pb = max((out_h - 1) * stride + (kh - 1) * dilation + 1
                 - h - pad_top, 0)
        pr = max((out_w - 1) * stride + (kw - 1) * dilation + 1
                 - wd - pad_left, 0)
        x = F.pad(x, (pad_left, pr, pad_top, pb))
        y = F.conv2d(x, w, stride=stride, dilation=dilation)
    y = y[:, :, :out_h, :out_w]
    return y.round().to(torch.int32).permute(0, 2, 3, 1).contiguous()


def conv_s8_reference(xq, wq, sx, sw, bias, stride: int, dilation: int,
                      pad_top: int, pad_left: int, out_h: int, out_w: int,
                      transpose: bool, bf16: bool) -> torch.Tensor:
    """The kernel's function in plain PyTorch: NHWC (N, out_h, out_w,
    Cout) float32 or bf16."""
    acc = conv_s8_int32(xq, wq, stride, dilation, pad_top, pad_left, out_h,
                        out_w, transpose)
    return epilogue(acc, sx, sw, bias, bf16)


def check_geometry(xq, wq, sx, sw, bias, stride, dilation, transpose):
    """Raise ValueError on what neither the kernel nor its plain version
    takes: int8 NHWC x and HWIO w of one channel count, float32 scales,
    the transposed conv only as k = 2, s = 2."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f"xq and wq must be int8; got {xq.dtype}, "
                         f"{wq.dtype}")
    if xq.dim() != 4 or wq.dim() != 4 or wq.shape[2] != xq.shape[3]:
        raise ValueError(f"xq (N, H, W, C) and wq (kh, kw, C, Cout) "
                         f"disagree: {tuple(xq.shape)}, {tuple(wq.shape)}")
    cout = wq.shape[3]
    if sx.numel() != 1 or sw.shape != (cout,) or (
            bias is not None and bias.shape != (cout,)):
        raise ValueError(f"sx must be a scalar and sw, bias (Cout,) = "
                         f"({cout},); got {tuple(sx.shape)}, "
                         f"{tuple(sw.shape)}, "
                         f"{None if bias is None else tuple(bias.shape)}")
    if transpose and (tuple(wq.shape[:2]) != (2, 2) or stride != 2
                      or dilation != 1):
        raise ValueError(f"the transposed conv is k = 2, s = 2 only; got "
                         f"k = {tuple(wq.shape[:2])}, s = {stride}, "
                         f"d = {dilation}")
    if stride < 1 or dilation < 1:
        raise ValueError(f"stride {stride}, dilation {dilation}")


def pack_weights(wq: torch.Tensor, c_pad: int,
                 transpose: bool) -> tuple[torch.Tensor, int]:
    """HWIO int8 weights -> the kernel's (taps, Cout, Kp) int8, k = (kh *
    KW + kw) * C + ci contiguous, C zero-padded to ``c_pad``, K to a
    multiple of 32. The transposed conv's four taps are packed per output
    parity (ry, rx), which reads flax tap (1 - ry, 1 - rx)."""
    kh, kw, c, cout = wq.shape
    if c_pad != c:
        wq = F.pad(wq, (0, 0, 0, c_pad - c))
    if transpose:
        taps = [wq[1 - p // 2, 1 - p % 2] for p in range(4)]  # (C, Cout)
        k = c_pad
        packed = torch.stack([t.t() for t in taps])          # (4, Cout, C)
    else:
        k = kh * kw * c_pad
        packed = wq.reshape(k, cout).t()[None]                # (1, Cout, K)
    kp = -(-k // _KSTEP) * _KSTEP
    if kp != k:
        packed = F.pad(packed, (0, kp - k))
    return packed.contiguous(), kp


def packed_weights(wq: torch.Tensor, c_pad: int,
                   transpose: bool) -> tuple[torch.Tensor, int]:
    """``pack_weights`` once per weight tensor: the packed table is kept on
    ``wq`` itself and repacked only if ``wq`` is written in place, so a
    serving program's tables (its inputs, alive as long as it is loaded)
    are packed at their first call and not on every batch. An inference
    tensor keeps no version count and is packed every call."""
    if wq.is_inference():
        return pack_weights(wq, c_pad, transpose)
    key = (wq._version, c_pad, transpose)
    cached = getattr(wq, "_ddti_packed", None)
    if cached is None or cached[0] != key:
        cached = (key, *pack_weights(wq, c_pad, transpose))
        wq._ddti_packed = cached
    return cached[1], cached[2]


def conv_s8_cuda(xq, wq, sx, sw, bias, stride: int, dilation: int,
                 pad_top: int, pad_left: int, out_h: int, out_w: int,
                 transpose: bool, bf16: bool) -> torch.Tensor:
    """Launch ``csrc/conv_s8.cu`` on CUDA tensors. Raises on anything the
    kernel does not take. Adds one to ``conv_s8_cuda.launches`` per
    launch."""
    check_geometry(xq, wq, sx, sw, bias, stride, dilation, transpose)
    dev = xq.device
    ts = [xq, wq, sx, sw] + ([bias] if bias is not None else [])
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError("xq, wq, sx, sw and bias must lie on one CUDA "
                         "device")
    n, h, w, c = xq.shape
    kh, kw, _, cout = wq.shape
    if n * max(h * w, out_h * out_w) >= 2 ** 31 or out_h < 1 or out_w < 1:
        raise ValueError(f"output {n} x {out_h} x {out_w} out of the "
                         f"kernel's range")
    c_pad = -(-c // 4) * 4
    x = xq.contiguous()
    if c_pad != c:  # the kernel reads channels four at a time
        x = F.pad(x, (0, c_pad - c))
    packed, kp = packed_weights(wq, c_pad, transpose)
    sxf = sx.to(torch.float32).reshape(()).contiguous()
    swf = sw.to(torch.float32).contiguous()
    bf = None if bias is None else bias.to(torch.float32).contiguous()
    y = torch.empty((n, out_h, out_w, cout), device=dev,
                    dtype=_out_dtype(bf16))
    from ._build import launch

    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    launch("conv_s8", x.data_ptr(), packed.data_ptr(), sxf.data_ptr(),
           swf.data_ptr(), None if bf is None else bf.data_ptr(),
           y.data_ptr(), n, h, w, c_pad, cout, kh, kw, stride, dilation,
           pad_top, pad_left, out_h, out_w, kp, int(transpose), int(bf16),
           dev.index, stream)
    conv_s8_cuda.launches += 1
    return y


conv_s8_cuda.launches = 0


@torch.library.custom_op("ddti::conv_s8", mutates_args=())
def conv_s8(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
            sw: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
            dilation: int, pad_top: int, pad_left: int, out_h: int,
            out_w: int, transpose: bool, bf16: bool) -> torch.Tensor:
    """NHWC int8 ``xq`` (N, H, W, C), HWIO int8 ``wq`` (kh, kw, C, Cout),
    float32 ``sx`` () and ``sw``, ``bias`` (Cout,) -> NHWC (N, out_h,
    out_w, Cout) float32, or bf16 where ``bf16``. CPU tensors take the
    plain version, every other device the kernel."""
    args = (xq, wq, sx, sw, bias, stride, dilation, pad_top, pad_left,
            out_h, out_w, transpose, bf16)
    if xq.device.type == "cpu":
        check_geometry(xq, wq, sx, sw, bias, stride, dilation, transpose)
        return conv_s8_reference(*args)
    return conv_s8_cuda(*args)


@conv_s8.register_fake
def _conv_s8_fake(xq, wq, sx, sw, bias, stride, dilation, pad_top,
                  pad_left, out_h, out_w, transpose, bf16):
    return xq.new_empty((xq.shape[0], out_h, out_w, wq.shape[3]),
                        dtype=_out_dtype(bf16))
