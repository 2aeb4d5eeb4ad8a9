"""The int8 convolution of the int8 serving graph: the activation's
quantization, s8 x s8 -> exact s32, then JAX's dequantizing epilogue.

``conv_s8(x, wq, sx, sw, bias, ...)`` computes, on NHWC activations ``x``
and int8 weights ``wq`` in flax's HWIO layout (the ``"quant"`` tables of
``train/quantize.py``, as the JAX package stores them),

    xq = x                                  (int8 x: already quantized)
    xq = clip(rint(float32(x) / sx), -127, 127)     (bf16 or float32 x)
    y  = float32(conv(xq, wq) in int32) * (sx * sw[co]) (+ bias[co])

cast to float32 or bfloat16: ``ddti_tpu/train/quantize.py:
_quant_interceptor``'s arithmetic in its order. The int8 form is what
bundles exported before the float forms call; the float forms move the
quantization into the kernel's load, so the int8 activation never reaches
device memory. Geometries: a plain conv with a square stride, dilation
and any zero padding (3x3 SAME, 1x1, ASPPUNet's dilated branches, the
strided down-convs with flax's asymmetric SAME), and the decoders'
transposed conv (k = 2, s = 2, VALID, flax's kernel orientation).
Anything else raises.

On a CUDA tensor it launches one of the two hand-written kernels of
``csrc/conv_s8.cu``, the route ``route_of`` picks from the geometry before
the launch: "wgmma" (TMA-fed s8 wgmma: stride-1 convs and the transposed
conv with C % 16 == 0, Cout of whole 16-byte rows, a box that fits shared
memory) or "mma" (the first design, on mma.sync: everything else). Each route
has its own launch counter (``conv_s8_wgmma.launches``,
``conv_s8_mma.launches``; ``launches()`` sums them). On a CPU tensor it
runs ``conv_s8_reference``, the same function in plain PyTorch: the
quantization as JAX writes it, then the conv in float64 on the int-valued
tensors, exact because |sum| <= 9 * 1024 * 127^2 < 2^53, cast to int32.
There is no other route. It is registered as ``torch.ops.ddti.conv_s8``
with a fake implementation, so an exported serving program
(``train/export.py``) holds it.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

ROUTES = ("wgmma", "mma")
# route "mma": the k-step (bytes), a multiple of which the packed K is, and
# the channel multiple its loads read
_KSTEP = 32
_MMA_CHANNELS = 4
# route "wgmma" (csrc/conv_s8.cu): channels a chunk, the output tile's rows
# and columns, its s8 A tile slots, the shared memory a block may use and
# the weight slots in flight at most
_CB, _TH, _TW, _A_SLOTS = 64, 16, 8, 3
_SMEM_LIMIT, _MAX_SLOTS = 232448, 16
# x's element types: the C entry points' xtype and the bytes of one
_X_TYPES = {torch.int8: (0, 1), torch.bfloat16: (1, 2), torch.float32: (2, 4)}


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


def quantize_activation(x: torch.Tensor, sx: torch.Tensor) -> torch.Tensor:
    """``clip(rint(float32(x) / sx), -127, 127)`` as int8: JAX's
    ``_quant_interceptor`` (a correctly rounded division, round half to
    even), which the kernels repeat bit for bit as they load x. An int8 x
    is already quantized and returned as it is."""
    if x.dtype == torch.int8:
        return x
    q = torch.round(x.to(torch.float32) / sx.to(torch.float32))
    return torch.clamp(q, -127, 127).to(torch.int8)


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


def conv_s8_reference(x, wq, sx, sw, bias, stride: int, dilation: int,
                      pad_top: int, pad_left: int, out_h: int, out_w: int,
                      transpose: bool, bf16: bool) -> torch.Tensor:
    """The kernels' function in plain PyTorch: x quantized
    (``quantize_activation``), the exact sums, the epilogue; NHWC (N,
    out_h, out_w, Cout) float32 or bf16."""
    acc = conv_s8_int32(quantize_activation(x, sx), wq, stride, dilation,
                        pad_top, pad_left, out_h, out_w, transpose)
    return epilogue(acc, sx, sw, bias, bf16)


def check_geometry(xq, wq, sx, sw, bias, stride, dilation, transpose):
    """Raise ValueError on what neither kernel nor their plain version
    takes: NHWC x (int8, bf16 or float32) and int8 HWIO w of one channel
    count, float32 scales, the transposed conv only as k = 2, s = 2."""
    if xq.dtype not in _X_TYPES or wq.dtype != torch.int8:
        raise ValueError(f"x must be int8, bf16 or float32 and wq int8; "
                         f"got {xq.dtype}, {wq.dtype}")
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
    """HWIO int8 weights -> the kernels' (taps, Cout, Kp) int8, k = (kh *
    KW + kw) * C + ci contiguous, C zero-padded to ``c_pad`` (a multiple of
    4 for route "mma", of 64 for route "wgmma", whose chunks of 64
    channels then never straddle two taps), K to a multiple of 32. The
    transposed conv's four taps are packed per output parity (ry, rx),
    which reads flax tap (1 - ry, 1 - rx)."""
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


def wgmma_plan(k: int, dilation: int, x_bytes: int, bn: int,
               out_bytes: int):
    """Route "wgmma"'s shared-memory plan for k x k taps at ``dilation``
    (csrc/conv_s8.cu:plan, mirrored): (x box slots, weight slots, bytes),
    or None where the box outgrows shared memory (the geometry then takes
    route "mma")."""
    extra = (k - 1) * dilation
    bh, bw = _TH + extra, _TW + extra
    if bh > 256 or bw > 256:
        return None
    def r1024(b):
        return -(-b // 1024) * 1024
    jp = bh * bw + (10 - bh * bw % 8) % 8  # pixels, padded to 2 mod 8
    xslot = r1024(bh * bw * _CB * x_bytes)
    aslot = r1024(4 * 16 * jp)
    bslot = bn * _CB
    fixed = _A_SLOTS * aslot + 2 * 64 * bn * out_bytes + 2048
    for nf in (3, 2, 1):  # a third x slot only beside 8 weight slots
        used = fixed + nf * xslot
        nb = min((_SMEM_LIMIT - used) // bslot, _MAX_SLOTS) \
            if used <= _SMEM_LIMIT else 0
        if nb >= (8 if nf == 3 else 3):
            return nf, nb, used + nb * bslot
    return None


def route_of(x: torch.Tensor, wq: torch.Tensor, stride: int, dilation: int,
             transpose: bool, bf16: bool) -> str:
    """The route a geometry takes: "wgmma" for a stride-1 conv or the
    transposed conv with C % 16 == 0, Cout of whole 16-byte output rows
    and a box that fits shared memory (``wgmma_plan``); else "mma"."""
    c, cout = wq.shape[2], wq.shape[3]
    k = 1 if transpose else wq.shape[0]
    out_bytes = 2 if bf16 else 4
    if (stride == 1 or transpose) and c % 16 == 0 \
            and (cout * out_bytes) % 16 == 0 and wgmma_plan(
                k, dilation, _X_TYPES[x.dtype][1], 64 if cout <= 64 else 128,
                out_bytes) is not None:
        return "wgmma"
    return "mma"


def _launch_args(x, wq, sx, sw, bias, c_pad, transpose):
    """What both routes' entry points take besides x, the output and the
    geometry: the packed weights (``packed_weights`` at ``c_pad``) and
    their K, the scales and bias in float32, and x's device's current
    stream."""
    packed, kp = packed_weights(wq, c_pad, transpose)
    sxf = sx.to(torch.float32).reshape(()).contiguous()
    swf = sw.to(torch.float32).contiguous()
    bf = None if bias is None else bias.to(torch.float32).contiguous()
    return packed, kp, sxf, swf, bf, torch._C._cuda_getCurrentRawStream(
        x.device.index)


def conv_s8_wgmma(x, wq, sx, sw, bias, stride: int, dilation: int,
                  pad_top: int, pad_left: int, out_h: int, out_w: int,
                  transpose: bool, bf16: bool) -> torch.Tensor:
    """Launch route "wgmma" of ``csrc/conv_s8.cu`` (``ddti_conv_s8_wgmma``)
    on CUDA tensors; raises where the geometry is not its
    (``route_of``). Adds one to ``conv_s8_wgmma.launches`` a launch."""
    if route_of(x, wq, stride, dilation, transpose, bf16) != "wgmma":
        raise ValueError(f"route wgmma does not take this geometry: x "
                         f"{tuple(x.shape)} {x.dtype}, w {tuple(wq.shape)}, "
                         f"stride {stride}, dilation {dilation}, transpose "
                         f"{transpose}, bf16 {bf16}")
    n, h, w, c = x.shape
    kh, _, _, cout = wq.shape
    x = x.contiguous()
    c_pad = -(-c // _CB) * _CB
    packed, _, sxf, swf, bf, stream = _launch_args(x, wq, sx, sw, bias,
                                                   c_pad, transpose)
    y = torch.empty((n, out_h, out_w, cout), device=x.device,
                    dtype=_out_dtype(bf16))
    from ._build import launch

    launch("conv_s8_wgmma", x.data_ptr(), packed.data_ptr(), sxf.data_ptr(),
           swf.data_ptr(), None if bf is None else bf.data_ptr(),
           y.data_ptr(), n, h, w, c, cout, 1 if transpose else kh, dilation,
           pad_top, pad_left, out_h, out_w, c_pad, int(transpose),
           _X_TYPES[x.dtype][0], int(bf16), x.device.index, stream)
    conv_s8_wgmma.launches += 1
    return y


def conv_s8_mma(x, wq, sx, sw, bias, stride: int, dilation: int,
                pad_top: int, pad_left: int, out_h: int, out_w: int,
                transpose: bool, bf16: bool) -> torch.Tensor:
    """Launch route "mma" of ``csrc/conv_s8.cu`` (``ddti_conv_s8``, the
    first design's kernel, quantizing as it loads) on CUDA tensors: it
    takes every geometry ``check_geometry`` passes. Adds one to
    ``conv_s8_mma.launches`` a launch."""
    n, h, w, c = x.shape
    kh, kw, _, cout = wq.shape
    if n * max(h * w, out_h * out_w) >= 2 ** 31 or out_h < 1 or out_w < 1:
        raise ValueError(f"output {n} x {out_h} x {out_w} out of the "
                         f"kernel's range")
    c_pad = -(-c // _MMA_CHANNELS) * _MMA_CHANNELS
    x = x.contiguous()
    if c_pad != c:  # the kernel reads channels four at a time
        x = F.pad(x, (0, c_pad - c))
    packed, kp, sxf, swf, bf, stream = _launch_args(x, wq, sx, sw, bias,
                                                    c_pad, transpose)
    y = torch.empty((n, out_h, out_w, cout), device=x.device,
                    dtype=_out_dtype(bf16))
    from ._build import launch

    launch("conv_s8", x.data_ptr(), packed.data_ptr(), sxf.data_ptr(),
           swf.data_ptr(), None if bf is None else bf.data_ptr(),
           y.data_ptr(), n, h, w, c_pad, cout, kh, kw, stride, dilation,
           pad_top, pad_left, out_h, out_w, kp, int(transpose),
           _X_TYPES[x.dtype][0], int(bf16), x.device.index, stream)
    conv_s8_mma.launches += 1
    return y


conv_s8_wgmma.launches = 0
conv_s8_mma.launches = 0
_ROUTE_FNS = {"wgmma": conv_s8_wgmma, "mma": conv_s8_mma}


def launches() -> int:
    """conv_s8's launches over both routes."""
    return conv_s8_wgmma.launches + conv_s8_mma.launches


def reset_launches() -> None:
    conv_s8_wgmma.launches = conv_s8_mma.launches = 0


def conv_s8_cuda(x, wq, sx, sw, bias, stride: int, dilation: int,
                 pad_top: int, pad_left: int, out_h: int, out_w: int,
                 transpose: bool, bf16: bool, route: str | None = None
                 ) -> torch.Tensor:
    """conv_s8 on CUDA tensors through ``route`` (None: ``route_of``'s
    choice, as the op makes it). Raises on anything the route does not
    take; nothing falls back to the plain version."""
    check_geometry(x, wq, sx, sw, bias, stride, dilation, transpose)
    dev = x.device
    ts = [x, wq, sx, sw] + ([bias] if bias is not None else [])
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError("x, wq, sx, sw and bias must lie on one CUDA "
                         "device")
    route = route or route_of(x, wq, stride, dilation, transpose, bf16)
    return _ROUTE_FNS[route](x, wq, sx, sw, bias, stride, dilation,
                             pad_top, pad_left, out_h, out_w, transpose,
                             bf16)


@torch.library.custom_op("ddti::conv_s8", mutates_args=())
def conv_s8(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
            sw: torch.Tensor, bias: Optional[torch.Tensor], stride: int,
            dilation: int, pad_top: int, pad_left: int, out_h: int,
            out_w: int, transpose: bool, bf16: bool) -> torch.Tensor:
    """NHWC ``xq`` (N, H, W, C): the int8 activation, or its bf16 or
    float32 value, quantized by ``sx`` as it is loaded; HWIO int8 ``wq``
    (kh, kw, C, Cout), float32 ``sx`` () and ``sw``, ``bias`` (Cout,) ->
    NHWC (N, out_h, out_w, Cout) float32, or bf16 where ``bf16``. CPU
    tensors take the plain version, every other device a kernel."""
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
