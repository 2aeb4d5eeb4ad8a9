"""Probe: a hand-written fused conv3x3 + bias + ReLU at one ResUNet level,
against cuDNN.

The port of the TPU probe ``benchmarks/pallas_conv_probe.py``: y =
relu(conv3x3(x) + b) with x (N, H, W, C) bf16 NHWC, wk (3, 3, C, CO) bf16
HWIO, b (CO,) float32, products summed in float32, y bf16; N128 128^2
C = CO = 128 by default. ``conv3x3_relu_cuda`` launches
``csrc/conv3x3.cu`` (an implicit GEMM on TMA-fed wgmma: 16 x 8 pixel
tiles, x reused across the three taps of a column, a persistent grid,
TMA stores) on CUDA tensors, with the weights relaid once by
``pack_weights``; ``conv3x3_relu_reference`` is its plain version (the
probe's formulation: nine shifted (N H W, C) @ (C, CO) products in
float32); ``conv3x3_relu`` dispatches by device. The
yardstick is cuDNN (``F.conv2d`` on the channels_last view, bias, ReLU),
timed only.

On the card (queued device time; cuDNN and the plain version beside):

    python -m ddti_tpu_torch.probes.pallas_conv_probe [spatial] [channels] [HT]

On the CPU, through the plain version at the probe's CPU shape (N 2, 16^2),
no times:

    python -m ddti_tpu_torch.probes.pallas_conv_probe --device cpu

HT, the TPU kernel's row-strip height, is accepted and ignored: the kernel
tiles 16 x 8 pixels x 128 channels and computes every row for any H and W.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.attention import _stream

N, SPATIAL, CHANNELS, HT = 128, 128, 128, 8
CPU_N, CPU_SPATIAL = 2, 16   # the TPU probe's interpret-mode shape
# what csrc/conv3x3.cu takes: C in boxes of 32 or 64 channels, CO in bf16
# pairs of 8-column tiles
C_MULTIPLE, CO_MULTIPLE = 32, 8
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core peak, FLOP/s
# |y - exact| on cancelling_inputs' interior, any C up to 512: 4x the
# rounded chunk sum's worst (7.5e-3 at C = 512), half a truncating
# accumulator's drift
CANCEL_LIMIT = 2.0 ** -5


def flop(n, h, w, c, co):
    """Multiply-adds of the convolution, two FLOP each."""
    return 2 * n * h * w * 9 * c * co


def conv3x3_relu_reference(x, wk, b):
    """The kernel's function in plain PyTorch, the TPU probe's formulation:
    x zero-padded by one pixel, nine shifted (N H W, C) @ (C, CO) products
    of the bf16 values in float32, summed tap by tap (dy, then dx), then
    bias, ReLU and a cast to x's dtype. Independent of cuDNN. Needs TF32
    off on the card (chip_smoke and the tests turn it off)."""
    n, h, w, c = x.shape
    co = wk.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = wk.float()
    acc = torch.zeros((n * h * w, co), dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            xs = xp[:, dy:dy + h, dx:dx + w, :].reshape(n * h * w, c)
            acc = acc + xs @ wf[dy, dx]
    y = torch.relu(acc + b.float())
    return y.reshape(n, h, w, co).to(x.dtype)


def pack_weights(wk):
    """(3, 3, C, CO) HWIO -> (CO, 9 C) bf16, K contiguous, k = (3 dy + dx)
    C + c: the layout the kernel reads. Once per set of weights, outside
    the timed call."""
    kh, kw, c, co = wk.shape
    if (kh, kw) != (3, 3):
        raise ValueError(f"wk must be (3, 3, C, CO); got {tuple(wk.shape)}")
    return wk.to(torch.bfloat16).reshape(9 * c, co).t().contiguous()


def conv3x3_relu_cuda(x, wt, b):
    """Launch ``csrc/conv3x3.cu`` on CUDA tensors: x (N, H, W, C) bf16,
    contiguous NHWC; wt (CO, 9 C) bf16 from ``pack_weights``; b (CO,)
    float32. Takes C % 32 == 0 and CO % 8 == 0 (C = CO in {64, 128, 256,
    512}, the ResUNet levels at base 64, among them), N H W < 2^31, and x
    and wt 16-byte aligned.
    Returns y (N, H, W, CO) bf16. Raises on anything the kernel does not
    take. Adds one to ``conv3x3_relu_cuda.launches`` per launch."""
    if x.dim() != 4 or wt.dim() != 2 or b.dim() != 1:
        raise ValueError("x must be (N, H, W, C), wt (CO, 9 C), b (CO,)")
    n, h, w, c = x.shape
    co = wt.shape[0]
    if wt.shape[1] != 9 * c or b.shape[0] != co:
        raise ValueError(f"wt {tuple(wt.shape)} and b {tuple(b.shape)} do "
                         f"not fit C = {c}")
    if x.dtype != torch.bfloat16 or wt.dtype != torch.bfloat16 \
            or b.dtype != torch.float32:
        raise ValueError(f"x and wt must be bfloat16 and b float32; got "
                         f"{x.dtype}, {wt.dtype}, {b.dtype}")
    if not (x.is_cuda and wt.is_cuda and b.is_cuda) \
            or not x.device == wt.device == b.device:
        raise ValueError("x, wt and b must lie on one CUDA device")
    if not (x.is_contiguous() and wt.is_contiguous() and b.is_contiguous()):
        raise ValueError("x must be contiguous NHWC, wt and b contiguous")
    if c % C_MULTIPLE or co % CO_MULTIPLE:
        raise ValueError(f"the kernel takes C % {C_MULTIPLE} == 0 and CO % "
                         f"{CO_MULTIPLE} == 0; got C = {c}, CO = {co}")
    if x.numel() == 0 or n * h * w >= 2 ** 31:
        raise ValueError("x must hold 1 to 2^31 - 1 pixels")
    if x.data_ptr() % 16 or wt.data_ptr() % 16:
        raise ValueError("x and wt must be 16-byte aligned (TMA reads them)")
    from ..ops._build import launch

    y = torch.empty((n, h, w, co), dtype=torch.bfloat16, device=x.device)
    dev = x.device.index
    launch("conv3x3_relu", x.data_ptr(), wt.data_ptr(), b.data_ptr(),
           y.data_ptr(), n, h, w, c, co, dev, _stream(dev))
    conv3x3_relu_cuda.launches += 1
    return y


conv3x3_relu_cuda.launches = 0


def conv3x3_relu(x, wk, b):
    """The kernel on CUDA tensors (weights relaid by ``pack_weights``), its
    plain version on CPU tensors; wk (3, 3, C, CO)."""
    if x.device.type == "cpu":
        return conv3x3_relu_reference(x, wk, b)
    return conv3x3_relu_cuda(x, pack_weights(wk), b)


def cudnn_conv(x, wk, b):
    """The yardstick, one library call chain on the same inputs: F.conv2d
    (cuDNN on the card) on x's channels_last view with bias, then ReLU;
    returns y as an (N, H, W, CO) view. The port never calls it on a path.
    ``cudnn_weights`` gives ``wk`` in the layout it takes."""
    y = F.conv2d(x.permute(0, 3, 1, 2), wk, b, padding=1)
    return torch.relu_(y).permute(0, 2, 3, 1)


def cudnn_weights(wk, b):
    """(3, 3, C, CO) HWIO and b -> F.conv2d's (CO, C, 3, 3) channels_last
    bf16 weights and a bf16 bias."""
    wc = wk.to(torch.bfloat16).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    return wc, b.to(torch.bfloat16)


def make_inputs(n, s, c, co=None, seed=0, device="cuda"):
    """The probe's inputs from numpy's seeded generator: x normal, bf16;
    wk normal x 0.05, rounded to bf16 (the Pallas kernel's operand); b
    normal float32."""
    co = c if co is None else co
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((n, s, s, c), np.float32))
    wk = torch.from_numpy(
        rng.standard_normal((3, 3, c, co), np.float32) * np.float32(0.05))
    b = torch.from_numpy(rng.standard_normal(co, np.float32))
    return (x.to(device, torch.bfloat16), wk.to(device, torch.bfloat16),
            b.to(device))


def cancelling_inputs(n, s, c, seed=0, device="cuda"):
    """Inputs whose float32 sum the bf16 output can see: x the same
    channel vector a in [1, 2) at every pixel, wk in [1, 2) (C = CO, both
    bf16), so every interior pixel sums the same K = 9 C positive products
    S[o] (~2.25 K), and b = 1 - S in float32. An interior y is then ~1
    and carries the whole error of the float32 sum, ~10^4 times its
    relative error. At C = 512 the kernel's design (exact chunk sums of 32
    added in order, rounded to nearest) is off by up to 7.5e-3 over 512
    channels (sigma 2e-3), one accumulator that truncates at every k16
    step by ~0.07: ``CANCEL_LIMIT`` lies between. Returns x, wk, b and the
    exact interior y (float64 S plus b) per output channel."""
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).bfloat16()
    a = bf(rng.uniform(1.0, 2.0, c))
    wk = bf(rng.uniform(1.0, 2.0, (3, 3, c, c)))
    total = torch.einsum("c,tco->o", a.double(),
                         wk.double().reshape(9, c, c))
    b = (1.0 - total).float()
    exact = total + b.double()
    x = a.reshape(1, 1, 1, c).expand(n, s, s, c).contiguous()
    return x.to(device), wk.to(device), b.to(device), exact.to(device)


def bf16_ulp(y):
    """One bf16 ulp of |y| (2^(e - 7) for |y| in [2^e, 2^(e + 1)), the
    smallest normal's for zero)."""
    a = y.float().abs().clamp(min=2.0 ** -126)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def within_tolerance(got, want):
    """The port's tolerance for this kernel against its plain version:
    each element within one bf16 ulp of the larger of the two values, or
    within 2^-8 max|want| absolute (the ReLU edge: one side just above
    zero, the other just below). Returns (ok, max |got - want|, share of
    elements not bit-equal)."""
    g, w_ = got.float(), want.float()
    d = (g - w_).abs()
    ok = (d <= bf16_ulp(torch.maximum(g.abs(), w_.abs()))) \
        | (d <= 2.0 ** -8 * w_.abs().max())
    return bool(ok.all()), float(d.max()), float((g != w_).float().mean())


def run(n=N, s=SPATIAL, c=CHANNELS, ht=HT, seed=0, device="cuda"):
    """The probe once: the kernel (the plain version on the CPU) against
    the plain version and against cuDNN (the CPU's F.conv2d), and on the
    card the queued device times of the kernel, cuDNN and the plain
    version with the tensor-core share. Prints the probe's lines and
    returns a dict."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain "
                           "version")
    on_card = torch.device(device).type != "cpu"
    print(f"HT {ht} accepted and ignored: the kernel chooses its own pixel "
          "tiles and computes every row", flush=True)
    x, wk, b = make_inputs(n, s, c, seed=seed, device=device)
    got = conv3x3_relu(x, wk, b)
    want = conv3x3_relu_reference(x, wk, b)
    wc, bc = cudnn_weights(wk, b)
    lib = cudnn_conv(x, wc, bc)
    ok, err_plain, share = within_tolerance(got, want)
    err = float((got.float() - lib.float()).abs().max())
    print(f"max |kernel - cudnn| = {err:.4f}" if on_card
          else f"max |plain - F.conv2d| = {err:.4f}", flush=True)
    print(f"vs plain: max |d| {err_plain:.3e}, {share:.2e} of elements "
          f"differ, within tolerance {ok}", flush=True)
    out = dict(shape=[n, s, s, c, c], max_abs_err=err_plain, within=ok,
               differ_share=share, max_abs_vs_cudnn=err)
    if not on_card:
        print("times not measured (CPU)", flush=True)
        return out
    from ._timing import queued_ms

    wt = pack_weights(wk)
    out["pack_ms"] = queued_ms(lambda: pack_weights(wk), calls=20)
    out["ms"] = queued_ms(lambda: conv3x3_relu_cuda(x, wt, b))
    out["library_ms"] = queued_ms(lambda: cudnn_conv(x, wc, bc))
    out["plain_ms"] = queued_ms(lambda: conv3x3_relu_reference(x, wk, b),
                                calls=5)
    fl = flop(n, s, s, c, c)
    for name, key in (("kernel", "ms"), ("cudnn ", "library_ms"),
                      ("plain ", "plain_ms")):
        ms = out[key]
        print(f"{name}: {ms:8.4f} ms  {fl / ms / 1e9:7.1f} TFLOP/s, "
              f"{fl / PEAK_BF16 / ms * 1e5:5.1f}% of the H100's dense bf16 "
              f"peak of 989 TFLOP/s", flush=True)
    print(f"weights relaid once (pack_weights): {out['pack_ms']:.4f} ms",
          flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("spatial", nargs="?", type=int, default=SPATIAL)
    p.add_argument("channels", nargs="?", type=int, default=CHANNELS)
    p.add_argument("ht", nargs="?", type=int, default=HT)
    p.add_argument("--device", default="cuda")
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    n, s = (CPU_N, CPU_SPATIAL) if torch.device(a.device).type == "cpu" \
        else (N, a.spatial)
    run(n, s, a.channels, a.ht, a.seed, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
