#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ddti_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

or, to compare another tree of the repository (a commit unpacked with git
archive) with this one on the same card, in the order other, this, this,
other: ``python3 chip_smoke.py --ab OTHER_TREE`` (see ``ab``; ``--ab
OTHER_TREE probes`` for the probes and the EDT alone: conv3x3, gather,
exp2_probe in every mode and the EDT's queued time and passes).

Phases, one or more lines each; any failure ends the run with a traceback
and a non-zero exit:

1. device   — needs CUDA; prints the card's name and power limit
              (nvidia-smi) and turns TF32 off, so float32 means float32.
2. build    — compiles the CUDA sources under ddti_tpu_torch/csrc with nvcc
              (one process per source, all at once) into build/, and the
              DDTI_POLY_EXP2=1 library beside it at the same time; prints
              each kernel's registers, spills and SASS opcode counts, and
              holds the poly build to the polynomial (no MUFU.EX2 in a
              flash kernel, no FRND or F2I on any poly path).
3. kernels  — every kernel against its plain PyTorch version on the card,
              with timings: flash attention forward at the serving path's
              shapes (in float32 with its TF32 split pre-pass timed apart);
              the flash backward kernels (csrc/flash_bwd.cu: dK/dV
              with the delta pre-pass, and dQ) at the same shapes, a ragged
              S and bf16 heads of 64 and 128, dq/dk/dv against their limits,
              two calls bit-equal; each flash row timed as one call between
              CUDA events, as a queue of calls (device time alone, the
              wrapper's host enqueue time beside it) and per kernel entry
              point by CUDA events around its launch, beside the plain
              version's; beside each flash
              row its bound (work counted from the shape over the card's
              published peaks, and the exp2 floor) and the fastest backend
              of PyTorch's fused
              attention (scaled_dot_product_attention, a yardstick the port
              never calls); the EDT (csrc/edt.cu) bit for bit against its
              plain version and against scipy at the training path's
              shapes, ragged ones and edge frames, timed as one call and
              queued, its column and row passes apart (torch.profiler),
              beside its bound and the min-plus algorithm's.
4. probes   — the ports of the softmax probes of benchmarks/
              (ddti_tpu_torch/probes): csrc/exp2_probe.cu in every mode
              against its plain version (<= 2 ulp, the copy bit for bit)
              on the probe's input and on edge values; the m-skip forward
              bit for bit against the production forward and within the
              forward's limits of its plain version; in a subprocess with
              DDTI_POLY_EXP2=1 (its own library, built beside the default
              one in the build phase) the flash forward and backward
              against their plain versions in poly mode, queued times
              beside; then the three probes' lines. The conv3x3 and
              gather probes: csrc/conv3x3.cu against its plain version
              (within one bf16 ulp or 2^-8 max|y|) at the probe's shape,
              its CPU shape, ragged ones, its tiling's edges and C = CO of
              64-512, and (the error-growth check) where the bias cancels a
              sum of 9 C positive products, within CANCEL_LIMIT of the
              exact value at every C; csrc/gather_probe.cu bit for bit
              against its plain version in every mode with edge indices
              planted, at the staged path's edges and on every builder (A,
              B, C, B2, F, P4, P5, P6), its count of staged (tile, image)
              pairs equal to plan_windows'; then the four probes' runs,
              with queued times beside cuDNN, torch.gather and the XLA
              builders' torch calls, the bounds, and each kernel's bytes
              from L2 into the SMs a call, the previous design's beside
              (mma.sync for the conv, per-element for the gather).
5. slice    — the serving daemon (ddti_tpu_torch.cli.serve) with the
              TransUNet of configs/config.yaml (base_filters 64, depth 4,
              512x512 -> 1024 bottleneck tokens), random weights from a seed,
              bf16, batch 16. A few dozen PNG frames are POSTed concurrently
              to /predict; the flash kernel's launch count must rise by 4
              (one per encoder layer) for every batch. In bf16, the kernel
              path's masks must agree with a plain-attention run of the same
              frames as closely as the kernel's own plain version does (the
              bf16 noise floor): tightly when batched alike in-process,
              loosely for the masks the daemon served (its batches form by
              arrival). In float32 both paths' masks must agree on >= 99.9%
              of pixels and their logits to 1e-3.
6. profile  — device time per bf16 serving batch of 16 on the kernel path
              and on the plain path (CUDA events), and a torch.profiler
              breakdown of the kernel path with the device's busy share.
7. train    — the training CLI (python -m ddti_tpu_torch.cli.main --mode
              both --synthetic) with the flagship ResUNet (base_filters 64,
              depth 5) at 512^2, batch 16, bf16, 2 epochs, in a subprocess:
              exit 0, the parameter count, the JAX CLI's run tree, finite
              loss terms with a nonzero boundary term, val IoU and test
              metrics with HD95/ASSD, a best .pth that loads strictly and an
              .npz in the JAX package's key layout, and exactly the expected
              number of EDT kernel launches.
8. ttrain   — the same CLI training the serving slice's TransUNet
              (base_filters 64, depth 4, 512^2 -> 1024 tokens) from a model
              YAML with dropout_rate 0.0, batch 16, bf16, 2 epochs: the same
              checks, and exactly the expected launches of the flash forward,
              both backward kernels and the EDT.
9. step     — one float32 train step from one state and batch with the
              kernel EDT and with the plain EDT: bit-equal boundary terms and
              updated parameters equal to 1e-6.
10. tstep   — one float32 TransUNet train step from one state and batch
              through the flash kernels and through their plain versions
              (swapped in explicitly): loss terms to 1e-6, gradients and
              updated parameters within the stated normwise limits; then a
              bf16 step at the default dropout 0.1, which the gate sends to
              the plain attention: no flash launch, finite terms.
11. tprofile — device time per train step (CUDA events), bf16 first:
              ResUNet at 512^2 / batch 16 and 256^2 / batch 128, with the
              EDT kernels' share; the TransUNet at 512^2 / batch 16 (S = 1024) on the
              kernel path and the plain path, and the S = 4096 TransUNet
              (base_filters 32, depth 3) at the largest batch <= 16 whose
              plain path fits; then the TransUNet in float32 (the training
              CLI's default dtype, TF32 off): S = 1024 on both paths and
              S = 4096 on the kernel path; torch.profiler top-8, busy share
              and the flash kernels' share.
12. result  — the total wall time, a JSON line of the kernels, then the
              device line.
"""

import concurrent.futures
import http.client
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

SEED = 0
DEVICE = "cuda"  # the training phases' device
SLICE = dict(in_channels=1, out_channels=1, base_filters=64, depth=4,
             image_size=512)
N_LAYERS = 4          # TransUNet's fixed encoder depth
BATCH = 16
N_FRAMES = 64
# bf16 masks of the kernel path may disagree with the plain path's on at
# most this share of pixels more than the kernel's own plain version does:
# KERNEL_MARGIN when all three are batched alike in-process, SERVED_MARGIN
# for the masks the daemon served, whose batches form by arrival
KERNEL_MARGIN = 5e-5
SERVED_MARGIN = 5e-4
# kernel vs plain: bf16 differs by the rounding of the probability tile,
# float32 by summation order only
O_LIMIT = {"bfloat16": 2e-2, "float32": 1e-4}
LSE_LIMIT = 1e-3
# (B, H, S, D, dtype): the slice's shape in both dtypes, the S = 4096
# bottleneck of config.yaml's TransUNet at depth 3 in both dtypes, and
# full-width heads
KERNEL_SHAPES = [(16, 8, 1024, 32, "bfloat16"), (16, 8, 1024, 32, "float32"),
                 (2, 8, 4096, 32, "bfloat16"), (2, 2, 1024, 128, "float32"),
                 (2, 8, 4096, 32, "float32")]
F32_LOGIT_LIMIT = 1e-3
# float32 masks of the kernel path and the plain path: at least this share
# of pixels agree (bf16 masks are held to the noise floor above instead)
F32_MASK_AGREE = 0.999
PROFILE_BATCHES = 5
PROFILE_TOP = 8
# the EDT at the training path's shape (N, H, W), bs128 at 256^2 (bench.py's
# headline leg), ragged widths and a single row; timed at the first two
EDT_SHAPES = [(16, 512, 512), (128, 256, 256), (8, 100, 100), (4, 200, 333),
              (3, 1, 333)]
EDT_TIMED = 2
# the lower envelope's integer operations a pixel, both passes (work_counts)
EDT_OPS_PER_PIXEL = 26
# the training slice: the CLI's flagship ResUNet at its defaults
TRAIN = dict(model_type="ResUNet", base_filters=64, depth=5, image_size=512,
             batch_size=16, epochs=2)
SYNTHETIC = (64, 16, 16)  # the CLI's --synthetic train/val/test frames
TRAIN_TIMEOUT_S = 600
STEP_PARAM_RTOL = 1e-6
# (image size, batch): the CLI default and bench.py's headline leg
TRAIN_PROFILES = [(512, 16), (256, 128)]
TRAIN_PROFILE_STEPS = 3
# backward kernels vs plain, max |difference| over max |value| of each of
# dq, dk, dv: float32 by summation order, bf16 also by P and dS landing an
# ulp apart where the two sides' float32 values straddle a bf16 boundary
G_LIMIT = {"bfloat16": 2e-2, "float32": 1e-4}
# the forward's shapes, a ragged S, and bf16 at the two wider padded head
# widths (each its own kernel instantiation)
BWD_SHAPES = KERNEL_SHAPES + [(2, 8, 1000, 32, "bfloat16"),
                              (4, 4, 1024, 64, "bfloat16"),
                              (2, 2, 1024, 128, "bfloat16")]
BWD_PROFILE_CALLS = 5
# calls of a kernel's wrapper enqueued back to back, with no synchronisation
# inside, behind a device-side sleep of SLEEP_CYCLES clocks (~0.1 s, far
# longer than the host takes to enqueue them): the host clock gives the
# wrapper's enqueue time per call, CUDA events the device time per call
# with no launch waiting for the host
HOST_CALLS = 100
SLEEP_CYCLES = 200_000_000
# the host shares its cores: where it enqueued the calls slower than the
# sleep lasted (autograd calls take ~1 ms each), the measurement is taken
# again behind a sleep the next of these many times as long
SLEEP_SCALES = (1, 4, 16)
# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): dense
# tensor-core bf16, float32 outside the tensor cores and dense TF32 on them,
# in FLOP/s, and HBM3 bytes/s; the exp2 unit issues 16 ex2 per clock per
# SM, 132 SMs at the 1980 MHz boost clock. A float32-accurate product runs
# on the tensor cores as three TF32 products (3xTF32: a_lo b_hi + a_hi b_lo
# + a_hi b_hi), at a third of the TF32 rate and above the FMA rate, so the
# float32 flash kernels' work is bound at 495 / 3 TFLOP/s. The EDT's
# integer operations run on the SM's INT32 lanes, 64 a clock per SM (four
# partitions of 16; NVIDIA's H100 architecture whitepaper), at the same
# clock.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
PEAK_BYTES = 3.35e12
EX2_PER_S = 132 * 16 * 1.98e9
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# PyTorch's fused attention backends, timed as yardsticks; the fastest
# that takes a shape is reported
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
# the TransUNet training slice: the serving slice's model from a model YAML
# (configs/config.yaml:337-343) with dropout_rate 0.0, trained by the CLI
TSLICE = dict(in_channels=1, out_channels=1, base_filters=64, depth=4,
              dropout_rate=0.0)
TSLICE_PARAMS = 19511873
TTRAIN = dict(image_size=512, batch_size=16, epochs=2)
# float32 step, flash kernels vs their plain versions: loss terms (relative)
# and gradients and updated parameters (normwise over all of them). The
# attention gradients' float32 summation-order differences (~3e-7 relative)
# reach 2.5e-5 normwise over all gradients, and the first AdamW step turns
# the gradients that lie within that noise of zero into sign flips of up to
# 2 lr: 1.2e-6 normwise on the parameters (H100); held to 4x and 8x that
TSTEP_TERM_RTOL = 1e-6
TSTEP_GRAD_RTOL = 1e-4
TSTEP_PARAM_RTOL = 1e-5
# the S = 4096 TransUNet of configs/config.yaml:303-308 (512^2, depth 3)
TLONG = dict(in_channels=1, out_channels=1, base_filters=32, depth=3,
             dropout_rate=0.0)
TLONG_BATCHES = (16, 8, 4, 2, 1)
# the probes phase: exp2_probe's edge values (signed zeros, -inf, the TPU
# kernels' -1e30 sentinel, halves that round to even, both ends of the
# clamp, a subnormal), held to EXP2_ULPS of the plain version; the m-skip
# forward's shapes (the probe's, the slice's, a ragged S), bit for bit
# against the production forward; the poly build's flash shapes (a and c of
# PERF.md)
EXP2_EDGES = (0.0, -0.0, float("-inf"), -1e30, -126.5, 127.0, 0.5, 1.5, 2.5,
              -0.5, -1.5, -2.5, -125.5, -126.0, -127.5, -130.0, 126.5, 3.0,
              -20.0, 1e-40, -1e-40, 0.25, -0.75)
EXP2_ULPS = 2
MSKIP_SHAPES = [(8, 8, 4096, 32), (16, 8, 1024, 32), (2, 8, 1000, 32)]
# conv3x3 kernel vs plain: the probe's shape, its CPU shape, a ragged one,
# the kernel's edges (W below its 8-column tile, W = 1, one image 300 wide,
# an odd count of pixel tiles, the 32-channel box at C = 32 and 96, CO of
# one 8-channel group and past a 128-channel tile),
# and (N, spatial, C = CO) of the error-growth check
CONV_SHAPES = [(128, 128, 128, 128, 128), (2, 16, 16, 128, 128),
               (3, 10, 12, 64, 96), (2, 16, 5, 64, 64), (2, 9, 1, 64, 64),
               (1, 4, 300, 64, 64), (3, 16, 24, 64, 64), (2, 20, 20, 32, 64),
               (2, 20, 20, 96, 128), (2, 16, 16, 64, 8), (2, 16, 16, 64, 136)]
CONV_GROWTH = (16, 64, (64, 128, 256, 512))
POLY_SHAPES = [(16, 8, 1024, 32, "bfloat16"), (16, 8, 1024, 32, "float32")]
POLY_TIMEOUT_S = 600


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def median_ms(fn, runs=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def work_counts(kernel, shape, dtype="bfloat16", shared_index=False):
    """What one call of ``kernel`` must do at ``shape``, counted from the
    shape alone: ``flop`` (a multiply-add is two), ``bytes`` (each input
    read once, each output written once) and ``exp2`` evaluations.

    Flash kernels take (B, H, S, D) and move (B, H, S, D) tensors of
    ``dtype`` and (B, H, S) float32 rows (lse2, delta); each (S, S, D)
    product is 2 B H S^2 D FLOP and each pass over the scores B H S^2
    exp2. ``flash_bwd`` is the pair (q, k, v, o, dO, lse2 -> dq, dk, dv:
    five products, P recomputed once by each kernel); ``flash_bwd_dkdv``
    (with the delta pre-pass: -> dk, dv, delta; S^T, dP^T, dV, dK) and
    ``flash_bwd_dq`` (q, k, v, dO, lse2, delta -> dq; S, dP, dQ) are its
    two kernels; ``flash_fwd_mskip`` does the forward's work (the rescale it
    skips is not counted in either). ``edt`` takes (N, H, W): uint8 in,
    float32 out, and ``flop`` counts the lower envelope's integer
    operations, 26 a pixel at the INT32 rate: 10 in the column pass (a
    zero's bit, the shift to the row, its lowest set bit, the two distances
    and two minima) and 16 in the row pass (the band scan's test of a new
    site against the stack's top two: two separator numerators and their
    cross products; the walk's two parabola values and their compare, and
    the clamp); the min-plus algorithm's add and min per (row, column,
    column) that the TPU kernel and the port's first EDT did is
    ``minplus_flop``. ``exp2_probe`` takes (rows, cols) float32 in and
    out, one exp2 an element and no FLOP that the bound counts. ``conv3x3``
    (benchmarks/pallas_conv_probe.py) takes (N, H, W, C, CO), the input
    counted padded by one pixel as the TPU probe pads it (csrc/conv3x3.cu
    reads it unpadded, slightly fewer bytes) and the output in bf16;
    ``gather`` (benchmarks/gather_probe*.py) (N, H, W, element bytes), src
    read and out written once, and one int32 index an element gathered, or
    with ``shared_index`` one (H, W) index plane read once for all N
    images (builders A, B, C and B2)."""
    if kernel == "edt":
        n, h, w = shape
        return dict(flop=EDT_OPS_PER_PIXEL * n * h * w,
                    bytes=n * h * w * (1 + 4), exp2=0,
                    minplus_flop=2 * n * h * w * w)
    if kernel == "exp2_probe":
        n = shape[0] * shape[1]
        return dict(flop=0, bytes=2 * 4 * n, exp2=n)
    if kernel == "conv3x3":
        n, h, w, c, co = shape
        return dict(flop=2 * n * h * w * 9 * c * co, exp2=0, bytes=2 * (
            n * (h + 2) * (w + 2) * c + n * h * w * co + 9 * c * co + co))
    if kernel == "gather":
        n, h, w, elem = shape
        index = h * w * 4 * (1 if shared_index else n)
        return dict(flop=0, bytes=n * h * w * 2 * elem + index, exp2=0)
    b, h, s, d = shape
    tensor = b * h * s * d * (2 if dtype == "bfloat16" else 4)
    rows = b * h * s * 4
    # products, tensors read + written, float32 rows read + written, exp2
    # passes
    products, tensors, nrows, passes = {
        "flash_fwd": (2, 4, 1, 1),
        "flash_fwd_mskip": (2, 4, 1, 1),
        "flash_bwd": (5, 8, 1, 2),
        "flash_bwd_dkdv": (4, 7, 2, 1),
        "flash_bwd_dq": (3, 5, 2, 1),
    }[kernel]
    return dict(flop=products * 2 * b * h * s * s * d,
                bytes=tensors * tensor + nrows * rows,
                exp2=passes * b * h * s * s)


def bound(kernel, shape, dtype="bfloat16", shared_index=False):
    """The least time the card could take for ``work_counts``: the larger
    of operations over the peak for their type (bf16 on the tensor cores,
    float32 flash products as 3xTF32 on them; the EDT's integer operations
    on the INT32 lanes) and bytes over the memory rate. Returns (bound_ms,
    bound_by, exp2_ms), exp2_ms the time the exp2 unit alone needs."""
    w = work_counts(kernel, shape, dtype, shared_index)
    peak = INT32_OPS_PER_S if kernel == "edt" else PEAK_FLOPS[
        "float32" if kernel in ("exp2_probe", "gather")
        else "tf32x3" if dtype == "float32" else dtype]
    ops_ms, bytes_ms = w["flop"] / peak * 1e3, w["bytes"] / PEAK_BYTES * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes",
            w["exp2"] / EX2_PER_S * 1e3)


def kernel_constants(source, *names):
    """The integer constants ``names`` as ddti_tpu_torch/csrc/``source``
    defines them (``kName = 16``), read from the source, so that the models
    below take the kernel's own tiling. Raises where one is missing."""
    import re

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ddti_tpu_torch", "csrc", source)
    with open(path) as f:
        text = f.read()
    found = {}
    for name in names:
        m = re.search(rf"\b{name}\s*=\s*(\d+)\s*[,;]", text)
        if not m:
            raise ValueError(f"{source} defines no constant {name}")
        found[name] = int(m.group(1))
    return found


# the conv3x3 kernel that csrc/conv3x3.cu replaced (mma.sync): tiles of 128
# flattened pixels x 128 channels
OLD_CONV_TILE = (128, 128)
L2_SECTOR = 32  # bytes


def conv_l2_bytes(n, h, w, c, co):
    """Bytes one conv3x3 call moves from L2 into the SMs, counted from the
    schedule, as {"old", "new"}: the mma.sync design (per 128-pixel x
    128-channel tile, 9 C x 128 pixels of x and 9 C x 128 channels of
    weights) and csrc/conv3x3.cu's (per kBH x kBW pixel tile and kBN
    channels, three x boxes of (kBH + 2) x kBW pixels a channel box, one
    for each dx, and all 9 C x kBN weights)."""
    k = kernel_constants("conv3x3.cu", "kBH", "kBW", "kBN")
    bh, bw, bn = k["kBH"], k["kBW"], k["kBN"]
    om, on = OLD_CONV_TILE
    old = -(-(n * h * w) // om) * -(-co // on) * 9 * c * (om + on) * 2
    tiles = n * -(-h // bh) * -(-w // bw) * -(-co // bn)
    return dict(old=old, new=tiles * (3 * c * (bh + 2) * bw + 9 * c * bn) * 2)


def _sectors(offsets):
    """Distinct L2 sectors a warp's 4-byte loads touch, summed over warps:
    ``offsets`` (loads, 32 lanes) of float offsets, -1 for none."""
    import numpy as np

    sec = np.where(offsets >= 0, offsets * 4 // L2_SECTOR, -1)
    sec = np.sort(sec, axis=1)
    new = np.concatenate([sec[:, :1] >= 0, (sec[:, 1:] != sec[:, :-1])
                          & (sec[:, 1:] >= 0)], axis=1)
    return int(new.sum())


def _gather_offsets(idx, r, c, mode):
    """(offsets into an image, -1 out of range; in range) of a shared (R',
    C') index plane."""
    import numpy as np

    i = np.asarray(idx, np.int64)
    length = r * c if mode == "flat" else (r, c)[mode]
    k = np.where(i < 0, i + length, i)
    inr = (k >= 0) & (k < length)
    if mode == "flat":
        off = k
    elif mode == 0:
        off = k * c + np.arange(i.shape[1])
    else:
        off = np.arange(i.shape[0])[:, None] * c + k
    return np.where(inr, off, -1), inr


def gather_l2_bytes(idx, n, r, c, mode, sms):
    """Source bytes one gather call moves from L2 into the SMs, for a shared
    index plane, as {"old", "new"}: the per-element kernel that served every
    mode before the windows (a thread's four neighbouring elements, a warp's
    128 along the flattened plane, one load instruction per element of four)
    and csrc/gather_probe.cu's (a staged tile's window per image, a direct
    tile's warps of 32 columns of one row), both counted as the 32-byte
    sectors a warp's loads touch with no reuse in L1; plus the index plane,
    read once per chunk in the old design and once per block in the new.
    The column mode and calls of fewer tiles than ``sms`` keep the
    per-element path. An upper bound on what L1 lets through."""
    import numpy as np

    from ddti_tpu_torch.probes import gather_probe as G

    off, _ = _gather_offsets(idx, r, c, mode)
    ir, ic = off.shape
    m = off.size
    flat = np.full(-(-m // 128) * 128, -1, np.int64)
    flat[:m] = off.reshape(-1)
    # old: warp w, instruction e, lane l reads element 128 w + 4 l + e
    old = _sectors(flat.reshape(-1, 32, 4).transpose(0, 2, 1).reshape(-1, 32))
    old = old * L2_SECTOR * n + m * 4
    tiles = -(-ir // G.TILE) * -(-ic // G.TILE)
    if mode == 1 or tiles * n < sms:  # the per-element path, as before
        return dict(old=old, new=old)
    plan = G.plan_windows(idx, r, c, mode, n=n, sms=sms)
    tiled = G._tile_view(off[None], -1)[0]
    new = 0
    for tr, tc in zip(*np.nonzero(~plan["staged"][0])):
        new += _sectors(tiled[tr, :, tc, :].reshape(-1, 32)) * L2_SECTOR
    new = (new + int(plan["bytes"][0][plan["staged"][0]].sum())) * n
    return dict(old=old, new=new + m * 4)


def gather_bank_wavefronts(idx, r, c, mode, pad=0):
    """Shared-memory wavefronts a warp's load from a staged window takes,
    averaged over the staged tiles of a shared (R', C') index plane: a warp
    reads 32 neighbouring columns of one output row of a tile, at (source
    row - rlo) x stride + source column - clo with a window-row stride of
    cols + ``pad`` floats; each distinct word in one of the 32 banks is one
    wavefront, the busiest bank's count the load's. 1.0 is conflict-free;
    None where no tile stages."""
    import numpy as np

    from ddti_tpu_torch.probes import gather_probe as G

    plan = G.plan_windows(idx, r, c, mode, n=1, sms=1)
    off, inr = _gather_offsets(idx, r, c, mode)
    rows, cols = off // c, off % c  # flat and row mode alike
    t = G.TILE
    fronts = []
    for tr, tc in zip(*np.nonzero(plan["staged"][0])):
        win = (slice(tr * t, (tr + 1) * t), slice(tc * t, (tc + 1) * t))
        stride = plan["cols"][0, tr, tc] + pad
        at = ((rows[win] - plan["rlo"][0, tr, tc]) * stride + cols[win]
              - plan["clo"][0, tr, tc])
        tile = np.full((t, t), -1, np.int64)  # a ragged edge tile padded
        tile[:at.shape[0], :at.shape[1]] = np.where(inr[win], at, -1)
        for load in tile.reshape(-1, 32):
            words = np.unique(load[load >= 0])
            if words.size:
                fronts.append(np.bincount(words % 32, minlength=32).max())
    return float(np.mean(fronts)) if fronts else None


def sdpa_yardstick(q, k, v, do=None):
    """The fastest backend of torch's scaled_dot_product_attention on these
    (B, H, S, D) inputs: the forward, or with ``do`` the backward alone
    (torch.autograd.grad of one forward, its graph retained). Returns (ms,
    backend name, queued ms), the fastest by ``median_ms`` and its
    ``queued_ms`` device time, or (None, None, None) where no backend takes
    the inputs. A yardstick only: the port never calls it."""
    import warnings

    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    best = (None, None, None)
    for name in SDPA_BACKENDS:
        try:
            with warnings.catch_warnings(), \
                    sdpa_kernel(getattr(SDPBackend, name)):
                warnings.simplefilter("ignore")
                if do is None:
                    def fn():
                        sdpa(q, k, v)
                else:
                    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                    o = sdpa(*leaves)

                    def fn():
                        torch.autograd.grad(o, leaves, do, retain_graph=True)
                ms = median_ms(fn)
                if best[0] is None or ms < best[0]:
                    best = (ms, name, queued_ms(fn)[1])
                del fn
        except (RuntimeError, NotImplementedError, ValueError):
            continue  # the backend does not take these inputs
    return best


def queued_ms(fn, calls=HOST_CALLS):
    """(host_ms, device_ms) per call of ``fn``: the host clock over
    ``calls`` calls enqueued back to back with no synchronisation inside,
    and CUDA events around the same calls, which wait behind a device-side
    sleep until all are enqueued, so that no launch waits for the host.
    ``median_ms`` of one call also counts the host's latency up to the
    first launch, which is most of it for a kernel of 0.1 ms."""
    import torch

    for scale in SLEEP_SCALES:
        torch.cuda.synchronize()
        slept = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        slept.record()
        torch.cuda._sleep(SLEEP_CYCLES * scale)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms < slept.elapsed_time(start):
            return host_ms / calls, start.elapsed_time(end) / calls
    raise AssertionError("the device-side sleep ended before the calls were "
                         "enqueued")


def launch_ms(fn, calls=HOST_CALLS):
    """Device time per call of each kernel entry point that ``fn`` reaches
    through ``_build.launch`` (one entry point may launch more than one
    kernel): CUDA events recorded on the current stream, which the wrappers
    launch on, just before and just after each entry point, over ``calls``
    calls queued behind a device-side sleep. Needs no profiler. Returns
    {entry point: ms per call}."""
    import torch

    from ddti_tpu_torch.ops import _build

    fn()
    torch.cuda.synchronize()
    launch, marks = _build.launch, []

    def timed(name, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(name, *args)
        end.record()
        marks.append((name, start, end))

    _build.launch = timed
    try:
        for scale in SLEEP_SCALES:
            marks.clear()
            slept = torch.cuda.Event(enable_timing=True)
            woke = torch.cuda.Event(enable_timing=True)
            slept.record()
            torch.cuda._sleep(SLEEP_CYCLES * scale)
            woke.record()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            if host_ms < slept.elapsed_time(woke):
                break
        else:
            raise AssertionError("the device-side sleep ended before the "
                                 "calls were enqueued")
    finally:
        _build.launch = launch
    assert marks, "no kernel entry point was called"
    ms = {}
    for name, start, end in marks:
        ms[name] = ms.get(name, 0.0) + start.elapsed_time(end) / calls
    return ms


def profiled_ms(fn, keys, calls=BWD_PROFILE_CALLS, tries=3):
    """Device time per call of ``fn`` from torch.profiler, summed over the
    kernels whose names hold each of ``keys`` (a dict: label -> tuple of
    name fragments); None for a label whose kernels the profiler recorded in
    none of ``tries`` windows (it has dropped every event of a kernel in
    some runs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    split = dict.fromkeys(keys)
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        # each kernel runs once a call: its mean over the launches the
        # profiler recorded, which stays right where it drops some of them
        got = dict.fromkeys(keys, 0.0)
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA or not e.count:
                continue
            for label, frags in keys.items():
                if any(f in e.key for f in frags):
                    got[label] += e.self_device_time_total / e.count / 1e3
                    break
        for label, ms in got.items():
            if split[label] is None and ms:
                split[label] = ms
        if all(split.values()):
            break
    return split


def _bound_text(kernel, shape, dtype, ms):
    bound_ms, by, exp2_ms = bound(kernel, shape, dtype)
    return (f"bound {bound_ms:.4f} ms ({by}; {bound_ms / ms:.1%} of it "
            f"reached), exp2 floor {exp2_ms:.4f} ms")


def kernel_report(lib, quiet=False):
    """Each kernel's registers and spills from the build's ptxas report,
    and the SASS opcodes that show how it runs (cuobjdump -sass): HGMMA
    (wgmma), UTMALDG (TMA loads), SYNCS (mbarriers), HMMA (mma.sync),
    atomics, and the exp2 unit's MUFU.EX2 beside FRND and F2I (which issue
    at its rate). The bf16 flash kernels (the forward, dK/dV and dQ) and the
    float32 ones (the forward but its FMA loop for heads above 128, dK/dV
    and dQ) must run on wgmma and TMA loads, and no flash kernel may use an
    atomic. Prints a line a kernel (none where ``quiet``) and every line in
    which ptxas reports a performance loss. Returns ({kernel: registers,
    spills}, {kernel: opcode counts}); the m-skip forward is named
    ``flash_fwd_bf16_kernel<DP,mskip>``."""
    import re
    import shutil

    def short(name):
        m = re.search(r"\dgather_kernelILi(\d)ELb([01])ELb([01])E", name)
        if m:  # <mode, 16-byte, shared index>
            return f"gather_kernel<{m.group(1)},{m.group(2)},{m.group(3)}>"
        m = re.search(r"\dedt_column_kernelILi(\d+)E([jm])", name)
        if m:  # <columns a lane, bits a word>
            return (f"edt_column_kernel<{m.group(1)},"
                    f"{32 if m.group(2) == 'j' else 64}>")
        m = re.search(r"\dtiled_gather_kernelILi(\d)ELb([01])E", name)
        if m:  # <mode, shared index>
            return f"tiled_gather_kernel<{m.group(1)},{m.group(2)}>"
        m = re.search(r"\d((?:flash|edt|exp2|conv3x3)_\w+?_kernel)"
                      r"(?:ILi(\d+)E(Lb1E)?|I(\w)|E)", name)
        if not m:
            return name
        arg = m.group(2) or m.group(4)
        arg = f"{arg},mskip" if m.group(3) else arg
        return f"{m.group(1)}<{arg}>" if arg else m.group(1)

    regs, cur = {}, None
    with open(os.path.splitext(lib)[0] + ".log") as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = short(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and cur:
                regs.setdefault(cur, {})["spill"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                regs.setdefault(cur, {})["regs"] = int(m.group(1))
            if "Performance Loss" in line:
                phase("build", f"ptxas: {line.strip()[:200]}")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    ops = {}
    for chunk in sass.split("Function : ")[1:]:
        name = short(chunk.split(None, 1)[0])
        ops[name] = {op: len(re.findall(pat, chunk)) for op, pat in (
            ("HGMMA", r"\bHGMMA\."), ("UTMALDG", r"\bUTMALDG"),
            ("SYNCS", r"\bSYNCS\."), ("HMMA", r"\bHMMA\."),
            ("atomic", r"\b(?:ATOM|ATOMG|ATOMS|RED)\b"),
            ("MUFU.EX2", r"\bMUFU\.EX2\b"), ("FRND", r"\bFRND\b"),
            ("F2I", r"\bF2I\b"))}
    for name in [] if quiet else sorted(set(regs) | set(ops)):
        r, o = regs.get(name, {}), ops.get(name, {})
        phase("build", f"{name}: {r.get('regs')} registers, "
              f"{r.get('spill')} bytes spilled; SASS "
              + " ".join(f"{k} {v}" for k, v in o.items()))
    for name, o in ops.items():
        if name.startswith("flash_"):
            assert o["atomic"] == 0, f"{name} uses atomics"
        if name.startswith(("flash_fwd_bf16", "flash_fwd_f32",
                            "flash_bwd_dkdv_bf16", "flash_bwd_dq_bf16",
                            "flash_bwd_dkdv_f32", "flash_bwd_dq_f32")) \
                and name != "flash_fwd_f32_fma_kernel<256>":
            assert o["HGMMA"] and o["UTMALDG"] and o["SYNCS"], \
                f"{name} issues no wgmma or TMA load"
        if name.startswith("conv3x3_relu_kernel"):
            assert o["HGMMA"] and o["UTMALDG"] and o["SYNCS"] \
                and o["HMMA"] == 0, \
                f"{name} does not run on wgmma and TMA alone: {o}"
    assert sum(n.startswith("conv3x3_relu_kernel") for n in ops) == 2, \
        "the conv3x3 kernel's two instances (boxes of 32 and 64 channels)"
    return regs, ops


def check_poly_build(path, default_ops):
    """The DDTI_POLY_EXP2=1 library at ``path`` against the default one's
    opcode counts. Its poly paths are the flash kernels whose default build
    runs MUFU.EX2 and exp2_probe's poly modes: none of them may issue
    MUFU.EX2, nor FRND or F2I (which run at the exp2 unit's rate) beyond
    what the default kernel (for the probe, its copy mode) issues without
    the polynomial."""
    regs, ops = kernel_report(path, quiet=True)
    keys = ("MUFU.EX2", "FRND", "F2I")
    base = {n: default_ops[n] for n in ops if n.startswith("flash_")
            and default_ops[n]["MUFU.EX2"]}
    base.update({f"exp2_probe_kernel<{m}>": default_ops["exp2_probe_kernel<0>"]
                 for m in (4, 5, 6)})
    for name, d in sorted(base.items()):
        o, r = ops[name], regs.get(name, {})
        phase("build", f"poly {name}: {r.get('regs')} registers, "
              f"{r.get('spill')} bytes spilled; " + " ".join(
                  f"{k} {o[k]} (without the polynomial {d[k]})"
                  for k in keys))
    assert len(base) > 3 and all(ops[n]["MUFU.EX2"] == 0 for n in base), \
        "a poly path issues MUFU.EX2"
    assert all(ops[n][k] <= d[k] for n, d in base.items()
               for k in ("FRND", "F2I")), "a poly path issues FRND or F2I"
    assert default_ops["exp2_probe_kernel<1>"]["MUFU.EX2"], \
        "exp2_probe's builtin mode does not run on the exp2 unit"


def check_kernels():
    import torch

    from ddti_tpu_torch.ops import attention as A

    rows = []
    for b, h, s, d, dt in KERNEL_SHAPES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v = (torch.randn((b, h, s, d), generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        o, lse = A.flash_forward_cuda(q, k, v)
        torch.cuda.synchronize()
        o_ref, lse_ref = A.flash_forward_reference(q, k, v)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        finite = bool(torch.isfinite(o.float()).all()
                      and torch.isfinite(lse).all())
        twice_equal = all(torch.equal(a, w) for a, w in zip(
            (o, lse), A.flash_forward_cuda(q, k, v)))
        ms = median_ms(lambda: A.flash_forward_cuda(q, k, v))
        host_ms, queue_ms = queued_ms(lambda: A.flash_forward_cuda(q, k, v))
        # float32 at D <= 128: the TF32 split pre-pass, its own entry point
        # (none in trees before the float32 forward ran on the tensor cores)
        split = launch_ms(lambda: A.flash_forward_cuda(q, k, v))
        device_ms = sum(split.values())
        prep_ms = split.get("flash_fwd_split_f32")
        plain_ms = median_ms(lambda: A.flash_forward_reference(q, k, v))
        lib_ms, lib, lib_queue_ms = sdpa_yardstick(q, k, v)
        shape = (b, h, s, d)
        bound_ms, bound_by, exp2_ms = bound("flash_fwd", shape, dt)
        phase("kernels", f"flash_fwd {shape} {dt}: max|do| {err_o:.3e} "
              f"(limit {O_LIMIT[dt]:g}) max|dlse2| {err_lse:.3e} (limit "
              f"{LSE_LIMIT:g}), two calls bit-equal {twice_equal}; kernel "
              f"{ms:.4f} ms (queued {queue_ms:.4f}, events at the launch "
              f"{device_ms:.4f}"
              + (f" of which the split pre-pass {prep_ms:.4f}" if prep_ms
                 else "")
              + f"; host enqueue {host_ms:.4f}) plain "
              f"{plain_ms:.4f} ms; SDPA forward {lib_ms} ms (queued "
              f"{lib_queue_ms}; {lib}); "
              + _bound_text("flash_fwd", shape, dt, device_ms))
        assert twice_equal, "two calls of the forward differ"
        assert finite, "non-finite kernel output"
        assert err_o <= O_LIMIT[dt] and err_lse <= LSE_LIMIT, \
            "kernel disagrees with its plain version"
        rows.append(dict(shape=[b, h, s, d], dtype=dt, max_abs_err=err_o,
                         max_abs_err_lse2=err_lse, ms=ms, queue_ms=queue_ms,
                         device_ms=device_ms, prepass_ms=prep_ms,
                         host_ms=host_ms,
                         plain_ms=plain_ms, library_ms=lib_ms, library=lib,
                         library_queue_ms=lib_queue_ms, bound_ms=bound_ms,
                         bound_by=bound_by, exp2_ms=exp2_ms))
    return rows


def check_bwd_kernels():
    """csrc/flash_bwd.cu against flash_backward_reference on the forward
    kernel's o and lse2: dq, dk, dv against G_LIMIT and two calls
    bit-equal; the whole backward's time (one call between CUDA events, and
    queued) beside the plain one's and SDPA's backward, each entry point's
    device time from CUDA events around its launch (the pre-pass counted
    with dK/dV, as one entry point launches both), the pre-pass's own from
    torch.profiler where it recorded it, the wrapper's host enqueue
    time."""
    import torch

    from ddti_tpu_torch.ops import attention as A

    rows = []
    for b, h, s, d, dt in BWD_SHAPES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v, do = (torch.randn((b, h, s, d), generator=g, device="cuda")
                       .to(dtype) for _ in range(4))
        o, lse = A.flash_forward_cuda(q, k, v)
        args = (q, k, v, o, lse, do)
        got = A.flash_backward_cuda(*args)
        again = A.flash_backward_cuda(*args)
        torch.cuda.synchronize()
        want = A.flash_backward_reference(*args)
        abs_err, rel_err = {}, {}
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert torch.isfinite(a.float()).all(), f"non-finite {name}"
            abs_err[name] = (a.float() - w.float()).abs().max().item()
            rel_err[name] = abs_err[name] / max(
                w.float().abs().max().item(), 1e-30)
        twice_equal = all(torch.equal(a, w) for a, w in zip(got, again))
        del got, again, want
        ms = median_ms(lambda: A.flash_backward_cuda(*args))
        host_ms, queue_ms = queued_ms(lambda: A.flash_backward_cuda(*args))
        plain_ms = median_ms(lambda: A.flash_backward_reference(*args))
        lib_ms, lib, lib_queue_ms = sdpa_yardstick(q, k, v, do)
        split = launch_ms(lambda: A.flash_backward_cuda(*args))
        split = dict(dkdv=split["flash_bwd_dkdv"], dq=split["flash_bwd_dq"])
        # the pre-pass alone; flash_bwd_delta in trees before the float32
        # kernels ran on the tensor cores (for --ab)
        prep_ms = profiled_ms(lambda: A.flash_backward_cuda(*args), {
            "rows": ("flash_bwd_rows", "flash_bwd_delta")})["rows"]
        prep_text = ("not recorded" if prep_ms is None
                     else f"{prep_ms:.4f}")
        shape = (b, h, s, d)
        bounds = {n: bound(n, shape, dt) for n in
                  ("flash_bwd", "flash_bwd_dkdv", "flash_bwd_dq")}
        phase("kernels", f"flash_bwd {shape} {dt}: max|d|/max|g| "
              + " ".join(f"{n} {e:.3e}" for n, e in rel_err.items())
              + f" (limit {G_LIMIT[dt]:g}); two calls bit-equal "
              f"{twice_equal}; kernels {ms:.4f} ms (queued {queue_ms:.4f}; "
              f"events at the launch: pre-pass + dK/dV {split['dkdv']:.4f} "
              f"(profiler: pre-pass {prep_text}), dQ "
              f"{split['dq']:.4f}; host enqueue {host_ms:.4f}) plain "
              f"{plain_ms:.4f} ms; SDPA backward {lib_ms} ms (queued "
              f"{lib_queue_ms}; {lib}); pair "
              + _bound_text("flash_bwd", shape, dt,
                            split["dkdv"] + split["dq"])
              + "; dK/dV " + _bound_text("flash_bwd_dkdv", shape, dt,
                                         split["dkdv"])
              + "; dQ " + _bound_text("flash_bwd_dq", shape, dt, split["dq"]))
        assert max(rel_err.values()) <= G_LIMIT[dt], \
            "a backward kernel disagrees with its plain version"
        assert twice_equal, "two calls of the backward differ"
        rows.append(dict(
            shape=[b, h, s, d], dtype=dt, abs_err=abs_err, rel_err=rel_err,
            ms=ms, queue_ms=queue_ms, host_ms=host_ms, ms_dkdv=split["dkdv"],
            ms_prepass=prep_ms,
            ms_dq=split["dq"], plain_ms=plain_ms, library_ms=lib_ms,
            library=lib, library_queue_ms=lib_queue_ms,
            bound_ms=bounds["flash_bwd"][0], bound_by=bounds["flash_bwd"][1],
            exp2_ms=bounds["flash_bwd"][2],
            bound_ms_dkdv=bounds["flash_bwd_dkdv"][0],
            bound_ms_dq=bounds["flash_bwd_dq"][0]))
    return rows


def decide(fwd_rows, bwd_rows):
    """The ratios that order the kernels' redesigns, at the slice's shape
    (16, 8, 1024, 32) bf16: r_fwd = forward ms / fastest SDPA forward and
    r_bwd = backward pair ms / fastest SDPA backward, from one call between
    CUDA events each (``median_ms``, which counts the host's latency too),
    and the same ratios of the queued device times (``queued_ms``). A
    kernel slower than the library call comes first, the larger factor
    first, by device time. Returns the four ratios by name."""
    f, b = fwd_rows[0], bwd_rows[0]
    r = dict(r_fwd=f["ms"] / f["library_ms"],
             r_bwd=b["ms"] / b["library_ms"],
             r_fwd_queued=f["queue_ms"] / f["library_queue_ms"],
             r_bwd_queued=b["queue_ms"] / b["library_queue_ms"])
    slower = sorted(((q, n) for q, n in (
        (r["r_fwd_queued"], "the forward"),
        (r["r_bwd_queued"], "the backward pair")) if q > 1), reverse=True)
    phase("kernels", f"r_fwd {r['r_fwd']:.3f} (flash_fwd {f['ms']:.4f} / "
          f"SDPA {f['library_ms']:.4f} ms, {f['library']}), r_bwd "
          f"{r['r_bwd']:.3f} (pair {b['ms']:.4f} / SDPA "
          f"{b['library_ms']:.4f} ms, {b['library']}); queued: r_fwd "
          f"{r['r_fwd_queued']:.3f}, r_bwd {r['r_bwd_queued']:.3f}; slower "
          "than SDPA by device time: "
          + (", ".join(n for _, n in slower) or "neither"))
    return r


def kernel_phases():
    """Phase 3's flash rows: the forward, the backward and the ratios that
    order their redesigns. Returns (forward rows, backward rows, ratios)."""
    rows = check_kernels()
    bwd_rows = check_bwd_kernels()
    return rows, bwd_rows, decide(rows, bwd_rows)


def check_probes():
    """Phase 4: the probes of benchmarks/ as the port runs them. Returns
    what the kernels line reports of exp2_probe, the m-skip forward and the
    poly build."""
    import torch

    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.probes import exp2_probe as E2
    from ddti_tpu_torch.probes import flash_mskip_ab as MS
    from ddti_tpu_torch.probes import flash_poly_ab as PA

    phase("probes", f"exp2_probe {(E2.ROWS, E2.COLS)} float32 uniform on "
          f"[{E2.LOW}, {E2.HIGH}), seed {SEED} (the CPU's max rel err: "
          "poly4 5.6e-5, poly5 3.3e-6, poly6 2.2e-7):")
    e2 = E2.run(seed=SEED)
    x = E2.make_input(E2.ROWS, E2.COLS, SEED, "cuda")
    e2["plain_ms"] = median_ms(lambda: E2.exp2_probe_reference(x, "poly6"))
    edges = torch.tensor(EXP2_EDGES, device="cuda")
    edge_ulps = {}
    for mode in E2.MODES:
        got = E2.exp2_probe_cuda(edges, mode)
        want = E2.exp2_probe_reference(edges, mode)
        assert not torch.isnan(got).any(), f"exp2_probe {mode}: NaN"
        edge_ulps[mode] = E2.ulp_distance(got, want)
        if mode == "copy":
            assert torch.equal(got.view(torch.int32), edges.view(torch.int32))
    e2["edge_ulps"] = edge_ulps
    ulps = {m: r["ulps_vs_plain"] for m, r in e2["modes"].items()}
    phase("probes", f"exp2_probe vs plain, ulps on the probe's input {ulps}, "
          f"on {len(EXP2_EDGES)} edge values {edge_ulps} (limit "
          f"{EXP2_ULPS}; copy bit for bit); plain poly6 "
          f"{e2['plain_ms']:.4f} ms")
    assert ulps["copy"] == 0 and edge_ulps["copy"] == 0
    assert max(ulps.values()) <= EXP2_ULPS \
        and max(edge_ulps.values()) <= EXP2_ULPS, \
        "exp2_probe disagrees with its plain version"

    phase("probes", "flash_mskip_ab (B, H, S, D) = "
          f"{(MS.B, MS.H, MS.S, MS.D)} bfloat16, seed {SEED}:")
    ms = MS.run(seed=SEED)
    assert ms["bit_equal"], "the m-skip forward differs from the baseline"
    rows = []
    for shape in MSKIP_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        o, lse = MS.flash_forward_mskip_cuda(q, k, v)
        o0, lse0 = A.flash_forward_cuda(q, k, v)
        torch.cuda.synchronize()
        o_ref, lse_ref = MS.flash_forward_mskip_reference(q, k, v)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        bit = torch.equal(o, o0) and torch.equal(lse, lse0)
        row = dict(shape=list(shape), bit_equal_to_flash_fwd=bit,
                   max_abs_err=err_o, max_abs_err_lse2=err_lse)
        row["stale_share"] = MS.flash_forward_mskip_reference.stale_share
        if shape == MSKIP_SHAPES[0]:
            row["plain_ms"] = median_ms(
                lambda: MS.flash_forward_mskip_reference(q, k, v))
            lib_ms, lib, lib_queue_ms = sdpa_yardstick(q, k, v)
            row.update(library_ms=lib_ms, library=lib,
                       library_queue_ms=lib_queue_ms)
        phase("probes", f"flash_fwd_mskip {shape} bfloat16: bit-equal to "
              f"flash_fwd (o, lse2) {bit}; vs its plain version max|do| "
              f"{err_o:.3e} (limit {O_LIMIT['bfloat16']:g}) max|dlse2| "
              f"{err_lse:.3e} (limit {LSE_LIMIT:g}); the plain version took "
              f"the stale branch on {row['stale_share']:.1%} of (16-row "
              f"group, 64-key tile) pairs"
              + (f"; plain {row['plain_ms']:.4f} ms, SDPA forward "
                 f"{row['library_ms']} ms (queued "
                 f"{row['library_queue_ms']}; {row['library']})"
                 if "plain_ms" in row else ""))
        assert bit, "the m-skip forward differs from the production forward"
        assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
        assert err_o <= O_LIMIT["bfloat16"] and err_lse <= LSE_LIMIT, \
            "the m-skip forward disagrees with its plain version"
        rows.append(row)
    ms["shapes"] = rows

    # the flash kernels built with the polynomial, in a process of their own
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--poly-child"], capture_output=True, text=True,
                         env=dict(os.environ, DDTI_POLY_EXP2="1"),
                         timeout=POLY_TIMEOUT_S)
    lines = res.stdout.splitlines()
    for line in lines:
        if not line.startswith("[poly] "):
            print(line, flush=True)
    if res.returncode != 0:
        print(res.stderr[-8000:], file=sys.stderr)
    assert res.returncode == 0, "the DDTI_POLY_EXP2=1 flash checks failed"
    poly = json.loads(next(l for l in lines if l.startswith("[poly] "))[7:])

    phase("probes", f"flash_poly_ab (B, H, S, D) = {(PA.B, PA.H, PA.S, PA.D)}"
          " bfloat16, one process per setting of DDTI_POLY_EXP2:")
    ab_rows = PA.run(seed=SEED)
    assert all(r["finite"] == "True" for r in ab_rows), "non-finite output"
    return dict(exp2_probe=e2, mskip=ms, poly=poly, poly_ab=ab_rows)


def check_conv_gather():
    """Phase 4, the conv3x3 and warp-gather probes: each kernel against its
    plain version at the listed shapes (outside any launch count), then
    each probe's ``run()``, the path a user drives, with its kernel's count
    set to 0 just before and read just after; it must launch. Returns what
    the kernels line reports of both."""
    import torch

    from ddti_tpu_torch.probes import gather_probe as G
    from ddti_tpu_torch.probes import gather_probe2 as G2
    from ddti_tpu_torch.probes import gather_probe3 as G3
    from ddti_tpu_torch.probes import pallas_conv_probe as P
    from ddti_tpu_torch.probes._timing import queued_ms as device_ms

    conv_rows = []
    for shape in CONV_SHAPES + [(CONV_GROWTH[0], CONV_GROWTH[1],
                                 CONV_GROWTH[1], c, c)
                                for c in CONV_GROWTH[2]]:
        n, h, w, c, co = shape
        x, wk, b = P.make_inputs(n, max(h, w), c, co, seed=SEED, device="cuda")
        x = x[:, :h, :w].contiguous()
        wt = P.pack_weights(wk)
        y = P.conv3x3_relu_cuda(x, wt, b)
        again = P.conv3x3_relu_cuda(x, wt, b)
        torch.cuda.synchronize()
        ok, err, share = P.within_tolerance(
            y, P.conv3x3_relu_reference(x, wk, b))
        bit = torch.equal(y, again)
        conv_rows.append(dict(shape=list(shape), within=ok, max_abs_err=err,
                              differ_share=share, deterministic=bit))
        phase("probes", f"conv3x3 {shape} bf16 vs plain: max|d| {err:.3e}, "
              f"{share:.3e} of elements differ, within one bf16 ulp or "
              f"2^-8 max|y|: {ok}; two calls bit-equal {bit}")
        assert ok and bit and bool(torch.isfinite(y.float()).all()), \
            f"conv3x3 {shape} disagrees with its plain version"
        del x, wk, b, wt, y, again
    # the float32 sum's error where the bf16 output can see it: b cancels
    # a sum of 9 C positive products, an interior y is ~1 (P.cancelling_
    # inputs); within P.CANCEL_LIMIT at every C, kernel and plain
    growth = {}
    for c in CONV_GROWTH[2]:
        x, wk, b, exact = P.cancelling_inputs(CONV_GROWTH[0], CONV_GROWTH[1],
                                              c, seed=SEED, device="cuda")
        errs = [(y.float()[:, 1:-1, 1:-1] - exact.float()).abs().max().item()
                for y in (P.conv3x3_relu_cuda(x, P.pack_weights(wk), b),
                          P.conv3x3_relu_reference(x, wk, b))]
        growth[c] = dict(kernel=errs[0], plain=errs[1])
        del x, wk, b, exact
    phase("probes", f"conv3x3 error growth, |y - exact| where b cancels a "
          f"sum of 9 C positive products (y ~1, limit {P.CANCEL_LIMIT:g}; "
          f"a truncating accumulator ~0.07 at C = 512), by C: "
          + ", ".join(f"{c}: kernel {e['kernel']:.3e} plain {e['plain']:.3e}"
                      for c, e in growth.items()))
    assert max(max(e.values()) for e in growth.values()) <= P.CANCEL_LIMIT, \
        "conv3x3's float32 sum drifts with C"

    phase("probes", f"pallas_conv_probe N{P.N} {P.SPATIAL}^2 C = CO = "
          f"{P.CHANNELS} bf16, seed {SEED}:")
    P.conv3x3_relu_cuda.launches = 0
    conv = P.run(seed=SEED)
    conv_launches = P.conv3x3_relu_cuda.launches
    conv_shape = (P.N, P.SPATIAL, P.SPATIAL, P.CHANNELS, P.CHANNELS)
    b_ms, b_by, _ = bound("conv3x3", conv_shape)
    l2 = conv_l2_bytes(*conv_shape)
    phase("probes", f"conv3x3 {conv_shape}: kernel {conv['ms']:.4f} ms, "
          f"cuDNN {conv['library_ms']:.4f} ms, plain {conv['plain_ms']:.4f} "
          f"ms (queued device time); bound {b_ms:.4f} ms ({b_by}): kernel "
          f"{b_ms / conv['ms']:.1%} of it, cuDNN "
          f"{b_ms / conv['library_ms']:.1%}; {conv_launches} launches; L2 -> "
          f"SM bytes a call (conv_l2_bytes) {l2['new'] / 1e9:.3f} GB (the "
          f"mma.sync design {l2['old'] / 1e9:.3f} GB), "
          f"{l2['new'] / conv['ms'] / 1e9:.2f} TB/s")
    assert conv["within"] and conv_launches > 0

    # every mode on the builders' shapes with edge indices planted: -1 and
    # -len wrap, len and -len - 1 give NaN; bit for bit (NaN's bits too)
    edge_rows = []
    src = torch.from_numpy(G.make_src((G.N, G.H, G.W), SEED)).cuda()
    for mode, shape in (("flat", (G.H, G.W)), (0, (G.H, G.W)),
                        (1, (G.H, G.W)), (0, (2048, 128)), (1, (512, 128))):
        s = src if shape == (G.H, G.W) else \
            torch.from_numpy(G.make_src(shape, SEED)).cuda()
        r, c = s.shape[-2:]
        length = r * c if mode == "flat" else (r, c)[mode]
        g = torch.Generator(device="cuda").manual_seed(SEED)
        idx = torch.randint(0, length, shape, generator=g, device="cuda",
                            dtype=torch.int32)
        idx.view(-1)[:4] = torch.tensor([-1, -length, length, -length - 1],
                                        dtype=torch.int32)
        got = G.gather_cuda(s, idx, mode)
        want = G.gather_reference(s, idx, mode)
        torch.cuda.synchronize()
        bit = torch.equal(got.view(torch.int32), want.view(torch.int32))
        nans = int(torch.isnan(got).sum())
        edge_rows.append(dict(mode=str(mode), shape=list(s.shape),
                              bit_equal=bit, nan=nans))
        phase("probes", f"gather {tuple(s.shape)} mode {mode} with edge "
              f"indices: bit-equal to plain {bit}, {nans} NaN (want "
              f"{(s.shape[0] if s.dim() == 3 else 1) * 2})")
        assert bit and nans == (s.shape[0] if s.dim() == 3 else 1) * 2, \
            "the gather kernel differs from its plain version"

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the staged path's edges (a window at the cap and past it, wrapping
    # and out-of-range indices inside a staged tile, per-image planes):
    # bit for bit, and the kernel's count of staged (tile, image) pairs
    # equal to plan_windows'; the case that mixes staged and direct tiles
    # timed beside torch.gather
    for name, (s_np, i_np, mode) in G.window_cases(SEED).items():
        s, i = torch.from_numpy(s_np).cuda(), torch.from_numpy(i_np).cuda()
        got, count = G.staged_count(s, i, mode)
        want = G.gather_reference(s, i, mode)
        plan = G.planned_staged(i_np, s.shape[0], *s.shape[-2:], mode,
                                sms=sms)
        bit = torch.equal(got.view(torch.int32), want.view(torch.int32))
        row = dict(mode=str(mode), case=name, shape=list(s.shape),
                   bit_equal=bit, staged=count)
        timed = ""
        if name == "flat per-image":
            index = G.torch_index(i, s.shape[0])
            row.update(ms=device_ms(lambda: G.gather_cuda(s, i, mode)),
                       library_ms=device_ms(
                           lambda: G.torch_gather(s, index, mode)))
            timed = (f"; {row['ms']:.4f} ms, torch.gather "
                     f"{row['library_ms']:.4f} ms (queued)")
        edge_rows.append(row)
        phase("probes", f"gather {name} {tuple(s.shape)} idx "
              f"{tuple(i.shape)}: bit-equal to plain {bit}, staged (tile, "
              f"image) pairs {count} (plan {plan}){timed}")
        assert bit and count == plan, \
            f"gather {name}: the staged path differs from plain or its plan"

    G.gather_cuda.launches = 0
    rows = {}
    for mod in (G, G2, G3):
        phase("probes", f"{mod.__name__.split('.')[-1]} N{G.N} "
              f"{G.H}x{G.W}, seed {SEED}:")
        rows.update(mod.run(seed=SEED))
    gather_launches = G.gather_cuda.launches
    kernel_rows = {k: r for k, r in rows.items() if "torch_call" not in r}
    assert len(kernel_rows) == 8 and all(r["match"] for r in rows.values()), \
        "a gather builder differs from the probe's want"
    assert gather_launches > 0
    # each builder through the kernel against the plain version on the card
    table = dict(G.builders())
    table.update(G2.builders()[0])
    table.update(G3.builders()[1])
    # (untimed calls: the timed ones pass no counter and carry no atomic);
    # the plan, the byte and bank models go to the phase line only
    models = {}
    for name, (s_np, i_np, mode, _) in table.items():
        s, i = torch.from_numpy(s_np).cuda(), torch.from_numpy(i_np).cuda()
        got, count = G.staged_count(s, i, mode)
        bit = torch.equal(got.view(torch.int32),
                          G.gather_reference(s, i, mode).view(torch.int32))
        n = s.shape[0] if s.dim() == 3 else 1
        key = name.strip()
        kernel_rows[key].update(bit_equal_to_plain=bit, staged=count)
        model = models[key] = dict(
            planned=G.planned_staged(i_np, n, *s.shape[-2:], mode, sms=sms),
            tiles=G.plan_windows(i_np, *s.shape[-2:],
                                 mode)["staged"].size * n)
        if i_np.ndim == 2 and s.dim() == 3:
            model["l2"] = gather_l2_bytes(i_np, n, *s.shape[-2:], mode, sms)
            model["banks"] = gather_bank_wavefronts(i_np, *s.shape[-2:],
                                                    mode)
        assert bit, f"gather builder {key} differs from plain"
        assert count == model["planned"], \
            f"gather builder {key}: staged {count}, plan says " \
            f"{model['planned']}"
    for key in ("A pallas flat take", "B pallas taa axis0",
                "B2 pallas taa ax0 promise"):
        assert kernel_rows[key]["staged"] == models[key]["tiles"], \
            f"gather builder {key}: a tile missed the staged path"
    assert kernel_rows["F  pallas dyn_gather lanes"]["staged"] == 0
    a_row = kernel_rows["A pallas flat take"]

    def models_text(m):
        text = f"staged {m['staged']} of {m['tiles']} (tile, image) pairs"
        if "l2" in m:
            text += (f"; L2 -> SM sectors {m['l2']['new'] / 1e6:.1f} MB, "
                     f"per-element {m['l2']['old'] / 1e6:.1f} MB")
        if m.get("banks"):
            text += f"; {m['banks']:.2f} shared-memory wavefronts a load"
        return text

    phase("probes", "gather builders through the kernel, bit-equal to "
          "plain (models: gather_l2_bytes, gather_bank_wavefronts): "
          + ", ".join(
              f"{k.split()[0]} {r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%}"
              f" of {r['bound_ms']:.5f}; torch.gather {r['library_ms']:.4f}; "
              + models_text(dict(models[k], staged=r["staged"])) + ")"
              for k, r in kernel_rows.items())
          + f"; {gather_launches} launches")
    return dict(conv=conv, conv_rows=conv_rows, conv_launches=conv_launches,
                conv_growth=growth, gather=rows, gather_edges=edge_rows,
                gather_launches=gather_launches, gather_a=a_row)


def poly_child():
    """Run as ``chip_smoke.py --poly-child`` with DDTI_POLY_EXP2=1: the
    flash forward and backward kernels of the poly build against their
    plain versions in poly mode at POLY_SHAPES (today's limits, no NaN),
    with their queued times; prints one line "[poly] {json}"."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ddti_tpu_torch.ops import _build
    from ddti_tpu_torch.ops import attention as A

    assert _build.USE_POLY_EXP2 and A.USE_POLY_EXP2, "DDTI_POLY_EXP2 unset"
    _build.load_library()
    rows = []
    for b, h, s, d, dt in POLY_SHAPES:
        shape = (b, h, s, d)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                       .to(getattr(torch, dt)) for _ in range(4))
        o, lse = A.flash_forward_cuda(q, k, v)
        args = (q, k, v, o, lse, do)
        got = A.flash_backward_cuda(*args)
        torch.cuda.synchronize()
        o_ref, lse_ref = A.flash_forward_reference(q, k, v)
        want = A.flash_backward_reference(*args)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        rel = {n: ((a.float() - w.float()).abs().max()
                   / w.float().abs().max().clamp(min=1e-30)).item()
               for n, a, w in zip(("dq", "dk", "dv"), got, want)}
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (o, lse, *got))
        del got, want, o_ref, lse_ref
        fwd_q = queued_ms(lambda: A.flash_forward_cuda(q, k, v))[1]
        pair_q = queued_ms(lambda: A.flash_backward_cuda(*args))[1]
        split = launch_ms(lambda: A.flash_backward_cuda(*args))
        row = dict(shape=list(shape), dtype=dt, max_abs_err=err_o,
                   max_abs_err_lse2=err_lse, rel_err=rel, finite=finite,
                   fwd_queue_ms=fwd_q, pair_queue_ms=pair_q,
                   dkdv_ms=split["flash_bwd_dkdv"],
                   dq_ms=split["flash_bwd_dq"])
        phase("probes", f"DDTI_POLY_EXP2=1 flash {shape} {dt} vs plain in "
              f"poly mode: forward max|do| {err_o:.3e} (limit "
              f"{O_LIMIT[dt]:g}) max|dlse2| {err_lse:.3e} (limit "
              f"{LSE_LIMIT:g}); backward max|d|/max|g| "
              + " ".join(f"{n} {e:.3e}" for n, e in rel.items())
              + f" (limit {G_LIMIT[dt]:g}); finite {finite}; queued: "
              f"forward {fwd_q:.4f} ms, pair {pair_q:.4f} ms (events at the "
              f"launch: pre-pass + dK/dV {row['dkdv_ms']:.4f}, dQ "
              f"{row['dq_ms']:.4f})")
        assert finite, "non-finite output of a poly flash kernel"
        assert err_o <= O_LIMIT[dt] and err_lse <= LSE_LIMIT, \
            "a poly forward disagrees with its plain version"
        assert max(rel.values()) <= G_LIMIT[dt], \
            "a poly backward kernel disagrees with its plain version"
        rows.append(row)
    print("[poly] " + json.dumps(rows), flush=True)


def random_state(model, seed):
    """Seeded random weights: He-scaled conv/linear weights, BatchNorm and
    LayerNorm affines near identity, BN statistics near (0, 1)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in model.state_dict().items():
        def normal(std):
            return torch.randn(t.shape, generator=g) * std
        if name.endswith("running_var"):
            sd[name] = torch.rand(t.shape, generator=g) + 0.5
        elif name.endswith("pos_emb"):
            sd[name] = normal(1.0)
        elif t.dim() == 1:
            sd[name] = normal(0.1) + (1.0 if name.endswith("weight") else 0.)
        else:
            fan_in = t.shape[0] if name.startswith("upconvs") else t[0].numel()
            sd[name] = normal((2.0 / fan_in) ** 0.5)
    return sd


def make_frames(n, size, seed):
    """Ultrasound-like test frames: speckle over a dark field with one
    brighter ellipse each, as uint8 (size, size)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    frames = []
    for _ in range(n):
        cy, cx, ry, rx = rng.uniform([0.3, 0.3, 0.08, 0.08],
                                     [0.7, 0.7, 0.25, 0.25])
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        img = 60 + 90 * inside + rng.normal(0, 25, (size, size))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def post(port, body, path="/predict?format=raw"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    conn.request("POST", path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    dt = time.perf_counter() - t0
    conn.close()
    return resp.status, dict(resp.getheaders()), data, dt


def get_json(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    assert resp.status == 200, (path, resp.status, body)
    return body


def run_batches(model, x, dtype):
    """uint8 (N, S, S, 1) frames -> (N, S, S) masks, BATCH at a time."""
    import torch

    from ddti_tpu_torch.train.export import make_serve_fn

    serve = make_serve_fn(model, compute_dtype=dtype)
    out = torch.cat([serve(x[i:i + BATCH]) for i in range(0, len(x), BATCH)])
    return out[..., 0].cpu().numpy()


def run_slice(tmp):
    import numpy as np
    import torch
    from PIL import Image

    from ddti_tpu_torch.cli import serve
    from ddti_tpu_torch.models import blocks, create_model
    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into

    model = create_model("TransUNet", **SLICE)
    n_params = sum(p.numel() for p in model.parameters())
    ckpt = os.path.join(tmp, "transunet_bf64_d4_512.pth")
    torch.save(random_state(model, SEED), ckpt)
    phase("slice", f"TransUNet {SLICE}: {n_params} parameters, random "
          f"weights (seed {SEED}) -> {os.path.basename(ckpt)}")

    args = serve.get_parser().parse_args(
        ["--checkpoint", ckpt, "--model_type", "TransUNet",
         "--base_filters", str(SLICE["base_filters"]),
         "--depth", str(SLICE["depth"]),
         "--image_size", str(SLICE["image_size"]),
         "--batch_size", str(BATCH), "--bf16", "--device", "cuda",
         "--port", "0"])
    t0 = time.perf_counter()
    server = serve.create_server(args)
    phase("slice", f"server up in {time.perf_counter() - t0:.2f} s "
          f"(load + warm-up batch) on port {server.server_address[1]}")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        health = get_json(port, "/healthz")
        phase("slice", f"/healthz {json.dumps(health)}")
        frames = make_frames(N_FRAMES, SLICE["image_size"], SEED)
        bodies = []
        for f in frames:
            buf = io.BytesIO()
            Image.fromarray(f, "L").save(buf, "PNG")
            bodies.append(buf.getvalue())

        A.flash_forward_cuda.launches = 0
        batches0 = server.batcher.n_batches
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(N_FRAMES) as pool:
            answers = list(pool.map(lambda b: post(port, b), bodies))
        wall = time.perf_counter() - t0
        launches = A.flash_forward_cuda.launches
        n_batches = server.batcher.n_batches - batches0

        lat = sorted(a[3] * 1e3 for a in answers)
        q = {p: lat[min(len(lat) - 1, int(len(lat) * p / 100))]
             for p in (50, 90, 99)}
        phase("slice", f"{N_FRAMES} concurrent POST /predict: {n_batches} "
              f"batches, {launches} flash_fwd launches, wall {wall:.3f} s, "
              f"{N_FRAMES / wall:.2f} img/s, client latency p50 {q[50]:.1f} "
              f"p90 {q[90]:.1f} p99 {q[99]:.1f} ms")
        stats = get_json(port, "/stats")
        phase("slice", f"/stats {json.dumps(stats)}")

        # a JPEG of another size comes back as a PNG mask of that size
        buf = io.BytesIO()
        Image.fromarray(frames[0], "L").resize((600, 480)).save(buf, "JPEG")
        status, headers, data, _ = post(port, buf.getvalue(), "/predict")
        odd = np.asarray(Image.open(io.BytesIO(data)))
        phase("slice", f"600x480 JPEG -> HTTP {status} "
              f"{headers.get('Content-Type')} mask {odd.shape}")
        assert status == 200 and odd.shape == (480, 600)
        assert set(np.unique(odd)) <= {0, 255}
    finally:
        server.shutdown()
        server.close()
        thread.join(timeout=30)

    masks = []
    for status, headers, data, _ in answers:
        assert status == 200, (status, data[:200])
        h, w = int(headers["X-Height"]), int(headers["X-Width"])
        assert (h, w) == frames[0].shape
        masks.append(np.frombuffer(data, np.uint8).reshape(h, w) // 255)
    masks = np.stack(masks)
    assert set(np.unique(masks)) <= {0, 1}
    assert n_batches < N_FRAMES, "requests did not coalesce"
    assert launches == N_LAYERS * n_batches, \
        f"{launches} kernel launches for {n_batches} batches"
    assert stats["images"] >= N_FRAMES and stats["errors"] == 0

    # the same frames through the plain attention path, explicitly chosen
    plain = load_checkpoint_into(
        ckpt, "TransUNet",
        create_model("TransUNet", use_flash_attention=False, **SLICE))
    x = torch.from_numpy(np.stack(frames)[..., None]).cuda()
    A.flash_forward_cuda.launches = 0
    ref = run_batches(plain.cuda(), x, torch.bfloat16)
    assert A.flash_forward_cuda.launches == 0, "the plain path launched"
    flash = load_checkpoint_into(ckpt, "TransUNet",
                                 create_model("TransUNet", **SLICE)).cuda()
    kern = run_batches(flash, x, torch.bfloat16)
    # bf16 noise floor: the flash path with the kernel swapped for its own
    # plain version. Two correct bf16 attentions already differ by about a
    # bf16 ulp, which the bf16 decoder turns into flips of the pixels whose
    # logit lies that close to the threshold.
    launched = A.flash_forward_cuda.launches
    blocks.flash_attention = lambda q, k, v: A.flash_forward_reference(
        q, k, v)[0]
    try:
        twin = run_batches(flash, x, torch.bfloat16)
    finally:
        blocks.flash_attention = A.flash_attention
    assert A.flash_forward_cuda.launches == launched
    floor = float((ref == twin).mean())
    agree = float((ref == kern).mean())
    served = float((ref == masks).mean())
    phase("slice", f"bf16 masks vs plain path: kernel's plain twin (noise "
          f"floor) {floor:.6%}; kernel path batched alike {agree:.6%} "
          f"(limit floor - {KERNEL_MARGIN:g}); served by the daemon "
          f"{served:.6%} (limit floor - {SERVED_MARGIN:g}); served vs "
          f"batched alike {float((kern == masks).mean()):.6%}; foreground "
          f"{masks.mean():.3f}")

    # float32 masks of both paths on every frame: only attention differs,
    # by summation order
    agree32 = float((run_batches(flash, x, torch.float32)
                     == run_batches(plain, x, torch.float32)).mean())
    phase("slice", f"float32 masks: kernel path vs plain path agree on "
          f"{agree32:.6%} of pixels (limit {F32_MASK_AGREE:.1%})")
    # and their logits on two frames
    xf = x[:2].permute(0, 3, 1, 2).float() / 255.0
    with torch.inference_mode():
        lf, lp = flash(xf), plain(xf)
    torch.cuda.synchronize()
    dlogit = (lf - lp).abs().max().item()
    near = (lp.abs() < 1e-2).float().mean().item()
    phase("slice", f"float32 logits kernel vs plain path: max|d| "
          f"{dlogit:.3e} (limit {F32_LOGIT_LIMIT:g}), shape "
          f"{tuple(lf.shape)}, share of |logit| < 1e-2: {near:.5f}")
    size = SLICE["image_size"]
    assert lf.shape == (2, 1, size, size) and torch.isfinite(lf).all()
    assert dlogit <= F32_LOGIT_LIMIT
    assert agree32 >= F32_MASK_AGREE, \
        "float32 masks of the kernel path and the plain path disagree"
    assert agree >= floor - KERNEL_MARGIN, \
        "the kernel path disagrees with the plain path beyond bf16 noise"
    assert served >= floor - SERVED_MARGIN, \
        "the served masks disagree with the plain path beyond bf16 noise"
    assert 0.0 < masks.mean() < 1.0, "degenerate masks"
    return launches, ckpt


def profile_slice(ckpt):
    """Device time of one bf16 batch through ``make_serve_fn`` on both
    attention paths, and where the kernel path's device time goes."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
    from ddti_tpu_torch.train.export import make_serve_fn

    x = torch.from_numpy(np.stack(make_frames(
        BATCH, SLICE["image_size"], SEED + 1))[..., None]).cuda()
    serve = {}
    for path, flash in (("kernel", None), ("plain", False)):
        model = create_model("TransUNet", use_flash_attention=flash, **SLICE)
        serve[path] = make_serve_fn(
            load_checkpoint_into(ckpt, "TransUNet", model).cuda(),
            compute_dtype=torch.bfloat16)
    order = ("plain", "kernel", "kernel", "plain")
    ms = [median_ms(lambda: serve[path](x)) for path in order]
    phase("profile", f"device time per bf16 batch of {BATCH} at "
          f"{SLICE['image_size']}^2 (CUDA events, median of 20), order "
          f"{', '.join(order)}: {', '.join(f'{t:.3f}' for t in ms)} ms")

    torch.cuda.synchronize()
    launches0 = A.flash_forward_cuda.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_BATCHES):
            serve["kernel"](x)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    phase("profile", f"torch.profiler, {PROFILE_BATCHES} kernel-path "
          f"batches: window {window_us / 1e3:.3f} ms, device kernels "
          f"{busy_us / 1e3:.3f} ms ({busy_us / window_us:.1%} busy), "
          f"{A.flash_forward_cuda.launches - launches0} flash_fwd launches")
    if not kernels:
        phase("profile", "no device time recorded: breakdown not measured")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[
            :PROFILE_TOP]:
        phase("profile", f"{e.self_device_time_total / busy_us:6.1%} "
              f"{e.count:4d} x {e.self_device_time_total / e.count / 1e3:.4f}"
              f" ms  {e.key[:90]}")


def edt_masks(n, h, w, seed):
    """EDT inputs (nonzero = foreground): 1 - the synthetic nodule masks
    (the boundary loss's input), or random discs and salt where the frame
    is not square, with the edge frames first: all zeros, all ones (no
    zero: the cap h + w), a single zero, a single nonzero pixel."""
    import numpy as np
    import torch

    from ddti_tpu_torch.data.synthetic import generate_ddti_like

    if h == w and h >= 64:
        _, masks = generate_ddti_like(n, (h, w), seed)
        m = (masks[..., 0] == 0).astype(np.uint8)
    else:
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:h, 0:w]
        m = (rng.random((n, h, w)) < 0.01).astype(np.uint8)
        for i in range(n):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            r = rng.uniform(1, max(h, w) / 3)
            m[i] |= ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)
    edge = [np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8),
            np.ones((h, w), np.uint8), np.zeros((h, w), np.uint8)]
    edge[2][h // 2, w // 3] = 0
    edge[3][h // 3, w // 2] = 1
    k = min(len(edge), n)
    m[:k] = np.stack(edge[:k])
    return torch.from_numpy(m)


def edt_times(shape, seed):
    """The EDT kernel's device time at (N, H, W) on ``edt_masks``, with
    whatever ``ddti_tpu_torch`` is imported: ``queued_ms`` (100 calls
    queued behind a device-side sleep) and its column and row passes apart
    (torch.profiler; None where it recorded no event of one)."""
    import torch

    from ddti_tpu_torch.ops import edt as E

    m = edt_masks(*shape, seed).to(DEVICE)
    times = dict(queued_ms=queued_ms(lambda: E.edt_cuda(m))[1])
    times.update(profiled_ms(lambda: E.edt_cuda(m), {
        "column_ms": ("edt_column",), "row_ms": ("edt_row",)}))
    torch.cuda.synchronize()
    return times


def check_edt():
    """csrc/edt.cu against its plain version (bit for bit, every frame) and
    scipy (every frame with a zero), with kernel and plain timings (one call
    and queued) and the kernel's column and row passes timed apart."""
    import numpy as np
    import torch
    from scipy import ndimage

    from ddti_tpu_torch.ops import edt as E

    rows = []
    for i, (n, h, w) in enumerate(EDT_SHAPES):
        m = edt_masks(n, h, w, SEED + i).to(DEVICE)
        got = E.edt_cuda(m)
        torch.cuda.synchronize()
        want = E.edt_reference(m)
        equal = torch.equal(got, want)
        err = (got - want).abs().max().item()
        host, ref_in = got.cpu().numpy(), m.cpu().numpy()
        scipy_frames = scipy_equal = 0
        for j in range(n):
            if not (ref_in[j] == 0).any():  # scipy has no answer there
                assert (host[j] == h + w).all(), "the cap h + w"
                continue
            scipy_frames += 1
            scipy_equal += np.array_equal(
                host[j], ndimage.distance_transform_edt(ref_in[j]).astype(
                    np.float32))
        row = dict(shape=[n, h, w], max_abs_err=err, bit_equal=equal,
                   scipy_frames=scipy_frames, scipy_equal=scipy_equal)
        timing = ""
        if i < EDT_TIMED:
            row["ms"] = median_ms(lambda: E.edt_cuda(m))
            row["plain_ms"] = median_ms(lambda: E.edt_reference(m))
            row.update(edt_times((n, h, w), SEED + i))
            b = bound("edt", (n, h, w))
            row.update(bound_ms=b[0], bound_by=b[1])
            minplus_ms = (work_counts("edt", (n, h, w))["minplus_flop"]
                          / PEAK_FLOPS["float32"] * 1e3)
            timing = (f", kernel {row['ms']:.4f} ms, queued "
                      f"{row['queued_ms']:.4f} (profiler: column pass "
                      + ", row pass ".join(
                          "not recorded" if row[key] is None
                          else f"{row[key]:.4f}"
                          for key in ("column_ms", "row_ms"))
                      + f") plain {row['plain_ms']:.4f} ms; bound "
                      f"{b[0]:.5f} ms ({b[1]}; the min-plus algorithm's "
                      f"{minplus_ms:.4f})")
        phase("kernels", f"edt_minplus {(n, h, w)} uint8: bit-equal to plain "
              f"{equal} (max|d| {err:.3e}), bit-equal to scipy on "
              f"{scipy_equal}/{scipy_frames} frames with a zero" + timing)
        assert equal, "the EDT kernel disagrees with its plain version"
        assert scipy_equal == scipy_frames, \
            "the EDT kernel disagrees with scipy"
        rows.append(row)
    return rows


def _parse_terms(log_text):
    """Every logged epoch line: (phase, epoch, avg loss, bce, dice, focal,
    boundary, iou)."""
    import re

    pat = re.compile(
        r"(Train|Validate) Epoch: (\d+), Avg Loss: (\S+)\n.*BCE Loss: (\S+), "
        r"Dice Loss: (\S+), Focal Loss: (\S+), Boundary Loss: (\S+)\n"
        r".*IoU: (\S+)\n")
    return [(g[0], int(g[1]), *map(float, g[2:]))
            for g in pat.findall(log_text)]


def jax_resunet_keys(depth):
    """The key set ddti_tpu.train.checkpoint.save_params_npz writes for a
    ResUNet of this depth, written out from the flax module tree (encoders,
    bottleneck and decoders are ResidualBlocks)."""
    keys = set()
    blocks = ([f"encoders_{i}" for i in range(depth)] + ["bottleneck"]
              + [f"decoders_{i}" for i in range(depth)])
    for b in blocks:
        for conv in ("conv1", "conv2", "skip"):
            keys.add(f"params/{b}/{conv}/kernel")
        for bn in ("bn1", "bn2"):
            keys |= {f"params/{b}/{bn}/scale", f"params/{b}/{bn}/bias",
                     f"batch_stats/{b}/{bn}/mean", f"batch_stats/{b}/{bn}/var"}
    for i in range(depth):
        keys |= {f"params/upconvs_{i}/kernel", f"params/upconvs_{i}/bias"}
    return keys | {"params/final_conv/kernel", "params/final_conv/bias"}


def jax_transunet_keys(depth, layers):
    """The key set ddti_tpu.train.checkpoint.save_params_npz writes for a
    TransUNet of this depth and encoder layer count, written out from the
    flax module tree (encoders and decoders are ConvBNAct blocks)."""
    keys = {"params/patchify/kernel", "params/pos_emb",
            "params/trans_proj/kernel", "params/trans_proj/bias",
            "params/final_conv/kernel", "params/final_conv/bias"}
    for b in ([f"encoders_{i}" for i in range(depth)]
              + [f"decoders_{i}" for i in range(depth)]):
        keys |= {f"params/{b}/conv1/kernel", f"params/{b}/conv2/kernel"}
        for bn in ("bn1", "bn2"):
            keys |= {f"params/{b}/{bn}/scale", f"params/{b}/{bn}/bias",
                     f"batch_stats/{b}/{bn}/mean", f"batch_stats/{b}/{bn}/var"}
    for i in range(depth):
        keys |= {f"params/upconvs_{i}/kernel", f"params/upconvs_{i}/bias"}
    for i in range(layers):
        for dense in ("qkv", "out_proj", "fc1", "fc2"):
            keys |= {f"params/trans_layers_{i}/{dense}/kernel",
                     f"params/trans_layers_{i}/{dense}/bias"}
        for ln in ("ln1", "ln2"):
            keys |= {f"params/trans_layers_{i}/{ln}/scale",
                     f"params/trans_layers_{i}/{ln}/bias"}
    return keys


def run_cli(tmp, name, model_type, model_kw, flags, epochs, keys):
    """The training CLI (--mode both --synthetic, 2 epochs, bf16) end to end
    in its own process: exit 0, the parameter count of ``model_kw``, the
    run tree, finite loss terms with a nonzero boundary term, val IoU and
    test metrics with HD95/ASSD, a best .pth that loads strictly and an .npz
    with the key set ``keys`` and the same tensors. Returns the launch count
    of each kernel in that run."""
    import math

    import numpy as np
    import torch

    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
    from ddti_tpu_torch.train.state import count_params

    base = os.path.join(tmp, f"runs_{name}")
    cmd = [sys.executable, "-m", "ddti_tpu_torch.cli.main", "--mode", "both",
           "--synthetic", "--use_amp_autocast", "true", "--base_dir", base,
           "--model_type", model_type, f"--epochs={epochs}", *flags]
    phase(name, " ".join(cmd[1:]))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=TRAIN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    out = res.stdout
    phase(name, f"exit {res.returncode} in {wall:.1f} s")
    if res.returncode != 0:
        print(out[-4000:], res.stderr[-8000:], sep="\n", file=sys.stderr)
    assert res.returncode == 0, "the training CLI failed"
    params = [l for l in out.splitlines() if l.startswith("[PARAMS]")]
    kernels = [l for l in out.splitlines() if l.startswith("[KERNELS]")]
    phase(name, f"{params[0]} {kernels[0]}")
    model = create_model(model_type, **model_kw)
    assert params[0] == f"[PARAMS] {model_type},{count_params(model)}"
    launches = dict(kv.split("=") for kv in kernels[0].split()[1:])
    launches = {k: int(v) for k, v in launches.items()}

    (run,) = os.listdir(base)
    run = os.path.join(base, run)
    for sub in ("models", "log/train_log.log", "result", "config.yaml"):
        assert os.path.exists(os.path.join(run, sub)), sub
    with open(os.path.join(run, "log", "train_log.log")) as f:
        log = f.read()
    terms = _parse_terms(log)
    for t in terms:
        phase(name, f"{t[0]} epoch {t[1]}: loss {t[2]:.4f} bce {t[3]:.4f} "
              f"dice {t[4]:.4f} focal {t[5]:.4f} boundary {t[6]:.4f} "
              f"IoU {t[7]:.4f}")
    assert len(terms) == 2 * epochs, "an epoch line is missing"
    assert all(math.isfinite(x) for t in terms for x in t[2:7])
    assert all(t[6] > 0 for t in terms), "the boundary term is zero"
    assert all(math.isfinite(t[7]) for t in terms if t[0] == "Validate")
    with open(os.path.join(run, "result", "test_metrics.json")) as f:
        test = json.load(f)
    phase(name, "test: " + ", ".join(
        f"{k} {test[k]:.4f}" for k in ("iou", "f1", "hd95_mean",
                                       "assd_mean", "total_images")))
    for k in ("iou", "f1", "hd95_mean", "assd_mean"):
        assert math.isfinite(test[k]), k
    assert test["total_images"] == SYNTHETIC[2]

    best = os.path.join(run, "models", f"{model_type}_best")
    load_checkpoint_into(best + ".pth", model_type, model)  # strict
    with np.load(best + ".npz") as z:
        got = set(z.files)
    assert got == keys, sorted(got ^ keys)[:8]
    twin = load_checkpoint_into(best + ".npz", model_type,
                                create_model(model_type, **model_kw))
    for k, v in model.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k]), k
    phase(name, f"best .pth loads strictly; .npz holds the JAX layout's "
          f"{len(keys)} keys and the same tensors")
    return launches


def _cli_batches(batch):
    """(train steps per epoch, val batches, test batches) of the CLI's
    synthetic splits."""
    return tuple(-(-n // batch) for n in SYNTHETIC)


def run_training(tmp):
    """The ResUNet training CLI; returns the EDT kernel's launch count."""
    model_kw = dict(base_filters=TRAIN["base_filters"], depth=TRAIN["depth"])
    flags = [f"--{k}={v}" for k, v in TRAIN.items()
             if k not in ("model_type", "epochs")]
    launches = run_cli(tmp, "train", "ResUNet", model_kw, flags,
                       TRAIN["epochs"], jax_resunet_keys(TRAIN["depth"]))
    steps, val, test_b = _cli_batches(TRAIN["batch_size"])
    expected = TRAIN["epochs"] * (steps + val) + test_b
    phase("train", f"edt_minplus launches {launches['edt_minplus']}, "
          f"expected {TRAIN['epochs']} epochs x ({steps} train + {val} val "
          f"steps) + {test_b} test batches = {expected}")
    assert launches["edt_minplus"] == expected
    return launches["edt_minplus"]


def run_transunet_training(tmp):
    """The TransUNet training CLI from a model YAML with dropout_rate 0.0;
    returns the launch counts, each checked against its expected value."""
    import yaml

    cfg = os.path.join(tmp, "transunet_bf64_d4_dropout0.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"model": {"model_type": "TransUNet",
                                  "kwargs": TSLICE}}, f)
    flags = ["--config_path", cfg, "--device", DEVICE,
             *(f"--{k}={v}" for k, v in TTRAIN.items() if k != "epochs")]
    model_kw = dict(TSLICE, image_size=TTRAIN["image_size"])
    launches = run_cli(tmp, "ttrain", "TransUNet", model_kw, flags,
                       TTRAIN["epochs"],
                       jax_transunet_keys(TSLICE["depth"], N_LAYERS))
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.state import count_params

    assert count_params(create_model("TransUNet", **model_kw)) \
        == TSLICE_PARAMS, "not the serving slice's TransUNet"
    steps, val, test_b = _cli_batches(TTRAIN["batch_size"])
    epochs = TTRAIN["epochs"]
    expected = {
        "flash_fwd": N_LAYERS * (epochs * (steps + val) + test_b),
        "flash_bwd_dkdv": N_LAYERS * epochs * steps,
        "flash_bwd_dq": N_LAYERS * epochs * steps,
        "edt_minplus": epochs * (steps + val) + test_b,
    }
    phase("ttrain", "launches " + ", ".join(
        f"{k} {launches[k]} (expected {v})" for k, v in expected.items())
        + f": {N_LAYERS} layers, {epochs} epochs x ({steps} train + {val} "
        f"val steps) + {test_b} test batches; the backward in train steps "
        f"only")
    assert {k: launches[k] for k in expected} == expected
    return launches


def _train_setup(size, batch, amp, seed=SEED, model_type="ResUNet",
                 model_kw=None):
    """A full-width model on the card (the flagship ResUNet unless
    ``model_type`` / ``model_kw`` say otherwise), its train state and step,
    one synthetic batch and its draws."""
    import torch

    from ddti_tpu_torch.core.config import Config
    from ddti_tpu_torch.data.augment import AugmentConfig, sample_draws
    from ddti_tpu_torch.data.dataset import synthetic_source
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.state import TrainState
    from ddti_tpu_torch.train.steps import make_train_step
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    if model_kw is None:
        model_kw = dict(base_filters=TRAIN["base_filters"],
                        depth=TRAIN["depth"])
    cfg = Config(image_size=size, store_size=size, batch_size=batch,
                 use_amp_autocast=amp)
    model = init_like_flax(create_model(model_type, **model_kw),
                           seed).to(DEVICE)
    src = synthetic_source(batch, (size, size), seed, device=DEVICE)
    images, masks = src.gather(list(range(batch)))
    aug = AugmentConfig(out_size=(size, size))
    draws = sample_draws(torch.Generator().manual_seed(seed), batch,
                         aug).to(DEVICE)
    state = TrainState(model, cfg.lr, 4, cfg.weight_decay)
    return model, state, make_train_step(cfg, aug), (images, masks, draws)


def step_kernel_vs_plain():
    """One float32 step from one state and batch through the kernel EDT and
    through the plain EDT (the boundary loss's EDT swapped explicitly);
    deterministic cuDNN so that only the EDT route differs."""
    import torch

    from ddti_tpu_torch.losses import losses
    from ddti_tpu_torch.ops import edt as E

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model, _, step, (images, masks, draws) = _train_setup(512, 16, False)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    try:
        for route in ("kernel", "plain"):
            from ddti_tpu_torch.train.state import TrainState

            model.load_state_dict(sd0)
            state = TrainState(model, 1e-5, 4)
            launched = E.edt_cuda.launches
            if route == "plain":
                losses.edt_batch = E.edt_reference
            m = step(state, images, masks, draws, None)
            torch.cuda.synchronize()
            assert (E.edt_cuda.launches - launched) == (route == "kernel")
            out[route] = (m.boundary.clone(), {
                k: v.clone() for k, v in model.state_dict().items()})
    finally:
        losses.edt_batch = E.edt_batch
        torch.backends.cudnn.deterministic = False
    (bk, pk), (bp, pp) = out["kernel"], out["plain"]
    rel = max(((pk[k] - pp[k]).abs().max()
               / pp[k].abs().max().clamp(min=1e-30)).item() for k in pk)
    moved = sum(not torch.equal(pk[k], sd0[k]) for k in pk)
    phase("step", f"float32 ResUNet 512^2 batch 16: boundary kernel "
          f"{bk.item():.9g} plain {bp.item():.9g} (bit-equal "
          f"{torch.equal(bk, bp)}); updated tensors {moved}/{len(pk)}, max "
          f"relative difference {rel:.3e} (limit {STEP_PARAM_RTOL:g})")
    assert torch.equal(bk, bp), "kernel and plain boundary terms differ"
    assert rel <= STEP_PARAM_RTOL and moved == len(pk)


def _plain_flash():
    """flash_attention with its kernels swapped for their plain versions
    (flash_forward_reference, flash_backward_reference) on any device."""
    import torch

    from ddti_tpu_torch.ops import attention as A

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = A.flash_forward_reference(q, k, v)
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            return A.flash_backward_reference(q, k, v, o, lse,
                                              do.contiguous().to(o.dtype))

    return PlainFlash.apply


def _flash_counts():
    from ddti_tpu_torch.ops import attention as A

    bwd = A.flash_backward_cuda
    return [A.flash_forward_cuda.launches, bwd.launches_dkdv, bwd.launches_dq]


def _normwise(a, b):
    """||a - b|| / ||b|| over every tensor of two same-keyed dicts."""
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    den = sum(float((b[k].double() ** 2).sum()) for k in b)
    return (num / den) ** 0.5


def tstep_kernel_vs_plain():
    """One float32 TransUNet step from one state and batch through the
    flash kernels and through their plain versions (swapped explicitly);
    deterministic cuDNN so that only the attention route differs. Then one
    bf16 step at the default dropout 0.1, where the gate takes the plain
    attention."""
    import math

    import torch

    from ddti_tpu_torch.models import blocks
    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.train.state import TrainState

    size, batch = TTRAIN["image_size"], TTRAIN["batch_size"]
    kw = dict(TSLICE, image_size=size)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model, _, step, (images, masks, draws) = _train_setup(
        size, batch, False, model_type="TransUNet", model_kw=kw)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    try:
        # the kernel route twice: its own run-to-run floor
        for route in ("kernel", "kernel again", "plain"):
            model.load_state_dict(sd0)
            state = TrainState(model, 1e-5, 4)
            before = _flash_counts()
            if route == "plain":
                blocks.flash_attention = _plain_flash()
            m = step(state, images, masks, draws, None)
            torch.cuda.synchronize()
            moved = [a - b for a, b in zip(_flash_counts(), before)]
            assert moved == [N_LAYERS * (route != "plain")] * 3, moved
            out[route] = (
                torch.stack([m.loss, m.bce, m.dice, m.focal,
                             m.boundary]).double(),
                {k: p.grad.clone() for k, p in model.named_parameters()},
                {k: v.clone() for k, v in model.state_dict().items()})
    finally:
        blocks.flash_attention = A.flash_attention
        torch.backends.cudnn.deterministic = False
    (tk, gk, pk), (tp, gp, pp) = out["kernel"], out["plain"]
    _, g2, p2 = out.pop("kernel again")
    term_rel = float(((tk - tp).abs() / tp.abs().clamp(min=1e-30)).max())
    grad_rel, param_rel = _normwise(gk, gp), _normwise(pk, pp)
    worst = max(gk, key=lambda k: _normwise({k: gk[k]}, {k: gp[k]}))
    phase("tstep", f"kernel route run twice: gradients normwise "
          f"{_normwise(gk, g2):.3e}, parameters {_normwise(pk, p2):.3e}; "
          f"kernels vs plain, the gradient furthest apart: {worst} "
          f"{_normwise({worst: gk[worst]}, {worst: gp[worst]}):.3e}")
    step_gap = max(float((pk[k] - pp[k]).abs().max()) for k in gk) / 1e-5
    n_moved = sum(not torch.equal(pk[k], sd0[k]) for k in pk)
    phase("tstep", f"float32 TransUNet {size}^2 batch {batch}, kernels vs "
          f"plain: loss terms kernel {tk.tolist()} plain {tp.tolist()}, max "
          f"relative difference {term_rel:.3e} (limit "
          f"{TSTEP_TERM_RTOL:g}); gradients normwise {grad_rel:.3e} (limit "
          f"{TSTEP_GRAD_RTOL:g}); updated tensors {n_moved}/{len(pk)}, "
          f"normwise {param_rel:.3e} (limit {TSTEP_PARAM_RTOL:g}), largest "
          f"parameter gap {step_gap:.3f} lr")
    assert term_rel <= TSTEP_TERM_RTOL, "kernel and plain loss terms differ"
    assert grad_rel <= TSTEP_GRAD_RTOL, "kernel and plain gradients differ"
    assert param_rel <= TSTEP_PARAM_RTOL and step_gap <= 2.001
    assert n_moved == len(pk)
    del model, step, images, masks, out, gk, gp, pk, pp, g2, p2, sd0
    torch.cuda.empty_cache()

    kw = {k: v for k, v in kw.items() if k != "dropout_rate"}  # 0.1
    _, state, step, (images, masks, draws) = _train_setup(
        size, batch, True, model_type="TransUNet", model_kw=kw)
    before = _flash_counts()
    m = step(state, images, masks, draws, None)
    torch.cuda.synchronize()
    terms = [float(t) for t in (m.loss, m.bce, m.dice, m.focal, m.boundary)]
    phase("tstep", f"bf16 TransUNet step at the default dropout 0.1: flash "
          f"launches {[a - b for a, b in zip(_flash_counts(), before)]} "
          f"(the gate takes the plain attention with probability dropout), "
          f"terms {terms}")
    assert _flash_counts() == before, "a flash kernel ran with dropout"
    assert all(math.isfinite(t) for t in terms) and terms[4] > 0
    del state, step, images, masks
    torch.cuda.empty_cache()


def _profile_steps(label, size, batch, model_type="ResUNet", model_kw=None,
                   dtype="bfloat16"):
    """Device time per train step in ``dtype`` (bf16 autocast, or float32
    with TF32 off; CUDA events) and a torch.profiler window over
    TRAIN_PROFILE_STEPS steps: busy share, the EDT's and the flash kernels'
    share, the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ddti_tpu_torch.ops import edt as E

    _, state, step, (images, masks, draws) = _train_setup(
        size, batch, dtype == "bfloat16", model_type=model_type,
        model_kw=model_kw)

    def one():
        step(state, images, masks, draws, None)

    ms = median_ms(one, runs=10, warmup=3)
    torch.cuda.synchronize()
    before = [E.edt_cuda.launches, *_flash_counts()]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN_PROFILE_STEPS):
            one()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    launched = [a - b for a, b in zip([E.edt_cuda.launches,
                                       *_flash_counts()], before)]
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    edt_us = sum(e.self_device_time_total for e in kernels
                 if "edt_" in e.key)
    flash_us = sum(e.self_device_time_total for e in kernels
                   if "flash_" in e.key)
    phase("tprofile", f"{label}: {dtype} train step {size}^2 batch {batch}: "
          f"{ms:.3f} ms device time (CUDA events, median of 10), "
          f"{batch / ms * 1e3:.1f} img/s; torch.profiler over "
          f"{TRAIN_PROFILE_STEPS} steps: window {window_us / 1e3:.3f} ms, "
          f"device kernels {busy_us / 1e3:.3f} ms "
          f"({busy_us / max(window_us, 1):.1%} busy), EDT kernels "
          f"{edt_us / 1e3:.3f} ms ({edt_us / max(busy_us, 1):.2%} of "
          f"device time), flash kernels {flash_us / 1e3:.3f} ms "
          f"({flash_us / max(busy_us, 1):.2%}); launches edt/flash_fwd/"
          f"flash_bwd_dkdv/flash_bwd_dq {launched}")
    if not kernels:
        phase("tprofile", "no device time recorded: breakdown not measured")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[
            :PROFILE_TOP]:
        phase("tprofile", f"{e.self_device_time_total / busy_us:6.1%} "
              f"{e.count:4d} x "
              f"{e.self_device_time_total / e.count / 1e3:.4f} ms  "
              f"{e.key[:90]}")
    del state, step, images, masks, prof
    torch.cuda.empty_cache()
    return dict(model=label, dtype=dtype, size=size, batch=batch, ms=ms,
                busy=busy_us / max(window_us, 1),
                edt_share=edt_us / max(busy_us, 1),
                flash_share=flash_us / max(busy_us, 1))


def profile_training():
    """The ResUNet train step at TRAIN_PROFILES."""
    return [_profile_steps("ResUNet bf64 d5", size, batch)
            for size, batch in TRAIN_PROFILES]


def profile_transunet():
    """The TransUNet train step on the kernel and the plain attention path:
    the slice's model at S = 1024, and the S = 4096 one at the largest
    batch of TLONG_BATCHES whose plain path fits in device memory, in bf16;
    then in float32 (the training CLI's default dtype) the slice's model on
    both paths and the S = 4096 one on the kernel path at that batch."""
    import gc

    import torch

    size, batch = TTRAIN["image_size"], TTRAIN["batch_size"]
    rows = []
    for path, flash in (("kernel", None), ("plain", False)):
        kw = dict(TSLICE, image_size=size, use_flash_attention=flash)
        rows.append(_profile_steps(f"TransUNet bf64 d4 S=1024 {path}", size,
                                   batch, "TransUNet", kw))
    kw = dict(TLONG, image_size=size)
    for batch in TLONG_BATCHES:
        try:
            plain = _profile_steps(
                "TransUNet bf32 d3 S=4096 plain", size, batch, "TransUNet",
                dict(kw, use_flash_attention=False))
            break
        except torch.cuda.OutOfMemoryError:
            phase("tprofile", f"TransUNet bf32 d3 S=4096 plain path at "
                  f"batch {batch}: out of device memory, halving")
        gc.collect()
        torch.cuda.empty_cache()
    rows.append(_profile_steps("TransUNet bf32 d3 S=4096 kernel", size,
                               batch, "TransUNet", kw))
    rows.append(plain)
    for path, flash in (("kernel", None), ("plain", False)):
        rows.append(_profile_steps(
            f"TransUNet bf64 d4 S=1024 {path}", size, TTRAIN["batch_size"],
            "TransUNet", dict(TSLICE, image_size=size,
                              use_flash_attention=flash), "float32"))
    rows.append(_profile_steps("TransUNet bf32 d3 S=4096 kernel", size,
                               batch, "TransUNet", kw, "float32"))
    return rows


def ab_probes():
    """The conv3x3 and gather kernels' queued times at the probes' shapes,
    beside cuDNN's and torch.gather's; exp2_probe's in every mode beside
    torch.exp2's and Tensor.copy_'s; and the EDT's queued time with its
    column and row passes at the EDT_TIMED shapes; all with the tree that
    is imported: {"conv": {ms, library_ms}, "gather": {builder: {ms,
    library_ms}}, "exp2": {modes: {mode: {ms, ...}}, library_ms}, "edt":
    [{shape, queued_ms, column_ms, row_ms}]}."""
    from ddti_tpu_torch.probes import exp2_probe as E2
    from ddti_tpu_torch.probes import gather_probe as G
    from ddti_tpu_torch.probes import gather_probe2 as G2
    from ddti_tpu_torch.probes import gather_probe3 as G3
    from ddti_tpu_torch.probes import pallas_conv_probe as P

    conv = P.run(seed=SEED)
    rows = {}
    for mod in (G, G2, G3):
        rows.update(mod.run(seed=SEED))
    keep = ("ms", "library_ms", "match")
    e2 = E2.run(seed=SEED)
    edt = [dict(shape=list(shape), **edt_times(shape, SEED + i))
           for i, shape in enumerate(EDT_SHAPES[:EDT_TIMED])]
    for r in edt:
        phase("ab", f"edt {tuple(r['shape'])}: queued {r['queued_ms']:.4f} "
              f"ms, column {r['column_ms']}, row {r['row_ms']}")
    return dict(conv={k: conv[k] for k in keep[:2]},
                gather={k: {f: r[f] for f in keep if f in r}
                        for k, r in rows.items() if "torch_call" not in r},
                exp2=dict(modes=e2["modes"], library_ms=e2["library_ms"]),
                edt=edt)


def ab_side(tree, probes_only=False):
    """One side of a same-card comparison of two trees: kernel_phases() and
    the TransUNet train steps on the kernel path (float32, the training
    CLI's default, then bf16; S = 1024 at batch 16 and S = 4096 at batch 8)
    and the conv3x3 and gather probes (ab_probes), or with ``probes_only``
    the probes alone, with ``tree``'s ddti_tpu_torch and this file's
    measurements. Prints one line "[ab] {json}"."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ddti_tpu_torch.ops import _build

    _build.build()
    _build.load_library()
    if probes_only:
        print("[ab] " + json.dumps(dict(tree=tree, source=_build.__file__,
                                        probes=ab_probes())), flush=True)
        return
    fwd, bwd, _ = kernel_phases()
    size = TTRAIN["image_size"]
    steps = [_profile_steps(f"{label} {tree}", size, batch, "TransUNet",
                            dict(kw, image_size=size), dt)
             for dt in ("float32", "bfloat16")
             for label, batch, kw in (("S=1024", TTRAIN["batch_size"], TSLICE),
                                      ("S=4096", 8, TLONG))]
    print("[ab] " + json.dumps(dict(tree=tree, source=_build.__file__,
                                    fwd=fwd, bwd=bwd, steps=steps,
                                    probes=ab_probes())),
          flush=True)


def ab(parent, *which):
    """Compare the tree at ``parent`` (another commit unpacked, e.g. with
    git archive) with this one on one card, in the order parent, this, this,
    parent, each side in its own process (ab_side); ``which`` = ("probes",)
    compares the probes and the EDT alone (ab_probes)."""
    for tree in (parent, ".", ".", parent):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--ab-side", tree, *which], check=True)


def main():
    import torch

    t_start = time.perf_counter()
    # the default build here and in the CLI runs; the probes phase's
    # subprocess sets DDTI_POLY_EXP2=1 for itself
    os.environ["DDTI_POLY_EXP2"] = "0"
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)  # as nvidia-smi prints it: name, power limit
    phase("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ddti_tpu_torch.ops import _build
    from ddti_tpu_torch.probes import exp2_probe as E2
    from ddti_tpu_torch.probes import flash_mskip_ab as MS

    # the DDTI_POLY_EXP2=1 library, built at the same time by a process of
    # its own (the flag is read once, at import)
    poly_build = subprocess.Popen(
        [sys.executable, "-c", "from ddti_tpu_torch.ops import _build; "
         "print(_build.build()[0])"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, DDTI_POLY_EXP2="1"))
    path, secs = _build.build()
    poly_out, poly_err = poly_build.communicate()
    assert poly_build.returncode == 0, f"the poly build failed:\n{poly_err}"
    poly_path = poly_out.split()[-1]
    _build.load_library()
    phase("build", f"nvcc {' '.join(_build.NVCC_FLAGS)}, one process per "
          f"source: {f'{secs:.2f} s' if secs else 'already built'} -> "
          f"{os.path.relpath(path)}; with -DDDTI_POLY_EXP2=1 at the same "
          f"time -> {os.path.relpath(poly_path)}")
    _, default_ops = kernel_report(path)
    check_poly_build(poly_path, default_ops)

    rows, bwd_rows, ratios = kernel_phases()
    edt_rows = check_edt()
    t_probes = time.perf_counter()
    probes = check_probes()
    cg = check_conv_gather()
    phase("probes", f"phase wall time {time.perf_counter() - t_probes:.1f} s")
    E2.exp2_probe_cuda.launches = MS.flash_forward_mskip_cuda.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        launches, ckpt = run_slice(tmp)
        probe_launches = (E2.exp2_probe_cuda.launches,
                          MS.flash_forward_mskip_cuda.launches)
        profile_slice(ckpt)
        edt_launches = run_training(tmp)
        t_launches = run_transunet_training(tmp)
    step_kernel_vs_plain()
    tstep_kernel_vs_plain()
    train_rows = profile_training()
    ttrain_rows = profile_transunet()

    phase("result", f"total wall time {time.perf_counter() - t_start:.1f} s")
    main_row, bwd_row = rows[0], bwd_rows[0]
    f32_row = next(r for r in bwd_rows if r["dtype"] == "float32")
    f32_fwd = next(r for r in rows if r["dtype"] == "float32")
    bwd_shape, bwd_dt = tuple(bwd_row["shape"]), bwd_row["dtype"]
    edt_bound = bound("edt", tuple(edt_rows[0]["shape"]))
    library_covers = ("scaled_dot_product_attention's backward: dq, dk and "
                      "dv together")
    e2, mskip, ab_rows = (probes["exp2_probe"], probes["mskip"],
                          probes["poly_ab"])
    poly = {r["dtype"]: r for r in probes["poly"]}
    e2_bound = bound("exp2_probe", tuple(e2["shape"]))
    ms_shape = tuple(mskip["shape"])
    ms_bound = bound("flash_fwd_mskip", ms_shape)
    conv_bound = bound("conv3x3", tuple(cg["conv"]["shape"]))
    gather_bound = bound("gather", (*cg["gather_a"]["shape"], 4),
                         shared_index=True)
    # the DDTI_POLY_EXP2=1 build's queued times at a and c, and the probe's
    # A/B (poly=0, then 1) at (8, 8, 4096, 32) bf16
    poly_fwd = {dt: r["fwd_queue_ms"] for dt, r in poly.items()}
    poly_pair = {dt: r["pair_queue_ms"] for dt, r in poly.items()}
    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ddti_tpu/ops/attention.py:347",
        "also_replaces": "ddti_tpu/ops/attention.py:104",
        "launches": launches,
        "train_launches": t_launches["flash_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library": f"scaled_dot_product_attention ({main_row['library']})",
        "queue_ms": main_row["queue_ms"],
        "library_queue_ms": main_row["library_queue_ms"],
        "r_fwd": ratios["r_fwd"],
        "r_fwd_queued": ratios["r_fwd_queued"],
        "f32_shape": f32_fwd["shape"],
        "f32_queue_ms": f32_fwd["queue_ms"],
        "f32_prepass_ms": f32_fwd["prepass_ms"],
        "f32_library_queue_ms": f32_fwd["library_queue_ms"],
        "f32_bound_ms": f32_fwd["bound_ms"],
        "poly_queue_ms": poly_fwd,
        "poly_ab": [{k: r[k] for k in ("poly", "fwd_ms", "fwdbwd_ms",
                                       "fwd_err")} for r in ab_rows],
        "shapes": rows,
    }, {
        "name": "flash_bwd_dkdv",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "ddti_tpu/ops/attention.py:405",
        "also_replaces": "ddti_tpu/ops/attention.py:180",
        "launches": t_launches["flash_bwd_dkdv"],
        "max_abs_err": max(max(r["abs_err"]["dk"], r["abs_err"]["dv"])
                           for r in bwd_rows),
        "max_rel_err": max(max(r["rel_err"]["dk"], r["rel_err"]["dv"])
                           for r in bwd_rows),
        "ms": bwd_row["ms_dkdv"],
        "plain_ms": bwd_row["plain_ms"],
        "plain_covers": "flash_backward_reference: dq, dk and dv together",
        "bound_ms": bwd_row["bound_ms_dkdv"],
        "bound_by": bound("flash_bwd_dkdv", bwd_shape, bwd_dt)[1],
        "library_ms": bwd_row["library_ms"],
        "library": f"scaled_dot_product_attention ({bwd_row['library']})",
        "library_covers": library_covers,
        "pair_ms": bwd_row["ms"],
        "pair_queue_ms": bwd_row["queue_ms"],
        "library_queue_ms": bwd_row["library_queue_ms"],
        "pair_bound_ms": bwd_row["bound_ms"],
        "r_bwd": ratios["r_bwd"],
        "r_bwd_queued": ratios["r_bwd_queued"],
        "f32_shape": f32_row["shape"],
        "f32_pair_queue_ms": f32_row["queue_ms"],
        "f32_library_queue_ms": f32_row["library_queue_ms"],
        "f32_pair_bound_ms": f32_row["bound_ms"],
        "poly_ms": {dt: r["dkdv_ms"] for dt, r in poly.items()},
        "poly_pair_queue_ms": poly_pair,
        "shapes": bwd_rows,
        "train_steps": ttrain_rows,
    }, {
        "name": "flash_bwd_dq",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "ddti_tpu/ops/attention.py:450",
        "also_replaces": "ddti_tpu/ops/attention.py:222",
        "launches": t_launches["flash_bwd_dq"],
        "max_abs_err": max(r["abs_err"]["dq"] for r in bwd_rows),
        "max_rel_err": max(r["rel_err"]["dq"] for r in bwd_rows),
        "ms": bwd_row["ms_dq"],
        "plain_ms": bwd_row["plain_ms"],
        "plain_covers": "flash_backward_reference: dq, dk and dv together",
        "bound_ms": bwd_row["bound_ms_dq"],
        "bound_by": bound("flash_bwd_dq", bwd_shape, bwd_dt)[1],
        "library_ms": bwd_row["library_ms"],
        "library": f"scaled_dot_product_attention ({bwd_row['library']})",
        "library_covers": library_covers,
        "poly_ms": {dt: r["dq_ms"] for dt, r in poly.items()},
    }, {
        "name": "edt_minplus",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/edt.cu",
        "replaces": "ddti_tpu/ops/edt.py:81",
        "launches": edt_launches,
        "max_abs_err": max(r["max_abs_err"] for r in edt_rows),
        "ms": edt_rows[0]["ms"],
        "plain_ms": edt_rows[0]["plain_ms"],
        "bound_ms": edt_bound[0],
        "bound_by": edt_bound[1],
        "queue_ms": edt_rows[0]["queued_ms"],
        "column_ms": edt_rows[0]["column_ms"],
        "row_ms": edt_rows[0]["row_ms"],
        "library_ms": None,  # no PyTorch call computes an EDT
        "shapes": edt_rows,
        "train_steps": train_rows,
    }, {
        "name": "exp2_probe",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/exp2_probe.cu",
        "replaces": "benchmarks/exp2_probe.py:50",
        "launches": probe_launches[0],
        "max_abs_err": max(r["abs_vs_plain"] for r in e2["modes"].values()),
        "ms": e2["modes"]["poly6"]["ms"],
        "plain_ms": e2["plain_ms"],
        "bound_ms": e2_bound[0],
        "bound_by": e2_bound[1],
        "library_ms": e2["library_ms"]["torch.exp2"],
        "library": "torch.exp2 (the builtin mode's function)",
        "mode": "poly6; every mode in modes, queued device time",
        "copy_ms": e2["library_ms"]["copy_"],
        "modes": e2["modes"],
        "edge_ulps": e2["edge_ulps"],
    }, {
        "name": "flash_fwd_mskip",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "benchmarks/flash_mskip_ab.py:81",
        "launches": probe_launches[1],
        "max_abs_err": max(r["max_abs_err"] for r in mskip["shapes"]),
        "ms": mskip["m-skip"]["ms"],
        "baseline_ms": mskip["baseline"]["ms"],
        "plain_ms": mskip["shapes"][0]["plain_ms"],
        "bound_ms": ms_bound[0],
        "bound_by": ms_bound[1],
        "exp2_ms": ms_bound[2],
        "library_ms": mskip["shapes"][0]["library_queue_ms"],
        "library": f"scaled_dot_product_attention "
                   f"({mskip['shapes'][0]['library']}), queued",
        "shape": list(ms_shape),
        "max_abs_err_vs_attention_reference": mskip["m-skip"]["max_abs_err"],
        "shapes": mskip["shapes"],
    }, {
        "name": "conv3x3",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/conv3x3.cu",
        "replaces": "benchmarks/pallas_conv_probe.py:42",
        "launches": cg["conv_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in cg["conv_rows"]),
        "ms": cg["conv"]["ms"],
        "plain_ms": cg["conv"]["plain_ms"],
        "bound_ms": conv_bound[0],
        "bound_by": conv_bound[1],
        "library_ms": cg["conv"]["library_ms"],
        "library": "F.conv2d (cuDNN, channels_last, bias) + relu_, queued",
        "shape": cg["conv"]["shape"],
        "pack_ms": cg["conv"]["pack_ms"],
        "cancel_err_by_c": cg["conv_growth"],
        "shapes": cg["conv_rows"],
    }, {
        "name": "gather",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/gather_probe.cu",
        "replaces": "benchmarks/gather_probe.py:55",
        "also_replaces": ["benchmarks/gather_probe.py:77",
                          "benchmarks/gather_probe.py:99",
                          "benchmarks/gather_probe2.py:73",
                          "benchmarks/gather_probe2.py:100",
                          "benchmarks/gather_probe3.py:96",
                          "benchmarks/gather_probe3.py:115",
                          "benchmarks/gather_probe3.py:134"],
        "launches": cg["gather_launches"],
        "max_abs_err": 0.0,  # bit for bit, NaN's bits included
        "ms": cg["gather_a"]["ms"],
        "plain_ms": cg["gather_a"]["plain_ms"],
        "bound_ms": gather_bound[0],
        "bound_by": gather_bound[1],
        "library_ms": cg["gather_a"]["library_ms"],
        "library": "torch.gather, the same call (builder A), queued",
        "builder": "A: flat take, (128, 256, 256) float32, shared index",
        "builders": cg["gather"],
        "edges": cg["gather_edges"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ab"]:  # python3 chip_smoke.py --ab TREE [probes]
        sys.exit(ab(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--ab-side"]:
        sys.exit(ab_side(sys.argv[2], sys.argv[3:4] == ["probes"]))
    if sys.argv[1:2] == ["--poly-child"]:
        sys.exit(poly_child())
    sys.exit(main())
