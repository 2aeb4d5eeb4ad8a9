"""Probe, third round of warp gathers: packed u16 and u8 gathers, and the
minimal Pallas dynamic gathers.

The port of the TPU probe ``benchmarks/gather_probe3.py``: a uint8 image
and mask (128, 256, 256) with one rotation field per image (theta from
numpy's ``default_rng(0)``). P1 (image and mask packed into 16 bits, one
gather), P2 (a uint8 gather) and P3 (a float32 gather), which the probe's
``main()`` runs as XLA gathers, become their torch calls. P4 (axis 0 of
(8, 128) with indices in [0, 8)), P5 (axis 0 of (512, 128)) and P6 (axis 1
of (256, 256)) are the probe's Pallas builders, which its ``main()``
defines and never runs; here they go through ``csrc/gather_probe.cu``
(``gather_probe.gather``), their indices drawn from the same generator in
the order P4, P5, P6.

On the card (queued device time; torch.gather of the same call beside each
kernel builder):

    python -m ddti_tpu_torch.probes.gather_probe3

On the CPU, through the plain versions, no times:

    python -m ddti_tpu_torch.probes.gather_probe3 --device cpu --batch 2
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .gather_probe import H, N, W, make_src, run_builders
from .gather_probe2 import index_fields


def kernel_builders(rng, seed=0):
    """P4, P5 and P6 ({name: (src, idx, mode, want)}), their indices drawn
    from ``rng`` in that order."""
    out = {}
    for name, shape, axis in (("P4 pallas dyn_gather 8x128", (8, 128), 0),
                              ("P5 pallas dyn_gather 512 ", (512, 128), 0),
                              ("P6 pallas dyn_gather ax1 ", (256, 256), 1)):
        s = make_src(shape, seed)
        idx = rng.integers(0, shape[axis], shape).astype(np.int32)
        out[name] = (s, idx, axis, np.take_along_axis(s, idx, axis=axis))
    return out


def builders(n=N, h=H, w=W, seed=0):
    """The torch calls P1-P3 ({name: (make, args, wants)}) and the kernel
    builders P4-P6 of ``gather_probe.run_builders``."""
    rng, yi, xi = index_fields(n, h, w)
    lin = (yi * w + xi).reshape(n, -1)
    gen = np.random.default_rng(seed)
    img = gen.integers(0, 256, (n, h, w), dtype=np.uint8)
    mask = gen.integers(0, 256, (n, h, w), dtype=np.uint8)
    want_i = np.take_along_axis(img.reshape(n, -1), lin, axis=1)
    want_m = np.take_along_axis(mask.reshape(n, -1), lin, axis=1)

    def p1_packed(i8, m8, ix):
        index = ix.long()

        def call():
            packed = (i8.reshape(n, -1).to(torch.int16) << 8) \
                | m8.reshape(n, -1).to(torch.int16)
            out = torch.gather(packed, 1, index)
            return (((out >> 8) & 0xFF).to(torch.uint8),
                    (out & 0xFF).to(torch.uint8))
        return call

    def p2_u8(i8, ix):
        index = ix.long()
        return lambda: torch.gather(i8.reshape(n, -1), 1, index)

    def p3_f32(i8, ix):
        x, index = i8.float().reshape(n, -1), ix.long()
        return lambda: torch.gather(x, 1, index)

    calls = {
        "P1 u16 packed xla   ": (p1_packed, (img, mask, lin),
                                 (want_i, want_m)),
        "P2 u8 xla           ": (p2_u8, (img, lin), (want_i,)),
        "P3 f32 xla          ": (p3_f32, (img, lin),
                                 (want_i.astype(np.float32),)),
    }
    return calls, kernel_builders(rng, seed)


def run(n=N, h=H, w=W, seed=0, device="cuda"):
    """P1-P3 as torch calls, then P4-P6 through the kernel; prints the
    probe's line per builder and returns {name: dict}."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain "
                           "versions")
    calls, kernel = builders(n, h, w, seed)
    rows = run_builders({}, device, calls)
    rows.update(run_builders(kernel, device))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--batch", type=int, default=N)
    p.add_argument("--size", type=int, default=H)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    run(a.batch, a.size, a.size, a.seed, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
