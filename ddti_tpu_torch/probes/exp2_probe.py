"""Probe: the exp2 unit against a polynomial exp2 on the FMA pipes.

The port of the TPU probe ``benchmarks/exp2_probe.py``: y = f(x) over a
(512, 16384) float32 array drawn uniformly from [-20, 3], f the builtin
exp2, the polynomial exp2 of order 4, 5 or 6, or a copy (the memory floor).
``exp2_probe_cuda`` launches ``csrc/exp2_probe.cu`` on CUDA tensors,
``exp2_probe_reference`` is its plain version.

On the card (times: CUDA events around calls queued behind a device-side
sleep, device time only; torch.exp2 and Tensor.copy_ beside each mode):

    python -m ddti_tpu_torch.probes.exp2_probe

On the CPU, through the plain versions, errors only:

    python -m ddti_tpu_torch.probes.exp2_probe --device cpu --rows 64
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.attention import _exp2_poly, _stream

ROWS, COLS = 512, 16384
LOW, HIGH = -20.0, 3.0
# mode -> csrc/exp2_probe.cu's mode code
MODES = {"copy": 0, "builtin": 1, "poly4": 4, "poly5": 5, "poly6": 6}
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA's data sheet)
# the smallest normal float32: ex2.approx.ftz flushes results below it
MIN_NORMAL = 2.0 ** -126


def exp2_probe_reference(x, mode):
    """The kernel's function in plain PyTorch on float32 ``x``: a copy,
    torch.exp2 with results below 2^-126 flushed to +0 as the exp2 unit
    (``ex2.approx.ftz``) flushes them, or ``_exp2_poly`` of the mode's
    order."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {sorted(MODES)}")
    if mode == "copy":
        return x.clone()
    if mode == "builtin":
        y = torch.exp2(x)
        return torch.where(y < MIN_NORMAL, torch.zeros_like(y), y)
    return _exp2_poly(x, int(mode[4:]))


def exp2_probe_cuda(x, mode):
    """Launch ``csrc/exp2_probe.cu`` on a contiguous, 16-byte aligned
    float32 CUDA tensor; returns y of x's shape. Raises on anything the
    kernel does not take. Adds one to ``exp2_probe_cuda.launches`` per
    launch."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of {sorted(MODES)}")
    if x.dtype != torch.float32:
        raise ValueError(f"x must be float32; got {x.dtype}")
    if not x.is_cuda:
        raise ValueError("x must lie on a CUDA device")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    if x.numel() == 0:
        raise ValueError("x must not be empty")
    from ..ops._build import launch

    y = torch.empty_like(x)
    launch("exp2_probe", x.data_ptr(), y.data_ptr(), x.numel(), MODES[mode],
           x.device.index, _stream(x.device.index))
    exp2_probe_cuda.launches += 1
    return y


exp2_probe_cuda.launches = 0


def exp2_probe(x, mode):
    """The kernel on a CUDA tensor, its plain version on a CPU tensor."""
    if x.device.type == "cpu":
        return exp2_probe_reference(x, mode)
    return exp2_probe_cuda(x, mode)


def ulp_distance(a, b):
    """Largest distance in units in the last place between two float32
    tensors of non-negative values (their bit patterns as integers: the
    order of the non-negative floats, subnormals and zero included)."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max())


def make_input(rows, cols, seed=0, device="cuda"):
    """(rows, cols) float32, uniform on [LOW, HIGH), from numpy's seeded
    generator (the same numbers on every device)."""
    x = np.random.default_rng(seed).uniform(LOW, HIGH, (rows, cols))
    return torch.from_numpy(x.astype(np.float32)).to(device)


def bound_ms(numel):
    """The least time the card could take: every element read and written
    once at the memory rate (the exp2 unit's share, numel / (16 x 132 x
    1.98e9) per second, is a tenth of it)."""
    return 2 * 4 * numel / PEAK_BYTES * 1e3


def run(rows=ROWS, cols=COLS, seed=0, device="cuda"):
    """Every mode once: its max relative error against float64 exp2 (0 for
    the copy, which must be bit-equal), its ulp distance from the plain
    version on the same device, and on the card its queued device time
    beside torch.exp2's and Tensor.copy_'s. Prints the TPU probe's line per
    mode and returns {mode: dict}."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain "
                           "versions")
    x = make_input(rows, cols, seed, device)
    want = torch.exp2(x.double())
    on_card = x.device.type != "cpu"
    lib = {}
    if on_card:
        from ._timing import queued_ms

        out = torch.empty_like(x)
        lib = {"torch.exp2": queued_ms(lambda: torch.exp2(x, out=out)),
               "copy_": queued_ms(lambda: out.copy_(x))}
    rows_out = {}
    for mode in MODES:
        y = exp2_probe(x, mode)
        ref = exp2_probe_reference(x, mode)
        if mode == "copy":
            err = 0.0
            assert torch.equal(y.view(torch.int32), x.view(torch.int32))
        else:
            err = float(((y.double() - want).abs()
                         / want.clamp(min=1e-30)).max())
        ulps = ulp_distance(y, ref)
        ms = queued_ms(lambda: exp2_probe_cuda(x, mode)) if on_card else None
        rows_out[mode] = dict(ms=ms, max_rel_err=err, ulps_vs_plain=ulps,
                              abs_vs_plain=float((y - ref).abs().max()))
        print(f"{mode:8s}: "
              + (f"{ms:7.4f} ms" if ms is not None else "not measured")
              + f"   max rel err {err:.3e}   {ulps} ulp from plain"
              + (f"   (bound {bound_ms(x.numel()):.4f} ms; torch.exp2 "
                 f"{lib['torch.exp2']:.4f}, copy_ {lib['copy_']:.4f} ms)"
                 if on_card else ""), flush=True)
    return dict(modes=rows_out, library_ms=lib or None,
                bound_ms=bound_ms(x.numel()), shape=[rows, cols])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--rows", type=int, default=ROWS)
    p.add_argument("--cols", type=int, default=COLS)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args(argv)
    run(a.rows, a.cols, a.seed, a.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
