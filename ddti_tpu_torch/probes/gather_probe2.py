"""Probe, second round of warp gathers: per-image index fields.

The port of the TPU probe ``benchmarks/gather_probe2.py``: src (128, 256,
256) float32 and one rotation field per image, theta drawn from numpy's
``default_rng(0)`` on [-pi, pi). B2 (take_along_axis along rows with the
first image's field, shared, ``promise_in_bounds``) and F (axis 0 over a
(2048, 128) block with random indices in [0, 2048)) go through
``csrc/gather_probe.cu`` (``gather_probe.gather``); E (a flat take per image
with its own index), E2 (the same as one batched take_along_axis) and G
(take_along_axis along axis 0 of the batch-in-lanes (H W, N) layout), the
probe's XLA builders, become their torch calls.

On the card (queued device time; torch.gather of the same call beside each
kernel builder):

    python -m ddti_tpu_torch.probes.gather_probe2

On the CPU, through the plain versions, no times:

    python -m ddti_tpu_torch.probes.gather_probe2 --device cpu --batch 2
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .gather_probe import H, N, W, make_src, rotation_fields, run_builders

HW_T = 2048  # builder F's sublane range


def index_fields(n=N, h=H, w=W):
    """The probe's per-image fields: the generator after its thetas (F
    draws from it next), and (yi, xi) int32 (n, h, w)."""
    rng = np.random.default_rng(0)
    ths = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    fields = [rotation_fields(th, h, w) for th in ths]
    return (rng, np.stack([f[0] for f in fields]),
            np.stack([f[1] for f in fields]))


def builders(n=N, h=H, w=W, seed=0):
    """The kernel builders B2 and F ({name: (src, idx, mode, want)}) and the
    torch calls E, E2 and G ({name: (make, args, wants)}) of
    ``gather_probe.run_builders``."""
    rng, yi, xi = index_fields(n, h, w)
    src = make_src((n, h, w), seed)
    lin = yi * w + xi
    want = np.take_along_axis(src.reshape(n, -1), lin.reshape(n, -1),
                              axis=1).reshape(n, h, w)
    s2 = make_src((HW_T, n), seed)
    idx_f = rng.integers(0, HW_T, (HW_T, n)).astype(np.int32)
    kernel = {
        "B2 pallas taa ax0 promise  ": (
            src, yi[0], 0, np.take_along_axis(src, yi[0][None], axis=1)),
        "F  pallas dyn_gather lanes ": (
            s2, idx_f, 0, np.take_along_axis(s2, idx_f, axis=0)),
    }

    def e_take(s, i):
        index = i.reshape(i.shape[0], -1).long()
        return lambda: torch.gather(s.reshape(s.shape[0], -1), 1,
                                    index).reshape(s.shape)

    def e2_taa(s, i):
        index = i.reshape(i.shape[0], -1).long()
        return lambda: torch.take_along_dim(
            s.reshape(s.shape[0], -1), index, dim=1).reshape(s.shape)

    def g_lanes(s, i):
        index = i.long()
        return lambda: torch.take_along_dim(s, index, dim=0)

    calls = {
        "E  xla take idx-input      ": (e_take, (src, lin), (want,)),
        "E2 xla taa batched         ": (e2_taa, (src, lin), (want,)),
        "G  xla taa (HW,N) lanes    ": (
            g_lanes, (src.reshape(n, -1).T.copy(),
                      lin.reshape(n, -1).T.copy()),
            (want.reshape(n, -1).T,)),
    }
    return kernel, calls


def run(n=N, h=H, w=W, seed=0, device="cuda"):
    """E, E2, B2, F and G in the probe's order; prints the probe's line per
    builder and returns {name: dict}."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain "
                           "versions")
    kernel, calls = builders(n, h, w, seed)
    rows = run_builders({}, device, {k: calls[k] for k in list(calls)[:2]})
    rows.update(run_builders(kernel, device))
    rows.update(run_builders({}, device, {k: calls[k]
                                          for k in list(calls)[2:]}))
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
