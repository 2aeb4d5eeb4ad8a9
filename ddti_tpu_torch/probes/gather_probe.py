"""Probe: what a per-element gather costs, for the augmentation warp.

The port of the TPU probe ``benchmarks/gather_probe.py``: src (128, 256,
256) float32 and one int32 index field (256, 256), shared by every image,
from a rotation by theta = 0.3 (8.4 M gathered elements a call, what the
warp gathers per batch). Builders A (a flat take over each image's H W
elements), B (take_along_axis along the image's rows, axis 0) and C (along
its columns, axis 1) go through ``csrc/gather_probe.cu``; D, the probe's
XLA flat take, becomes its torch call (``torch.gather``). The kernel also
serves ``gather_probe2`` and ``gather_probe3``.

``gather_cuda`` launches the kernel on CUDA tensors, ``gather_reference``
is its plain version and ``gather`` dispatches by device. Out-of-range
indices follow JAX's default gather mode: k in [-len, -1] wraps, any other
k outside [0, len) gives NaN. In the flat and row modes the kernel gives a
block a 64 x 64 output tile and, where the tile's source window fits
``STAGE_CAP`` bytes, copies the window into shared memory once per image
and gathers from there; ``plan_windows`` computes that choice on the host,
and ``gather_cuda(..., staged=counter)`` makes the kernel count it.

On the card (times: CUDA events around calls queued behind a device-side
sleep, device time only; torch.gather of the same call beside each):

    python -m ddti_tpu_torch.probes.gather_probe

On the CPU, through the plain versions, no times:

    python -m ddti_tpu_torch.probes.gather_probe --device cpu --batch 2
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..ops.attention import _stream

H = W = 256
N = 128
THETA = 0.3
# mode -> csrc/gather_probe.cu's mode code: a flat take over the image,
# take_along_axis along its rows (axis 0) or along its columns (axis 1)
MODES = {"flat": 0, 0: 1, 1: 2}
PEAK_BYTES = 3.35e12  # H100 SXM HBM3, bytes/s (NVIDIA's data sheet)
# csrc/gather_probe.cu's flat and row modes: output tiles of TILE x TILE,
# a source window staged where it holds at most STAGE_CAP bytes
TILE = 64
STAGE_CAP = 32768
# an H100 SXM's SMs: a call of fewer tiles takes no window (plan_windows'
# default; callers on the card pass the device's count)
SMS = 132


def _check_shapes(src, idx, mode):
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of 'flat', 0, 1")
    if src.dim() not in (2, 3) or idx.dim() not in (2, 3):
        raise ValueError("src and idx must be (N, R, C) or (R, C)")
    if idx.dim() == 3 and (src.dim() != 3 or idx.shape[0] != src.shape[0]):
        raise ValueError("a batched idx needs src of the same batch")
    r, c = src.shape[-2:]
    ir, ic = idx.shape[-2:]
    if (mode == 0 and ic != c) or (mode == 1 and ir != r):
        raise ValueError(f"idx {tuple(idx.shape)} does not fit src "
                         f"{tuple(src.shape)} along axis {mode}")


def gather_reference(src, idx, mode):
    """The kernel's function in plain PyTorch: for every image of ``src``
    ((N, R, C), or one (R, C) image), the index ``idx`` ((R', C') shared by
    every image, or (N, R', C')) taken over the flattened image
    (``mode="flat"``), along its rows (0) or along its columns (1), as
    ``jnp.take`` / ``jnp.take_along_axis`` take it: negative indices wrap
    once, the rest out of range give NaN. The output has idx's shape, with
    src's batch."""
    _check_shapes(src, idx, mode)
    s = src if src.dim() == 3 else src[None]
    n = s.shape[0]
    i = idx if idx.dim() == 3 else idx[None].expand(n, -1, -1)
    r, c = src.shape[-2:]
    length = r * c if mode == "flat" else (r, c)[mode]
    k = i.long()
    k = torch.where(k < 0, k + length, k)
    valid = (k >= 0) & (k < length)
    k = k.clamp(0, length - 1)
    if mode == "flat":
        out = torch.gather(s.reshape(n, -1), 1, k.reshape(n, -1))
        out = out.reshape(k.shape)
    else:
        out = torch.gather(s, 1 + mode, k)
    out = torch.where(valid, out, torch.full_like(out, float("nan")))
    return out if src.dim() == 3 else out[0]


def gather_cuda(src, idx, mode, staged=None):
    """Launch ``csrc/gather_probe.cu`` on contiguous float32 ``src`` and
    int32 ``idx`` CUDA tensors of ``gather_reference``'s shapes; a 2-D idx
    is read once for all images. Checks no index element. ``staged``: None,
    or an int64 CUDA tensor of one element to which the kernel adds the
    (tile, image) pairs it gathered from a staged window (``plan_windows``
    says which). Raises on anything the kernel does not take. Adds one to
    ``gather_cuda.launches`` per launch."""
    _check_shapes(src, idx, mode)
    if src.dtype != torch.float32 or idx.dtype != torch.int32:
        raise ValueError(f"src must be float32 and idx int32; got "
                         f"{src.dtype}, {idx.dtype}")
    if not (src.is_cuda and idx.is_cuda) or src.device != idx.device:
        raise ValueError("src and idx must lie on one CUDA device")
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("src and idx must be contiguous")
    if src.numel() == 0 or idx.numel() == 0:
        raise ValueError("src and idx must not be empty")
    r, c = src.shape[-2:]
    ir, ic = idx.shape[-2:]
    n = src.shape[0] if src.dim() == 3 else 1
    if r * c >= 2 ** 31 or n * ir * ic >= 2 ** 31:
        raise ValueError("an image and the output must hold < 2^31 elements")
    if staged is not None and (staged.dtype != torch.int64
                               or staged.device != src.device
                               or staged.numel() != 1):
        raise ValueError("staged must be one int64 on src's device")
    from ..ops._build import launch

    out = torch.empty(((n,) if src.dim() == 3 else ()) + (ir, ic),
                      dtype=torch.float32, device=src.device)
    dev = src.device.index
    launch("gather_probe", src.data_ptr(), idx.data_ptr(), out.data_ptr(),
           None if staged is None else staged.data_ptr(), n, r, c, ir, ic,
           int(idx.dim() == 2), MODES[mode], dev, _stream(dev))
    gather_cuda.launches += 1
    return out


gather_cuda.launches = 0


def staged_count(src, idx, mode):
    """The kernel once on CUDA tensors with its counter: (out, the number
    of (tile, image) pairs it gathered from a staged window)."""
    counter = torch.zeros(1, dtype=torch.int64, device=src.device)
    out = gather_cuda(src, idx, mode, staged=counter)
    return out, int(counter.item())


def _tile_view(a, fill):
    """(planes, R', C') -> (planes, TR, TILE, TC, TILE), padded with
    ``fill`` to whole tiles."""
    p, ir, ic = a.shape
    tr, tc = -(-ir // TILE), -(-ic // TILE)
    full = np.full((p, tr * TILE, tc * TILE), fill, a.dtype)
    full[:, :ir, :ic] = a
    return full.reshape(p, tr, TILE, tc, TILE)


def plan_windows(idx, r, c, mode, aligned=True, n=None, sms=SMS):
    """The kernel's plan of its flat and row modes, tile by tile, in numpy:
    for an index plane ``idx`` ((R', C') shared, or (N, R', C')) over
    images of (r, c), each TILE x TILE tile's source window (rows [rlo,
    rhi] of the in-range indices after the wrap of negatives; in flat mode
    columns k % c too, rounded out to multiples of 4, in row mode the
    tile's own columns) and whether the tile stages it: the mode is flat
    or rows, c % 4 == 0, the image is 16-byte ``aligned``, the call of
    ``n`` images (default: one per plane) has at least ``sms`` (tile,
    image) pairs, and the window holds at most STAGE_CAP bytes. A tile
    with no in-range index has an empty window and stages (it only writes
    NaN). Returns a dict of (planes, TR, TC) arrays: staged, rows, cols
    (floats a window row), bytes, rlo, clo; the column mode stages
    nothing."""
    if mode not in MODES:
        raise ValueError(f"mode {mode!r}: one of 'flat', 0, 1")
    i = np.asarray(idx, np.int64)
    i = i[None] if i.ndim == 2 else i
    p, ir, ic = i.shape
    if mode == 1:
        zero = np.zeros((p, -(-ir // TILE), -(-ic // TILE)), np.int64)
        return dict(staged=zero.astype(bool), rows=zero, cols=zero,
                    bytes=zero, rlo=zero, clo=zero)
    length = r * c if mode == "flat" else r
    k = np.where(i < 0, i + length, i)
    inr = (k >= 0) & (k < length)
    cols = np.broadcast_to(np.arange(ic), i.shape)
    sr = k // c if mode == "flat" else k
    sc = k % c if mode == "flat" else cols
    big = np.iinfo(np.int64).max
    t_in = _tile_view(inr, False)
    rlo = np.where(t_in, _tile_view(sr, 0), big).min((2, 4))
    rhi = np.where(t_in, _tile_view(sr, 0), -big).max((2, 4))
    nonempty = rhi >= rlo
    if mode == "flat":
        clo = np.where(t_in, _tile_view(sc, 0), big).min((2, 4))
        chi = np.where(t_in, _tile_view(sc, 0), -big).max((2, 4))
    else:
        j0 = np.arange(-(-ic // TILE)) * TILE
        clo = np.broadcast_to(j0, rlo.shape)
        chi = np.broadcast_to(np.minimum(j0 + TILE, ic) - 1, rlo.shape)
    clo4 = np.where(nonempty, clo & ~3, 0)
    rows = np.where(nonempty, rhi - rlo + 1, 0)
    ncols = np.where(nonempty, (chi | 3) + 1 - clo4, 0)
    nbytes = rows * ncols * 4
    n = p if n is None else n
    ok = mode in ("flat", 0) and c % 4 == 0 and aligned \
        and rlo[0].size * n >= sms
    return dict(staged=ok & (nbytes <= STAGE_CAP), rows=rows, cols=ncols,
                bytes=nbytes, rlo=np.where(nonempty, rlo, 0), clo=clo4)


def planned_staged(idx, n, r, c, mode, aligned=True, sms=SMS):
    """The staged (tile, image) pairs the kernel counts for a call of n
    images: every staged tile of a shared plane n times, of per-image
    planes once."""
    staged = plan_windows(idx, r, c, mode, aligned, n, sms)["staged"]
    return int(staged.sum()) * (n if np.ndim(idx) == 2 else 1)


def window_cases(seed=0):
    """Index planes at the edges of the kernel's staged path, {name: (src,
    idx, mode)} as numpy arrays: in row and flat mode a window of exactly
    STAGE_CAP bytes in every tile and one a step past it (the next size a
    window can take: one more row, or four more columns); negative indices
    that wrap into a staged window and indices out of range beside them;
    per-image index planes (rotations by three angles) that stage."""
    rng = np.random.default_rng(seed)
    ii, jj = np.mgrid[:256, :128]
    cases = {}
    # batches of at least SMS (tile, image) pairs, so that the calls tile
    for name, rows in (("rows at cap", 128), ("rows past cap", 129)):
        # every 64 x 64 tile spans `rows` source rows, 64 columns
        cases[name] = (make_src((17, 256, 128), seed),
                       ((2 * ii + jj) % rows).astype(np.int32), 0)
    ii, jj = np.mgrid[:128, :256]
    for name, cols in (("flat at cap", 128), ("flat past cap", 132)):
        # every tile spans 64 source rows of `cols` columns of 256
        cases[name] = (make_src((17, 128, 256), seed),
                       ((ii % 64) * 256 + (2 * jj + ii) % cols)
                       .astype(np.int32), "flat")
    for mode, length in ((0, 64), ("flat", 64 * 64)):
        idx = rng.integers(length * 5 // 8, length, (64, 64)).astype(np.int32)
        idx.reshape(-1)[[0, 9, 70, 3000, 4095]] = [-1, -3, length,
                                                   -length - 1, -length]
        cases[f"{mode} edges staged"] = (make_src((SMS, 64, 64), seed), idx,
                                         mode)
    thetas = np.linspace(-3.0, 3.0, 9)
    fields = [rotation_fields(th) for th in thetas]
    for mode in (0, "flat"):
        idx = np.stack([f[0] if mode == 0 else f[0] * W + f[1]
                        for f in fields])
        cases[f"{mode} per-image"] = (make_src((len(thetas), H, W), seed),
                                      idx, mode)
    return cases


def gather(src, idx, mode):
    """The kernel on CUDA tensors, its plain version on CPU tensors."""
    if src.device.type == "cpu":
        return gather_reference(src, idx, mode)
    return gather_cuda(src, idx, mode)


def torch_index(idx, n):
    """``idx`` as torch.gather takes it: int64, (n, R', C'); a shared
    (R', C') plane is expanded over the batch (stride 0, no copy). Set-up,
    outside the timed call."""
    i = idx.long()
    return i if i.dim() == 3 else i[None].expand(n, -1, -1)


def torch_gather(src, index, mode):
    """The same call as one ``torch.gather`` (in-range indices only;
    ``index`` from ``torch_index``): the library yardstick beside the
    kernel, which the port never calls on a path."""
    s = src if src.dim() == 3 else src[None]
    if mode == "flat":
        out = torch.gather(s.reshape(s.shape[0], -1), 1,
                           index.reshape(index.shape[0], -1))
        out = out.reshape(index.shape)
    else:
        out = torch.gather(s, 1 + mode, index)
    return out if src.dim() == 3 else out[0]


def rotation_fields(theta, h=H, w=W):
    """The probes' index fields of a rotation by ``theta`` about the image
    centre, as ``benchmarks/gather_probe*.py`` compute them: (yi, xi), int32
    (h, w) source rows and columns, floored and clipped to the image. The
    arithmetic follows theta's numpy type (a Python float gives float64
    products, a float32 theta float32 ones), as in the probes."""
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    ys = (-np.sin(theta) * (xx - w / 2) + np.cos(theta) * (yy - h / 2)
          + h / 2)
    xs = (np.cos(theta) * (xx - w / 2) + np.sin(theta) * (yy - h / 2)
          + w / 2)
    yi = np.clip(np.floor(ys), 0, h - 1).astype(np.int32)
    xi = np.clip(np.floor(xs), 0, w - 1).astype(np.int32)
    return yi, xi


def make_src(shape, seed=0):
    """float32 uniform on [0, 1) from numpy's seeded generator (the probes
    draw jax.random.uniform; only the index fields are theirs bit for
    bit)."""
    return np.random.default_rng(seed).random(shape, dtype=np.float32)


def bound_ms(n, m, shared=True, elem=4):
    """The least time the card could take for a gather of n images of m
    elements: src read once, out written once (``elem`` bytes each) and the
    int32 index read once (once in all where it is shared) at the memory
    rate."""
    nbytes = n * m * 2 * elem + (m if shared else n * m) * 4
    return nbytes / PEAK_BYTES * 1e3


def builders(n=N, h=H, w=W, seed=0):
    """The probe's kernel builders A, B and C: {name: (src, idx, mode,
    want)} as numpy arrays, ``want`` the probe's numpy check. They share
    one (h, w) index field of the theta = 0.3 rotation."""
    src = make_src((n, h, w), seed)
    yi, xi = rotation_fields(THETA, h, w)
    return {
        "A pallas flat take   ": (src, yi * w + xi, "flat", src[:, yi, xi]),
        "B pallas taa axis0   ": (src, yi, 0,
                                  np.take_along_axis(src, yi[None], 1)),
        "C pallas taa axis1   ": (src, xi, 1,
                                  np.take_along_axis(src, xi[None], 2)),
    }


def run_builders(table, device, torch_calls=None):
    """Each builder of ``table`` ({name: (src, idx, mode, want)}) through
    ``gather``, held bit for bit to its numpy want, and on the card timed
    (queued device time) beside ``torch_gather`` of the same call; then
    each of ``torch_calls`` ({name: (make, args, wants)}, the probes' XLA
    builders as torch calls: ``make(*args on the device)`` does the set-up
    and returns the call, which returns one output per want) alike. Prints
    the probe's line per builder and returns {name: dict}."""
    on_card = torch.device(device).type != "cpu"
    if on_card:
        from ._timing import queued_ms
    rows = {}
    for name, (src, idx, mode, want) in table.items():
        s = torch.from_numpy(src).to(device)
        i = torch.from_numpy(idx).to(device)
        out = gather(s, i, mode)
        match = bool(np.array_equal(out.cpu().numpy(), want))
        n = s.shape[0] if s.dim() == 3 else 1
        b = bound_ms(n, i.shape[-2] * i.shape[-1], shared=i.dim() == 2)
        row = dict(match=match, bound_ms=b, shape=list(s.shape),
                   idx_shape=list(i.shape), mode=str(mode))
        if on_card:
            index = torch_index(i, n)
            row["ms"] = queued_ms(lambda: gather_cuda(s, i, mode))
            row["library_ms"] = queued_ms(
                lambda: torch_gather(s, index, mode))
            # few calls: each plain call is a dozen launches, and the
            # launch queue must not fill behind the sleep
            row["plain_ms"] = queued_ms(
                lambda: gather_reference(s, i, mode), calls=10)
        rows[name.strip()] = row
        print(f"{name}: OK match={match} "
              + (f"{row['ms']:.4f} ms (bound {b:.4f} ms, {b / row['ms']:.1%}"
                 f" of it; torch.gather {row['library_ms']:.4f} ms, plain "
                 f"{row['plain_ms']:.4f} ms)" if on_card else "not measured"),
              flush=True)
    for name, (make, args, wants) in (torch_calls or {}).items():
        call = make(*(torch.from_numpy(a).to(device) for a in args))
        outs = call()
        outs = outs if isinstance(outs, tuple) else (outs,)
        match = all(bool(np.array_equal(o.cpu().numpy(), w_))
                    for o, w_ in zip(outs, wants, strict=True))
        row = dict(match=match, torch_call=True)
        if on_card:
            row["ms"] = queued_ms(call)
        rows[name.strip()] = row
        print(f"{name}: OK match={match} "
              + (f"{row['ms']:.4f} ms (torch)" if on_card
                 else "not measured"), flush=True)
    return rows


def run(n=N, h=H, w=W, seed=0, device="cuda"):
    """Builders A, B, C through the kernel, and D, the XLA flat take of
    each image, as torch.gather; prints the probe's line per builder and
    returns {name: dict}."""
    if device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu for the plain "
                           "versions")
    table = builders(n, h, w, seed)
    src, lin, _, want = table["A pallas flat take   "]

    def d_flat_take(s, i):
        index = torch_index(i, s.shape[0])
        return lambda: torch_gather(s, index, "flat")

    return run_builders(table, device, {
        "D xla flat take      ": (d_flat_take, (src, lin), (want,))})


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
