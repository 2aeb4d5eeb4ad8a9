"""Diagnostic: the EDT's column pass at each width of its mask loads.

Not a path of the port. ``csrc/edt.cu`` picks V, the mask bytes a thread
loads a row (``column_bytes``), from W, the buffers' alignment and the SM
count. This script builds ``csrc/edt.cu`` alone once for each V of
``WIDTHS`` with that choice replaced by V, and once as it is ("rule"),
into ``build/edt_column_widths/`` of the checkout, all builds at once.
At each of ``SHAPES`` (the synthetic nodule masks that the boundary loss
takes) it holds every build bit for bit against the plain version, then
times each build twice, in the order of ``WIDTHS`` and back: its column
and row passes apart (torch.profiler, device time a launch) and the whole
call queued behind a device-side sleep. On the card only:

    python -m ddti_tpu_torch.probes.edt_column_widths
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
WIDTHS = (1, 2, 4)
# on an H100's 132 SMs: the training slice's (16, 512, 512), where the
# rule takes V = 2; the batch of 64 at that size and the smoke's second
# timed shape (128, 256, 256), where it takes 4
SHAPES = [(16, 512, 512), (64, 512, 512), (128, 256, 256)]
ANCHOR = "  const int v = column_bytes(fg, out, n, w, sms);\n"
PROFILED_CALLS = 20


def forced_source(text, v):
    """``csrc/edt.cu``'s text with the column pass's width fixed at ``v``.
    Raises where the anchor is not found exactly once (the kernel
    changed)."""
    if text.count(ANCHOR) != 1:
        raise ValueError("csrc/edt.cu no longer has the anchor "
                         f"{ANCHOR.strip()!r} exactly once")
    return text.replace(ANCHOR, f"  const int v = {v};\n")


def build(dst):
    """Every build at once: {label: loaded library}."""
    from ..ops import _build

    dst.mkdir(parents=True, exist_ok=True)
    text = (PKG / "csrc" / "edt.cu").read_text()
    sources = {"rule": text}
    sources.update({f"V={v}": forced_source(text, v) for v in WIDTHS})
    procs = {}
    for label, src in sources.items():
        stem = label.replace("=", "")
        cu = dst / f"edt_{stem}.cu"
        cu.write_text(src)
        so = dst / f"libedt_{stem}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(so),
               str(cu)]
        procs[label] = (so, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for label, (so, cmd, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n"
                               f"{' '.join(cmd)}\n{log}")
        lib = ctypes.CDLL(str(so))
        lib.ddti_edt.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_void_p]
        lib.ddti_edt.restype = ctypes.c_int
        libs[label] = lib
    return libs


def column_row_ms(fn):
    """Device time a launch of the column and the row pass (torch.profiler
    over PROFILED_CALLS calls, averaged over the launches it recorded; None
    where it recorded none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    split = {"column": None, "row": None}
    for e in prof.key_averages():
        for key in split:
            if f"edt_{key}" in e.key and e.count:
                split[key] = e.device_time_total / 1e3 / e.count
    return split["column"], split["row"]


def main():
    import torch

    from ..data.synthetic import generate_ddti_like
    from ..ops.edt import edt_reference
    from ._timing import queued_ms

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the diagnostic builds and runs "
                           "the kernel on the card")
    libs = build(PKG.parent / "build" / "edt_column_widths")
    stream = torch.cuda.current_stream().cuda_stream
    order = ["rule", *(f"V={v}" for v in WIDTHS)]
    for n, h, w in SHAPES:
        _, masks = generate_ddti_like(n, (h, w), 0)
        m = torch.from_numpy((masks[..., 0] == 0).astype("uint8")).cuda()
        out = torch.empty((n, h, w), device="cuda")
        want = edt_reference(m)

        def call(lib):
            err = lib.ddti_edt(m.data_ptr(), out.data_ptr(), n, h, w, stream)
            if err:
                raise RuntimeError(f"ddti_edt returned {err}")

        for label in order:
            out.zero_()
            call(libs[label])
            torch.cuda.synchronize()
            assert torch.equal(out, want), \
                f"{label} at {(n, h, w)}: differs from the plain version"
        for rnd, labels in enumerate((order, order[::-1])):
            for label in labels:
                lib = libs[label]
                col, row = column_row_ms(lambda: call(lib))
                q = queued_ms(lambda: call(lib))
                col, row = ("not recorded" if t is None else f"{t:.4f} ms"
                            for t in (col, row))
                print(f"{(n, h, w)} round {rnd} {label:5s}: column {col}, "
                      f"row {row}, queued {q:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
