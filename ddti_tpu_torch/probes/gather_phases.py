"""Diagnostic: where a block of the gather kernel's staged path spends its
cycles.

Not a path of the port. It copies ``ddti_tpu_torch/`` into
``build/gather_phases/`` of the checkout, adds ``clock64`` reads around
the four phases of a staged block of ``csrc/gather_probe.cu`` with a shared
index (plan the window; issue the copies of the window ``kBufs - 1``
images ahead; wait for this image's window; gather it and release the
buffer), builds that copy and runs builders A, B and B2 through it, bit
for bit against the plain version. Thread 0 of each block writes its
cycles into the ``staged`` buffer after the count, which this script
widens to 1 + 8 int64s a block. Prints, per builder, the mean cycles a
block spends in each phase and the longest block's total, beside the
window sizes ``plan_windows`` gives. On the card only:

    python -m ddti_tpu_torch.probes.gather_phases
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
BUILDERS = ("A", "B", "B2")
PHASES = ("plan", "issue", "wait", "gather", "total")
# (anchor in csrc/gather_probe.cu, its instrumented form): each anchor
# occurs once in the source
PATCHES = [
    ("""  if constexpr (SHARED) {
    const Window win = plan_tile<MODE>(idx, off, i0, j0, r, c, ir, ic,
                                       stage_ok, red);
""", """  long long t0 = clock64(), t1, cyc[4] = {0, 0, 0, 0};
  if constexpr (SHARED) {
    const Window win = plan_tile<MODE>(idx, off, i0, j0, r, c, ir, ic,
                                       stage_ok, red);
    cyc[0] = clock64() - t0;
"""),
    ("""        if (ahead < n1) copy_window(buf(ahead), src + ahead * rc, win, c);
        cp_async_commit();
        cp_async_wait<kBufs - 1>();
        __syncthreads();
        gather_tile(out + b * m, buf(b), nullptr, off, i0, j0, ic);
        __syncthreads();  // the buffer is free for image b + kBufs
""", """        t1 = clock64();
        if (ahead < n1) copy_window(buf(ahead), src + ahead * rc, win, c);
        cp_async_commit();
        cyc[1] += clock64() - t1;
        t1 = clock64();
        cp_async_wait<kBufs - 1>();
        __syncthreads();
        cyc[2] += clock64() - t1;
        t1 = clock64();
        gather_tile(out + b * m, buf(b), nullptr, off, i0, j0, ic);
        __syncthreads();  // the buffer is free for image b + kBufs
        cyc[3] += clock64() - t1;
"""),
    ("""  if (staged && threadIdx.x == 0 && count) atomicAdd(staged, count);
}
""", """  if (staged && threadIdx.x == 0 && count) atomicAdd(staged, count);
  if (staged && threadIdx.x == 0) {
    unsigned long long* t =
        staged + 1 + 8 * (blockIdx.y * gridDim.x + blockIdx.x);
    for (int k = 0; k < 4; ++k) t[k] = cyc[k];
    t[4] = clock64() - t0;
    t[5] = gridDim.x * gridDim.y;
  }
}
"""),
]


def instrumented_source(text):
    """``csrc/gather_probe.cu``'s text with the phase clocks added. Raises
    where an anchor is not found exactly once (the kernel changed)."""
    for anchor, replacement in PATCHES:
        if text.count(anchor) != 1:
            raise ValueError("csrc/gather_probe.cu no longer has the anchor "
                             f"{anchor.splitlines()[0]!r} exactly once")
        text = text.replace(anchor, replacement)
    return text


def child():
    """In the instrumented copy: each builder's phase cycles a block."""
    import torch

    from ..ops._build import launch
    from ..ops.attention import _stream
    from . import gather_probe as G
    from . import gather_probe2 as G2

    table = dict(G.builders())
    table.update(G2.builders()[0])
    for name, (s_np, i_np, mode, _) in table.items():
        if name.split()[0] not in BUILDERS:
            continue
        s, i = torch.from_numpy(s_np).cuda(), torch.from_numpy(i_np).cuda()
        n, (r, c), (ir, ic) = s.shape[0], s.shape[-2:], i.shape
        tiles = -(-ir // G.TILE) * -(-ic // G.TILE)
        buf = torch.zeros(1 + 8 * tiles * n, dtype=torch.int64,
                          device="cuda")
        out = torch.empty((n, ir, ic), device="cuda")
        for _ in range(5):  # the last call's cycles, warm
            buf.zero_()
            launch("gather_probe", s.data_ptr(), i.data_ptr(), out.data_ptr(),
                   buf.data_ptr(), n, r, c, ir, ic, 1, G.MODES[mode], 0,
                   _stream(0))
        torch.cuda.synchronize()
        want = G.gather_reference(s, i, mode)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32)), \
            f"{name.strip()}: the instrumented kernel differs from plain"
        cyc = buf[1:].view(-1, 8).cpu().numpy()
        cyc = cyc[:int(cyc[0, 5])]
        win = G.plan_windows(i_np, r, c, mode, n=n)
        print(f"{name.strip()}: {len(cyc)} blocks; mean cycles a block "
              + ", ".join(f"{p} {cyc[:, k].mean():.0f}"
                          for k, p in enumerate(PHASES))
              + f"; longest block {cyc[:, 4].max()}; window mean "
              f"{win['bytes'].mean():.0f} bytes ({win['rows'].mean():.1f} "
              f"rows x {win['cols'].mean():.1f} floats)", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the diagnostic builds and runs "
                           "the kernel on the card")
    dst = PKG.parent / "build" / "gather_phases"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(PKG, dst / PKG.name,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cu = dst / PKG.name / "csrc" / "gather_probe.cu"
    cu.write_text(instrumented_source(cu.read_text()))
    return subprocess.run([sys.executable, "-m", f"{PKG.name}.probes."
                           "gather_phases", "--child"], cwd=dst).returncode


if __name__ == "__main__":
    sys.exit(child() if sys.argv[1:] == ["--child"] else main())
