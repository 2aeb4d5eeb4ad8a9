"""Diagnostic: what bounds route "wgmma" of the int8 conv
(``csrc/conv_s8.cu``), by taking one of its parts away at a time.

Not a path of the port. For each variant it copies ``ddti_tpu_torch/``
into ``build/conv_s8_ablate/<variant>/`` of the checkout, takes one part
out of the wgmma kernel's source, builds that copy and times route
"wgmma" through it at the flagship ResUNet's five 3x3 levels (16 x 512^2
x 64 -> 64 down to 16 x 32^2 x 1024 -> 1024, bf16 out), x as int8 and as
bf16, queued behind a device-side sleep (CUDA events). The variants:

- ``full``: the kernel as it is;
- ``no_quant``: the quantizer warpgroup writes no s8 tile (x's box is
  loaded, not read; the products read what the tile held);
- ``no_weights``: the weights' producer loads no tile (it arrives on the
  slot's barrier alone; the products read what the slot held);
- ``no_x``: the x producer loads no box;
- ``no_mma``: the consumers issue no product;
- ``no_store``: the storer writes nothing (the staging and its barriers
  stay).

The outputs of every variant but ``full`` are wrong by design; ``full``
is checked bit for bit against the plain version. A part's cost is how
much time its removal saves. On the card only:

    python -m ddti_tpu_torch.probes.conv_s8_ablate [--levels 0,4] [variant ...]
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parents[1]
LEVELS = [(16, 512 >> i, 512 >> i, 64 << i, 64 << i) for i in range(5)]
FORMS = ("int8", "bf16")
# variant -> [(anchor in csrc/conv_s8.cu, its replacement)]; each anchor
# occurs once in the source
VARIANTS = {
    "full": [],
    "no_quant": [(
        "        quantize_box<XT>(smem + g.xoff + xr.slot * g.xslot,\n"
        "                         smem + g.aoff + ar.slot * g.aslot, g, tid, "
        "sx);\n", "")],
    "no_weights": [(
        "            mbar_expect_tx(bfull + r.slot, g.bslot);\n"
        "            tma_load(smem + g.boff + r.slot * g.bslot, &w_map,\n"
        "                     bfull + r.slot, tap * g.cp + ch * kCB, "
        "t.ct * BN,\n"
        "                     t.par);\n",
        "            mbar_arrive(bfull + r.slot);\n")],
    "no_x": [(
        "          mbar_expect_tx(xfull + r.slot, xbytes);\n"
        "          tma_load(smem + g.xoff + r.slot * g.xslot, &x_map, "
        "xfull + r.slot,\n"
        "                   ch * kCB, t.ox0 - g.pl, t.oy0 - g.pt, "
        "t.img);\n",
        "          mbar_arrive(xfull + r.slot);\n")],
    "no_mma": [(
        "            mma_chunk<BN>(acc, a0 + 16 * g.dil * (kh * g.bw + kw),\n"
        "                          smem_addr(smem + g.boff + br.slot * "
        "g.bslot), g);\n", "")],
    "no_store": [(
        "            if (g.transpose)\n"
        "              tma_store(&y_map, out + b * kOutBox, co, t.par & 1, "
        "t.ox0,\n"
        "                        t.par >> 1, t.oy0 + kWgRows * w);\n"
        "            else\n"
        "              tma_store(&y_map, out + b * kOutBox, co, t.ox0,\n"
        "                        t.oy0 + kWgRows * w, t.img);\n", "")],
}


def patched_source(text, variant):
    """``csrc/conv_s8.cu``'s text with ``variant``'s part taken out.
    Raises where an anchor is not found exactly once (the kernel
    changed)."""
    for anchor, replacement in VARIANTS[variant]:
        if text.count(anchor) != 1:
            raise ValueError(f"csrc/conv_s8.cu no longer has {variant}'s "
                             f"anchor:\n{anchor}")
        text = text.replace(anchor, replacement)
    return text


def make_copy(root, variant):
    """The package copied under ``root/variant`` with the patched kernel;
    returns the directory to put on sys.path."""
    dest = Path(root) / variant
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(PKG, dest / "ddti_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    src = dest / "ddti_tpu_torch" / "csrc" / "conv_s8.cu"
    src.write_text(patched_source(src.read_text(), variant))
    return dest


def time_variant(variant, levels=None):
    """In this process (the variant's copy first on sys.path): build, then
    route "wgmma"'s queued ms at each level (``levels``: their indices,
    all by default) and form; ``full`` checked against the plain version.
    Prints one JSON line."""
    import numpy as np
    import torch

    from ddti_tpu_torch.ops import _build
    from ddti_tpu_torch.ops import conv_s8 as C

    _build.build()
    rows = []
    for i, (n, h, w, c, cout) in enumerate(LEVELS):
        if levels is not None and i not in levels:
            continue
        rng = np.random.default_rng(i)
        wq = torch.from_numpy(rng.integers(-127, 128, (3, 3, c, cout),
                                           dtype=np.int8)).cuda()
        sx = torch.tensor(np.float32(0.0137)).cuda()
        sw = torch.from_numpy(rng.uniform(1e-4, 2e-2, cout).astype(
            np.float32)).cuda()
        bias = torch.from_numpy(rng.normal(size=cout).astype(
            np.float32)).cuda()
        for form in FORMS:
            if form == "int8":
                x = torch.from_numpy(rng.integers(
                    -127, 128, (n, h, w, c), dtype=np.int8)).cuda()
            else:
                x = (torch.randn((n, h, w, c), device="cuda") * 0.6).to(
                    torch.bfloat16)
            args = (x, wq, sx, sw, bias, 1, 1, 1, 1, h, w, False, True)
            if variant == "full":
                got = C.conv_s8_cuda(*args, route="wgmma")
                assert torch.equal(got, C.conv_s8_reference(*args))
                del got
            ms = queued_ms(lambda: C.conv_s8_cuda(*args, route="wgmma"))
            rows.append(dict(shape=[n, h, w, c, cout], form=form, ms=ms))
            print(f"[conv_s8_ablate] {variant} {form} {n}x{h}x{w}x{c}->"
                  f"{cout}: {ms:.4f} ms queued", flush=True)
        torch.cuda.empty_cache()
    print("[conv_s8_ablate] " + json.dumps({"variant": variant,
                                             "rows": rows}), flush=True)


def queued_ms(fn, calls=20):
    """Device ms per call of ``fn``: ``calls`` calls enqueued behind a
    device-side sleep, CUDA events around them."""
    import torch

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def main(argv=None):
    """``[--levels 0,1,...] [variant ...]``: every variant at every level
    by default."""
    argv = sys.argv[1:] if argv is None else argv
    levels = None
    if argv[:1] == ["--levels"]:
        levels, argv = argv[1], argv[2:]
    import torch

    if not torch.cuda.is_available():
        print("conv_s8_ablate needs an NVIDIA card", file=sys.stderr)
        return 2
    root = PKG.parent / "build" / "conv_s8_ablate"
    for variant in argv or VARIANTS:
        dest = make_copy(root, variant)
        subprocess.run([sys.executable, "-c",
                        "import sys; sys.path.insert(0, sys.argv[1]); "
                        "from ddti_tpu_torch.probes import conv_s8_ablate "
                        "as P; P.time_variant(sys.argv[2], None if "
                        "sys.argv[3] == 'all' else [int(v) for v in "
                        "sys.argv[3].split(',')])",
                        str(dest), variant, levels or "all"], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
