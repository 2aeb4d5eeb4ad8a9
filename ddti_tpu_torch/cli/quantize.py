"""Offline int8 quantization, ported from ``ddti_tpu/cli/quantize.py``: any
trained checkpoint into an int8 serving bundle, no retraining.

  python -m ddti_tpu_torch.cli.quantize --checkpoint <ck> --output <prefix> \
      [--model_type ResUNet --base_filters 64 --depth 5] \
      [--calib_dir <images>] [--image_size 256 --batch_size 128]

Takes every checkpoint form the infer CLI does (``.pth``, ``.npz``, a
full-state directory). Activation scales come from the checkpoint's QAT
ranges (``qstats/``, a ``--qat`` run's; ``--no_qstats`` ignores them) or
from calibration on ``--calib_dir``'s images (synthetic DDTI-like frames
without it). Writes ``<prefix>_serving_program.pt2`` + ``.npz``
(``<prefix>_b<N>_...`` for a comma list of batch sizes, quantized once),
every quantized conv a call of the hand-written int8 kernel
(``ops/conv_s8.py``). ``--min_channels auto`` exports the 0 and 128
variants at the largest batch, times one batch of each (CUDA events on
the card), and keeps the faster.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ddti_tpu_torch.cli.export import model_kwargs


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="int8-quantize a checkpoint into a serving bundle "
                    "(PyTorch/CUDA)")
    ap.add_argument("--checkpoint", required=True,
                    help=".pth, .npz or a full-state directory")
    ap.add_argument("--output", required=True,
                    help="output prefix; writes <prefix>_serving_program"
                         ".pt2 and .npz")
    ap.add_argument("--model_type", default="ResUNet")
    ap.add_argument("--base_filters", type=int, default=64)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--batch_size", default="128",
                    help="the program's (fixed) serving batch; a comma "
                         "list (e.g. 4,32) exports one bundle per batch, "
                         "served together by cli/serve --checkpoint b4,b32")
    ap.add_argument("--calib_dir", default=None,
                    help="directory of calibration images (up to "
                         "--calib_count used); synthetic frames if omitted")
    ap.add_argument("--calib_count", type=int, default=32)
    ap.add_argument("--min_channels", default="0",
                    help="mixed precision: quantize only convs with "
                         "max(cin, cout) >= this; 'auto' exports the 0 and "
                         "128 variants, times both on the device and keeps "
                         "the faster")
    ap.add_argument("--input_dtype", choices=["f32", "uint8"],
                    default="f32",
                    help="program input: f32 [0,1] or raw uint8 bytes")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute (autocast; matches bf16-trained "
                         "runs)")
    ap.add_argument("--model_kwargs", default=None,
                    help="JSON dict of extra create_model kwargs")
    ap.add_argument("--tta", action="store_true",
                    help="bake the 4-way flip TTA ensemble into the program")
    ap.add_argument("--threshold", type=float, default=0.5,
                    help="binarization threshold baked into the program")
    ap.add_argument("--no_qstats", action="store_true",
                    help="ignore the checkpoint's QAT activation ranges "
                         "and calibrate on images instead")
    ap.add_argument("--device", default="cuda",
                    help="cuda[:N] (default; raises if CUDA is absent) or "
                         "cpu: where calibration and the program run")
    ap.add_argument("--cpu", dest="device", action="store_const",
                    const="cpu", help="the same as --device cpu")
    return ap


def calibration_images(args, size: int):
    """(N, size, size, 1) float32 [0, 1] numpy: --calib_dir's first
    --calib_count images resized bilinearly, or synthetic frames (seed
    0). None when the directory holds no image."""
    import numpy as np

    if args.calib_dir:
        from PIL import Image

        names = sorted(n for n in os.listdir(args.calib_dir)
                       if n.lower().endswith((".jpg", ".jpeg", ".png",
                                              ".bmp")))[:args.calib_count]
        if not names:
            return None
        return np.stack([
            np.asarray(Image.open(os.path.join(args.calib_dir, n))
                       .convert("L").resize((size, size), Image.BILINEAR),
                       np.float32)[..., None] / 255.0 for n in names])
    from ddti_tpu_torch.data.synthetic import generate_ddti_like

    imgs, _ = generate_ddti_like(args.calib_count, (size, size), 0)
    return np.asarray(imgs, np.float32) / 255.0


def time_batch_ms(fn, batch: int, size: int, in_dtype, device,
                  reps: int = 6) -> float:
    """Milliseconds of one batch of ``fn`` on zeros: CUDA events around
    ``reps`` batches after a warm one on the card, the host clock on the
    CPU."""
    import torch

    x = torch.zeros((batch, size, size, 1), dtype=in_dtype, device=device)
    fn(x)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        for _ in range(reps):
            fn(x)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(x)
    return (time.perf_counter() - t0) * 1e3 / reps


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)

    import torch

    from ddti_tpu_torch.core.device import resolve_device
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.checkpoint import (
        load_checkpoint_into,
        load_qstats,
    )
    from ddti_tpu_torch.train.export import (
        PROGRAM_SUFFIX,
        load_serving_bundle,
        save_bundle,
        weights_path_for,
    )
    from ddti_tpu_torch.train.quantize import (
        export_quantized_program,
        quant_tables,
        quantize_serving,
    )

    device = resolve_device(args.device)
    size = args.image_size
    model = create_model(args.model_type, **model_kwargs(args))
    load_checkpoint_into(args.checkpoint, args.model_type, model)
    model = model.to(device).eval()

    # a --qat run's ranges, learned over the whole run, beat one batch
    qat_amax = None
    if not args.no_qstats:
        qs = load_qstats(args.checkpoint)
        if qs:
            # an all-zero tree (a run that never stepped) calibrates
            qat_amax = {p: v for p, v in qs.items() if v > 0} or None
            if qat_amax:
                print(f"using {len(qat_amax)} QAT-learned activation "
                      f"ranges from the checkpoint (disable with "
                      f"--no_qstats)")
    calib = None
    if not qat_amax:
        imgs = calibration_images(args, size)
        if imgs is None:
            print(f"no images in {args.calib_dir}")
            return 1
        calib = torch.from_numpy(imgs).to(device)
        print(f"calibrating on {len(imgs)} images "
              f"({'real' if args.calib_dir else 'synthetic'})")

    in_dtype = torch.uint8 if args.input_dtype == "uint8" else torch.float32
    prog = args.output + PROGRAM_SUFFIX
    os.makedirs(os.path.dirname(os.path.abspath(prog)), exist_ok=True)
    batches = sorted({int(b) for b in str(args.batch_size).split(",") if b})
    kw = dict(threshold=args.threshold, input_dtype=in_dtype, tta=args.tta,
              bf16=args.bf16, model_type=args.model_type)

    def quantize(mc):
        return quantize_serving(model, calib, amax=qat_amax,
                                min_channels=mc, model_type=args.model_type,
                                bf16=args.bf16)

    exported = {}
    if args.min_channels == "auto":
        best = None
        for mc in (0, 128):
            svars = quantize(mc)
            program = export_quantized_program(model, svars, batches[-1],
                                               size, **kw)
            cand = args.output + f"_mc{mc}" + PROGRAM_SUFFIX
            save_bundle(cand, program, svars)
            fn, bn, sz, dt = load_serving_bundle(cand, device=device)
            ms = time_batch_ms(fn, bn, sz, dt, device)
            print(f"min_channels={mc}: {ms:.1f} ms/batch "
                  f"({bn / ms * 1e3:.1f} img/s)")
            if best is None or ms < best[1]:
                best = (mc, ms, program, svars)
            del fn
        mc, _, program, svars = best
        print(f"auto: keeping min_channels={mc}")
        for loser in (0, 128):
            cand = args.output + f"_mc{loser}" + PROGRAM_SUFFIX
            for f in (cand, weights_path_for(cand)):
                os.remove(f)
        exported = {batches[-1]: (program, svars)}
    else:
        mc = int(args.min_channels)

    written = []
    shared = None
    for bn in batches:
        if bn in exported:
            program, svars = exported[bn]
        else:
            if shared is None:  # quantize once; every batch shares it
                shared = exported[batches[-1]][1] if exported else (
                    quantize(mc))
            svars = shared
            program = export_quantized_program(model, svars, bn, size, **kw)
        out = (prog if len(batches) == 1
               else args.output + f"_b{bn}" + PROGRAM_SUFFIX)
        save_bundle(out, program, svars)
        n_q = len(quant_tables(svars))
        print(f"wrote {out} (+ .npz, {n_q} int8 conv kernels, batch={bn} "
              f"size={size} input={args.input_dtype})")
        written.append(out)
    if len(written) > 1:
        print("serve the set: python -m ddti_tpu_torch.cli.serve "
              "--checkpoint " + ",".join(written))
    return 0


if __name__ == "__main__":
    sys.exit(main())
