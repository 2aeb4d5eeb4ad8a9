"""Offline serving-bundle export, ported from ``ddti_tpu/cli/export.py``:
any checkpoint, or a comma list of same-architecture checkpoints as one
ensemble, into a deployable ``torch.export`` bundle, no training pipeline
involved.

  python -m ddti_tpu_torch.cli.export --checkpoint <ck>[,<ck2>,...] \
      --output <prefix> [--model_type ResUNet --base_filters 64 --depth 5] \
      [--image_size 256 --batch_size 128] [--bf16] [--tta] [--fold_bn]

Writes ``<prefix>_serving_program.pt2`` + ``.npz`` (``<prefix>_b<N>_...``
for each entry of a comma list of batch sizes), servable by
``cli/infer.py``, ``cli/serve.py`` and ``train.export.load_serving_bundle``.
Checkpoints: ``.pth``, ``.npz`` (either package's) or a full-state
directory of the port. An ensemble's members run in one program:
probability mean, then the baked threshold. For int8 use
``cli/quantize.py`` (one member). The program is traced on ``--device``
(the card by default) and runs there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def model_kwargs(args) -> dict:
    kwargs = dict(in_channels=1, out_channels=1,
                  base_filters=args.base_filters, depth=args.depth)
    if args.model_type == "TransUNet":
        kwargs["image_size"] = args.image_size
    if args.model_kwargs:
        kwargs.update(json.loads(args.model_kwargs))
    return kwargs


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="export a serving bundle (PyTorch/CUDA)")
    ap.add_argument("--checkpoint", required=True,
                    help=".pth, .npz or a full-state directory; a comma "
                         "list of same-architecture checkpoints exports a "
                         "probability-mean ensemble bundle")
    ap.add_argument("--output", required=True,
                    help="output prefix; writes <prefix>_serving_program"
                         ".pt2 and .npz")
    ap.add_argument("--model_type", default="ResUNet")
    ap.add_argument("--base_filters", type=int, default=64)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--batch_size", default="128",
                    help="the program's (fixed) serving batch; a comma "
                         "list (e.g. 4,32) exports one bundle per batch "
                         "for multi-program serving (cli/serve)")
    ap.add_argument("--input_dtype", choices=["f32", "uint8"],
                    default="uint8",
                    help="program input: raw uint8 bytes (deployment "
                         "default) or f32 [0,1]")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 compute (autocast; matches bf16-trained "
                         "runs)")
    ap.add_argument("--weights_dtype", choices=["keep", "bf16"],
                    default="keep",
                    help="bf16 halves the .npz bundle")
    ap.add_argument("--fold_bn", action="store_true",
                    help="fold BatchNorm into the conv weights first")
    ap.add_argument("--tta", action="store_true",
                    help="bake the 4-way flip TTA ensemble per member")
    ap.add_argument("--threshold", type=float, default=0.5,
                    help="binarization threshold baked into the program")
    ap.add_argument("--model_kwargs", default=None,
                    help="JSON dict of extra create_model kwargs")
    ap.add_argument("--device", default="cuda",
                    help="cuda[:N] (default; raises if CUDA is absent) or "
                         "cpu: where the program is traced and runs")
    ap.add_argument("--cpu", dest="device", action="store_const",
                    const="cpu", help="the same as --device cpu")
    return ap


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)

    import torch

    from ddti_tpu_torch.core.device import resolve_device
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
    from ddti_tpu_torch.train.export import (
        PROGRAM_SUFFIX,
        export_serving_ensemble,
        export_serving_program,
        save_bundle,
    )

    device = resolve_device(args.device)
    model = create_model(args.model_type, **model_kwargs(args))
    members = []
    for ck in (p for p in args.checkpoint.split(",") if p):
        load_checkpoint_into(ck, args.model_type, model)
        members.append({k: v.detach().clone()
                        for k, v in model.state_dict().items()})
    model = model.to(device).eval()
    members = [{k: v.to(device) for k, v in m.items()} for m in members]
    model.load_state_dict(members[0])

    in_dtype = torch.uint8 if args.input_dtype == "uint8" else torch.float32
    wdtype = torch.bfloat16 if args.weights_dtype == "bf16" else None
    kw = dict(threshold=args.threshold, fold_bn=args.fold_bn,
              input_dtype=in_dtype, weights_dtype=wdtype, tta=args.tta,
              bf16=args.bf16, model_type=args.model_type)
    batches = [int(b) for b in str(args.batch_size).split(",") if b]
    os.makedirs(os.path.dirname(os.path.abspath(args.output)),
                exist_ok=True)
    for batch in batches:
        suffix = f"_b{batch}" if len(batches) > 1 else ""
        if len(members) > 1:
            program, svars = export_serving_ensemble(
                model, members, batch, args.image_size, **kw)
            note = f"{len(members)}-member ensemble"
        else:
            program, svars = export_serving_program(
                model, batch, args.image_size, **kw)
            note = "single model"
        prog = args.output + suffix + PROGRAM_SUFFIX
        save_bundle(prog, program, svars)
        print(f"wrote {prog} (+ .npz, {note}, batch={batch} "
              f"size={args.image_size} input={args.input_dtype}"
              + (", tta" if args.tta else "")
              + (", fold_bn" if args.fold_bn else "") + ")")
    return 0


if __name__ == "__main__":
    sys.exit(main())
