"""Checkpoint averaging (SWA-style), ported from ``ddti_tpu/cli/average.py``:
merge K trained checkpoints of one architecture into one weight bundle.

    python -m ddti_tpu_torch.cli.average --checkpoints <run>/models/periodic \\
        --output avg.npz --model_type ResUNet --base_filters 64 --depth 5 \\
        [--weights 1,1,2] [--recalib_count 64 [--recalib_dir <images>]]

Takes every checkpoint form the port's infer CLI does (``.pth``,
``.npz``, a full-state directory, whose EMA shadow it prefers, as JAX
does) and a managed rotation root (a directory of numeric step
directories, as ``--save_interval`` writes): that expands to its kept
steps, oldest first.

Parameters and BatchNorm statistics average arithmetically (weighted
where ``--weights`` says), in float64 on the host; ``--recalib_count N``
then re-estimates the running statistics by streaming N images through
the merged model in train mode (no gradients), ``--recalib_passes``
times, at the port's BatchNorm momentum (the JAX package's 0.9 retention).
The output is a ``.npz`` in ``save_params_npz`` layout that the train
CLI (``--checkpoint_path``), the infer CLI and the daemon load, and the
JAX package too. ``--device`` (default ``cuda``) runs the recalibration;
``cpu`` for small runs. The members' QAT ranges (``qstats/``) merge by
their maximum into the output, as in JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def _expand_managed(path: str) -> list:
    """A managed rotation root (directory of numeric step dirs) expands
    to its step checkpoints, oldest first; anything else passes through."""
    if os.path.isdir(path):
        steps = sorted(int(d) for d in os.listdir(path) if d.isdigit())
        if steps:
            return [os.path.join(path, str(s)) for s in steps]
    return [path]


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--checkpoints", required=True, nargs="+",
                    help="two or more checkpoints (full-state dir / .npz / "
                         ".pth), or one managed rotation root to average "
                         "its kept steps")
    ap.add_argument("--output", required=True,
                    help="output .npz weight bundle")
    ap.add_argument("--weights", default=None,
                    help="comma-separated per-checkpoint weights "
                         "(default: uniform); normalized to sum 1")
    ap.add_argument("--model_type", default="ResUNet")
    ap.add_argument("--base_filters", type=int, default=64)
    ap.add_argument("--depth", type=int, default=5)
    ap.add_argument("--image_size", type=int, default=256)
    ap.add_argument("--model_kwargs", default=None,
                    help="JSON dict of extra create_model kwargs")
    ap.add_argument("--recalib_count", type=int, default=0,
                    help="re-estimate BN running stats on N images "
                         "through the averaged model (SWA BN pass); "
                         "0 keeps the averaged stats")
    ap.add_argument("--recalib_dir", default=None,
                    help="directory of recalibration images "
                         "(synthetic DDTI-like frames if omitted)")
    ap.add_argument("--recalib_batch", type=int, default=32)
    ap.add_argument("--recalib_passes", type=int, default=25,
                    help="passes over the recalibration images: BN "
                         "running stats are a momentum-0.9 EMA, so "
                         "~50 update steps are needed to forget the "
                         "averaged stats (0.9^50 < 1%%)")
    ap.add_argument("--device", default="cuda",
                    help="cuda[:N] (default; raises if CUDA is absent) or "
                         "cpu")
    return ap


def _recalib_images(args, size: int):
    """(N, 1, size, size) float32 [0, 1]: the first ``--recalib_count``
    images of ``--recalib_dir`` resized bilinearly, or synthetic frames
    (seed 0, as in JAX). None when the directory has no image."""
    import numpy as np

    if args.recalib_dir:
        from PIL import Image

        names = sorted(
            n for n in os.listdir(args.recalib_dir)
            if n.lower().endswith((".jpg", ".jpeg", ".png", ".bmp"))
        )[:args.recalib_count]
        if not names:
            return None
        imgs = np.stack([
            np.asarray(Image.open(os.path.join(args.recalib_dir, n))
                       .convert("L")
                       .resize((size, size), Image.BILINEAR),
                       np.float32) / 255.0 for n in names])
    else:
        from ddti_tpu_torch.data.synthetic import generate_ddti_like

        raw, _ = generate_ddti_like(args.recalib_count, (size, size), 0)
        imgs = np.asarray(raw, np.float32)[..., 0] / 255.0
    return imgs[:, None]


def _recalibrate(model, imgs, args, device) -> None:
    """The SWA BatchNorm pass: the merged model in train mode over the
    images in chunks of ``--recalib_batch`` (a short last chunk padded
    with its last image, as in JAX), ``--recalib_passes`` times."""
    import numpy as np
    import torch

    b = max(args.recalib_batch, 1)
    model.train()
    with torch.no_grad():
        for _ in range(max(args.recalib_passes, 1)):
            for i in range(0, len(imgs), b):
                chunk = imgs[i:i + b]
                if len(chunk) < b:
                    chunk = np.concatenate(
                        [chunk, chunk[-1:].repeat(b - len(chunk), 0)])
                model(torch.from_numpy(chunk).to(device))
    model.eval()


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)

    import numpy as np
    import torch

    from ddti_tpu_torch.core.device import resolve_device
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.checkpoint import (
        load_checkpoint_into,
        load_qstats,
        save_params_npz,
    )

    device = resolve_device(args.device)
    paths = [p for c in args.checkpoints for p in _expand_managed(c)]
    if len(paths) < 2:
        print("need at least two checkpoints to average "
              f"(got {paths})")
        return 1
    if args.weights:
        w = np.asarray([float(x) for x in args.weights.split(",")],
                       np.float64)
        if len(w) != len(paths):
            print(f"--weights has {len(w)} entries for {len(paths)} "
                  f"checkpoints ({paths})")
            return 1
    else:
        w = np.ones(len(paths), np.float64)
    w = w / w.sum()

    size = args.image_size
    kwargs = dict(in_channels=1, out_channels=1,
                  base_filters=args.base_filters, depth=args.depth)
    if args.model_type == "TransUNet":
        kwargs["image_size"] = size
    if args.model_kwargs:
        kwargs.update(json.loads(args.model_kwargs))
    model = create_model(args.model_type, **kwargs)

    # a running weighted sum in float64 on the host: K checkpoints never
    # coexist
    acc = {k: np.zeros(v.shape, np.float64)
           for k, v in model.state_dict().items()}
    # QAT activation ranges (train --qat) merge by their MAX over the
    # members: a range covering every member's activations keeps an int8
    # export of the averaged weights saturation-free
    qstats: dict = {}
    for path, wi in zip(paths, w):
        load_checkpoint_into(path, args.model_type, model)
        for k, v in model.state_dict().items():
            acc[k] += wi * v.numpy().astype(np.float64)
        try:
            qs = load_qstats(path) or {}
        except Exception:
            qs = {}
        for k, v in qs.items():
            qstats[k] = max(qstats.get(k, 0.0), float(v))
        print(f"averaged {path} (weight {wi:.3f})")
    sd = model.state_dict()
    model.load_state_dict({k: torch.from_numpy(acc[k]).to(sd[k].dtype)
                           for k in sd})

    if args.recalib_count > 0 and any(True for _ in model.buffers()):
        imgs = _recalib_images(args, size)
        if imgs is None:
            print(f"no images in {args.recalib_dir}")
            return 1
        model.to(device)
        _recalibrate(model, imgs, args, device)
        model.cpu()
        print(f"recalibrated BN stats on {len(imgs)} images x "
              f"{max(args.recalib_passes, 1)} passes "
              f"({'real' if args.recalib_dir else 'synthetic'})")

    os.makedirs(os.path.dirname(os.path.abspath(args.output)),
                exist_ok=True)
    save_params_npz(args.output, args.model_type, model.state_dict(),
                    qstats=qstats or None)
    print(f"wrote averaged weights ({len(paths)} checkpoints"
          + (f", {len(qstats)} QAT ranges max-merged" if qstats else "")
          + f") -> {args.output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
