"""Diagnostic: a sharded serving bundle against one card's bundle.

Not a path of the port. After a run on a mesh with data > 1 the Trainer
writes both ``<Model>_serving_program.pt2`` (one device, the global batch)
and ``<Model>_serving_sharded.pt2`` (the program traced at the per-device
batch, one moved copy a card). This script asks where their masks part.
The flagship ResUNet (base 64, depth 5) on seeded weights serves FRAMES
synthetic frames at 512², in float32 and under bf16 autocast, through
three bundles: one card's at the global batch, one card's at the
per-device batch, and the sharded one over ``--cards`` cards. It counts
the pixels and frames where each pair's masks differ (and the largest
|logit| at such a pixel), and compares the model's own logits batch by
batch: at the global against the per-device batch on the first card, and
at the per-device batch on the first card against each other card. On N
cards (float32 with TF32 off, as every entry point of the port runs):

    python -m ddti_tpu_torch.probes.sharded_bundles --cards 4

and, to rehearse the script on the CPU at a toy size (the CPU stands for
every card):

    python -m ddti_tpu_torch.probes.sharded_bundles --device cpu \\
        --cards 2 --size 32 --base_filters 4 --depth 3 --frames 8 --batch 4
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

SEED = 0


def seeded_state(model, seed):
    """Seeded weights that give the random net masks neither empty nor
    full: He-scaled conv and linear weights, BatchNorm affines near
    identity, its statistics near (0, 1)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in model.state_dict().items():
        def normal(std):
            return torch.randn(t.shape, generator=g) * std
        if name.endswith("running_var"):
            sd[name] = torch.rand(t.shape, generator=g) + 0.5
        elif not t.is_floating_point():
            sd[name] = t
        elif t.dim() == 1:
            sd[name] = normal(0.1) + (1.0 if name.endswith("weight") else 0.)
        else:
            fan_in = t.shape[0] if name.startswith("upconvs") else t[0].numel()
            sd[name] = normal((2.0 / fan_in) ** 0.5)
    return sd


def compare_masks(a, b, logits):
    """(pixels that differ, frames with any, largest |logit| there)."""
    diff = a != b
    return dict(pixels=int(diff.sum()),
                frames=int(diff.flatten(1).any(1).sum()),
                max_abs_logit=(float(logits[diff].abs().max())
                               if diff.any() else 0.0))


def logits_by_batch(model, x, batch, bf16):
    """The model's NHWC float32 logits of ``x``, ``batch`` frames a call."""
    import torch

    from ddti_tpu_torch.train.export import nhwc_logits

    with torch.inference_mode():
        return torch.cat([nhwc_logits(model, x[i:i + batch], bf16)
                          for i in range(0, len(x), batch)])


def run(args):
    import copy

    import torch

    from ddti_tpu_torch.core.device import resolve_device
    from ddti_tpu_torch.data.synthetic import generate_ddti_like
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.export import (
        export_serving_program,
        load_serving_bundle,
        per_device_batch,
        save_bundle,
    )

    device = resolve_device(args.device)
    if device.type == "cuda":
        cards = [torch.device("cuda", i) for i in range(args.cards)]
        assert torch.cuda.device_count() >= args.cards, \
            f"needs {args.cards} cards, have {torch.cuda.device_count()}"
    else:
        cards = [device] * args.cards
    model = create_model("ResUNet", base_filters=args.base_filters,
                         depth=args.depth)
    model.load_state_dict(seeded_state(model, SEED))
    model = model.to(device).eval()
    images, _ = generate_ddti_like(args.frames, (args.size, args.size), SEED)
    frames = torch.from_numpy(images).to(device)
    x = frames.to(torch.float32) / 255.0
    per = per_device_batch(args.batch, args.cards)
    out = dict(cards=args.cards, batch=args.batch, per_device=per,
               frames=args.frames, size=args.size)
    if device.type == "cuda":
        out["card_names"] = [torch.cuda.get_device_name(c) for c in cards]
    with tempfile.TemporaryDirectory() as tmp:
        for label, bf16 in (("float32", False), ("bf16", True)):
            # the model's logits batch by batch
            whole = logits_by_batch(model, x, args.batch, bf16)
            pieces = logits_by_batch(model, x, per, bf16)
            res = dict(logits_global_vs_per_device=dict(
                max_abs=float((whole - pieces).abs().max()),
                max_abs_logit=float(whole.abs().max()),
                bit_equal=bool(torch.equal(whole, pieces))))
            across = []
            for c in cards[1:]:
                other = logits_by_batch(copy.deepcopy(model).to(c),
                                        x.to(c), per, bf16).to(device)
                across.append(float((other - pieces).abs().max()))
            res["logits_per_device_across_cards_max_abs"] = across
            # the three bundles
            masks = {}
            for name, b, nr in (("one_card_global", args.batch, 1),
                                ("one_card_per_device", per, 1),
                                ("sharded", per, args.cards)):
                path = os.path.join(tmp, f"{label}_{name}.pt2")
                program, variables = export_serving_program(
                    model, b, args.size, bf16=bf16, model_type="ResUNet")
                save_bundle(path, program, variables, nr_devices=nr)
                fn, gb, _, _ = load_serving_bundle(
                    path, device=str(device),
                    devices=cards if nr > 1 else None)
                masks[name] = torch.cat([fn(frames[i:i + gb])
                                         for i in range(0, len(frames), gb)])
            res["foreground"] = float(
                masks["one_card_global"].float().mean())
            for a, b in (("one_card_global", "sharded"),
                         ("one_card_per_device", "sharded"),
                         ("one_card_global", "one_card_per_device")):
                res[f"{a}_vs_{b}"] = compare_masks(
                    masks[a], masks[b], whole)
            out[label] = res
            print(f"[sharded] {label}: " + json.dumps(res), flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--base_filters", type=int, default=64)
    ap.add_argument("--depth", type=int, default=5)
    args = ap.parse_args(argv)
    print(json.dumps({"sharded_bundles": run(args)}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
