"""Dataset preparation, ported from ``ddti_tpu/cli/split_data.py``: split a
flat image/mask dump into the train/val/test tree.

  python -m ddti_tpu_torch.cli.split_data --source flat --output ddti \
      [--masks masks] [--ratios 0.7,0.15,0.15] [--seed 42] [--copy] \
      [--kfold 5 --fold 0]

The training CLI reads a pre-split tree (``train/<name>.jpg`` paired with
``train_mask/<name>_mask.jpg``, the same for val and test; the port's
``data/dataset.py``), but the DDTI distribution arrives flat. This CLI
pairs files by that filename convention, shuffles deterministically
(Python's ``random.Random(seed)``, the JAX tool's: the same seed and
inputs give the same split), and writes the tree, as symlinks by default
(``--copy`` for a self-contained tree).

``--kfold K --fold I`` replaces the ratio split with cross-validation
folds: test = fold I, val = fold (I+1) mod K, train = the rest — run it K
times (one output tree per fold) and aggregate with ``cli/aggregate``.

A ``split_manifest.json`` (seed, ratios/fold, per-split name lists) is
written into the output root so any split is reproducible and auditable.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import shutil

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def find_pairs(img_dir: str, mask_dir: str | None = None):
    """Pair ``<stem><ext>`` images with ``<stem>_mask<ext'>`` masks. Masks live in ``mask_dir``
    (defaults to ``img_dir`` for flat dumps). Returns (pairs, unpaired):
    pairs = sorted [(image_filename, mask_filename)], unpaired = images
    with no mask + masks with no image."""
    mask_dir = mask_dir or img_dir
    files = sorted(os.listdir(img_dir))
    mask_files = sorted(os.listdir(mask_dir))
    masks = {}  # stem -> mask filename
    for f in mask_files:
        stem, ext = os.path.splitext(f)
        if ext.lower() in _IMG_EXTS and stem.endswith("_mask"):
            masks[stem[:-len("_mask")]] = f
    pairs, unpaired = [], []
    used = set()
    for f in files:
        stem, ext = os.path.splitext(f)
        if ext.lower() not in _IMG_EXTS or stem.endswith("_mask"):
            continue
        if stem in masks:
            pairs.append((f, masks[stem]))
            used.add(stem)
        else:
            unpaired.append(f)
    unpaired += [m for s, m in masks.items() if s not in used]
    return pairs, unpaired


def _ratio_split(pairs: list, ratios, rng: random.Random) -> dict:
    shuffled = list(pairs)
    rng.shuffle(shuffled)
    n = len(shuffled)
    n_train = round(n * ratios[0])
    n_val = round(n * ratios[1])
    # every nonzero-ratio split gets at least one pair (cumulative
    # rounding can zero a small split)
    n_test = n - n_train - n_val
    if ratios[2] > 0 and n_test == 0 and n_train > 1:
        n_train -= 1
        n_test = 1
    if ratios[1] > 0 and n_val == 0 and n_train > 1:
        n_train -= 1
        n_val += 1
        n_test = n - n_train - n_val
    return {"train": shuffled[:n_train],
            "val": shuffled[n_train:n_train + n_val],
            "test": shuffled[n_train + n_val:]}


def _kfold_split(pairs: list, k: int, fold: int, rng: random.Random) -> dict:
    shuffled = list(pairs)
    rng.shuffle(shuffled)
    folds = [shuffled[i::k] for i in range(k)]
    test = folds[fold]
    val = folds[(fold + 1) % k]
    train = [p for i, f in enumerate(folds)
             for p in f if i not in (fold, (fold + 1) % k)]
    return {"train": train, "val": val, "test": test}


def materialize(splits: dict, img_dir: str, mask_dir: str,
                output: str, copy: bool = False) -> None:
    """Write the reference tree: ``<split>/<image>`` +
    ``<split>_mask/<mask>``, symlinked (default) or copied."""
    place = shutil.copy2 if copy else (
        lambda src, dst: os.symlink(os.path.abspath(src), dst))
    for split, items in splits.items():
        d_img = os.path.join(output, split)
        d_mask = os.path.join(output, f"{split}_mask")
        os.makedirs(d_img, exist_ok=True)
        os.makedirs(d_mask, exist_ok=True)
        for img, mask in items:
            place(os.path.join(img_dir, img), os.path.join(d_img, img))
            place(os.path.join(mask_dir, mask), os.path.join(d_mask, mask))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True,
                    help="directory of images (flat DDTI dump)")
    ap.add_argument("--masks", default=None,
                    help="directory of <name>_mask.* files "
                         "(default: same as --source)")
    ap.add_argument("--output", required=True,
                    help="output root; train/ train_mask/ val/ ... created "
                         "inside")
    ap.add_argument("--ratios", default="0.7,0.15,0.15",
                    help="train,val,test fractions (must sum to 1)")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--copy", action="store_true",
                    help="copy files instead of symlinking")
    ap.add_argument("--kfold", type=int, default=0,
                    help="K-fold cross-validation split instead of ratios")
    ap.add_argument("--fold", type=int, default=0,
                    help="with --kfold: which fold is the test split "
                         "(val = the next fold)")
    args = ap.parse_args(argv)

    mask_dir = args.masks or args.source
    pairs, unpaired = find_pairs(args.source, args.masks)
    if not pairs:
        print(f"no <name>.<ext> + <name>_mask.<ext> pairs found in "
              f"{args.source}" + (f" + {mask_dir}" if args.masks else ""))
        return 1
    if unpaired:
        print(f"warning: {len(unpaired)} unpaired file(s) skipped: "
              f"{', '.join(unpaired[:5])}"
              + (" ..." if len(unpaired) > 5 else ""))

    rng = random.Random(args.seed)
    if args.kfold:
        if not 2 <= args.kfold <= len(pairs):
            print(f"--kfold must be in [2, {len(pairs)}]")
            return 1
        if not 0 <= args.fold < args.kfold:
            print(f"--fold must be in [0, {args.kfold})")
            return 1
        splits = _kfold_split(pairs, args.kfold, args.fold, rng)
        plan = {"kfold": args.kfold, "fold": args.fold}
    else:
        ratios = tuple(float(x) for x in args.ratios.split(","))
        if len(ratios) != 3 or abs(sum(ratios) - 1.0) > 1e-6 or \
                any(r < 0 for r in ratios):
            print(f"--ratios must be three non-negative fractions summing "
                  f"to 1, got {args.ratios}")
            return 1
        splits = _ratio_split(pairs, ratios, rng)
        plan = {"ratios": list(ratios)}

    os.makedirs(args.output, exist_ok=True)
    materialize(splits, args.source, mask_dir, args.output, copy=args.copy)
    with open(os.path.join(args.output, "split_manifest.json"), "w") as f:
        json.dump({"seed": args.seed, **plan,
                   "source": os.path.abspath(args.source),
                   "masks": os.path.abspath(mask_dir),
                   "copied": bool(args.copy),
                   "splits": {s: [img for img, _ in items]
                              for s, items in splits.items()}},
                  f, indent=1)
    print(" / ".join(f"{s}: {len(items)}" for s, items in splits.items())
          + f" pairs -> {args.output} "
          + ("(copied)" if args.copy else "(symlinked)"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
