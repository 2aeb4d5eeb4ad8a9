"""Raw-DDTI ingestion, ported from ``ddti_tpu/cli/prepare.py``: rasterize
the distribution's XML polygon annotations into paired masks.

  python -m ddti_tpu_torch.cli.prepare --source raw_ddti --output flat \
      [--mask_format jpg|png] [--keep_empty] [--copy]

The public DDTI dump ships ``<case>_<n>.jpg`` ultrasound frames and one
``<case>.xml`` per case whose ``<mark>`` elements carry the nodule outline
as a JSON-encoded SVG polygon list, keyed by frame number. The training
CLI pairs ``<name>.jpg`` with a rasterized ``<name>_mask.jpg``. This CLI
parses each case's XML, fills the union of its polygons per frame with
Pillow (the JAX tool's drawing, so the masks are the same bytes), and
writes the flat ``<name>.jpg`` + ``<name>_mask.jpg`` dump that
``split_data`` turns into the train/val/test tree (see DDTI.md).

Masks default to JPEG, what the reference trains on (its soft-valued
targets come from JPEG masks and a bilinear resize); ``--mask_format png``
writes lossless masks.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import xml.etree.ElementTree as ET

_IMG_EXTS = (".jpg", ".jpeg", ".png", ".bmp")


def parse_case_marks(xml_path: str):
    """Parse one case XML into {frame_number: [polygon, ...]} where each
    polygon is a list of (x, y) float tuples.

    The dump's ``<svg>`` payload is a JSON string like
    ``[{"points": [{"x": 133, "y": 145}, ...]}, ...]`` (one dict per
    polygon; a case can have several nodules per frame). Empty/absent
    payloads mean the frame is annotated as nodule-free. Malformed marks
    are skipped, never fatal — real dumps contain a handful.
    """
    marks: dict[int, list] = {}
    try:
        root = ET.parse(xml_path).getroot()
    except ET.ParseError:
        return marks
    for mark in root.iter("mark"):
        num_el = mark.find("image")
        svg_el = mark.find("svg")
        if num_el is None or num_el.text is None:
            continue
        try:
            frame = int(str(num_el.text).strip())
        except ValueError:
            continue
        polys = marks.setdefault(frame, [])
        svg = (svg_el.text or "").strip() if svg_el is not None else ""
        if not svg:
            continue
        try:
            shapes = json.loads(svg)
        except (json.JSONDecodeError, ValueError):
            continue
        if isinstance(shapes, dict):
            shapes = [shapes]
        for shape in shapes:
            pts = shape.get("points") if isinstance(shape, dict) else None
            if not pts:
                continue
            try:
                poly = [(float(p["x"]), float(p["y"])) for p in pts]
            except (KeyError, TypeError, ValueError):
                continue
            if len(poly) >= 3:
                polys.append(poly)
    return marks


def rasterize_mask(size, polygons):
    """Fill the union of polygons into an 8-bit {0,255} PIL image of
    ``size`` = (width, height), the masks' value convention (thresholded
    at 0.5 of the [0, 1] float range)."""
    from PIL import Image, ImageDraw

    mask = Image.new("L", size, 0)
    draw = ImageDraw.Draw(mask)
    for poly in polygons:
        draw.polygon([(x, y) for x, y in poly], fill=255, outline=255)
    return mask


def find_case_images(source: str, case: str):
    """Frame images for a case: ``<case>_<n>.<ext>`` keyed by frame
    number; a bare ``<case>.<ext>`` (single-frame cases in some mirrors)
    maps to frame 1."""
    frames: dict[int, str] = {}
    for path in sorted(glob.glob(os.path.join(source, glob.escape(case) + "_*"))):
        stem, ext = os.path.splitext(os.path.basename(path))
        if ext.lower() not in _IMG_EXTS:
            continue
        suffix = stem[len(case) + 1:]
        if suffix.isdigit():
            frames[int(suffix)] = path
    if not frames:
        for ext in _IMG_EXTS:
            path = os.path.join(source, case + ext)
            if os.path.exists(path):
                frames[1] = path
                break
    return frames


def prepare(source: str, output: str, mask_format: str = "jpg",
            keep_empty: bool = False, copy: bool = False,
            quality: int = 95):
    """Convert a raw DDTI dump into a flat paired dump. Returns the
    manifest dict (also written to ``prepare_manifest.json``)."""
    from PIL import Image

    os.makedirs(output, exist_ok=True)
    xmls = sorted(glob.glob(os.path.join(source, "*.xml")))
    written, empties, missing = [], [], []
    for xml_path in xmls:
        case = os.path.splitext(os.path.basename(xml_path))[0]
        marks = parse_case_marks(xml_path)
        frames = find_case_images(source, case)
        for frame, polys in sorted(marks.items()):
            img_path = frames.get(frame)
            if img_path is None:
                missing.append(f"{case}_{frame}")
                continue
            if not polys and not keep_empty:
                empties.append(f"{case}_{frame}")
                continue
            with Image.open(img_path) as im:
                size = im.size
            name = f"{case}_{frame}"
            img_ext = os.path.splitext(img_path)[1].lower()
            dst_img = os.path.join(output, name + img_ext)
            # lexists: a dangling symlink (raw dump moved since the last
            # run) must be replaced, not tripped over by os.symlink or
            # silently written through by copy2
            if os.path.lexists(dst_img) and not os.path.exists(dst_img):
                os.unlink(dst_img)  # re-point at the current source
            if not os.path.exists(dst_img):
                if copy:
                    shutil.copy2(img_path, dst_img)
                else:
                    os.symlink(os.path.abspath(img_path), dst_img)
            mask = rasterize_mask(size, polys)
            mask_name = f"{name}_mask.{mask_format}"
            mask.save(os.path.join(output, mask_name),
                      **({"quality": quality} if mask_format in ("jpg", "jpeg")
                         else {}))
            written.append(name)
    manifest = {
        "source": os.path.abspath(source),
        "cases": len(xmls),
        "pairs": sorted(written),
        "skipped_empty": sorted(empties),
        "missing_images": sorted(missing),
        "mask_format": mask_format,
        "keep_empty": keep_empty,
    }
    with open(os.path.join(output, "prepare_manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--source", required=True,
                    help="raw DDTI directory: <case>.xml + <case>_<n>.jpg")
    ap.add_argument("--output", required=True,
                    help="flat paired dump to write (feed to python -m ddti_tpu_torch.cli.split_data)")
    ap.add_argument("--mask_format", default="jpg", choices=["jpg", "png"],
                    help="jpg = reference-parity soft masks (default); "
                         "png = lossless binary masks")
    ap.add_argument("--keep_empty", action="store_true",
                    help="emit all-zero masks for annotated-empty frames "
                         "instead of skipping them")
    ap.add_argument("--copy", action="store_true",
                    help="copy images instead of symlinking")
    ap.add_argument("--quality", type=int, default=95,
                    help="JPEG quality for --mask_format jpg")
    args = ap.parse_args(argv)

    if not os.path.isdir(args.source):
        print(f"--source {args.source} is not a directory")
        return 1
    manifest = prepare(args.source, args.output, args.mask_format,
                       args.keep_empty, args.copy, args.quality)
    if not manifest["pairs"]:
        if manifest["skipped_empty"]:
            # every annotated frame had an empty <svg> payload — point the
            # operator at the real knob instead of a bogus "no XML" story
            print(f"all {len(manifest['skipped_empty'])} annotated "
                  f"frame(s) in {args.source} carry empty mark payloads "
                  f"(nodule-free); rerun with --keep_empty to emit them "
                  f"with all-background masks")
        else:
            print(f"no <case>.xml with matching frame images found in "
                  f"{args.source}")
        return 1
    if manifest["missing_images"]:
        lost = manifest["missing_images"]
        print(f"warning: {len(lost)} mark(s) had no matching frame image: "
              f"{', '.join(lost[:5])}" + (" ..." if len(lost) > 5 else ""))
    print(f"{len(manifest['pairs'])} image/mask pairs -> {args.output} "
          f"({len(manifest['skipped_empty'])} empty frames "
          + ("kept" if args.keep_empty else "skipped")
          + f", masks .{args.mask_format}); next: python -m "
          f"ddti_tpu_torch.cli.split_data --source {args.output} "
          f"--output <tree>")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
