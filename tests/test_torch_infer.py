"""The infer CLI of the port (``python -m ddti_tpu_torch.cli.infer``)
against the JAX package's (``python -m ddti_tpu.cli.infer --cpu``), on the
CPU, on the same weights (one AttentionUNet at base filters 8, depth 3,
32², exported by JAX as ``.npz`` and ``.pth``; a second, perturbed one for
the ensemble) and one folder of JPEG and PNG frames of five sizes.

Each mode (resized, ``--tta``, ``--sliding_window``, a two-checkpoint
ensemble, ``--prob``, ``--fold_bn``) runs through both CLIs: binary masks
agree on >= 99.9% of pixels, ``--prob`` maps within 1 gray level. The
contours (``eval/contours.py``), the folder scorer (``eval/folder_eval.py``)
and the overlays are held exactly to JAX's on the JAX CLI's own output.
"""

import argparse
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from ddti_tpu.cli import infer as jinfer
from ddti_tpu.eval import contours as jcontours
from ddti_tpu.eval import folder_eval as jfolder
from ddti_tpu.train.checkpoint import save_params_npz
from ddti_tpu.train.torch_interop import save_pth
from ddti_tpu_torch.cli import infer
from ddti_tpu_torch.eval import contours, folder_eval

from test_torch_zoo import jax_model, port_model

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = ["--model_type", "AttentionUNet", "--base_filters", "8", "--depth",
         "3", "--image_size", "32", "--batch_size", "2"]
SLIDING = ["--sliding_window", "--window", "32", "--stride", "16"]
# (height, width) of the frames; three JPEGs, two PNGs
SHAPES = [(40, 50), (64, 64), (100, 70), (33, 47), (80, 96)]
MASK_AGREE = 0.999
PROB_LEVELS = 1


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Checkpoints, frames, ground-truth masks, and a threshold at the
    median probability of the resized frames (these random-weight models
    put nearly every logit a little above 0)."""
    d = tmp_path_factory.mktemp("infer")
    _, params, stats = jax_model("AttentionUNet")
    rng = np.random.default_rng(7)
    params_b = jax.tree.map(lambda a: (np.asarray(a) + rng.normal(
        0, 0.05, np.shape(a))).astype(np.float32), params)
    paths = {"npz": str(d / "a.npz"), "pth": str(d / "a.pth"),
             "b": str(d / "b.pth")}
    save_params_npz(paths["npz"], params, stats)
    save_pth(paths["pth"], "AttentionUNet", params, stats)
    save_pth(paths["b"], "AttentionUNet", params_b, stats)
    imgs, masks = d / "imgs", d / "masks"
    imgs.mkdir()
    masks.mkdir()
    for i, (h, w) in enumerate(SHAPES):
        yy, xx = np.mgrid[0:h, 0:w]
        blob = ((yy - h / 2) ** 2 / (h / 3) ** 2
                + (xx - w / 2) ** 2 / (w / 3) ** 2) < 1
        frame = np.clip(60 + 90 * blob + rng.normal(0, 30, (h, w)), 0, 255)
        ext = "jpg" if i < 3 else "png"
        Image.fromarray(frame.astype(np.uint8)).save(imgs / f"f{i}.{ext}")
        Image.fromarray(blob.astype(np.uint8) * 255).save(
            masks / f"f{i}_mask.png")
    m = port_model("AttentionUNet").eval()
    x = np.stack([np.asarray(Image.open(imgs / n).convert("L").resize(
        (32, 32), Image.BILINEAR), np.float32) / 255.0
        for n in sorted(os.listdir(imgs))])[:, None]
    with torch.no_grad():
        probs = torch.sigmoid(m(torch.from_numpy(x))).numpy()
    return dict(dir=d, paths=paths, imgs=str(imgs), masks=str(masks),
                threshold=f"{float(np.median(probs)):.6f}")


def _run_both(data, name, flags, ckpt=None, port_subprocess=False):
    """Both CLIs on the frames; returns their output directories."""
    ckpt = ckpt or data["paths"]["npz"]
    common = ["--checkpoint", ckpt, "--input_dir", data["imgs"], *MODEL,
              "--threshold", data["threshold"], *flags]
    out = {k: str(data["dir"] / f"{name}_{k}") for k in ("jax", "port")}
    assert jinfer.main(common + ["--output_dir", out["jax"], "--cpu",
                                 "--compilation_cache", "off"]) == 0
    port = common + ["--output_dir", out["port"], "--device", "cpu"]
    if port_subprocess:
        res = subprocess.run(
            [sys.executable, "-m", "ddti_tpu_torch.cli.infer", *port],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert res.returncode == 0, res.stderr[-3000:]
        assert "predicted 5 images in" in res.stdout
        assert "[KERNELS] flash_fwd=0" in res.stdout
    else:
        assert infer.main(port) == 0
    return out


def _preds(out_dir):
    return {f: np.asarray(Image.open(os.path.join(out_dir, f)))
            for f in sorted(os.listdir(out_dir)) if f.endswith("_pred.png")}


@pytest.mark.parametrize("mode, flags", [
    ("resized", []), ("tta", ["--tta"]), ("sliding", SLIDING),
    ("sliding_tta", SLIDING + ["--tta"]), ("ensemble", []),
    ("fold_bn", ["--fold_bn"])])
def test_binary_masks_match_jax_cli(data, mode, flags):
    ckpt = (f"{data['paths']['npz']},{data['paths']['b']}"
            if mode == "ensemble" else None)
    out = _run_both(data, mode, flags, ckpt,
                    port_subprocess=mode == "resized")
    want, got = _preds(out["jax"]), _preds(out["port"])
    assert sorted(got) == [f"f{i}_pred.png" for i in range(5)] == sorted(want)
    agree = np.mean(np.concatenate([(got[f] == want[f]).ravel()
                                    for f in want]))
    assert agree >= MASK_AGREE, agree
    for i, f in enumerate(sorted(want)):
        assert got[f].shape == SHAPES[i] and got[f].dtype == np.uint8
        assert set(np.unique(got[f])) <= {0, 255}
    fg = np.mean(np.concatenate([g.ravel() for g in got.values()]) > 0)
    assert 0.01 < fg < 0.99, fg  # neither mask empty nor full


def test_prob_maps_match_jax_cli(data):
    out = _run_both(data, "prob", ["--prob"])
    want, got = _preds(out["jax"]), _preds(out["port"])
    for f in want:
        diff = np.abs(got[f].astype(int) - want[f].astype(int))
        assert diff.max() <= PROB_LEVELS, f
    assert len(np.unique(np.concatenate([g.ravel() for g in got.values()]))
               ) > 2


def test_overlay_and_mask_dir_match_jax(data, tmp_path):
    """``--overlay --mask_dir`` through both CLIs (``--fold_bn --prob``, the
    card's mode c); then, on the JAX CLI's own output folder, the port's
    ``find_contours``, ``evaluate_predictions``, ``write_eval_artifacts``
    and overlay are exactly JAX's."""
    flags = ["--fold_bn", "--prob", "--overlay", "--mask_dir", data["masks"]]
    out = _run_both(data, "overlay", flags)
    for d in out.values():
        files = set(os.listdir(d))
        assert {"eval_metrics.json", "per_image_metrics.csv"} <= files
        assert {f"f{i}_overlay.png" for i in range(5)} <= files

    jdir = out["jax"]
    for thr in (127.0, float(data["threshold"]) * 255):
        want = jfolder.evaluate_predictions(jdir, data["masks"],
                                            pred_thresh255=thr)
        got = folder_eval.evaluate_predictions(jdir, data["masks"],
                                               pred_thresh255=thr)
        assert json.dumps(got, sort_keys=True) == json.dumps(
            want, sort_keys=True)
        a, b = tmp_path / f"jax{thr}", tmp_path / f"port{thr}"
        a.mkdir()
        b.mkdir()
        assert folder_eval.write_eval_artifacts(str(b), *got) == \
            jfolder.write_eval_artifacts(str(a), *want)
        for f in ("eval_metrics.json", "per_image_metrics.csv"):
            assert (a / f).read_bytes() == (b / f).read_bytes(), f
    assert want[0]["images"] == 5 and "hd95_mean" in want[0]

    args = argparse.Namespace(input_dir=data["imgs"], overlay=True,
                              prob=True, threshold=float(data["threshold"]),
                              output_dir=str(tmp_path))
    n_contours = 0
    for f, mask in _preds(jdir).items():
        m = (mask.astype(np.float32) > args.threshold * 255).astype(
            np.float32)
        want_c = jcontours.find_contours(m, 0.5)
        got_c = contours.find_contours(m, 0.5)
        assert len(got_c) == len(want_c)
        for g, w in zip(got_c, want_c):
            np.testing.assert_array_equal(g, w)
        n_contours += len(got_c)
        stem = f[:-len("_pred.png")]
        name = next(n for n in os.listdir(data["imgs"])
                    if n.startswith(stem + "."))
        infer._maybe_overlay(args, name, mask)
        np.testing.assert_array_equal(
            np.asarray(Image.open(tmp_path / f"{stem}_overlay.png")),
            np.asarray(Image.open(os.path.join(jdir,
                                               f"{stem}_overlay.png"))))
    assert n_contours > 0


def test_default_device_needs_cuda(data, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA")
    args = ["--checkpoint", data["paths"]["pth"], "--input_dir",
            data["imgs"], "--output_dir", str(tmp_path), *MODEL]
    assert infer.get_parser().parse_args(args).device == "cuda"
    assert infer.get_parser().parse_args(args + ["--cpu"]).device == "cpu"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        infer.main(args)


def test_stablehlo_checkpoint_raises(data, tmp_path):
    args = ["--checkpoint", str(tmp_path / "serve.stablehlo"),
            "--input_dir", data["imgs"], "--output_dir", str(tmp_path),
            *MODEL, "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        infer.main(args)
