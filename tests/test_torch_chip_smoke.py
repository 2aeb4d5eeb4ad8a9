"""The work counts and bounds that chip_smoke.py prints beside each kernel's
time, held to counts made by hand from the shapes. CPU only: chip_smoke
imports nothing but the standard library at module level."""

import pytest

import chip_smoke as C

SLICE = (16, 8, 1024, 32)  # the TransUNet bottleneck at 512^2: 1024 tokens


@pytest.mark.parametrize("kernel, shape, dtype, flop, nbytes, exp2", [
    # five (S, S, D) products; q, k, v, o, dO in and dq, dk, dv out (bf16),
    # lse2 in (float32); P recomputed by both kernels
    ("flash_bwd", SLICE, "bfloat16", 42.9e9, 67.6e6, 268.4e6),
    # two products; q, k, v in and o out, lse2 out
    ("flash_fwd", SLICE, "bfloat16", 17.2e9, 34.1e6, 134.2e6),
    # its two kernels: S^T, dP^T, dV, dK (+ delta) and S, dP, dQ
    ("flash_bwd_dkdv", SLICE, "bfloat16", 34.4e9, 59.8e6, 134.2e6),
    ("flash_bwd_dq", SLICE, "bfloat16", 25.8e9, 43.0e6, 134.2e6),
    # float32 moves twice the bytes for the same products
    ("flash_bwd", SLICE, "float32", 42.9e9, 134.7e6, 268.4e6),
    # the EDT's lower envelope: 26 integer operations a pixel, both passes
    ("edt", (16, 512, 512), "bfloat16", 109.05e6, 21.0e6, 0),
    # the exp2 probe: 512 x 16384 float32 read and written, one exp2 each
    ("exp2_probe", (512, 16384), "float32", 0, 67_108_864, 8_388_608),
    # the m-skip forward: the forward's two products at the probe's shape
    ("flash_fwd_mskip", (8, 8, 4096, 32), "bfloat16", 137_438_953_472,
     68_157_440, 1_073_741_824),
])
def test_work_counts_match_hand_counts(kernel, shape, dtype, flop, nbytes,
                                       exp2):
    w = C.work_counts(kernel, shape, dtype)
    assert w["flop"] == pytest.approx(flop, rel=2e-3)
    assert w["bytes"] == pytest.approx(nbytes, rel=2e-3)
    assert w["exp2"] == pytest.approx(exp2, rel=2e-3)


def test_bounds_at_the_slice_shape():
    """bf16 flash work is bound by the tensor cores (989 TFLOP/s) rather
    than the bytes (3.35 TB/s); the pair's exp2 floor (two passes of 134 M
    exp2 at 16 a clock on 132 SMs at 1980 MHz) lies above its FLOP bound;
    the EDT's lower envelope does 26 integer operations a pixel on the
    INT32 lanes (64 a clock per SM), a little longer than its 5 bytes a
    pixel take; the min-plus algorithm's add and min per (row, column,
    column) would have taken 0.0641 ms at the float32 rate."""
    ms, by, exp2_ms = C.bound("flash_bwd", SLICE)
    assert by == "operations"
    assert ms == pytest.approx(0.0434, rel=1e-2)
    assert exp2_ms == pytest.approx(0.0642, rel=1e-2)
    assert C.bound("flash_fwd", SLICE)[0] == pytest.approx(0.0174, rel=1e-2)
    edt_ms, edt_by, _ = C.bound("edt", (16, 512, 512))
    assert edt_by == "operations"
    assert edt_ms == pytest.approx(0.00652, rel=1e-2)
    assert C.bound("edt", (128, 256, 256))[0] == pytest.approx(0.01304,
                                                               rel=1e-2)
    edt_bytes = C.work_counts("edt", (16, 512, 512))["bytes"]
    assert edt_bytes / C.PEAK_BYTES * 1e3 == pytest.approx(0.00626,
                                                           rel=1e-2)
    minplus = C.work_counts("edt", (16, 512, 512))["minplus_flop"]
    assert minplus / C.PEAK_FLOPS["float32"] * 1e3 == pytest.approx(
        0.0641, rel=1e-2)
    # a product too thin for its bytes is bound by memory
    assert C.bound("flash_fwd", (64, 8, 64, 8))[1] == "bytes"


def test_redesign_order_follows_device_time(capsys):
    """The ratios to the fastest SDPA call come from one call between CUDA
    events (host latency included) and from queued device time; the
    redesign order follows the device time."""
    fwd = [dict(ms=0.17, library_ms=0.10, queue_ms=0.145,
                library_queue_ms=0.088, library="CUDNN_ATTENTION")]
    bwd = [dict(ms=0.50, library_ms=0.33, queue_ms=0.466,
                library_queue_ms=0.229, library="CUDNN_ATTENTION")]
    r = C.decide(fwd, bwd)
    assert r["r_fwd"] == pytest.approx(1.7)
    assert r["r_fwd"] > r["r_bwd"] and r["r_bwd_queued"] > r["r_fwd_queued"]
    out = capsys.readouterr().out
    assert out.rstrip().endswith(
        "slower than SDPA by device time: the backward pair, the forward")


@pytest.mark.parametrize("kernel, shape, ms", [
    # five products of 2 B H S^2 D FLOP at 495 / 3 TFLOP/s (3xTF32)
    ("flash_bwd", SLICE, 0.2603),
    ("flash_bwd_dkdv", SLICE, 0.2082),
    ("flash_bwd_dq", SLICE, 0.1562),
    ("flash_bwd", (2, 2, 1024, 128), 0.03254),
    ("flash_fwd", SLICE, 0.1041),
])
def test_float32_flash_bounds_at_the_3xtf32_rate(kernel, shape, ms):
    """float32 flash work is bound at the tensor cores' TF32 rate over
    three (a float32-accurate product as three TF32 products), not at the
    FMA rate of 67 TFLOP/s; the EDT's bound, its integer operations on the
    INT32 lanes, does not follow the dtype argument."""
    got, by, _ = C.bound(kernel, shape, "float32")
    assert by == "operations"
    assert got == pytest.approx(ms, rel=2e-3)
    assert C.bound("edt", (16, 512, 512), "float32") == C.bound(
        "edt", (16, 512, 512))
    w = C.work_counts("edt", (16, 512, 512))
    assert w["flop"] / C.INT32_OPS_PER_S * 1e3 == pytest.approx(
        0.00652, rel=1e-2)


def test_probe_bounds():
    """The exp2 probe is bound by its 67.1 MB at 3.35 TB/s (0.0200 ms; its
    exp2 alone 0.0020 ms of the unit); the m-skip forward at the probe's
    shape by the tensor cores (137.4 GFLOP at 989 TFLOP/s, 0.139 ms), under
    an exp2 floor of 0.257 ms."""
    ms, by, exp2_ms = C.bound("exp2_probe", (512, 16384))
    assert by == "bytes"
    assert ms == pytest.approx(0.0200, rel=2e-3)
    assert exp2_ms == pytest.approx(0.00201, rel=1e-2)
    ms, by, exp2_ms = C.bound("flash_fwd_mskip", (8, 8, 4096, 32))
    assert by == "operations"
    assert ms == pytest.approx(0.139, rel=2e-3)
    assert exp2_ms == pytest.approx(0.257, rel=2e-3)


@pytest.mark.parametrize("kernel, shape, ms, by", [
    # benchmarks/pallas_conv_probe.py at N128 128^2 C = CO = 128 bf16:
    # 618.5 GFLOP at 989 TFLOP/s, above its 1.09 GB (0.326 ms; the input
    # padded by one pixel)
    ("conv3x3", (128, 128, 128, 128, 128), 0.6254, "operations"),
    # the gather probes at N128 256^2: f32 values and int32 indices in, f32
    # out (100.7 MB); packed u16 (67.1 MB); u8 (50.3 MB)
    ("gather", (128, 256, 256, 4), 0.03005, "bytes"),
    ("gather", (128, 256, 256, 2), 0.02003, "bytes"),
    ("gather", (128, 256, 256, 1), 0.01502, "bytes"),
])
def test_bounds_of_the_probes_still_to_port(kernel, shape, ms, by):
    got, got_by, _ = C.bound(kernel, shape)
    assert got_by == by
    assert got == pytest.approx(ms, rel=2e-3)
    if kernel == "conv3x3":
        w = C.work_counts(kernel, shape)
        assert w["flop"] == 618_475_290_624
        assert w["bytes"] == 1_090_945_280


@pytest.mark.parametrize("shape, shared, nbytes, ms", [
    # builders A, B, C and B2: N128 256^2 f32 in and out, one (256, 256)
    # int32 index plane read once for the batch
    ((128, 256, 256, 4), True, 67_371_008, 0.02011),
    # F: (2048, 128) f32 src and out, an int32 index per element
    ((1, 2048, 128, 4), False, 3_145_728, 0.000939),
    # P4: (8, 128)
    ((1, 8, 128, 4), False, 12_288, 12_288 / 3.35e12 * 1e3),
    # P5 (512, 128) and P6 (256, 256): 786,432 B each
    ((1, 512, 128, 4), False, 786_432, 0.000235),
    ((1, 256, 256, 4), False, 786_432, 0.000235),
])
def test_bounds_of_the_ported_gather_builders(shape, shared, nbytes, ms):
    """The gather kernel's builders at their own shapes: bound by bytes, a
    shared index counted once (not once per image, as the per-image default
    counts it)."""
    w = C.work_counts("gather", shape, shared_index=shared)
    assert w["bytes"] == nbytes and w["flop"] == 0
    got, by, _ = C.bound("gather", shape, shared_index=shared)
    assert by == "bytes"
    assert got == pytest.approx(ms, rel=2e-3)


@pytest.mark.parametrize("model_type, kw", [
    ("UNet", {}), ("ASPPUNet", {}), ("AttentionUNet", {}), ("VNet2D", {}),
    ("ImprovedVNet", {"deep_supervision": True}),
    ("ImprovedVNet", {"use_attention": False})])
def test_jax_zoo_keys_match_save_params_npz(model_type, kw, tmp_path):
    """The key sets the smoke's zoo train phase holds each .npz to, written
    out from the flax module tree, equal the keys JAX's own
    ``save_params_npz`` writes at depth 3."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ddti_tpu.models import create_model
    from ddti_tpu.train.checkpoint import save_params_npz

    jm = create_model(model_type, base_filters=4, depth=3, **kw)
    v = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((1, 32, 32, 1)), train=False)))
    path = str(tmp_path / "w.npz")
    save_params_npz(path, v["params"], v["batch_stats"])
    with np.load(path) as z:
        want = set(z.files)
    assert C.jax_zoo_keys(model_type, 3, **kw) == want


@pytest.mark.parametrize("kw, forwards, launches", [
    # (a) resized, --tta: 32 frames in 2 batches of 16, 4 flips, 4 layers
    (dict(tta=True), 2, 32),
    # (b) --sliding_window: 24 frames of 2 tiles and 8 of 6, one chunk of
    # up to 8 tiles each
    (dict(sliding=True), 32, 128),
    # (c) --fold_bn: 2 batches + the check's two forwards of one frame
    (dict(fold_bn=True), 2, 16),
    # (d) two members, one forward each a batch
    (dict(members=2), 2, 16),
    (dict(sliding=True, tta=True, members=2, fold_bn=True), 32, 4 * (
        4 * 2 * 32 + 4)),
])
def test_infer_flash_launches(kw, forwards, launches):
    """The infer phase's expected flash launches, counted by hand for its
    frames (24 at 600 x 480, 8 at 1024 x 768) and the slice's TransUNet (4
    attention layers, batch 16)."""
    sizes = [(w, h) for w, h, n in C.INFER_FRAMES for _ in range(n)]
    assert len(sizes) == 32
    assert C.infer_forwards(sizes, 16, kw.get("sliding", False)) == forwards
    assert C.infer_flash_launches(4, sizes, 16, **kw) == launches
    assert C.infer_flash_launches(0, sizes, 16, **kw) == 0  # AttentionUNet


def test_infer_tiles_of_the_two_frame_sizes():
    from ddti_tpu_torch.eval.sliding_window import tile_coords

    got = {(w, h): len(tile_coords(h, w, C.INFER_WINDOW,
                                   C.INFER_STRIDE)[2])
           for w, h, _ in C.INFER_FRAMES}
    assert got == {(600, 480): 2, (1024, 768): 6}
    assert max(got.values()) <= C.INFER_TILE_BATCH


def test_parse_infer_output():
    text = ("ensembling 2 checkpoints (probability mean)\n"
            "predicted 32 images in 3.4s (9.4 img/s)\n"
            "eval vs 32 masks: IoU=0.1000 F1=0.2000\n"
            "[KERNELS] flash_fwd=128\n")
    assert C.parse_infer_output(text) == (32, 3.4, 9.4, 128)
    with pytest.raises(AssertionError):
        C.parse_infer_output("predicted 32 images in 3.4s (9.4 img/s)\n")


def test_make_infer_frames(tmp_path):
    """The frames and masks the infer phase writes: INFER_FRAMES' sizes,
    grayscale JPEGs, binary masks named <stem>_mask.png, the ellipses
    inside the frames; the same from the same seed."""
    import numpy as np
    from PIL import Image

    imgs, masks, frames = C.make_infer_frames(str(tmp_path / "a"), 3)
    assert [s for _, s in frames] == [
        (w, h) for w, h, n in C.INFER_FRAMES for _ in range(n)]
    for name, size in frames:
        img = Image.open(f"{imgs}/{name}")
        assert img.mode == "L" and img.size == size
        m = np.asarray(Image.open(f"{masks}/{name[:-4]}_mask.png"))
        assert set(np.unique(m)) == {0, 255}
        assert 0.005 < (m > 0).mean() < 0.5
    again = C.make_infer_frames(str(tmp_path / "b"), 3)[2]
    assert again == frames
    a = np.asarray(Image.open(f"{imgs}/{frames[-1][0]}"))
    b = np.asarray(Image.open(f"{tmp_path}/b/imgs/{frames[-1][0]}"))
    np.testing.assert_array_equal(a, b)


def test_infer_limits():
    """The limits the infer phase prints beside each check."""
    assert C.INFER_LOGIT_RTOL == 1e-3
    assert C.INFER_BF16_AGREE == 0.995
    assert C.INFER_FLIPS == 4 and C.INFER_TIMED_RUNS >= 10


def test_recipe_card_vs_cpu_runs_on_the_cpu(monkeypatch, capsys):
    """The recipe phase's card-vs-CPU check, with the CPU as the card at a
    toy size: every branch's draws made, ties counted, nothing off."""
    monkeypatch.setattr(C, "DEVICE", "cpu")
    monkeypatch.setattr(C, "TRAIN_PROFILES", [(64, 6), (32, 4)])
    rows = C.recipe_card_vs_cpu()
    assert [r["shape"] for r in rows] == [[6, 64, 64], [4, 32, 32]]
    for r in rows:
        assert r["image_pixels_off"] == r["mask_pixels_off"] == 0
        assert r["clahe_bit_equal"] and r["chain_with_clahe_equal"]
        assert r["tie_pixels"] > 0 and r["clahe_inputs_off"] == 0
    assert "card vs CPU, every branch" in capsys.readouterr().out


def test_chain_ties_hold_the_exact_warps_floors():
    """Every pixel where the exact warp's floored source coordinate moves
    when the angle moves by a few ulps lies on a counted tie."""
    import torch

    from ddti_tpu_torch.data.augment import AugmentConfig, sample_draws
    from ddti_tpu_torch.ops import resample as R

    cfg = AugmentConfig(fast_warp=False, use_elastic=True, p_elastic=1.0)
    d = sample_draws(torch.Generator().manual_seed(1), 8, cfg, (48, 48))
    ties = C._chain_ties(d, 48)
    assert ties.shape == (8, 48, 48) and 0 < ties.float().mean() < 0.01
    xs, ys = R._source_coords(d.angle, 48, 48)
    nudged = d.angle.double().mul(1 + 1e-7).float()
    xs2, ys2 = R._source_coords(nudged, 48, 48)
    moved = (torch.floor(xs) != torch.floor(xs2)) | (
        torch.floor(ys) != torch.floor(ys2))
    moved = torch.where(d.flip_h[:, None, None] | d.flip_v[:, None, None],
                        torch.zeros_like(moved), moved)
    assert not (moved & ~ties).any()


def test_recipe_cli_flags_are_test_sh():
    flags = C._recipe_flags()
    assert "--image_size=256" in flags and "--store_size=256" in flags
    assert "--base_filters=64" in flags and "--depth=5" in flags
    assert set(C.RECIPE_SETTINGS) == {"plain", "speckle", "tgc", "clahe",
                                      "mixup", "elastic"}
    assert C.RECIPE_OPTIONS[C.RECIPE_OPTIONS.index("--grad_accum") + 1] \
        == "2"


LIFECYCLE_LOG = """\
2026-10-18 01:30:21,100 - INFO - Resuming at epoch 2/3 (restored step 6)
2026-10-18 01:30:22,100 - INFO - Train Epoch: 2, Avg Loss: 1.4223
2026-10-18 01:30:23,100 - INFO - Train Epoch: 3, Avg Loss: 1.4233
2026-10-18 01:30:24,100 - INFO - Threshold sweep (val IoU): 0.05:0.0645, \
0.10:0.0700, 0.15:0.0612 -> using 0.10
2026-10-18 01:30:25,100 - INFO - Contour grids: 16 frames in 12.500 s -> \
test_boundaries_0.png
[KERNELS] edt_minplus=11 flash_fwd=0 flash_bwd_dkdv=0 flash_bwd_dq=0
"""


def test_parse_lifecycle_log():
    got = C.parse_lifecycle_log(LIFECYCLE_LOG)
    assert got == {"epochs": [2, 3], "threshold": 0.10,
                   "grid_frames": 16, "grid_s": 12.5,
                   "resumed_epoch": 2, "resumed_step": 6,
                   "kernels": {"edt_minplus": 11, "flash_fwd": 0,
                               "flash_bwd_dkdv": 0, "flash_bwd_dq": 0}}
    assert C.parse_lifecycle_log("") == {"epochs": []}


def test_lifecycle_cmd_is_the_flagship_with_the_lifecycle_flags():
    cmd = C.lifecycle_cmd("/b", "--resume")
    assert cmd[1:3] == ["-m", "ddti_tpu_torch.cli.main"]
    for flag in ("--base_filters=64", "--depth=5", "--image_size=512",
                 "--batch_size=16", "--epochs=3", "--save_interval=1",
                 "--max_keep_checkpoints=2", "--tune_threshold",
                 "--best_full_state", "--synthetic"):
        assert flag in cmd, flag
    assert cmd[cmd.index("--device") + 1] == "cuda"
    assert cmd[-1] == "--resume"
    # the CLI parses every flag of the command
    from ddti_tpu_torch.cli.main import get_parser

    args = get_parser().parse_args(cmd[3:])
    assert args.save_interval == 1 and args.max_keep_checkpoints == 2
    assert args.ema_decay == 0.999 and args.resume


def test_lifecycle_flag_needs_the_card(tmp_path):
    """``chip_smoke.py --lifecycle`` without a card (nor nvidia-smi) exits
    non-zero and prints no result line."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "chip_smoke.py", "--lifecycle"],
                       cwd=root, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"lifecycle"' not in r.stdout and '"ok"' not in r.stdout


def test_lifecycle_phase_rehearses_on_the_cpu(monkeypatch, tmp_path, capsys):
    """The whole lifecycle phase with the CPU as the card and a tiny
    ResUNet (base 4, depth 2, 32^2): its three CLI runs, the restore held
    bit for bit, the best-save timings, the average and the infer CLI; no
    kernel launches here."""
    monkeypatch.setattr(C, "DEVICE", "cpu")
    monkeypatch.setattr(C, "TRAIN", dict(
        model_type="ResUNet", base_filters=4, depth=2, image_size=32,
        batch_size=16, epochs=2))
    monkeypatch.setattr(C, "INFER_FRAMES", ((64, 48, 3), (96, 64, 1)))
    monkeypatch.setattr(C, "LIFECYCLE_RECALIB", 4)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = C.run_lifecycle(str(tmp_path))
    finally:
        torch.set_num_threads(n)
    assert got["launches"] == {"uninterrupted": 0, "resumed": 0}
    assert got["restore"]["step"] // 4 == 1
    assert got["restore"]["tensors"] > 0 and got["restore"]["bytes"] > 0
    assert len(got["best_saves"]["rows"]) == 4
    assert all(0.05 <= t <= 0.95 for t in got["threshold"])
    out = capsys.readouterr().out
    assert "preempted: exit 75, test phase skipped" in out
    assert "bit-equal True" in out


def test_legacy_flag_needs_the_card():
    """``chip_smoke.py --legacy`` without a card exits non-zero and prints
    no result line."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "chip_smoke.py", "--legacy"],
                       cwd=root, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"legacy"' not in r.stdout and '"ok"' not in r.stdout


def test_legacy_sweep_extra_is_run_sh_at_one_epoch_in_bf16():
    """The legacy sweep's ``--extra`` parses through the port's training
    CLI: run.sh's extras (256^2, synthetic, both modes) with 1 epoch in
    place of 2, batch 16 and bf16."""
    import os
    import re
    import shlex

    args = C.legacy_extra_args()
    assert (args.mode, args.synthetic, args.epochs, args.image_size,
            args.store_size, args.batch_size) == ("both", True, 1, 256, 256,
                                                   16)
    assert args.use_amp_autocast is True
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "run.sh")) as f:
        run_sh = re.search(r'--extra "([^"]*)"', f.read()).group(1)
    ours = shlex.split(C.LEGACY_EXTRA)
    theirs = shlex.split(run_sh)
    theirs[theirs.index("--epochs") + 1] = "1"
    assert ours[:len(theirs)] == theirs
    assert C.LEGACY_JOBS == len(C.LEGACY)  # the nine jobs at once


@pytest.mark.parametrize("model_type", C.LEGACY)
def test_jax_legacy_keys_match_save_params_npz(model_type, tmp_path):
    """The key sets the legacy phase holds each swept .npz to, written out
    from the flax module tree, equal the keys JAX's ``save_params_npz``
    writes (small widths, the default depths and layer counts)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from ddti_tpu.models import create_model
    from ddti_tpu.train.checkpoint import save_params_npz

    kw = {"TripleBranchImprovedVNet": dict(base_num_filters=4),
          "MoresImprovedVNet": dict(base_filters=4),
          "MoresVNet2D": dict(features=(2, 4, 8, 16, 32))}.get(
        model_type, dict(features=(2, 4, 8, 16)))
    if model_type == "MoresTransUNet":
        kw.update(trans_dim=8, num_heads=2, image_size=64)
    elif model_type in ("LegacyUNet", "MoresUNet"):
        kw = {}
    jm = create_model(model_type, **kw)
    v = jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), jax.eval_shape(
        lambda: jm.init({"params": jax.random.PRNGKey(0)},
                        jnp.zeros((1, 64, 64, 1)), train=False)))
    path = str(tmp_path / "w.npz")
    save_params_npz(path, v["params"], v["batch_stats"])
    with np.load(path) as z:
        want = set(z.files)
    assert C.jax_legacy_keys(model_type) == want


def test_legacy_phase_rehearses_on_the_cpu(monkeypatch, tmp_path, capsys):
    """The legacy phase with the CPU as the card, two of its models at a
    tiny size (MoresVNet2D and MoresTransUNet, features 4, 8, one encoder
    layer, 32^2, float32): the params tool's 14 counts, the split and the
    sweep through the CLIs, every run's checks with the JAX key set, the
    aggregate's ranked rows and CSV, and MoresTransUNet served; no kernel
    launches here, and the step and profiles only on the card."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from ddti_tpu.models import create_model

    models = ("MoresVNet2D", "MoresTransUNet")
    kw = dict(in_channels=1, out_channels=1, features=[4, 8], trans_dim=16,
              num_heads=2, num_layers=1, image_size=32)
    counts = {}
    for m in models:
        import warnings
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            shapes = jax.eval_shape(lambda: create_model(m, **kw).init(
                {"params": jax.random.PRNGKey(0)},
                jnp.zeros((1, 32, 32, 1)), train=False))
        counts[m] = sum(int(np.prod(a.shape))
                        for a in jax.tree.leaves(shapes["params"]))
    monkeypatch.setattr(C, "DEVICE", "cpu")
    monkeypatch.setattr(C, "LEGACY", models)
    monkeypatch.setattr(C, "LEGACY_KW", kw)
    monkeypatch.setattr(C, "LEGACY_JAX_PARAMS", counts)
    monkeypatch.setattr(C, "LEGACY_EXTRA", (
        "--mode both --synthetic --epochs 1 --image_size 32 --store_size 32 "
        "--batch_size 16 --log_every 0"))
    monkeypatch.setattr(C, "LEGACY_SERVE", dict(image_size=32, batch=2,
                                                batches=2))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        got = C.run_legacy(str(tmp_path))
    finally:
        torch.set_num_threads(n)
    assert got["launches"] == {m: 0 for m in models}
    assert sorted(got["test_iou"]) == sorted(models)
    assert got["serve"]["launches"] == 0 and got["serve"]["rel"] <= 1e-3
    assert "train_steps" not in got
    out = capsys.readouterr().out
    assert "the 14 counts equal the JAX package's cli/params.py" in out
    assert "cli/aggregate.py: 2 ranked rows and a CSV" in out


@pytest.mark.parametrize("intervals, lo, hi, want", [
    ([(0, 10), (5, 15)], None, None, 15),            # overlapping
    ([(0, 20), (5, 8), (6, 7)], None, None, 20),     # nested
    ([(0, 2), (5, 7), (10, 11)], None, None, 5),     # disjoint
    ([(7, 9), (0, 3), (2, 4)], None, None, 6),       # unsorted, chained
    ([(-5, 3), (2, 6), (9, 30)], 0, 20, 17),         # clipped to the window
    ([(-5, -1), (25, 30)], 0, 20, 0),                # wholly outside it
    ([(3, 3), (4, 2)], None, None, 0),               # empty intervals
    ([], 0, 10, 0),
], ids=["overlap", "nested", "disjoint", "unsorted", "clipped", "outside",
        "empty", "none"])
def test_interval_union(intervals, lo, hi, want):
    """The busy time of a profiler window: the union of the device
    intervals, each clipped to the window (F1: the summed durations read
    above 100%)."""
    assert C.interval_union_us(intervals, lo, hi) == pytest.approx(want)


def test_device_busy_reads_the_union_inside_the_window(monkeypatch, capsys):
    """device_busy on a trace of its own making: two overlapping kernels,
    a memcpy, a kernel outside the window, and device-side user annotations
    spanning kernels (as AdamW's ``Optimizer.step`` range and the busy
    window itself show), which the union and the kernel shares leave out
    and the old sum counted twice; the old reading is printed once."""
    from types import SimpleNamespace as NS

    import torch

    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, a, b, dev=cuda, ann=False):
        return NS(name=name, device_type=dev, is_user_annotation=ann,
                  time_range=NS(start=a, end=b))

    events = [ev(C.BUSY_WINDOW, 100, 200, cpu), ev("k1", 110, 140),
              ev("k2", 130, 150), ev("Memcpy HtoD", 160, 170),
              ev("k0", 50, 90), ev("Optimizer.step#AdamW.step", 105, 175,
                                   ann=True),
              ev(C.BUSY_WINDOW, 108, 172, ann=True)]
    avgs = [NS(key=e.name, device_type=e.device_type,
               is_user_annotation=e.is_user_annotation,
               self_device_time_total=e.time_range.end - e.time_range.start)
            for e in events if e.device_type == cuda]
    prof = NS(events=lambda: events, key_averages=lambda: avgs)
    monkeypatch.setattr(C, "_SUMMED_SHOWN", [])
    b = C.device_busy(prof)
    assert b == {"window_us": 100, "union_us": 50}   # 110-150 and 160-170
    assert C.busy_text(b).startswith("50.0% busy")
    # the kernel shares' denominator holds no annotation
    assert sorted(e.key for e in C.device_kernels(prof)) == [
        "Memcpy HtoD", "k0", "k1", "k2"]
    text = C.summed_text(prof, b)
    assert "reads 50.0% of a 0.100 ms window" in text
    assert "reads 234.0%" in text           # 100 of kernels + 134 annotated
    assert (f"134.0% are the user annotations (Optimizer.step#AdamW.step "
            f"70.0%, {C.BUSY_WINDOW} 64.0%)") in text
    assert "overlapping one another 0.010 ms" in text
    C.device_busy(prof)
    out = capsys.readouterr().out
    assert out.count("[busy] ") == 1 and text in out


def test_metrics_names_are_the_jax_daemons():
    """The hostdata phase holds the card daemon's /metrics to METRICS_JAX,
    which must be the series the JAX daemon's _metrics prints."""
    import os
    import re

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "ddti_tpu", "cli", "serve.py")) as f:
        src = f.read()
    body = src[src.index("def _metrics("):src.index("def _reload(")]
    names = set(re.findall(r"# TYPE (ddti_\w+)", body))
    assert names == set(C.METRICS_JAX)


def test_hostdata_flag_needs_the_card():
    """``chip_smoke.py --hostdata`` without a card exits non-zero and
    prints no result line."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "chip_smoke.py", "--hostdata"],
                       cwd=root, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"hostdata"' not in r.stdout and '"ok"' not in r.stdout


def test_cache_bytecode_keeps_it_under_build_inside_a_checkout(
        monkeypatch, tmp_path):
    """In a checkout the smoke and its children write bytecode under
    build/pycache, whatever PYTHONDONTWRITEBYTECODE said; beside nothing
    of the repository it changes nothing."""
    import importlib.util
    import os
    import shutil
    import sys

    monkeypatch.setenv("PYTHONDONTWRITEBYTECODE", "1")
    monkeypatch.delenv("PYTHONPYCACHEPREFIX", raising=False)
    monkeypatch.setattr(sys, "dont_write_bytecode", True)
    monkeypatch.setattr(sys, "pycache_prefix", None)
    shutil.copy(C.__file__, tmp_path / "chip_smoke.py")
    spec = importlib.util.spec_from_file_location(
        "lone_chip_smoke", tmp_path / "chip_smoke.py")
    lone = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lone)
    lone.cache_bytecode()
    assert os.environ["PYTHONDONTWRITEBYTECODE"] == "1"
    assert "PYTHONPYCACHEPREFIX" not in os.environ
    assert sys.dont_write_bytecode and sys.pycache_prefix is None
    C.cache_bytecode()
    want = os.path.join(os.path.dirname(os.path.abspath(C.__file__)),
                        "build", "pycache")
    assert os.environ["PYTHONPYCACHEPREFIX"] == want
    assert "PYTHONDONTWRITEBYTECODE" not in os.environ
    assert sys.pycache_prefix == want and not sys.dont_write_bytecode


@pytest.mark.parametrize("names, kernel, want", [
    # the EDT's row pass, once a call, as the profiler demangles it (an
    # anonymous namespace), beside its column pass and other kernels
    (["(anonymous namespace)::edt_row_kernel(float*, long long, int, int)",
      "void (anonymous namespace)::edt_column_kernel<4, unsigned int>(...)",
      "edt_row_kernel", "void edt_row_kernel(float*)", "my_edt_row_kernel",
      "edt_row_kernel_v2(float*)"], "edt_minplus", 3),
    (["void flash_fwd_bf16_kernel<32, false>(CUtensorMap, CUtensorMap)",
      "void flash_fwd_f32_kernel<32>(CUtensorMap)",
      "flash_fwd_split_f32_kernel(float const*)",
      "void flash_fwd_bf16_kernel<64, true>(CUtensorMap)"], "flash_fwd", 2),
    ([], "edt_minplus", 0),
])
def test_kernel_launches_from_profiler_names(names, kernel, want):
    assert C.kernel_launches(names, kernel) == want


def test_trace_kernel_names_reads_the_kernel_events(tmp_path):
    import json

    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"cat": "kernel", "name": "(anonymous namespace)::edt_row_kernel()"},
        {"cat": "Kernel", "name": "edt_row_kernel"},
        {"cat": "cpu_op", "name": "edt_row_kernel"},
        {"cat": "cuda_runtime", "name": "cudaGraphLaunch"},
        {"ph": "M", "name": "process_name"}]}))
    names = C.trace_kernel_names(str(path))
    assert C.kernel_launches(names, "edt_minplus") == 2
    assert "categories" in C._trace_summary(str(path))


def test_parse_autobatch_reads_each_candidate_and_the_pick():
    log = "\n".join([
        "2026-10-18 - INFO - [autobatch] batch 8/device: measured peak "
        "5.10 GiB vs budget 72.68 GiB (fits; 5476083302 B, cap "
        "78040000000 B)",
        "2026-10-18 - INFO - [autobatch] batch 16/device: measured peak "
        "9.90 GiB vs budget 72.68 GiB (fits; 10630044057 B, cap "
        "78040000000 B)",
        "2026-10-18 - INFO - [autobatch] batch 32/device: measured peak "
        "80.00 GiB vs budget 72.68 GiB (over; 85899345920 B, cap "
        "78040000000 B)",
        "2026-10-18 - INFO - [autobatch] selected --batch_size 16"])
    rows, picked = C.parse_autobatch(log)
    assert picked == 16
    assert rows == [(8, 5476083302, 78040000000, True),
                    (16, 10630044057, 78040000000, True),
                    (32, 85899345920, 78040000000, False)]
    rows, picked = C.parse_autobatch(
        "[autobatch] batch 8/device: measured peak 1.00 GiB vs budget 2.00 "
        "GiB (fits; 1 B, cap 2 B)\n[autobatch] batch 16/device: out of "
        "memory (over budget): CUDA out of memory\n[autobatch] selected "
        "--batch_size 8")
    assert rows == [(8, 1, 2, True), (16, None, None, False)] and picked == 8


def test_parse_autobatch_reads_the_ports_own_log_lines(caplog):
    """The lines train/autobatch.py writes are the lines the smoke reads."""
    import logging
    import types

    from ddti_tpu_torch.train import autobatch

    def peak(config, model, batch, host_augment=False):
        if batch >= 64:
            import torch
            raise torch.cuda.OutOfMemoryError("CUDA out of memory. x")
        return batch * 2 ** 28

    lg = logging.getLogger("smoke_autobatch")
    with caplog.at_level(logging.INFO, logger="smoke_autobatch"):
        b = autobatch.pick_batch_size(types.SimpleNamespace(grad_accum=1),
                                      None, budget_bytes=2 ** 34,
                                      peak_fn=peak, logger=lg)
        lg.info(f"[autobatch] selected --batch_size {b}")
    rows, picked = C.parse_autobatch("\n".join(
        r.getMessage() for r in caplog.records))
    assert picked == b == 32
    assert [r[0] for r in rows] == [8, 16, 32, 64]
    assert rows[-1] == (64, None, None, False)
    assert rows[2] == (32, 32 * 2 ** 28, int(2 ** 34 * 0.92), True)


def test_trainer_flag_needs_the_card():
    """``chip_smoke.py --trainer`` without a card exits non-zero and
    prints no result line."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "chip_smoke.py", "--trainer"],
                       cwd=root, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"trainer"' not in r.stdout and '"ok"' not in r.stdout


def test_trainer_phase_constants():
    """(b)'s store is whole steps of the flagship batch; (c)'s dataset
    leaves a fused epoch of several steps at batch 64 and at least two at
    128; the student is narrower than the teacher; the CLI's --lr_find
    runs the stated steps, on the synthetic frames or a dataset."""
    assert C.TRAINER_STORE % C.TRAIN["batch_size"] == 0
    assert C.TRAINER_STORE // C.TRAIN["batch_size"] == 8
    assert -(-C.TRAINER_AUTO_FRAMES // 128) >= 2
    assert C.TRAINER_AUTO_FRAMES // 64 >= 3
    assert C.TRAINER_STUDENT["base_filters"] < C.SLICE["base_filters"]
    cmd = C._trainer_cmd("b", "--lr_find", "30")
    assert cmd[1:3] == ["-m", "ddti_tpu_torch.cli.main"]
    assert cmd[-2:] == ["--lr_find", "30"] and "--synthetic" in cmd
    cmd = C._trainer_cmd("b", "--epochs", "1", data="d")
    assert "--synthetic" not in cmd
    assert cmd[cmd.index("--dataset_path") + 1] == "d"


def test_parse_fused_run_reads_the_ports_own_log_lines():
    """The fused epoch's replays and --batch_size auto's run peak, from
    the lines engine.py and cli/main.py write (the CPU run's log has the
    fused epoch's loop but no graph, so no replay line)."""
    text = "\n".join([
        "2026-10-18 - INFO - Fused epoch: step 0 eager, 1 step captured, "
        "2 graph replays",
        "2026-10-18 - INFO - Fused epoch: step 0 eager, 1 step captured, "
        "7 graph replays",
        "2026-10-18 - INFO - [autobatch] the run's peak: 30.10 GiB "
        "allocated, 40.00 GiB reserved above what the model held before "
        "the pick (32319628902 B, 42949672960 B)"])
    assert C.parse_fused_run(text) == ([2, 7], (32319628902, 42949672960))
    assert C.parse_fused_run("Train Epoch: 1") == ([], None)
    import inspect

    from ddti_tpu_torch.cli import main as tmain
    from ddti_tpu_torch.train import engine

    assert "graph replays" in inspect.getsource(engine.Trainer._replay_epoch)
    assert "the run's peak: " in inspect.getsource(tmain.main)


def test_clock_marks_the_peak_of_each_interval_and_stops_its_sampler(
        tmp_path, monkeypatch, capsys):
    """The smoke's Clock reads device memory from ``nvidia-smi -lms`` (here
    a stand-in printing 100, 300, 900 MiB, then 50 until stopped): each
    mark prints the largest reading since the last one, and stop() ends
    the sampling process."""
    import os
    import time

    fake = tmp_path / "nvidia-smi"
    fake.write_text("#!/bin/sh\nfor m in 100 300 900; do echo $m; done\n"
                    "while true; do echo 50; sleep 0.05; done\n")
    fake.chmod(0o755)
    monkeypatch.setenv("PATH", f"{tmp_path}{os.pathsep}{os.environ['PATH']}")
    clock = C.Clock()
    deadline = time.time() + 10
    while clock.peak_mib < 900 and time.time() < deadline:
        time.sleep(0.05)
    clock.mark("first")
    time.sleep(0.3)
    clock.mark("second")
    clock.stop()
    assert clock._smi.poll() is not None
    first, second = clock.rows
    assert first["name"] == "first" and first["peak_gib"] == 900 / 1024
    assert second["peak_gib"] == 50 / 1024
    assert second["at_s"] >= first["at_s"] + 0.3
    out = capsys.readouterr().out
    assert "[clock] first: " in out and "at most 0.88 GiB" in out


@pytest.mark.parametrize("flag, key", [("--deploy", '"deploy"'),
                                       ("--profiles", '"train_steps"')])
def test_deploy_and_profiles_flags_need_the_card(flag, key):
    """``chip_smoke.py --deploy`` and ``--profiles`` without a card exit
    non-zero and print no result line."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "chip_smoke.py", flag],
                       cwd=root, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert key not in r.stdout and '"ok"' not in r.stdout


@pytest.mark.parametrize("shape, k, pad, bf16, nbytes, ops", [
    # the flagship's first-level 3x3 conv: x (int8) in, y (bf16) out
    ((16, 512, 512, 64, 64), 3, 1, True,
     16 * 512 * 512 * 64 * 3 + 9 * 64 * 64 + 8 * 64 + 4,
     2 * 16 * 512 * 512 * 64 * 9 * 64),
    # the decoders' transposed conv: one tap an output pixel
    ((2, 16, 16, 64, 32), 2, "T", False,
     2 * 16 * 16 * 64 + 4 * 64 * 32 + 8 * 32 + 4 + 2 * 32 * 32 * 32 * 4,
     2 * 2 * 32 * 32 * 32 * 64),
])
def test_conv_s8_bound_counts(shape, k, pad, bf16, nbytes, ops):
    n, h, w, c, cout = shape
    ms, by = C.conv_s8_bound(n, h, w, c, cout, k, 1 if pad != "T" else 2,
                             1, pad, bf16)
    want = max(ops / C.PEAK_INT8_OPS, nbytes / C.PEAK_BYTES) * 1e3
    assert ms == pytest.approx(want)
    assert by == ("operations" if ops / C.PEAK_INT8_OPS
                  >= nbytes / C.PEAK_BYTES else "bytes")


def test_deploy_constants_and_qstats_keys():
    """The flagship row is DEPLOY_CONV_LEVELS' first; the QAT run's .npz
    ranges are JAX's init_qstats of the slice's TransUNet."""
    import jax
    import jax.numpy as jnp

    from ddti_tpu.models import create_model as jcreate_model
    from ddti_tpu.train.qat import init_qstats

    assert C.DEPLOY_CONV == C.DEPLOY_CONV_LEVELS[0]
    assert C.DEPLOY_BATCHES[-1] == C.TTRAIN["batch_size"]
    size = C.TTRAIN["image_size"]
    jm = jcreate_model("TransUNet", **C.TSLICE, image_size=size)
    v = jax.eval_shape(lambda k: jm.init({"params": k}, jnp.zeros(
        (1, size, size, 1)), train=False), jax.random.PRNGKey(0))
    want = init_qstats(jm, v, (1, size, size, 1))
    assert C.qstats_keys() == {f"qstats/{p}" for p in want}
