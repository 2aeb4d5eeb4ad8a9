"""The port's checkpoint averaging CLI (ddti_tpu_torch/cli/average.py)
against the JAX package's ddti_tpu/cli/average.py on the CPU, UNet bf8 d3
at 32^2: three shared ``.npz`` files (JAX's own ``save_params_npz``
exports) averaged by both CLIs, uniform and weighted; a port periodic
root expanded and averaged; the SWA BatchNorm recalibration; the output
loaded by the train CLI, the infer CLI and JAX.

Tolerance: the averaged tensors within 1e-6 relative of JAX's (both sum
in float64 and round once to float32, so in practice equal).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.cli.average import main as javerage
from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.train.checkpoint import load_params_npz, save_params_npz
from ddti_tpu_torch.cli import main as tmain
from ddti_tpu_torch.cli.average import _expand_managed, main as average
from ddti_tpu_torch.models import blocks, create_model
from ddti_tpu_torch.train import checkpoint as ck
from ddti_tpu_torch.train.state import TrainState
from ddti_tpu_torch.utils.weight_init import init_like_flax

from test_torch_lifecycle import SMALL, _stepped_state

RTOL = 1e-6
ARGS = ["--model_type", "UNet", "--base_filters", "8", "--depth", "3",
        "--image_size", "32"]
JAX_ARGS = ARGS + ["--cpu", "--compilation_cache", "off"]
PORT_ARGS = ARGS + ["--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: xdist runs six of these processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_vars(seed):
    model = jcreate_model("UNet", in_channels=1, out_channels=1,
                          base_filters=8, depth=3)
    v = model.init({"params": jax.random.PRNGKey(seed)},
                   jnp.zeros((1, 32, 32, 1)), train=False)
    rng = np.random.default_rng(seed)
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(
        np.float32), v["batch_stats"])
    return v["params"], stats


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    """Three JAX exports (other seeds, other BatchNorm statistics)."""
    root = tmp_path_factory.mktemp("shared")
    paths = []
    for seed in (0, 1, 2):
        p = str(root / f"m{seed}.npz")
        save_params_npz(p, *_jax_vars(seed))
        paths.append(p)
    return paths


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("weights", [None, "1,2,5"])
def test_average_matches_jax(tmp_path, shared, weights):
    extra = ["--weights", weights] if weights else []
    jout, tout = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    assert javerage(["--checkpoints", *shared, "--output", jout]
                    + JAX_ARGS + extra) == 0
    assert average(["--checkpoints", *shared, "--output", tout]
                   + PORT_ARGS + extra) == 0
    want, got = _npz(jout), _npz(tout)
    assert got.keys() == want.keys()
    w = np.asarray([1, 2, 5] if weights else [1, 1, 1], np.float64)
    members = [_npz(p) for p in shared]
    for k in want:
        assert got[k].dtype == want[k].dtype == np.float32, k
        np.testing.assert_allclose(got[k], want[k], rtol=RTOL, err_msg=k)
        exact = sum(wi * m[k].astype(np.float64)
                    for wi, m in zip(w / w.sum(), members))
        np.testing.assert_allclose(got[k], exact, rtol=RTOL, err_msg=k)


def test_average_rejects_single_and_bad_weights(tmp_path, shared):
    out = str(tmp_path / "o.npz")
    assert average(["--checkpoints", shared[0], "--output", out]
                   + PORT_ARGS) == 1
    assert average(["--checkpoints", *shared[:2], "--output", out,
                    "--weights", "1,2,3"] + PORT_ARGS) == 1
    assert not os.path.exists(out)


def test_periodic_root_expands_and_averages_the_shadows(tmp_path):
    """A managed root expands to its step directories, oldest first; a
    full state contributes its EMA shadow (the weights it serves)."""
    root = tmp_path / "periodic"
    mgr = ck.ManagedCheckpointer(str(root), max_to_keep=3, async_save=False)
    states = []
    for step in (1, 2):
        st = _stepped_state(ema=True, seed=step)
        mgr.save(step, st)
        states.append(st)
    mgr.close()
    assert _expand_managed(str(root)) == [str(root / "1"), str(root / "2")]
    assert _expand_managed(str(root / "1")) == [str(root / "1")]
    out = str(tmp_path / "avg.npz")
    assert average(["--checkpoints", str(root), "--output", out,
                    "--model_type", "UNet", "--image_size", "32",
                    "--base_filters", str(SMALL["base_filters"]),
                    "--depth", str(SMALL["depth"]), "--device", "cpu"]) == 0
    got = ck.load_checkpoint_into(out, "UNet", create_model(
        "UNet", **SMALL)).state_dict()
    for k, v in got.items():
        want = (states[0].eval_state_dict()[k].double()
                + states[1].eval_state_dict()[k].double()) / 2
        torch.testing.assert_close(v, want.float(), rtol=RTOL, atol=0)


def test_bn_recalibration_moves_only_the_statistics(tmp_path, shared):
    out, out_rc = str(tmp_path / "avg.npz"), str(tmp_path / "rc.npz")
    assert average(["--checkpoints", *shared[:2], "--output", out]
                   + PORT_ARGS) == 0
    assert average(["--checkpoints", *shared[:2], "--output", out_rc,
                    "--recalib_count", "4", "--recalib_batch", "4",
                    "--recalib_passes", "10"] + PORT_ARGS) == 0
    a, b = _npz(out), _npz(out_rc)
    moved = []
    for k in a:
        if k.startswith("params/"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        else:
            assert np.isfinite(b[k]).all(), k
            moved.append(float(np.abs(a[k] - b[k]).max()))
    assert moved and max(moved) > 1e-3


def test_recalibration_matches_jax(tmp_path, shared):
    """The SWA pass from the same synthetic frames: the re-estimated
    means and variances within 1e-4 relative of JAX's (its two-pass
    variance, the port's numerics, QUIRKS #24)."""
    from ddti_tpu.models import blocks as jblocks

    flags = ["--recalib_count", "6", "--recalib_batch", "4",
             "--recalib_passes", "3"]
    jout, tout = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jblocks.set_bn_fast_variance(False)
    try:
        assert javerage(["--checkpoints", *shared, "--output", jout]
                        + JAX_ARGS + flags) == 0
    finally:
        jblocks.set_bn_fast_variance(True)
    blocks.BatchNorm2d.exact_variance = True  # the port's two passes too
    try:
        assert average(["--checkpoints", *shared, "--output", tout]
                       + PORT_ARGS + flags) == 0
    finally:
        blocks.BatchNorm2d.exact_variance = False
    want, got = _npz(jout), _npz(tout)
    for k in want:
        if k.startswith("batch_stats/"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-6, err_msg=k)


def test_average_is_served_and_warm_starts(tmp_path, shared):
    """The averaged .npz: JAX loads it, the port's infer CLI predicts
    masks from it, the train CLI warm-starts from it, and --resume from
    it refuses (no optimizer state)."""
    out = str(tmp_path / "avg.npz")
    assert average(["--checkpoints", *shared, "--output", out]
                   + PORT_ARGS) == 0
    load_params_npz(out, *_jax_vars(9))  # JAX reads the layout
    from ddti_tpu_torch.data.synthetic import write_synthetic_dataset

    data = tmp_path / "data"
    write_synthetic_dataset(str(data), n_train=1, n_val=1, n_test=2,
                            size=(32, 32))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "ddti_tpu_torch.cli.infer", "--checkpoint",
         out, "--input_dir", str(data / "test"), "--output_dir",
         str(tmp_path / "preds"), *PORT_ARGS],
        cwd=root, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    preds = sorted(os.listdir(tmp_path / "preds"))
    assert len(preds) == 2 and all(p.endswith("_pred.png") for p in preds)

    base = ["--mode", "train", "--synthetic", "--epochs", "1",
            "--image_size", "32", "--store_size", "32", "--model_type",
            "UNet", "--base_filters", "8", "--depth", "3", "--batch_size",
            "16", "--log_every", "0", "--device", "cpu"]
    assert tmain.main(base + ["--checkpoint_path", out, "--base_dir",
                              str(tmp_path / "runs")]) == 0
    (run,) = (tmp_path / "runs").iterdir()
    assert f"Warm-started weights from {out}" in (
        run / "log" / "train_log.log").read_text()
    with pytest.raises(ValueError, match="weights only"):
        tmain.main(base + ["--resume", "--checkpoint_path", out,
                           "--base_dir", str(tmp_path / "runs2")])


def test_recalibration_runs_in_train_mode_without_gradients(tmp_path):
    """The pass updates the running statistics only: no parameter gets a
    gradient, and the model is back in eval mode."""
    from ddti_tpu_torch.cli.average import _recalibrate, get_parser

    model = init_like_flax(create_model("UNet", base_filters=8, depth=3), 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    args = get_parser().parse_args(["--checkpoints", "a", "--output", "b",
                                     "--recalib_batch", "4",
                                     "--recalib_passes", "2"])
    _recalibrate(model, np.random.default_rng(0).random(
        (6, 1, 32, 32)).astype(np.float32), args, "cpu")
    assert not model.training
    assert all(p.grad is None for p in model.parameters())
    for k, v in model.state_dict().items():
        same = torch.equal(v, before[k])
        assert same == ("running" not in k), k
    TrainState(model, 1e-3, 1)  # still a trainable model
