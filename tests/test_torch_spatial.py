"""The port's spatial ``model`` axis (``ddti_tpu_torch/parallel/spatial.py``)
against the port's single-device step and the JAX package's
``data=2,model=2`` mesh step, on the CPU: six models of the zoo at narrow
widths (UNet, ResUNet with mixup, ASPPUNet, TransUNet at dropout 0,
ImprovedVNet with its deep-supervision heads at 64^2, the triple-branch
VNet at dropout 0), a global batch of 8 over four gloo ranks (two data
groups of two bands each) in one spawn (``parallel.launch_local``; the rank
bodies are ``torch_spatial_workers``). The JAX side runs in this process
on 4 of its fake CPU devices with ``batch_sharding(mesh, spatial=True)``;
every side takes the same weights (``train/torch_interop.py``) and the
same draws (JAX's, from its key layout: ``test_torch_augment.jax_draws``).
The fast warp is the chain's default, so its rotations move pixels across
the band edges (the whole frames are augmented before the bands are cut).

Tolerances are the data-parallel tests' (``test_torch_parallel``).
Against the single-device step: the loss terms within rel 2e-5, BatchNorm
running statistics within 1e-6 normwise, the parameters after one SGD
step within rtol 2e-4, atol 1e-6, and the gradients with the network in
float64 within 1e-5 normwise. The confusion counts are held to the two
threshold flips ``test_torch_train`` allows: a float32 conv on a band
sums in another order than on the whole frame, and one pixel of the
ImprovedVNet case at 64^2 sits on the threshold (one flip measured; the
float64 gradients agree to 1e-5 all the same). Against JAX's mesh step:
the loss within rel 2e-5, counts within two threshold flips, running
statistics within 1e-5 normwise, the parameters within 1e-5 normwise and
each within rtol 2e-4, atol 1e-6 beyond the port's own single-device
step's distance from it: in the triple-branch net and ImprovedVNet some
updates are float32 noise on both sides (a bias whose gradient the next
train-mode BatchNorm all but cancels), where the port's single-device
step already lies more than that from JAX's (``test_torch_zoo`` holds
those). The halo exchange and the band gather are held in float64 to
1e-12, edge rows included.

Each process-spawning test bounds its run (``torch_parallel_workers.
bounded``: 120 s), and its ranks are ended with it. Its ranks take one
intra-op thread each (OMP_NUM_THREADS=1): a band step's ~100 small
collectives wait on both ranks being scheduled, which threads spinning
beside the other test workers would delay.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ddti_tpu.core import Config as JConfig
from ddti_tpu.data import generate_ddti_like
from ddti_tpu.data.augment import AugmentConfig as JAugmentConfig
from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.parallel import make_mesh as jmake_mesh
from ddti_tpu.parallel.mesh import batch_sharding, replicated
from ddti_tpu.train.checkpoint import save_params_npz
from ddti_tpu.train.state import TrainState as JTrainState
from ddti_tpu.train.steps import _build_train_step_impl
from ddti_tpu.train.torch_interop import export_state_dict
from ddti_tpu_torch.parallel import (
    Mesh,
    check_mesh_shape,
    launch_local,
    local_rows,
    process_local_batch,
)
from ddti_tpu_torch.parallel.spatial import check_bands, pooling_levels

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_workers as W  # noqa: E402
import torch_spatial_workers as S  # noqa: E402
from test_torch_augment import jax_draws  # noqa: E402
from test_torch_parallel import _mix_draws  # noqa: E402

MESH = {"data": 2, "model": 2}
BATCH = 8
CASES = {  # name: (model type, kwargs, side, Config options)
    "UNet": ("UNet", dict(base_filters=4, depth=3), 32, {}),
    "ResUNet_mixup": ("ResUNet", dict(base_filters=4, depth=3), 32,
                      {"use_mixup": True, "mixup_prob": 1.0}),
    # a bottleneck of 4 rows, bands of 2: dilations 6, 12, 18 read their
    # rows from the gathered frame
    "ASPPUNet": ("ASPPUNet", dict(base_filters=4, depth=3), 32, {}),
    "TransUNet": ("TransUNet", dict(
        base_filters=4, depth=2, embed_dim=8, num_heads=2,
        num_transformer_layers=1, dropout_rate=0.0, image_size=32), 32, {}),
    "ImprovedVNet": ("ImprovedVNet", dict(base_filters=4, depth=3,
                                          deep_supervision=True), 64,
                     {"alpha": 0.5}),
    "TripleBranchImprovedVNet": ("TripleBranchImprovedVNet", dict(
        base_num_filters=4, dropout_rate=0.0), 32, {}),
}
KEYS = {name: 11 + i for i, name in enumerate(CASES)}
OPTION_CASES = {
    "UNet_grad_accum": dict(config={"grad_accum": 2}),
    "UNet_host_augment": dict(host=True),
    "UNet_distill": {},
    "UNet_remat": dict(model_kw=dict(base_filters=4, depth=3, remat=True)),
}
HALOS = ((1, 1), (1, 0), (0, 1), (2, 3), (6, 6))


def _normwise(a: dict, b: dict, keys) -> float:
    x = torch.cat([torch.as_tensor(a[k]).double().ravel() for k in keys])
    y = torch.cat([torch.as_tensor(b[k]).double().ravel() for k in keys])
    return float((x - y).norm() / y.norm())


def _jax_variables(mt, kw, size):
    jm = jcreate_model(mt, **kw)
    v = jax.jit(lambda k: jm.init({"params": k},
                                  jnp.zeros((1, size, size, 1)),
                                  train=False))(jax.random.PRNGKey(0))
    return jm, v


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """{name: (JAX model, variables, images, masks, augment config)} and
    the cases the ranks run."""
    jax_side, cases = {}, {}
    for name, (mt, kw, size, opts) in CASES.items():
        jm, v = _jax_variables(mt, kw, size)
        weights = {k: np.ascontiguousarray(a) for k, a in export_state_dict(
            mt, v["params"], v["batch_stats"]).items()}
        im, ma = generate_ddti_like(BATCH, (size, size), KEYS[name])
        acfg = JAugmentConfig(fast_warp=True, out_size=(size, size))
        k_aug, k_mix, _ = jax.random.split(jax.random.PRNGKey(KEYS[name]), 3)
        mix = _mix_draws(k_mix, BATCH) if opts.get("use_mixup") else None
        jax_side[name] = (jm, v, im, ma, acfg)
        cases[name] = dict(model_type=mt, model_kw=kw, size=size,
                           config=opts, weights=weights, images=im,
                           masks=ma, draws=jax_draws(k_aug, BATCH, acfg),
                           mix=mix)
        cases[f"{name}_f64"] = dict(cases[name], kind="grads64")
    cases["UNet_qat"] = dict(cases["UNet"], config={"qat": True})
    # the options no other case runs on bands, each held against the
    # single-device step: --grad_accum 2 (each microbatch's rows cut into
    # bands), --host_augment's step, a distillation teacher (its soft
    # targets from bands, kd_bce's band means), --remat (the halos
    # exchanged again in the recomputation)
    for name, extra in OPTION_CASES.items():
        cases[name] = dict(cases["UNet"], **extra)
    cases["UNet_distill"]["teacher"] = dict(
        model_type="ResUNet", model_kw=CASES["ResUNet_mixup"][1],
        weights=cases["ResUNet_mixup"]["weights"])
    cases["export"] = dict(kind="export", size=32, model_kw=dict(
        base_filters=4, depth=2), dir=str(tmp_path_factory.mktemp("export")))
    cases["units"] = dict(kind="units", halos=HALOS)
    cases["fused"] = dict(kind="fused", size=32, model_kw=dict(
        base_filters=4, depth=2), config={"use_mixup": True,
                                          "mixup_prob": 1.0,
                                          "nan_guard": True},
        dir=str(tmp_path_factory.mktemp("fused")))
    return jax_side, cases


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Every case on four gloo ranks (data=2, model=2), once: each rank's
    results, in rank order."""
    cases = setup[1]
    tmp = tmp_path_factory.mktemp("spatial")
    torch.save(cases, tmp / "in.pt")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        rc = W.bounded(launch_local, S.spatial_worker, 4, "cpu",
                       (str(tmp / "in.pt"), str(tmp)), MESH)
    assert rc == 0
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(4)]


@pytest.fixture(scope="module")
def single(setup):
    """The single-device step (or float64 gradients, or export run) of a
    case, run once."""
    done = {}
    run = {"grads64": S.run_grads64, "export": S.run_export}

    def one(name):
        if name not in done:
            case = setup[1][name]
            done[name] = run.get(case.get("kind"), S.run_step)(case)
        return done[name]

    return one


@pytest.mark.parametrize("name", list(CASES) + list(OPTION_CASES))
def test_spatial_step_matches_single_device(single, ranks, name):
    """The 4-rank step (two data groups, two bands each) equals the
    single-device step on the same global batch and draws: loss terms,
    counts, n, BatchNorm statistics and the SGD parameters; every rank
    holds the same state. Also for each of OPTION_CASES' options."""
    one = single(name)
    sp = ranks[0][name]
    for a, b in zip(sp["terms"], one["terms"]):
        assert a == pytest.approx(b, rel=2e-5, abs=1e-7)
    for a, b in zip(sp["counts"], one["counts"]):
        assert abs(a - b) <= 2
    assert sp["n"] == one["n"] == BATCH
    run = [k for k in one["state"] if "running_" in k]
    assert _normwise(sp["state"], one["state"], run) < 1e-6
    for k in one["state"]:
        if k not in run:
            np.testing.assert_allclose(sp["state"][k].numpy(),
                                       one["state"][k].numpy(),
                                       rtol=2e-4, atol=1e-6, err_msg=k)
        for r in range(1, 4):
            assert torch.equal(sp["state"][k], ranks[r][name]["state"][k]), k
    for r in range(1, 4):
        assert ranks[r][name]["terms"] == sp["terms"]
        assert ranks[r][name]["counts"] == sp["counts"]


@pytest.mark.parametrize("name", list(CASES))
def test_spatial_gradients_match_single_device_in_float64(single, ranks,
                                                          name):
    """The averaged gradients of the band forward and backward (halos and
    their gradients, the token path's reduce-scatter, SE and Dice sums
    over the model group, the EDT of gathered targets, global BatchNorm
    and Focal-Tversky) equal the single device's within 1e-5 normwise,
    the network in float64."""
    one = single(f"{name}_f64")
    sp = ranks[0][f"{name}_f64"]
    keys = list(one["grads"])
    assert sorted(sp["grads"]) == sorted(keys)
    assert _normwise(sp["grads"], one["grads"], keys) < 1e-5


@pytest.mark.parametrize("name", list(CASES))
def test_convs_see_bands(single, ranks, name):
    """No rank runs the unsharded network: every conv's input (a forward
    pre-hook, before its halo) is the band, H / 2 of the single device's
    rows at its level, except the token path's patchify, which takes the
    gathered frame."""
    one = single(name)["rows"]
    for r in range(4):
        got = ranks[r][name]["rows"]
        assert sorted(got) == sorted(one)
        for conv, rows in one.items():
            want = rows if conv.endswith(S.GATHERED) else rows // 2
            assert got[conv] == want, (r, conv, got[conv], rows)


@pytest.fixture(scope="module")
def jax_mesh_steps(setup, eight_devices):
    """JAX's step on a data=2,model=2 mesh (frames sharded by rows) for
    every case, with SGD(1e-2), from the same variables and keys."""
    mesh = jmake_mesh(dict(MESH), eight_devices[:4])
    rep, sh = replicated(mesh), batch_sharding(mesh, spatial=True)
    out = {}
    for name, (jm, v, im, ma, acfg) in setup[0].items():
        mt, _, size, opts = CASES[name]
        cfg = JConfig(batch_size=BATCH, image_size=size, store_size=size,
                      lr=1e-3, model_type=mt, **opts)
        tx = optax.sgd(S.SGD_LR)
        state = JTrainState(step=jnp.zeros((), jnp.int32),
                            params=v["params"], batch_stats=v["batch_stats"],
                            opt_state=tx.init(v["params"]), tx=tx,
                            apply_fn=jm.apply)
        state = jax.device_put(jax.device_get(state), rep)
        step = jax.jit(_build_train_step_impl(cfg, acfg))
        with mesh:
            new, m = step(state, jax.device_put(jnp.asarray(im), sh),
                          jax.device_put(jnp.asarray(ma), sh),
                          jax.random.PRNGKey(KEYS[name]))
        out[name] = (export_state_dict(mt, new.params, new.batch_stats), m)
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_spatial_step_matches_jax_mesh_step(single, ranks, jax_mesh_steps,
                                            name):
    want, jm = jax_mesh_steps[name]
    sp, one = ranks[0][name], single(name)
    assert sp["terms"][0] == pytest.approx(float(jm.loss), rel=2e-5)
    for a, b in zip(sp["counts"], jm.counts):
        assert abs(a - float(b)) <= 2
    want = {k: torch.from_numpy(np.array(w)) for k, w in want.items()}
    run = [k for k in want if "running_" in k]
    params = [k for k in want if k not in run]
    assert _normwise(sp["state"], want, run) < 1e-5
    assert _normwise(sp["state"], want, params) < 1e-5
    for k in params:
        gap = (sp["state"][k] - want[k]).abs()
        own = (one["state"][k] - want[k]).abs()
        assert bool((gap <= 1e-6 + 2e-4 * want[k].abs() + own).all()), k


def test_export_serving_after_a_model_axis_run(single, ranks):
    """--export_serving after a Trainer epoch on data=2, model=2: the
    writer's f32 bundle, a program of whole frames, gives on whole frames
    the masks of the trained model's own serve function, and so does the
    sharded bundle (data > 1); against the same run on one device, the
    trained weights agree within 1e-5 normwise and the masks on at least
    99.9% of pixels (a float32 band sum may flip a pixel at the
    threshold)."""
    one = single("export")
    sp = ranks[0]["export"]
    assert torch.equal(sp["bundle"], sp["model"])
    assert torch.equal(sp["sharded"], sp["bundle"])
    assert torch.equal(one["bundle"], one["model"])
    assert "sharded" not in one
    assert all("bundle" not in ranks[r]["export"] for r in range(1, 4))
    for r in range(1, 4):
        for k, v in sp["state"].items():
            assert torch.equal(ranks[r]["export"]["state"][k], v), k
    params = [k for k in one["state"] if "running_" not in k
              and "num_batches" not in k]
    assert _normwise(sp["state"], one["state"], params) < 1e-5
    agree = (sp["bundle"] == one["bundle"]).float().mean().item()
    assert agree >= 0.999, agree
    assert 0 < sp["bundle"].float().mean().item() < 1


def test_spatial_qat_ranges_are_global(single, ranks):
    """--qat on bands: each fake-quantized conv takes its halo after the
    quantization (``Conv2d.band_input``) and its batch range is maxed over
    every rank, so all four ranks fold the same ranges, and the first
    conv's (its input is the augmented batch) equals the single device's
    exactly; deeper ones within PR 19's 5e-2 (a last-bit difference
    upstream moves a range by a quantization step)."""
    one = single("UNet_qat")["qstats"]
    sp = [ranks[r]["UNet_qat"]["qstats"] for r in range(4)]
    assert all(q == sp[0] for q in sp[1:])
    assert sorted(sp[0]) == sorted(one)
    first = "encoders_0/conv1"
    assert sp[0][first] == one[first]
    for k, v in one.items():
        assert v > 0 and sp[0][k] == pytest.approx(v, rel=5e-2), k


@pytest.mark.parametrize("which", [f"halo{t},{b}" for t, b in HALOS]
                         + ["gather"])
def test_halo_and_band_gather_in_float64(ranks, which):
    """``halo`` (edge exchange, and through the gathered frame where the
    halo is wider than the band) and ``gather_band`` on every rank: the
    forward against the zero-padded whole frame, the backward against the
    whole frame's gradient of every rank's upstream weights (the halo rows'
    gradients added to their owners; the gather's a reduce-scatter)."""
    for r in range(4):
        fwd, bwd = ranks[r]["units"][which]
        assert fwd < 1e-12 and bwd < 1e-12, (r, fwd, bwd)


def test_band_flip_is_the_whole_frames(ranks):
    """``spatial.flip`` of a band (the flip ensemble's, on bands of rows)
    is the band of the flipped whole frame, for a vertical, horizontal
    and double flip, on every rank."""
    for r in range(4):
        assert ranks[r]["units"]["flip"] == (0.0, 0.0, 0.0), r


def test_fused_epoch_matches_stepwise_on_the_mesh(ranks):
    """--fused_epoch on data=2, model=2 (the CPU's loop: the same
    collectives without a graph; each step's frames padded to a fixed
    number under mixup; --nan_guard decided on the device, every rank's
    finite flag minimised over the ranks) trains the state of the
    stepwise epoch."""
    for r in range(4):
        step, fused = ranks[r]["fused"][False], ranks[r]["fused"][True]
        for k in step:
            np.testing.assert_allclose(fused[k].numpy(), step[k].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
            assert torch.equal(fused[k], ranks[0]["fused"][True][k]), k


# ---------------------------------------------------------------------------
# the mesh's layout, the band condition, the CLI and the API
# ---------------------------------------------------------------------------


def test_mesh_layout_rows_and_bands():
    """Row-major, data first (JAX's devices.reshape): rank = d * M + m; a
    data group's model ranks share its rows; process_local_batch gives a
    rank its rows and its band."""
    check_mesh_shape({"data": 2, "model": 2}, 4)
    meshes = [Mesh(dict(MESH), r, 4) for r in range(4)]
    assert [(m.data_rank, m.model_rank) for m in meshes] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    rows = [local_rows(8, m).tolist() for m in meshes]
    assert rows == [[0, 1, 2, 3]] * 2 + [[4, 5, 6, 7]] * 2
    x = np.arange(8 * 4 * 3).reshape(8, 4, 3)
    for m in meshes:
        got = process_local_batch(x, m)
        lo = 2 * m.model_rank
        np.testing.assert_array_equal(got, x[rows[m.rank]][:, lo:lo + 2])


def test_uneven_bands_raise():
    """A height that does not give equal, even bands at every level
    raises, naming the condition and the sizes (before any rank starts,
    in ``fit``)."""
    from ddti_tpu_torch import api
    from ddti_tpu_torch.models import create_model

    assert pooling_levels(create_model("UNet", base_filters=4, depth=3)) == 3
    assert pooling_levels(create_model("LegacyUNet")) == 4
    check_bands(32, 2, 3)
    with pytest.raises(ValueError, match=r"model \* 2\*\*3 = 16"):
        check_bands(40, 2, 3)
    with pytest.raises(ValueError, match="divide by model"):
        api.fit(np.zeros((8, 24, 24), np.uint8),
                np.zeros((8, 24, 24), np.uint8), base_filters=4, depth=3,
                mesh="data=1,model=2", device="cpu")


@pytest.fixture(scope="module")
def jax_unet_keys(tmp_path_factory):
    """The key set of JAX's ``save_params_npz`` for the CLI's UNet."""
    jm, v = _jax_variables("UNet", dict(base_filters=4, depth=3), 32)
    path = str(tmp_path_factory.mktemp("jax") / "j.npz")
    save_params_npz(path, v["params"], v["batch_stats"])
    with np.load(path) as z:
        return sorted(z.files)


def test_cli_model_axis_end_to_end(tmp_path, capfd, jax_unet_keys,
                                   monkeypatch):
    """python -m ddti_tpu_torch.cli.main --device cpu --mesh
    data=1,model=2 --tta --tune_threshold: two gloo ranks, each on its
    band of every frame, train, validate, sweep the threshold and test
    with the flip ensemble (its vertical flips of whole frames) (JAX's
    test_cli_mesh_flag_end_to_end); one run directory whose log names the
    mesh, a .npz with JAX's key set, test metrics over the 16 whole test
    frames."""
    import json

    from ddti_tpu_torch.cli import main as tmain

    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    rc = W.bounded(tmain.main, [
        "--mode", "both", "--synthetic", "--epochs", "1", "--image_size",
        "32", "--store_size", "32", "--model_type", "UNet",
        "--base_filters", "4", "--depth", "3", "--batch_size", "8", "--lr",
        "1e-3", "--device", "cpu", "--mesh", "data=1,model=2", "--tta",
        "--tune_threshold", "--base_dir", str(tmp_path)])
    assert rc == 0
    (run,) = tmp_path.iterdir()
    log = (run / "log" / "train_log.log").read_text()
    assert ("Using explicit mesh {'data': 1, 'model': 2} over 2 devices"
            in log)
    printed = capfd.readouterr().out
    assert printed.count("[PARAMS] UNet,") == 1
    assert printed.count("Test Metrics") == 1
    with np.load(run / "models" / "UNet_best.npz") as z:
        assert sorted(z.files) == jax_unet_keys
    assert "Threshold sweep (val IoU)" in log
    m = json.loads((run / "result" / "test_metrics.json").read_text())
    assert m["total_images"] == 16 and m["tta"] is True
    assert m["tp"] + m["fp"] + m["fn"] + m["tn"] == 16 * 32 * 32


def test_fit_on_a_model_axis(tmp_path, monkeypatch):
    """``api.fit(mesh="data=1,model=2")``: two gloo ranks train on bands;
    rank 0's best weights come back and predict whole frames."""
    from ddti_tpu_torch import api as ddti

    im, mk = generate_ddti_like(12, (32, 32), 3)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    m = W.bounded(ddti.fit, im[..., 0], mk[..., 0], base_filters=4,
                  depth=3, epochs=1, batch_size=4, bf16=False,
                  verbose=False, device="cpu", mesh="data=1,model=2",
                  run_dir=str(tmp_path))
    pred = m.predict(im)
    assert pred.shape == (12, 32, 32) and pred.dtype == np.uint8
