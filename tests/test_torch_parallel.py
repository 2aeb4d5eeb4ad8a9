"""The port's data parallelism (``ddti_tpu_torch/parallel``) against the
port's single-device step and the JAX package's ``data=2`` mesh, on the
CPU: UNet, base_filters 8, depth 3, 32^2, a global batch of 16 over two
gloo ranks in spawned processes (``parallel.launch_local``; their bodies
are ``torch_parallel_workers``). The JAX side runs in this process on a
``data=2`` mesh of its fake CPU devices. The weights come across through
``train/torch_interop.py``; every side takes the same draws (JAX's, from
its key layout: ``test_torch_augment.jax_draws``).

Tolerances. Against the single-device step: the loss within rel 2e-5 and
the confusion counts equal (JAX's own bounds, tests/test_parallel.py),
BatchNorm running statistics within 1e-6 normwise and the parameters
after one SGD step within rtol 2e-4, atol 1e-6. Gradients within 1e-5
normwise with the network in float64 (``run_grads64``): in float32 the
single-device step itself moves its gradients by up to 9.2e-3 normwise
when only the order of its batch rows changes (a ReLU or max-pool kink
flips; one-pass BatchNorm variance cancels), so float32 gradients are held
through the SGD parameters. Against JAX's mesh step: the loss within rel
2e-5, counts within the two threshold flips the single-device comparison
allows (tests/test_torch_train.py), parameters within rtol 2e-4, atol 1e-6
and running statistics within 1e-5 normwise.

Each process-spawning test bounds its run (``torch_parallel_workers.
bounded``: 120 s), and its ranks are ended with it.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from ddti_tpu.core import Config as JConfig
from ddti_tpu.data import generate_ddti_like
from ddti_tpu.data.augment import AugmentConfig as JAugmentConfig
from ddti_tpu.models import blocks as jblocks
from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.parallel import make_mesh as jmake_mesh
from ddti_tpu.train.state import TrainState as JTrainState
from ddti_tpu.train.steps import _build_train_step_impl
from ddti_tpu.train.torch_interop import export_state_dict
from ddti_tpu_torch.data.augment import MixupDraws
from ddti_tpu_torch.parallel import (
    Mesh,
    check_mesh_shape,
    launch_local,
    local_rows,
    parse_mesh_spec,
)
from ddti_tpu_torch.parallel.mesh import make_mesh
from ddti_tpu_torch.train import export as E

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import torch_parallel_workers as W  # noqa: E402
from test_torch_augment import jax_draws  # noqa: E402

SIZE, BATCH = W.SIZE, W.BATCH
STEP_CASES = {  # name: (JAX Config options, one-pass BatchNorm)
    "plain": ({}, True),
    "grad_accum": ({"grad_accum": 2}, True),
    "mixup": ({"use_mixup": True, "mixup_prob": 1.0}, True),
    "bn_exact_variance": ({"bn_exact_variance": True}, False),
}
GRAD64_CASES = ("plain", "mixup", "bn_exact_variance")
KEYS = {name: 3 + i for i, name in enumerate(STEP_CASES)}


def _jax_variables():
    jm = jcreate_model("UNet", base_filters=W.SMALL["base_filters"],
                       depth=W.SMALL["depth"])
    v = jax.jit(lambda k: jm.init({"params": k},
                                  jnp.zeros((1, SIZE, SIZE, 1)),
                                  train=False))(jax.random.PRNGKey(0))
    return jm, v


def _mix_draws(key, n, prob=1.0, alpha=0.2):
    """JAX ``mixup``'s draws from its key layout, as ``MixupDraws``."""
    k_gate, k_lam, k_perm = jax.random.split(key, 3)
    on = float(jax.random.uniform(k_gate)) < prob
    lam = float(jax.random.beta(k_lam, alpha, alpha)) if on else 1.0
    return MixupDraws(torch.tensor(lam, dtype=torch.float32),
                      torch.from_numpy(np.array(
                          jax.random.permutation(k_perm, n))).long())


@pytest.fixture(scope="module")
def setup():
    jm, v = _jax_variables()
    weights = {k: np.ascontiguousarray(a) for k, a in export_state_dict(
        "UNet", v["params"], v["batch_stats"]).items()}
    im, ma = generate_ddti_like(BATCH, (SIZE, SIZE), 0)
    acfg = JAugmentConfig(fast_warp=True, out_size=(SIZE, SIZE))
    cases = {}
    for name, (opts, _) in STEP_CASES.items():
        key = jax.random.PRNGKey(KEYS[name])
        k_aug, k_mix, _ = jax.random.split(key, 3)
        cfg = {k: o for k, o in opts.items()}
        mix = (_mix_draws(k_mix, BATCH) if opts.get("use_mixup") else None)
        cases[name] = dict(weights=weights, images=im, masks=ma,
                           draws=jax_draws(k_aug, BATCH, acfg), mix=mix,
                           config=cfg)
    cases["qat"] = dict(cases["plain"], config={"qat": True})
    for name in GRAD64_CASES:
        cases[f"{name}_f64"] = dict(cases[name], kind="grads64")
    valid = np.ones(BATCH, np.float32)
    valid[12:] = 0.0  # four wraparound-padded duplicates
    cases["eval"] = dict(weights=weights, images=im, masks=ma, valid=valid,
                         kind="eval")
    return jm, v, im, ma, acfg, cases


@pytest.fixture(scope="module")
def ranks(setup, tmp_path_factory):
    """Every case on two gloo ranks, once: {name: rank 0's results} and
    rank 1's."""
    cases = setup[-1]
    tmp = tmp_path_factory.mktemp("dp_steps")
    torch.save(cases, tmp / "in.pt")
    rc = W.bounded(launch_local, W.steps_worker, 2, "cpu",
                   (str(tmp / "in.pt"), str(tmp)))
    assert rc == 0
    return (torch.load(tmp / "rank0.pt", weights_only=False),
            torch.load(tmp / "rank1.pt", weights_only=False))


def _single(case):
    run = {"eval": W.run_eval, "grads64": W.run_grads64}.get(
        case.get("kind"), W.run_step)
    return run(case)


def _normwise(a: dict, b: dict, keys) -> float:
    x = torch.cat([a[k].double().ravel() for k in keys])
    y = torch.cat([b[k].double().ravel() for k in keys])
    return float((x - y).norm() / y.norm())


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_dp_step_matches_single_device(setup, ranks, name):
    """The 2-rank step equals the single-device step on the same global
    batch and draws: loss terms, counts, n, BatchNorm statistics and the
    SGD parameters; both ranks hold the same state."""
    case = setup[-1][name]
    one, dp, dp1 = _single(case), ranks[0][name], ranks[1][name]
    assert dp["terms"][0] == pytest.approx(one["terms"][0], rel=2e-5)
    for a, b in zip(dp["terms"], one["terms"]):
        assert a == pytest.approx(b, rel=2e-5, abs=1e-7)
    assert dp["counts"] == one["counts"]
    assert dp["n"] == one["n"] == BATCH
    run = [k for k in one["state"] if "running_" in k]
    assert _normwise(dp["state"], one["state"], run) < 1e-6
    for k in one["state"]:
        if k not in run:
            np.testing.assert_allclose(dp["state"][k].numpy(),
                                       one["state"][k].numpy(),
                                       rtol=2e-4, atol=1e-6, err_msg=k)
        assert torch.equal(dp["state"][k], dp1["state"][k]), k
    assert dp["terms"] == dp1["terms"] and dp["counts"] == dp1["counts"]


@pytest.mark.parametrize("name", GRAD64_CASES)
def test_dp_gradients_match_single_device_in_float64(setup, ranks, name):
    """The averaged gradients of the 2-rank forward and backward (global
    BatchNorm, the Focal-Tversky sums over the ranks, the gradient
    all-reduce) equal the single device's within 1e-5 normwise, the
    network in float64."""
    case = setup[-1][f"{name}_f64"]
    one, dp = _single(case), ranks[0][f"{name}_f64"]
    keys = list(one["grads"])
    assert sorted(dp["grads"]) == sorted(keys)
    assert _normwise(dp["grads"], one["grads"], keys) < 1e-5


def test_dp_eval_step_counts_match(setup, ranks):
    """The eval step over the ranks' rows: counts weighted by the padding
    mask and summed over the ranks, n the valid images, loss terms the
    global batch's."""
    one, dp = _single(setup[-1]["eval"]), ranks[0]["eval"]
    assert dp["counts"] == one["counts"]
    assert dp["n"] == one["n"] == 12
    for a, b in zip(dp["terms"], one["terms"]):
        assert a == pytest.approx(b, rel=2e-5, abs=1e-7)


def test_dp_qat_ranges_are_global(setup, ranks):
    """--qat: each conv's batch range is maxed over the ranks, so both
    ranks fold the same ranges, and the first conv's (its input is the
    augmented batch itself, bit for bit on both sides) equals the single
    device's exactly. Deeper ranges follow a staircase of roundings that a
    last-bit difference upstream moves by a quantization step; measured
    within 1.4e-2 here, held to 5e-2."""
    one, dp, dp1 = (_single(setup[-1]["qat"]), ranks[0]["qat"],
                    ranks[1]["qat"])
    assert dp["qstats"] == dp1["qstats"]
    assert sorted(dp["qstats"]) == sorted(one["qstats"])
    first = "encoders_0/conv1"  # its input is the augmented batch
    assert dp["qstats"][first] == one["qstats"][first]
    for k, v in one["qstats"].items():
        assert v > 0 and dp["qstats"][k] == pytest.approx(v, rel=5e-2), k


@pytest.fixture(scope="module")
def jax_mesh_steps(setup, eight_devices):
    """JAX's step on a data=2 mesh for every case, with SGD(1e-2), from
    the same variables and keys."""
    jm, v, im, ma, acfg, _ = setup
    mesh = jmake_mesh({"data": 2}, eight_devices[:2])
    rep, dp = NamedSharding(mesh, P()), NamedSharding(mesh, P("data"))
    out = {}
    for name, (opts, fast) in STEP_CASES.items():
        cfg = JConfig(batch_size=BATCH, image_size=SIZE, store_size=SIZE,
                      lr=1e-3, **opts)
        tx = optax.sgd(W.SGD_LR)
        state = JTrainState(step=jnp.zeros((), jnp.int32),
                            params=v["params"], batch_stats=v["batch_stats"],
                            opt_state=tx.init(v["params"]), tx=tx,
                            apply_fn=jm.apply)
        state = jax.device_put(jax.device_get(state), rep)
        jblocks.set_bn_fast_variance(fast)
        try:
            step = jax.jit(_build_train_step_impl(cfg, acfg))
            with mesh:
                new, m = step(state, jax.device_put(jnp.asarray(im), dp),
                              jax.device_put(jnp.asarray(ma), dp),
                              jax.random.PRNGKey(KEYS[name]))
        finally:
            jblocks.set_bn_fast_variance(True)
        out[name] = (export_state_dict("UNet", new.params, new.batch_stats),
                     m)
    return out


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_dp_step_matches_jax_mesh_step(ranks, jax_mesh_steps, name):
    want, jm = jax_mesh_steps[name]
    dp = ranks[0][name]
    assert dp["terms"][0] == pytest.approx(float(jm.loss), rel=2e-5)
    for a, b in zip(dp["counts"], jm.counts):
        assert abs(a - float(b)) <= 2
    run = [k for k in want if "running_" in k]
    assert _normwise(dp["state"], {k: torch.from_numpy(np.asarray(want[k]))
                                   for k in run}, run) < 1e-5
    for k, w in want.items():
        if k not in run:
            np.testing.assert_allclose(dp["state"][k].numpy(),
                                       np.asarray(w), rtol=2e-4, atol=1e-6,
                                       err_msg=k)


# ---------------------------------------------------------------------------
# the mesh, its rows and its refusals
# ---------------------------------------------------------------------------


def test_parse_mesh_spec():
    assert parse_mesh_spec("data=4,model=2") == {"data": 4, "model": 2}
    assert parse_mesh_spec("data=8") == {"data": 8}
    with pytest.raises(ValueError):
        parse_mesh_spec("data=four")
    with pytest.raises(ValueError):
        parse_mesh_spec("")


def test_mesh_wrong_count_raises():
    with pytest.raises(ValueError, match="needs 5 devices, have 8"):
        check_mesh_shape({"data": 5}, 8)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        make_mesh({"data": 2})  # no process group: a world of one
    m = make_mesh({"data": 1}, "cpu")
    assert (m.world, m.rank, m.distributed) == (1, 0, False)


@pytest.mark.parametrize("k", [1, 2, 4])
def test_local_rows_are_each_microbatchs_pieces(k):
    """Rank r's rows are the r-th piece of every global microbatch, in
    microbatch order; together the ranks cover the batch once."""
    meshes = [Mesh({"data": 2}, r, 2) for r in range(2)]
    rows = [local_rows(16, m, k) for m in meshes]
    assert sorted(torch.cat(rows).tolist()) == list(range(16))
    micro = 16 // k
    for r, got in enumerate(rows):
        for i, piece in enumerate(got.view(k, -1)):
            lo = i * micro + r * micro // 2
            assert piece.tolist() == list(range(lo, lo + micro // 2))
    with pytest.raises(ValueError, match="must divide evenly"):
        local_rows(15, meshes[0])
    with pytest.raises(ValueError, match="grad_accum 16"):
        local_rows(16, meshes[0], 16)


# ---------------------------------------------------------------------------
# sharded serving bundles
# ---------------------------------------------------------------------------


def _tiny_model(seed=0):
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    return init_like_flax(create_model("UNet", **W.SMALL), seed).eval()


def test_sharded_serving_export_roundtrip(tmp_path):
    """export_serving_sharded: a program at the per-device batch 8 with
    nr_devices 2 recorded; loaded over two CPU devices it serves the
    global batch of 16, masks equal to the single-device bundle's; the
    card's lone GPU (or too few devices) raises JAX's message."""
    model = _tiny_model()
    x, _ = generate_ddti_like(16, (SIZE, SIZE), 3)
    prog, svars = E.export_serving_sharded(model, 2, 16, SIZE)
    path = str(tmp_path / "m_serving_sharded.pt2")
    E.save_bundle(path, prog, svars, nr_devices=2)
    fn, batch, size, _ = E.load_serving_bundle(path, device="cpu",
                                               devices=["cpu", "cpu"])
    assert (batch, size) == (16, SIZE)
    got = fn(x).numpy()
    one_prog, one_vars = E.export_serving_program(model, 16, SIZE)
    E.save_bundle(str(tmp_path / "one.pt2"), one_prog, one_vars)
    want_fn, one_batch, _, _ = E.load_serving_bundle(str(tmp_path / "one.pt2"),
                                                     device="cpu")
    assert one_batch == 16
    np.testing.assert_array_equal(got, want_fn(x).numpy())
    with pytest.raises(ValueError, match="needs 2 devices; only 1"):
        E.load_serving_bundle(path, device="cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="must divide evenly"):
        E.export_serving_sharded(model, 3, 16, SIZE)


def test_int8_sharded_serving_export(tmp_path):
    """export_serving_int8_sharded: the int8 program over two CPU devices,
    masks equal to the single-device int8 bundle's (the same calibration
    batch, so the same tables)."""
    from ddti_tpu_torch.train.quantize import (
        export_serving_int8,
        export_serving_int8_sharded,
    )

    model = _tiny_model(1)
    im, _ = generate_ddti_like(16, (SIZE, SIZE), 5)
    calib = torch.from_numpy(im.astype(np.float32) / 255.0)
    prog, svars = export_serving_int8_sharded(model, 2, 16, SIZE,
                                              calib_images=calib)
    E.save_bundle(str(tmp_path / "q.pt2"), prog, svars, nr_devices=2)
    fn, batch, _, _ = E.load_serving_bundle(str(tmp_path / "q.pt2"),
                                            device="cpu")
    assert batch == 16 and any(k.startswith("quant/") for k in svars)
    one, one_vars = export_serving_int8(model, 16, SIZE, calib_images=calib)
    E.save_bundle(str(tmp_path / "q1.pt2"), one, one_vars)
    want, _, _, _ = E.load_serving_bundle(str(tmp_path / "q1.pt2"),
                                          device="cpu")
    np.testing.assert_array_equal(fn(calib).numpy(), want(calib).numpy())


def test_infer_cli_sharded_bundle(tmp_path):
    """The infer CLI serves a sharded bundle with a partial batch: 3
    frames through a program of 4 a device over 2 devices."""
    from PIL import Image

    from ddti_tpu_torch.cli.infer import main as infer_main

    prog, svars = E.export_serving_sharded(_tiny_model(), 2, 8, SIZE)
    path = str(tmp_path / "m_serving_program.pt2")
    E.save_bundle(path, prog, svars, nr_devices=2)
    ind = tmp_path / "imgs"
    ind.mkdir()
    rng = np.random.default_rng(0)
    for i in range(3):
        Image.fromarray(rng.integers(0, 255, (SIZE, SIZE), dtype=np.uint8),
                        "L").save(str(ind / f"f{i}.png"))
    out = tmp_path / "preds"
    assert infer_main(["--checkpoint", path, "--input_dir", str(ind),
                       "--output_dir", str(out), "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == [f"f{i}_pred.png" for i in range(3)]


# ---------------------------------------------------------------------------
# the Trainer and the CLI on two ranks
# ---------------------------------------------------------------------------


def test_cli_mesh_flag_end_to_end(tmp_path, capfd):
    """python -m ddti_tpu_torch.cli.main --device cpu --mesh data=2
    --export_serving --serving_dtype bf16: the Trainer on two gloo ranks
    trains, validates and tests; one run directory (rank 0's) whose log
    names the mesh; [PARAMS] and [KERNELS] printed once; the sharded bundle
    records 2 devices and serves a global batch of 8 with the masks of the
    same weights' single-device bundle (JAX's
    test_trainer_end_to_end_on_mesh and test_cli_mesh_flag_end_to_end)."""
    from ddti_tpu_torch.cli import main as tmain

    rc = W.bounded(tmain.main, [
        "--mode", "both", "--synthetic", "--epochs", "1", "--image_size",
        str(SIZE), "--store_size", str(SIZE), "--model_type", "UNet",
        "--base_filters", "8", "--depth", "3", "--batch_size", "8", "--lr",
        "1e-3", "--device", "cpu", "--mesh", "data=2", "--export_serving",
        "--serving_dtype", "bf16", "--base_dir", str(tmp_path)])
    assert rc == 0
    (run,) = tmp_path.iterdir()
    log = (run / "log" / "train_log.log").read_text()
    assert "Using explicit mesh {'data': 2} over 2 devices" in log
    assert "Test Metrics" in log
    printed = capfd.readouterr().out
    assert printed.count("[PARAMS] UNet,") == 1
    assert printed.count("[KERNELS] edt_minplus=0 ") == 1
    assert printed.count("Test Metrics") == 1
    models = run / "models"
    assert (models / "UNet_best.npz").is_file()
    assert (run / "result" / "test_metrics.json").is_file()
    spath = models / "UNet_serving_sharded.pt2"
    assert (models / "UNet_serving_sharded.npz").is_file()
    fn, batch, size, _ = E.load_serving_bundle(str(spath), device="cpu")
    assert (batch, size) == (8, SIZE)
    x = np.random.default_rng(0).integers(0, 256, (8, SIZE, SIZE, 1),
                                          dtype=np.uint8)
    got = fn(x)
    assert got.shape == (8, SIZE, SIZE, 1) and got.dtype == torch.uint8
    want, _, _, _ = E.load_serving_bundle(
        str(models / "UNet_serving_program.pt2"), device="cpu")
    np.testing.assert_array_equal(got.numpy(), want(x).numpy())


@pytest.mark.parametrize("argv", [
    [], ["--use_data_parallel", "False"], ["--use_data_parallel", "true"],
    ["--mesh", "data=4", "--multihost", "--coordinator", "h:1",
     "--num_processes", "4", "--process_id", "3"]])
def test_the_six_flags_parse_as_jaxs(argv):
    """--use_data_parallel (a real boolean, QUIRKS #19), --mesh,
    --multihost, --coordinator, --num_processes and --process_id: JAX's
    names and defaults, the same values from the same command line."""
    from ddti_tpu.cli import main as jmain
    from ddti_tpu_torch.cli import main as tmain

    keys = ("use_data_parallel", "mesh", "multihost", "coordinator",
            "num_processes", "process_id")
    j = vars(jmain.get_parser().parse_args(argv))
    t = vars(tmain.get_parser().parse_args(argv))
    assert {k: t[k] for k in keys} == {k: j[k] for k in keys}
