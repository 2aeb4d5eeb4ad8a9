"""The serving bundles of the port (``ddti_tpu_torch/train/export.py``,
``train/checkpoint.py``'s tensor files) on the CPU: ``torch.export``
programs against ``serve_body`` bit for bit (f32 and bf16 compute, TTA,
uint8 and float input, weights as arguments and baked, a TransUNet whose
attention is the registered flash forward, the int8 graph on
``ddti::conv_s8``); an ensemble bundle against JAX's
``export_serving_ensemble`` run through JAX's ``load_serving_bundle``;
a multi-batch set sharing one copy of its tensors; loading without model
code; the ``.npz`` files (``::bf16`` raw bits, ``qstats/`` ranges) read
both ways.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.train import checkpoint as jck
from ddti_tpu.train import export as jexport
from ddti_tpu.train.torch_interop import export_state_dict
from ddti_tpu_torch.models import create_model
from ddti_tpu_torch.train import checkpoint as ck
from ddti_tpu_torch.train import export as E
from ddti_tpu_torch.train import quantize as Q

ROOT = Path(__file__).resolve().parents[1]
SIZE, BATCH = 32, 3
SMALL = dict(in_channels=1, out_channels=1, base_filters=4, depth=2)
TRANS = dict(SMALL, embed_dim=16, num_heads=2, num_transformer_layers=1,
             dropout_rate=0.0, image_size=128)
# JAX's f32 ensemble program vs the port's: the members' float logits
# differ by rounding, so a pixel at the threshold may flip
ENSEMBLE_AGREE = 0.999


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed=0, model_type="ResUNet", kw=SMALL):
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    m = init_like_flax(create_model(model_type, **kw), seed)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():  # BatchNorm statistics away from the identity
        for name, b in m.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.randn(b.shape, generator=g) * 0.2)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    return m.eval()


def _images(n=BATCH, size=SIZE, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        0, 256, (n, size, size, 1), dtype=np.uint8))


def _roundtrip(tmp_path, program, variables, name="b"):
    path = str(tmp_path / (name + E.PROGRAM_SUFFIX))
    E.save_bundle(path, program, variables)
    return E.load_serving_bundle(path, device="cpu")


@pytest.mark.parametrize("tta", [False, True])
@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("input_dtype", [torch.uint8, torch.float32])
def test_program_masks_are_serve_body(tmp_path, bf16, tta, input_dtype):
    m = _model()
    program, v = E.export_serving_program(m, BATCH, SIZE, input_dtype=input_dtype,
                                          bf16=bf16, tta=tta)
    fn, batch, size, dt = _roundtrip(tmp_path, program, v)
    assert (batch, size, dt) == (BATCH, SIZE, input_dtype)
    x = _images()
    if input_dtype != torch.uint8:
        x = x.to(torch.float32) / 255.0
    want = E.serve_body(m, x, compute_dtype=torch.bfloat16 if bf16
                        else torch.float32, tta=tta)
    got = fn(x)
    assert got.dtype == torch.uint8 and torch.equal(got, want)
    assert torch.equal(fn(x.numpy()), want)  # numpy in


def test_baked_program_is_serve_body(tmp_path):
    m = _model(1)
    path = str(tmp_path / "m_serving.pt2")
    E.save_serving(path, m, BATCH, SIZE, input_dtype=torch.uint8,
                   threshold=0.4, fold_bn=True)
    fn, batch, size, _ = E.load_serving_bundle(path, device="cpu")
    assert fn.variables is None and (batch, size) == (BATCH, SIZE)
    x = _images(seed=1)
    from ddti_tpu_torch.train.fold_bn import fold_batchnorm

    want = E.serve_body(fold_batchnorm(m), x, threshold=0.4)
    assert torch.equal(fn(x), want)


def test_transunet_program_calls_the_flash_forward(tmp_path):
    """A 1024-token bottleneck: the program holds ``ddti::flash_fwd`` and
    its masks are serve_body's (flash's plain version on the CPU)."""
    m = _model(2, "TransUNet", TRANS)
    program, v = E.export_serving_program(m, 2, 128, input_dtype=torch.uint8,
                                          bf16=True)
    targets = {str(n.target) for _, g in program.graph_module.named_modules()
               for n in g.graph.nodes}
    assert "ddti.flash_fwd.default" in targets
    fn, *_ = _roundtrip(tmp_path, program, v)
    x = _images(2, 128, seed=2)
    assert torch.equal(fn(x), E.serve_body(m, x,
                                           compute_dtype=torch.bfloat16))


@pytest.mark.parametrize("bf16", [False, True])
def test_int8_program_is_the_quantized_graph(tmp_path, bf16):
    m = _model(3)
    calib = _images(4, seed=3).to(torch.float32) / 255.0
    program, v = Q.export_serving_int8(m, BATCH, SIZE, calib_images=calib,
                                       input_dtype=torch.uint8, bf16=bf16,
                                       min_channels=8)
    targets = {str(n.target) for _, g in program.graph_module.named_modules()
               for n in g.graph.nodes}
    assert "ddti.conv_s8.default" in targets
    fn, *_ = _roundtrip(tmp_path, program, v)
    x = _images(seed=4)
    want = E.serve_body(m, x, compute_dtype=torch.bfloat16 if bf16
                        else torch.float32,
                        apply_fn=lambda t: Q.quantized_apply(m, v, t))
    assert torch.equal(fn(x), want)
    # the int8 tables ride the .npz as int8; stripped kernels are (1,)
    loaded = ck.load_variables_npz(E.weights_path_for(
        str(tmp_path / ("b" + E.PROGRAM_SUFFIX))))
    assert all(t.dtype == torch.int8 for k, t in loaded.items()
               if k.endswith("/wq"))


def test_bf16_weights_halve_the_bundle_and_keep_the_masks(tmp_path):
    """``weights_dtype`` bf16 (JAX ``_cast_floating``): the .npz holds raw
    bf16 bits; the program widens them exactly, so its masks are the
    masks of the model with its weights rounded to bf16 once."""
    m = _model(4)
    p32, v32 = E.export_serving_program(m, BATCH, SIZE, bf16=True)
    p16, v16 = E.export_serving_program(m, BATCH, SIZE, bf16=True,
                                        weights_dtype=torch.bfloat16)
    fn32, *_ = _roundtrip(tmp_path, p32, v32, "f32")
    fn16, *_ = _roundtrip(tmp_path, p16, v16, "bf16")
    with np.load(tmp_path / "f32_serving_program.npz") as a, \
            np.load(tmp_path / "bf16_serving_program.npz") as b:
        floats = [k for k in a.files if a[k].dtype == np.float32]
        assert floats and all(b[k + "::bf16"].nbytes * 2 == a[k].nbytes
                              for k in floats)
    rounded = _model(4)
    rounded.load_state_dict({k: t.to(torch.bfloat16).float()
                             for k, t in m.state_dict().items()})
    x = _images(seed=5)
    assert torch.equal(fn16(x), E.serve_body(rounded, x,
                                             compute_dtype=torch.bfloat16))


def test_ensemble_bundle_matches_jax_export_serving_ensemble(tmp_path):
    """Three members from JAX's initialisations: the port's bundle against
    JAX's StableHLO program loaded by JAX's ``load_serving_bundle``, and
    bit for bit against the port's own member-mean."""
    jm = jcreate_model("ResUNet", **SMALL)
    members, sds = [], []
    for seed in range(3):
        v = jm.init({"params": jax.random.PRNGKey(seed)},
                    jnp.zeros((1, SIZE, SIZE, 1)), train=False)
        rng = np.random.default_rng(seed)
        stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(
            np.float32), v["batch_stats"])
        members.append((v["params"], stats))
        sds.append({k: torch.from_numpy(np.array(a)) for k, a in
                    export_state_dict("ResUNet", v["params"],
                                      stats).items()})
    blob, jvars = jexport.export_serving_ensemble(
        jm, members, BATCH, SIZE, input_dtype=jnp.uint8, threshold=0.45)
    jprog = tmp_path / "j_serving_program.stablehlo"
    jprog.write_bytes(blob)
    jck.save_variables_npz(str(tmp_path / "j_serving_program.npz"), jvars)
    jfn, *_ = jexport.load_serving_bundle(str(jprog))
    x = _images(seed=6)
    want = np.asarray(jfn(x.numpy()))
    model = create_model("ResUNet", **SMALL).eval()
    program, v = E.export_serving_ensemble(model, sds, BATCH, SIZE,
                                           input_dtype=torch.uint8,
                                           threshold=0.45)
    assert all(t.shape[0] == 3 for t in v.values())
    fn, *_ = _roundtrip(tmp_path, program, v)
    got = fn(x)
    assert (got.numpy() == want).mean() >= ENSEMBLE_AGREE

    def probs(sd):
        model.load_state_dict(sd)
        return torch.sigmoid(E.nhwc_logits(model, x.float() / 255.0))

    mean = sum(probs(sd) for sd in sds) / 3
    assert torch.equal(got, (mean > 0.45).to(torch.uint8))


def test_a_batch_set_shares_its_tensors(tmp_path):
    m = _model(5)
    paths = []
    for bn in (1, 4):
        program, v = E.export_serving_program(m, bn, SIZE,
                                              input_dtype=torch.uint8)
        paths.append(str(tmp_path / f"m_b{bn}{E.PROGRAM_SUFFIX}"))
        E.save_bundle(paths[-1], program, v)
    f1, b1, *_ = E.load_serving_bundle(paths[0], device="cpu")
    f4, b4, *_ = E.load_serving_bundle(paths[1], device="cpu",
                                       shared_variables=f1.variables)
    assert (b1, b4) == (1, 4) and f4.variables is f1.variables
    x = _images(4, seed=7)
    assert torch.equal(f4(x)[:1], f1(x[:1]))
    # a set of another model's tensors is not reused
    other, ov = E.export_serving_program(_model(6), 2, SIZE)
    E.save_bundle(str(tmp_path / "o.pt2"), other, {
        k: t[:1] if t.dim() else t for k, t in ov.items()})
    with pytest.raises(ValueError, match="does not hold the tensors"):
        E.load_serving_bundle(str(tmp_path / "o.pt2"), device="cpu")


def test_a_bundle_runs_only_on_the_device_type_it_was_exported_on(
        tmp_path, monkeypatch):
    from ddti_tpu_torch.core import device as D

    program, v = E.export_serving_program(_model(5), 2, SIZE)
    path = str(tmp_path / ("m" + E.PROGRAM_SUFFIX))
    E.save_bundle(path, program, v)
    # past the CUDA check, so the refusal is the bundle's own
    monkeypatch.setattr(D, "resolve_device", lambda name: torch.device(name))
    with pytest.raises(ValueError, match="exported on cpu, not cuda"):
        E.load_serving_bundle(path, device="cuda")
    if not torch.cuda.is_available():
        monkeypatch.undo()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            E.load_serving_bundle(path)


def test_loading_a_bundle_imports_no_model_code(tmp_path):
    m = _model(7, "TransUNet", TRANS)
    calib = _images(2, 128, seed=8).to(torch.float32) / 255.0
    program, v = Q.export_serving_int8(m, 2, 128, calib_images=calib,
                                       input_dtype=torch.uint8)
    path = str(tmp_path / ("q" + E.PROGRAM_SUFFIX))
    E.save_bundle(path, program, v)
    code = ("import sys, numpy as np\n"
            "from ddti_tpu_torch.train.export import load_serving_bundle\n"
            f"fn, b, s, dt = load_serving_bundle({path!r}, device='cpu')\n"
            "out = fn(np.zeros((b, s, s, 1), np.uint8))\n"
            "assert out.shape == (b, s, s, 1), out.shape\n"
            "bad = sorted(m for m in sys.modules if m.startswith("
            "('ddti_tpu_torch.models', 'jax', 'flax', 'ddti_tpu.')))\n"
            "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)


def test_variables_npz_matches_jax_layout(tmp_path):
    """The port's tensor file holds JAX's keys and bytes: bf16 as uint16
    raw bits under ``::bf16``, others as they are; each package reads the
    other's."""
    rng = np.random.default_rng(9)
    a32 = rng.normal(size=(3, 4)).astype(np.float32)
    i8 = rng.integers(-127, 128, (5,)).astype(np.int8)
    tensors = {"params/x": torch.from_numpy(a32).to(torch.bfloat16),
               "quant/c/wq": torch.from_numpy(i8),
               "batch_stats/m": torch.from_numpy(a32)}
    mine = str(tmp_path / "mine.npz")
    ck.save_variables_npz(mine, tensors)
    theirs = str(tmp_path / "theirs.npz")
    jck.save_variables_npz(theirs, {
        "params": {"x": jnp.asarray(a32, jnp.bfloat16)},
        "quant": {"c": {"wq": jnp.asarray(i8)}},
        "batch_stats": {"m": jnp.asarray(a32)}})
    with np.load(mine) as a, np.load(theirs) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert np.array_equal(a[k], b[k]) and a[k].dtype == b[k].dtype
    back = ck.load_variables_npz(theirs)
    for k, t in tensors.items():
        assert back[k].dtype == t.dtype and torch.equal(back[k], t)


def test_qstats_npz_read_both_ways(tmp_path):
    jm = jcreate_model("ResUNet", **SMALL)
    v = jm.init({"params": jax.random.PRNGKey(0)},
                jnp.zeros((1, SIZE, SIZE, 1)), train=False)
    ranges = {"encoders_0/conv1": 1.25, "bottleneck/skip": 0.5}
    jpath = str(tmp_path / "j.npz")
    jck.save_params_npz(jpath, v["params"], v["batch_stats"],
                        qstats={k: np.float32(x) for k, x in ranges.items()})
    assert ck.load_qstats(jpath) == ranges
    m = create_model("ResUNet", **SMALL)
    ck.load_checkpoint_into(jpath, "ResUNet", m)  # the weights load too
    ppath = str(tmp_path / "p.npz")
    ck.save_params_npz(ppath, "ResUNet", m.state_dict(),
                       qstats={k: torch.tensor(x) for k, x in ranges.items()})
    assert jck.load_qstats(ppath) == ranges
    p, s = jck.load_params_npz(ppath, v["params"], v["batch_stats"])
    assert ck.load_qstats(str(tmp_path / "none.pth")) is None
    np.testing.assert_array_equal(
        np.asarray(p["encoders_0"]["conv1"]["kernel"]),
        np.asarray(v["params"]["encoders_0"]["conv1"]["kernel"]))


def test_a_full_state_directory_carries_qstats(tmp_path):
    from ddti_tpu_torch.train.qat import init_qstats
    from ddti_tpu_torch.train.state import TrainState

    state = TrainState(_model(8), 1e-3, 4, model_type="ResUNet")
    state.qstats = init_qstats(state.model, (1, 1, SIZE, SIZE))
    for v in state.qstats.values():
        v.fill_(2.0)
    ck.save_checkpoint(str(tmp_path / "last"), state)
    got = ck.load_qstats(str(tmp_path / "last"))
    assert got == {k: 2.0 for k in state.qstats}


def test_orbax_and_stablehlo_name_the_routes(tmp_path):
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="ddti_tpu.cli.average"):
        ck.read_checkpoint(str(tmp_path / "orbax"))
    from ddti_tpu_torch.cli.infer import check_not_stablehlo

    with pytest.raises(NotImplementedError,
                       match="ddti_tpu_torch.cli.export"):
        check_not_stablehlo(["m_serving_program.stablehlo"])
