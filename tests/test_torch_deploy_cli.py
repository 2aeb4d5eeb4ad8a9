"""The deployment surface end to end on the CPU, tiny: ``cli/export.py``
(batch lists, an ensemble), ``cli/quantize.py`` (``--min_channels 0`` and
``auto``, QAT ranges and ``--no_qstats``), ``cli/infer.py`` on a bundle
(the same masks as on the live checkpoint), the daemon serving a
two-program int8 set and reloading it, the training CLI's ``--qat
--export_serving --serving_dtype int8 --serving_batches``, ``cli/
average.py``'s range merge, and the library API (``fit`` -> ``save`` /
``export_serving`` -> ``load``).
"""

import io
import json
import os
import threading
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

import ddti_tpu_torch.api as ddti
from ddti_tpu_torch.cli import average as tavg
from ddti_tpu_torch.cli import export as texport
from ddti_tpu_torch.cli import infer as tinfer
from ddti_tpu_torch.cli import main as tmain
from ddti_tpu_torch.cli import quantize as tquant
from ddti_tpu_torch.cli import serve as tserve
from ddti_tpu_torch.models import create_model
from ddti_tpu_torch.train import checkpoint as ck
from ddti_tpu_torch.train import export as E
from ddti_tpu_torch.train.qat import init_qstats
from ddti_tpu_torch.utils.weight_init import init_like_flax

SIZE = 32
ARCH = ["--model_type", "ResUNet", "--base_filters", "4", "--depth", "2",
        "--image_size", str(SIZE), "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(seed):
    return init_like_flax(create_model("ResUNet", in_channels=1,
                                       out_channels=1, base_filters=4,
                                       depth=2), seed).eval()


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Two checkpoints (one with QAT ranges) and a folder of frames."""
    d = tmp_path_factory.mktemp("deploy")
    out = {}
    for seed in (0, 1):
        m = _model(seed)
        qs = None
        if seed == 1:
            qs = {k: 0.5 + i for i, k in enumerate(
                init_qstats(m, (1, 1, SIZE, SIZE)))}
        ck.save_weights(str(d / f"m{seed}"), "ResUNet", m, qstats=qs)
        out[seed] = str(d / f"m{seed}.npz")
    imgs = d / "imgs"
    imgs.mkdir()
    rng = np.random.default_rng(0)
    for i in range(5):
        Image.fromarray(rng.integers(0, 256, (40, 36), dtype=np.uint8)).save(
            imgs / f"f{i}.png")
    out["imgs"], out["dir"] = str(imgs), d
    return out


def _preds(folder):
    return {n: np.asarray(Image.open(os.path.join(folder, n)))
            for n in sorted(os.listdir(folder)) if n.endswith("_pred.png")}


def test_export_cli_writes_a_bundle_per_batch(files, tmp_path):
    out = str(tmp_path / "m")
    assert texport.main(["--checkpoint", files[0], "--output", out,
                         "--batch_size", "2,4", *ARCH]) == 0
    x = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (4, SIZE, SIZE, 1), dtype=np.uint8))
    m = ck.load_checkpoint_into(files[0], "ResUNet", _model(9))
    for bn in (2, 4):
        fn, batch, size, dt = E.load_serving_bundle(
            f"{out}_b{bn}{E.PROGRAM_SUFFIX}", device="cpu")
        assert (batch, size, dt) == (bn, SIZE, torch.uint8)
        assert torch.equal(fn(x[:bn]), E.serve_body(m, x[:bn]))


def test_export_cli_ensemble_and_infer_on_bundles(files, tmp_path):
    """A two-member ensemble bundle predicts what the infer CLI's live
    ensemble of the same checkpoints predicts, image for image; a single
    bundle (``--weights`` given) what its live checkpoint predicts."""
    ens = str(tmp_path / "ens")
    assert texport.main(["--checkpoint", f"{files[0]},{files[1]}",
                         "--output", ens, "--batch_size", "2",
                         "--input_dtype", "f32", *ARCH]) == 0
    one = str(tmp_path / "one")
    assert texport.main(["--checkpoint", files[1], "--output", one,
                         "--batch_size", "4", *ARCH]) == 0
    runs = {
        "live_ens": ["--checkpoint", f"{files[0]},{files[1]}"],
        "bundle_ens": ["--checkpoint", ens + E.PROGRAM_SUFFIX],
        "live_one": ["--checkpoint", files[1]],
        "bundle_one": ["--checkpoint", one + E.PROGRAM_SUFFIX, "--weights",
                       one + "_serving_program.npz"],
    }
    for name, ckpt in runs.items():
        assert tinfer.main([*ckpt, "--input_dir", files["imgs"],
                            "--output_dir", str(tmp_path / name),
                            *ARCH]) == 0
    for a, b in (("live_ens", "bundle_ens"), ("live_one", "bundle_one")):
        pa, pb = _preds(tmp_path / a), _preds(tmp_path / b)
        assert sorted(pa) == sorted(pb) and len(pa) == 5
        for n in pa:
            assert np.array_equal(pa[n], pb[n]), (a, n)


def test_quantize_cli_ranges_calibration_and_auto(files, tmp_path, capsys):
    q = str(tmp_path / "q")
    assert tquant.main(["--checkpoint", files[1], "--output", q,
                        "--batch_size", "1,4", "--min_channels", "0",
                        "--calib_count", "4", *ARCH]) == 0
    said = capsys.readouterr().out
    assert "QAT-learned activation ranges" in said
    fn, *_ = E.load_serving_bundle(f"{q}_b4{E.PROGRAM_SUFFIX}", device="cpu")
    sx = {k: float(v) for k, v in fn.variables.items()
          if k.endswith("/sx")}
    ranges = ck.load_qstats(files[1])
    assert sx and all(sx[f"quant/{p}/sx"] == np.float32(r / 127.0)
                      for p, r in ranges.items())
    c = str(tmp_path / "c")
    assert tquant.main(["--checkpoint", files[1], "--output", c,
                        "--batch_size", "2", "--no_qstats",
                        "--calib_count", "4", *ARCH]) == 0
    assert "calibrating on 4 images" in capsys.readouterr().out
    a = str(tmp_path / "a")
    assert tquant.main(["--checkpoint", files[0], "--output", a,
                        "--batch_size", "2", "--min_channels", "auto",
                        "--calib_count", "2", *ARCH]) == 0
    said = capsys.readouterr().out
    assert "min_channels=0:" in said and "min_channels=128:" in said
    assert "auto: keeping" in said
    assert sorted(os.listdir(tmp_path)).count("a_serving_program.pt2") == 1
    assert not [n for n in os.listdir(tmp_path) if "_mc" in n]
    out = tmp_path / "pred"
    assert tinfer.main(["--checkpoint", f"{q}_b4{E.PROGRAM_SUFFIX}",
                        "--input_dir", files["imgs"], "--output_dir",
                        str(out), *ARCH]) == 0
    assert len(_preds(out)) == 5


def _post(port, frame):
    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, "PNG")
    req = urllib.request.Request(f"http://127.0.0.1:{port}/predict",
                                 data=buf.getvalue(), method="POST")
    return np.asarray(Image.open(io.BytesIO(urllib.request.urlopen(
        req).read())))


def test_daemon_serves_a_two_program_int8_set(files, tmp_path):
    q = str(tmp_path / "q")
    assert tquant.main(["--checkpoint", files[0], "--output", q,
                        "--batch_size", "1,4", "--input_dtype", "uint8",
                        "--calib_count", "4", *ARCH]) == 0
    paths = [f"{q}_b{bn}{E.PROGRAM_SUFFIX}" for bn in (1, 4)]
    args = tserve.get_parser().parse_args([
        "--checkpoint", ",".join(paths), "--device", "cpu", "--port", "0",
        "--max_wait_ms", "200"])
    server = tserve.create_server(args)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    port = server.server_address[1]
    try:
        assert server.batcher.batch_n == 4 and server.size == SIZE
        fn, *_ = E.load_serving_bundle(paths[0], device="cpu")
        rng = np.random.default_rng(5)
        frames = [rng.integers(0, 256, (SIZE, SIZE), dtype=np.uint8)
                  for _ in range(4)]
        got = _post(port, frames[0])  # alone: the batch-1 program
        want = fn(torch.from_numpy(frames[0][None, ..., None]))[0, ..., 0]
        assert np.array_equal(got > 0, want.numpy() > 0)
        out = [None] * 4
        ts = [threading.Thread(target=lambda i=i: out.__setitem__(
            i, _post(port, frames[i]))) for i in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/stats").read())
        assert stats["batches_by_program"]["1"] >= 1
        assert sum(stats["batches_by_program"].values()) == stats["batches"]
        health = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/healthz").read())
        assert health["program_batches"] == [1, 4]
        for i in range(4):
            want = fn(torch.from_numpy(frames[i][None, ..., None]))
            assert np.array_equal(out[i] > 0, want[0, ..., 0].numpy() > 0)
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/reload", data=b"", method="POST")
        assert json.loads(urllib.request.urlopen(req).read())
        stats = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/stats").read())
        assert stats["reloads"] == 1
    finally:
        server.shutdown()
        server.close()


def test_training_cli_qat_exports_an_int8_set(tmp_path, capsys):
    rc = tmain.main(["--mode", "train", "--synthetic", "--device", "cpu",
                     "--base_filters", "4", "--depth", "2", "--image_size",
                     str(SIZE), "--store_size", str(SIZE), "--batch_size",
                     "4", "--epochs", "1", "--qat", "--export_serving",
                     "--serving_dtype", "int8", "--serving_batches", "1,4",
                     "--base_dir", str(tmp_path)])
    assert rc == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert last.startswith("[KERNELS]") and last.endswith("conv_s8=0")
    (run,) = os.listdir(tmp_path)
    models = tmp_path / run / "models"
    names = set(os.listdir(models))
    assert {"ResUNet_b1_serving_program.pt2", "ResUNet_b4_serving_program.pt2",
            "ResUNet_b1_serving_program.npz", "ResUNet_serving.pt2"} <= names
    ranges = ck.load_qstats(str(models / "ResUNet_last.npz"))
    assert ranges and all(v > 0 for v in ranges.values())
    fn1, *_ = E.load_serving_bundle(str(models / (
        "ResUNet_b1" + E.PROGRAM_SUFFIX)), device="cpu")
    fn4, *_ = E.load_serving_bundle(str(models / (
        "ResUNet_b4" + E.PROGRAM_SUFFIX)), device="cpu",
        shared_variables=fn1.variables)
    assert fn4.variables is fn1.variables
    sx = {k[len("quant/"):-len("/sx")]: float(v)
          for k, v in fn1.variables.items() if k.endswith("/sx")}
    assert set(sx) == set(ranges)  # the learned ranges, not calibration
    for p, r in ranges.items():
        assert sx[p] == np.float32(r / 127.0)


def test_average_cli_merges_ranges_by_max(files, tmp_path):
    qs = {k: 3.0 for k in ck.load_qstats(files[1])}
    other = str(tmp_path / "o")
    ck.save_weights(other, "ResUNet", _model(2), qstats=qs)
    out = str(tmp_path / "avg.npz")
    assert tavg.main(["--checkpoints", files[1], other + ".npz", "--output",
                      out, "--recalib_count", "0", *ARCH]) == 0
    merged = ck.load_qstats(out)
    mine = ck.load_qstats(files[1])
    assert merged == {k: max(v, 3.0) for k, v in mine.items()}


def test_api_fit_save_export_load(tmp_path):
    from ddti_tpu_torch.data.synthetic import generate_ddti_like

    im, mk = generate_ddti_like(20, (SIZE, SIZE), 0)
    m = ddti.fit(im, mk, base_filters=4, depth=2, epochs=1, batch_size=4,
                 bf16=False, verbose=False, device="cpu", qat=True,
                 run_dir=str(tmp_path / "run"))
    assert m.qstats and all(v > 0 for v in m.qstats.values())
    pred = m.predict(im)
    assert pred.shape == (20, SIZE, SIZE) and pred.dtype == np.uint8
    back = ddti.load(m.save(str(tmp_path / "w")), base_filters=4, depth=2,
                     image_size=SIZE, bf16=False, device="cpu")
    assert back.qstats == pytest.approx(m.qstats)
    assert np.array_equal(back.predict(im), pred)
    metrics = back.evaluate(im, mk)
    assert 0.0 <= metrics["iou"] <= 1.0
    for dtype in ("f32", "int8"):
        path = m.export_serving(str(tmp_path / dtype), batch=4, dtype=dtype)
        fn, batch, size, dt = E.load_serving_bundle(path, device="cpu")
        assert (batch, size, dt) == (4, SIZE, torch.uint8)
        masks = fn(torch.from_numpy(im[:4])).numpy()[..., 0]
        if dtype == "f32":  # BN folded: a pixel at the threshold may flip
            assert (masks == pred[:4]).mean() >= 0.999
    with pytest.raises(NotImplementedError, match="item 12"):
        ddti.fit(im, mk, mesh="data=2", device="cpu")
    if not torch.cuda.is_available():  # the card unless the caller says cpu
        for call in (lambda: ddti.fit(im, mk, epochs=1),
                     lambda: ddti.load(str(tmp_path / "w.npz"))):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                call()
