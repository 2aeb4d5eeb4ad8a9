"""The port's serving daemon (ddti_tpu_torch/cli/serve.py) against the JAX
package's, on the CPU, plus the port's import boundary.

The same small TransUNet checkpoint is served by both daemons on ephemeral
ports; one JPEG POSTed to each must come back as the same mask, except at
pixels whose logit lies within 1e-3 of the threshold.
"""

import ast
import http.client
import io
import json
import pathlib
import subprocess
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ddti_tpu.cli import serve as jserve
from ddti_tpu.models import create_model as jax_create_model
from ddti_tpu.train.torch_interop import save_pth
from ddti_tpu_torch.cli import serve as tserve
from ddti_tpu_torch.models import create_model
from ddti_tpu_torch.train.checkpoint import load_checkpoint_into

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(base_filters=8, depth=3, image_size=64)
ARGS = ["--model_type", "TransUNet", "--base_filters", "8", "--depth", "3",
        "--image_size", "64", "--batch_size", "2", "--port", "0"]


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    jm = jax_create_model("TransUNet", **SMALL)
    v = jm.init({"params": jax.random.PRNGKey(3)},
                jnp.zeros((1, 64, 64, 1)), train=False)
    path = str(tmp_path_factory.mktemp("serve") / "w.pth")
    save_pth(path, "TransUNet", v["params"], v["batch_stats"])
    return path


def _jpeg(seed=0):
    rng = np.random.default_rng(seed)
    frame = rng.integers(0, 256, (64, 64), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(frame, "L").save(buf, "JPEG")
    return buf.getvalue()


def _request(server, method, path, body=None):
    conn = http.client.HTTPConnection("127.0.0.1",
                                      server.server_address[1], timeout=60)
    conn.request(method, path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    conn.close()
    return resp, data


def _serving(server):
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    return t


def _stop(server, t):
    server.shutdown()
    server.close()
    t.join(timeout=10)


def test_port_daemon_matches_jax_daemon(pth):
    jsrv = jserve.create_server(jserve.get_parser().parse_args(
        ["--checkpoint", pth, "--compilation_cache", "off", *ARGS]))
    tsrv = tserve.create_server(tserve.get_parser().parse_args(
        ["--checkpoint", pth, "--device", "cpu", *ARGS]))
    threads = [_serving(jsrv), _serving(tsrv)]
    try:
        body = _jpeg()
        masks = []
        for srv in (jsrv, tsrv):
            resp, data = _request(srv, "POST", "/predict", body)
            assert resp.status == 200
            assert resp.getheader("Content-Type") == "image/png"
            masks.append(np.asarray(Image.open(io.BytesIO(data))))
        assert masks[1].shape == (64, 64)
        assert set(np.unique(masks[1])) <= {0, 255}

        # the logits of the decoded frame decide which pixels may differ
        frame = np.asarray(Image.open(io.BytesIO(body)).convert("L"))
        m = load_checkpoint_into(pth, "TransUNet",
                                 create_model("TransUNet", **SMALL)).eval()
        with torch.inference_mode():
            logits = m(torch.tensor(frame).float()[None, None] / 255.0)
        differ = masks[0] != masks[1]
        assert np.all(np.abs(logits[0, 0].numpy()[differ]) < 1e-3)

        resp, raw = _request(tsrv, "POST", "/predict?format=raw", body)
        assert resp.status == 200
        assert (resp.getheader("X-Height"), resp.getheader("X-Width")) \
            == ("64", "64")
        np.testing.assert_array_equal(
            np.frombuffer(raw, np.uint8).reshape(64, 64), masks[1])

        resp, data = _request(tsrv, "GET", "/healthz")
        health = json.loads(data)
        assert health["status"] == "ok" and health["model"] == "TransUNet"
        assert health["batch"] == 2 and health["size"] == 64
        resp, data = _request(tsrv, "GET", "/stats")
        stats = json.loads(data)
        assert stats["requests"] == 2 and stats["images"] == 2
        assert stats["errors"] == 0
        assert 0 < stats["latency_p50_ms"] <= stats["latency_p99_ms"]
        resp, data = _request(tsrv, "POST", "/predict", b"not an image")
        assert resp.status == 400
        resp, _ = _request(tsrv, "GET", "/nope")
        assert resp.status == 404
    finally:
        for srv, t in zip((jsrv, tsrv), threads):
            _stop(srv, t)


def test_batcher_direct():
    """Batcher semantics without HTTP: identity predictor, padded tails,
    error propagation, clean close."""
    calls = []

    def predict(x):
        calls.append(x.shape)
        return x

    b = tserve.Batcher(predict, batch_n=4, max_wait_ms=1.0)
    a = np.full((8, 8, 1), 7, np.uint8)
    out = b.submit(a)
    assert np.array_equal(out, a)
    assert calls == [(4, 8, 8, 1)]  # padded to the fixed batch

    def boom(x):
        raise RuntimeError("device on fire")

    b2 = tserve.Batcher(boom, batch_n=2, max_wait_ms=1.0)
    with pytest.raises(RuntimeError, match="device on fire"):
        b2.submit(a)
    b.close()
    b2.close()
    assert not b._thread.is_alive() and not b2._thread.is_alive()


def test_device_cuda_without_cuda_raises(pth):
    if torch.cuda.is_available():
        pytest.skip("this box has CUDA")
    args = tserve.get_parser().parse_args(["--checkpoint", pth, *ARGS])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tserve.create_server(args)


def test_port_imports_no_jax():
    """At run time: importing every module of the port (the serving and
    training entry points among them) loads neither JAX nor the JAX
    package nor its probes (benchmarks/). In the source: no module of the
    port (nor chip_smoke.py) names them in an import, lazy ones
    included."""
    modules = sorted(
        ".".join(f.relative_to(ROOT).with_suffix("").parts)
        for f in (ROOT / "ddti_tpu_torch").rglob("*.py")
        if f.name != "__init__.py")
    assert "ddti_tpu_torch.cli.main" in modules
    # the legacy zoo and the experiment tools among them
    assert {f"ddti_tpu_torch.{m}" for m in (
        "models.legacy", "models.mores", "cli.params", "cli.split_config",
        "cli.sweep", "cli.aggregate", "cli.split_data", "cli.prepare",
        "cli.preview")} <= set(modules)
    # the host data path: the PIL/cv2 chain and the native loader's binding
    assert {"ddti_tpu_torch.data.host_transforms",
            "ddti_tpu_torch.runtime.native"} <= set(modules)
    # the rest of single-device training: distillation, the range test,
    # the measured batch pick
    assert {f"ddti_tpu_torch.train.{m}" for m in (
        "distill", "lr_finder", "autobatch")} <= set(modules)
    # data parallelism: the mesh, its collectives and the launch
    assert {"ddti_tpu_torch.parallel.mesh",
            "ddti_tpu_torch.parallel.multihost"} <= set(modules)
    code = (f"import sys, {', '.join(modules)}; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'ddti_tpu', 'benchmarks')); "
            "assert not bad, bad")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
    files = sorted((ROOT / "ddti_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    for f in files:
        for node in ast.walk(ast.parse(f.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in ("jax", "jaxlib", "flax",
                                               "ddti_tpu", "benchmarks"), \
                    (f, n)


def test_daemon_tta_fold_bn_masks_equal_serve_body(pth):
    """``--tta --fold_bn``: /healthz reports both, and a POSTed JPEG comes
    back as ``serve_body(fold_batchnorm(model), frame, tta=True)``'s mask
    of the frame as the daemon decodes and resizes it (natively where the
    library has libjpeg, as JAX's daemon does), resized back to the
    frame."""
    from ddti_tpu_torch.train.export import serve_body
    from ddti_tpu_torch.train.fold_bn import fold_batchnorm

    srv = tserve.create_server(tserve.get_parser().parse_args(
        ["--checkpoint", pth, "--device", "cpu", "--tta", "--fold_bn",
         *ARGS]))
    t = _serving(srv)
    try:
        health = json.loads(_request(srv, "GET", "/healthz")[1])
        assert health["tta"] is True and health["fold_bn"] is True
        for seed, size in ((0, (64, 64)), (1, (90, 50))):
            img = Image.open(io.BytesIO(_jpeg(seed))).convert("L")
            buf = io.BytesIO()
            img.resize(size).save(buf, "JPEG")
            body = buf.getvalue()
            resp, data = _request(srv, "POST", "/predict", body)
            assert resp.status == 200
            got = np.asarray(Image.open(io.BytesIO(data)))
            frame = Image.open(io.BytesIO(body)).convert("L")
            if srv.native_decode:  # the daemon decodes a JPEG natively
                from ddti_tpu_torch.runtime.native import decode_jpeg_bytes

                x = decode_jpeg_bytes(body, 64, 64)[0][None]
            else:
                x = np.asarray(frame.resize((64, 64), Image.BILINEAR),
                               np.uint8)[None, ..., None]
            model = fold_batchnorm(load_checkpoint_into(
                pth, "TransUNet", create_model("TransUNet", **SMALL)))
            with torch.inference_mode():
                mask = serve_body(model.eval(), torch.from_numpy(x),
                                  tta=True)[0, ..., 0].numpy()
            want = np.asarray(Image.fromarray(mask * 255).resize(
                frame.size, Image.NEAREST))
            assert got.shape == (size[1], size[0])
            np.testing.assert_array_equal(got, want)
    finally:
        _stop(srv, t)
    plain = tserve.load_predictor(tserve.get_parser().parse_args(
        ["--checkpoint", pth, "--device", "cpu", *ARGS]))[3]
    assert plain["tta"] is False and plain["fold_bn"] is False


def test_overlay_equals_jax_overlay_png(pth):
    """``?overlay=1`` answers the frame at its own size with the mask's
    contours in red: JAX's ``_overlay_png`` of the same frame and mask; as
    ``?format=raw`` too, with three channels."""
    srv = tserve.create_server(tserve.get_parser().parse_args(
        ["--checkpoint", pth, "--device", "cpu", *ARGS]))
    t = _serving(srv)
    try:
        img = Image.open(io.BytesIO(_jpeg(2))).convert("L")
        buf = io.BytesIO()
        img.resize((80, 48)).save(buf, "JPEG")
        body = buf.getvalue()
        # an overlay request decodes with PIL, as JAX's daemon does: the
        # mask to draw is the one of the PIL-decoded frame, which the daemon
        # gives for that frame sent as a PNG
        png = io.BytesIO()
        Image.open(io.BytesIO(body)).convert("L").save(png, "PNG")
        _, data = _request(srv, "POST", "/predict", png.getvalue())
        mask = np.asarray(Image.open(io.BytesIO(data)))
        assert 0 < mask.mean() < 255  # a contour to draw
        resp, data = _request(srv, "POST", "/predict?overlay=1", body)
        assert resp.status == 200
        assert resp.getheader("Content-Type") == "image/png"
        got = np.asarray(Image.open(io.BytesIO(data)))
        orig = Image.open(io.BytesIO(body)).convert("L")
        want = jserve._overlay_png(orig, mask)
        assert got.shape == (48, 80, 3)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tserve._overlay_png(orig, mask), want)
        assert np.any(got[..., 0] != got[..., 1])  # red drawn
        resp, raw = _request(srv, "POST", "/predict?overlay=1&format=raw",
                             body)
        assert resp.getheader("X-Channels") == "3"
        np.testing.assert_array_equal(
            np.frombuffer(raw, np.uint8).reshape(48, 80, 3), want)
    finally:
        _stop(srv, t)
