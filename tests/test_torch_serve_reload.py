"""The port daemon's reload surface against the JAX daemon's, on the CPU:
``POST /reload`` (and its 400 and 500 answers), ``--watch`` following a
reloaded path, ``GET /metrics`` under the JAX daemon's names for the same
live ``.npz``, ``/stats``' keys, and ``/predict``'s native and PIL decodes.
"""

import http.client
import io
import json
import os
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from ddti_tpu.cli import serve as jserve
from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.train.checkpoint import save_params_npz
from ddti_tpu_torch.cli import serve as tserve
from ddti_tpu_torch.runtime import native

ARGS = ["--model_type", "ResUNet", "--base_filters", "4", "--depth", "2",
        "--image_size", "32", "--batch_size", "2", "--port", "0"]


def _npz(path, seed):
    jm = jcreate_model("ResUNet", in_channels=1, out_channels=1,
                       base_filters=4, depth=2)
    v = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros((1, 32, 32, 1)),
                                  train=False))(jax.random.PRNGKey(seed))
    # the head starts at zero (all logits 0): a random one, so that the
    # masks are mixed and two seeds' masks differ
    rng = np.random.default_rng(seed)
    params = jax.tree.map(np.asarray, v["params"])
    k = params["final_conv"]["kernel"]
    params["final_conv"]["kernel"] = rng.normal(0, 1, k.shape).astype(
        np.float32)
    save_params_npz(str(path), params, v["batch_stats"])
    return str(path)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs beside other workers' tests."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("reload")
    return _npz(d / "a.npz", 1), _npz(d / "b.npz", 2)


def _jpeg(seed=0, size=(40, 36)):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size[1], 0:size[0]]
    frame = (120 + 80 * np.sin(xx / 4.0) * np.cos(yy / 6.0)
             + rng.normal(0, 25, xx.shape)).clip(0, 255).astype(np.uint8)
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


def _server(*argv, jax_side=False):
    mod = jserve if jax_side else tserve
    extra = ["--compilation_cache", "off"] if jax_side else ["--device",
                                                             "cpu"]
    srv = mod.create_server(mod.get_parser().parse_args([*argv, *extra,
                                                         *ARGS]))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t


def _stop(srv, t):
    srv.shutdown()
    srv.close()
    t.join(timeout=10)


def _mask(srv, body):
    resp, data = _request(srv, "POST", "/predict?format=raw", body)
    assert resp.status == 200, data
    return np.frombuffer(data, np.uint8)


def _want(ckpt, frame):
    """The mask the live model gives one decoded (32, 32, 1) frame, at the
    frame's original size (what /predict answers, raw)."""
    predict = tserve.load_predictor(tserve.get_parser().parse_args(
        ["--checkpoint", ckpt, "--device", "cpu", *ARGS]))[0]
    return predict(np.stack([frame, frame]))[0]


def test_reload_swaps_the_model_and_refuses_bad_requests(ckpts):
    a, b = ckpts
    srv, t = _server("--checkpoint", a)
    try:
        body = _jpeg()
        before = _mask(srv, body)
        resp, data = _request(srv, "POST", "/reload",
                              json.dumps({"checkpoint": b}).encode())
        assert resp.status == 200, data
        out = json.loads(data)
        assert out["status"] == "reloaded" and out["checkpoint"] == b
        assert out["batch"] == 2 and out["model"] == "ResUNet"
        after = _mask(srv, body)
        assert not np.array_equal(before, after)
        frame = native.decode_jpeg_bytes(body, 32, 32)[0]
        small = np.asarray(Image.fromarray(_want(b, frame)[..., 0] * 255)
                           .resize((40, 36), Image.NEAREST))
        np.testing.assert_array_equal(after.reshape(36, 40), small)
        # a bare POST reads the current path again
        assert _request(srv, "POST", "/reload")[0].status == 200
        stats = json.loads(_request(srv, "GET", "/stats")[1])
        assert stats["reloads"] == 2
        assert stats["batches_by_program"] == {"2": 2}
        for bad in (b"[1, 2]", b"{not json"):
            resp, data = _request(srv, "POST", "/reload", bad)
            assert resp.status == 400, bad
            assert "bad reload request" in json.loads(data)["error"]
        resp, data = _request(srv, "POST", "/reload", json.dumps(
            {"checkpoint": a + ".missing"}).encode())
        assert resp.status == 500
        assert "reload failed" in json.loads(data)["error"]
        assert srv.args.checkpoint == b  # refused reloads change nothing
        assert json.loads(_request(srv, "GET", "/stats")[1])["reloads"] == 2
        np.testing.assert_array_equal(_mask(srv, body), after)
    finally:
        _stop(srv, t)


def test_reload_under_concurrent_traffic(ckpts):
    """Eight clients POST across two swaps: every request answers 200, and
    /stats counts them all."""
    a, b = ckpts
    srv, t = _server("--checkpoint", a, "--max_wait_ms", "2")
    errors, done = [], []
    body = _jpeg(1)

    def client():
        for _ in range(6):
            resp, data = _request(srv, "POST", "/predict", body)
            (done if resp.status == 200 else errors).append(resp.status)

    try:
        threads = [threading.Thread(target=client) for _ in range(8)]
        for th in threads:
            th.start()
        for ck in (b, a):
            resp, _ = _request(srv, "POST", "/reload",
                               json.dumps({"checkpoint": ck}).encode())
            assert resp.status == 200
        for th in threads:
            th.join(timeout=120)
        assert errors == [] and len(done) == 48
        stats = json.loads(_request(srv, "GET", "/stats")[1])
        assert stats["requests"] == 48 and stats["errors"] == 0
        assert stats["reloads"] == 2
    finally:
        _stop(srv, t)


def _wait(cond, timeout=20.0):
    deadline = time.time() + timeout
    while not cond() and time.time() < deadline:
        time.sleep(0.05)
    return cond()


def test_watch_follows_the_reloaded_path(ckpts, tmp_path):
    """--watch 0.2: a rewritten checkpoint reloads; after POST /reload
    onto a new path the watch follows it, and a checkpoint missing when
    the watch started is loaded once it is written."""
    a, b = ckpts
    live = tmp_path / "live.npz"
    live.write_bytes(open(a, "rb").read())
    srv, t = _server("--checkpoint", str(live), "--watch", "0.2")
    try:
        body = _jpeg(2)
        first = _mask(srv, body)
        time.sleep(0.05)
        live.write_bytes(open(b, "rb").read())
        os.utime(live, (time.time() + 5, time.time() + 5))
        assert _wait(lambda: srv.n_reloads >= 1)
        assert not np.array_equal(_mask(srv, body), first)
        moved = tmp_path / "moved.npz"
        moved.write_bytes(open(a, "rb").read())
        resp, _ = _request(srv, "POST", "/reload", json.dumps(
            {"checkpoint": str(moved)}).encode())
        assert resp.status == 200 and srv.n_reloads == 2
        np.testing.assert_array_equal(_mask(srv, body), first)
        time.sleep(0.8)  # the watch does not load again what /reload did
        assert srv.n_reloads == 2
        moved.write_bytes(open(b, "rb").read())
        os.utime(moved, (time.time() + 10, time.time() + 10))
        assert _wait(lambda: srv.n_reloads >= 3)
        live.write_bytes(open(a, "rb").read())  # the old path: not watched
        os.utime(live, (time.time() + 20, time.time() + 20))
        time.sleep(0.8)
        assert srv.n_reloads == 3
    finally:
        _stop(srv, t)
    late = tmp_path / "late.npz"
    late.write_bytes(open(a, "rb").read())
    srv, t = _server("--checkpoint", str(late))
    try:
        late.unlink()
        srv.start_watcher(0.2)
        time.sleep(0.5)
        assert srv.n_reloads == 0
        late.write_bytes(open(b, "rb").read())
        assert _wait(lambda: srv.n_reloads == 1)
    finally:
        _stop(srv, t)


def _metric_names(text):
    names, types = set(), set()
    for line in text.splitlines():
        if line.startswith("# TYPE"):
            types.add(tuple(line.split()[2:]))
        elif line:
            names.add(line.rsplit(" ", 1)[0])
    return names, types


def test_metrics_and_stats_match_the_jax_daemon(ckpts):
    """The same .npz served by both daemons, one JPEG POSTed to each and
    one reload: /metrics has the JAX daemon's series (names, labels, TYPE
    lines) and parses as Prometheus text; /stats has JAX's keys."""
    a, _ = ckpts
    body = _jpeg(3)
    pages, stats = [], []
    for jax_side in (True, False):
        srv, t = _server("--checkpoint", a, jax_side=jax_side)
        try:
            assert _request(srv, "POST", "/predict", body)[0].status == 200
            assert _request(srv, "POST", "/reload")[0].status == 200
            resp, data = _request(srv, "GET", "/metrics")
            assert resp.status == 200
            assert resp.getheader("Content-Type").startswith("text/plain")
            pages.append(data.decode())
            stats.append(json.loads(_request(srv, "GET", "/stats")[1]))
        finally:
            _stop(srv, t)
    jnames, jtypes = _metric_names(pages[0])
    tnames, ttypes = _metric_names(pages[1])
    assert tnames == jnames and ttypes == jtypes
    assert 'ddti_program_batches_total{batch="2"}' in tnames
    for line in pages[1].splitlines():
        if line and not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])
    assert "ddti_reloads_total 1" in pages[1]
    assert "ddti_requests_total 1" in pages[1]
    assert sorted(stats[1]) == sorted(stats[0])


def test_predict_decodes_jpegs_natively_and_falls_back_to_pil(
        ckpts, monkeypatch):
    """A JPEG decodes through decode_jpeg_bytes (/healthz says so), a PNG
    through PIL, and a JPEG the native decode refuses falls to PIL for
    that request; each answer is the live model's mask of that decode."""
    a, _ = ckpts
    srv, t = _server("--checkpoint", a)
    try:
        health = json.loads(_request(srv, "GET", "/healthz")[1])
        assert health["native_decode"] is native.decode_available()
        assert health["native_decode"], native.decode_available_reason()
        body = _jpeg(4, size=(53, 41))
        pil = np.asarray(Image.open(io.BytesIO(body)).convert("L").resize(
            (32, 32), Image.BILINEAR), np.uint8)[..., None]
        nat = native.decode_jpeg_bytes(body, 32, 32)[0]
        assert np.abs(nat.astype(int) - pil).max() <= 1

        def at_size(m):
            return np.asarray(Image.fromarray(m[..., 0] * 255).resize(
                (53, 41), Image.NEAREST)).ravel()

        np.testing.assert_array_equal(_mask(srv, body), at_size(_want(a, nat)))
        png = io.BytesIO()
        Image.open(io.BytesIO(body)).convert("L").save(png, "PNG")
        np.testing.assert_array_equal(_mask(srv, png.getvalue()),
                                      at_size(_want(a, pil)))
        calls = []

        def refuse(data, h, w):
            calls.append(len(data))
            raise ValueError("native JPEG decode failed")

        monkeypatch.setattr(native, "decode_jpeg_bytes", refuse)
        np.testing.assert_array_equal(_mask(srv, body),
                                      at_size(_want(a, pil)))
        assert calls == [len(body)]
        stats = json.loads(_request(srv, "GET", "/stats")[1])
        assert stats["errors"] == 0 and stats["requests"] == 3
    finally:
        _stop(srv, t)


def test_reload_keeps_tta_fold_bn_and_bf16(ckpts):
    """A reload rebuilds the model with the daemon's --tta, --fold_bn
    (checked against the unfolded model at load) and --bf16: /healthz
    still reports them, and the mask of a frame after the swap is
    serve_body's with the same options on the new weights."""
    import torch

    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
    from ddti_tpu_torch.train.export import serve_body
    from ddti_tpu_torch.train.fold_bn import fold_batchnorm

    a, b = ckpts
    srv, t = _server("--checkpoint", a, "--tta", "--fold_bn", "--bf16")
    try:
        body = _jpeg(5, size=(32, 32))
        resp, _ = _request(srv, "POST", "/reload",
                           json.dumps({"checkpoint": b}).encode())
        assert resp.status == 200
        health = json.loads(_request(srv, "GET", "/healthz")[1])
        assert health["tta"] is True and health["fold_bn"] is True
        got = _mask(srv, body).reshape(32, 32)
        frame = native.decode_jpeg_bytes(body, 32, 32)[0]
        model = fold_batchnorm(load_checkpoint_into(
            b, "ResUNet", create_model("ResUNet", in_channels=1,
                                       out_channels=1, base_filters=4,
                                       depth=2)), "ResUNet").eval()
        x = torch.from_numpy(np.stack([frame, frame]))
        with torch.inference_mode():
            want = serve_body(model, x, compute_dtype=torch.bfloat16,
                              tta=True)[0, ..., 0].numpy()
        np.testing.assert_array_equal(got, want * 255)
    finally:
        _stop(srv, t)
