"""Online HTTP model server, ported from ``ddti_tpu/cli/serve.py``: a live
checkpoint or ``.pt2`` serving bundles on one CUDA device (or, when asked
for, the CPU).

Concurrent requests coalesce into fixed ``(batch, size, size, 1)`` batches,
padded when sparse, so throughput approaches the offline rate while a lone
request waits at most ``--max_wait_ms`` for batch-mates.

Endpoints:
  GET  /healthz   liveness + model info (JSON), ``native_decode`` among it
  GET  /stats     request/image/batch counters, throughput, latency (JSON)
  GET  /metrics   the same counters in Prometheus exposition format (the
                  JAX daemon's names)
  POST /reload    hot-swap the model or bundle set from the same
                  (rewritten) or a new ``{"checkpoint": path}``: loaded,
                  warmed, then swapped into the batcher at once (a batch
                  already running keeps its program); the train -> serve
                  loop without a restart
  POST /predict   body = raw image bytes (JPEG/PNG/BMP, any size); JPEGs
                  decode through the native libjpeg path of
                  ``runtime/native.py`` where it is built (PIL for the rest,
                  for ``?overlay=1`` and for a JPEG it refuses);
                  response = PNG mask at the ORIGINAL resolution.
                  ``?overlay=1`` returns the original frame (RGB) with the
                  mask's contours drawn in red instead. ``?format=raw``
                  returns raw uint8 bytes (X-Width / X-Height / X-Channels
                  headers) and skips the PNG encoder.

Usage:
  python -m ddti_tpu_torch.cli.serve --checkpoint <.pth|.npz|_last> \
      --model_type TransUNet --base_filters 64 --depth 4 --image_size 512 \
      --batch_size 16 --bf16 [--tta] [--fold_bn] [--watch SECONDS] \
      [--device cuda]

Every model name of ``models.create_model`` serves; ``--config_path``
takes the model YAML a run was trained from (an ImprovedVNet with
``deep_supervision: true`` carries its heads' weights; its main logits
decide the mask). ``--tta`` thresholds the mean probability of the 4-way
flip ensemble (four forwards a batch); ``--fold_bn`` folds every Conv ->
BatchNorm pair into the conv before serving (``train/fold_bn.py``, checked
against the unfolded model at load). ``/healthz`` reports both. A reload
keeps all of these, bf16 and the TF32 flags. ``--watch N`` polls the
checkpoint's mtime every N seconds and reloads when training rewrites it,
following a path that ``/reload`` installed.

``--checkpoint`` may name ``.pt2`` serving bundles (``train/export.py``):
no model code runs, the programs bake their batch, size, threshold, TTA
and precision (f32, bf16 or int8). A comma list of bundles of one model
at several batch sizes is served as one set: each flush runs through the
smallest program that holds it (``/stats`` counts ``batches_by_program``),
and the set holds one copy of the weights on the device. ``--weights``
names a single bundle's tensors (default: its sibling ``.npz``).
"""

from __future__ import annotations

import argparse
import collections
import copy
import io
import json
import os
import queue
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse


class QueueFull(Exception):
    """Raised by ``Batcher.submit`` when the pending queue is at
    ``max_queue`` — the HTTP layer maps it to 503 + Retry-After."""


class Batcher:
    """Micro-batching executor: requests enqueue single frames; a worker
    thread coalesces up to ``batch_n`` of them (waiting at most
    ``max_wait_ms`` after the first arrival), zero-pads the tail, and runs
    one fixed-shape device program for the whole group.

    ``max_queue`` bounds the pending-frame queue (backpressure): beyond it
    ``submit`` raises :class:`QueueFull` instead of letting latency — and
    one blocked handler thread per request — grow without bound."""

    def __init__(self, predict, batch_n: int, max_wait_ms: float = 5.0,
                 max_queue: int | None = None, small_programs=None):
        self.batch_n = int(batch_n)
        # programs ascending by batch: a sparse flush runs through the
        # smallest that holds it (latency), a full one through the main
        # program (throughput); a reload swaps the set
        self.programs = sorted(
            [(int(bn), fn) for bn, fn in (small_programs or [])
             if int(bn) < self.batch_n]) + [(self.batch_n, predict)]
        self.max_wait = max_wait_ms / 1000.0
        self.max_queue = int(max_queue) if max_queue else 8 * self.batch_n
        self._q: queue.Queue = queue.Queue()
        self._stop = False
        self.lock = threading.Lock()
        self.n_batches = 0
        self.n_images = 0
        self.n_rejected = 0
        self.batches_by_program = {bn: 0 for bn, _ in self.programs}
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ddti-batcher")
        self._thread.start()

    def submit(self, arr):
        """``arr``: (size, size, 1) uint8 frame. Blocks until its mask is
        computed; returns the (size, size, 1) uint8 {0,1} mask. Raises
        :class:`QueueFull` when ``max_queue`` frames are already waiting."""
        if self._q.qsize() >= self.max_queue:
            with self.lock:
                self.n_rejected += 1
            raise QueueFull(
                f"{self._q.qsize()} frames pending (max_queue="
                f"{self.max_queue})")
        ev = threading.Event()
        slot: dict = {}
        self._q.put((arr, ev, slot))
        ev.wait()
        if "error" in slot:
            raise slot["error"]
        return slot["mask"]

    def swap_programs(self, predict, batch_n: int | None = None,
                      small_programs=None) -> None:
        """Replace the serving programs at once (hot reload). A flush
        already running keeps the program it took; the next one takes the
        new set."""
        batch_n = self.batch_n if batch_n is None else int(batch_n)
        programs = sorted(
            [(int(bn), fn) for bn, fn in (small_programs or [])
             if int(bn) < batch_n]) + [(batch_n, predict)]
        with self.lock:
            self.batch_n = batch_n
            self.programs = programs
            for bn, _ in programs:
                self.batches_by_program.setdefault(bn, 0)

    def close(self):
        self._stop = True
        self._q.put(None)
        self._thread.join(timeout=10)

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                if self._stop:
                    return
                continue
            items = [item]
            deadline = time.perf_counter() + self.max_wait
            while len(items) < self.batch_n:
                left = deadline - time.perf_counter()
                if left <= 0:
                    break
                try:
                    nxt = self._q.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:
                    if self._stop:
                        break
                    continue
                items.append(nxt)
            try:
                self._flush(items)
            except BaseException as e:  # the worker must NEVER die —
                # every submit() waits on an Event with no timeout, so an
                # escaped exception here would hang all clients forever
                err = (e if isinstance(e, Exception)
                       else RuntimeError(repr(e)))
                for _, ev, slot in items:
                    if not ev.is_set():
                        slot["error"] = err
                        ev.set()
            if self._stop and self._q.empty():
                return

    def _flush(self, items):
        import numpy as np

        with self.lock:  # snapshot: a concurrent reload may swap the set
            programs = list(self.programs)
        largest = programs[-1][0]
        if len(items) > largest:
            # the set shrank while this flush collected (a reload to
            # smaller batches): split it
            for i in range(0, len(items), largest):
                self._flush(items[i:i + largest])
            return
        bn, predict = next(p for p in programs if p[0] >= len(items))
        x = np.stack([a for a, _, _ in items])
        if len(items) < bn:
            pad = np.zeros((bn - len(items),) + x.shape[1:], x.dtype)
            x = np.concatenate([x, pad])
        try:
            masks = np.asarray(predict(x))[:len(items)]
        except Exception as e:  # surface device errors to every waiter
            for _, ev, slot in items:
                slot["error"] = e
                ev.set()
            return
        with self.lock:
            self.n_batches += 1
            self.n_images += len(items)
            self.batches_by_program[bn] += 1
        for m, (_, ev, slot) in zip(masks, items):
            slot["mask"] = m
            ev.set()


def load_predictor(args):
    """Build the predictor of ``--checkpoint`` on ``--device``.

    Returns ``(predict, batch_n, size, info)`` where ``predict`` maps a
    uint8 ``(batch_n, size, size, 1)`` numpy array to uint8 {0,1} masks of
    the same shape: the largest program of a bundle set."""
    return load_programs(args)[:4]


def load_bundles(args, device):
    """``.pt2`` bundles (a comma list: one model at several batch sizes)
    -> ``(predict, batch_n, size, info, small)`` with ``small`` the
    smaller programs ascending, ``(batch, predict)`` each. The set shares
    one copy of the weights where the programs' tensors match."""
    from ddti_tpu_torch.train.export import load_serving_bundle

    paths = [p for p in args.checkpoint.split(",") if p]
    weights = getattr(args, "weights", None)
    if len(paths) > 1 and weights:
        raise ValueError(
            "--weights applies to a single bundle; with a bundle list each "
            "program loads its sibling .npz")
    loaded = []
    shared = None  # one device copy of the weights across the set
    for p in paths:
        fn, batch_n, size, in_dtype = load_serving_bundle(
            p, weights if len(paths) == 1 else None,
            shared_variables=shared, device=device)
        shared = fn.variables or shared

        def predict(x, _fn=fn):  # a float program's fn scales uint8 itself
            return _fn(x).cpu().numpy()

        loaded.append((batch_n, predict, size, in_dtype))
    loaded.sort(key=lambda t: t[0])
    sizes = {t[2] for t in loaded}
    if len(sizes) != 1:
        raise ValueError(f"bundle image sizes differ: {sorted(sizes)}")
    batches = [t[0] for t in loaded]
    if len(set(batches)) != len(batches):
        raise ValueError(f"duplicate bundle batch sizes: {batches}")
    batch_n, predict, size, in_dtype = loaded[-1]
    info = {"artifact": ",".join(os.path.basename(p) for p in paths),
            "input_dtype": str(in_dtype).replace("torch.", ""),
            "program_batches": batches, "device": str(device)}
    return predict, batch_n, size, info, [(bn, fn) for bn, fn, _, _
                                          in loaded[:-1]]


def load_programs(args):
    """``(predict, batch_n, size, info, small)``: ``.pt2`` bundles through
    ``load_bundles``, anything else the live model (``small`` empty)."""
    import numpy as np
    import torch

    from ddti_tpu_torch.cli.infer import check_not_stablehlo
    from ddti_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    paths = [p for p in args.checkpoint.split(",") if p]
    check_not_stablehlo(paths)
    if all(p.endswith(".pt2") for p in paths):
        return load_bundles(args, device)

    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
    from ddti_tpu_torch.train.export import make_serve_fn

    model_type = args.model_type
    kwargs = dict(in_channels=1, out_channels=1,
                  base_filters=args.base_filters, depth=args.depth)
    if args.config_path:
        from ddti_tpu_torch.core.config import Config

        cfg = Config(model_type=model_type)
        cfg.apply_model_yaml(args.config_path)
        model_type, kwargs = cfg.model_type, cfg.model_kwargs
    if model_type == "TransUNet":
        kwargs.setdefault("image_size", args.image_size)
    model = create_model(model_type, **kwargs)
    load_checkpoint_into(args.checkpoint, model_type, model)
    model = model.to(device)
    if args.fold_bn:
        from ddti_tpu_torch.train.fold_bn import fold_batchnorm

        model = fold_batchnorm(model, model_type)
    serve = make_serve_fn(model, threshold=args.threshold,
                          compute_dtype=(torch.bfloat16 if args.bf16
                                         else torch.float32),
                          tta=args.tta)

    def predict(x):
        out = serve(torch.from_numpy(np.ascontiguousarray(x)).to(device))
        return out.cpu().numpy()

    info = {"model": model_type, **{k: kwargs[k] for k in (
        "base_filters", "depth") if k in kwargs}, "device": str(device),
        "tta": bool(args.tta), "fold_bn": bool(args.fold_bn)}
    return predict, args.batch_size, args.image_size, info, []


def _overlay_png(orig_gray, mask_2d):
    """Red predicted contours (``eval/contours.py`` marching squares) drawn
    on the original grayscale frame: the online twin of the infer CLI's
    --overlay. Returns (H, W, 3) uint8."""
    import numpy as np

    from ddti_tpu_torch.eval.contours import find_contours

    rgb = np.repeat(np.asarray(orig_gray)[..., None], 3, axis=-1).copy()
    for c in find_contours((np.asarray(mask_2d) > 0).astype(np.float32),
                           0.5):
        rr = np.clip(np.round(c[:, 0]).astype(int), 0, rgb.shape[0] - 1)
        cc = np.clip(np.round(c[:, 1]).astype(int), 0, rgb.shape[1] - 1)
        rgb[rr, cc] = (255, 0, 0)
    return rgb


def _quantiles(latencies) -> list:
    """(50, p50), (90, p90), (99, p99) over the recent-latency ring
    (empty list when no requests yet)."""
    if not latencies:
        return []
    s = sorted(latencies)
    return [(q, s[min(len(s) - 1, int(len(s) * q / 100))])
            for q in (50, 90, 99)]


class _Handler(BaseHTTPRequestHandler):
    server_version = "ddti-tpu-torch-serve/1.0"
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *a):  # route access logs through our logger
        if self.server.verbose:  # type: ignore[attr-defined]
            sys.stderr.write("%s - %s\n" % (self.address_string(),
                                            fmt % a))

    def _json(self, code: int, obj) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        srv = self.server
        path = urlparse(self.path).path
        if path == "/healthz":
            health = {"status": "ok", "batch": srv.batcher.batch_n,
                      "size": srv.size, **srv.info,
                      "native_decode": srv.native_decode}
            if not srv.native_decode:
                health["native_decode_absent"] = srv.native_decode_reason
            self._json(200, health)
        elif path == "/stats":
            with srv.stats_lock, srv.batcher.lock:
                n = srv.n_requests
                up = time.perf_counter() - srv.t_start
                self._json(200, {
                    "requests": n,
                    "errors": srv.n_errors,
                    "images": srv.batcher.n_images,
                    "batches": srv.batcher.n_batches,
                    "mean_batch_fill": round(
                        srv.batcher.n_images
                        / max(srv.batcher.n_batches, 1), 3),
                    "uptime_s": round(up, 3),
                    "images_per_sec": round(
                        srv.batcher.n_images / max(up, 1e-9), 3),
                    "mean_latency_ms": round(
                        1e3 * srv.total_latency / max(n, 1), 3),
                    **{f"latency_p{q}_ms": round(1e3 * v, 3)
                       for q, v in _quantiles(srv.recent_latency)},
                    "rejected": srv.batcher.n_rejected,
                    "queue_depth": srv.batcher._q.qsize(),
                    "batches_by_program": {
                        str(bn): n for bn, n in sorted(
                            srv.batcher.batches_by_program.items())},
                    "reloads": srv.n_reloads,
                })
        elif path == "/metrics":
            self._metrics()
        else:
            self._json(404, {"error": f"unknown path {path}"})

    def _metrics(self):
        """GET /metrics: the /stats counters in Prometheus exposition
        format, under the JAX daemon's names."""
        srv = self.server
        with srv.stats_lock, srv.batcher.lock:
            up = time.perf_counter() - srv.t_start
            n = srv.n_requests
            lines = [
                "# TYPE ddti_requests_total counter",
                f"ddti_requests_total {n}",
                "# TYPE ddti_request_errors_total counter",
                f"ddti_request_errors_total {srv.n_errors}",
                "# TYPE ddti_images_total counter",
                f"ddti_images_total {srv.batcher.n_images}",
                "# TYPE ddti_batches_total counter",
                f"ddti_batches_total {srv.batcher.n_batches}",
                "# TYPE ddti_rejected_total counter",
                f"ddti_rejected_total {srv.batcher.n_rejected}",
                "# TYPE ddti_reloads_total counter",
                f"ddti_reloads_total {srv.n_reloads}",
                "# TYPE ddti_queue_depth gauge",
                f"ddti_queue_depth {srv.batcher._q.qsize()}",
                "# TYPE ddti_uptime_seconds gauge",
                f"ddti_uptime_seconds {up:.3f}",
                "# TYPE ddti_request_latency_seconds_sum counter",
                f"ddti_request_latency_seconds_sum "
                f"{srv.total_latency:.6f}",
                "# TYPE ddti_request_latency_seconds_count counter",
                f"ddti_request_latency_seconds_count {n}",
                "# TYPE ddti_request_latency_seconds gauge",
                *(f'ddti_request_latency_seconds{{quantile="0.{q}"}} '
                  f"{v:.6f}"
                  for q, v in _quantiles(srv.recent_latency)),
                "# TYPE ddti_program_batches_total counter",
                f'ddti_program_batches_total{{batch="{srv.batcher.batch_n}"}}'
                f" {srv.batcher.n_batches}",
            ]
        body = ("\n".join(lines) + "\n").encode()
        self.send_response(200)
        self.send_header("Content-Type",
                         "text/plain; version=0.0.4; charset=utf-8")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _reload(self):
        """POST /reload [{"checkpoint": path}]: load the (new) checkpoint,
        warm it and swap it into the batcher at once."""
        srv = self.server
        try:
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b""
            req = json.loads(body) if body else {}
            if not isinstance(req, dict):
                raise ValueError("body must be a JSON object")
        except Exception as e:
            self._json(400, {"error": f"bad reload request: {e}"})
            return
        try:
            info = srv.reload(req.get("checkpoint"))
        except Exception as e:
            self._json(500, {"error": f"reload failed: {e}"})
            return
        self._json(200, {"status": "reloaded",
                         "checkpoint": srv.args.checkpoint,
                         "batch": srv.batcher.batch_n, **info})

    def do_POST(self):
        import numpy as np
        from PIL import Image

        srv = self.server
        parsed = urlparse(self.path)
        if parsed.path == "/reload":
            self._reload()
            return
        if parsed.path != "/predict":
            self._json(404, {"error": f"unknown path {parsed.path}"})
            return
        t0 = time.perf_counter()
        query = parse_qs(parsed.query)
        want_overlay = query.get("overlay", ["0"])[0] not in ("0", "",
                                                              "false")
        try:
            length = int(self.headers.get("Content-Length", 0))
            data = self.rfile.read(length)
            arr = img = None
            # an overlay is drawn on the ORIGINAL frame, which only the PIL
            # path keeps
            if srv.native_decode and not want_overlay \
                    and data[:2] == b"\xff\xd8":
                # one C call (libjpeg decode + triangle-filter resize),
                # within one gray level of PIL's fixed-point resize
                from ddti_tpu_torch.runtime.native import decode_jpeg_bytes

                try:
                    arr, orig_size = decode_jpeg_bytes(data, srv.size,
                                                       srv.size)
                except ValueError:
                    pass  # an odd JPEG: PIL below, for this request
            if arr is None:
                img = Image.open(io.BytesIO(data)).convert("L")
                orig_size = img.size
                arr = np.asarray(img.resize((srv.size, srv.size),
                                            Image.BILINEAR),
                                 np.uint8)[..., None]
        except Exception as e:
            with srv.stats_lock:
                srv.n_errors += 1
            self._json(400, {"error": f"could not decode image: {e}"})
            return
        try:
            mask = srv.batcher.submit(arr)
        except QueueFull as e:
            self.send_response(503)
            body = json.dumps({"error": f"overloaded: {e}"}).encode()
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Retry-After", "1")
            self.end_headers()
            self.wfile.write(body)
            return
        except Exception as e:
            with srv.stats_lock:
                srv.n_errors += 1
            self._json(500, {"error": f"prediction failed: {e}"})
            return
        m = Image.fromarray((mask[..., 0] * 255).astype(np.uint8))
        m = m.resize(orig_size, Image.NEAREST)
        if want_overlay:  # drawn on the frame at its original resolution
            m = Image.fromarray(_overlay_png(img, np.asarray(m)))
        if query.get("format", ["png"])[0] == "raw":
            arr = np.asarray(m)
            body = arr.tobytes()
            ctype = "application/octet-stream"
            dims = {"X-Width": str(arr.shape[1]),
                    "X-Height": str(arr.shape[0]),
                    "X-Channels": str(1 if arr.ndim == 2 else arr.shape[2])}
        else:
            buf = io.BytesIO()
            m.save(buf, "PNG")
            body = buf.getvalue()
            ctype = "image/png"
            dims = {}
        with srv.stats_lock:
            srv.n_requests += 1
            dt = time.perf_counter() - t0
            srv.total_latency += dt
            srv.recent_latency.append(dt)
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in dims.items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)


class PredictionServer(ThreadingHTTPServer):
    """ThreadingHTTPServer + the model batcher and serving counters."""

    daemon_threads = True
    # listen backlog: socketserver's default of 5 drops the connects of a
    # burst of concurrent clients, which then retry after a second
    request_queue_size = 128

    def __init__(self, addr, batcher: Batcher, size: int, info: dict,
                 verbose: bool = False, args=None):
        self.batcher = batcher
        self.size = size
        self.info = info
        self.verbose = verbose
        self.args = args  # what POST /reload loads from
        self.reload_lock = threading.Lock()
        self.n_reloads = 0
        self._watch_mtimes = {}  # what the last load read (--watch)
        # native libjpeg request decode where the library has it, else PIL
        from ddti_tpu_torch.runtime import native

        self.native_decode = native.decode_available()
        self.native_decode_reason = native.decode_available_reason()
        self.stats_lock = threading.Lock()
        self.n_requests = 0
        self.n_errors = 0
        self.total_latency = 0.0
        # ring of the last 1024 request latencies for quantiles
        self.recent_latency = collections.deque(maxlen=1024)
        self.t_start = time.perf_counter()
        super().__init__(addr, _Handler)

    def reload(self, checkpoint: str | None = None) -> dict:
        """Load ``checkpoint`` (default: the current path, read again),
        warm it, and swap it into the batcher at once. Returns its info.
        One at a time (``reload_lock``). A bundle set may bring other
        batch sizes; its image size must stay the daemon's."""
        import numpy as np

        new_args = copy.copy(self.args)
        new_args.checkpoint = checkpoint or self.args.checkpoint
        with self.reload_lock:
            # read before loading: a rewrite during the load is seen next
            seen = self._mtimes(new_args.checkpoint)
            predict, batch_n, size, info, small = load_programs(new_args)
            if size != self.size:
                raise ValueError(
                    f"artifact image size {size} != serving size "
                    f"{self.size}; restart the daemon to change sizes")
            if not new_args.no_warmup:
                for bn, fn in small + [(batch_n, predict)]:
                    fn(np.zeros((bn, size, size, 1), np.uint8))
            self.batcher.swap_programs(predict, batch_n, small)
            self.args = new_args
            self.info = info
            self._watch_mtimes = seen
            with self.stats_lock:
                self.n_reloads += 1
        return info

    @staticmethod
    def _mtimes(checkpoint: str) -> dict:
        try:
            return {p: os.path.getmtime(p) for p in checkpoint.split(",")
                    if os.path.exists(p)}
        except OSError:  # removed between the two calls
            return {}

    def start_watcher(self, interval_s: float) -> None:
        """--watch: poll the checkpoint's mtime and reload when training
        rewrites it. The path is read from ``self.args.checkpoint`` every
        tick, so a ``POST /reload`` onto a new path moves the watch with
        it, and a checkpoint that did not exist when the watch started is
        loaded once it is written. Every reload records the mtimes it
        loaded, so the watch does not load again what ``/reload`` just
        did (JAX's watcher reloads a path newly installed once more)."""
        self._watch_mtimes = self._mtimes(self.args.checkpoint)

        def _poll():
            while not self._watch_stop.wait(interval_s):
                current = self._mtimes(self.args.checkpoint)
                changed = [p for p, m in current.items()
                           if self._watch_mtimes.get(p) != m]
                if not changed:
                    continue
                try:
                    self.reload()
                    sys.stderr.write(
                        f"watch: reloaded after {changed} changed\n")
                except Exception as e:  # the old model keeps serving
                    sys.stderr.write(f"watch: reload failed: {e}\n")

        self._watch_stop = threading.Event()
        self._watch_thread = threading.Thread(target=_poll, daemon=True,
                                              name="ddti-watch")
        self._watch_thread.start()

    def close(self):
        if getattr(self, "_watch_thread", None) is not None:
            self._watch_stop.set()
            self._watch_thread.join(timeout=5)
        self.batcher.close()
        self.server_close()


def create_server(args) -> PredictionServer:
    """Load the predictor, warm it up (one padded batch, so the first
    request does not pay the kernel build and cuDNN's first-call set-up),
    and bind the HTTP server. ``--port 0`` binds an ephemeral port
    (``server.server_address[1]`` reveals it)."""
    import numpy as np

    predict, batch_n, size, info, small = load_programs(args)
    if not args.no_warmup:
        for bn, fn in small + [(batch_n, predict)]:
            fn(np.zeros((bn, size, size, 1), np.uint8))
    batcher = Batcher(predict, batch_n, max_wait_ms=args.max_wait_ms,
                      max_queue=args.max_queue, small_programs=small)
    server = PredictionServer((args.host, args.port), batcher, size, info,
                              verbose=args.verbose, args=args)
    if getattr(args, "watch", 0):
        server.start_watcher(float(args.watch))
    return server


def get_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="HTTP nodule-segmentation server (PyTorch/CUDA)")
    ap.add_argument("--checkpoint", required=True,
                    help=".pth state_dict (reference format), .npz "
                         "weight export of the JAX package, a full-state "
                         "directory of the port (<Model>_last), or .pt2 "
                         "serving bundles: a comma list of one model's "
                         "bundles at several batch sizes serves as one set")
    ap.add_argument("--weights", default=None,
                    help=".npz tensors of a single weights-as-arguments "
                         ".pt2 bundle (default: its sibling .npz)")
    ap.add_argument("--watch", type=float, default=0,
                    help="poll the checkpoint file(s) every N seconds and "
                         "hot-reload when they change (0 = off)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max_wait_ms", type=float, default=5.0,
                    help="micro-batching window: how long to hold a "
                         "request open for batch-mates before running a "
                         "padded batch")
    ap.add_argument("--model_type", default="TransUNet")
    ap.add_argument("--base_filters", type=int, default=64)
    ap.add_argument("--depth", type=int, default=4)
    ap.add_argument("--image_size", type=int, default=512)
    ap.add_argument("--config_path", default=None,
                    help="model YAML ({model: {model_type, kwargs}}, as "
                         "the training CLI takes): its model_type and "
                         "kwargs replace --model_type, --base_filters and "
                         "--depth (ImprovedVNet's deep_supervision, "
                         "use_attention, ASPPUNet's aspp_dilations, ...)")
    ap.add_argument("--batch_size", type=int, default=16,
                    help="fixed batch shape of every device run")
    ap.add_argument("--bf16", action="store_true",
                    help="bf16 autocast compute (params stay float32)")
    ap.add_argument("--threshold", type=float, default=0.5,
                    help="binarization threshold")
    ap.add_argument("--tta", action="store_true",
                    help="4-way flip test-time augmentation (four forwards "
                         "a batch)")
    ap.add_argument("--fold_bn", action="store_true",
                    help="fold BatchNorm into the conv weights at load")
    ap.add_argument("--device", default="cuda",
                    help="cuda[:N] (default; raises if CUDA is absent) or "
                         "cpu")
    ap.add_argument("--max_queue", type=int, default=0,
                    help="backpressure bound on pending frames (0 = "
                         "8x batch); beyond it /predict returns 503 + "
                         "Retry-After instead of queueing unboundedly")
    ap.add_argument("--no_warmup", action="store_true")
    ap.add_argument("--verbose", action="store_true",
                    help="per-request access log")
    return ap


def main(argv=None) -> int:
    args = get_parser().parse_args(argv)
    server = create_server(args)
    host, port = server.server_address[:2]
    print(f"serving on http://{host}:{port}  "
          f"(batch={server.batcher.batch_n} size={server.size} "
          f"{server.info})", flush=True)

    import signal

    def _term(signum, frame):  # SIGTERM (k8s/systemd stop) drains too
        raise KeyboardInterrupt

    signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("shutting down")
    finally:
        server.close()  # batcher drains pending frames before exiting
    return 0


if __name__ == "__main__":
    sys.exit(main())
