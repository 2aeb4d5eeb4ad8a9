#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ddti_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, one or more lines each; any failure ends the run with a traceback
and a non-zero exit:

1. device   — needs CUDA; prints the card's name and power limit
              (nvidia-smi) and turns TF32 off, so float32 means float32.
2. build    — compiles the CUDA sources under ddti_tpu_torch/csrc with nvcc
              (one process per source, all at once) into build/.
3. kernels  — every kernel against its plain PyTorch version on the card,
              with timings: flash attention forward at the serving path's
              shapes; the flash backward kernels (csrc/flash_bwd.cu: dK/dV
              with the delta pre-pass, and dQ) at the same shapes and a
              ragged S, dq/dk/dv against their limits, each kernel's device
              time from torch.profiler beside the plain backward's; the EDT
              (csrc/edt.cu) bit for bit against its plain version and
              against scipy at the training path's shapes, ragged ones and
              edge frames.
4. slice    — the serving daemon (ddti_tpu_torch.cli.serve) with the
              TransUNet of configs/config.yaml (base_filters 64, depth 4,
              512x512 -> 1024 bottleneck tokens), random weights from a seed,
              bf16, batch 16. A few dozen PNG frames are POSTed concurrently
              to /predict; the flash kernel's launch count must rise by 4
              (one per encoder layer) for every batch. In bf16, the kernel
              path's masks must agree with a plain-attention run of the same
              frames as closely as the kernel's own plain version does (the
              bf16 noise floor): tightly when batched alike in-process,
              loosely for the masks the daemon served (its batches form by
              arrival). In float32 both paths' masks must agree on >= 99.9%
              of pixels and their logits to 1e-3.
5. profile  — device time per bf16 serving batch of 16 on the kernel path
              and on the plain path (CUDA events), and a torch.profiler
              breakdown of the kernel path with the device's busy share.
6. train    — the training CLI (python -m ddti_tpu_torch.cli.main --mode
              both --synthetic) with the flagship ResUNet (base_filters 64,
              depth 5) at 512^2, batch 16, bf16, 2 epochs, in a subprocess:
              exit 0, the parameter count, the JAX CLI's run tree, finite
              loss terms with a nonzero boundary term, val IoU and test
              metrics with HD95/ASSD, a best .pth that loads strictly and an
              .npz in the JAX package's key layout, and exactly the expected
              number of EDT kernel launches.
7. ttrain   — the same CLI training the serving slice's TransUNet
              (base_filters 64, depth 4, 512^2 -> 1024 tokens) from a model
              YAML with dropout_rate 0.0, batch 16, bf16, 2 epochs: the same
              checks, and exactly the expected launches of the flash forward,
              both backward kernels and the EDT.
8. step     — one float32 train step from one state and batch with the
              kernel EDT and with the plain EDT: bit-equal boundary terms and
              updated parameters equal to 1e-6.
9. tstep    — one float32 TransUNet train step from one state and batch
              through the flash kernels and through their plain versions
              (swapped in explicitly): loss terms to 1e-6, gradients and
              updated parameters within the stated normwise limits; then a
              bf16 step at the default dropout 0.1, which the gate sends to
              the plain attention: no flash launch, finite terms.
10. tprofile — device time per bf16 train step (CUDA events): ResUNet at
              512^2 / batch 16 and 256^2 / batch 128, with the EDT kernels'
              share; the TransUNet at 512^2 / batch 16 (S = 1024) on the
              kernel path and the plain path, and the S = 4096 TransUNet
              (base_filters 32, depth 3) at the largest batch <= 16 whose
              plain path fits; torch.profiler top-8, busy share and the
              flash kernels' share.
11. result  — the total wall time, a JSON line of the kernels, then the
              device line.
"""

import concurrent.futures
import http.client
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

SEED = 0
DEVICE = "cuda"  # the training phases' device
SLICE = dict(in_channels=1, out_channels=1, base_filters=64, depth=4,
             image_size=512)
N_LAYERS = 4          # TransUNet's fixed encoder depth
BATCH = 16
N_FRAMES = 64
# bf16 masks of the kernel path may disagree with the plain path's on at
# most this share of pixels more than the kernel's own plain version does:
# KERNEL_MARGIN when all three are batched alike in-process, SERVED_MARGIN
# for the masks the daemon served, whose batches form by arrival
KERNEL_MARGIN = 5e-5
SERVED_MARGIN = 5e-4
# kernel vs plain: bf16 differs by the rounding of the probability tile,
# float32 by summation order only
O_LIMIT = {"bfloat16": 2e-2, "float32": 1e-4}
LSE_LIMIT = 1e-3
# (B, H, S, D, dtype): the slice's shape in both dtypes, the S = 4096
# bottleneck of config.yaml's TransUNet at depth 3, and full-width heads
KERNEL_SHAPES = [(16, 8, 1024, 32, "bfloat16"), (16, 8, 1024, 32, "float32"),
                 (2, 8, 4096, 32, "bfloat16"), (2, 2, 1024, 128, "float32")]
F32_LOGIT_LIMIT = 1e-3
# float32 masks of the kernel path and the plain path: at least this share
# of pixels agree (bf16 masks are held to the noise floor above instead)
F32_MASK_AGREE = 0.999
PROFILE_BATCHES = 5
PROFILE_TOP = 8
# the EDT at the training path's shape (N, H, W), bs128 at 256^2 (bench.py's
# headline leg), ragged widths and a single row; timed at the first two
EDT_SHAPES = [(16, 512, 512), (128, 256, 256), (8, 100, 100), (4, 200, 333),
              (3, 1, 333)]
EDT_TIMED = 2
# the training slice: the CLI's flagship ResUNet at its defaults
TRAIN = dict(model_type="ResUNet", base_filters=64, depth=5, image_size=512,
             batch_size=16, epochs=2)
SYNTHETIC = (64, 16, 16)  # the CLI's --synthetic train/val/test frames
TRAIN_TIMEOUT_S = 600
STEP_PARAM_RTOL = 1e-6
# (image size, batch): the CLI default and bench.py's headline leg
TRAIN_PROFILES = [(512, 16), (256, 128)]
TRAIN_PROFILE_STEPS = 3
# backward kernels vs plain, max |difference| over max |value| of each of
# dq, dk, dv: float32 by summation order, bf16 also by P and dS landing an
# ulp apart where the two sides' float32 values straddle a bf16 boundary
G_LIMIT = {"bfloat16": 2e-2, "float32": 1e-4}
# the forward's shapes and a ragged S
BWD_SHAPES = KERNEL_SHAPES + [(2, 8, 1000, 32, "bfloat16")]
BWD_PROFILE_CALLS = 5
# the TransUNet training slice: the serving slice's model from a model YAML
# (configs/config.yaml:337-343) with dropout_rate 0.0, trained by the CLI
TSLICE = dict(in_channels=1, out_channels=1, base_filters=64, depth=4,
              dropout_rate=0.0)
TSLICE_PARAMS = 19511873
TTRAIN = dict(image_size=512, batch_size=16, epochs=2)
# float32 step, flash kernels vs their plain versions: loss terms (relative)
# and gradients and updated parameters (normwise over all of them). The
# attention gradients' float32 summation-order differences (~3e-7 relative)
# reach 2.5e-5 normwise over all gradients, and the first AdamW step turns
# the gradients that lie within that noise of zero into sign flips of up to
# 2 lr: 1.2e-6 normwise on the parameters (H100); held to 4x and 8x that
TSTEP_TERM_RTOL = 1e-6
TSTEP_GRAD_RTOL = 1e-4
TSTEP_PARAM_RTOL = 1e-5
# the S = 4096 TransUNet of configs/config.yaml:303-308 (512^2, depth 3)
TLONG = dict(in_channels=1, out_channels=1, base_filters=32, depth=3,
             dropout_rate=0.0)
TLONG_BATCHES = (16, 8, 4, 2, 1)


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


def median_ms(fn, runs=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernels():
    import torch

    from ddti_tpu_torch.ops import attention as A

    rows = []
    for b, h, s, d, dt in KERNEL_SHAPES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v = (torch.randn((b, h, s, d), generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        o, lse = A.flash_forward_cuda(q, k, v)
        torch.cuda.synchronize()
        o_ref, lse_ref = A.flash_forward_reference(q, k, v)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        finite = bool(torch.isfinite(o.float()).all()
                      and torch.isfinite(lse).all())
        ms = median_ms(lambda: A.flash_forward_cuda(q, k, v))
        plain_ms = median_ms(lambda: A.flash_forward_reference(q, k, v))
        phase("kernels", f"flash_fwd {(b, h, s, d)} {dt}: max|do| {err_o:.3e} "
              f"(limit {O_LIMIT[dt]:g}) max|dlse2| {err_lse:.3e} (limit "
              f"{LSE_LIMIT:g}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        assert finite, "non-finite kernel output"
        assert err_o <= O_LIMIT[dt] and err_lse <= LSE_LIMIT, \
            "kernel disagrees with its plain version"
        rows.append(dict(shape=[b, h, s, d], dtype=dt, max_abs_err=err_o,
                         max_abs_err_lse2=err_lse, ms=ms, plain_ms=plain_ms))
    return rows


def check_bwd_kernels():
    """csrc/flash_bwd.cu against flash_backward_reference on the forward
    kernel's o and lse2: dq, dk, dv against G_LIMIT; the whole backward's
    time (CUDA events) beside the plain one's, and each kernel's device
    time from torch.profiler (the delta pre-pass counted with dK/dV)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ddti_tpu_torch.ops import attention as A

    rows = []
    for b, h, s, d, dt in BWD_SHAPES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v, do = (torch.randn((b, h, s, d), generator=g, device="cuda")
                       .to(dtype) for _ in range(4))
        o, lse = A.flash_forward_cuda(q, k, v)
        args = (q, k, v, o, lse, do)
        got = A.flash_backward_cuda(*args)
        torch.cuda.synchronize()
        want = A.flash_backward_reference(*args)
        abs_err, rel_err = {}, {}
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert torch.isfinite(a.float()).all(), f"non-finite {name}"
            abs_err[name] = (a.float() - w.float()).abs().max().item()
            rel_err[name] = abs_err[name] / max(
                w.float().abs().max().item(), 1e-30)
        del got, want
        ms = median_ms(lambda: A.flash_backward_cuda(*args))
        plain_ms = median_ms(lambda: A.flash_backward_reference(*args))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(BWD_PROFILE_CALLS):
                A.flash_backward_cuda(*args)
            torch.cuda.synchronize()
        split = {"dkdv": 0.0, "dq": 0.0}
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            if "flash_bwd_dq" in e.key:
                split["dq"] += e.self_device_time_total
            elif "flash_bwd_dkdv" in e.key or "flash_bwd_delta" in e.key:
                split["dkdv"] += e.self_device_time_total
        assert split["dkdv"] > 0 and split["dq"] > 0, \
            "torch.profiler recorded no backward kernel"
        split = {k: us / BWD_PROFILE_CALLS / 1e3 for k, us in split.items()}
        phase("kernels", f"flash_bwd {(b, h, s, d)} {dt}: max|d|/max|g| "
              + " ".join(f"{n} {e:.3e}" for n, e in rel_err.items())
              + f" (limit {G_LIMIT[dt]:g}); kernels {ms:.4f} ms (profiler: "
              f"delta + dK/dV {split['dkdv']:.4f}, dQ {split['dq']:.4f}) "
              f"plain {plain_ms:.4f} ms")
        assert max(rel_err.values()) <= G_LIMIT[dt], \
            "a backward kernel disagrees with its plain version"
        rows.append(dict(shape=[b, h, s, d], dtype=dt, abs_err=abs_err,
                         rel_err=rel_err, ms=ms, ms_dkdv=split["dkdv"],
                         ms_dq=split["dq"], plain_ms=plain_ms))
    return rows


def random_state(model, seed):
    """Seeded random weights: He-scaled conv/linear weights, BatchNorm and
    LayerNorm affines near identity, BN statistics near (0, 1)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in model.state_dict().items():
        def normal(std):
            return torch.randn(t.shape, generator=g) * std
        if name.endswith("running_var"):
            sd[name] = torch.rand(t.shape, generator=g) + 0.5
        elif name.endswith("pos_emb"):
            sd[name] = normal(1.0)
        elif t.dim() == 1:
            sd[name] = normal(0.1) + (1.0 if name.endswith("weight") else 0.)
        else:
            fan_in = t.shape[0] if name.startswith("upconvs") else t[0].numel()
            sd[name] = normal((2.0 / fan_in) ** 0.5)
    return sd


def make_frames(n, size, seed):
    """Ultrasound-like test frames: speckle over a dark field with one
    brighter ellipse each, as uint8 (size, size)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    frames = []
    for _ in range(n):
        cy, cx, ry, rx = rng.uniform([0.3, 0.3, 0.08, 0.08],
                                     [0.7, 0.7, 0.25, 0.25])
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        img = 60 + 90 * inside + rng.normal(0, 25, (size, size))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def post(port, body, path="/predict?format=raw"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    conn.request("POST", path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    dt = time.perf_counter() - t0
    conn.close()
    return resp.status, dict(resp.getheaders()), data, dt


def get_json(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    assert resp.status == 200, (path, resp.status, body)
    return body


def run_batches(model, x, dtype):
    """uint8 (N, S, S, 1) frames -> (N, S, S) masks, BATCH at a time."""
    import torch

    from ddti_tpu_torch.train.export import make_serve_fn

    serve = make_serve_fn(model, compute_dtype=dtype)
    out = torch.cat([serve(x[i:i + BATCH]) for i in range(0, len(x), BATCH)])
    return out[..., 0].cpu().numpy()


def run_slice(tmp):
    import numpy as np
    import torch
    from PIL import Image

    from ddti_tpu_torch.cli import serve
    from ddti_tpu_torch.models import blocks, create_model
    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into

    model = create_model("TransUNet", **SLICE)
    n_params = sum(p.numel() for p in model.parameters())
    ckpt = os.path.join(tmp, "transunet_bf64_d4_512.pth")
    torch.save(random_state(model, SEED), ckpt)
    phase("slice", f"TransUNet {SLICE}: {n_params} parameters, random "
          f"weights (seed {SEED}) -> {os.path.basename(ckpt)}")

    args = serve.get_parser().parse_args(
        ["--checkpoint", ckpt, "--model_type", "TransUNet",
         "--base_filters", str(SLICE["base_filters"]),
         "--depth", str(SLICE["depth"]),
         "--image_size", str(SLICE["image_size"]),
         "--batch_size", str(BATCH), "--bf16", "--device", "cuda",
         "--port", "0"])
    t0 = time.perf_counter()
    server = serve.create_server(args)
    phase("slice", f"server up in {time.perf_counter() - t0:.2f} s "
          f"(load + warm-up batch) on port {server.server_address[1]}")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        health = get_json(port, "/healthz")
        phase("slice", f"/healthz {json.dumps(health)}")
        frames = make_frames(N_FRAMES, SLICE["image_size"], SEED)
        bodies = []
        for f in frames:
            buf = io.BytesIO()
            Image.fromarray(f, "L").save(buf, "PNG")
            bodies.append(buf.getvalue())

        A.flash_forward_cuda.launches = 0
        batches0 = server.batcher.n_batches
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(N_FRAMES) as pool:
            answers = list(pool.map(lambda b: post(port, b), bodies))
        wall = time.perf_counter() - t0
        launches = A.flash_forward_cuda.launches
        n_batches = server.batcher.n_batches - batches0

        lat = sorted(a[3] * 1e3 for a in answers)
        q = {p: lat[min(len(lat) - 1, int(len(lat) * p / 100))]
             for p in (50, 90, 99)}
        phase("slice", f"{N_FRAMES} concurrent POST /predict: {n_batches} "
              f"batches, {launches} flash_fwd launches, wall {wall:.3f} s, "
              f"{N_FRAMES / wall:.2f} img/s, client latency p50 {q[50]:.1f} "
              f"p90 {q[90]:.1f} p99 {q[99]:.1f} ms")
        stats = get_json(port, "/stats")
        phase("slice", f"/stats {json.dumps(stats)}")

        # a JPEG of another size comes back as a PNG mask of that size
        buf = io.BytesIO()
        Image.fromarray(frames[0], "L").resize((600, 480)).save(buf, "JPEG")
        status, headers, data, _ = post(port, buf.getvalue(), "/predict")
        odd = np.asarray(Image.open(io.BytesIO(data)))
        phase("slice", f"600x480 JPEG -> HTTP {status} "
              f"{headers.get('Content-Type')} mask {odd.shape}")
        assert status == 200 and odd.shape == (480, 600)
        assert set(np.unique(odd)) <= {0, 255}
    finally:
        server.shutdown()
        server.close()
        thread.join(timeout=30)

    masks = []
    for status, headers, data, _ in answers:
        assert status == 200, (status, data[:200])
        h, w = int(headers["X-Height"]), int(headers["X-Width"])
        assert (h, w) == frames[0].shape
        masks.append(np.frombuffer(data, np.uint8).reshape(h, w) // 255)
    masks = np.stack(masks)
    assert set(np.unique(masks)) <= {0, 1}
    assert n_batches < N_FRAMES, "requests did not coalesce"
    assert launches == N_LAYERS * n_batches, \
        f"{launches} kernel launches for {n_batches} batches"
    assert stats["images"] >= N_FRAMES and stats["errors"] == 0

    # the same frames through the plain attention path, explicitly chosen
    plain = load_checkpoint_into(
        ckpt, "TransUNet",
        create_model("TransUNet", use_flash_attention=False, **SLICE))
    x = torch.from_numpy(np.stack(frames)[..., None]).cuda()
    A.flash_forward_cuda.launches = 0
    ref = run_batches(plain.cuda(), x, torch.bfloat16)
    assert A.flash_forward_cuda.launches == 0, "the plain path launched"
    flash = load_checkpoint_into(ckpt, "TransUNet",
                                 create_model("TransUNet", **SLICE)).cuda()
    kern = run_batches(flash, x, torch.bfloat16)
    # bf16 noise floor: the flash path with the kernel swapped for its own
    # plain version. Two correct bf16 attentions already differ by about a
    # bf16 ulp, which the bf16 decoder turns into flips of the pixels whose
    # logit lies that close to the threshold.
    launched = A.flash_forward_cuda.launches
    blocks.flash_attention = lambda q, k, v: A.flash_forward_reference(
        q, k, v)[0]
    try:
        twin = run_batches(flash, x, torch.bfloat16)
    finally:
        blocks.flash_attention = A.flash_attention
    assert A.flash_forward_cuda.launches == launched
    floor = float((ref == twin).mean())
    agree = float((ref == kern).mean())
    served = float((ref == masks).mean())
    phase("slice", f"bf16 masks vs plain path: kernel's plain twin (noise "
          f"floor) {floor:.6%}; kernel path batched alike {agree:.6%} "
          f"(limit floor - {KERNEL_MARGIN:g}); served by the daemon "
          f"{served:.6%} (limit floor - {SERVED_MARGIN:g}); served vs "
          f"batched alike {float((kern == masks).mean()):.6%}; foreground "
          f"{masks.mean():.3f}")

    # float32 masks of both paths on every frame: only attention differs,
    # by summation order
    agree32 = float((run_batches(flash, x, torch.float32)
                     == run_batches(plain, x, torch.float32)).mean())
    phase("slice", f"float32 masks: kernel path vs plain path agree on "
          f"{agree32:.6%} of pixels (limit {F32_MASK_AGREE:.1%})")
    # and their logits on two frames
    xf = x[:2].permute(0, 3, 1, 2).float() / 255.0
    with torch.inference_mode():
        lf, lp = flash(xf), plain(xf)
    torch.cuda.synchronize()
    dlogit = (lf - lp).abs().max().item()
    near = (lp.abs() < 1e-2).float().mean().item()
    phase("slice", f"float32 logits kernel vs plain path: max|d| "
          f"{dlogit:.3e} (limit {F32_LOGIT_LIMIT:g}), shape "
          f"{tuple(lf.shape)}, share of |logit| < 1e-2: {near:.5f}")
    size = SLICE["image_size"]
    assert lf.shape == (2, 1, size, size) and torch.isfinite(lf).all()
    assert dlogit <= F32_LOGIT_LIMIT
    assert agree32 >= F32_MASK_AGREE, \
        "float32 masks of the kernel path and the plain path disagree"
    assert agree >= floor - KERNEL_MARGIN, \
        "the kernel path disagrees with the plain path beyond bf16 noise"
    assert served >= floor - SERVED_MARGIN, \
        "the served masks disagree with the plain path beyond bf16 noise"
    assert 0.0 < masks.mean() < 1.0, "degenerate masks"
    return launches, ckpt


def profile_slice(ckpt):
    """Device time of one bf16 batch through ``make_serve_fn`` on both
    attention paths, and where the kernel path's device time goes."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
    from ddti_tpu_torch.train.export import make_serve_fn

    x = torch.from_numpy(np.stack(make_frames(
        BATCH, SLICE["image_size"], SEED + 1))[..., None]).cuda()
    serve = {}
    for path, flash in (("kernel", None), ("plain", False)):
        model = create_model("TransUNet", use_flash_attention=flash, **SLICE)
        serve[path] = make_serve_fn(
            load_checkpoint_into(ckpt, "TransUNet", model).cuda(),
            compute_dtype=torch.bfloat16)
    order = ("plain", "kernel", "kernel", "plain")
    ms = [median_ms(lambda: serve[path](x)) for path in order]
    phase("profile", f"device time per bf16 batch of {BATCH} at "
          f"{SLICE['image_size']}^2 (CUDA events, median of 20), order "
          f"{', '.join(order)}: {', '.join(f'{t:.3f}' for t in ms)} ms")

    torch.cuda.synchronize()
    launches0 = A.flash_forward_cuda.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILE_BATCHES):
            serve["kernel"](x)
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    phase("profile", f"torch.profiler, {PROFILE_BATCHES} kernel-path "
          f"batches: window {window_us / 1e3:.3f} ms, device kernels "
          f"{busy_us / 1e3:.3f} ms ({busy_us / window_us:.1%} busy), "
          f"{A.flash_forward_cuda.launches - launches0} flash_fwd launches")
    if not kernels:
        phase("profile", "no device time recorded: breakdown not measured")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[
            :PROFILE_TOP]:
        phase("profile", f"{e.self_device_time_total / busy_us:6.1%} "
              f"{e.count:4d} x {e.self_device_time_total / e.count / 1e3:.4f}"
              f" ms  {e.key[:90]}")


def edt_masks(n, h, w, seed):
    """EDT inputs (nonzero = foreground): 1 - the synthetic nodule masks
    (the boundary loss's input), or random discs and salt where the frame
    is not square, with the edge frames first: all zeros, all ones (no
    zero: the cap h + w), a single zero, a single nonzero pixel."""
    import numpy as np
    import torch

    from ddti_tpu_torch.data.synthetic import generate_ddti_like

    if h == w and h >= 64:
        _, masks = generate_ddti_like(n, (h, w), seed)
        m = (masks[..., 0] == 0).astype(np.uint8)
    else:
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:h, 0:w]
        m = (rng.random((n, h, w)) < 0.01).astype(np.uint8)
        for i in range(n):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            r = rng.uniform(1, max(h, w) / 3)
            m[i] |= ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)
    edge = [np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8),
            np.ones((h, w), np.uint8), np.zeros((h, w), np.uint8)]
    edge[2][h // 2, w // 3] = 0
    edge[3][h // 3, w // 2] = 1
    k = min(len(edge), n)
    m[:k] = np.stack(edge[:k])
    return torch.from_numpy(m)


def check_edt():
    """csrc/edt.cu against its plain version (bit for bit, every frame) and
    scipy (every frame with a zero), with kernel and plain timings."""
    import numpy as np
    import torch
    from scipy import ndimage

    from ddti_tpu_torch.ops import edt as E

    rows = []
    for i, (n, h, w) in enumerate(EDT_SHAPES):
        m = edt_masks(n, h, w, SEED + i).to(DEVICE)
        got = E.edt_cuda(m)
        torch.cuda.synchronize()
        want = E.edt_reference(m)
        equal = torch.equal(got, want)
        err = (got - want).abs().max().item()
        host, ref_in = got.cpu().numpy(), m.cpu().numpy()
        scipy_frames = scipy_equal = 0
        for j in range(n):
            if not (ref_in[j] == 0).any():  # scipy has no answer there
                assert (host[j] == h + w).all(), "the cap h + w"
                continue
            scipy_frames += 1
            scipy_equal += np.array_equal(
                host[j], ndimage.distance_transform_edt(ref_in[j]).astype(
                    np.float32))
        row = dict(shape=[n, h, w], max_abs_err=err, bit_equal=equal,
                   scipy_frames=scipy_frames, scipy_equal=scipy_equal)
        if i < EDT_TIMED:
            row["ms"] = median_ms(lambda: E.edt_cuda(m))
            row["plain_ms"] = median_ms(lambda: E.edt_reference(m))
        phase("kernels", f"edt_minplus {(n, h, w)} uint8: bit-equal to plain "
              f"{equal} (max|d| {err:.3e}), bit-equal to scipy on "
              f"{scipy_equal}/{scipy_frames} frames with a zero"
              + (f", kernel {row['ms']:.4f} ms plain {row['plain_ms']:.4f} "
                 f"ms" if "ms" in row else ""))
        assert equal, "the EDT kernel disagrees with its plain version"
        assert scipy_equal == scipy_frames, \
            "the EDT kernel disagrees with scipy"
        rows.append(row)
    return rows


def _parse_terms(log_text):
    """Every logged epoch line: (phase, epoch, avg loss, bce, dice, focal,
    boundary, iou)."""
    import re

    pat = re.compile(
        r"(Train|Validate) Epoch: (\d+), Avg Loss: (\S+)\n.*BCE Loss: (\S+), "
        r"Dice Loss: (\S+), Focal Loss: (\S+), Boundary Loss: (\S+)\n"
        r".*IoU: (\S+)\n")
    return [(g[0], int(g[1]), *map(float, g[2:]))
            for g in pat.findall(log_text)]


def jax_resunet_keys(depth):
    """The key set ddti_tpu.train.checkpoint.save_params_npz writes for a
    ResUNet of this depth, written out from the flax module tree (encoders,
    bottleneck and decoders are ResidualBlocks)."""
    keys = set()
    blocks = ([f"encoders_{i}" for i in range(depth)] + ["bottleneck"]
              + [f"decoders_{i}" for i in range(depth)])
    for b in blocks:
        for conv in ("conv1", "conv2", "skip"):
            keys.add(f"params/{b}/{conv}/kernel")
        for bn in ("bn1", "bn2"):
            keys |= {f"params/{b}/{bn}/scale", f"params/{b}/{bn}/bias",
                     f"batch_stats/{b}/{bn}/mean", f"batch_stats/{b}/{bn}/var"}
    for i in range(depth):
        keys |= {f"params/upconvs_{i}/kernel", f"params/upconvs_{i}/bias"}
    return keys | {"params/final_conv/kernel", "params/final_conv/bias"}


def jax_transunet_keys(depth, layers):
    """The key set ddti_tpu.train.checkpoint.save_params_npz writes for a
    TransUNet of this depth and encoder layer count, written out from the
    flax module tree (encoders and decoders are ConvBNAct blocks)."""
    keys = {"params/patchify/kernel", "params/pos_emb",
            "params/trans_proj/kernel", "params/trans_proj/bias",
            "params/final_conv/kernel", "params/final_conv/bias"}
    for b in ([f"encoders_{i}" for i in range(depth)]
              + [f"decoders_{i}" for i in range(depth)]):
        keys |= {f"params/{b}/conv1/kernel", f"params/{b}/conv2/kernel"}
        for bn in ("bn1", "bn2"):
            keys |= {f"params/{b}/{bn}/scale", f"params/{b}/{bn}/bias",
                     f"batch_stats/{b}/{bn}/mean", f"batch_stats/{b}/{bn}/var"}
    for i in range(depth):
        keys |= {f"params/upconvs_{i}/kernel", f"params/upconvs_{i}/bias"}
    for i in range(layers):
        for dense in ("qkv", "out_proj", "fc1", "fc2"):
            keys |= {f"params/trans_layers_{i}/{dense}/kernel",
                     f"params/trans_layers_{i}/{dense}/bias"}
        for ln in ("ln1", "ln2"):
            keys |= {f"params/trans_layers_{i}/{ln}/scale",
                     f"params/trans_layers_{i}/{ln}/bias"}
    return keys


def run_cli(tmp, name, model_type, model_kw, flags, epochs, keys):
    """The training CLI (--mode both --synthetic, 2 epochs, bf16) end to end
    in its own process: exit 0, the parameter count of ``model_kw``, the
    run tree, finite loss terms with a nonzero boundary term, val IoU and
    test metrics with HD95/ASSD, a best .pth that loads strictly and an .npz
    with the key set ``keys`` and the same tensors. Returns the launch count
    of each kernel in that run."""
    import math

    import numpy as np
    import torch

    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
    from ddti_tpu_torch.train.state import count_params

    base = os.path.join(tmp, f"runs_{name}")
    cmd = [sys.executable, "-m", "ddti_tpu_torch.cli.main", "--mode", "both",
           "--synthetic", "--use_amp_autocast", "true", "--base_dir", base,
           "--model_type", model_type, f"--epochs={epochs}", *flags]
    phase(name, " ".join(cmd[1:]))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=TRAIN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    out = res.stdout
    phase(name, f"exit {res.returncode} in {wall:.1f} s")
    if res.returncode != 0:
        print(out[-4000:], res.stderr[-8000:], sep="\n", file=sys.stderr)
    assert res.returncode == 0, "the training CLI failed"
    params = [l for l in out.splitlines() if l.startswith("[PARAMS]")]
    kernels = [l for l in out.splitlines() if l.startswith("[KERNELS]")]
    phase(name, f"{params[0]} {kernels[0]}")
    model = create_model(model_type, **model_kw)
    assert params[0] == f"[PARAMS] {model_type},{count_params(model)}"
    launches = dict(kv.split("=") for kv in kernels[0].split()[1:])
    launches = {k: int(v) for k, v in launches.items()}

    (run,) = os.listdir(base)
    run = os.path.join(base, run)
    for sub in ("models", "log/train_log.log", "result", "config.yaml"):
        assert os.path.exists(os.path.join(run, sub)), sub
    with open(os.path.join(run, "log", "train_log.log")) as f:
        log = f.read()
    terms = _parse_terms(log)
    for t in terms:
        phase(name, f"{t[0]} epoch {t[1]}: loss {t[2]:.4f} bce {t[3]:.4f} "
              f"dice {t[4]:.4f} focal {t[5]:.4f} boundary {t[6]:.4f} "
              f"IoU {t[7]:.4f}")
    assert len(terms) == 2 * epochs, "an epoch line is missing"
    assert all(math.isfinite(x) for t in terms for x in t[2:7])
    assert all(t[6] > 0 for t in terms), "the boundary term is zero"
    assert all(math.isfinite(t[7]) for t in terms if t[0] == "Validate")
    with open(os.path.join(run, "result", "test_metrics.json")) as f:
        test = json.load(f)
    phase(name, "test: " + ", ".join(
        f"{k} {test[k]:.4f}" for k in ("iou", "f1", "hd95_mean",
                                       "assd_mean", "total_images")))
    for k in ("iou", "f1", "hd95_mean", "assd_mean"):
        assert math.isfinite(test[k]), k
    assert test["total_images"] == SYNTHETIC[2]

    best = os.path.join(run, "models", f"{model_type}_best")
    load_checkpoint_into(best + ".pth", model_type, model)  # strict
    with np.load(best + ".npz") as z:
        got = set(z.files)
    assert got == keys, sorted(got ^ keys)[:8]
    twin = load_checkpoint_into(best + ".npz", model_type,
                                create_model(model_type, **model_kw))
    for k, v in model.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k]), k
    phase(name, f"best .pth loads strictly; .npz holds the JAX layout's "
          f"{len(keys)} keys and the same tensors")
    return launches


def _cli_batches(batch):
    """(train steps per epoch, val batches, test batches) of the CLI's
    synthetic splits."""
    return tuple(-(-n // batch) for n in SYNTHETIC)


def run_training(tmp):
    """The ResUNet training CLI; returns the EDT kernel's launch count."""
    model_kw = dict(base_filters=TRAIN["base_filters"], depth=TRAIN["depth"])
    flags = [f"--{k}={v}" for k, v in TRAIN.items()
             if k not in ("model_type", "epochs")]
    launches = run_cli(tmp, "train", "ResUNet", model_kw, flags,
                       TRAIN["epochs"], jax_resunet_keys(TRAIN["depth"]))
    steps, val, test_b = _cli_batches(TRAIN["batch_size"])
    expected = TRAIN["epochs"] * (steps + val) + test_b
    phase("train", f"edt_minplus launches {launches['edt_minplus']}, "
          f"expected {TRAIN['epochs']} epochs x ({steps} train + {val} val "
          f"steps) + {test_b} test batches = {expected}")
    assert launches["edt_minplus"] == expected
    return launches["edt_minplus"]


def run_transunet_training(tmp):
    """The TransUNet training CLI from a model YAML with dropout_rate 0.0;
    returns the launch counts, each checked against its expected value."""
    import yaml

    cfg = os.path.join(tmp, "transunet_bf64_d4_dropout0.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"model": {"model_type": "TransUNet",
                                  "kwargs": TSLICE}}, f)
    flags = ["--config_path", cfg, "--device", DEVICE,
             *(f"--{k}={v}" for k, v in TTRAIN.items() if k != "epochs")]
    model_kw = dict(TSLICE, image_size=TTRAIN["image_size"])
    launches = run_cli(tmp, "ttrain", "TransUNet", model_kw, flags,
                       TTRAIN["epochs"],
                       jax_transunet_keys(TSLICE["depth"], N_LAYERS))
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.state import count_params

    assert count_params(create_model("TransUNet", **model_kw)) \
        == TSLICE_PARAMS, "not the serving slice's TransUNet"
    steps, val, test_b = _cli_batches(TTRAIN["batch_size"])
    epochs = TTRAIN["epochs"]
    expected = {
        "flash_fwd": N_LAYERS * (epochs * (steps + val) + test_b),
        "flash_bwd_dkdv": N_LAYERS * epochs * steps,
        "flash_bwd_dq": N_LAYERS * epochs * steps,
        "edt_minplus": epochs * (steps + val) + test_b,
    }
    phase("ttrain", "launches " + ", ".join(
        f"{k} {launches[k]} (expected {v})" for k, v in expected.items())
        + f": {N_LAYERS} layers, {epochs} epochs x ({steps} train + {val} "
        f"val steps) + {test_b} test batches; the backward in train steps "
        f"only")
    assert {k: launches[k] for k in expected} == expected
    return launches


def _train_setup(size, batch, amp, seed=SEED, model_type="ResUNet",
                 model_kw=None):
    """A full-width model on the card (the flagship ResUNet unless
    ``model_type`` / ``model_kw`` say otherwise), its train state and step,
    one synthetic batch and its draws."""
    import torch

    from ddti_tpu_torch.core.config import Config
    from ddti_tpu_torch.data.augment import AugmentConfig, sample_draws
    from ddti_tpu_torch.data.dataset import synthetic_source
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.state import TrainState
    from ddti_tpu_torch.train.steps import make_train_step
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    if model_kw is None:
        model_kw = dict(base_filters=TRAIN["base_filters"],
                        depth=TRAIN["depth"])
    cfg = Config(image_size=size, store_size=size, batch_size=batch,
                 use_amp_autocast=amp)
    model = init_like_flax(create_model(model_type, **model_kw),
                           seed).to(DEVICE)
    src = synthetic_source(batch, (size, size), seed, device=DEVICE)
    images, masks = src.gather(list(range(batch)))
    aug = AugmentConfig(out_size=(size, size))
    draws = sample_draws(torch.Generator().manual_seed(seed), batch,
                         aug).to(DEVICE)
    state = TrainState(model, cfg.lr, 4, cfg.weight_decay)
    return model, state, make_train_step(cfg, aug), (images, masks, draws)


def step_kernel_vs_plain():
    """One float32 step from one state and batch through the kernel EDT and
    through the plain EDT (the boundary loss's EDT swapped explicitly);
    deterministic cuDNN so that only the EDT route differs."""
    import torch

    from ddti_tpu_torch.losses import losses
    from ddti_tpu_torch.ops import edt as E

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model, _, step, (images, masks, draws) = _train_setup(512, 16, False)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    try:
        for route in ("kernel", "plain"):
            from ddti_tpu_torch.train.state import TrainState

            model.load_state_dict(sd0)
            state = TrainState(model, 1e-5, 4)
            launched = E.edt_cuda.launches
            if route == "plain":
                losses.edt_batch = E.edt_reference
            m = step(state, images, masks, draws, None)
            torch.cuda.synchronize()
            assert (E.edt_cuda.launches - launched) == (route == "kernel")
            out[route] = (m.boundary.clone(), {
                k: v.clone() for k, v in model.state_dict().items()})
    finally:
        losses.edt_batch = E.edt_batch
        torch.backends.cudnn.deterministic = False
    (bk, pk), (bp, pp) = out["kernel"], out["plain"]
    rel = max(((pk[k] - pp[k]).abs().max()
               / pp[k].abs().max().clamp(min=1e-30)).item() for k in pk)
    moved = sum(not torch.equal(pk[k], sd0[k]) for k in pk)
    phase("step", f"float32 ResUNet 512^2 batch 16: boundary kernel "
          f"{bk.item():.9g} plain {bp.item():.9g} (bit-equal "
          f"{torch.equal(bk, bp)}); updated tensors {moved}/{len(pk)}, max "
          f"relative difference {rel:.3e} (limit {STEP_PARAM_RTOL:g})")
    assert torch.equal(bk, bp), "kernel and plain boundary terms differ"
    assert rel <= STEP_PARAM_RTOL and moved == len(pk)


def _plain_flash():
    """flash_attention with its kernels swapped for their plain versions
    (flash_forward_reference, flash_backward_reference) on any device."""
    import torch

    from ddti_tpu_torch.ops import attention as A

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = A.flash_forward_reference(q, k, v)
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            return A.flash_backward_reference(q, k, v, o, lse,
                                              do.contiguous().to(o.dtype))

    return PlainFlash.apply


def _flash_counts():
    from ddti_tpu_torch.ops import attention as A

    bwd = A.flash_backward_cuda
    return [A.flash_forward_cuda.launches, bwd.launches_dkdv, bwd.launches_dq]


def _normwise(a, b):
    """||a - b|| / ||b|| over every tensor of two same-keyed dicts."""
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    den = sum(float((b[k].double() ** 2).sum()) for k in b)
    return (num / den) ** 0.5


def tstep_kernel_vs_plain():
    """One float32 TransUNet step from one state and batch through the
    flash kernels and through their plain versions (swapped explicitly);
    deterministic cuDNN so that only the attention route differs. Then one
    bf16 step at the default dropout 0.1, where the gate takes the plain
    attention."""
    import math

    import torch

    from ddti_tpu_torch.models import blocks
    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.train.state import TrainState

    size, batch = TTRAIN["image_size"], TTRAIN["batch_size"]
    kw = dict(TSLICE, image_size=size)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model, _, step, (images, masks, draws) = _train_setup(
        size, batch, False, model_type="TransUNet", model_kw=kw)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    try:
        # the kernel route twice: its own run-to-run floor
        for route in ("kernel", "kernel again", "plain"):
            model.load_state_dict(sd0)
            state = TrainState(model, 1e-5, 4)
            before = _flash_counts()
            if route == "plain":
                blocks.flash_attention = _plain_flash()
            m = step(state, images, masks, draws, None)
            torch.cuda.synchronize()
            moved = [a - b for a, b in zip(_flash_counts(), before)]
            assert moved == [N_LAYERS * (route != "plain")] * 3, moved
            out[route] = (
                torch.stack([m.loss, m.bce, m.dice, m.focal,
                             m.boundary]).double(),
                {k: p.grad.clone() for k, p in model.named_parameters()},
                {k: v.clone() for k, v in model.state_dict().items()})
    finally:
        blocks.flash_attention = A.flash_attention
        torch.backends.cudnn.deterministic = False
    (tk, gk, pk), (tp, gp, pp) = out["kernel"], out["plain"]
    _, g2, p2 = out.pop("kernel again")
    term_rel = float(((tk - tp).abs() / tp.abs().clamp(min=1e-30)).max())
    grad_rel, param_rel = _normwise(gk, gp), _normwise(pk, pp)
    worst = max(gk, key=lambda k: _normwise({k: gk[k]}, {k: gp[k]}))
    phase("tstep", f"kernel route run twice: gradients normwise "
          f"{_normwise(gk, g2):.3e}, parameters {_normwise(pk, p2):.3e}; "
          f"kernels vs plain, the gradient furthest apart: {worst} "
          f"{_normwise({worst: gk[worst]}, {worst: gp[worst]}):.3e}")
    step_gap = max(float((pk[k] - pp[k]).abs().max()) for k in gk) / 1e-5
    n_moved = sum(not torch.equal(pk[k], sd0[k]) for k in pk)
    phase("tstep", f"float32 TransUNet {size}^2 batch {batch}, kernels vs "
          f"plain: loss terms kernel {tk.tolist()} plain {tp.tolist()}, max "
          f"relative difference {term_rel:.3e} (limit "
          f"{TSTEP_TERM_RTOL:g}); gradients normwise {grad_rel:.3e} (limit "
          f"{TSTEP_GRAD_RTOL:g}); updated tensors {n_moved}/{len(pk)}, "
          f"normwise {param_rel:.3e} (limit {TSTEP_PARAM_RTOL:g}), largest "
          f"parameter gap {step_gap:.3f} lr")
    assert term_rel <= TSTEP_TERM_RTOL, "kernel and plain loss terms differ"
    assert grad_rel <= TSTEP_GRAD_RTOL, "kernel and plain gradients differ"
    assert param_rel <= TSTEP_PARAM_RTOL and step_gap <= 2.001
    assert n_moved == len(pk)
    del model, step, images, masks, out, gk, gp, pk, pp, g2, p2, sd0
    torch.cuda.empty_cache()

    kw = {k: v for k, v in kw.items() if k != "dropout_rate"}  # 0.1
    _, state, step, (images, masks, draws) = _train_setup(
        size, batch, True, model_type="TransUNet", model_kw=kw)
    before = _flash_counts()
    m = step(state, images, masks, draws, None)
    torch.cuda.synchronize()
    terms = [float(t) for t in (m.loss, m.bce, m.dice, m.focal, m.boundary)]
    phase("tstep", f"bf16 TransUNet step at the default dropout 0.1: flash "
          f"launches {[a - b for a, b in zip(_flash_counts(), before)]} "
          f"(the gate takes the plain attention with probability dropout), "
          f"terms {terms}")
    assert _flash_counts() == before, "a flash kernel ran with dropout"
    assert all(math.isfinite(t) for t in terms) and terms[4] > 0
    del state, step, images, masks
    torch.cuda.empty_cache()


def _profile_steps(label, size, batch, model_type="ResUNet", model_kw=None):
    """Device time per bf16 train step (CUDA events) and a torch.profiler
    window over TRAIN_PROFILE_STEPS steps: busy share, the EDT's and the
    flash kernels' share, the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ddti_tpu_torch.ops import edt as E

    _, state, step, (images, masks, draws) = _train_setup(
        size, batch, True, model_type=model_type, model_kw=model_kw)

    def one():
        step(state, images, masks, draws, None)

    ms = median_ms(one, runs=10, warmup=3)
    torch.cuda.synchronize()
    before = [E.edt_cuda.launches, *_flash_counts()]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(TRAIN_PROFILE_STEPS):
            one()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    launched = [a - b for a, b in zip([E.edt_cuda.launches,
                                       *_flash_counts()], before)]
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in kernels)
    edt_us = sum(e.self_device_time_total for e in kernels
                 if "edt_" in e.key)
    flash_us = sum(e.self_device_time_total for e in kernels
                   if "flash_" in e.key)
    phase("tprofile", f"{label}: bf16 train step {size}^2 batch {batch}: "
          f"{ms:.3f} ms device time (CUDA events, median of 10), "
          f"{batch / ms * 1e3:.1f} img/s; torch.profiler over "
          f"{TRAIN_PROFILE_STEPS} steps: window {window_us / 1e3:.3f} ms, "
          f"device kernels {busy_us / 1e3:.3f} ms "
          f"({busy_us / max(window_us, 1):.1%} busy), EDT kernels "
          f"{edt_us / 1e3:.3f} ms ({edt_us / max(busy_us, 1):.2%} of "
          f"device time), flash kernels {flash_us / 1e3:.3f} ms "
          f"({flash_us / max(busy_us, 1):.2%}); launches edt/flash_fwd/"
          f"flash_bwd_dkdv/flash_bwd_dq {launched}")
    if not kernels:
        phase("tprofile", "no device time recorded: breakdown not measured")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[
            :PROFILE_TOP]:
        phase("tprofile", f"{e.self_device_time_total / busy_us:6.1%} "
              f"{e.count:4d} x "
              f"{e.self_device_time_total / e.count / 1e3:.4f} ms  "
              f"{e.key[:90]}")
    del state, step, images, masks, prof
    torch.cuda.empty_cache()
    return dict(model=label, size=size, batch=batch, ms=ms,
                busy=busy_us / max(window_us, 1),
                edt_share=edt_us / max(busy_us, 1),
                flash_share=flash_us / max(busy_us, 1))


def profile_training():
    """The ResUNet train step at TRAIN_PROFILES."""
    return [_profile_steps("ResUNet bf64 d5", size, batch)
            for size, batch in TRAIN_PROFILES]


def profile_transunet():
    """The TransUNet train step on the kernel and the plain attention path:
    the slice's model at S = 1024, and the S = 4096 one at the largest
    batch of TLONG_BATCHES whose plain path fits in device memory."""
    import gc

    import torch

    size, batch = TTRAIN["image_size"], TTRAIN["batch_size"]
    rows = []
    for path, flash in (("kernel", None), ("plain", False)):
        kw = dict(TSLICE, image_size=size, use_flash_attention=flash)
        rows.append(_profile_steps(f"TransUNet bf64 d4 S=1024 {path}", size,
                                   batch, "TransUNet", kw))
    kw = dict(TLONG, image_size=size)
    for batch in TLONG_BATCHES:
        try:
            plain = _profile_steps(
                "TransUNet bf32 d3 S=4096 plain", size, batch, "TransUNet",
                dict(kw, use_flash_attention=False))
            break
        except torch.cuda.OutOfMemoryError:
            phase("tprofile", f"TransUNet bf32 d3 S=4096 plain path at "
                  f"batch {batch}: out of device memory, halving")
        gc.collect()
        torch.cuda.empty_cache()
    rows.append(_profile_steps("TransUNet bf32 d3 S=4096 kernel", size,
                               batch, "TransUNet", kw))
    rows.append(plain)
    return rows


def main():
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)  # as nvidia-smi prints it: name, power limit
    phase("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ddti_tpu_torch.ops import _build

    path, secs = _build.build()
    _build.load_library()
    phase("build", f"nvcc {' '.join(_build.NVCC_FLAGS)}, one process per "
          f"source: {f'{secs:.2f} s' if secs else 'already built'} -> "
          f"{os.path.relpath(path)}")

    rows = check_kernels()
    bwd_rows = check_bwd_kernels()
    edt_rows = check_edt()
    with tempfile.TemporaryDirectory() as tmp:
        launches, ckpt = run_slice(tmp)
        profile_slice(ckpt)
        edt_launches = run_training(tmp)
        t_launches = run_transunet_training(tmp)
    step_kernel_vs_plain()
    tstep_kernel_vs_plain()
    train_rows = profile_training()
    ttrain_rows = profile_transunet()

    phase("result", f"total wall time {time.perf_counter() - t_start:.1f} s")
    main_row = rows[0]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ddti_tpu/ops/attention.py:347",
        "also_replaces": "ddti_tpu/ops/attention.py:104",
        "launches": launches,
        "train_launches": t_launches["flash_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "shapes": rows,
    }, {
        "name": "flash_bwd_dkdv",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "ddti_tpu/ops/attention.py:405",
        "also_replaces": "ddti_tpu/ops/attention.py:180",
        "launches": t_launches["flash_bwd_dkdv"],
        "max_abs_err": max(max(r["abs_err"]["dk"], r["abs_err"]["dv"])
                           for r in bwd_rows),
        "max_rel_err": max(max(r["rel_err"]["dk"], r["rel_err"]["dv"])
                           for r in bwd_rows),
        "ms": bwd_rows[0]["ms_dkdv"],
        "plain_ms": bwd_rows[0]["plain_ms"],
        "plain_covers": "flash_backward_reference: dq, dk and dv together",
        "shapes": bwd_rows,
        "train_steps": ttrain_rows,
    }, {
        "name": "flash_bwd_dq",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "ddti_tpu/ops/attention.py:450",
        "also_replaces": "ddti_tpu/ops/attention.py:222",
        "launches": t_launches["flash_bwd_dq"],
        "max_abs_err": max(r["abs_err"]["dq"] for r in bwd_rows),
        "max_rel_err": max(r["rel_err"]["dq"] for r in bwd_rows),
        "ms": bwd_rows[0]["ms_dq"],
        "plain_ms": bwd_rows[0]["plain_ms"],
        "plain_covers": "flash_backward_reference: dq, dk and dv together",
    }, {
        "name": "edt_minplus",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/edt.cu",
        "replaces": "ddti_tpu/ops/edt.py:81",
        "launches": edt_launches,
        "max_abs_err": max(r["max_abs_err"] for r in edt_rows),
        "ms": edt_rows[0]["ms"],
        "plain_ms": edt_rows[0]["plain_ms"],
        "shapes": edt_rows,
        "train_steps": train_rows,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
