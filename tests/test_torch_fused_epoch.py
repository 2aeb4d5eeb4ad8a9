"""``--fused_epoch`` on the CPU: the precomputed-epoch loop (the same loop
the card runs as one eager step and CUDA graph replays) against the
stepwise epoch bit for bit, with the train-step options, the augmentation
branches, the nan_guard on the device and a distillation teacher; the
device-side guard against the host one; the epoch-granularity stop; the
fused and stepwise epochs' metrics against JAX's ``make_scan_epoch`` on
the same weights, batches and draws (the statistics level of
test_torch_train.py's CLI runs); the gated branches' dense draws (the
fixed shapes a CUDA graph replays) against their sparse ones; and the
CLI."""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.core import Config as JConfig
from ddti_tpu.data.augment import AugmentConfig as JAugmentConfig
from ddti_tpu.eval.metrics import epoch_metrics_from_counts as jepoch_metrics
from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.train.state import create_train_state
from ddti_tpu.train.steps import make_scan_epoch
from ddti_tpu.train.torch_interop import export_state_dict
from ddti_tpu_torch.cli import main as tmain
from ddti_tpu_torch.core.config import Config
from ddti_tpu_torch.core.logging import create_logger
from ddti_tpu_torch.data.augment import AugmentConfig
from ddti_tpu_torch.data.dataset import synthetic_source
from ddti_tpu_torch.models import create_model
from ddti_tpu_torch.train import engine
from ddti_tpu_torch.train.checkpoint import save_weights
from ddti_tpu_torch.train.engine import Trainer
from ddti_tpu_torch.train.state import TrainState
from ddti_tpu_torch.train.steps import StepMetrics, accumulate, make_train_step
from ddti_tpu_torch.utils.weight_init import init_like_flax

from test_torch_augment import jax_draws

SMALL = dict(in_channels=1, out_channels=1, base_filters=4, depth=2)
SIZE, BATCH, N_TRAIN = 32, 4, 14  # 4 steps an epoch, the last one padded


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: xdist runs six of these processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _config(tmp_path, name, **kw):
    kw = dict(dict(epochs=2, lr=1e-3), **kw)
    cfg = Config(model_type="ResUNet", image_size=SIZE, store_size=SIZE,
                 batch_size=BATCH, log_every=0, base_dir=str(tmp_path / name),
                 model_kwargs=dict(SMALL), **kw)
    cfg.make_dirs()
    return cfg


def _trainer(tmp_path, name, sd0, remat=False, **kw):
    cfg = _config(tmp_path, name, **kw)
    src = synthetic_source(N_TRAIN, (SIZE, SIZE), 3)
    model = create_model("ResUNet", **SMALL, remat=remat)
    model.load_state_dict(sd0)
    logger = create_logger(os.path.join(cfg.log_dir, "train_log.log"),
                           console=False)
    return Trainer(cfg, (src, src, src), logger, model), cfg


def _state(tr):
    """Every tensor of the train state, and its step."""
    full = tr.state.full_state_dict()
    flat = {f"model/{k}": v for k, v in full["model"].items()}
    for k, st in full["adam"].items():
        flat.update({f"adam/{k}/{m}": v for m, v in st.items()})
    for k, v in (full.get("ema") or {}).items():
        flat[f"ema/{k}"] = v
    return flat, full["step"]


def _train_lines(cfg):
    text = open(os.path.join(cfg.log_dir, "train_log.log")).read()
    return [line.split(" - ", 2)[-1] for line in text.splitlines()
            if "Train Epoch" in line or "IoU" in line
            or "Boundary Loss" in line or "step(s) skipped" in line]


@pytest.fixture(scope="module")
def start():
    return init_like_flax(create_model("ResUNet", **SMALL), 0).state_dict()


@pytest.fixture(scope="module")
def teacher_ckpt(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("teacher") / "t")
    m = init_like_flax(create_model("ResUNet", **SMALL), 7)
    save_weights(base, "ResUNet", m)
    return base + ".npz"


CASES = {
    "default": {},
    "step options": dict(grad_accum=2, ema_decay=0.9, clip_grad_norm=0.5,
                         freeze="encoders_0", freeze_bn_stats=True),
    "augmentation": dict(use_mixup=True, mixup_prob=1.0, p_crop=0.5,
                         use_tgc=True, use_elastic=True, use_speckle=True,
                         use_clahe=True, aug_fast_warp=False),
    "nan_guard": dict(nan_guard=True, bn_exact_variance=True),
    "remat": dict(remat=True),
    "distillation": dict(distill_weight=0.3, distill_temperature=3.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_fused_epoch_equals_the_stepwise_epoch(case, tmp_path, start,
                                               teacher_ckpt):
    """Two epochs each way from one start: every tensor of the state
    (parameters, BatchNorm statistics, AdamW's moments and steps, the EMA)
    bit for bit, the step count, and the logged epoch metrics."""
    kw = dict(CASES[case])
    if case == "distillation":
        kw["distill_checkpoint"] = teacher_ckpt
    runs = {}
    for name, fused in (("stepwise", False), ("fused", True)):
        tr, cfg = _trainer(tmp_path, name, start, fused_epoch=fused, **kw)
        assert tr.fused == fused
        for epoch in range(2):
            tr.train_one_epoch(epoch)
        runs[name] = (*_state(tr), _train_lines(cfg))
    (a, step_a, lines_a), (b, step_b, lines_b) = runs.values()
    assert step_a == step_b == 8
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
    assert lines_a == lines_b and len(lines_a) >= 6


def test_device_guard_equals_the_host_guard(start):
    """A finite step, a non-finite one, a finite one: the device-side
    guard (snapshot and select) leaves the state and metrics the host-side
    guard leaves, bit for bit."""
    cfg = Config(image_size=SIZE, batch_size=BATCH, nan_guard=True,
                 ema_decay=0.9)
    src = synthetic_source(BATCH, (SIZE, SIZE), 1)
    images, masks = src.gather(np.arange(BATCH))
    bad = images.float() / 255.0
    bad[-1, 3, 5, 0] = float("nan")
    draws = engine.sample_draws(torch.Generator().manual_seed(0), BATCH,
                                AugmentConfig(out_size=(SIZE, SIZE)))
    out = []
    for device_guard in (False, True):
        model = create_model("ResUNet", **SMALL)
        model.load_state_dict(start)
        state = TrainState(model, 1e-3, 4, ema=True, nan_guard=True)
        if device_guard:
            state.init_optimizer_state()
        step = make_train_step(cfg, AugmentConfig(out_size=(SIZE, SIZE)),
                               device_guard=device_guard)
        mets = [step(state, x, y, draws, None) for x, y in (
            (images, masks), (bad, masks.float() / 255.0), (images, masks))]
        out.append((mets, state.model.state_dict(), state.ema,
                    {k: dict(v) for k, v in
                     state.full_state_dict()["adam"].items()}))
    (ma, sda, ea, oa), (mb, sdb, eb, ob) = out
    assert [float(m.skipped) for m in mb] == [0.0, 1.0, 0.0]
    for x, y in zip(ma, mb):
        for u, v in zip(x[:5] + (x.n,), y[:5] + (y.n,)):
            assert torch.equal(torch.as_tensor(u), torch.as_tensor(v))
        for u, v in zip(x.counts, y.counts):
            assert torch.equal(u, v)
    for k in sda:
        assert torch.equal(sda[k], sdb[k]), k
    for k in ea:
        assert torch.equal(ea[k], eb[k]), k
    for k in oa:
        for m in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(oa[k][m], ob[k][m]), (k, m)


def test_fused_nan_guard_stops_once_a_whole_epoch_is_rejected(tmp_path,
                                                              start):
    """Non-finite weights make every step non-finite: the fused epoch
    skips all of them on the device (the state kept, the step count
    unmoved) and the run stops at epoch granularity, with JAX's warnings."""
    sd = dict(start)
    sd["final_conv.weight"] = torch.full_like(sd["final_conv.weight"],
                                              float("nan"))
    tr, cfg = _trainer(tmp_path, "nan", sd, fused_epoch=True,
                       nan_guard=True, epochs=3)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.train()
    log = open(os.path.join(cfg.log_dir, "train_log.log")).read()
    assert "degrades to EPOCH granularity" in log
    assert "every step of the fused epoch was non-finite" in log
    assert "4 step(s) skipped in epoch 1" in log
    assert "Train Epoch: 2" not in log
    assert tr.state.step == 0
    after = tr.model.state_dict()
    for k, v in before.items():
        assert torch.equal(v, after[k]) or torch.isnan(v).any(), k


def test_a_streaming_source_keeps_the_stepwise_loop(tmp_path, start):
    class Stream:  # a host-streaming source: no epoch_batches
        dataset = list(range(8))

        def __iter__(self):
            return iter(())

    cfg = _config(tmp_path, "stream", fused_epoch=True)
    model = create_model("ResUNet", **SMALL)
    tr = Trainer(cfg, (Stream(), Stream(), Stream()),
                 create_logger(str(tmp_path / "l.txt"), console=False),
                 model)
    assert not tr.fused and not tr.state.capturable  # the CPU's AdamW


def test_accumulate_in_place_equals_accumulate():
    g = torch.Generator().manual_seed(0)

    def metrics():
        r = torch.rand(8, generator=g)
        counts = engine.ConfusionCounts(*(torch.rand(
            (), generator=g, dtype=torch.float64) * 1e4 for _ in range(6)))
        return StepMetrics(*r[:5], counts, r[5] * 16, 0.0)

    ms = [metrics() for _ in range(5)]
    total, inplace = None, engine.zero_metrics("cpu")
    for m in ms:
        total = accumulate(total, m)
        engine.accumulate_(inplace, m)
    for a, b in zip(total[:5] + (total.n,), inplace[:5] + (inplace.n,)):
        assert torch.equal(a, b)
    for a, b in zip(total.counts, inplace.counts):
        assert torch.equal(a, b)
    assert float(inplace.skipped) == 0.0


@pytest.mark.parametrize("gates", ["some", "none", "all"])
def test_dense_draws_augment_as_the_sparse_ones(gates):
    """The elastic, speckle and CLAHE branches from ``dense_draws`` (every
    image run, the gated ones kept) and from the sparse draws (the gated
    images alone): the same images and masks bit for bit, whichever
    images the gates pick, at a side that is not a multiple of the CPU's
    vector width."""
    from ddti_tpu_torch.data.augment import (
        augment_batch,
        dense_draws,
        sample_draws,
    )

    p = {"some": 0.5, "none": 0.0, "all": 1.0}[gates]
    cfg = AugmentConfig(use_elastic=True, use_speckle=True, use_clahe=True,
                        p_elastic=p, p_speckle=p, p_clahe=p,
                        out_size=(36, 36))
    n, hw = 6, (36, 36)
    rng = np.random.default_rng(5)
    images = torch.from_numpy(rng.random((n, *hw, 1), dtype=np.float32))
    masks = torch.from_numpy((rng.random((n, *hw, 1)) > 0.6)
                             .astype(np.float32))
    draws = sample_draws(torch.Generator().manual_seed(9), n, cfg, hw)
    k = len(draws.elastic_idx)
    assert {"some": 0 < k < n, "none": k == 0, "all": k == n}[gates]
    dense = dense_draws(draws, n)
    assert dense.elastic_idx.dtype == torch.bool
    assert dense.elastic_dx.shape == (n, *hw)
    assert int(dense.clahe_idx.sum()) == len(draws.clahe_idx)
    a = augment_batch(images, masks, draws, cfg)
    b = augment_batch(images, masks, dense, cfg)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert dense_draws(dense, n).elastic_dx is dense.elastic_dx


def _epoch_avgs(log_text):
    loss = [float(v) for v in re.findall(
        r"Train Epoch: \d+, Avg Loss: ([\d.]+)", log_text)]
    iou = [float(v) for v in re.findall(r"IoU: ([\d.]+)\n", log_text)]
    return loss, iou


def test_fused_and_stepwise_epochs_match_jax_scan_epoch(tmp_path,
                                                        monkeypatch):
    """JAX's one-program epoch and the port's stepwise and fused epochs
    from the same weights, batch order and draws (JAX's, fed to the port),
    both packages at their default one-pass BatchNorm: the epoch's average
    loss and IoU within 2e-3 (the logs' 4 decimals, as
    test_torch_train.py's CLI runs are held)."""
    seed = 42
    jm = jcreate_model("ResUNet", **SMALL)
    v = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros(
        (1, SIZE, SIZE, 1)), train=False))(jax.random.PRNGKey(1))
    params, stats = v["params"], v["batch_stats"]
    sd0 = {k: torch.from_numpy(np.ascontiguousarray(a)) for k, a in
           export_state_dict("ResUNet", params, stats).items()}
    jcfg = JConfig(image_size=SIZE, store_size=SIZE, batch_size=BATCH,
                   lr=1e-3, seed=seed)
    acfg = JAugmentConfig(fast_warp=True, out_size=(SIZE, SIZE))
    src = synthetic_source(N_TRAIN, (SIZE, SIZE), 3)
    idx = np.stack(list(src.epoch_batches(np.random.default_rng((seed, 0)),
                                          BATCH)))
    state = create_train_state(jm, jax.random.PRNGKey(0), (1, SIZE, SIZE, 1),
                               1e-3, len(idx), 1e-2)
    state = state.replace(params=params, batch_stats=stats)
    ekey = jax.random.fold_in(jax.random.PRNGKey(seed), 0)
    _, stacked = make_scan_epoch(jcfg, acfg)(
        state, jnp.asarray(src.images.numpy()), jnp.asarray(src.masks.numpy()),
        jnp.asarray(idx), ekey)
    stacked = jax.device_get(stacked)
    n = stacked.n.sum()
    jloss = float((stacked.loss * stacked.n).sum() / n)
    jiou = jepoch_metrics(type(stacked.counts)(
        *(c.sum() for c in stacked.counts)))["iou"]

    def draws(self, epoch, step, n):
        k = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(seed),
                                                  epoch), step)
        return jax_draws(jax.random.split(k, 3)[0], n, acfg), None

    monkeypatch.setattr(Trainer, "_draws", draws)
    for fused in (False, True):
        tr, cfg = _trainer(tmp_path, f"f{fused}", sd0, fused_epoch=fused,
                           seed=seed)
        tr.train_one_epoch(0)
        loss, iou = _epoch_avgs(open(os.path.join(
            cfg.log_dir, "train_log.log")).read())
        assert loss[0] == pytest.approx(jloss, abs=2e-3), fused
        assert iou[0] == pytest.approx(jiou, abs=2e-3), fused


def test_cli_fused_epoch_logs_what_the_stepwise_run_logs(tmp_path):
    flags = ["--mode", "train", "--synthetic", "--device", "cpu",
             "--base_filters", "4", "--depth", "2", "--image_size", "32",
             "--store_size", "32", "--batch_size", "16", "--epochs", "2",
             "--log_every", "0"]
    assert tmain.get_parser().parse_args([]).fused_epoch is False
    logs = []
    for extra in ([], ["--fused_epoch"]):
        base = tmp_path / ("fused" if extra else "stepwise")
        assert tmain.main(flags + extra + ["--base_dir", str(base)]) == 0
        (log,) = base.glob("*/log/train_log.log")
        logs.append([line.split(" - ", 2)[-1]
                     for line in log.read_text().splitlines()
                     if "Epoch:" in line or "IoU" in line])
    assert logs[0] == logs[1] and len(logs[0]) == 10

