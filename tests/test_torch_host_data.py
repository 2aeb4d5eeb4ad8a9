"""The port's host data path against the JAX package's, on the CPU: the
``.store_cache`` (one cache key, each package reading the other's store),
``decode_to_store``'s native stores, ``HostBatchIterator``'s batches, one
``make_host_train_step`` step, and the Trainer and the training CLI fed by
each streaming source (``--host_augment`` and ``--native_loader on``).
"""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from ddti_tpu.core import Config as JConfig
from ddti_tpu.data import dataset as jd
from ddti_tpu.data import host_transforms as jht
from ddti_tpu.models import blocks as jblocks
from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.train.state import create_train_state
from ddti_tpu.train.steps import make_host_train_step as jmake_host_step
from ddti_tpu.train.torch_interop import export_state_dict
from ddti_tpu_torch.cli import main as tmain
from ddti_tpu_torch.core.config import Config
from ddti_tpu_torch.core.logging import create_logger
from ddti_tpu_torch.data import dataset as td
from ddti_tpu_torch.data import host_transforms as tht
from ddti_tpu_torch.data.augment import MixupDraws
from ddti_tpu_torch.data.synthetic import (
    generate_ddti_like,
    write_synthetic_dataset,
)
from ddti_tpu_torch.models import blocks, create_model
from ddti_tpu_torch.runtime import NativeSource
from ddti_tpu_torch.train import engine
from ddti_tpu_torch.train.state import TrainState
from ddti_tpu_torch.train.steps import make_host_train_step

SMALL = dict(in_channels=1, out_channels=1, base_filters=8, depth=3)
SIZE, BATCH, LR = 64, 4, 1e-5
TINY = ["--base_filters", "4", "--depth", "2", "--image_size", "32",
        "--store_size", "32", "--batch_size", "4", "--epochs", "2",
        "--log_every", "0", "--device", "cpu", "--mode", "both"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs beside other workers' tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = tmp_path_factory.mktemp("ds")
    write_synthetic_dataset(str(r), n_train=10, n_val=4, n_test=4,
                            size=(40, 40), seed=1)
    return str(r)


def _both(root, split="train", jtf=None, ttf=None):
    args = (os.path.join(root, split), os.path.join(root, f"{split}_mask"))
    return jd.MedicalDataset(*args, jtf), td.MedicalDataset(*args, ttf)


def test_store_cache_is_shared_with_jax(root, tmp_path):
    """One key: each package reads the store the other wrote (the files
    are overwritten with a marker after writing, so a re-decode would
    show), and the decoded stores agree bit for bit, native and PIL."""
    jds, tds = _both(root)
    size = (24, 24)
    for cache in (tmp_path / "a", tmp_path / "b"):
        assert td.store_cache_paths(tds, size, str(cache)) \
            == jd.store_cache_paths(jds, size, str(cache))
    for native in (True, False):
        want = jd.decode_to_store(jds, size, use_native=native)
        got = td.decode_to_store(tds, size, use_native=native)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        assert got[0].shape == (10, 24, 24, 1) and got[0].dtype == np.uint8
    for writer, reader, cache in ((jd, td, "a"), (td, jd, "b")):
        c = str(tmp_path / cache)
        ds = jds if writer is jd else tds
        imgs, _ = writer.decode_to_store(ds, size, cache_dir=c)
        ip, mp = td.store_cache_paths(tds, size, c)
        np.full(os.path.getsize(ip), 7, np.uint8).tofile(ip)
        got_i, got_m = reader.decode_to_store(jds if reader is jd else tds,
                                              size, cache_dir=c)
        assert (got_i == 7).all() and got_m.shape == imgs.shape
        assert reader.decode_to_store_files(
            jds if reader is jd else tds, size, c) == (ip, mp, 10)
    assert sorted(os.listdir(tmp_path / "b")) == sorted(
        os.path.basename(p)
        for p in td.store_cache_paths(tds, size, str(tmp_path / "b")))


def test_host_batch_iterator_matches_jax(root):
    """Elastic and speckle on: with the JAX side's global np.random seeded
    with the port's field seed, both iterators yield the same batches,
    epoch by epoch after set_epoch and from their stateful streams; the
    port's epoch replays bit for bit (its --resume), the short last
    batch kept."""
    chain = dict(use_elastic=True, use_speckle=True, use_tgc=True,
                 use_clahe=True, out_size=(32, 32))
    jds, tds = _both(root, "train", jht.build_train_chain(**chain),
                     tht.build_train_chain(**chain))
    jit = jd.HostBatchIterator(jds, 4, shuffle=True, seed=5)
    tit = td.HostBatchIterator(tds, 4, shuffle=True, seed=5)
    for epoch in (None, 0, 1, None):
        if epoch is not None:
            jit.set_epoch(epoch)
            tit.set_epoch(epoch)
        got = list(tit)
        np.random.seed(tit.field_seed)
        want = list(jit)
        assert [b[0].shape[0] for b in got] == [4, 4, 2]
        for (gi, gm), (wi, wm) in zip(got, want):
            assert gi.dtype == np.float32
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gm, wm)
    tit.set_epoch(1)
    again = list(tit)
    tit.set_epoch(1)
    for (a, b), (c, d) in zip(again, list(tit)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    # an eval chain in __getitem__, as the JAX dataset applies it
    jev, tev = _both(root, "val", jht.build_eval_chain((16, 16)),
                     tht.build_eval_chain((16, 16)))
    for a, b in zip(tev[1], jev[1]):
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def two_pass_bn():
    # both packages in two passes: flax's use_fast_variance=False and
    # the port's BatchNorm2d.exact_variance (--bn_exact_variance)
    jblocks.set_bn_fast_variance(False)
    blocks.BatchNorm2d.exact_variance = True
    yield
    jblocks.set_bn_fast_variance(True)
    blocks.BatchNorm2d.exact_variance = False


def test_host_train_step_matches_jax(two_pass_bn):
    """One --host_augment step from the same weights on one float32 batch
    that the host chain made, with mixup on and JAX's draws: loss terms to
    1e-5, BN statistics to 1e-5 normwise, parameters after the AdamW
    update to 1e-5 normwise (JAX's float32 parity bar of
    test_torch_train.py's step, which the host step's shared body
    meets)."""
    jm = jcreate_model("ResUNet", **SMALL)
    v = jax.jit(lambda k: jm.init({"params": k},
                                  jnp.zeros((1, SIZE, SIZE, 1)),
                                  train=False))(jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = v["params"]
    stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape).astype(
        np.float32), v["batch_stats"])
    chain = tht.build_train_chain(True, True, out_size=(SIZE, SIZE))
    frames, masks = generate_ddti_like(BATCH, (80, 80), 3)
    r, nprng = random.Random(0), np.random.RandomState(0)
    pairs = [chain(Image.fromarray(f[..., 0]), Image.fromarray(m[..., 0]),
                   r, nprng) for f, m in zip(frames, masks)]
    images = np.stack([p[0] for p in pairs])
    targets = np.stack([p[1] for p in pairs])

    jcfg = JConfig(image_size=SIZE, batch_size=BATCH, lr=LR,
                   bn_exact_variance=True, use_mixup=True, mixup_prob=1.0)
    state = create_train_state(jm, jax.random.PRNGKey(0),
                               (1, SIZE, SIZE, 1), LR, 16, 1e-2)
    state = state.replace(params=params, batch_stats=stats)
    # the port's copy first: JAX's step donates the state it is given
    m = create_model("ResUNet", **SMALL)
    m.load_state_dict({k: torch.from_numpy(np.array(x))
                       for k, x in export_state_dict(
                           "ResUNet", params, stats).items()})
    key = jax.random.PRNGKey(4)
    jstate, jmet = jmake_host_step(jcfg)(state, jnp.asarray(images),
                                         jnp.asarray(targets), key)
    k_mix = jax.random.split(key, 3)[1]
    _, k_lam, k_perm = jax.random.split(k_mix, 3)
    mix = MixupDraws(
        torch.tensor(float(jax.random.beta(k_lam, 0.2, 0.2))),
        torch.from_numpy(np.array(jax.random.permutation(k_perm, BATCH))
                         ).long())
    assert float(mix.lam) < 1.0

    tstate = TrainState(m, LR, 16, 1e-2)
    tmet = make_host_train_step(jcfg)(tstate, torch.from_numpy(images),
                                      torch.from_numpy(targets), mix)
    for name in ("loss", "bce", "dice", "focal", "boundary"):
        assert float(getattr(tmet, name)) == pytest.approx(
            float(getattr(jmet, name)), rel=1e-5), name
    assert float(tmet.boundary) > 0 and tstate.step == 1
    want = export_state_dict("ResUNet", jstate.params, jstate.batch_stats)
    t_all, w_all = [], []
    for k, t in m.state_dict().items():
        t, w = t.numpy(), np.asarray(want[k])
        if "running_" in k:
            assert np.linalg.norm(t - w) / np.linalg.norm(w) < 1e-5, k
        else:
            t_all.append(t.ravel())
            w_all.append(w.ravel())
    t_all, w_all = np.concatenate(t_all), np.concatenate(w_all)
    assert np.linalg.norm(t_all - w_all) / np.linalg.norm(w_all) < 1e-5


def test_trainer_takes_streaming_sources(root, tmp_path):
    """The Trainer on a NativeSource (uint8, the device chain) and on
    HostBatchIterators (float32, the host step): steps an epoch from
    num_batches or the dataset's length, set_epoch before each epoch,
    validation and test with unnamed audit rows."""
    cfg = Config(model_type="ResUNet", image_size=32, store_size=32,
                 batch_size=4, epochs=1, log_every=0, base_dir=str(tmp_path),
                 surface_metrics=False, async_best_save=False)
    cfg.make_dirs()
    logger = create_logger(os.path.join(cfg.log_dir, "log.txt"))
    model = create_model("ResUNet", in_channels=1, out_channels=1,
                         base_filters=4, depth=2)
    host = tmain.load_host_sources(
        Config(dataset_path=root, image_size=32, store_size=32,
               batch_size=4, use_speckle=True, seed=3))
    calls = []
    host[0].set_epoch = lambda e, _f=host[0].set_epoch: (calls.append(e),
                                                         _f(e))
    tr = engine.Trainer(cfg, host, logger, model)
    assert tr.steps_per_epoch == 3
    tr.train()
    assert calls == [0]
    m = tr.test(visualize=False)
    assert m["tp"] + m["fp"] + m["fn"] + m["tn"] == 4 * 32 * 32
    rows = open(os.path.join(cfg.result_dir, "per_image_metrics.csv")
                ).read().splitlines()
    assert len(rows) == 5 and all(",," in r or r.split(",")[1] == ""
                                  for r in rows[1:])

    native = tmain.load_sources(Config(dataset_path=root, store_size=32,
                                       batch_size=4, seed=3), "cpu", False,
                                native="on")
    assert isinstance(native[0], NativeSource)
    assert isinstance(native[1], td.DeviceDataSource)
    tr = engine.Trainer(cfg, native, logger, create_model(
        "ResUNet", in_channels=1, out_channels=1, base_filters=4, depth=2))
    assert tr.steps_per_epoch == 3 and tr._frame_hw == (32, 32)
    step0 = tr.state.step
    tr.train_one_epoch(0)
    assert tr.state.step == step0 + 3
    native[0].loader.close()


@pytest.mark.parametrize("flags", [
    ["--host_augment", "--use_elastic", "--use_speckle", "--use_tgc",
     "--use_clahe"],
    ["--native_loader", "on"]], ids=["host_augment", "native_loader"])
def test_cli_trains_from_each_source(root, tmp_path, flags, capsys):
    """The training CLI on --device cpu from the dataset on disk, through
    each streaming source: exit 0, the run tree, finite epoch losses and
    the test metrics; the native run leaves its .store_cache beside the
    dataset, in the JAX CLI's file names."""
    rc = tmain.main(["--dataset_path", root, "--base_dir",
                     str(tmp_path), *TINY, *flags])
    assert rc == 0
    out = capsys.readouterr().out
    assert "[PARAMS] ResUNet," in out and "Test Metrics" in out
    (run,) = os.listdir(tmp_path)
    log = open(os.path.join(tmp_path, run, "log", "train_log.log")).read()
    assert log.count("Train Epoch:") == 2 and "nan" not in log.split(
        "Test Metrics")[0].lower()
    assert os.path.isfile(os.path.join(tmp_path, run, "models",
                                       "ResUNet_best.pth"))
    if "--native_loader" in flags:
        cache = os.path.join(root, ".store_cache")
        jds, _ = _both(root)
        ip, mp = jd.store_cache_paths(jds, (32, 32), cache)
        assert os.path.getsize(ip) == os.path.getsize(mp) == 10 * 32 * 32
