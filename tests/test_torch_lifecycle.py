"""The port's run lifecycle (ddti_tpu_torch/train/{state,checkpoint,
engine}.py, cli/main.py) on the CPU, mirroring the JAX package's
tests/test_preempt.py and tests/test_checkpoint_manager.py: the full train
state saved and restored bit for bit, a run resumed at an epoch boundary
bit-equal to the uninterrupted run, the optimizer structure check, the
EMA seed and drop rules, rotated periodic checkpoints, graceful SIGTERM
(in validate, mid-epoch, a second signal, a worker thread), the async
best saver, and the CLI's exit 75, resume hint and --resume.

Tolerance: none. Everything restored or resumed is held bit for bit
(``torch.equal``) on the CPU.
"""

import fcntl
import json
import logging
import os
import pathlib
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from ddti_tpu_torch.cli import main as tmain
from ddti_tpu_torch.core.config import Config
from ddti_tpu_torch.core.logging import create_logger
from ddti_tpu_torch.data.dataset import DeviceDataSource
from ddti_tpu_torch.data.synthetic import generate_ddti_like
from ddti_tpu_torch.models import create_model
from ddti_tpu_torch.train import checkpoint as ck
from ddti_tpu_torch.train.engine import Trainer, _AsyncBestSaver
from ddti_tpu_torch.train.state import TrainState
from ddti_tpu_torch.utils.weight_init import init_like_flax

ROOT = pathlib.Path(__file__).resolve().parents[1]
SMALL = dict(base_filters=4, depth=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: xdist runs six of these processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trainer(tmp_path, epochs=3, n_train=16, batch=8, **kw):
    cfg = Config(epochs=epochs, batch_size=batch, image_size=32,
                 store_size=32, lr=1e-3, model_type="UNet",
                 base_dir=str(tmp_path), log_every=0, **kw)
    cfg.make_dirs()
    logger = create_logger(os.path.join(cfg.log_dir, "log.log"),
                           console=False)
    srcs = tuple(DeviceDataSource(*generate_ddti_like(n, (32, 32), s))
                 for n, s in ((n_train, 0), (8, 1), (8, 2)))
    model = init_like_flax(create_model("UNet", **SMALL), 0)
    return Trainer(cfg, srcs, logger, model)


def _assert_full_equal(a: dict, b: dict, where=""):
    """Two full-state trees equal bit for bit, key for key."""
    assert a.keys() == b.keys(), where
    for k in a:
        if isinstance(a[k], dict):
            _assert_full_equal(a[k], b[k], f"{where}/{k}")
        elif isinstance(a[k], torch.Tensor):
            assert a[k].dtype == b[k].dtype, f"{where}/{k}"
            assert torch.equal(a[k].cpu(), b[k].cpu()), f"{where}/{k}"
        else:
            assert a[k] == b[k], f"{where}/{k}"


def _stepped_state(ema=True, freeze=(), steps=3, seed=0):
    """A UNet TrainState after ``steps`` AdamW updates of random
    gradients (every moment and the EMA moved)."""
    model = init_like_flax(create_model("UNet", **SMALL), seed)
    st = TrainState(model, 1e-3, 4, model_type="UNet", freeze=freeze,
                    ema=ema)
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for p in st.trainable:
            p.grad = torch.randn(p.shape, generator=g)
        st.apply_gradients()
        st.update_ema(0.9)
    return st


def _fresh_state(ema=True, freeze=(), seed=7):
    model = init_like_flax(create_model("UNet", **SMALL), seed)
    return TrainState(model, 1e-3, 4, model_type="UNet", freeze=freeze,
                      ema=ema)


# ------------------------------------------------------------ full state

@pytest.mark.parametrize("ema", [False, True])
def test_full_state_roundtrip_is_bit_equal(tmp_path, ema):
    st = _stepped_state(ema=ema)
    ck.save_checkpoint(str(tmp_path / "s"), st)
    assert os.listdir(tmp_path / "s") == [ck.STATE_FILE]  # no tmp left
    fresh = ck.restore_checkpoint(str(tmp_path / "s"), _fresh_state(ema))
    assert fresh.step == 3
    _assert_full_equal(st.full_state_dict(), fresh.full_state_dict())
    # AdamW continues identically from both
    for s in (st, fresh):
        for p in s.trainable:
            p.grad = torch.ones_like(p)
        s.apply_gradients()
    _assert_full_equal(st.full_state_dict(), fresh.full_state_dict())


def test_restore_before_any_step(tmp_path):
    """A state saved before its first update (AdamW's state still empty)
    restores to one that steps exactly as a fresh one."""
    st = _fresh_state(seed=1)
    ck.save_checkpoint(str(tmp_path / "s"), st)
    fresh = ck.restore_checkpoint(str(tmp_path / "s"), _fresh_state(seed=2))
    for s in (st, fresh):
        for p in s.trainable:
            p.grad = torch.full_like(p, 0.5)
        s.apply_gradients()
    _assert_full_equal(st.full_state_dict(), fresh.full_state_dict())


@pytest.mark.parametrize("saved, run", [
    (("encoders_0",), ("encoders_1",)),   # different frozen tensors
    ((), ("decoders",)),                   # more frozen on resume
    (("bottleneck",), ()),                 # fewer frozen on resume
])
def test_mismatched_freeze_raises_before_changing_anything(tmp_path, saved,
                                                           run):
    st = _stepped_state(freeze=saved)
    ck.save_checkpoint(str(tmp_path / "s"), st)
    target = _fresh_state(freeze=run)
    before = {k: v.clone() for k, v in target.model.state_dict().items()}
    with pytest.raises(ValueError, match="optimizer's parameters differ"):
        ck.restore_checkpoint(str(tmp_path / "s"), target)
    for k, v in target.model.state_dict().items():
        assert torch.equal(v, before[k]), k  # checked whole, then loaded
    assert target.step == 0


def test_same_size_frozen_sets_cannot_swap_moments(tmp_path):
    """Moments are stored by name: two runs whose trainable sets have the
    same size and shapes but other names refuse, where a by-index load
    would put every moment on the wrong tensor without complaint."""
    frozen_a = _stepped_state(freeze=("encoders_0/conv2",))
    frozen_b = _fresh_state(freeze=("decoders_1/conv2",))
    shapes = [[tuple(p.shape) for p in s.trainable]
              for s in (frozen_a, frozen_b)]
    assert sorted(shapes[0]) == sorted(shapes[1])  # the premise
    assert frozen_a.frozen != frozen_b.frozen
    with pytest.raises(ValueError, match="optimizer's parameters differ"):
        frozen_b.load_full_state_dict(frozen_a.full_state_dict())


def test_shape_mismatch_raises(tmp_path):
    st = _stepped_state()
    ck.save_checkpoint(str(tmp_path / "s"), st)
    wide = TrainState(create_model("UNet", base_filters=8, depth=2), 1e-3,
                      4, model_type="UNet")
    with pytest.raises(ValueError, match="shape"):
        ck.restore_checkpoint(str(tmp_path / "s"), wide)


def test_ema_seed_and_drop_rules(tmp_path):
    """JAX ``_merge_restored_ema``: a checkpoint without a shadow seeds an
    EMA run's from the restored parameters; an EMA-off run drops a saved
    shadow; EMA on both sides restores it."""
    plain = _stepped_state(ema=False)
    ck.save_checkpoint(str(tmp_path / "plain"), plain)
    seeded = ck.restore_checkpoint(str(tmp_path / "plain"), _fresh_state())
    for k, p in seeded.model.named_parameters():
        assert torch.equal(seeded.ema[k], p), k
    assert seeded.ema[k] is not p  # a copy, not the parameter itself

    with_ema = _stepped_state(ema=True)
    ck.save_checkpoint(str(tmp_path / "ema"), with_ema)
    dropped = ck.restore_checkpoint(str(tmp_path / "ema"),
                                    _fresh_state(ema=False))
    assert dropped.ema is None
    assert "ema" not in dropped.full_state_dict()
    kept = ck.restore_checkpoint(str(tmp_path / "ema"), _fresh_state())
    for k in with_ema.ema:
        assert torch.equal(kept.ema[k], with_ema.ema[k])
        assert not torch.equal(kept.ema[k],
                               dict(kept.model.named_parameters())[k])


def test_load_checkpoint_into_reads_full_state_dirs(tmp_path):
    """Serving (prefer_ema) takes the shadow, a training warm start the
    live weights; a directory without the port's file is refused as an
    Orbax one."""
    st = _stepped_state(ema=True)
    ck.save_checkpoint(str(tmp_path / "s"), st)
    served = ck.load_checkpoint_into(str(tmp_path / "s"), "UNet",
                                     create_model("UNet", **SMALL))
    warm = ck.load_checkpoint_into(str(tmp_path / "s"), "UNet",
                                   create_model("UNet", **SMALL),
                                   prefer_ema=False)
    for k, v in st.eval_state_dict().items():
        assert torch.equal(served.state_dict()[k], v), k
    for k, v in st.model.state_dict().items():
        assert torch.equal(warm.state_dict()[k], v), k
    (tmp_path / "orbax").mkdir()
    with pytest.raises(ValueError, match="Orbax"):
        ck.load_checkpoint_into(str(tmp_path / "orbax"), "UNet",
                                create_model("UNet", **SMALL))


# ---------------------------------------------------- managed checkpoints

@pytest.mark.parametrize("async_save", [False, True])
def test_rotation_keeps_newest(tmp_path, async_save):
    mgr = ck.ManagedCheckpointer(str(tmp_path / "ck"), max_to_keep=2,
                                 async_save=async_save)
    st = _stepped_state(ema=False, steps=1)
    for step in (1, 2, 3, 4, 5):
        st.step = step
        assert mgr.save(step, st, metrics={"val_iou": step / 10})
    mgr.wait()
    kept = sorted(int(d) for d in os.listdir(tmp_path / "ck")
                  if d.isdigit())
    assert kept == [4, 5]
    assert mgr.latest_step() == 5
    with open(tmp_path / "ck" / "5" / "metrics.json") as f:
        assert json.load(f) == {"val_iou": 0.5}
    mgr.close()


def test_restore_latest_roundtrip_and_empty(tmp_path):
    mgr = ck.ManagedCheckpointer(str(tmp_path / "ck"), async_save=False)
    assert mgr.restore_latest(_fresh_state()) is None
    st = _stepped_state(seed=1)
    st.step = 7
    mgr.save(7, st)
    restored, step = mgr.restore_latest(_fresh_state(seed=99))
    assert step == 7 and restored.step == 7
    _assert_full_equal(st.full_state_dict(), restored.full_state_dict())
    mgr.close()


def test_save_snapshot_is_taken_at_save_time(tmp_path):
    """The async periodic save writes the state as it was at save(), not
    as training left it when the write ran."""
    mgr = ck.ManagedCheckpointer(str(tmp_path / "ck"), async_save=True)
    st = _stepped_state(ema=False)
    want = {k: v.clone() for k, v in st.model.state_dict().items()}
    mgr.save(1, st)
    with torch.no_grad():
        for p in st.model.parameters():
            p.add_(1.0)
    mgr.close()
    got = ck.read_checkpoint(str(tmp_path / "ck" / "1"))["model"]
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_trainer_periodic_rotation_and_resume(tmp_path):
    """save_interval 1, max_keep 2, 3 epochs -> periodic/ holds 2 and 3,
    each with its epoch's val IoU and a confusion plot in result/; the
    newest restores into a fresh state at step 3 epochs' worth."""
    tr = _trainer(tmp_path, epochs=3, save_interval=1,
                  max_keep_checkpoints=2)
    tr.train()
    pdir = os.path.join(tr.config.model_dir, "periodic")
    assert sorted(int(d) for d in os.listdir(pdir)) == [2, 3]
    for e in (1, 2, 3):
        assert os.path.exists(os.path.join(
            tr.config.result_dir, f"epoch_{e}_confusion_matrix.png"))
    mgr = ck.ManagedCheckpointer(pdir)
    restored, step = mgr.restore_latest(_fresh_state(ema=False))
    assert step == 3 and restored.step == 3 * tr.steps_per_epoch
    mgr.close()


# ----------------------------------------------------- resume, bit-equal

def test_resume_at_epoch_boundary_is_bit_equal(tmp_path):
    """2 epochs uninterrupted == 1 epoch, its _last restored into a fresh
    Trainer (another init), 1 more: parameters, statistics, AdamW, step
    and EMA bit for bit."""
    kw = dict(ema_decay=0.9)
    full = _trainer(tmp_path / "full", epochs=2, **kw)
    full.train()
    first = _trainer(tmp_path / "first", epochs=1, **kw)
    first.train()
    second = _trainer(tmp_path / "second", epochs=2, **kw)
    with torch.no_grad():  # another starting point, so the restore shows
        for p in second.model.parameters():
            p.mul_(0.5)
    last = os.path.join(first.config.model_dir, "UNet_last")
    ck.restore_checkpoint(last, second.state)
    second.start_epoch = second.state.step // second.steps_per_epoch
    assert second.start_epoch == 1
    second.train()
    _assert_full_equal(full.state.full_state_dict(),
                       second.state.full_state_dict())
    with open(os.path.join(second.config.log_dir, "log.log")) as f:
        log = f.read()
    assert "Resuming at epoch 2/2 (restored step 2)" in log
    assert "Train Epoch: 1," not in log


def test_best_val_iou_starts_afresh_on_resume(tmp_path):
    """As in JAX, a resumed run keeps no best IoU: its first validated
    epoch saves a best."""
    first = _trainer(tmp_path / "a", epochs=1)
    first.train()
    second = _trainer(tmp_path / "b", epochs=2)
    ck.restore_checkpoint(os.path.join(first.config.model_dir, "UNet_last"),
                          second.state)
    second.start_epoch = 1
    assert second.best_val_iou == -np.inf
    second.train()
    with open(os.path.join(second.config.log_dir, "log.log")) as f:
        assert "--Best model saved at epoch 2" in f.read()


# ------------------------------------------------------------ preemption

def test_sigterm_during_validate_checkpoints_and_stops(tmp_path):
    tr = _trainer(tmp_path, epochs=5)
    calls = []
    real_validate = tr.validate

    def validate_and_preempt(epoch):
        calls.append(epoch)
        out = real_validate(epoch)
        os.kill(os.getpid(), signal.SIGTERM)  # handled by train()'s handler
        return out

    tr.validate = validate_and_preempt
    before_term = signal.getsignal(signal.SIGTERM)
    before_int = signal.getsignal(signal.SIGINT)
    tr.train()
    assert tr.preempted
    assert calls == [0]  # stopped after the first epoch, 4 budgeted remain
    last = os.path.join(tr.config.model_dir, "UNet_last")
    assert ck.is_full_state(last)
    assert os.path.exists(last + ".npz") and os.path.exists(last + ".pth")
    assert ck.read_checkpoint(last)["step"] == tr.steps_per_epoch
    assert signal.getsignal(signal.SIGTERM) is before_term
    assert signal.getsignal(signal.SIGINT) is before_int


def test_preempted_mid_epoch_stops_step_loop(tmp_path):
    """The per-step check: a signal during the epoch ends the step loop
    after the step under way, which is kept, and no validate follows."""
    tr = _trainer(tmp_path, epochs=5, n_train=32)
    real_step = tr.train_step
    taken = []

    def step_then_signal(*a):
        out = real_step(*a)
        taken.append(1)
        if len(taken) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    tr.train_step = step_then_signal
    validated = []
    tr.validate = lambda e: validated.append(e) or (0.0, 0.0)
    tr.train()
    assert tr.preempted and validated == []
    assert tr.state.step == 2 < tr.steps_per_epoch
    last = os.path.join(tr.config.model_dir, "UNet_last")
    _assert_full_equal(ck.read_checkpoint(last),
                       {"format": "ddti_tpu_torch.train_state",
                        **ck.to_host(tr.state.full_state_dict())})


def test_second_signal_aborts():
    """The first signal arms the graceful stop; a second aborts."""
    import types

    self = types.SimpleNamespace(_preempted=False,
                                 logger=logging.getLogger("t"))
    Trainer._on_preempt_signal(self, signal.SIGTERM, None)
    assert self._preempted
    with pytest.raises(KeyboardInterrupt):
        Trainer._on_preempt_signal(self, signal.SIGTERM, None)


def test_train_in_worker_thread_skips_handlers(tmp_path):
    """signal.signal raises off the main thread: train() runs without
    handlers there."""
    tr = _trainer(tmp_path, epochs=1)
    before = signal.getsignal(signal.SIGTERM)
    err = []

    def run():
        try:
            tr.train()
        except Exception as e:  # pragma: no cover
            err.append(e)

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=300)
    assert not t.is_alive() and not err
    assert not tr.preempted
    assert signal.getsignal(signal.SIGTERM) is before
    assert ck.is_full_state(os.path.join(tr.config.model_dir, "UNet_last"))


# ------------------------------------------------------------ best saves

def test_async_best_save_writes_what_blocking_writes(tmp_path):
    """Default (async) and --async_best_save false give the same best
    .npz, .pth and, under --best_full_state, the same full state."""
    out = {}
    for mode in (True, False):
        tr = _trainer(tmp_path / str(mode), epochs=2, async_best_save=mode,
                      best_full_state=True, ema_decay=0.9)
        tr.train()
        best = os.path.join(tr.config.model_dir, "UNet_best")
        with np.load(best + ".npz") as z:
            npz = {k: z[k] for k in z.files}
        out[mode] = (npz, torch.load(best + ".pth", weights_only=True),
                     ck.read_checkpoint(best))
    (a_npz, a_pth, a_full), (b_npz, b_pth, b_full) = out[True], out[False]
    assert a_npz.keys() == b_npz.keys()
    for k in a_npz:
        np.testing.assert_array_equal(a_npz[k], b_npz[k], err_msg=k)
    _assert_full_equal(a_pth, b_pth)
    _assert_full_equal(a_full, b_full)


def test_async_snapshot_is_taken_before_the_next_step(tmp_path):
    """The async saver writes the weights of the best epoch, though the
    optimizer moves the live tensors in place before the write runs."""
    tr = _trainer(tmp_path, epochs=1)
    gate = threading.Event()
    tr._best_saver = _AsyncBestSaver(tr.logger)
    real_submit = tr._best_saver.submit
    tr._best_saver.submit = lambda fn, label: real_submit(
        lambda: (gate.wait(30), fn()), label)
    want = {k: v.clone() for k, v in tr.state.eval_state_dict().items()}
    tr._save_best(0, 0.5)
    with torch.no_grad():
        for p in tr.model.parameters():
            p.add_(1.0)
    gate.set()
    tr._best_saver.close()
    got = torch.load(os.path.join(tr.config.model_dir, "UNet_best.pth"),
                     weights_only=True)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_best_saver_latest_wins_under_stress():
    """Hundreds of submits with a short switch interval: the writes run
    one at a time, in submission order, none twice, the last submitted
    written last, and close() returns in time."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        saver = _AsyncBestSaver(logging.getLogger("t"))
        written, active, overlaps = [], [0], []
        lock = threading.Lock()

        def write(i):
            def fn():
                with lock:
                    active[0] += 1
                    overlaps.append(active[0])
                time.sleep(1e-4)
                written.append(i)
                with lock:
                    active[0] -= 1
            return fn

        for i in range(300):
            saver.submit(write(i), f"best {i}")
        closer = threading.Thread(target=saver.close)
        closer.start()
        closer.join(timeout=60)
        assert not closer.is_alive()
    finally:
        sys.setswitchinterval(old)
    assert written and written[-1] == 299
    assert written == sorted(set(written)) and max(overlaps) == 1


def test_failed_best_save_is_raised_after_training(tmp_path):
    saver = _AsyncBestSaver(logging.getLogger("t"))

    def fail():
        raise OSError("disk full")

    saver.submit(fail, "best")
    with pytest.raises(RuntimeError, match="best-epoch save failed"):
        saver.close()


def test_test_metrics_records_the_threshold(tmp_path):
    """test_metrics.json carries 0.5 without --tune_threshold (no longer
    a constant written beside the tuned one)."""
    tr = _trainer(tmp_path, epochs=1)
    tr.test(visualize=False)
    with open(os.path.join(tr.config.result_dir, "test_metrics.json")) as f:
        assert json.load(f)["threshold"] == 0.5


# ------------------------------------------------------------------- CLI

CLI = ["--synthetic", "--device", "cpu", "--base_filters", "4", "--depth",
       "2", "--image_size", "32", "--store_size", "32", "--log_every", "1",
       "--save_interval", "1", "--max_keep_checkpoints", "2"]
# the preempted run takes 16 steps an epoch, room for the signal to land
# within epoch 2; the others 4
SLOW, FAST = ["--batch_size", "4"], ["--batch_size", "16"]


def _cli(base, *flags):
    return [sys.executable, "-m", "ddti_tpu_torch.cli.main", "--base_dir",
            str(base), *CLI, *flags]


def _run_cli_lifecycle(root):
    """The CLI runs, two waves of processes: a 3-epoch run sent SIGTERM
    once epoch 2 is under way, a 2-epoch and a 1-epoch run; then the
    preempted run resumed from its hint and the 1-epoch run resumed to 2
    epochs. {name: [exit code, output, base dir]} plus the hint."""
    env = dict(os.environ, OMP_NUM_THREADS="1",
               DDTI_RESUME_HINT=str(root / "hint.json"))
    runs = {}

    def start(name, *flags):
        base = root / name
        base.mkdir(parents=True)
        return subprocess.Popen(_cli(base, *flags), cwd=ROOT, env=env,
                                stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True), base

    procs = {}
    try:
        procs["preempted"] = start("preempted", "--mode", "both",
                                   "--epochs", "3", *SLOW)
        procs["two"] = start("two", "--mode", "train", "--epochs", "2",
                             *FAST)
        procs["one"] = start("one", "--mode", "train", "--epochs", "1",
                             *FAST)
        p, base = procs["preempted"]
        seen, t0 = [], time.time()
        for line in p.stdout:
            seen.append(line)
            if "Epoch 2 step 1:" in line or time.time() - t0 > 120:
                break
        p.send_signal(signal.SIGTERM)
        out = p.communicate(timeout=120)[0]
        runs["preempted"] = [p.returncode, "".join(seen) + out, str(base)]
        for name in ("two", "one"):
            p, base = procs[name]
            runs[name] = [p.wait(timeout=300), p.stdout.read(), str(base)]
        hint = json.loads((root / "hint.json").read_text())
        (one,) = (root / "one").iterdir()
        procs["resumed"] = start("resumed", "--mode", "both", "--epochs",
                                 "3", "--resume", "--checkpoint_path",
                                 hint["checkpoint_path"], *SLOW)
        procs["one_more"] = start(
            "one_more", "--mode", "train", "--epochs", "2", "--resume",
            "--checkpoint_path", str(one / "models" / "ResUNet_last"), *FAST)
        for name in ("resumed", "one_more"):
            p, base = procs[name]
            out = p.communicate(timeout=300)[0]
            runs[name] = [p.returncode, out, str(base)]
        return {"runs": runs, "hint": hint}
    finally:
        for p, _ in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()


@pytest.fixture(scope="module")
def cli_lifecycle(tmp_path_factory):
    """The CLI runs, made once a session: under xdist the first worker to
    ask runs them, holding a lock in the session's shared temporary
    directory, and the others read its results."""
    shared = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        shared = shared.parent
    done = shared / "cli_lifecycle.json"
    with open(shared / "cli_lifecycle.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not done.exists():
            done.write_text(json.dumps(
                _run_cli_lifecycle(shared / "lifecycle")))
    return json.loads(done.read_text())


def _run_dir(base):
    (run,) = pathlib.Path(base).iterdir()
    return run


def test_cli_sigterm_exits_75_with_hint(cli_lifecycle):
    rc, out, base = cli_lifecycle["runs"]["preempted"]
    assert rc == 75, out[-3000:]
    assert "preempted at epoch 2" in out
    assert "test phase skipped" in out.lower()
    assert "Test Metrics" not in out
    assert out.splitlines()[-1].startswith("[KERNELS] edt_minplus=0")
    last = _run_dir(base) / "models" / "ResUNet_last"
    assert cli_lifecycle["hint"] == {"checkpoint_path": str(last),
                                     "epochs": 3}
    assert ck.is_full_state(str(last))
    for suffix in (".npz", ".pth"):
        assert (last.parent / ("ResUNet_last" + suffix)).exists()


def test_cli_resume_completes_the_budget(cli_lifecycle):
    rc, out, base = cli_lifecycle["runs"]["resumed"]
    assert rc == 0, out[-3000:]
    assert "Resumed full state from" in out
    assert "Resuming at epoch 2/3" in out
    assert "Train Epoch: 1," not in out
    assert "Train Epoch: 2," in out and "Train Epoch: 3," in out
    assert "Test Metrics" in out
    run = _run_dir(base)
    assert sorted(os.listdir(run / "models" / "periodic")) == ["2", "3"]
    assert (run / "result" / "test_boundaries_0.png").exists()


def test_cli_resume_at_epoch_boundary_is_bit_equal(cli_lifecycle):
    """--epochs 1, then --resume to 2 == --epochs 2, through the CLI."""
    runs = cli_lifecycle["runs"]
    for name in ("two", "one", "one_more"):
        assert runs[name][0] == 0, runs[name][1][-3000:]
    assert "Resuming at epoch 2/2" in runs["one_more"][1]
    got = [ck.read_checkpoint(str(_run_dir(runs[n][2]) / "models"
                                  / "ResUNet_last"))
           for n in ("two", "one_more")]
    _assert_full_equal(*got)


def test_cli_resume_refusals(tmp_path):
    """--resume from a weights-only .npz, a missing path and a mismatched
    --freeze each raise, as in the JAX CLI."""
    base = ["--synthetic", "--device", "cpu", "--base_filters", "4",
            "--depth", "2", "--image_size", "32", "--store_size", "32",
            "--batch_size", "16", "--epochs", "1", "--log_every", "0",
            "--mode", "train"]
    assert tmain.main(base + ["--base_dir", str(tmp_path / "a")]) == 0
    run = _run_dir(tmp_path / "a")
    last = str(run / "models" / "ResUNet_last")
    with pytest.raises(ValueError, match="weights only"):
        tmain.main(base + ["--base_dir", str(tmp_path / "b"), "--resume",
                           "--checkpoint_path", last + ".npz"])
    with pytest.raises(FileNotFoundError, match="required by --resume"):
        tmain.main(base + ["--base_dir", str(tmp_path / "c"), "--resume",
                           "--checkpoint_path", str(tmp_path / "nope")])
    with pytest.raises(ValueError, match="SAME optimizer structure"):
        tmain.main(base + ["--base_dir", str(tmp_path / "d"), "--resume",
                           "--checkpoint_path", last, "--freeze",
                           "encoders_0"])
    # without --resume the same directory is a weights-only warm start
    assert tmain.main(base + ["--base_dir", str(tmp_path / "e"), "--freeze",
                              "encoders_0", "--checkpoint_path", last]) == 0
    log = (_run_dir(tmp_path / "e") / "log" / "train_log.log").read_text()
    assert f"Warm-started weights from {last}" in log


def test_cli_resumes_from_a_periodic_root(tmp_path):
    """A directory of numeric step directories resumes from its newest."""
    base = ["--synthetic", "--device", "cpu", "--base_filters", "4",
            "--depth", "2", "--image_size", "32", "--store_size", "32",
            "--batch_size", "16", "--log_every", "0", "--mode", "train",
            "--save_interval", "1", "--max_keep_checkpoints", "2"]
    assert tmain.main(base + ["--epochs", "2",
                              "--base_dir", str(tmp_path / "a")]) == 0
    root = _run_dir(tmp_path / "a") / "models" / "periodic"
    assert tmain.main(base + ["--epochs", "3", "--resume",
                              "--checkpoint_path", str(root),
                              "--base_dir", str(tmp_path / "b")]) == 0
    log = (_run_dir(tmp_path / "b") / "log" / "train_log.log").read_text()
    assert f"Resumed full state from {root} step 2" in log
    assert "Resuming at epoch 3/3 (restored step 8)" in log
