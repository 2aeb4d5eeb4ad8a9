"""``--lr_find``: the port's ``run_lr_finder`` against JAX's on one
scripted loss sequence (duck-typed trainers whose step returns the next
loss): the history, the stop reason, both suggestions, the log line and
``lr_find.csv`` byte for byte; a real tiny run that leaves the Trainer's
state bit-equal; and the CLI."""

import logging
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.train import lr_finder as jlr
from ddti_tpu_torch.cli import main as tmain
from ddti_tpu_torch.core.config import Config
from ddti_tpu_torch.core.logging import create_logger
from ddti_tpu_torch.data.dataset import synthetic_source
from ddti_tpu_torch.models import create_model
from ddti_tpu_torch.train import lr_finder as tlr
from ddti_tpu_torch.train.engine import Trainer
from ddti_tpu_torch.train.state import TrainState


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: xdist runs six of these processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Lines(logging.Handler):
    def __init__(self):
        super().__init__()
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def _logger(name):
    lg = logging.getLogger(f"lr_find_test.{name}")
    lg.handlers[:] = []
    lg.propagate = False
    lg.setLevel(logging.INFO)
    lg.addHandler(_Lines())
    return lg


def _config(result_dir):
    return types.SimpleNamespace(weight_decay=1e-2, clip_grad_norm=0.0,
                                 freeze="", nan_guard=False, seed=42,
                                 result_dir=result_dir)


def _jax_trainer(losses, per_pass, result_dir):
    """What JAX's run_lr_finder reads of a Trainer, its step scripted."""
    script = iter(losses)

    def step(state, images, masks, key, tvars):
        return state, types.SimpleNamespace(loss=jnp.float32(next(script)))

    return types.SimpleNamespace(
        config=_config(result_dir), key=jax.random.PRNGKey(0),
        state=types.SimpleNamespace(params={"w": jnp.zeros(3)},
                                    batch_stats={}, qstats=None,
                                    apply_fn=None),
        train_src=None, _teacher_vars=None, train_step=step,
        _iter_batches=lambda src, shuffle: iter(
            [(np.zeros(1), np.zeros(1))] * per_pass),
        logger=_logger("jax"))


def _port_trainer(losses, per_pass, result_dir):
    """What the port's run_lr_finder reads of a Trainer, its step
    scripted."""
    script = iter(losses)

    def step(state, images, masks, draws, mix):
        state.apply_gradients()  # the ramp's learning rate, taken
        return types.SimpleNamespace(loss=torch.tensor(float(
            np.float32(next(script)))))

    model = torch.nn.Linear(3, 1)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    tr = types.SimpleNamespace(
        config=_config(result_dir), device=torch.device("cpu"),
        state=TrainState(model, 1e-3, 1), train_src=None, train_step=step,
        _gen=None, _field_gen=None, dp=None, is_writer=True,
        _draws=lambda epoch, i, n: (types.SimpleNamespace(
            to=lambda dev: None), None),
        _batches=lambda src, shuffle, rng: iter(
            [(None, torch.zeros(1, dtype=torch.uint8),
              torch.zeros(1, dtype=torch.uint8))] * per_pass),
        logger=_logger("port"))
    # the Trainer's own step dispatch (one process: no mesh)
    tr._train_on = types.MethodType(Trainer._train_on, tr)
    return tr


def _smooth_then(n, tail):
    """A falling loss curve for n steps, then ``tail`` appended."""
    rng = np.random.default_rng(n)
    head = [1.2 - 0.6 * (i / n) ** 2 + 0.01 * rng.random() for i in range(n)]
    return head + tail


# (losses, --lr_find steps, batches a pass over the source, the stop)
SCRIPTS = {
    "completed": (_smooth_then(20, []), 20, 7, "completed"),
    "diverged": (_smooth_then(14, [1e2, 1e3, 1e4, 1e5, 1e6]), 30, 5,
                 "diverged"),
    "non-finite": (_smooth_then(12, [float("nan")]), 30, 4,
                   "non-finite loss"),
    "one pass of 40": (_smooth_then(40, []), 40, 64, "completed"),
}


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_range_test_matches_jax(name, tmp_path):
    losses, steps, per_pass, stop = SCRIPTS[name]
    out = {}
    for side, make, run in (("jax", _jax_trainer, jlr.run_lr_finder),
                            ("port", _port_trainer, tlr.run_lr_finder)):
        rd = str(tmp_path / side)
        tr = make(losses + [0.5] * 5, per_pass, rd)
        r = run(tr, num_steps=steps, min_lr=1e-6, max_lr=3.0)
        with open(r["csv"], "rb") as f:
            csv = f.read()
        out[side] = (r, csv, [line for line in tr.logger.handlers[0].lines
                              if "LR range test" in line])
    (jr, jcsv, jlog), (tr, tcsv, tlog) = out["jax"], out["port"]
    assert tr["history"] == jr["history"]
    assert tr["stop_reason"] == jr["stop_reason"]
    assert tr["lr_steepest"] == jr["lr_steepest"]
    assert tr["lr_min_over_10"] == jr["lr_min_over_10"]
    assert tcsv == jcsv
    assert [line.replace(str(tmp_path / "port"), "")
            for line in tlog] == [line.replace(str(tmp_path / "jax"), "")
                                  for line in jlog]
    assert (tr["png"] is None) == (jr["png"] is None)
    assert tr["stop_reason"].split(" at ")[0] == stop
    assert (len(tr["history"]) == steps) == (stop == "completed")


def test_too_few_finite_steps_raise_as_in_jax(tmp_path):
    losses = [1.0, 0.9, float("nan")]
    for make, run in ((_jax_trainer, jlr.run_lr_finder),
                      (_port_trainer, tlr.run_lr_finder)):
        with pytest.raises(RuntimeError, match="collected only 2 finite"):
            run(make(losses, 4, str(tmp_path)), num_steps=10)


def test_the_ramp_sets_each_steps_learning_rate(tmp_path):
    """The disposable state's AdamW takes min_lr * ratio^(i / (N - 1)) at
    step i (JAX's optax schedule of the ramp), capped at max_lr."""
    seen = []
    tr = _port_trainer([1.0] * 12, 12, str(tmp_path))
    inner = tr.train_step

    def step(state, *args):
        m = inner(state, *args)
        seen.append(state.optimizer.param_groups[0]["lr"])
        return m

    tr.train_step = step
    tlr.run_lr_finder(tr, num_steps=6, min_lr=1e-4, max_lr=1.0)
    want = [1e-4 * 1e4 ** (i / 5) for i in range(6)]
    assert seen == pytest.approx(want, rel=1e-12)


def test_a_real_run_leaves_the_trainers_state_alone(tmp_path):
    cfg = Config(model_type="ResUNet", image_size=32, store_size=32,
                 batch_size=4, base_dir=str(tmp_path), ema_decay=0.9,
                 model_kwargs=dict(base_filters=4, depth=2))
    cfg.make_dirs()
    src = synthetic_source(8, (32, 32), 0)
    tr = Trainer(cfg, (src, src, src),
                 create_logger(os.path.join(cfg.log_dir, "log.txt"),
                               console=False),
                 create_model("ResUNet", base_filters=4, depth=2))
    tr.train_one_epoch(0)  # AdamW's moments and the EMA exist
    before = tr.state.full_state_dict()
    before = {"model": {k: v.clone() for k, v in before["model"].items()},
              "adam": {k: {m: t.clone() for m, t in v.items()}
                       for k, v in before["adam"].items()},
              "ema": {k: v.clone() for k, v in before["ema"].items()},
              "step": before["step"]}
    gens = tr._gen, tr._field_gen
    r = tlr.run_lr_finder(tr, num_steps=6)
    assert len(r["history"]) == 6
    assert all(math.isfinite(v) for h in r["history"] for v in h)
    after = tr.state.full_state_dict()
    assert after["step"] == before["step"]
    for part in ("model", "ema"):
        for k, v in before[part].items():
            assert torch.equal(after[part][k], v), (part, k)
    for k, st in before["adam"].items():
        for m, v in st.items():
            assert torch.equal(after["adam"][k][m], v), (k, m)
    assert (tr._gen, tr._field_gen) == gens


def test_cli_lr_find_prints_the_suggestions_and_trains_nothing(tmp_path,
                                                               capsys):
    rc = tmain.main(["--mode", "both", "--synthetic", "--device", "cpu",
                     "--base_filters", "4", "--depth", "2", "--image_size",
                     "32", "--store_size", "32", "--batch_size", "16",
                     "--lr_find", "8", "--lr_find_min", "1e-6",
                     "--lr_find_max", "0.1", "--base_dir", str(tmp_path)])
    assert rc == 0
    out = capsys.readouterr().out
    line = [x for x in out.splitlines() if x.startswith("[LR_FIND]")]
    assert len(line) == 1 and "steepest=" in line[0]
    assert "min_over_10=" in line[0]
    (run,) = tmp_path.iterdir()
    rows = (run / "result" / "lr_find.csv").read_text().splitlines()
    assert rows[0] == "step,lr,loss,smoothed" and len(rows) == 9
    log = (run / "log" / "train_log.log").read_text()
    assert "LR range test: 8 steps" in log and "Train Epoch" not in log
    assert "Test Metrics" not in out
