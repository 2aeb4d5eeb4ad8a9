"""``--profile N`` on the CPU: a torch.profiler trace of epoch 1's first N
steps under ``<result_dir>/trace`` (a Chrome/TensorBoard JSON), closed at
the epoch's end when the epoch is shorter, ignored under --fused_epoch with
JAX's warning, and a tracing failure logged without failing the run (JAX
``engine.py:421-477``)."""

import json

import pytest
import torch
import torch.profiler

from ddti_tpu_torch.cli import main as tmain

FLAGS = ["--mode", "train", "--synthetic", "--device", "cpu",
         "--base_filters", "4", "--depth", "2", "--image_size", "32",
         "--store_size", "32", "--batch_size", "16", "--epochs", "2",
         "--log_every", "0"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: xdist runs six of these processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(tmp_path, *extra):
    assert tmain.main(FLAGS + list(extra) + ["--base_dir", str(tmp_path)]) \
        == 0
    (run,) = tmp_path.iterdir()
    return run, (run / "log" / "train_log.log").read_text()


def _trace_names(run):
    (trace,) = (run / "result" / "trace").glob("*.json")
    with open(trace) as f:
        return [e.get("name", "") for e in json.load(f)["traceEvents"]]


@pytest.mark.parametrize("steps, said", [(2, "--Trace of 2 steps written"),
                                         (9, "--Trace written")])
def test_profile_writes_a_trace_of_the_first_steps(tmp_path, steps, said):
    """Two of the epoch's 4 steps, or all 4 when asked for 9 (the trace
    closes at the epoch's end); the trace holds the steps' convolutions
    and is written once, in epoch 1."""
    run, log = _run(tmp_path, "--profile", str(steps))
    assert said in log and log.count("--Trace") == 1
    names = _trace_names(run)
    assert sum(n == "aten::convolution" for n in names) > 0
    assert tmain.get_parser().parse_args(
        ["--profile", "3"]).profile_steps == 3


def test_profile_is_ignored_under_fused_epoch(tmp_path):
    run, log = _run(tmp_path, "--profile", "2", "--fused_epoch")
    assert "--profile is ignored under --fused_epoch" in log
    assert not (run / "result" / "trace").exists()


def test_a_tracing_failure_is_logged_and_training_goes_on(tmp_path,
                                                         monkeypatch):
    def broken(*args, **kwargs):
        raise RuntimeError("no tracer here")

    monkeypatch.setattr(torch.profiler, "profile", broken)
    _, log = _run(tmp_path, "--profile", "2")
    assert "trace capture unavailable: no tracer here" in log
    assert "Train Epoch: 2" in log
