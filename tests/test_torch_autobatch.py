"""``--batch_size auto``: the port's selection rule against JAX's
``pick_batch_size`` with the same injected peaks (JAX's predicted, the
port's measured: here both are the test's numbers), the grad_accum filter,
the stop rule, a refusal after a fitting candidate and on the first,
the data-parallel multiple (the per-device pick times the mesh's data
axis); the CPU's refusal (no peak meter) and the flag's parsing, as
JAX's."""

import argparse
import types

import pytest
import torch

from ddti_tpu.cli import main as jmain
from ddti_tpu.train import autobatch as jab
from ddti_tpu_torch.cli import main as tmain
from ddti_tpu_torch.train import autobatch as tab

GIB = 2 ** 30
BUDGET = 40 * GIB  # cap 0.92 x 40 = 36.8 GiB


def _peaks(per_image_gib, base_gib=2.0, refuse_from=None, error=None):
    """A peak function: base + batch x per-image GiB; from ``refuse_from``
    on, ``error`` raised (the card's, or JAX's compile refusal)."""
    def peak(config, model, batch, host_augment=False):
        if refuse_from is not None and batch >= refuse_from:
            raise error
        return int((base_gib + batch * per_image_gib) * GIB)
    return peak


def _both(monkeypatch, peak_jax, peak_port, **kw):
    """JAX's pick and the port's, on one config and the same peaks: each
    result, or the exception's type and message start."""
    cfg = types.SimpleNamespace(grad_accum=kw.pop("grad_accum", 1))
    monkeypatch.setattr(jab, "predicted_step_peak_bytes", peak_jax)
    out = []
    for pick, extra in ((jab.pick_batch_size, {}),
                        (tab.pick_batch_size, {"peak_fn": peak_port})):
        try:
            out.append(pick(cfg, None, budget_bytes=BUDGET, **extra, **kw))
        except (ValueError, MemoryError, RuntimeError) as e:
            out.append((type(e).__name__, str(e).split(" ")[0]))
    return out


@pytest.mark.parametrize("per_image, grad_accum, want", [
    (0.05, 1, 512),     # every candidate fits
    (0.2, 1, 128),      # 27.6 GiB fits, 53.2 does not
    (0.3, 1, 64),
    (0.3, 16, 64),      # 8 filtered out
    (0.3, 32, 64),
    (0.1, 8, 256),      # every candidate divisible by 8
    (0.3, 3, None),     # no candidate divisible by 3: ValueError
    (5.0, 1, None),     # the smallest is over: MemoryError
])
def test_selection_matches_jax(monkeypatch, per_image, grad_accum, want):
    peak = _peaks(per_image)
    jax_pick, port_pick = _both(monkeypatch, peak, peak,
                                grad_accum=grad_accum)
    assert port_pick == jax_pick
    if want is not None:
        assert port_pick == want
    else:
        assert isinstance(port_pick, tuple)


@pytest.mark.parametrize("data_parallel", [1, 2, 8])
def test_the_pick_is_global_over_the_data_axis(monkeypatch, data_parallel):
    """Candidates are per device; the pick is the global batch, the
    per-device one times --mesh data=N, as JAX's."""
    peak = _peaks(0.2)
    jax_pick, port_pick = _both(monkeypatch, peak, peak,
                                data_parallel=data_parallel)
    assert port_pick == jax_pick == 128 * data_parallel


def test_a_refusal_after_a_fitting_candidate_means_over_budget(monkeypatch):
    """JAX's compile refusal and the card's out-of-memory at 128: both pick
    64, as if 128 were measured over budget."""
    jax_pick, port_pick = _both(
        monkeypatch,
        _peaks(0.1, refuse_from=128, error=RuntimeError("hbm")),
        _peaks(0.1, refuse_from=128,
               error=torch.cuda.OutOfMemoryError("CUDA out of memory")))
    assert port_pick == jax_pick == 64


def test_a_refusal_on_the_first_candidate_is_a_real_error(monkeypatch):
    monkeypatch.setattr(jab, "predicted_step_peak_bytes", _peaks(
        0.1, refuse_from=8, error=RuntimeError("hbm")))
    with pytest.raises(RuntimeError, match="hbm"):
        jab.pick_batch_size(types.SimpleNamespace(grad_accum=1), None,
                            budget_bytes=BUDGET)
    with pytest.raises(torch.cuda.OutOfMemoryError):
        tab.pick_batch_size(types.SimpleNamespace(grad_accum=1), None,
                            budget_bytes=BUDGET, peak_fn=_peaks(
                                0.1, refuse_from=8,
                                error=torch.cuda.OutOfMemoryError("oom")))


def test_another_error_after_a_fit_is_not_over_budget():
    """Only the card's out-of-memory reads as over budget: any other
    failure of a probe step is the program's, and raises."""
    with pytest.raises(ValueError, match="broken"):
        tab.pick_batch_size(types.SimpleNamespace(grad_accum=1), None,
                            budget_bytes=BUDGET, peak_fn=_peaks(
                                0.1, refuse_from=16,
                                error=ValueError("broken")))


def test_the_log_names_each_candidates_measured_peak(caplog):
    import logging

    lg = logging.getLogger("autobatch_test")
    with caplog.at_level(logging.INFO, logger="autobatch_test"):
        b = tab.pick_batch_size(types.SimpleNamespace(grad_accum=1), None,
                                budget_bytes=BUDGET, peak_fn=_peaks(0.2),
                                logger=lg)
    assert b == 128
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 6  # 8 .. 128 fit, 256 extrapolated over
    assert lines[-2].startswith("[autobatch] batch 128/device: measured "
                                "peak 27.60 GiB vs budget 36.80 GiB (fits;")
    assert f"cap {int(BUDGET * 0.92)} B)" in lines[-2]
    assert lines[-1] == ("[autobatch] batch 256/device: 53.20 GiB "
                         "extrapolated from the measured peaks, over the "
                         "budget 36.80 GiB (not run)")


def test_a_candidate_extrapolated_over_the_budget_is_not_run():
    """Affine peaks: 256's is extrapolated from 64's and 128's, over the
    budget, so its step never runs (it would fill the card to fail)."""
    ran = []

    def peak(config, model, batch, host_augment=False):
        ran.append(batch)
        return int((2.0 + 0.2 * batch) * GIB)

    assert tab.pick_batch_size(types.SimpleNamespace(grad_accum=1), None,
                               budget_bytes=BUDGET, peak_fn=peak) == 128
    assert ran == [8, 16, 32, 64, 128]


def test_superlinear_peaks_are_measured_over_as_in_jax(monkeypatch):
    """Where the peak grows faster than the batch, the extrapolation
    underestimates, the candidate runs and is measured over: JAX's pick."""
    def peak(config, model, batch, host_augment=False):
        return int((1.0 + 0.002 * batch ** 2) * GIB)

    jax_pick, port_pick = _both(monkeypatch, peak, peak)
    assert port_pick == jax_pick == 128


def test_the_cpu_has_no_peak_meter(tmp_path):
    with pytest.raises(RuntimeError, match="no peak meter"):
        tab.device_budget_bytes("cpu")
    model = torch.nn.Linear(2, 2)
    with pytest.raises(RuntimeError, match="no peak meter"):
        tab.measured_step_peak_bytes(types.SimpleNamespace(), model, 8)
    with pytest.raises(RuntimeError, match="no peak meter"):
        tmain.main(["--mode", "train", "--synthetic", "--device", "cpu",
                    "--base_filters", "4", "--depth", "2", "--image_size",
                    "32", "--store_size", "32", "--batch_size", "auto",
                    "--base_dir", str(tmp_path)])


@pytest.mark.parametrize("arg", ["auto", "AUTO", " auto ", "32", "x1"])
def test_batch_size_argument_parses_as_jax(arg):
    def parse(fn):
        try:
            return fn(arg)
        except argparse.ArgumentTypeError as e:
            return str(e)

    assert parse(tmain._batch_size_arg) == parse(jmain._batch_size_arg)
    assert tmain.get_parser().parse_args([]).batch_size == 16
