"""Quantization-aware training (``ddti_tpu_torch/train/qat.py`` and its
wiring in ``train/{state,steps,engine}.py``) against the JAX package's
``train/qat.py``, on the CPU in float32.

``fake_quant``'s forward bit for bit and its clipped-STE gradient mask;
the tracked convs (``init_qstats``); the range EMA bit for bit; one QAT
train step from JAX's weights with JAX's draws (also under
``--grad_accum 2`` and ``min_channels``): loss terms, parameters,
statistics, gradients and ranges at the tolerances stated below;
``--remat`` against the plain QAT step (each range observed once, a
recomputation adds nothing); ``--nan_guard`` keeping the ranges of a
rejected step on both guards; the full state's ranges; the fused epoch
against the stepwise one bit for bit; a teacher never fake-quantized.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.train import qat as jqat
from ddti_tpu.train.state import create_train_state
from ddti_tpu.train.steps import _build_train_step_impl
from ddti_tpu_torch.data.augment import AugmentConfig
from ddti_tpu_torch.models import create_model
from ddti_tpu_torch.train import qat
from ddti_tpu_torch.train.state import TrainState
from ddti_tpu_torch.train.steps import make_train_step

from test_torch_augment import jax_draws
from test_torch_fused_epoch import _state, _trainer, start  # noqa: F401
from test_torch_train_options import (  # noqa: F401
    ACFG,
    LR,
    SIZE,
    SMALL,
    _adam_mu,
    _batch,
    _jcfg,
    _normwise,
    _port_model,
    _torch_dict,
    jax_init,
    two_pass_bn,
)

# One QAT step against JAX's, measured over the seven cases below: where no
# conv input lands within an ulp of a rounding tie the step matches at the
# float tolerances of tests/test_torch_train.py (loss 2.2e-7, gradients
# 1.7e-6, ranges 5.7e-7); where some do (seeds 12, 11 under grad_accum 2
# and 31 at min_channels 8), those activations take the other int8 level,
# 1/127 of their conv's range, and the step moves by that: measured at
# most loss terms 2.4e-4 relative, BatchNorm statistics 6.8e-5 and
# parameters 3.4e-3 normwise, gradients 3.5e-2 normwise, ranges 2.4e-3
# relative. The bounds are twice those.
QAT_TERM_RTOL = 5e-4
QAT_STATS_TOL = 2e-4
QAT_PARAM_TOL = 7e-3
QAT_GRAD_TOL = 7e-2
QAT_RANGE_RTOL = 5e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: xdist runs six of these processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_fake_quant_forward_and_gradient_mask_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0.0, 2.0, (3, 5, 7, 4)).astype(np.float32)
    for scale in (np.float32(0.01), rng.uniform(0.005, 0.03, 4).astype(
            np.float32)):
        want = np.asarray(jqat.fake_quant(jnp.asarray(x), jnp.asarray(scale)))
        jg = np.asarray(jax.grad(lambda t: jnp.sum(jqat.fake_quant(
            t, jnp.asarray(scale)) * 3.0))(jnp.asarray(x)))
        tx = torch.from_numpy(x).requires_grad_(True)
        got = qat.fake_quant(tx, torch.from_numpy(np.asarray(scale)))
        (got * 3.0).sum().backward()
        assert np.array_equal(got.detach().numpy(), want)
        assert np.array_equal(tx.grad.numpy(), jg)
        assert 0 < (jg == 0).mean() < 1  # both sides of the clip range


@pytest.mark.parametrize("model_type,kw,mc", [
    ("ResUNet", {}, 0), ("ResUNet", {}, 8), ("VNet2D", {}, 0),
    ("AttentionUNet", {}, 4),
    ("TransUNet", dict(embed_dim=16, num_heads=2, num_transformer_layers=1,
                       image_size=SIZE), 0)])
def test_tracked_convs_are_jax_init_qstats(model_type, kw, mc):
    kw = dict(SMALL, **kw)
    jm = jcreate_model(model_type, **kw)
    v = jm.init({"params": jax.random.PRNGKey(0)},
                jnp.zeros((1, SIZE, SIZE, 1)), train=False)
    want = jqat.init_qstats(jm, v, (1, SIZE, SIZE, 1), min_channels=mc)
    got = qat.init_qstats(create_model(model_type, **kw), (1, 1, SIZE, SIZE),
                          mc, model_type)
    assert list(got) == sorted(want) and got
    assert all(float(t) == 0.0 and t.dtype == torch.float32
               for t in got.values())


def test_range_ema_matches_jax():
    """d * ema + (1 - d) * amax in float32; an unobserved entry takes the
    batch's amax; an entry without an observation keeps its value."""
    rng = np.random.default_rng(1)
    old = {f"c{i}": np.float32(v) for i, v in enumerate(
        [0.0, 1.5, 0.25, 3.0])}
    obs = {f"c{i}": np.float32(rng.uniform(0.1, 4.0)) for i in range(3)}
    jstate = create_train_state(
        jcreate_model("ResUNet", **SMALL), jax.random.PRNGKey(0),
        (1, SIZE, SIZE, 1), LR, 4, 1e-2).replace(
            qstats={k: jnp.asarray(v) for k, v in old.items()})
    for decay in (0.99, 0.9, 0.0):
        want = jstate.update_qstats(
            {k: jnp.asarray(v) for k, v in obs.items()}, decay).qstats
        got = {k: torch.tensor(v) for k, v in old.items()}
        qat.update_qstats(got, {k: torch.tensor(v) for k, v in obs.items()},
                          decay)
        for k in old:
            assert got[k].numpy() == np.asarray(want[k]), (decay, k)
    assert qat.qstats_amax({"a": torch.tensor(0.0), "b/c": 2.5}) == {
        "b/c": 2.5}


def _both_qat(jax_init, jcfg, batches, mc=0):
    """QAT steps of JAX and the port from the same weights, the port fed
    JAX's draws."""
    jm, params, stats = jax_init
    state = create_train_state(jm, jax.random.PRNGKey(0), (1, SIZE, SIZE, 1),
                               LR, 16, 1e-2, qat=True, quant_min_channels=mc)
    state = state.replace(params=params, batch_stats=stats)
    jstep = jax.jit(_build_train_step_impl(jcfg, ACFG))
    m = _port_model(params, stats)
    tstate = TrainState(m, LR, 16, 1e-2, model_type="ResUNet")
    tstate.qstats = qat.init_qstats(m, (1, 1, SIZE, SIZE), mc, "ResUNet")
    assert sorted(tstate.qstats) == sorted(state.qstats)
    step = make_train_step(jcfg, AugmentConfig(out_size=(SIZE, SIZE)))
    jmets, tmets = [], []
    for images, masks, key in batches:
        state, jmet = jstep(state, jnp.asarray(images), jnp.asarray(masks),
                            key)
        k_aug = jax.random.split(key, 3)[0]
        tmets.append(step(tstate, torch.from_numpy(images),
                          torch.from_numpy(masks),
                          jax_draws(k_aug, images.shape[0], ACFG), None))
        jmets.append(jmet)
    return state, jmets, tstate, tmets, m


def _adam_first_moments(tstate, m) -> dict:
    return {k: tstate.optimizer.state[p]["exp_avg"].numpy()
            for k, p in m.named_parameters()}


@pytest.mark.parametrize("options,mc,seed", [
    ({}, 0, 10), ({}, 0, 11), ({}, 0, 12),
    (dict(grad_accum=2), 0, 10), (dict(grad_accum=2), 0, 11),
    ({}, 8, 30), ({}, 8, 31)])
def test_qat_step_matches_jax(two_pass_bn, jax_init, options, mc, seed):
    """One QAT step from JAX's weights, its batch and draws: the loss
    terms, BatchNorm statistics, parameters, gradients (AdamW's first
    moments) and ranges at the QAT tolerances (module docstring); with
    ``min_channels`` 8 only the wide convs are tracked."""
    batches = [(*_batch(seed), jax.random.PRNGKey(seed + 10))]
    jstate, (jmet,), tstate, (tmet,), m = _both_qat(
        jax_init, _jcfg(qat=True, **options), batches, mc)
    for name in ("loss", "bce", "dice", "focal", "boundary"):
        assert float(getattr(tmet, name)) == pytest.approx(
            float(getattr(jmet, name)), rel=QAT_TERM_RTOL), name
    want = _torch_dict(jstate.params, jstate.batch_stats)
    got = {k: v.detach().numpy() for k, v in m.state_dict().items()}
    for k in got:
        if "running_" in k:
            assert _normwise(got, want, [k]) < QAT_STATS_TOL, k
    pkeys = [k for k, _ in m.named_parameters()]
    assert _normwise(got, want, pkeys) < QAT_PARAM_TOL
    for k in pkeys:  # AdamW's first update is lr sign(g): a flip moves 2 lr
        assert np.abs(got[k] - want[k]).max() <= 2.001 * LR, k
    jmu, tmu = _adam_mu(jstate.opt_state), _adam_first_moments(tstate, m)
    assert _normwise(tmu, jmu, sorted(tmu)) < QAT_GRAD_TOL
    if mc:
        assert 0 < len(tstate.qstats) < len(qat.init_qstats(
            _port_model(*jax_init[1:]), (1, 1, SIZE, SIZE)))
    for k, v in jstate.qstats.items():
        got_r, want_r = float(tstate.qstats[k]), float(v)
        assert want_r > 0 and got_r == pytest.approx(
            want_r, rel=QAT_RANGE_RTOL), k


@pytest.mark.parametrize("remat", [True, (0,)])
def test_qat_remat_observes_each_range_once(jax_init, remat):
    """Recomputation reuses the forward's scales and records nothing: the
    ranges, loss and gradients equal the step without remat."""
    images, masks = _batch(40)
    draws = jax_draws(jax.random.PRNGKey(41), images.shape[0], ACFG)
    out = {}
    for r in (False, remat):
        m = create_model("ResUNet", **SMALL, remat=r)
        m.load_state_dict(_port_model(*jax_init[1:]).state_dict())
        state = TrainState(m, LR, 16, model_type="ResUNet")
        state.qstats = qat.init_qstats(m, (1, 1, SIZE, SIZE))
        met = make_train_step(_jcfg(qat=True),
                              AugmentConfig(out_size=(SIZE, SIZE)))(
            state, torch.from_numpy(images), torch.from_numpy(masks), draws,
            None)
        out[r] = (float(met.loss), {k: float(v) for k, v in
                                    state.qstats.items()},
                  torch.cat([state.optimizer.state[p]["exp_avg"].ravel()
                             for p in m.parameters()]))
    (l0, q0, g0), (l1, q1, g1) = out[False], out[remat]
    assert q1 == q0 and all(v > 0 for v in q0.values())
    assert l1 == pytest.approx(l0, rel=1e-6)
    assert float((g1 - g0).norm() / g0.norm()) < 1e-6


@pytest.mark.parametrize("device_guard", [False, True])
def test_nan_guard_keeps_the_ranges_of_a_rejected_step(jax_init,
                                                       device_guard):
    images, masks = _batch(50)
    draws = jax_draws(jax.random.PRNGKey(51), images.shape[0], ACFG)
    m = _port_model(*jax_init[1:])
    state = TrainState(m, LR, 16, model_type="ResUNet", nan_guard=True)
    state.qstats = qat.init_qstats(m, (1, 1, SIZE, SIZE))
    if device_guard:
        state.init_optimizer_state()
    step = make_train_step(_jcfg(qat=True, nan_guard=True),
                           AugmentConfig(out_size=(SIZE, SIZE)),
                           device_guard=device_guard)
    args = (torch.from_numpy(images), torch.from_numpy(masks), draws, None)
    assert float(step(state, *args).skipped) == 0.0
    kept = {k: v.clone() for k, v in state.qstats.items()}
    with torch.no_grad():
        m.final_conv.bias.fill_(float("nan"))
    assert float(step(state, *args).skipped) == 1.0
    assert all(torch.equal(state.qstats[k], v) for k, v in kept.items())


def test_full_state_carries_the_ranges(jax_init):
    m = _port_model(*jax_init[1:])
    state = TrainState(m, LR, 16, model_type="ResUNet")
    state.qstats = qat.init_qstats(m, (1, 1, SIZE, SIZE))
    for i, v in enumerate(state.qstats.values()):
        v.fill_(0.5 + i)
    full = state.full_state_dict()
    other = TrainState(_port_model(*jax_init[1:]), LR, 16,
                       model_type="ResUNet")
    other.qstats = qat.init_qstats(other.model, (1, 1, SIZE, SIZE), 8)
    other.load_full_state_dict(full)
    assert all(float(v) == float(state.qstats[k])
               for k, v in other.qstats.items())
    plain = TrainState(_port_model(*jax_init[1:]), LR, 16,
                       model_type="ResUNet")
    plain.load_full_state_dict(full)  # --qat off: the ranges are dropped
    assert plain.qstats is None


def test_fused_qat_epoch_equals_the_stepwise_epoch(tmp_path, start):  # noqa: F811
    runs = {}
    for name, fused in (("stepwise", False), ("fused", True)):
        tr, _ = _trainer(tmp_path, name, start, fused_epoch=fused, qat=True,
                         qat_ema_decay=0.9, grad_accum=2)
        for epoch in range(2):
            tr.train_one_epoch(epoch)
        flat, step = _state(tr)
        flat.update({f"qstats/{k}": v for k, v in tr.state.qstats.items()})
        runs[name] = (flat, step)
    (a, sa), (b, sb) = runs.values()
    assert sa == sb == 8 and sorted(a) == sorted(b)
    assert any(k.startswith("qstats/") for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k


def test_a_teacher_is_never_fake_quantized(jax_init, monkeypatch):
    """Only the student's convs take the QAT forward: no module of the
    teacher has its forward swapped while its soft targets are made, and
    the student's ranges are all observed."""
    from ddti_tpu_torch.train import distill
    from ddti_tpu_torch.train import steps as tsteps

    swapped = []
    real = distill.soft_targets

    def spy(teacher, images, t):
        swapped.append([n for n, sub in teacher.named_modules()
                        if "forward" in sub.__dict__])
        return real(teacher, images, t)

    monkeypatch.setattr(tsteps, "soft_targets", spy)
    images, masks = _batch(60)
    m = _port_model(*jax_init[1:])
    state = TrainState(m, LR, 16, model_type="ResUNet")
    state.qstats = qat.init_qstats(m, (1, 1, SIZE, SIZE))
    teacher = distill.Teacher([create_model("ResUNet", **SMALL)], amp=False)
    step = make_train_step(_jcfg(qat=True, distill_weight=0.5),
                           AugmentConfig(out_size=(SIZE, SIZE)),
                           teacher=teacher)
    step(state, torch.from_numpy(images), torch.from_numpy(masks),
         jax_draws(jax.random.PRNGKey(61), images.shape[0], ACFG), None)
    assert swapped == [[]]
    assert all(float(v) > 0 for v in state.qstats.values())
