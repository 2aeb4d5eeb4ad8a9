"""Train-mode BatchNorm variance, the port against flax: one pass (flax's
``use_fast_variance=True``, the JAX package's default and the port's) and
two passes (``--bn_exact_variance``: ``set_bn_fast_variance(False)`` on the
JAX side, ``BatchNorm2d.exact_variance`` on the port's). One layer's
forward, running statistics and input and parameter gradients in float32
and in bf16 (the dtype a BatchNorm sees under autocast); a ResUNet's loss
gradients and statistics in float64 on both sides (of a random
projection of the logits: the loss suite reduces in float32) (the float32 one-pass
gradient carries cancellation noise that neither side reproduces:
QUIRKS #24); ``--remat``; and how the Trainer and the CLI set the mode.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.models import blocks as jblocks
from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.train.torch_interop import export_state_dict
from ddti_tpu_torch.cli import main as tmain
from ddti_tpu_torch.core.config import Config
from ddti_tpu_torch.data.dataset import synthetic_source
from ddti_tpu_torch.models import blocks, create_model
from ddti_tpu_torch.train.engine import Trainer

SMALL = dict(in_channels=1, out_channels=1, base_filters=4, depth=3)
SIZE = 32
# one layer in float32: forward and running statistics within 1e-6
# (measured 2.4e-7), gradients within 1e-5 of max|g| (measured 5.7e-6 on
# the bias); in bf16 the output within two bf16 roundings of max|y|, the
# gradients within 2e-2 normwise (bf16 gradients), statistics within 1e-6
F32_TOL = dict(out=1e-6, stats=1e-6, grad=1e-5)
BF16_TOL = dict(out=2 ** -7, stats=1e-6, grad=2e-2)
# a ResUNet in float64, both modes: the loss, every gradient and statistic
# within 1e-9 relative (normwise)
F64_TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: xdist runs six of these processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _mode(exact: bool):
    """Both packages in one variance mode: flax's process-wide setting and
    the port's class default (for modules no Trainer set)."""
    jblocks.set_bn_fast_variance(not exact)
    blocks.BatchNorm2d.exact_variance = exact
    try:
        yield
    finally:
        jblocks.set_bn_fast_variance(True)
        blocks.BatchNorm2d.exact_variance = False


def _layer_case(seed, shape=(4, 6, 6, 5)):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    # a channel mean of 3 std: E[x^2] is 10 var, where one pass loses digits
    x = rng.normal(3.0, 1.0, shape).astype(np.float32) * rng.uniform(
        0.5, 2.0, c).astype(np.float32)
    return dict(
        x=x, r=rng.normal(size=shape).astype(np.float32),
        scale=rng.uniform(0.5, 1.5, c).astype(np.float32),
        bias=rng.normal(0, 1, c).astype(np.float32),
        mean0=rng.normal(0, 1, c).astype(np.float32),
        var0=rng.uniform(0.5, 1.5, c).astype(np.float32))


def _flax_layer(case, dtype):
    bn = jblocks.batch_norm(train=True, dtype=dtype)
    stats = {"mean": case["mean0"], "var": case["var0"]}

    def f(x, s, b):
        y, upd = bn.apply({"params": {"scale": s, "bias": b},
                           "batch_stats": stats}, x,
                          mutable=["batch_stats"])
        return (y.astype(jnp.float32) * case["r"]).sum(), (y, upd)

    x = jnp.asarray(case["x"], dtype)
    (_, (y, upd)), g = jax.value_and_grad(f, argnums=(0, 1, 2),
                                          has_aux=True)(
        x, jnp.asarray(case["scale"]), jnp.asarray(case["bias"]))
    f32 = [np.asarray(jnp.asarray(t, jnp.float32)) for t in (y, *g)]
    return f32[0], upd["batch_stats"], f32[1:]


def _port_layer(case, dtype, exact):
    tb = blocks.BatchNorm2d(case["x"].shape[-1])
    tb.load_state_dict({"weight": torch.from_numpy(case["scale"]),
                        "bias": torch.from_numpy(case["bias"]),
                        "running_mean": torch.from_numpy(case["mean0"]),
                        "running_var": torch.from_numpy(case["var0"])})
    tb.exact_variance = exact
    x = torch.from_numpy(case["x"]).permute(0, 3, 1, 2).to(dtype)
    x.requires_grad_()
    y = tb.train()(x)
    assert y.dtype == dtype
    r = torch.from_numpy(case["r"]).permute(0, 3, 1, 2)
    (y.float() * r).sum().backward()

    def nhwc(t):
        return t.detach().float().permute(0, 2, 3, 1).numpy()

    return (nhwc(y), {"mean": tb.running_mean.numpy(),
                      "var": tb.running_var.numpy()},
            [nhwc(x.grad), tb.weight.grad.numpy(), tb.bias.grad.numpy()])


@pytest.mark.parametrize("exact", [False, True], ids=["one_pass", "two_pass"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", [0, 1])
def test_layer_matches_flax(exact, dtype, seed):
    """One train-mode layer: the output, the running statistics (flax's
    momentum update of the biased variance) and the gradients of sum(y *
    r) with respect to the input, the scale and the bias."""
    case = _layer_case(seed)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    with _mode(exact):
        jy, jstats, jg = _flax_layer(case, getattr(jnp, dtype))
    ty, tstats, tg = _port_layer(case, getattr(torch, dtype), exact)
    assert np.abs(ty - jy).max() <= tol["out"] * np.abs(jy).max()
    for k in ("mean", "var"):
        np.testing.assert_allclose(tstats[k], np.asarray(jstats[k]),
                                   rtol=tol["stats"], atol=tol["stats"])
    for t, j in zip(tg, jg):
        if dtype == "float32":
            assert np.abs(t - j).max() <= tol["grad"] * np.abs(j).max()
        else:
            assert np.linalg.norm(t - j) <= tol["grad"] * np.linalg.norm(j)


def test_one_pass_and_two_pass_differ_as_flax_modes_do():
    """At a channel mean of 1000 std, float32's one pass loses the unit
    variance to cancellation on both sides alike (E[x^2] ~ 1e6, whose ulp
    is 0.0625: both off the truth by more than 1e-2 and less than 32 ulps;
    the noise itself follows the summation order, so the two sides' values
    differ), and the two passes keep it on both (1e-3)."""
    rng = np.random.default_rng(3)
    x = (1000.0 + rng.normal(size=(2, 8, 8, 3))).astype(np.float32)
    case = dict(_layer_case(3, x.shape), x=x)
    true = x.astype(np.float64).var(axis=(0, 1, 2))
    for exact in (False, True):
        with _mode(exact):
            _, jstats, _ = _flax_layer(case, jnp.float32)
        _, tstats, _ = _port_layer(case, torch.float32, exact)
        for stats in (tstats["var"], np.asarray(jstats["var"])):
            err = np.abs((stats - 0.9 * case["var0"]) / 0.1 - true)
            if exact:
                assert err.max() < 1e-3 * true.max()
            else:
                assert 1e-2 < err.max() < 32 * 0.0625


def test_one_pass_stats_reduce_in_at_least_float32():
    x = torch.randn(2, 3, 4, 4, dtype=torch.float64) * 3 + 1
    mean, var = blocks.one_pass_stats(x)
    assert mean.dtype == var.dtype == torch.float64
    torch.testing.assert_close(mean, x.mean(dim=(0, 2, 3)))
    torch.testing.assert_close(var, x.var(dim=(0, 2, 3), correction=0))
    mean, var = blocks.one_pass_stats(x.to(torch.bfloat16))
    assert mean.dtype == var.dtype == torch.float32


@functools.lru_cache(maxsize=None)
def _jax_resunet_f64(exact):
    """JAX's float64 loss, gradients and updated statistics of a ResUNet
    (one jitted program), with its weights, statistics and batch."""
    with jax.enable_x64(True):
        jm = jcreate_model("ResUNet", **SMALL, dtype=jnp.float64)
        v = jax.jit(lambda k: jm.init(
            {"params": k}, jnp.zeros((1, SIZE, SIZE, 1), jnp.float64),
            train=False))(jax.random.PRNGKey(0))
        rng = np.random.default_rng(0)
        stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape),
                             v["batch_stats"])
        params = jax.tree.map(lambda a: np.asarray(a, np.float64),
                              v["params"])
        x = rng.random((3, SIZE, SIZE, 1))
        # a float64 objective: the loss suite reduces in float32
        y = rng.normal(size=(3, SIZE, SIZE, 1))

        def loss_fn(p):
            out, upd = jm.apply({"params": p, "batch_stats": stats},
                                jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
            return (out * y).sum(), upd

        with _mode(exact):  # flax reads the mode as it traces
            (jloss, upd), jg = jax.jit(jax.value_and_grad(
                loss_fn, has_aux=True))(params)
        want = export_state_dict("ResUNet", jg, upd["batch_stats"])
        return float(jloss), want, params, stats, x, y


def _resunet_f64(exact, remat=False):
    """A ResUNet's loss, gradients and running statistics after one
    train-mode forward, in float64 on both sides from the same weights."""
    jloss, want, params, stats, x, y = _jax_resunet_f64(exact)
    m = create_model("ResUNet", **SMALL, remat=remat).double()
    m.load_state_dict({k: torch.from_numpy(np.array(v, np.float64))
                       for k, v in export_state_dict(
                           "ResUNet", params, stats).items()})
    blocks.set_bn_exact_variance(m, exact)
    out = m.train()(torch.from_numpy(x).permute(0, 3, 1, 2))
    loss = (out.permute(0, 2, 3, 1) * torch.from_numpy(y)).sum()
    loss.backward()
    got = {k: p.grad for k, p in m.named_parameters()}
    got.update({k: b for k, b in m.named_buffers()})
    return jloss, want, float(loss), got


@pytest.mark.parametrize("exact", [False, True], ids=["one_pass", "two_pass"])
def test_resunet_gradients_match_flax_in_float64(exact):
    jloss, want, tloss, got = _resunet_f64(exact)
    assert tloss == pytest.approx(jloss, rel=F64_TOL)
    assert sorted(got) == sorted(want)
    for k, t in got.items():
        w = np.asarray(want[k])
        err = np.linalg.norm(t.detach().numpy() - w)
        assert err <= F64_TOL * max(np.linalg.norm(w), 1e-12), k


def test_remat_recomputes_with_the_same_one_pass_statistics():
    """--remat's recomputation normalises with the one-pass statistics of
    the forward (not F.batch_norm's two passes) and updates nothing: the
    loss, gradients and running statistics equal the plain run's."""
    _, _, loss, got = _resunet_f64(False)
    _, _, loss_r, got_r = _resunet_f64(False, remat=True)
    assert loss_r == loss
    for k in got:
        torch.testing.assert_close(got_r[k], got[k], rtol=1e-12, atol=0)


def test_eval_mode_ignores_the_variance_mode():
    case = _layer_case(5)
    outs = []
    for exact in (False, True):
        tb = blocks.BatchNorm2d(5)
        tb.exact_variance = exact
        tb.load_state_dict({"weight": torch.from_numpy(case["scale"]),
                            "bias": torch.from_numpy(case["bias"]),
                            "running_mean": torch.from_numpy(case["mean0"]),
                            "running_var": torch.from_numpy(case["var0"])})
        outs.append(tb.eval()(torch.from_numpy(case["x"]).permute(0, 3, 1,
                                                                  2)))
    assert torch.equal(outs[0], outs[1])


def _trainer(tmp_path, **kw):
    cfg = Config(model_type="ResUNet", image_size=SIZE, store_size=SIZE,
                 batch_size=4, epochs=1, log_every=0, base_dir=str(tmp_path),
                 **kw)
    cfg.make_dirs()
    from ddti_tpu_torch.core.logging import create_logger

    src = synthetic_source(4, (SIZE, SIZE), 0)
    logger = create_logger(str(tmp_path / "log.txt"), console=False)
    return Trainer(cfg, (src, src, src), logger,
                   create_model("ResUNet", **SMALL)), tmp_path / "log.txt"


@pytest.mark.parametrize("exact", [False, True])
def test_trainer_sets_the_mode_on_its_modules(tmp_path, exact):
    """Set both ways, whatever the class default says, and logged as the
    JAX Trainer logs it."""
    blocks.BatchNorm2d.exact_variance = not exact
    try:
        tr, log = _trainer(tmp_path, bn_exact_variance=exact)
    finally:
        blocks.BatchNorm2d.exact_variance = False
    modes = {m.exact_variance for m in tr.model.modules()
             if isinstance(m, blocks.BatchNorm2d)}
    assert modes == {exact}
    assert ("--bn_exact_variance: two-pass" in log.read_text()) == exact


def test_cli_takes_bn_exact_variance(tmp_path):
    assert tmain.get_parser().parse_args([]).bn_exact_variance is False
    flags = ["--mode", "train", "--synthetic", "--device", "cpu",
             "--base_filters", "4", "--depth", "2", "--image_size", "32",
             "--store_size", "32", "--batch_size", "16", "--epochs", "1",
             "--log_every", "0", "--bn_exact_variance", "--base_dir",
             str(tmp_path)]
    assert tmain.main(flags) == 0
    (log,) = tmp_path.glob("*/log/train_log.log")
    assert "--bn_exact_variance: two-pass" in log.read_text()
