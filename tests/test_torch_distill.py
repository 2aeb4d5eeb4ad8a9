"""Distillation, the port against ``ddti_tpu/train/distill.py`` on the CPU:
``kd_bce`` and its gradient and ``soft_targets`` (one teacher, a
two-member ensemble) on identical logits, weights and images; one train
step under a teacher and under an ensemble against JAX's
``_build_train_step_impl(teacher_apply=...)`` on identical weights and
draws (loss terms, parameters, BatchNorm statistics and gradients at
test_torch_train_options.py's limits, both packages in two-pass BatchNorm);
the teacher's architecture overrides; and the CLI's flags."""

import json
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ddti_tpu.core import Config as JConfig
from ddti_tpu.models import create_model as jcreate_model
from ddti_tpu.train import distill as jdistill
from ddti_tpu.train.checkpoint import save_params_npz
from ddti_tpu.train.state import create_train_state
from ddti_tpu.train.steps import _build_train_step_impl
from ddti_tpu_torch.cli import main as tmain
from ddti_tpu_torch.core.config import Config
from ddti_tpu_torch.data.augment import AugmentConfig
from ddti_tpu_torch.train import distill as tdistill
from ddti_tpu_torch.train.state import TrainState
from ddti_tpu_torch.train.steps import make_train_step

from test_torch_augment import jax_draws
from test_torch_train_options import (
    ACFG,
    LR,
    SIZE,
    SMALL,
    _batch,
    _check_step,
    _port_model,
    jax_init,  # noqa: F401  (a fixture)
    two_pass_bn,  # noqa: F401  (a fixture)
)

# kd_bce and soft targets, float32 both sides: relative 1e-6 (measured
# 1.2e-7); their gradients normwise 1e-6
KD_RTOL = 1e-6
TEACHER = dict(in_channels=1, out_channels=1, base_filters=4, depth=2)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: xdist runs six of these processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("temperature", [1.0, 2.0, 4.5])
def test_kd_bce_and_its_gradient_match_jax(temperature):
    rng = np.random.default_rng(int(temperature * 10))
    logits = rng.normal(0, 6, (3, 8, 8, 1)).astype(np.float32)
    soft = rng.random((3, 8, 8, 1)).astype(np.float32)
    jv, jg = jax.value_and_grad(jdistill.kd_bce)(
        jnp.asarray(logits), jnp.asarray(soft), temperature)
    x = torch.from_numpy(logits).requires_grad_()
    tv = tdistill.kd_bce(x, torch.from_numpy(soft), temperature)
    tv.backward()
    assert float(tv) == pytest.approx(float(jv), rel=KD_RTOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg),
                               rtol=KD_RTOL, atol=KD_RTOL * 1e-3)


@pytest.fixture(scope="module")
def teacher_files(tmp_path_factory):
    """Two ResUNet teachers (TEACHER) with seeded weights, written by the
    JAX package as .npz: their paths."""
    d = tmp_path_factory.mktemp("teachers")
    jm = jcreate_model("ResUNet", **TEACHER)
    paths = []
    for seed in (3, 4):
        v = jax.jit(lambda k: jm.init({"params": k}, jnp.zeros(
            (1, SIZE, SIZE, 1)), train=False))(jax.random.PRNGKey(seed))
        rng = np.random.default_rng(seed)
        stats = jax.tree.map(lambda a: rng.uniform(0.5, 1.5, a.shape)
                             .astype(np.float32), v["batch_stats"])
        path = str(d / f"teacher{seed}.npz")
        save_params_npz(path, v["params"], stats)
        paths.append(path)
    return paths


def _configs(ckpt, **kw):
    """The JAX config and the port's, student SMALL, teacher TEACHER."""
    common = dict(image_size=SIZE, batch_size=4, lr=LR,
                  distill_checkpoint=ckpt, distill_model_type="ResUNet",
                  distill_base_filters=TEACHER["base_filters"],
                  distill_depth=TEACHER["depth"], **kw)
    jcfg = JConfig(bn_exact_variance=True, **common)
    jcfg.model_kwargs = dict(SMALL)
    return jcfg, Config(model_kwargs=dict(SMALL), **common)


_JAX_TEACHERS = {}


def _jax_teacher(jcfg):
    """JAX's (apply, variables) of a checkpoint list, built once (flax's
    init runs op by op)."""
    key = jcfg.distill_checkpoint
    if key not in _JAX_TEACHERS:
        _JAX_TEACHERS[key] = jdistill.teacher_from_config(jcfg)
    return _JAX_TEACHERS[key]


@pytest.mark.parametrize("members", [1, 2])
@pytest.mark.parametrize("temperature", [1.0, 3.0])
def test_soft_targets_match_jax(teacher_files, members, temperature):
    ckpt = ",".join(teacher_files[:members])
    jcfg, cfg = _configs(ckpt)
    t_apply, t_vars = _jax_teacher(jcfg)
    teacher = tdistill.teacher_from_config(cfg)
    assert len(teacher.members) == members and not teacher.training
    images = np.random.default_rng(members).random(
        (3, SIZE, SIZE, 1)).astype(np.float32)
    want = np.asarray(jdistill.soft_targets(t_apply, t_vars,
                                            jnp.asarray(images),
                                            temperature))
    got = tdistill.soft_targets(teacher, torch.from_numpy(images),
                                temperature)
    assert got.shape == (3, SIZE, SIZE, 1) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=KD_RTOL,
                               atol=KD_RTOL)


@pytest.mark.parametrize("members", [1, 2])
def test_distillation_step_matches_jax(two_pass_bn, jax_init, teacher_files,
                                       members):
    """One step of the SMALL student under the teacher (or the two-member
    ensemble) from the same weights, batch and draws, at weight 0.4 and
    temperature 2.5: the blended loss and the other terms, parameters,
    statistics and first moments as test_torch_train_options.py holds the
    plain step."""
    ckpt = ",".join(teacher_files[:members])
    jcfg, cfg = _configs(ckpt, distill_weight=0.4, distill_temperature=2.5)
    jm, params, stats = jax_init
    t_apply, t_vars = _jax_teacher(jcfg)
    state = create_train_state(jm, jax.random.PRNGKey(0), (1, SIZE, SIZE, 1),
                               LR, 16, 1e-2)
    state = state.replace(params=params, batch_stats=stats)
    images, masks = _batch(7)
    key = jax.random.PRNGKey(11)
    jstep = jax.jit(_build_train_step_impl(jcfg, ACFG,
                                           teacher_apply=t_apply))
    jstate, jmet = jstep(state, jnp.asarray(images), jnp.asarray(masks), key,
                         t_vars)
    m = _port_model(params, stats)
    tstate = TrainState(m, LR, 16, 1e-2, model_type="ResUNet")
    step = make_train_step(cfg, AugmentConfig(out_size=(SIZE, SIZE)),
                           teacher=tdistill.teacher_from_config(cfg))
    tmet = step(tstate, torch.from_numpy(images), torch.from_numpy(masks),
                jax_draws(jax.random.split(key, 3)[0], 4, ACFG), None)
    _check_step(jstate, jmet, tstate, tmet, m)
    # the blend moved the loss off the plain composite
    plain = make_train_step(cfg, AugmentConfig(out_size=(SIZE, SIZE)))(
        TrainState(_port_model(params, stats), LR, 16),
        torch.from_numpy(images), torch.from_numpy(masks),
        jax_draws(jax.random.split(key, 3)[0], 4, ACFG), None)
    assert abs(float(plain.loss) - float(tmet.loss)) > 1e-3
    assert float(plain.bce) == pytest.approx(float(tmet.bce), rel=1e-6)


@pytest.mark.parametrize("overrides, want_type, want_kw", [
    ({}, "UNet", dict(base_filters=8, depth=3)),
    (dict(distill_model_type="ResUNet"), "ResUNet",
     dict(base_filters=8, depth=3)),
    (dict(distill_model_type="AttentionUNet", distill_base_filters=4,
          distill_depth=2), "AttentionUNet", dict(base_filters=4, depth=2)),
    (dict(distill_model_type="TransUNet", distill_base_filters=4,
          distill_depth=2, distill_kwargs=json.dumps(
              {"embed_dim": 16, "num_heads": 2,
               "num_transformer_layers": 1})), "TransUNet",
     dict(base_filters=4, depth=2, embed_dim=16, num_heads=2,
          num_transformer_layers=1, image_size=SIZE)),
])
def test_teacher_architecture_follows_jax_rules(overrides, want_type,
                                                want_kw):
    """The student's architecture unless overridden, --distill_kwargs on
    top (JAX's rules: the TransUNet takes the image size); both packages
    build teachers of one parameter count."""
    cfg = types.SimpleNamespace(model_type="UNet", image_size=SIZE,
                                use_amp_autocast=False, distill_checkpoint="x",
                                model_kwargs=dict(base_filters=8, depth=3),
                                **overrides)
    mtype, kw = tdistill.teacher_kwargs(cfg)
    assert mtype == want_type
    assert {k: kw[k] for k in want_kw} == want_kw
    teacher = tdistill.teacher_from_config(cfg, load=False)
    t_apply, t_vars = jdistill.teacher_from_config(cfg, abstract=True)
    n_jax = sum(int(np.prod(x.shape))
                for x in jax.tree.leaves(t_vars["params"]))
    assert sum(p.numel() for p in teacher.parameters()) == n_jax


def test_no_checkpoint_no_teacher():
    assert tdistill.teacher_from_config(Config()) is None


def test_the_teacher_stays_in_eval_mode(teacher_files):
    _, cfg = _configs(teacher_files[0])
    teacher = tdistill.teacher_from_config(cfg)
    teacher.train()
    assert not teacher.training
    assert not any(m.training for m in teacher.modules())
    assert not any(p.requires_grad for p in teacher.parameters())


def test_cli_distills_from_a_checkpoint(teacher_files, tmp_path):
    flags = ["--mode", "train", "--synthetic", "--device", "cpu",
             "--model_type", "UNet", "--base_filters", "4", "--depth", "2",
             "--image_size", str(SIZE), "--store_size", str(SIZE),
             "--batch_size", "16", "--epochs", "1", "--log_every", "0",
             "--distill_checkpoint", ",".join(teacher_files),
             "--distill_model_type", "ResUNet",
             "--distill_base_filters", "4", "--distill_depth", "2",
             "--distill_weight", "0.7", "--distill_temperature", "3",
             "--distill_kwargs", "{}", "--base_dir", str(tmp_path)]
    args = tmain.get_parser().parse_args(flags)
    assert (args.distill_weight, args.distill_temperature) == (0.7, 3.0)
    assert tmain.main(flags) == 0
    (log,) = tmp_path.glob("*/log/train_log.log")
    text = log.read_text()
    assert "Distilling from" in text and "weight=0.7, T=3.0" in text
    assert "Train Epoch: 1" in text
