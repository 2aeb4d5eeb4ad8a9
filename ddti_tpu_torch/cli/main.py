"""Training CLI of the port, ported from ``ddti_tpu/cli/main.py``:

    python -m ddti_tpu_torch.cli.main --mode both --synthetic \\
        --model_type ResUNet --base_filters 64 --depth 5 --image_size 512 \\
        --batch_size 16 --use_amp_autocast true --epochs 2

Any of the seven models of ``models/zoo.py`` takes its kwargs from a model
YAML, as in the JAX CLI (``--config_path`` with ``{model: {model_type,
kwargs}}``, one entry of ``configs/config.yaml``): a TransUNet's
``dropout_rate: 0.0`` lets its 1024-token bottleneck train through the
flash kernels; ImprovedVNet's ``deep_supervision: true`` adds its heads'
loss, weighted by ``--alpha``; ``use_attention`` and ``aspp_dilations``
pass through too.

The flags keep the JAX package's names, defaults and help: the
augmentation branches (``--p_crop --use_elastic --use_speckle --use_tgc
--use_clahe --aug_shared_geometry --aug_exact_warp``) and the train-step
options (``--grad_accum --nan_guard --nan_guard_patience --clip_grad_norm
--ema_decay --freeze --freeze_bn_stats --remat [LEVELS]``) among them.
``--device`` (default ``cuda``, which raises where CUDA is absent; ``cpu``
for small runs) is the port's own.

The rest of single-device training takes the JAX flags too:
``--bn_exact_variance`` (two-pass BatchNorm variance; flax's one pass is
the default), ``--fused_epoch`` (each train epoch one CUDA graph of a
step, replayed), ``--profile N`` (a ``torch.profiler`` trace of epoch 1's
first N steps in ``result/trace``), ``--lr_find N`` with
``--lr_find_min``/``--lr_find_max`` (the range test instead of training;
prints ``[LR_FIND] steepest=... min_over_10=...`` and exits 0),
``--batch_size auto`` (the largest candidate whose measured step peak
fits the card; refused on the CPU, which has no peak meter) and the
``--distill_*`` flags (a frozen teacher's tempered probabilities blended
into the loss).

Deployment takes them too: ``--qat`` (every conv trains fake-quantized,
with ``--qat_ema_decay``'s activation-range EMA and
``--quant_min_channels``), and ``--export_serving`` with
``--serving_dtype {f32,bf16,int8}`` and ``--serving_batches 1,16``: after
training, ``<Model>[_b<N>]_serving_program.pt2`` + ``.npz`` and the baked
``<Model>_serving.pt2`` in ``models/`` (``train/export.py``; int8 from the
QAT ranges, else one validation batch, on the hand-written int8 conv).
The ``[KERNELS]`` line counts ``conv_s8`` too.

Data parallelism takes the JAX CLI's six flags (``parallel/``): one
process a device, joined by ``torch.distributed``. ``--mesh data=N``
launches N ranks on this host (cuda:0..N-1 with NCCL; with ``--device
cpu`` N gloo ranks on the CPU, as JAX's tests fake devices), and
``--mesh data=N,model=M`` N x M ranks, each of a data group's M ranks
holding a band of H / M rows of its frames (``parallel/spatial.py``);
``--use_data_parallel true``, the default, launches one rank per visible
GPU where there is more than one, as JAX meshes every local device;
``--multihost`` (with ``--coordinator``, ``--num_processes`` and
``--process_id``, or their JAX environment variables, or a torch
launcher's) joins an external group, one process per device, and
``--mesh`` then names the mesh over it. Every rank trains the same state
on its rows of each global batch (BatchNorm, the Focal-Tversky index,
gradients and metrics are global); rank 0 alone writes the run directory
and prints ``[PARAMS]``, and ``[KERNELS]`` with every rank's launches
summed. After training with data > 1, ``--export_serving`` also writes
``<Model>_serving_sharded.pt2``.

Data: ``<dataset_path>/{train,val,test}`` (+ ``_mask``) decoded once
(libjpeg, in C++ threads, for all-JPEG sets) to uint8 stores at
``--store_size``, memoized under ``<dataset_path>/.store_cache``; val and
test live on the device, and so does train unless ``--native_loader on``
(or ``auto`` with a train store above 2 GiB) streams it through the C++
mmap loader (``runtime/native.py``). With ``--synthetic`` (or when the
directories are absent) 64/16/16 generated DDTI-like frames.
``--host_augment`` runs the reference's own data path instead: PIL decode
and the PIL/cv2 chain per image on the host (``data/host_transforms.py``,
one process; a synthetic JPEG dataset is written where none is on disk),
the card taking float32 batches through ``make_host_train_step``.
``--num_workers`` is kept for parity with the JAX CLI; nothing reads it.
``[PARAMS] <model>,<count>`` is printed for shell capture, as the JAX CLI
does, and at the end ``[KERNELS]`` with the launch count of each
hand-written kernel.

The run lifecycle is the JAX CLI's: ``--checkpoint_path`` warm-starts the
weights from a ``.pth``, a ``save_params_npz`` ``.npz`` or a full-state
directory of the port; with ``--resume`` it restores the full train state
from such a directory (``<run>/models/<Model>_last``, or the newest step of
a ``periodic/`` root) and completes the original ``--epochs`` budget.
SIGTERM or SIGINT saves the state and exits with 75 (EX_TEMPFAIL), the
test phase skipped, and writes ``{"checkpoint_path", "epochs"}`` to the
JSON file ``$DDTI_RESUME_HINT`` names, where set. ``--save_interval``,
``--max_keep_checkpoints``, ``--async_best_save``, ``--best_full_state``
and ``--tune_threshold`` keep their JAX meaning:

    python -m ddti_tpu_torch.cli.main --mode both --synthetic --epochs 3 \
        --resume --checkpoint_path <run>/models/ResUNet_last
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys


def _str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("true", "1", "yes", "y", "t"):
        return True
    if v.lower() in ("false", "0", "no", "n", "f"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def _batch_size_arg(v: str):
    """int, or the literal 'auto' (resolved in main() once the model is
    built, by train/autobatch.pick_batch_size)."""
    if isinstance(v, int):
        return v
    if v.strip().lower() == "auto":
        return "auto"
    try:
        return int(v)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"expected an integer or 'auto', got {v!r}")


def parse_remat_arg(v):
    """--remat value -> the models' ``remat`` kwarg: True (bare flag) or a
    tuple of level indices from a comma list ('0,1' -> (0, 1)); a
    malformed value is a usage error at parse time (JAX
    ``parse_remat_arg``)."""
    if v in (True, False, None):
        return bool(v)
    try:
        levels = tuple(sorted({int(t) for t in str(v).split(",")
                               if t.strip()}))
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"--remat expects no value or a comma list of level indices "
            f"(e.g. 0,1), got {v!r}")
    if not levels:  # '--remat ,' is refused, not read as full remat
        raise argparse.ArgumentTypeError(
            f"--remat got an empty level list: {v!r}")
    if any(level < 0 for level in levels):
        raise argparse.ArgumentTypeError(
            f"--remat level indices must be >= 0, got {v!r}")
    return levels


def get_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    # dataset
    p.add_argument("--dataset_path", default="data/dataset", type=str)
    p.add_argument("--dataset", default="DDTI", type=str)
    p.add_argument("--checkpoint_path", default="", type=str,
                   help="warm start from a .pth, .npz or full-state "
                        "directory; with --resume the full state")
    p.add_argument("--config_path", default=None, type=str)
    # augmentation
    p.add_argument("--p_crop", default=0, type=float)
    p.add_argument("--use_elastic", action="store_true")
    p.add_argument("--use_speckle", action="store_true")
    p.add_argument("--use_tgc", action="store_true")
    p.add_argument("--use_clahe", action="store_true")
    p.add_argument("--use_mixup", action="store_true")
    p.add_argument("--mixup_alpha", type=float, default=0.2)
    p.add_argument("--mixup_prob", type=float, default=0.3)
    p.add_argument("--aug_shared_geometry", action="store_true",
                   help="one flip/rotation draw per batch (diverges from "
                        "the reference's per-image draws)")
    p.add_argument("--aug_fast_warp", action="store_true", default=True,
                   help="Paeth three-shear flip+rotate (per-image geometry "
                        "kept; sub-pixel nearest-rounding divergence from "
                        "PIL, QUIRKS #23). The default; this flag is kept "
                        "as a no-op for compatibility")
    p.add_argument("--aug_exact_warp", dest="aug_fast_warp",
                   action="store_false",
                   help="exact PIL-map flip+rotate (bit-parity with the "
                        "reference's TF.rotate; one gather a pixel)")
    # model
    p.add_argument("--model_type", default="ResUNet", type=str)
    p.add_argument("--base_filters", default=64, type=int)
    p.add_argument("--depth", default=5, type=int)
    p.add_argument("--in_channels", default=1, type=int)
    p.add_argument("--out_channels", default=1, type=int)
    # loss
    p.add_argument("--bce_ratio", type=float, default=1)
    p.add_argument("--dice_ratio", type=float, default=0)
    p.add_argument("--focal_ratio", type=float, default=1)
    p.add_argument("--boundary_ratio", type=float, default=0)
    # training
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--epochs", type=int, default=10000)
    p.add_argument("--batch_size", default=16, type=_batch_size_arg,
                   help="per-step batch, or 'auto': measure one train "
                        "step's peak memory on the card at each candidate "
                        "and pick the largest that fits "
                        "(train/autobatch.py; CUDA only)")
    p.add_argument("--lr", type=float, default=1e-5)
    p.add_argument("--weight_decay", type=float, default=1e-2)
    p.add_argument("--grad_accum", default=1, type=int,
                   help="microbatches per optimizer step: each train step "
                        "runs batch_size/grad_accum-sized microbatches, "
                        "averages their gradients and applies ONE update "
                        "(BatchNorm normalizes per microbatch, like torch "
                        "accumulation loops)")
    p.add_argument("--clip_grad_norm", default=0.0, type=float,
                   help="clip gradients to this global L2 norm before the "
                        "AdamW update; 0 disables (reference parity: its "
                        "optimizer is bare AdamW)")
    p.add_argument("--nan_guard", action="store_true",
                   help="reject train steps whose loss or gradients are "
                        "non-finite: the update is skipped (the whole "
                        "train state, including the step counter, is "
                        "kept), the step contributes nothing to epoch "
                        "metrics, and training stops gracefully after "
                        "--nan_guard_patience consecutive rejections")
    p.add_argument("--nan_guard_patience", default=5, type=int,
                   help="consecutive non-finite steps tolerated under "
                        "--nan_guard before training stops")
    p.add_argument("--freeze", default="", type=str,
                   help="fine-tuning: comma list of param-path prefixes "
                        "to freeze (no updates, no weight decay) — e.g. "
                        "'encoders,bottleneck' trains only the decoder; "
                        "the JAX package's paths (encoders_0/conv1/...), "
                        "so one string freezes the same tensors in both")
    p.add_argument("--freeze_bn_stats", action="store_true",
                   help="also pin frozen modules' BatchNorm running "
                        "stats (default: BN-adapt — stats keep tracking "
                        "the fine-tuning data)")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="exponential-moving-average shadow of the params "
                        "(e.g. 0.999), updated after every step; "
                        "validation/test and the saved weights use it")
    p.add_argument("--remat", nargs="?", const=True, default=False,
                   type=parse_remat_arg, metavar="LEVELS",
                   help="recompute conv-block activations in the backward "
                        "pass (torch.utils.checkpoint). Bare --remat remats "
                        "every block; a comma list of level indices "
                        "(--remat 0,1; 0 = highest resolution) remats only "
                        "those encoder/decoder levels")
    p.add_argument("--save_interval", default=20, type=int)
    p.add_argument("--max_keep_checkpoints", default=3, type=int,
                   help="rotation depth of the periodic checkpoint manager")
    p.add_argument("--async_best_save", type=_str2bool, default=True,
                   help="write best-epoch artifacts on a background "
                        "thread (the device-to-host copy and writes "
                        "overlap training); false = blocking")
    p.add_argument("--best_full_state", action="store_true",
                   help="also write the full train state at best-IoU "
                        "epochs (resume-from-best with optimizer state). "
                        "Default: best epochs write the .npz/.pth weights "
                        "only; <Model>_last stays resumable")
    p.add_argument("--tune_threshold", action="store_true",
                   help="pick the mask binarization threshold maximizing "
                        "val IoU (19-point device sweep) and test with it "
                        "instead of the fixed 0.5")
    p.add_argument("--resume", action="store_true",
                   help="restore the full train state (params, optimizer, "
                        "step) from --checkpoint_path before training — "
                        "unlike the reference's weights-only warm start")
    p.add_argument("--log_every", default=20, type=int,
                   help="in-epoch progress interval in steps; 0 disables")
    p.add_argument("--profile", dest="profile_steps", default=0, type=int,
                   help="capture a torch.profiler trace of the first N "
                        "train steps into <result_dir>/trace (Chrome or "
                        "TensorBoard); 0 disables")
    p.add_argument("--bn_exact_variance", action="store_true",
                   help="compute BatchNorm batch variance two-pass "
                        "(E[(x-mu)^2], torch numerics) instead of flax's "
                        "one-pass E[x^2]-E[x]^2")
    p.add_argument("--fused_epoch", action="store_true",
                   help="run each training epoch as one CUDA graph of a "
                        "train step, replayed per step (a device store "
                        "only). Caveats: --profile is ignored and "
                        "--nan_guard degrades to epoch granularity (both "
                        "warned at epoch 0)")
    p.add_argument("--lr_find", type=int, default=0, metavar="N",
                   help="run an N-step learning-rate range test instead "
                        "of training (geometric ramp --lr_find_min.."
                        "--lr_find_max on the real train step; curve + "
                        "suggestions into result/, then exit)")
    p.add_argument("--lr_find_min", type=float, default=1e-7)
    p.add_argument("--lr_find_max", type=float, default=1.0)
    p.add_argument("--distill_checkpoint", default="", type=str,
                   help="knowledge distillation (train/distill.py): a "
                        "trained teacher checkpoint (.npz, .pth or a "
                        "full-state directory; a comma list is an "
                        "ensemble) whose frozen forward supervises the "
                        "student through a tempered per-pixel BCE, inside "
                        "the train step")
    p.add_argument("--distill_model_type", default="", type=str,
                   help="teacher architecture (default: --model_type)")
    p.add_argument("--distill_base_filters", default=0, type=int,
                   help="teacher base_filters (default: --base_filters)")
    p.add_argument("--distill_depth", default=0, type=int,
                   help="teacher depth (default: --depth)")
    p.add_argument("--distill_kwargs", default="", type=str,
                   help="JSON dict of extra teacher create_model kwargs "
                        "(e.g. '{\"num_heads\": 4}'), required when the "
                        "teacher trained with non-default behaviour-only "
                        "kwargs")
    p.add_argument("--distill_weight", default=0.5, type=float,
                   help="KD share of the total loss: total = (1-w)*ground"
                        "-truth composite + w*KD (1.0 = teacher only)")
    p.add_argument("--distill_temperature", default=2.0, type=float,
                   help="sigmoid softening temperature for the KD term")
    p.add_argument("--early_stop_patience", default=50, type=int)
    p.add_argument("--alpha", type=float, default=2,
                   help="weight of the deep-supervision heads' loss "
                        "(ImprovedVNet with deep_supervision: true)")
    p.add_argument("--use_amp_autocast", type=_str2bool, default=False,
                   help="bf16 autocast for the model's forward and backward")
    # the reference declares use_data_parallel type=bool, so
    # `--use_data_parallel False` parses truthy; the JAX CLI takes real
    # booleans instead (QUIRKS #19), and so does the port
    p.add_argument("--use_data_parallel", type=_str2bool, default=True,
                   help="shard the batch over all local devices (one rank "
                        "per visible GPU, where there is more than one)")
    p.add_argument("--mesh", default=None, type=str,
                   help="explicit device mesh, e.g. 'data=4' or "
                        "'data=2,model=2' — 'data' shards the batch, "
                        "'model' the frames' rows (one rank per device); "
                        "overrides --use_data_parallel")
    p.add_argument("--multihost", action="store_true",
                   help="join a multi-host run via "
                        "torch.distributed.init_process_group before device "
                        "use (one process per device)")
    p.add_argument("--coordinator", default=None,
                   help="coordinator host:port (env "
                        "JAX_COORDINATOR_ADDRESS, or a torch launcher's "
                        "MASTER_ADDR/MASTER_PORT)")
    p.add_argument("--num_processes", type=int, default=None,
                   help="total process count (env JAX_NUM_PROCESSES)")
    p.add_argument("--process_id", type=int, default=None,
                   help="this process's rank (env JAX_PROCESS_ID)")
    p.add_argument("--native_loader", default="auto",
                   choices=["auto", "on", "off"],
                   help="stream train batches through the C++ threaded "
                        "mmap loader instead of a device-resident store; "
                        "auto = when the train store exceeds 2 GiB "
                        "(too large to keep on the card alongside "
                        "training)")
    p.add_argument("--host_augment", action="store_true",
                   help="strict-parity mode: run the PIL/cv2 host "
                        "augmentation chain (reference oracle) instead of "
                        "the on-device pipeline")
    p.add_argument("--surface_metrics", default=True, type=_str2bool,
                   help="per-image HD95/ASSD surface distances in test()")
    p.add_argument("--export_serving", action="store_true",
                   help="after training, write the serving bundles: "
                        "<Model>_serving_program.pt2 + .npz (weights as "
                        "arguments, one a --serving_batches entry) and the "
                        "baked <Model>_serving.pt2 (train/export.py)")
    p.add_argument("--serving_batches", default=None, type=str,
                   help="comma list of batch shapes for --export_serving "
                        "(e.g. 1,8,128): one bundle per shape, servable "
                        "together by cli/serve as a multi-program set")
    p.add_argument("--serving_dtype", choices=["f32", "bf16", "int8"],
                   default="f32",
                   help="exported bundle precision: bf16 halves the .npz; "
                        "int8 runs every conv as s8 x s8 -> s32 on the "
                        "hand-written kernel (per-channel weights, "
                        "activation ranges from --qat or one calibration "
                        "batch; train/quantize.py)")
    p.add_argument("--quant_min_channels", type=int, default=0,
                   help="int8 serving and --qat: only convs with "
                        "max(cin, cout) >= this (mixed precision)")
    p.add_argument("--qat", action="store_true",
                   help="quantization-aware training: fake-quantized conv "
                        "forwards (per-channel int8 weights, per-tensor "
                        "activations, STE gradients) and an activation-range "
                        "EMA that --serving_dtype int8 exports take "
                        "(train/qat.py; respects --quant_min_channels)")
    p.add_argument("--qat_ema_decay", type=float, default=0.99,
                   help="per-step decay of the QAT activation-range EMA")
    p.add_argument("--tta", action="store_true",
                   help="4-way flip test-time augmentation in test(): the "
                        "sigmoid probabilities averaged over {identity, h, "
                        "v, hv} flips (4 forward passes, eval/tta.py); "
                        "validation stays without it")
    p.add_argument("--mode", default="test", choices=["train", "test", "both"])
    p.add_argument("--image_size", default=512, type=int)
    p.add_argument("--store_size", default=512, type=int)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--synthetic", action="store_true",
                   help="run on generated DDTI-like data (no dataset needed)")
    p.add_argument("--base_dir", default="experiments", type=str)
    p.add_argument("--device", default="cuda",
                   help="cuda[:N] (raises without CUDA) or cpu")
    return p


def build_config(args: argparse.Namespace):
    from ddti_tpu_torch.core.config import Config

    fields = {f.name for f in dataclasses.fields(Config)}
    cfg = Config(**{k: v for k, v in vars(args).items() if k in fields})
    cfg.model_kwargs = dict(
        in_channels=args.in_channels, out_channels=args.out_channels,
        base_filters=args.base_filters, depth=args.depth)
    if args.config_path:
        cfg.apply_model_yaml(args.config_path)
    return cfg


NATIVE_AUTO_BYTES = 2 << 30  # stores past this stream via the C++ loader


def load_sources(cfg, device, synthetic: bool, native: str = "auto",
                 logger=None):
    """(train, val, test) sources: the dataset on disk, or 64/16/16
    synthetic frames (seeds seed, seed + 10000, seed + 20000) when asked
    for or when the split directories are absent.

    From disk, every split decodes once into ``<dataset_path>/.store_cache``
    (the JAX package's file names); val and test are device stores. The
    TRAIN split streams through the native C++ threaded mmap loader
    (``runtime/host_loader.cpp``) when ``native`` is "on", or "auto" and
    its store exceeds ``NATIVE_AUTO_BYTES``: the counterpart of the
    reference's DataLoader worker processes. ``logger`` gets a line a
    split: decoded or read from the cache, in how many seconds."""
    import time
    from ddti_tpu_torch.data.dataset import (
        DeviceDataSource,
        MedicalDataset,
        decode_to_store,
        decode_to_store_files,
        store_cache_paths,
    )
    from ddti_tpu_torch.data.synthetic import generate_ddti_like

    size = (cfg.store_size, cfg.store_size)
    root = cfg.dataset_path
    on_disk = all(os.path.isdir(os.path.join(root, s))
                  for s in ("train", "val", "test"))
    if synthetic or not on_disk:
        return tuple(
            DeviceDataSource(*generate_ddti_like(n, size, cfg.seed + s),
                             device=device)
            for n, s in ((64, 0), (16, 10_000), (16, 20_000)))
    cache = os.path.join(root, ".store_cache")
    sources = []
    for split in ("train", "val", "test"):
        ds = MedicalDataset(os.path.join(root, split),
                            os.path.join(root, f"{split}_mask"))
        use_native = split == "train" and (
            native == "on"
            or (native == "auto"
                and len(ds) * size[0] * size[1] > NATIVE_AUTO_BYTES))
        hit = all(os.path.isfile(p)
                  for p in store_cache_paths(ds, size, cache))
        t0 = time.perf_counter()
        if use_native:
            from ddti_tpu_torch.runtime import NativeBatchLoader, NativeSource

            ip, mp, n = decode_to_store_files(ds, size, cache_dir=cache)
            secs = time.perf_counter() - t0
            sources.append(NativeSource(NativeBatchLoader(
                ip, mp, n, size[0], size[1], cfg.batch_size,
                seed=cfg.seed)))
        else:
            images, masks = decode_to_store(ds, size, cache_dir=cache)
            secs = time.perf_counter() - t0
            sources.append(DeviceDataSource(images, masks, device=device,
                                            names=ds.img_names))
        if logger is not None:
            logger.info(
                f"Data: {split} {len(ds)} frames at {size[0]}x{size[1]} "
                f"{'from the .store_cache' if hit else 'decoded'} in "
                f"{secs:.3f} s" + (" (native loader)" if use_native else ""))
    return tuple(sources)


def load_host_sources(cfg, synthetic: bool = False):
    """The strict-parity sources of ``--host_augment``: MedicalDataset and
    the PIL/cv2 host chain in single-process HostBatchIterators (the
    reference's data path without its worker processes). Without the split
    directories (or with ``synthetic``) a synthetic JPEG dataset is written
    under the temporary directory first, as the JAX CLI does."""
    import tempfile

    from ddti_tpu_torch.data.dataset import HostBatchIterator, MedicalDataset
    from ddti_tpu_torch.data.host_transforms import (
        build_eval_chain,
        build_train_chain,
    )
    from ddti_tpu_torch.data.synthetic import write_synthetic_dataset

    root = cfg.dataset_path
    if synthetic or not os.path.isdir(os.path.join(root, "train")):
        root = os.path.join(tempfile.gettempdir(), "ddti_synth_host")
        if not os.path.isdir(os.path.join(root, "train")):
            write_synthetic_dataset(root, n_train=64, n_val=16, n_test=16,
                                    size=(cfg.store_size, cfg.store_size),
                                    seed=cfg.seed)
    out = (cfg.image_size, cfg.image_size)
    train_tf = build_train_chain(cfg.use_elastic, cfg.use_speckle,
                                 cfg.use_tgc, cfg.use_clahe, out)
    eval_tf = build_eval_chain(out)
    sources = []
    for split, tf, shuffle in (("train", train_tf, True),
                               ("val", eval_tf, False),
                               ("test", eval_tf, True)):
        ds = MedicalDataset(os.path.join(root, split),
                            os.path.join(root, f"{split}_mask"), tf)
        sources.append(HostBatchIterator(ds, cfg.batch_size, shuffle,
                                         seed=cfg.seed))
    return tuple(sources)


def _warm_start(cfg, args, model, logger) -> None:
    """The weights-only warm starts (JAX ``cli/main.py``): a ``.pth``
    (also under --resume, as in JAX), an ``.npz`` (refused under
    --resume: it holds no optimizer state) or, without --resume, a
    full-state directory's live weights."""
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into

    cp = cfg.checkpoint_path
    if cp.endswith(".npz") and args.resume:
        raise ValueError(
            ".npz bundles hold weights only (no optimizer/step); use "
            "--checkpoint_path without --resume to warm start")
    if cp.endswith(".pth") or cp.endswith(".npz") or not args.resume:
        load_checkpoint_into(cp, cfg.model_type, model, prefer_ema=False)
        logger.info(f"Warm-started weights from {cp}")


def _resume(cfg, trainer, logger) -> None:
    """The full resume: parameters, BatchNorm statistics, AdamW, the step
    and the EMA shadow from a full-state directory, or the newest step of
    a managed root (numeric step directories); the run continues the
    ORIGINAL epoch budget from the restored step's epoch."""
    from ddti_tpu_torch.train.checkpoint import (
        ManagedCheckpointer,
        restore_checkpoint,
    )

    cp = cfg.checkpoint_path
    try:
        if any(d.isdigit() for d in os.listdir(cp)):
            mgr = ManagedCheckpointer(cp)
            restored = mgr.restore_latest(trainer.state)
            mgr.close()
            if restored is None:
                raise FileNotFoundError(
                    f"no checkpoint steps found under {cp}")
            logger.info(f"Resumed full state from {cp} step {restored[1]}")
        else:
            restore_checkpoint(cp, trainer.state)
            logger.info(f"Resumed full state from {cp}")
    except ValueError as e:
        raise ValueError(
            f"--resume could not restore {cp} into this run's state — a "
            "full resume needs the SAME optimizer structure (check "
            "--freeze/--clip_grad_norm match the original run; use "
            "--checkpoint_path without --resume for a weights-only warm "
            "start)") from e
    trainer.start_epoch = min(
        int(trainer.state.step) // trainer.steps_per_epoch, cfg.epochs)


def _write_resume_hint(cfg, logger) -> None:
    """``$DDTI_RESUME_HINT``'s JSON, the sweep runner's contract: relaunch
    with --resume --checkpoint_path <checkpoint_path>."""
    hint = os.environ.get("DDTI_RESUME_HINT")
    if not hint:
        return
    try:
        with open(hint, "w") as f:
            json.dump({"checkpoint_path": os.path.join(
                cfg.model_dir, f"{cfg.model_type}_last"),
                "epochs": cfg.epochs}, f)
    except OSError as e:
        logger.warning(f"could not write resume hint {hint}: {e}")


def _multihost_device(args, spec):
    """A joined process's device: ``--device`` where it names one (cuda:N
    or cpu), else cuda:LOCAL_RANK (a torch launcher's), else the process
    id modulo the visible GPUs."""
    import torch

    from ddti_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    index = (int(local) if local not in (None, "")
             else spec.process_id % max(torch.cuda.device_count(), 1))
    return resolve_device(f"cuda:{index}")


def _launch(args, argv) -> int:
    """Decide how the run is laid out and start it: joined to an external
    group (``--multihost``), N local ranks (``--mesh data=N``, or one per
    visible GPU under ``--use_data_parallel``), or one process."""
    import torch

    from ddti_tpu_torch.core.device import resolve_device
    from ddti_tpu_torch.parallel import (
        check_mesh_shape,
        initialize_multihost,
        launch_local,
        make_mesh,
        parse_mesh_spec,
        spec_from,
    )
    from ddti_tpu_torch.parallel.mesh import backend_for, init_process_group
    from ddti_tpu_torch.parallel.multihost import free_port

    shape = parse_mesh_spec(args.mesh) if args.mesh else None
    if args.multihost:
        spec = spec_from(args.coordinator, args.num_processes,
                         args.process_id)
        device = _multihost_device(args, spec)
        if initialize_multihost(spec, device):
            import torch.distributed as dist

            try:
                return _run(args, make_mesh(shape, device, multihost=True))
            finally:
                dist.destroy_process_group()
    device = resolve_device(args.device)
    if shape:
        world = math.prod(shape.values())
        check_mesh_shape(shape, torch.cuda.device_count()
                         if device.type == "cuda" else world)
    elif (args.use_data_parallel and device.type == "cuda"
          and torch.cuda.device_count() > 1):
        shape = {"data": torch.cuda.device_count()}
    if not shape:
        return _run(args, None)
    world = math.prod(shape.values())
    if world > 1:
        return launch_local(_rank_main, world, device.type, (argv,), shape)
    import torch.distributed as dist

    init_process_group(0, 1, f"127.0.0.1:{free_port()}",
                       backend_for(device))
    try:
        return _run(args, make_mesh(shape, device))
    finally:
        dist.destroy_process_group()


def _rank_main(mesh, argv) -> int:
    """A spawned rank of ``launch_local``: the same command line, on its
    mesh."""
    return _run(get_parser().parse_args(argv), mesh)


def _rank0_first(mesh, fn):
    """``fn()`` on rank 0 first, then on the others (a barrier between):
    what it writes (a decode cache, a synthetic dataset) is made once."""
    from ddti_tpu_torch.parallel.mesh import host_reduce

    out = fn() if mesh is None or mesh.rank == 0 else None
    host_reduce(0.0, mesh)
    return fn() if out is None else out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    return _launch(get_parser().parse_args(argv), argv)


def _run(args, mesh) -> int:
    """The run itself, in this process: single-device without a mesh,
    else one data-parallel rank of it."""
    import torch

    from ddti_tpu_torch.core.device import resolve_device
    from ddti_tpu_torch.core.logging import create_logger, rank_logger
    from ddti_tpu_torch.core.prng import set_seed
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.ops import attention, conv_s8, edt
    from ddti_tpu_torch.parallel.mesh import broadcast_object, host_reduce
    from ddti_tpu_torch.train.engine import Trainer
    from ddti_tpu_torch.train.state import count_params
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    device = resolve_device(str(mesh.device if mesh else args.device))
    writer = mesh is None or mesh.rank == 0
    cfg = build_config(args)
    if ((args.resume or cfg.checkpoint_path)
            and not os.path.exists(cfg.checkpoint_path or "")):
        # an asked-for warm start or resume never falls through to a fresh
        # random init
        raise FileNotFoundError(
            f"--checkpoint_path {cfg.checkpoint_path!r} does not exist"
            + (" (required by --resume)" if args.resume else ""))
    set_seed(cfg.seed)
    if mesh is not None:
        cfg.mesh_shape = dict(mesh.shape)
    if writer:
        cfg.make_dirs()
    # one run directory: rank 0 names it (a timestamp), the others take it
    dirs = broadcast_object([cfg.cfg_dir, cfg.model_dir, cfg.log_dir,
                             cfg.result_dir], mesh)
    cfg.cfg_dir, cfg.model_dir, cfg.log_dir, cfg.result_dir = dirs
    logger = (create_logger(os.path.join(cfg.log_dir, "train_log.log"))
              if writer else rank_logger(mesh.rank))
    if mesh is not None:
        logger.info(f"Using explicit mesh {mesh.shape} over {mesh.world} "
                    f"devices ({mesh.world} processes, "
                    f"{'gloo' if device.type == 'cpu' else 'nccl'}; this "
                    f"rank {mesh.rank} on {device})")

    model_kwargs = dict(cfg.model_kwargs)
    if args.remat:
        model_kwargs["remat"] = args.remat
    if cfg.model_type == "TransUNet":
        model_kwargs.setdefault("image_size", cfg.image_size)
    model = init_like_flax(create_model(cfg.model_type, **model_kwargs),
                           cfg.seed)
    if cfg.checkpoint_path:
        _warm_start(cfg, args, model, logger)
    model.to(device)

    held = None  # under --batch_size auto: the bytes held before the pick
    if cfg.batch_size == "auto":
        # measured before the sources exist (they batch at this size)
        from ddti_tpu_torch.train.autobatch import pick_batch_size

        held = torch.cuda.memory_allocated(device)
        dp = mesh.data if mesh is not None else 1
        cfg.batch_size = pick_batch_size(
            cfg, model, data_parallel=dp,
            host_augment=bool(args.host_augment), logger=logger,
            mesh=mesh if mesh is not None and mesh.model > 1 else None)
        # every rank measured its own card: the smallest pick fits all
        cfg.batch_size = int(host_reduce(cfg.batch_size, mesh, "min"))
        logger.info(f"[autobatch] selected --batch_size {cfg.batch_size}"
                    + (f" (global over data={dp})" if dp > 1 else ""))
        torch.cuda.reset_peak_memory_stats(device)

    if args.host_augment:
        sources = _rank0_first(mesh, lambda: load_host_sources(
            cfg, synthetic=args.synthetic))
    else:
        sources = _rank0_first(mesh, lambda: load_sources(
            cfg, device, args.synthetic, native=args.native_loader,
            logger=logger))
    trainer = Trainer(cfg, sources, logger, model, mesh=mesh)
    if args.resume and os.path.isdir(cfg.checkpoint_path):
        _resume(cfg, trainer, logger)

    n_params = count_params(model)
    logger.info(f"Model: {cfg.model_type} | Trainable params: "
                f"{n_params / 1e6:.2f}M ({n_params:,}) | device {device}")
    if writer:
        print(f"[PARAMS] {cfg.model_type},{n_params}")  # shell capture

    if args.lr_find:
        # the range test instead of training; the curve and suggestions
        # land in result/ (train/lr_finder.py). Rerun with --lr <pick>.
        from ddti_tpu_torch.train.lr_finder import run_lr_finder

        r = run_lr_finder(trainer, num_steps=args.lr_find,
                          min_lr=args.lr_find_min, max_lr=args.lr_find_max)
        if writer:
            print(f"[LR_FIND] steepest={r['lr_steepest']:.4g} "
                  f"min_over_10={r['lr_min_over_10']:.4g}")
        return 0

    rc = 0
    if args.mode in ("train", "both"):
        trainer.train()
        if held is not None:  # what the picked batch took in the run
            peak = torch.cuda.max_memory_allocated(device) - held
            kept = torch.cuda.max_memory_reserved(device) - held
            logger.info(f"[autobatch] the run's peak: {peak / 2**30:.2f} "
                        f"GiB allocated, {kept / 2**30:.2f} GiB reserved "
                        f"above what the model held before the pick "
                        f"({peak} B, {kept} B)")
        if trainer.preempted:
            # checkpoints are saved; EX_TEMPFAIL tells a scheduler or the
            # sweep runner to relaunch with --resume
            if writer:
                _write_resume_hint(cfg, logger)
            logger.info("Run preempted — test phase skipped "
                        "(exit code 75, checkpoints saved)")
            rc = 75
    if rc == 0 and args.mode in ("test", "both"):
        trainer.test()
    # the hand-written kernels this run launched (0 on the CPU, where the
    # plain versions run): the shell-capture proof of the kernel path
    # (also in the run's log, where a sweep's interleaved jobs keep it apart)
    # under a mesh every rank's launches, summed
    bwd = attention.flash_backward_cuda
    counts = {name: int(host_reduce(n, mesh)) for name, n in (
        ("edt_minplus", edt.edt_cuda.launches),
        ("flash_fwd", attention.flash_forward_cuda.launches),
        ("flash_bwd_dkdv", bwd.launches_dkdv),
        ("flash_bwd_dq", bwd.launches_dq),
        ("conv_s8", conv_s8.launches()))}
    kernels = "[KERNELS] " + " ".join(f"{k}={v}" for k, v in counts.items())
    if writer:
        logger.info(kernels)
        print(kernels)
    return rc


if __name__ == "__main__":
    sys.exit(main())
