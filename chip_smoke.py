#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``ddti_tpu_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

or, to compare another tree of the repository (a commit unpacked with git
archive) with this one on the same card, in the order other, this, this,
other: ``python3 chip_smoke.py --ab OTHER_TREE`` (see ``ab``; ``--ab
OTHER_TREE probes`` for the probes and the EDT alone: conv3x3, gather,
exp2_probe in every mode and the EDT's queued time and passes; ``--ab
OTHER_TREE serve`` for the bf16 serving batch alone); ``python3
chip_smoke.py --zoo`` runs the zoo phases alone and profiles every zoo
model at both sizes; ``python3 chip_smoke.py --infer`` runs the infer phase
alone (the AttentionUNet trained first, as the zoo phase trains it);
``python3 chip_smoke.py --recipe`` runs the recipe phase alone;
``python3 chip_smoke.py --lifecycle`` the lifecycle phase alone;
``python3 chip_smoke.py --legacy`` the legacy phase alone;
``python3 chip_smoke.py --hostdata`` the hostdata phase alone;
``python3 chip_smoke.py --trainer`` the trainer phase alone;
``python3 chip_smoke.py --deploy`` the deploy phase alone;
``python3 chip_smoke.py --profiles`` the ResUNet and TransUNet train-step
profiles (phase 11) alone.

Phases, one or more lines each; any failure ends the run with a traceback
and a non-zero exit:

1. device   — needs CUDA; prints the card's name and power limit
              (nvidia-smi) and turns TF32 off, so float32 means float32.
2. build    — compiles the CUDA sources under ddti_tpu_torch/csrc with nvcc
              (one process per source, all at once) into build/, and the
              DDTI_POLY_EXP2=1 library beside it at the same time; prints
              each kernel's registers, spills and SASS opcode counts, and
              holds the poly build to the polynomial (no MUFU.EX2 in a
              flash kernel, no FRND or F2I on any poly path).
3. kernels  — every kernel against its plain PyTorch version on the card,
              with timings: flash attention forward at the serving path's
              shapes (in float32 with its TF32 split pre-pass timed apart);
              the flash backward kernels (csrc/flash_bwd.cu: dK/dV
              with the delta pre-pass, and dQ) at the same shapes, a ragged
              S and bf16 heads of 64 and 128, dq/dk/dv against their limits,
              two calls bit-equal; each flash row timed as one call between
              CUDA events, as a queue of calls (device time alone, the
              wrapper's host enqueue time beside it) and per kernel entry
              point by CUDA events around its launch, beside the plain
              version's; beside each flash
              row its bound (work counted from the shape over the card's
              published peaks, and the exp2 floor) and the fastest backend
              of PyTorch's fused
              attention (scaled_dot_product_attention, a yardstick the port
              never calls); the EDT (csrc/edt.cu) bit for bit against its
              plain version and against scipy at the training path's
              shapes, ragged ones and edge frames, timed as one call and
              queued, its column and row passes apart (torch.profiler),
              beside its bound and the min-plus algorithm's.
4. probes   — the ports of the softmax probes of benchmarks/
              (ddti_tpu_torch/probes): csrc/exp2_probe.cu in every mode
              against its plain version (<= 2 ulp, the copy bit for bit)
              on the probe's input and on edge values; the m-skip forward
              bit for bit against the production forward and within the
              forward's limits of its plain version; in a subprocess with
              DDTI_POLY_EXP2=1 (its own library, built beside the default
              one in the build phase) the flash forward and backward
              against their plain versions in poly mode, queued times
              beside; then the three probes' lines. The conv3x3 and
              gather probes: csrc/conv3x3.cu against its plain version
              (within one bf16 ulp or 2^-8 max|y|) at the probe's shape,
              its CPU shape, ragged ones, its tiling's edges and C = CO of
              64-512, and (the error-growth check) where the bias cancels a
              sum of 9 C positive products, within CANCEL_LIMIT of the
              exact value at every C; csrc/gather_probe.cu bit for bit
              against its plain version in every mode with edge indices
              planted, at the staged path's edges and on every builder (A,
              B, C, B2, F, P4, P5, P6), its count of staged (tile, image)
              pairs equal to plan_windows'; then the four probes' runs,
              with queued times beside cuDNN, torch.gather and the XLA
              builders' torch calls, the bounds, and each kernel's bytes
              from L2 into the SMs a call, the previous design's beside
              (mma.sync for the conv, per-element for the gather).
5. slice    — the serving daemon (ddti_tpu_torch.cli.serve) with the
              TransUNet of configs/config.yaml (base_filters 64, depth 4,
              512x512 -> 1024 bottleneck tokens), random weights from a seed,
              bf16, batch 16. A few dozen PNG frames are POSTed concurrently
              to /predict; the flash kernel's launch count must rise by 4
              (one per encoder layer) for every batch. In bf16, the kernel
              path's masks must agree with a plain-attention run of the same
              frames as closely as the kernel's own plain version does (the
              bf16 noise floor): tightly when batched alike in-process,
              loosely for the masks the daemon served (its batches form by
              arrival). In float32 both paths' masks must agree on >= 99.9%
              of pixels and their logits to 1e-3.
6. profile  — device time per bf16 serving batch of 16 on the kernel path
              and on the plain path (CUDA events), and a torch.profiler
              breakdown of the kernel path with the device's busy share.
7. train    — the training CLI (python -m ddti_tpu_torch.cli.main --mode
              both --synthetic) with the flagship ResUNet (base_filters 64,
              depth 5) at 512^2, batch 16, bf16, 1 epoch, in a subprocess:
              exit 0, the parameter count, the JAX CLI's run tree, finite
              loss terms with a nonzero boundary term, val IoU and test
              metrics with HD95/ASSD, a best .pth that loads strictly and an
              .npz in the JAX package's key layout, and exactly the expected
              number of EDT kernel launches; with --profile 3, whose trace
              under result/trace must hold the EDT's row kernel 3 times
              (the trainer phase's (c)).
8. ttrain   — (at the same time as 7) the same CLI training the serving
              slice's TransUNet
              (base_filters 64, depth 4, 512^2 -> 1024 tokens) from a model
              YAML with dropout_rate 0.0 and --tta, batch 16, bf16, 1
              epoch: the same checks, "tta": true in test_metrics.json, and
              exactly the expected launches of the flash forward (four
              forwards a test batch), both backward kernels and the EDT.
9. step     — one float32 train step from one state and batch with the
              kernel EDT and with the plain EDT: bit-equal boundary terms and
              updated parameters equal to 1e-6.
10. tstep   — one float32 TransUNet train step from one state and batch
              through the flash kernels and through their plain versions
              (swapped in explicitly): loss terms to 1e-6, gradients and
              updated parameters within the stated normwise limits; then a
              bf16 step at the default dropout 0.1, which the gate sends to
              the plain attention: no flash launch, finite terms.
11. tprofile — device time per train step (CUDA events), bf16 first:
              the S = 4096 TransUNet (base_filters 32, depth 3) at the
              largest batch <= 16 whose plain path fits, on the kernel and
              the plain path, then in float32 (the training CLI's default
              dtype, TF32 off) on the kernel path; torch.profiler top-8,
              busy share, the flash and EDT kernels' shares. Under
              --profiles also the ResUNet at 512^2 / batch 16 and 256^2 /
              batch 128 and the TransUNet at 512^2 / batch 16 (S = 1024)
              on both paths in bf16 and float32.
12. zoo train — the same CLI training each of the rest of the zoo (UNet,
              ASPPUNet, AttentionUNet, VNet2D and ImprovedVNet with
              deep_supervision and --alpha 2) from a one-entry model YAML of
              configs/config.yaml's base_filters 64, depth 5 entries, 512^2,
              batch 16, bf16, 1 epoch, three runs at a time: run_cli's
              checks with the JAX
              package's key set of each model, its parameter count, and
              exactly the expected EDT launches (the heads' loss runs none);
              then zoo serve: each best .pth through cli/serve.py's
              load_predictor on the card (a bf16 batch of 16, uint8 masks,
              their agreement with float32 masks) and float32 logits on the
              card against the CPU's at batch 1, within 1e-3.
    infer   — the inference CLI (python -m ddti_tpu_torch.cli.infer
              --device cuda) over synthetic JPEG frames (600x480 and
              1024x768, the latter 6 tiles at window 512, stride 256), on
              the slice's TransUNet in (a) resized --bf16 --tta --mask_dir,
              (b) --sliding_window, (c) --fold_bn --prob --overlay and (d) a
              two-checkpoint ensemble, and on the AttentionUNet entry's
              trained .pth in (a) and (c): exit 0, every output file, and
              exactly the expected flash launches (layers x flips x batches
              or tile chunks x members, + --fold_bn's check). In process:
              TTA'd float32 logits, kernel vs plain path, within 1e-3 of the
              largest; folded vs unfolded float32 logits within
              fold_batchnorm's own tolerance; bf16 vs float32 TTA masks
              >= 99.5%; device times of a bf16 batch of 16 with and without
              TTA and --fold_bn, and of one tiled 1024x768 frame. Then the
              daemon with --tta --fold_bn: single POSTs equal to serve_body's
              masks of the same padded batch, one ?overlay=1 equal to
              _overlay_png, 16 flash launches a batch.
13. zoo step — for each of those models one float32 train step at 512^2,
              batch 4, with the kernel EDT and with the plain one: bit-equal
              boundary terms, parameters to 1e-6 (ImprovedVNet's step with
              its heads' term).
14. zoo profile — after tprofile: each of those models' bf16 train step at
              512^2 / batch 16, and UNet's also at 256^2 / batch 128, as
              tprofile reads the ResUNet's.
15. recipe  — the training recipe's augmentation branches and train-step
              options, on the flagship ResUNet (base_filters 64, depth 5):
              augment_batch with every branch on (crop, elastic, the exact
              warp, speckle, TGC, CLAHE) on the card and the CPU from the
              same draws at 512^2 / batch 16 and 256^2 / batch 128 (masks
              equal but at near-integer ties of a floored coordinate, at
              most 0.05% of the pixels; images up to CLAHE within 1e-5
              (at 64 px; scaled with the size, the float32 spacing of the
              remap's coordinates) but there; CLAHE bit for bit on the same uint8 frames, whose values differ
              only within 1e-5 of a rounding boundary; the Paeth warp bit
              for bit where its shifts agree); test.sh's six ablation commands through the CLI (256^2,
              batch 16, bf16, 1 epoch, all seven at once) and one run with
              --grad_accum 2 --clip_grad_norm 1.0 --ema_decay 0.999
              --nan_guard --freeze encoders_0 --freeze_bn_stats --remat 0,1:
              run_cli's checks, exactly the expected EDT launches (2 a
              train step under --grad_accum 2), the frozen tensors
              bit-equal to the initial weights in both saved .npz; one
              float32 step at 512^2 / batch 16 with --remat and --remat 0,1
              against none (loss and gradients <= 1e-6 normwise, running
              statistics equal, a lower memory peak); the bf16 step's device
              time at both sizes with each branch, all, and --remat, beside
              augment_batch's own time; whether cv2 imports.
16. lifecycle — the Trainer's run lifecycle on the flagship ResUNet
              (base_filters 64, depth 5, 512^2, batch 16, bf16) through the
              CLI, 3 epochs with --save_interval 1 --max_keep_checkpoints 2
              --tune_threshold --best_full_state --ema_decay 0.999: one run
              uninterrupted and, at the same time, one sent SIGTERM once
              epoch 2 is under way (exit 75, "test phase skipped", the
              DDTI_RESUME_HINT JSON, ResUNet_last/ with its .npz and .pth),
              then that run resumed from the hint ("Resuming at epoch 2/3",
              epochs 2-3 only); for both full runs periodic/ holding 2 and
              3, the tuned threshold in test_metrics.json, a decodable
              test_boundaries_0.png and one EDT launch a train and val step
              and a test batch. The preempted state restored on the card
              bit for bit against its file (every tensor and the step), its
              bytes and save time; one float32 step from it with the kernel
              EDT and with the plain EDT, bit-equal boundary terms. An
              improving epoch's cost: _save_best and the next train epoch,
              blocking with the full state (under --lifecycle also async,
              and both without the full state). Then
              cli/average.py over the resumed run's periodic states with
              the BatchNorm pass on 32 frames (the JAX layout's keys), and
              cli/infer.py predicting the infer phase's frames from it.
17. legacy  — the nine fixed-architecture models (models/legacy.py,
              models/mores.py; LEGACY): python -m ddti_tpu_torch.cli.params
              printing the JAX tool's 14 counts; run.sh's path with the
              port's tools: a nine-entry model matrix split by
              cli/split_config.py and swept by cli/sweep.py --config_dir,
              5 jobs at a time, at run.sh's extras with 1 epoch and bf16
              (256^2, batch 16): every job exit 0 with JAX's parameter
              count, check_run's checks with the JAX key set of each model,
              exactly the expected EDT launches in each run's log; then
              cli/aggregate.py's nine ranked rows and CSV; MoresTransUNet's
              best .pth served by load_predictor at 512^2, bf16, batch 16
              (1024 bottleneck tokens: 4 flash_fwd launches a batch), its
              float32 logits kernel path on the card vs plain path on the
              CPU within 1e-3 and the bf16 batch's device time on both
              paths; LegacyUNet's float32 step, kernel vs plain EDT
              (bit-equal boundary, parameters to 1e-6); the nine bf16 train
              steps at 512^2 / batch 16 (median of 5) and their peaks.
18. hostdata — the reference's own data path feeding the flagship ResUNet
              (bf64, d5, bf16, 512^2 / batch 16) from synthetic JPEG pairs
              on disk (600x480 and 1024x768; 32 train, 16 val, 16 test):
              (a) the host loader (runtime/host_loader.cpp) built by g++
              into build/, whether its libjpeg decode is in it and what the
              machine has of libjpeg; (b) the train JPEGs decoded to 512^2
              natively (within one gray level of PIL) and by PIL, host ms a
              frame; (c) the training CLI with --host_augment and every
              branch and with --native_loader on, at once, then the native
              run again, reading the .store_cache (decode seconds saved):
              run_cli's checks and exactly the expected EDT launches; (d) a
              float32 make_host_train_step on the card against the CPU on
              one host batch (terms and parameters normwise), the kernel
              EDT against the plain one bit-equal; (e) the bf16 step's
              device and wall ms, img/s and busy share fed by the device
              store, the native loader and the host chain; (f) the daemon
              on the serving slice's TransUNet: native vs PIL masks,
              POST /reload under concurrent clients, --watch, /metrics'
              series against the JAX daemon's, request decode ms.
19. trainer — the rest of single-device training on the flagship ResUNet
              (bf64, d5, bf16, 512^2 / batch 16): (a) the step with one-pass
              and with two-pass BatchNorm variance (interleaved medians),
              the running statistics one step of each leaves, and the
              one-pass module on the card against float64 on the CPU
              (statistics, output, input gradient; BN_LIMITS); (b) a
              stepwise and a --fused_epoch epoch (one eager step, a CUDA
              graph replayed) from one start on a 128-frame store, cuDNN
              deterministic: wall times, replays, the parameters and
              statistics of the stepwise epoch bit for bit, the EDT once
              a step counted from torch.profiler's exported trace and the
              wrapper's count (the eager step's and the capture's); (c) at
              once, the CLI with --batch_size auto --fused_epoch on a
              192-frame dataset (each candidate's measured peak, the
              pick's within 0.92 of the budget, its fused epoch's replays,
              the run's peak, the EDT's launches), --lr_find 30 at 256^2 (finite
              rows or a stated stop, finite suggestions) and (d) a UNet
              student (bf32, d4) under the serving slice's TransUNet as
              teacher (4 flash forwards a train step, run_cli's checks);
              --profile 3 is phase 7's run (run alone, this phase runs its
              own); then the student's step with and without the teacher,
              its launches a step.
20. deploy  — (run after the infer phase, on the flagship checkpoint that
              phase 7 wrote) the int8 conv (csrc/conv_s8.cu) bit for bit
              against its plain version at every zoo geometry
              (ops/conv_s8.py:ZOO_GEOMETRIES; s32 sums, float32 and bf16
              outputs, two calls equal), timed at the flagship's 3x3 conv
              (one call, queued) beside its bound and cuDNN's bf16
              F.conv2d; at once, the serving TransUNet trained by the CLI
              with --qat --export_serving --serving_dtype int8
              --serving_batches 1,16 (run_cli's checks, exact launches),
              cli/export (f32) and cli/quantize (--min_channels 128) on the
              flagship, and this process exporting its bf16 and int8
              (min_channels 0) bundles; one serving batch of 16 at 512^2
              of each of the four, and at the same time cli/infer on the
              QAT run's int8 batch-16 bundle (its launches); the int8
              (min_channels 0) batch traced by torch.profiler (conv_s8's
              and the elementwise kernels' shares, busy); the daemon on
              the QAT run's two-program
              int8 set, masks against serve_body's int8 graph, the conv_s8
              and flash launches of its requests. ``--deploy`` runs the
              phase alone (training its own flagship first) with every
              flagship level's conv row.
21. result  — the total wall time, a JSON line of the kernels (the flash
              forward's with the infer, legacy, hostdata and trainer
              phases' launches; the EDT's with the recipe, lifecycle,
              legacy, hostdata and trainer phases' launches and numbers;
              conv_s8's with the deploy phase's),
              then the device
              line. Every busy share is the union of the device intervals
              of kernels, memcpys and memsets in a record_function window
              (``device_busy``); the first window of a run also prints
              the old summed key_averages beside it, once.
"""

import atexit
import concurrent.futures
import copy
import http.client
import io
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time

SEED = 0
CLOCK_SAMPLE_MS = 200  # main's device-memory sampling period
STEP_RUNS = 5          # train-step profiles: CUDA-event median of
STEP_WARMUP = 2
DEVICE = "cuda"  # the training phases' device
SLICE = dict(in_channels=1, out_channels=1, base_filters=64, depth=4,
             image_size=512)
N_LAYERS = 4          # TransUNet's fixed encoder depth
BATCH = 16
N_FRAMES = 64
# bf16 masks of the kernel path may disagree with the plain path's on at
# most this share of pixels more than the kernel's own plain version does:
# KERNEL_MARGIN when all three are batched alike in-process, SERVED_MARGIN
# for the masks the daemon served, whose batches form by arrival
KERNEL_MARGIN = 5e-5
SERVED_MARGIN = 5e-4
# kernel vs plain: bf16 differs by the rounding of the probability tile,
# float32 by summation order only
O_LIMIT = {"bfloat16": 2e-2, "float32": 1e-4}
LSE_LIMIT = 1e-3
# (B, H, S, D, dtype): the slice's shape in both dtypes, the S = 4096
# bottleneck of config.yaml's TransUNet at depth 3 in both dtypes, and
# full-width heads
KERNEL_SHAPES = [(16, 8, 1024, 32, "bfloat16"), (16, 8, 1024, 32, "float32"),
                 (2, 8, 4096, 32, "bfloat16"), (2, 2, 1024, 128, "float32"),
                 (2, 8, 4096, 32, "float32")]
F32_LOGIT_LIMIT = 1e-3
# float32 masks of the kernel path and the plain path: at least this share
# of pixels agree (bf16 masks are held to the noise floor above instead)
F32_MASK_AGREE = 0.999
PROFILE_BATCHES = 5
PROFILE_TOP = 8
# the EDT at the training path's shape (N, H, W), bs128 at 256^2 (bench.py's
# headline leg), the recipe phase's 256^2 batch of 16 and its --grad_accum 2
# microbatch, ragged widths and a single row; timed at the first two
EDT_SHAPES = [(16, 512, 512), (128, 256, 256), (16, 256, 256), (8, 256, 256),
              (8, 100, 100), (4, 200, 333), (3, 1, 333)]
EDT_TIMED = 2
# the lower envelope's integer operations a pixel, both passes (work_counts)
EDT_OPS_PER_PIXEL = 26
# the training slice: the CLI's flagship ResUNet at its defaults
TRAIN = dict(model_type="ResUNet", base_filters=64, depth=5, image_size=512,
             batch_size=16, epochs=1)
SYNTHETIC = (64, 16, 16)  # the CLI's --synthetic train/val/test frames
TRAIN_TIMEOUT_S = 600
STEP_PARAM_RTOL = 1e-6
# (image size, batch): the CLI default and bench.py's headline leg
TRAIN_PROFILES = [(512, 16), (256, 128)]
TRAIN_PROFILE_STEPS = 3
# backward kernels vs plain, max |difference| over max |value| of each of
# dq, dk, dv: float32 by summation order, bf16 also by P and dS landing an
# ulp apart where the two sides' float32 values straddle a bf16 boundary
G_LIMIT = {"bfloat16": 2e-2, "float32": 1e-4}
# the forward's shapes, a ragged S, and bf16 at the two wider padded head
# widths (each its own kernel instantiation)
BWD_SHAPES = KERNEL_SHAPES + [(2, 8, 1000, 32, "bfloat16"),
                              (4, 4, 1024, 64, "bfloat16"),
                              (2, 2, 1024, 128, "bfloat16")]
BWD_PROFILE_CALLS = 5
# calls of a kernel's wrapper enqueued back to back, with no synchronisation
# inside, behind a device-side sleep of SLEEP_CYCLES clocks (~0.1 s, far
# longer than the host takes to enqueue them): the host clock gives the
# wrapper's enqueue time per call, CUDA events the device time per call
# with no launch waiting for the host
HOST_CALLS = 100
SLEEP_CYCLES = 200_000_000
# the host shares its cores: where it enqueued the calls slower than the
# sleep lasted (autograd calls take ~1 ms each), the measurement is taken
# again behind a sleep the next of these many times as long
SLEEP_SCALES = (1, 4, 16)
# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): dense
# tensor-core bf16, float32 outside the tensor cores and dense TF32 on them,
# in FLOP/s, and HBM3 bytes/s; the exp2 unit issues 16 ex2 per clock per
# SM, 132 SMs at the 1980 MHz boost clock. A float32-accurate product runs
# on the tensor cores as three TF32 products (3xTF32: a_lo b_hi + a_hi b_lo
# + a_hi b_hi), at a third of the TF32 rate and above the FMA rate, so the
# float32 flash kernels' work is bound at 495 / 3 TFLOP/s. The EDT's
# integer operations run on the SM's INT32 lanes, 64 a clock per SM (four
# partitions of 16; NVIDIA's H100 architecture whitepaper), at the same
# clock.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12, "tf32x3": 495e12 / 3}
PEAK_BYTES = 3.35e12
EX2_PER_S = 132 * 16 * 1.98e9
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# PyTorch's fused attention backends, timed as yardsticks; the fastest
# that takes a shape is reported
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")
# the TransUNet training slice: the serving slice's model from a model YAML
# (configs/config.yaml:337-343) with dropout_rate 0.0, trained by the CLI
TSLICE = dict(in_channels=1, out_channels=1, base_filters=64, depth=4,
              dropout_rate=0.0)
TSLICE_PARAMS = 19511873
TTRAIN = dict(image_size=512, batch_size=16, epochs=1)
# float32 step, flash kernels vs their plain versions: loss terms (relative)
# and gradients and updated parameters (normwise over all of them). The
# attention gradients' float32 summation-order differences (~3e-7 relative)
# reach 2.5e-5 normwise over all gradients, and the first AdamW step turns
# the gradients that lie within that noise of zero into sign flips of up to
# 2 lr: 1.2e-6 normwise on the parameters (H100); held to 4x and 8x that
TSTEP_TERM_RTOL = 1e-6
TSTEP_GRAD_RTOL = 1e-4
TSTEP_PARAM_RTOL = 1e-5
# the S = 4096 TransUNet of configs/config.yaml:303-308 (512^2, depth 3)
TLONG = dict(in_channels=1, out_channels=1, base_filters=32, depth=3,
             dropout_rate=0.0)
TLONG_BATCHES = (16, 8, 4, 2, 1)
# the probes phase: exp2_probe's edge values (signed zeros, -inf, the TPU
# kernels' -1e30 sentinel, halves that round to even, both ends of the
# clamp, a subnormal), held to EXP2_ULPS of the plain version; the m-skip
# forward's shapes (the probe's, the slice's, a ragged S), bit for bit
# against the production forward; the poly build's flash shapes (a and c of
# PERF.md)
EXP2_EDGES = (0.0, -0.0, float("-inf"), -1e30, -126.5, 127.0, 0.5, 1.5, 2.5,
              -0.5, -1.5, -2.5, -125.5, -126.0, -127.5, -130.0, 126.5, 3.0,
              -20.0, 1e-40, -1e-40, 0.25, -0.75)
EXP2_ULPS = 2
MSKIP_SHAPES = [(8, 8, 4096, 32), (16, 8, 1024, 32), (2, 8, 1000, 32)]
# conv3x3 kernel vs plain: the probe's shape, its CPU shape, a ragged one,
# the kernel's edges (W below its 8-column tile, W = 1, one image 300 wide,
# an odd count of pixel tiles, the 32-channel box at C = 32 and 96, CO of
# one 8-channel group and past a 128-channel tile),
# and (N, spatial, C = CO) of the error-growth check
CONV_SHAPES = [(128, 128, 128, 128, 128), (2, 16, 16, 128, 128),
               (3, 10, 12, 64, 96), (2, 16, 5, 64, 64), (2, 9, 1, 64, 64),
               (1, 4, 300, 64, 64), (3, 16, 24, 64, 64), (2, 20, 20, 32, 64),
               (2, 20, 20, 96, 128), (2, 16, 16, 64, 8), (2, 16, 16, 64, 136)]
CONV_GROWTH = (16, 64, (64, 128, 256, 512))
POLY_SHAPES = [(16, 8, 1024, 32, "bfloat16"), (16, 8, 1024, 32, "float32")]
POLY_TIMEOUT_S = 600
# the rest of the zoo, each at its configs/config.yaml entry of
# base_filters 64, depth 5 (UNet :64-70, ASPPUNet :204-210, AttentionUNet
# :274-280, VNet2D :414-420, ImprovedVNet :484-490), trained by the CLI from
# a one-entry model YAML with these kwargs added; the JAX package's
# parameter count of each entry as it stands (flax eval_shape)
ZOO = {"UNet": {}, "ASPPUNet": {}, "AttentionUNet": {}, "VNet2D": {},
       "ImprovedVNet": {"deep_supervision": True}}
ZOO_JAX_PARAMS = {"UNet": 124_373_057, "ASPPUNet": 160_020_545,
                  "AttentionUNet": 125_776_752, "VNet2D": 129_958_039,
                  "ImprovedVNet": 131_361_712}
ZOO_TRAIN = dict(image_size=512, batch_size=16, epochs=1)
# the zoo's CLI runs, this many at a time: each holds its model, optimizer
# state and 512^2 / batch 16 activations on the card, and most of its wall
# time is process start, initialisation and weight files
ZOO_TRAIN_PARALLEL = 3
ZOO_STEP_BATCH = 4     # the float32 step, kernel EDT vs plain
ZOO_CPU_BATCH = 2      # float32 logits on the card vs on the CPU
ZOO_LOGIT_RTOL = 1e-3  # max |card - CPU| / max |CPU|, the serving limit

# the infer phase (the inference CLI, its modes, the daemon's --tta and
# --fold_bn): synthetic grayscale JPEG frames (width, height, count), the
# 1024 x 768 ones 6 tiles each at the CLI's window 512, stride 256
INFER_FRAMES = ((600, 480, 24), (1024, 768, 8))
INFER_WINDOW, INFER_STRIDE, INFER_TILE_BATCH = 512, 256, 8
INFER_FLIPS = 4
INFER_PARALLEL = 6     # CLI runs at a time (process start dominates each)
INFER_TIMEOUT_S = 300
INFER_LOGIT_RTOL = 1e-3   # TTA'd float32 logits, kernel vs plain path
INFER_BF16_AGREE = 0.995  # bf16 masks vs float32 masks, TTA on
INFER_CHECK_BATCH = 4     # in-process float32 comparisons
INFER_TIMED_RUNS = 20     # median of, CUDA events
INFER_DAEMON_POSTS = 4
# --overlay's marching squares run in Python over every mixed 2x2 cell of
# a mask, seconds a 1024 x 768 frame where a random-weight model's mask is
# speckled: mode (c) takes this many frames of each size
INFER_OVERLAY_FRAMES = 2
# the AttentionUNet of configs/config.yaml:274-280 (the zoo's entry)
INFER_ATTN = dict(base_filters=64, depth=5)
# the recipe phase: test.sh:8-13's ablations (the reference's recorded
# experiments) at 256^2, batch 16, 1 epoch, bf16, and one run with every
# train-step option; the card-vs-CPU, remat and timing checks at
# TRAIN_PROFILES
RECIPE_SETTINGS = {"plain": [], "speckle": ["--use_speckle"],
                   "tgc": ["--use_tgc"], "clahe": ["--use_clahe"],
                   "mixup": ["--use_mixup"], "elastic": ["--use_elastic"]}
RECIPE_OPTIONS = ["--grad_accum", "2", "--clip_grad_norm", "1.0",
                  "--ema_decay", "0.999", "--nan_guard", "--freeze",
                  "encoders_0", "--freeze_bn_stats", "--remat", "0,1"]
RECIPE_TRAIN = dict(image_size=256, store_size=256, batch_size=16, epochs=1)
RECIPE_PARALLEL = 7
CLI_SEED = 42          # the CLI's --seed default: its initial weights
RECIPE_BRANCHES = {"crop": dict(p_crop=0.5), "elastic": dict(use_elastic=True),
                   "exact warp": dict(fast_warp=False),
                   "shared geometry": dict(shared_geometry=True),
                   "speckle": dict(use_speckle=True),
                   "tgc": dict(use_tgc=True), "clahe": dict(use_clahe=True)}
RECIPE_ALL = dict(p_crop=0.5, use_elastic=True, use_speckle=True,
                  use_tgc=True, use_clahe=True)
RECIPE_TIE = 1e-4        # a floored coordinate this close to an integer
RECIPE_TIE_SHARE = 5e-4  # mask pixels that may differ, all at ties
# image values off ties: the CPU tests' 1e-5 at 64 px frames, scaled with
# the float32 spacing of the remap's absolute source coordinates (2^-23 H:
# 7.6e-6 at 64 px, 6.1e-5 at 512), since a one-ulp coordinate difference
# moves a bilinear sample by up to that spacing
RECIPE_TOL = 1e-5
RECIPE_TOL_SIZE = 64
RECIPE_FREEZE = "encoders"  # the prefix profile_recipe's frozen steps take
REMAT_RTOL = 1e-6        # remat vs plain float32 step: loss, gradients
# the lifecycle phase: the flagship ResUNet (TRAIN's width and size, bf16)
# through the CLI for 3 epochs with a rotated full state every epoch (2
# kept), the best full state, the threshold tuned on val and an EMA shadow
# (so that the restored state holds one); once uninterrupted, once sent
# SIGTERM in epoch 2 and resumed; then cli/average.py over the periodic
# states with the BatchNorm pass on 32 frames, and cli/infer.py on that
LIFECYCLE_EPOCHS = 3
LIFECYCLE_FLAGS = ["--save_interval=1", "--max_keep_checkpoints=2",
                   "--tune_threshold", "--best_full_state",
                   "--ema_decay=0.999", "--log_every=1"]
LIFECYCLE_RECALIB = 32
# the best saves timed, (--best_full_state, --async_best_save): all four
# under --lifecycle; the whole run times the blocking full-state save only
# (the CLI runs write theirs in the background)
BEST_SAVE_MODES = ((False, False), (False, True), (True, False), (True, True))
WHOLE_RUN_BEST_SAVES = ((True, False),)

# the legacy phase: the nine fixed-architecture models of
# models/legacy.py and models/mores.py, run.sh's sweep path at 1 epoch in
# bf16, aggregate, MoresTransUNet served, LegacyUNet's step, nine profiles
LEGACY = ("LegacyUNet", "TripleBranchImprovedVNet", "MoresUNet",
          "MoresVNet2D", "MoresAttentionUNet", "MoresResUNet",
          "MoresASPPUNet", "MoresTransUNet", "MoresImprovedVNet")
# what the JAX package's cli/params.py prints (its two sections)
PARAMS_JAX = {
    "reference": {"UNet": 31_042_369, "VNet2D": 8_127_031,
                  "ImprovedVNet": 160_435_681, "TransUNet": 20_560_449,
                  "ResUNet": 32_429_185, "ASPPUNet": 39_947_329,
                  "AttentionUNet": 31_388_013},
    "active": {"UNet": 124_373_057, "ResUNet": 129_960_065,
               "ASPPUNet": 160_020_545, "AttentionUNet": 125_776_752,
               "TransUNet": 67_297_345, "VNet2D": 8_127_031,
               "ImprovedVNet": 8_216_056}}
# the default ctors' counts as JAX counts them (the reference set's, and
# MoresUNet's and MoresImprovedVNet's from jax.eval_shape)
LEGACY_JAX_PARAMS = {
    "LegacyUNet": 31_042_369, "TripleBranchImprovedVNet": 160_435_681,
    "MoresUNet": 31_042_369, "MoresVNet2D": 8_127_031,
    "MoresAttentionUNet": 31_388_013, "MoresResUNet": 32_429_185,
    "MoresASPPUNet": 39_947_329, "MoresTransUNet": 20_560_449,
    "MoresImprovedVNet": 160_435_681}
LEGACY_KW = dict(in_channels=1, out_channels=1)  # each entry's kwargs
# run.sh:12-13's extras at 1 epoch in place of 2, in bf16
LEGACY_EXTRA = ("--mode both --synthetic --epochs 1 --image_size 256 "
                "--store_size 256 --batch_size 16 --use_amp_autocast true")
LEGACY_JOBS = 9  # the nine at once (5 at a time took two rounds)
LEGACY_SWEEP_TIMEOUT_S = 900
LEGACY_SERVE = dict(image_size=512, batch=16, batches=2)
LEGACY_STEP_BATCH = 4
LEGACY_PROFILE = (512, 16)
LEGACY_PROFILE_RUNS = 5

# the hostdata phase: the reference's own data path feeding the flagship
# (TRAIN's ResUNet, bf16, 512^2 / batch 16) from synthetic JPEG pairs on disk
# (width, height, count a split; the infer phase's two frame sizes), through
# the host chain (--host_augment with every branch) and through the C++
# loader over a natively decoded .store_cache (--native_loader on, twice:
# the second run reads the cache); the daemon's reload surface on the
# serving slice's TransUNet
HOSTDATA_SPLITS = {"train": ((600, 480, 16), (1024, 768, 16)),
                   "val": ((600, 480, 8), (1024, 768, 8)),
                   "test": ((600, 480, 8), (1024, 768, 8))}
HOSTDATA_CHAIN = ["--use_elastic", "--use_speckle", "--use_tgc",
                  "--use_clahe"]
HOSTDATA_DECODE_TOL = 1  # gray levels, native decode vs PIL
# (d): the float32 host step on the card against the CPU, the flagship's
# widths at (size, batch) that the CPU takes in seconds. Loss terms
# (relative) and BatchNorm statistics (normwise) card vs CPU; gradients
# and updated parameters (normwise over all of them) against the same step
# in float64 on the CPU, where the card's error may be at most
# HOSTDATA_F32_FACTOR times the CPU's own float32 error: the card is as
# accurate as the CPU. (Bars on card vs CPU directly read past their limits
# on an H100: parameters 1.645e-05 normwise against 1e-5, gradients
# 1.214e-04 against 1e-4, updates more than 0.05 lr apart on 0.86% of the
# parameters against 0.5%: float32's own noise at this depth.)
HOSTDATA_STEP = (192, 2)
HOSTDATA_TERM_RTOL = 1e-5
HOSTDATA_STAT_RTOL = 1e-5
HOSTDATA_F32_FACTOR = 2.0
HOSTDATA_TIMED = 5    # (e): steps timed a source, after 2 warm-up steps
HOSTDATA_AGREE = 0.995  # (f): native vs PIL masks, share of pixels
HOSTDATA_POSTS = 8
HOSTDATA_CLIENTS = 8
HOSTDATA_TIMEOUT_S = 600
# the trainer phase: the rest of single-device training on the flagship
# (bf16, 512^2 / batch 16). (a) one-pass against two-pass BatchNorm: the
# running statistics one step of each leaves (normwise), and the one-pass
# module on the card against float64 on the CPU: mean and variance over the
# activations' RMS (and its square), the bf16 output over max|y| (a bf16
# rounding is 2^-9 of it), the input gradient normwise (bf16 gradients)
BN_LIMITS = {"running": 1e-3, "stats": 1e-5, "output": 2 ** -7,
             "grad": 1e-2}
TRAINER_TIMED = 5      # steps timed a mode, after 2 warm-up steps each
TRAINER_STORE = 128    # (b): an 8-step epoch at batch 16
# (c): --batch_size auto's train frames, so that the pick (64 on an H100)
# leaves a fused epoch of several steps: an eager one, a capture, replays
TRAINER_AUTO_FRAMES = 192
TRAINER_LR_FIND = 30   # (c): --lr_find's steps, at 256^2
PROFILE_STEPS = 3      # (c): --profile's traced steps
# (d): the student under the serving slice's TransUNet as teacher
TRAINER_STUDENT = dict(base_filters=32, depth=4)
# a kernel's name in a profiler trace: the EDT by its row pass (once a
# call), the flash forward by its bf16 kernel
TRACE_KERNELS = {"edt_minplus": "edt_row_kernel",
                 "flash_fwd": "flash_fwd_bf16_kernel"}

# GET /metrics' series, as the JAX daemon prints them
# (ddti_tpu/cli/serve.py:_metrics)
METRICS_JAX = (
    "ddti_requests_total", "ddti_request_errors_total", "ddti_images_total",
    "ddti_batches_total", "ddti_rejected_total", "ddti_reloads_total",
    "ddti_queue_depth", "ddti_uptime_seconds",
    "ddti_request_latency_seconds_sum", "ddti_request_latency_seconds_count",
    "ddti_request_latency_seconds", "ddti_program_batches_total")


def phase(name, msg):
    print(f"[{name}] {msg}", flush=True)


class Clock:
    """Marks of main's wall time, each with the most device memory in use
    (every process on the card, as nvidia-smi reads it every
    CLOCK_SAMPLE_MS; no CUDA call of this process, so that no capture
    sees one) since the last mark."""

    def __init__(self):
        self.t0 = self.t_mark = time.perf_counter()
        self.peak_mib, self.rows = 0, []
        self._smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=memory.used",
             "--format=csv,noheader,nounits", "-lms", str(CLOCK_SAMPLE_MS)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        atexit.register(self.stop)  # a failed check stops the sampler too

        def sample():
            for line in self._smi.stdout:
                if line.strip().isdigit():
                    self.peak_mib = max(self.peak_mib, int(line))

        self._thread = threading.Thread(target=sample, daemon=True)
        self._thread.start()

    def mark(self, name):
        now = time.perf_counter()
        row = dict(name=name, at_s=now - self.t0, took_s=now - self.t_mark,
                   peak_gib=self.peak_mib / 1024)
        self.rows.append(row)
        self.peak_mib, self.t_mark = 0, now
        phase("clock", f"{name}: {row['took_s']:.1f} s, done at "
              f"{row['at_s']:.1f} s; device memory in use at most "
              f"{row['peak_gib']:.2f} GiB")

    def stop(self):
        if self._smi.poll() is None:
            self._smi.terminate()
        self._smi.wait()
        self._thread.join()


def median_ms(fn, runs=20, warmup=3):
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def work_counts(kernel, shape, dtype="bfloat16", shared_index=False):
    """What one call of ``kernel`` must do at ``shape``, counted from the
    shape alone: ``flop`` (a multiply-add is two), ``bytes`` (each input
    read once, each output written once) and ``exp2`` evaluations.

    Flash kernels take (B, H, S, D) and move (B, H, S, D) tensors of
    ``dtype`` and (B, H, S) float32 rows (lse2, delta); each (S, S, D)
    product is 2 B H S^2 D FLOP and each pass over the scores B H S^2
    exp2. ``flash_bwd`` is the pair (q, k, v, o, dO, lse2 -> dq, dk, dv:
    five products, P recomputed once by each kernel); ``flash_bwd_dkdv``
    (with the delta pre-pass: -> dk, dv, delta; S^T, dP^T, dV, dK) and
    ``flash_bwd_dq`` (q, k, v, dO, lse2, delta -> dq; S, dP, dQ) are its
    two kernels; ``flash_fwd_mskip`` does the forward's work (the rescale it
    skips is not counted in either). ``edt`` takes (N, H, W): uint8 in,
    float32 out, and ``flop`` counts the lower envelope's integer
    operations, 26 a pixel at the INT32 rate: 10 in the column pass (a
    zero's bit, the shift to the row, its lowest set bit, the two distances
    and two minima) and 16 in the row pass (the band scan's test of a new
    site against the stack's top two: two separator numerators and their
    cross products; the walk's two parabola values and their compare, and
    the clamp); the min-plus algorithm's add and min per (row, column,
    column) that the TPU kernel and the port's first EDT did is
    ``minplus_flop``. ``exp2_probe`` takes (rows, cols) float32 in and
    out, one exp2 an element and no FLOP that the bound counts. ``conv3x3``
    (benchmarks/pallas_conv_probe.py) takes (N, H, W, C, CO), the input
    counted padded by one pixel as the TPU probe pads it (csrc/conv3x3.cu
    reads it unpadded, slightly fewer bytes) and the output in bf16;
    ``gather`` (benchmarks/gather_probe*.py) (N, H, W, element bytes), src
    read and out written once, and one int32 index an element gathered, or
    with ``shared_index`` one (H, W) index plane read once for all N
    images (builders A, B, C and B2)."""
    if kernel == "edt":
        n, h, w = shape
        return dict(flop=EDT_OPS_PER_PIXEL * n * h * w,
                    bytes=n * h * w * (1 + 4), exp2=0,
                    minplus_flop=2 * n * h * w * w)
    if kernel == "exp2_probe":
        n = shape[0] * shape[1]
        return dict(flop=0, bytes=2 * 4 * n, exp2=n)
    if kernel == "conv3x3":
        n, h, w, c, co = shape
        return dict(flop=2 * n * h * w * 9 * c * co, exp2=0, bytes=2 * (
            n * (h + 2) * (w + 2) * c + n * h * w * co + 9 * c * co + co))
    if kernel == "gather":
        n, h, w, elem = shape
        index = h * w * 4 * (1 if shared_index else n)
        return dict(flop=0, bytes=n * h * w * 2 * elem + index, exp2=0)
    b, h, s, d = shape
    tensor = b * h * s * d * (2 if dtype == "bfloat16" else 4)
    rows = b * h * s * 4
    # products, tensors read + written, float32 rows read + written, exp2
    # passes
    products, tensors, nrows, passes = {
        "flash_fwd": (2, 4, 1, 1),
        "flash_fwd_mskip": (2, 4, 1, 1),
        "flash_bwd": (5, 8, 1, 2),
        "flash_bwd_dkdv": (4, 7, 2, 1),
        "flash_bwd_dq": (3, 5, 2, 1),
    }[kernel]
    return dict(flop=products * 2 * b * h * s * s * d,
                bytes=tensors * tensor + nrows * rows,
                exp2=passes * b * h * s * s)


def bound(kernel, shape, dtype="bfloat16", shared_index=False):
    """The least time the card could take for ``work_counts``: the larger
    of operations over the peak for their type (bf16 on the tensor cores,
    float32 flash products as 3xTF32 on them; the EDT's integer operations
    on the INT32 lanes) and bytes over the memory rate. Returns (bound_ms,
    bound_by, exp2_ms), exp2_ms the time the exp2 unit alone needs."""
    w = work_counts(kernel, shape, dtype, shared_index)
    peak = INT32_OPS_PER_S if kernel == "edt" else PEAK_FLOPS[
        "float32" if kernel in ("exp2_probe", "gather")
        else "tf32x3" if dtype == "float32" else dtype]
    ops_ms, bytes_ms = w["flop"] / peak * 1e3, w["bytes"] / PEAK_BYTES * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes",
            w["exp2"] / EX2_PER_S * 1e3)


def kernel_constants(source, *names):
    """The integer constants ``names`` as ddti_tpu_torch/csrc/``source``
    defines them (``kName = 16``), read from the source, so that the models
    below take the kernel's own tiling. Raises where one is missing."""
    import re

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "ddti_tpu_torch", "csrc", source)
    with open(path) as f:
        text = f.read()
    found = {}
    for name in names:
        m = re.search(rf"\b{name}\s*=\s*(\d+)\s*[,;]", text)
        if not m:
            raise ValueError(f"{source} defines no constant {name}")
        found[name] = int(m.group(1))
    return found


# the conv3x3 kernel that csrc/conv3x3.cu replaced (mma.sync): tiles of 128
# flattened pixels x 128 channels
OLD_CONV_TILE = (128, 128)
L2_SECTOR = 32  # bytes


def conv_l2_bytes(n, h, w, c, co):
    """Bytes one conv3x3 call moves from L2 into the SMs, counted from the
    schedule, as {"old", "new"}: the mma.sync design (per 128-pixel x
    128-channel tile, 9 C x 128 pixels of x and 9 C x 128 channels of
    weights) and csrc/conv3x3.cu's (per kBH x kBW pixel tile and kBN
    channels, three x boxes of (kBH + 2) x kBW pixels a channel box, one
    for each dx, and all 9 C x kBN weights)."""
    k = kernel_constants("conv3x3.cu", "kBH", "kBW", "kBN")
    bh, bw, bn = k["kBH"], k["kBW"], k["kBN"]
    om, on = OLD_CONV_TILE
    old = -(-(n * h * w) // om) * -(-co // on) * 9 * c * (om + on) * 2
    tiles = n * -(-h // bh) * -(-w // bw) * -(-co // bn)
    return dict(old=old, new=tiles * (3 * c * (bh + 2) * bw + 9 * c * bn) * 2)


def _sectors(offsets):
    """Distinct L2 sectors a warp's 4-byte loads touch, summed over warps:
    ``offsets`` (loads, 32 lanes) of float offsets, -1 for none."""
    import numpy as np

    sec = np.where(offsets >= 0, offsets * 4 // L2_SECTOR, -1)
    sec = np.sort(sec, axis=1)
    new = np.concatenate([sec[:, :1] >= 0, (sec[:, 1:] != sec[:, :-1])
                          & (sec[:, 1:] >= 0)], axis=1)
    return int(new.sum())


def _gather_offsets(idx, r, c, mode):
    """(offsets into an image, -1 out of range; in range) of a shared (R',
    C') index plane."""
    import numpy as np

    i = np.asarray(idx, np.int64)
    length = r * c if mode == "flat" else (r, c)[mode]
    k = np.where(i < 0, i + length, i)
    inr = (k >= 0) & (k < length)
    if mode == "flat":
        off = k
    elif mode == 0:
        off = k * c + np.arange(i.shape[1])
    else:
        off = np.arange(i.shape[0])[:, None] * c + k
    return np.where(inr, off, -1), inr


def gather_l2_bytes(idx, n, r, c, mode, sms):
    """Source bytes one gather call moves from L2 into the SMs, for a shared
    index plane, as {"old", "new"}: the per-element kernel that served every
    mode before the windows (a thread's four neighbouring elements, a warp's
    128 along the flattened plane, one load instruction per element of four)
    and csrc/gather_probe.cu's (a staged tile's window per image, a direct
    tile's warps of 32 columns of one row), both counted as the 32-byte
    sectors a warp's loads touch with no reuse in L1; plus the index plane,
    read once per chunk in the old design and once per block in the new.
    The column mode and calls of fewer tiles than ``sms`` keep the
    per-element path. An upper bound on what L1 lets through."""
    import numpy as np

    from ddti_tpu_torch.probes import gather_probe as G

    off, _ = _gather_offsets(idx, r, c, mode)
    ir, ic = off.shape
    m = off.size
    flat = np.full(-(-m // 128) * 128, -1, np.int64)
    flat[:m] = off.reshape(-1)
    # old: warp w, instruction e, lane l reads element 128 w + 4 l + e
    old = _sectors(flat.reshape(-1, 32, 4).transpose(0, 2, 1).reshape(-1, 32))
    old = old * L2_SECTOR * n + m * 4
    tiles = -(-ir // G.TILE) * -(-ic // G.TILE)
    if mode == 1 or tiles * n < sms:  # the per-element path, as before
        return dict(old=old, new=old)
    plan = G.plan_windows(idx, r, c, mode, n=n, sms=sms)
    tiled = G._tile_view(off[None], -1)[0]
    new = 0
    for tr, tc in zip(*np.nonzero(~plan["staged"][0])):
        new += _sectors(tiled[tr, :, tc, :].reshape(-1, 32)) * L2_SECTOR
    new = (new + int(plan["bytes"][0][plan["staged"][0]].sum())) * n
    return dict(old=old, new=new + m * 4)


def gather_bank_wavefronts(idx, r, c, mode, pad=0):
    """Shared-memory wavefronts a warp's load from a staged window takes,
    averaged over the staged tiles of a shared (R', C') index plane: a warp
    reads 32 neighbouring columns of one output row of a tile, at (source
    row - rlo) x stride + source column - clo with a window-row stride of
    cols + ``pad`` floats; each distinct word in one of the 32 banks is one
    wavefront, the busiest bank's count the load's. 1.0 is conflict-free;
    None where no tile stages."""
    import numpy as np

    from ddti_tpu_torch.probes import gather_probe as G

    plan = G.plan_windows(idx, r, c, mode, n=1, sms=1)
    off, inr = _gather_offsets(idx, r, c, mode)
    rows, cols = off // c, off % c  # flat and row mode alike
    t = G.TILE
    fronts = []
    for tr, tc in zip(*np.nonzero(plan["staged"][0])):
        win = (slice(tr * t, (tr + 1) * t), slice(tc * t, (tc + 1) * t))
        stride = plan["cols"][0, tr, tc] + pad
        at = ((rows[win] - plan["rlo"][0, tr, tc]) * stride + cols[win]
              - plan["clo"][0, tr, tc])
        tile = np.full((t, t), -1, np.int64)  # a ragged edge tile padded
        tile[:at.shape[0], :at.shape[1]] = np.where(inr[win], at, -1)
        for load in tile.reshape(-1, 32):
            words = np.unique(load[load >= 0])
            if words.size:
                fronts.append(np.bincount(words % 32, minlength=32).max())
    return float(np.mean(fronts)) if fronts else None


def sdpa_yardstick(q, k, v, do=None):
    """The fastest backend of torch's scaled_dot_product_attention on these
    (B, H, S, D) inputs: the forward, or with ``do`` the backward alone
    (torch.autograd.grad of one forward, its graph retained). Returns (ms,
    backend name, queued ms), the fastest by ``median_ms`` and its
    ``queued_ms`` device time, or (None, None, None) where no backend takes
    the inputs. A yardstick only: the port never calls it."""
    import warnings

    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel

    sdpa = torch.nn.functional.scaled_dot_product_attention
    best = (None, None, None)
    for name in SDPA_BACKENDS:
        try:
            with warnings.catch_warnings(), \
                    sdpa_kernel(getattr(SDPBackend, name)):
                warnings.simplefilter("ignore")
                if do is None:
                    def fn():
                        sdpa(q, k, v)
                else:
                    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                    o = sdpa(*leaves)

                    def fn():
                        torch.autograd.grad(o, leaves, do, retain_graph=True)
                ms = median_ms(fn)
                if best[0] is None or ms < best[0]:
                    best = (ms, name, queued_ms(fn)[1])
                del fn
        except (RuntimeError, NotImplementedError, ValueError):
            continue  # the backend does not take these inputs
    return best


def queued_ms(fn, calls=HOST_CALLS):
    """(host_ms, device_ms) per call of ``fn``: the host clock over
    ``calls`` calls enqueued back to back with no synchronisation inside,
    and CUDA events around the same calls, which wait behind a device-side
    sleep until all are enqueued, so that no launch waits for the host.
    ``median_ms`` of one call also counts the host's latency up to the
    first launch, which is most of it for a kernel of 0.1 ms."""
    import torch

    for scale in SLEEP_SCALES:
        torch.cuda.synchronize()
        slept = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        slept.record()
        torch.cuda._sleep(SLEEP_CYCLES * scale)
        start.record()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        end.synchronize()
        if host_ms < slept.elapsed_time(start):
            return host_ms / calls, start.elapsed_time(end) / calls
    raise AssertionError("the device-side sleep ended before the calls were "
                         "enqueued")


def launch_ms(fn, calls=HOST_CALLS):
    """Device time per call of each kernel entry point that ``fn`` reaches
    through ``_build.launch`` (one entry point may launch more than one
    kernel): CUDA events recorded on the current stream, which the wrappers
    launch on, just before and just after each entry point, over ``calls``
    calls queued behind a device-side sleep. Needs no profiler. Returns
    {entry point: ms per call}."""
    import torch

    from ddti_tpu_torch.ops import _build

    fn()
    torch.cuda.synchronize()
    launch, marks = _build.launch, []

    def timed(name, *args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch(name, *args)
        end.record()
        marks.append((name, start, end))

    _build.launch = timed
    try:
        for scale in SLEEP_SCALES:
            marks.clear()
            slept = torch.cuda.Event(enable_timing=True)
            woke = torch.cuda.Event(enable_timing=True)
            slept.record()
            torch.cuda._sleep(SLEEP_CYCLES * scale)
            woke.record()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            host_ms = (time.perf_counter() - t0) * 1e3
            torch.cuda.synchronize()
            if host_ms < slept.elapsed_time(woke):
                break
        else:
            raise AssertionError("the device-side sleep ended before the "
                                 "calls were enqueued")
    finally:
        _build.launch = launch
    assert marks, "no kernel entry point was called"
    ms = {}
    for name, start, end in marks:
        ms[name] = ms.get(name, 0.0) + start.elapsed_time(end) / calls
    return ms


def profiled_ms(fn, keys, calls=BWD_PROFILE_CALLS, tries=3):
    """Device time per call of ``fn`` from torch.profiler, summed over the
    kernels whose names hold each of ``keys`` (a dict: label -> tuple of
    name fragments); None for a label whose kernels the profiler recorded in
    none of ``tries`` windows (it has dropped every event of a kernel in
    some runs)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    split = dict.fromkeys(keys)
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        # each kernel runs once a call: its mean over the launches the
        # profiler recorded, which stays right where it drops some of them
        got = dict.fromkeys(keys, 0.0)
        for e in prof.key_averages():
            if e.device_type != torch.autograd.DeviceType.CUDA or not e.count:
                continue
            for label, frags in keys.items():
                if any(f in e.key for f in frags):
                    got[label] += e.self_device_time_total / e.count / 1e3
                    break
        for label, ms in got.items():
            if split[label] is None and ms:
                split[label] = ms
        if all(split.values()):
            break
    return split


def _bound_text(kernel, shape, dtype, ms):
    bound_ms, by, exp2_ms = bound(kernel, shape, dtype)
    return (f"bound {bound_ms:.4f} ms ({by}; {bound_ms / ms:.1%} of it "
            f"reached), exp2 floor {exp2_ms:.4f} ms")


def kernel_report(lib, quiet=False):
    """Each kernel's registers and spills from the build's ptxas report,
    and the SASS opcodes that show how it runs (cuobjdump -sass): HGMMA
    (wgmma), UTMALDG (TMA loads), SYNCS (mbarriers), HMMA (mma.sync),
    atomics, and the exp2 unit's MUFU.EX2 beside FRND and F2I (which issue
    at its rate). The bf16 flash kernels (the forward, dK/dV and dQ) and the
    float32 ones (the forward but its FMA loop for heads above 128, dK/dV
    and dQ) must run on wgmma and TMA loads, and no flash kernel may use an
    atomic. Prints a line a kernel (none where ``quiet``) and every line in
    which ptxas reports a performance loss. Returns ({kernel: registers,
    spills}, {kernel: opcode counts}); the m-skip forward is named
    ``flash_fwd_bf16_kernel<DP,mskip>``."""
    import re
    import shutil

    def short(name):
        m = re.search(r"\dgather_kernelILi(\d)ELb([01])ELb([01])E", name)
        if m:  # <mode, 16-byte, shared index>
            return f"gather_kernel<{m.group(1)},{m.group(2)},{m.group(3)}>"
        m = re.search(r"\dedt_column_kernelILi(\d+)E([jm])", name)
        if m:  # <columns a lane, bits a word>
            return (f"edt_column_kernel<{m.group(1)},"
                    f"{32 if m.group(2) == 'j' else 64}>")
        m = re.search(r"\dtiled_gather_kernelILi(\d)ELb([01])E", name)
        if m:  # <mode, shared index>
            return f"tiled_gather_kernel<{m.group(1)},{m.group(2)}>"
        m = re.search(r"\d((?:flash|edt|exp2|conv3x3)_\w+?_kernel)"
                      r"(?:ILi(\d+)E(Lb1E)?|I(\w)|E)", name)
        if not m:
            return name
        arg = m.group(2) or m.group(4)
        arg = f"{arg},mskip" if m.group(3) else arg
        return f"{m.group(1)}<{arg}>" if arg else m.group(1)

    regs, cur = {}, None
    with open(os.path.splitext(lib)[0] + ".log") as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = short(m.group(1))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and cur:
                regs.setdefault(cur, {})["spill"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and cur:
                regs.setdefault(cur, {})["regs"] = int(m.group(1))
            if "Performance Loss" in line:
                phase("build", f"ptxas: {line.strip()[:200]}")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    ops = {}
    for chunk in sass.split("Function : ")[1:]:
        name = short(chunk.split(None, 1)[0])
        ops[name] = {op: len(re.findall(pat, chunk)) for op, pat in (
            ("HGMMA", r"\bHGMMA\."), ("UTMALDG", r"\bUTMALDG"),
            ("SYNCS", r"\bSYNCS\."), ("HMMA", r"\bHMMA\."),
            ("atomic", r"\b(?:ATOM|ATOMG|ATOMS|RED)\b"),
            ("MUFU.EX2", r"\bMUFU\.EX2\b"), ("FRND", r"\bFRND\b"),
            ("F2I", r"\bF2I\b"))}
    for name in [] if quiet else sorted(set(regs) | set(ops)):
        r, o = regs.get(name, {}), ops.get(name, {})
        phase("build", f"{name}: {r.get('regs')} registers, "
              f"{r.get('spill')} bytes spilled; SASS "
              + " ".join(f"{k} {v}" for k, v in o.items()))
    for name, o in ops.items():
        if name.startswith("flash_"):
            assert o["atomic"] == 0, f"{name} uses atomics"
        if name.startswith(("flash_fwd_bf16", "flash_fwd_f32",
                            "flash_bwd_dkdv_bf16", "flash_bwd_dq_bf16",
                            "flash_bwd_dkdv_f32", "flash_bwd_dq_f32")) \
                and name != "flash_fwd_f32_fma_kernel<256>":
            assert o["HGMMA"] and o["UTMALDG"] and o["SYNCS"], \
                f"{name} issues no wgmma or TMA load"
        if name.startswith("conv3x3_relu_kernel"):
            assert o["HGMMA"] and o["UTMALDG"] and o["SYNCS"] \
                and o["HMMA"] == 0, \
                f"{name} does not run on wgmma and TMA alone: {o}"
    assert sum(n.startswith("conv3x3_relu_kernel") for n in ops) == 2, \
        "the conv3x3 kernel's two instances (boxes of 32 and 64 channels)"
    return regs, ops


def check_poly_build(path, default_ops):
    """The DDTI_POLY_EXP2=1 library at ``path`` against the default one's
    opcode counts. Its poly paths are the flash kernels whose default build
    runs MUFU.EX2 and exp2_probe's poly modes: none of them may issue
    MUFU.EX2, nor FRND or F2I (which run at the exp2 unit's rate) beyond
    what the default kernel (for the probe, its copy mode) issues without
    the polynomial."""
    regs, ops = kernel_report(path, quiet=True)
    keys = ("MUFU.EX2", "FRND", "F2I")
    base = {n: default_ops[n] for n in ops if n.startswith("flash_")
            and default_ops[n]["MUFU.EX2"]}
    base.update({f"exp2_probe_kernel<{m}>": default_ops["exp2_probe_kernel<0>"]
                 for m in (4, 5, 6)})
    for name, d in sorted(base.items()):
        o, r = ops[name], regs.get(name, {})
        phase("build", f"poly {name}: {r.get('regs')} registers, "
              f"{r.get('spill')} bytes spilled; " + " ".join(
                  f"{k} {o[k]} (without the polynomial {d[k]})"
                  for k in keys))
    assert len(base) > 3 and all(ops[n]["MUFU.EX2"] == 0 for n in base), \
        "a poly path issues MUFU.EX2"
    assert all(ops[n][k] <= d[k] for n, d in base.items()
               for k in ("FRND", "F2I")), "a poly path issues FRND or F2I"
    assert default_ops["exp2_probe_kernel<1>"]["MUFU.EX2"], \
        "exp2_probe's builtin mode does not run on the exp2 unit"


def check_kernels():
    import torch

    from ddti_tpu_torch.ops import attention as A

    rows = []
    for b, h, s, d, dt in KERNEL_SHAPES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v = (torch.randn((b, h, s, d), generator=g, device="cuda")
                   .to(dtype) for _ in range(3))
        o, lse = A.flash_forward_cuda(q, k, v)
        torch.cuda.synchronize()
        o_ref, lse_ref = A.flash_forward_reference(q, k, v)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        finite = bool(torch.isfinite(o.float()).all()
                      and torch.isfinite(lse).all())
        twice_equal = all(torch.equal(a, w) for a, w in zip(
            (o, lse), A.flash_forward_cuda(q, k, v)))
        ms = median_ms(lambda: A.flash_forward_cuda(q, k, v))
        host_ms, queue_ms = queued_ms(lambda: A.flash_forward_cuda(q, k, v))
        # float32 at D <= 128: the TF32 split pre-pass, its own entry point
        # (none in trees before the float32 forward ran on the tensor cores)
        split = launch_ms(lambda: A.flash_forward_cuda(q, k, v))
        device_ms = sum(split.values())
        prep_ms = split.get("flash_fwd_split_f32")
        plain_ms = median_ms(lambda: A.flash_forward_reference(q, k, v))
        lib_ms, lib, lib_queue_ms = sdpa_yardstick(q, k, v)
        shape = (b, h, s, d)
        bound_ms, bound_by, exp2_ms = bound("flash_fwd", shape, dt)
        phase("kernels", f"flash_fwd {shape} {dt}: max|do| {err_o:.3e} "
              f"(limit {O_LIMIT[dt]:g}) max|dlse2| {err_lse:.3e} (limit "
              f"{LSE_LIMIT:g}), two calls bit-equal {twice_equal}; kernel "
              f"{ms:.4f} ms (queued {queue_ms:.4f}, events at the launch "
              f"{device_ms:.4f}"
              + (f" of which the split pre-pass {prep_ms:.4f}" if prep_ms
                 else "")
              + f"; host enqueue {host_ms:.4f}) plain "
              f"{plain_ms:.4f} ms; SDPA forward {lib_ms} ms (queued "
              f"{lib_queue_ms}; {lib}); "
              + _bound_text("flash_fwd", shape, dt, device_ms))
        assert twice_equal, "two calls of the forward differ"
        assert finite, "non-finite kernel output"
        assert err_o <= O_LIMIT[dt] and err_lse <= LSE_LIMIT, \
            "kernel disagrees with its plain version"
        rows.append(dict(shape=[b, h, s, d], dtype=dt, max_abs_err=err_o,
                         max_abs_err_lse2=err_lse, ms=ms, queue_ms=queue_ms,
                         device_ms=device_ms, prepass_ms=prep_ms,
                         host_ms=host_ms,
                         plain_ms=plain_ms, library_ms=lib_ms, library=lib,
                         library_queue_ms=lib_queue_ms, bound_ms=bound_ms,
                         bound_by=bound_by, exp2_ms=exp2_ms))
    return rows


def check_bwd_kernels():
    """csrc/flash_bwd.cu against flash_backward_reference on the forward
    kernel's o and lse2: dq, dk, dv against G_LIMIT and two calls
    bit-equal; the whole backward's time (one call between CUDA events, and
    queued) beside the plain one's and SDPA's backward, each entry point's
    device time from CUDA events around its launch (the pre-pass counted
    with dK/dV, as one entry point launches both), the pre-pass's own from
    torch.profiler where it recorded it, the wrapper's host enqueue
    time."""
    import torch

    from ddti_tpu_torch.ops import attention as A

    rows = []
    for b, h, s, d, dt in BWD_SHAPES:
        dtype = getattr(torch, dt)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v, do = (torch.randn((b, h, s, d), generator=g, device="cuda")
                       .to(dtype) for _ in range(4))
        o, lse = A.flash_forward_cuda(q, k, v)
        args = (q, k, v, o, lse, do)
        got = A.flash_backward_cuda(*args)
        again = A.flash_backward_cuda(*args)
        torch.cuda.synchronize()
        want = A.flash_backward_reference(*args)
        abs_err, rel_err = {}, {}
        for name, a, w in zip(("dq", "dk", "dv"), got, want):
            assert torch.isfinite(a.float()).all(), f"non-finite {name}"
            abs_err[name] = (a.float() - w.float()).abs().max().item()
            rel_err[name] = abs_err[name] / max(
                w.float().abs().max().item(), 1e-30)
        twice_equal = all(torch.equal(a, w) for a, w in zip(got, again))
        del got, again, want
        ms = median_ms(lambda: A.flash_backward_cuda(*args))
        host_ms, queue_ms = queued_ms(lambda: A.flash_backward_cuda(*args))
        plain_ms = median_ms(lambda: A.flash_backward_reference(*args))
        lib_ms, lib, lib_queue_ms = sdpa_yardstick(q, k, v, do)
        split = launch_ms(lambda: A.flash_backward_cuda(*args))
        split = dict(dkdv=split["flash_bwd_dkdv"], dq=split["flash_bwd_dq"])
        # the pre-pass alone; flash_bwd_delta in trees before the float32
        # kernels ran on the tensor cores (for --ab)
        prep_ms = profiled_ms(lambda: A.flash_backward_cuda(*args), {
            "rows": ("flash_bwd_rows", "flash_bwd_delta")})["rows"]
        prep_text = ("not recorded" if prep_ms is None
                     else f"{prep_ms:.4f}")
        shape = (b, h, s, d)
        bounds = {n: bound(n, shape, dt) for n in
                  ("flash_bwd", "flash_bwd_dkdv", "flash_bwd_dq")}
        phase("kernels", f"flash_bwd {shape} {dt}: max|d|/max|g| "
              + " ".join(f"{n} {e:.3e}" for n, e in rel_err.items())
              + f" (limit {G_LIMIT[dt]:g}); two calls bit-equal "
              f"{twice_equal}; kernels {ms:.4f} ms (queued {queue_ms:.4f}; "
              f"events at the launch: pre-pass + dK/dV {split['dkdv']:.4f} "
              f"(profiler: pre-pass {prep_text}), dQ "
              f"{split['dq']:.4f}; host enqueue {host_ms:.4f}) plain "
              f"{plain_ms:.4f} ms; SDPA backward {lib_ms} ms (queued "
              f"{lib_queue_ms}; {lib}); pair "
              + _bound_text("flash_bwd", shape, dt,
                            split["dkdv"] + split["dq"])
              + "; dK/dV " + _bound_text("flash_bwd_dkdv", shape, dt,
                                         split["dkdv"])
              + "; dQ " + _bound_text("flash_bwd_dq", shape, dt, split["dq"]))
        assert max(rel_err.values()) <= G_LIMIT[dt], \
            "a backward kernel disagrees with its plain version"
        assert twice_equal, "two calls of the backward differ"
        rows.append(dict(
            shape=[b, h, s, d], dtype=dt, abs_err=abs_err, rel_err=rel_err,
            ms=ms, queue_ms=queue_ms, host_ms=host_ms, ms_dkdv=split["dkdv"],
            ms_prepass=prep_ms,
            ms_dq=split["dq"], plain_ms=plain_ms, library_ms=lib_ms,
            library=lib, library_queue_ms=lib_queue_ms,
            bound_ms=bounds["flash_bwd"][0], bound_by=bounds["flash_bwd"][1],
            exp2_ms=bounds["flash_bwd"][2],
            bound_ms_dkdv=bounds["flash_bwd_dkdv"][0],
            bound_ms_dq=bounds["flash_bwd_dq"][0]))
    return rows


def decide(fwd_rows, bwd_rows):
    """The ratios that order the kernels' redesigns, at the slice's shape
    (16, 8, 1024, 32) bf16: r_fwd = forward ms / fastest SDPA forward and
    r_bwd = backward pair ms / fastest SDPA backward, from one call between
    CUDA events each (``median_ms``, which counts the host's latency too),
    and the same ratios of the queued device times (``queued_ms``). A
    kernel slower than the library call comes first, the larger factor
    first, by device time. Returns the four ratios by name."""
    f, b = fwd_rows[0], bwd_rows[0]
    r = dict(r_fwd=f["ms"] / f["library_ms"],
             r_bwd=b["ms"] / b["library_ms"],
             r_fwd_queued=f["queue_ms"] / f["library_queue_ms"],
             r_bwd_queued=b["queue_ms"] / b["library_queue_ms"])
    slower = sorted(((q, n) for q, n in (
        (r["r_fwd_queued"], "the forward"),
        (r["r_bwd_queued"], "the backward pair")) if q > 1), reverse=True)
    phase("kernels", f"r_fwd {r['r_fwd']:.3f} (flash_fwd {f['ms']:.4f} / "
          f"SDPA {f['library_ms']:.4f} ms, {f['library']}), r_bwd "
          f"{r['r_bwd']:.3f} (pair {b['ms']:.4f} / SDPA "
          f"{b['library_ms']:.4f} ms, {b['library']}); queued: r_fwd "
          f"{r['r_fwd_queued']:.3f}, r_bwd {r['r_bwd_queued']:.3f}; slower "
          "than SDPA by device time: "
          + (", ".join(n for _, n in slower) or "neither"))
    return r


def kernel_phases():
    """Phase 3's flash rows: the forward, the backward and the ratios that
    order their redesigns. Returns (forward rows, backward rows, ratios)."""
    rows = check_kernels()
    bwd_rows = check_bwd_kernels()
    return rows, bwd_rows, decide(rows, bwd_rows)


def check_probes():
    """Phase 4: the probes of benchmarks/ as the port runs them. Returns
    what the kernels line reports of exp2_probe, the m-skip forward and the
    poly build."""
    import torch

    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.probes import exp2_probe as E2
    from ddti_tpu_torch.probes import flash_mskip_ab as MS
    from ddti_tpu_torch.probes import flash_poly_ab as PA

    phase("probes", f"exp2_probe {(E2.ROWS, E2.COLS)} float32 uniform on "
          f"[{E2.LOW}, {E2.HIGH}), seed {SEED} (the CPU's max rel err: "
          "poly4 5.6e-5, poly5 3.3e-6, poly6 2.2e-7):")
    e2 = E2.run(seed=SEED)
    x = E2.make_input(E2.ROWS, E2.COLS, SEED, "cuda")
    e2["plain_ms"] = median_ms(lambda: E2.exp2_probe_reference(x, "poly6"))
    edges = torch.tensor(EXP2_EDGES, device="cuda")
    edge_ulps = {}
    for mode in E2.MODES:
        got = E2.exp2_probe_cuda(edges, mode)
        want = E2.exp2_probe_reference(edges, mode)
        assert not torch.isnan(got).any(), f"exp2_probe {mode}: NaN"
        edge_ulps[mode] = E2.ulp_distance(got, want)
        if mode == "copy":
            assert torch.equal(got.view(torch.int32), edges.view(torch.int32))
    e2["edge_ulps"] = edge_ulps
    ulps = {m: r["ulps_vs_plain"] for m, r in e2["modes"].items()}
    phase("probes", f"exp2_probe vs plain, ulps on the probe's input {ulps}, "
          f"on {len(EXP2_EDGES)} edge values {edge_ulps} (limit "
          f"{EXP2_ULPS}; copy bit for bit); plain poly6 "
          f"{e2['plain_ms']:.4f} ms")
    assert ulps["copy"] == 0 and edge_ulps["copy"] == 0
    assert max(ulps.values()) <= EXP2_ULPS \
        and max(edge_ulps.values()) <= EXP2_ULPS, \
        "exp2_probe disagrees with its plain version"

    phase("probes", "flash_mskip_ab (B, H, S, D) = "
          f"{(MS.B, MS.H, MS.S, MS.D)} bfloat16, seed {SEED}:")
    ms = MS.run(seed=SEED)
    assert ms["bit_equal"], "the m-skip forward differs from the baseline"
    rows = []
    for shape in MSKIP_SHAPES:
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v = (torch.randn(shape, generator=g, device="cuda")
                   .to(torch.bfloat16) for _ in range(3))
        o, lse = MS.flash_forward_mskip_cuda(q, k, v)
        o0, lse0 = A.flash_forward_cuda(q, k, v)
        torch.cuda.synchronize()
        o_ref, lse_ref = MS.flash_forward_mskip_reference(q, k, v)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        bit = torch.equal(o, o0) and torch.equal(lse, lse0)
        row = dict(shape=list(shape), bit_equal_to_flash_fwd=bit,
                   max_abs_err=err_o, max_abs_err_lse2=err_lse)
        row["stale_share"] = MS.flash_forward_mskip_reference.stale_share
        if shape == MSKIP_SHAPES[0]:
            row["plain_ms"] = median_ms(
                lambda: MS.flash_forward_mskip_reference(q, k, v))
            lib_ms, lib, lib_queue_ms = sdpa_yardstick(q, k, v)
            row.update(library_ms=lib_ms, library=lib,
                       library_queue_ms=lib_queue_ms)
        phase("probes", f"flash_fwd_mskip {shape} bfloat16: bit-equal to "
              f"flash_fwd (o, lse2) {bit}; vs its plain version max|do| "
              f"{err_o:.3e} (limit {O_LIMIT['bfloat16']:g}) max|dlse2| "
              f"{err_lse:.3e} (limit {LSE_LIMIT:g}); the plain version took "
              f"the stale branch on {row['stale_share']:.1%} of (16-row "
              f"group, 64-key tile) pairs"
              + (f"; plain {row['plain_ms']:.4f} ms, SDPA forward "
                 f"{row['library_ms']} ms (queued "
                 f"{row['library_queue_ms']}; {row['library']})"
                 if "plain_ms" in row else ""))
        assert bit, "the m-skip forward differs from the production forward"
        assert torch.isfinite(o.float()).all() and torch.isfinite(lse).all()
        assert err_o <= O_LIMIT["bfloat16"] and err_lse <= LSE_LIMIT, \
            "the m-skip forward disagrees with its plain version"
        rows.append(row)
    ms["shapes"] = rows

    # the flash kernels built with the polynomial, in a process of their own
    res = subprocess.run([sys.executable, os.path.abspath(__file__),
                          "--poly-child"], capture_output=True, text=True,
                         env=dict(os.environ, DDTI_POLY_EXP2="1"),
                         timeout=POLY_TIMEOUT_S)
    lines = res.stdout.splitlines()
    for line in lines:
        if not line.startswith("[poly] "):
            print(line, flush=True)
    if res.returncode != 0:
        print(res.stderr[-8000:], file=sys.stderr)
    assert res.returncode == 0, "the DDTI_POLY_EXP2=1 flash checks failed"
    poly = json.loads(next(l for l in lines if l.startswith("[poly] "))[7:])

    phase("probes", f"flash_poly_ab (B, H, S, D) = {(PA.B, PA.H, PA.S, PA.D)}"
          " bfloat16, one process per setting of DDTI_POLY_EXP2:")
    ab_rows = PA.run(seed=SEED)
    assert all(r["finite"] == "True" for r in ab_rows), "non-finite output"
    return dict(exp2_probe=e2, mskip=ms, poly=poly, poly_ab=ab_rows)


def check_conv_gather():
    """Phase 4, the conv3x3 and warp-gather probes: each kernel against its
    plain version at the listed shapes (outside any launch count), then
    each probe's ``run()``, the path a user drives, with its kernel's count
    set to 0 just before and read just after; it must launch. Returns what
    the kernels line reports of both."""
    import torch

    from ddti_tpu_torch.probes import gather_probe as G
    from ddti_tpu_torch.probes import gather_probe2 as G2
    from ddti_tpu_torch.probes import gather_probe3 as G3
    from ddti_tpu_torch.probes import pallas_conv_probe as P
    from ddti_tpu_torch.probes._timing import queued_ms as device_ms

    conv_rows = []
    for shape in CONV_SHAPES + [(CONV_GROWTH[0], CONV_GROWTH[1],
                                 CONV_GROWTH[1], c, c)
                                for c in CONV_GROWTH[2]]:
        n, h, w, c, co = shape
        x, wk, b = P.make_inputs(n, max(h, w), c, co, seed=SEED, device="cuda")
        x = x[:, :h, :w].contiguous()
        wt = P.pack_weights(wk)
        y = P.conv3x3_relu_cuda(x, wt, b)
        again = P.conv3x3_relu_cuda(x, wt, b)
        torch.cuda.synchronize()
        ok, err, share = P.within_tolerance(
            y, P.conv3x3_relu_reference(x, wk, b))
        bit = torch.equal(y, again)
        conv_rows.append(dict(shape=list(shape), within=ok, max_abs_err=err,
                              differ_share=share, deterministic=bit))
        phase("probes", f"conv3x3 {shape} bf16 vs plain: max|d| {err:.3e}, "
              f"{share:.3e} of elements differ, within one bf16 ulp or "
              f"2^-8 max|y|: {ok}; two calls bit-equal {bit}")
        assert ok and bit and bool(torch.isfinite(y.float()).all()), \
            f"conv3x3 {shape} disagrees with its plain version"
        del x, wk, b, wt, y, again
    # the float32 sum's error where the bf16 output can see it: b cancels
    # a sum of 9 C positive products, an interior y is ~1 (P.cancelling_
    # inputs); within P.CANCEL_LIMIT at every C, kernel and plain
    growth = {}
    for c in CONV_GROWTH[2]:
        x, wk, b, exact = P.cancelling_inputs(CONV_GROWTH[0], CONV_GROWTH[1],
                                              c, seed=SEED, device="cuda")
        errs = [(y.float()[:, 1:-1, 1:-1] - exact.float()).abs().max().item()
                for y in (P.conv3x3_relu_cuda(x, P.pack_weights(wk), b),
                          P.conv3x3_relu_reference(x, wk, b))]
        growth[c] = dict(kernel=errs[0], plain=errs[1])
        del x, wk, b, exact
    phase("probes", f"conv3x3 error growth, |y - exact| where b cancels a "
          f"sum of 9 C positive products (y ~1, limit {P.CANCEL_LIMIT:g}; "
          f"a truncating accumulator ~0.07 at C = 512), by C: "
          + ", ".join(f"{c}: kernel {e['kernel']:.3e} plain {e['plain']:.3e}"
                      for c, e in growth.items()))
    assert max(max(e.values()) for e in growth.values()) <= P.CANCEL_LIMIT, \
        "conv3x3's float32 sum drifts with C"

    phase("probes", f"pallas_conv_probe N{P.N} {P.SPATIAL}^2 C = CO = "
          f"{P.CHANNELS} bf16, seed {SEED}:")
    P.conv3x3_relu_cuda.launches = 0
    conv = P.run(seed=SEED)
    conv_launches = P.conv3x3_relu_cuda.launches
    conv_shape = (P.N, P.SPATIAL, P.SPATIAL, P.CHANNELS, P.CHANNELS)
    b_ms, b_by, _ = bound("conv3x3", conv_shape)
    l2 = conv_l2_bytes(*conv_shape)
    phase("probes", f"conv3x3 {conv_shape}: kernel {conv['ms']:.4f} ms, "
          f"cuDNN {conv['library_ms']:.4f} ms, plain {conv['plain_ms']:.4f} "
          f"ms (queued device time); bound {b_ms:.4f} ms ({b_by}): kernel "
          f"{b_ms / conv['ms']:.1%} of it, cuDNN "
          f"{b_ms / conv['library_ms']:.1%}; {conv_launches} launches; L2 -> "
          f"SM bytes a call (conv_l2_bytes) {l2['new'] / 1e9:.3f} GB (the "
          f"mma.sync design {l2['old'] / 1e9:.3f} GB), "
          f"{l2['new'] / conv['ms'] / 1e9:.2f} TB/s")
    assert conv["within"] and conv_launches > 0

    # every mode on the builders' shapes with edge indices planted: -1 and
    # -len wrap, len and -len - 1 give NaN; bit for bit (NaN's bits too)
    edge_rows = []
    src = torch.from_numpy(G.make_src((G.N, G.H, G.W), SEED)).cuda()
    for mode, shape in (("flat", (G.H, G.W)), (0, (G.H, G.W)),
                        (1, (G.H, G.W)), (0, (2048, 128)), (1, (512, 128))):
        s = src if shape == (G.H, G.W) else \
            torch.from_numpy(G.make_src(shape, SEED)).cuda()
        r, c = s.shape[-2:]
        length = r * c if mode == "flat" else (r, c)[mode]
        g = torch.Generator(device="cuda").manual_seed(SEED)
        idx = torch.randint(0, length, shape, generator=g, device="cuda",
                            dtype=torch.int32)
        idx.view(-1)[:4] = torch.tensor([-1, -length, length, -length - 1],
                                        dtype=torch.int32)
        got = G.gather_cuda(s, idx, mode)
        want = G.gather_reference(s, idx, mode)
        torch.cuda.synchronize()
        bit = torch.equal(got.view(torch.int32), want.view(torch.int32))
        nans = int(torch.isnan(got).sum())
        edge_rows.append(dict(mode=str(mode), shape=list(s.shape),
                              bit_equal=bit, nan=nans))
        phase("probes", f"gather {tuple(s.shape)} mode {mode} with edge "
              f"indices: bit-equal to plain {bit}, {nans} NaN (want "
              f"{(s.shape[0] if s.dim() == 3 else 1) * 2})")
        assert bit and nans == (s.shape[0] if s.dim() == 3 else 1) * 2, \
            "the gather kernel differs from its plain version"

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # the staged path's edges (a window at the cap and past it, wrapping
    # and out-of-range indices inside a staged tile, per-image planes):
    # bit for bit, and the kernel's count of staged (tile, image) pairs
    # equal to plan_windows'; the case that mixes staged and direct tiles
    # timed beside torch.gather
    for name, (s_np, i_np, mode) in G.window_cases(SEED).items():
        s, i = torch.from_numpy(s_np).cuda(), torch.from_numpy(i_np).cuda()
        got, count = G.staged_count(s, i, mode)
        want = G.gather_reference(s, i, mode)
        plan = G.planned_staged(i_np, s.shape[0], *s.shape[-2:], mode,
                                sms=sms)
        bit = torch.equal(got.view(torch.int32), want.view(torch.int32))
        row = dict(mode=str(mode), case=name, shape=list(s.shape),
                   bit_equal=bit, staged=count)
        timed = ""
        if name == "flat per-image":
            index = G.torch_index(i, s.shape[0])
            row.update(ms=device_ms(lambda: G.gather_cuda(s, i, mode)),
                       library_ms=device_ms(
                           lambda: G.torch_gather(s, index, mode)))
            timed = (f"; {row['ms']:.4f} ms, torch.gather "
                     f"{row['library_ms']:.4f} ms (queued)")
        edge_rows.append(row)
        phase("probes", f"gather {name} {tuple(s.shape)} idx "
              f"{tuple(i.shape)}: bit-equal to plain {bit}, staged (tile, "
              f"image) pairs {count} (plan {plan}){timed}")
        assert bit and count == plan, \
            f"gather {name}: the staged path differs from plain or its plan"

    G.gather_cuda.launches = 0
    rows = {}
    for mod in (G, G2, G3):
        phase("probes", f"{mod.__name__.split('.')[-1]} N{G.N} "
              f"{G.H}x{G.W}, seed {SEED}:")
        rows.update(mod.run(seed=SEED))
    gather_launches = G.gather_cuda.launches
    kernel_rows = {k: r for k, r in rows.items() if "torch_call" not in r}
    assert len(kernel_rows) == 8 and all(r["match"] for r in rows.values()), \
        "a gather builder differs from the probe's want"
    assert gather_launches > 0
    # each builder through the kernel against the plain version on the card
    table = dict(G.builders())
    table.update(G2.builders()[0])
    table.update(G3.builders()[1])
    # (untimed calls: the timed ones pass no counter and carry no atomic);
    # the plan, the byte and bank models go to the phase line only
    models = {}
    for name, (s_np, i_np, mode, _) in table.items():
        s, i = torch.from_numpy(s_np).cuda(), torch.from_numpy(i_np).cuda()
        got, count = G.staged_count(s, i, mode)
        bit = torch.equal(got.view(torch.int32),
                          G.gather_reference(s, i, mode).view(torch.int32))
        n = s.shape[0] if s.dim() == 3 else 1
        key = name.strip()
        kernel_rows[key].update(bit_equal_to_plain=bit, staged=count)
        model = models[key] = dict(
            planned=G.planned_staged(i_np, n, *s.shape[-2:], mode, sms=sms),
            tiles=G.plan_windows(i_np, *s.shape[-2:],
                                 mode)["staged"].size * n)
        if i_np.ndim == 2 and s.dim() == 3:
            model["l2"] = gather_l2_bytes(i_np, n, *s.shape[-2:], mode, sms)
            model["banks"] = gather_bank_wavefronts(i_np, *s.shape[-2:],
                                                    mode)
        assert bit, f"gather builder {key} differs from plain"
        assert count == model["planned"], \
            f"gather builder {key}: staged {count}, plan says " \
            f"{model['planned']}"
    for key in ("A pallas flat take", "B pallas taa axis0",
                "B2 pallas taa ax0 promise"):
        assert kernel_rows[key]["staged"] == models[key]["tiles"], \
            f"gather builder {key}: a tile missed the staged path"
    assert kernel_rows["F  pallas dyn_gather lanes"]["staged"] == 0
    a_row = kernel_rows["A pallas flat take"]

    def models_text(m):
        text = f"staged {m['staged']} of {m['tiles']} (tile, image) pairs"
        if "l2" in m:
            text += (f"; L2 -> SM sectors {m['l2']['new'] / 1e6:.1f} MB, "
                     f"per-element {m['l2']['old'] / 1e6:.1f} MB")
        if m.get("banks"):
            text += f"; {m['banks']:.2f} shared-memory wavefronts a load"
        return text

    phase("probes", "gather builders through the kernel, bit-equal to "
          "plain (models: gather_l2_bytes, gather_bank_wavefronts): "
          + ", ".join(
              f"{k.split()[0]} {r['ms']:.4f} ms ({r['bound_ms'] / r['ms']:.1%}"
              f" of {r['bound_ms']:.5f}; torch.gather {r['library_ms']:.4f}; "
              + models_text(dict(models[k], staged=r["staged"])) + ")"
              for k, r in kernel_rows.items())
          + f"; {gather_launches} launches")
    return dict(conv=conv, conv_rows=conv_rows, conv_launches=conv_launches,
                conv_growth=growth, gather=rows, gather_edges=edge_rows,
                gather_launches=gather_launches, gather_a=a_row)


def poly_child():
    """Run as ``chip_smoke.py --poly-child`` with DDTI_POLY_EXP2=1: the
    flash forward and backward kernels of the poly build against their
    plain versions in poly mode at POLY_SHAPES (today's limits, no NaN),
    with their queued times; prints one line "[poly] {json}"."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ddti_tpu_torch.ops import _build
    from ddti_tpu_torch.ops import attention as A

    assert _build.USE_POLY_EXP2 and A.USE_POLY_EXP2, "DDTI_POLY_EXP2 unset"
    _build.load_library()
    rows = []
    for b, h, s, d, dt in POLY_SHAPES:
        shape = (b, h, s, d)
        g = torch.Generator(device="cuda").manual_seed(SEED)
        q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                       .to(getattr(torch, dt)) for _ in range(4))
        o, lse = A.flash_forward_cuda(q, k, v)
        args = (q, k, v, o, lse, do)
        got = A.flash_backward_cuda(*args)
        torch.cuda.synchronize()
        o_ref, lse_ref = A.flash_forward_reference(q, k, v)
        want = A.flash_backward_reference(*args)
        err_o = (o.float() - o_ref.float()).abs().max().item()
        err_lse = (lse - lse_ref).abs().max().item()
        rel = {n: ((a.float() - w.float()).abs().max()
                   / w.float().abs().max().clamp(min=1e-30)).item()
               for n, a, w in zip(("dq", "dk", "dv"), got, want)}
        finite = all(bool(torch.isfinite(t.float()).all())
                     for t in (o, lse, *got))
        del got, want, o_ref, lse_ref
        fwd_q = queued_ms(lambda: A.flash_forward_cuda(q, k, v))[1]
        pair_q = queued_ms(lambda: A.flash_backward_cuda(*args))[1]
        split = launch_ms(lambda: A.flash_backward_cuda(*args))
        row = dict(shape=list(shape), dtype=dt, max_abs_err=err_o,
                   max_abs_err_lse2=err_lse, rel_err=rel, finite=finite,
                   fwd_queue_ms=fwd_q, pair_queue_ms=pair_q,
                   dkdv_ms=split["flash_bwd_dkdv"],
                   dq_ms=split["flash_bwd_dq"])
        phase("probes", f"DDTI_POLY_EXP2=1 flash {shape} {dt} vs plain in "
              f"poly mode: forward max|do| {err_o:.3e} (limit "
              f"{O_LIMIT[dt]:g}) max|dlse2| {err_lse:.3e} (limit "
              f"{LSE_LIMIT:g}); backward max|d|/max|g| "
              + " ".join(f"{n} {e:.3e}" for n, e in rel.items())
              + f" (limit {G_LIMIT[dt]:g}); finite {finite}; queued: "
              f"forward {fwd_q:.4f} ms, pair {pair_q:.4f} ms (events at the "
              f"launch: pre-pass + dK/dV {row['dkdv_ms']:.4f}, dQ "
              f"{row['dq_ms']:.4f})")
        assert finite, "non-finite output of a poly flash kernel"
        assert err_o <= O_LIMIT[dt] and err_lse <= LSE_LIMIT, \
            "a poly forward disagrees with its plain version"
        assert max(rel.values()) <= G_LIMIT[dt], \
            "a poly backward kernel disagrees with its plain version"
        rows.append(row)
    print("[poly] " + json.dumps(rows), flush=True)


def random_state(model, seed):
    """Seeded random weights: He-scaled conv/linear weights, BatchNorm and
    LayerNorm affines near identity, BN statistics near (0, 1)."""
    import torch

    g = torch.Generator().manual_seed(seed)
    sd = {}
    for name, t in model.state_dict().items():
        def normal(std):
            return torch.randn(t.shape, generator=g) * std
        if name.endswith("running_var"):
            sd[name] = torch.rand(t.shape, generator=g) + 0.5
        elif name.endswith("pos_emb"):
            sd[name] = normal(1.0)
        elif t.dim() == 1:
            sd[name] = normal(0.1) + (1.0 if name.endswith("weight") else 0.)
        else:
            fan_in = t.shape[0] if name.startswith("upconvs") else t[0].numel()
            sd[name] = normal((2.0 / fan_in) ** 0.5)
    return sd


def make_frames(n, size, seed):
    """Ultrasound-like test frames: speckle over a dark field with one
    brighter ellipse each, as uint8 (size, size)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    frames = []
    for _ in range(n):
        cy, cx, ry, rx = rng.uniform([0.3, 0.3, 0.08, 0.08],
                                     [0.7, 0.7, 0.25, 0.25])
        inside = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 < 1
        img = 60 + 90 * inside + rng.normal(0, 25, (size, size))
        frames.append(np.clip(img, 0, 255).astype(np.uint8))
    return frames


def post(port, body, path="/predict?format=raw"):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=300)
    t0 = time.perf_counter()
    conn.request("POST", path, body=body)
    resp = conn.getresponse()
    data = resp.read()
    dt = time.perf_counter() - t0
    conn.close()
    return resp.status, dict(resp.getheaders()), data, dt


def get_json(port, path):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
    conn.request("GET", path)
    resp = conn.getresponse()
    body = json.loads(resp.read())
    conn.close()
    assert resp.status == 200, (path, resp.status, body)
    return body


def run_batches(model, x, dtype):
    """uint8 (N, S, S, 1) frames -> (N, S, S) masks, BATCH at a time."""
    import torch

    from ddti_tpu_torch.train.export import make_serve_fn

    serve = make_serve_fn(model, compute_dtype=dtype)
    out = torch.cat([serve(x[i:i + BATCH]) for i in range(0, len(x), BATCH)])
    return out[..., 0].cpu().numpy()


def run_slice(tmp):
    import numpy as np
    import torch
    from PIL import Image

    from ddti_tpu_torch.cli import serve
    from ddti_tpu_torch.models import blocks, create_model
    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into

    model = create_model("TransUNet", **SLICE)
    n_params = sum(p.numel() for p in model.parameters())
    ckpt = os.path.join(tmp, "transunet_bf64_d4_512.pth")
    torch.save(random_state(model, SEED), ckpt)
    phase("slice", f"TransUNet {SLICE}: {n_params} parameters, random "
          f"weights (seed {SEED}) -> {os.path.basename(ckpt)}")

    args = serve.get_parser().parse_args(
        ["--checkpoint", ckpt, "--model_type", "TransUNet",
         "--base_filters", str(SLICE["base_filters"]),
         "--depth", str(SLICE["depth"]),
         "--image_size", str(SLICE["image_size"]),
         "--batch_size", str(BATCH), "--bf16", "--device", "cuda",
         "--port", "0"])
    t0 = time.perf_counter()
    server = serve.create_server(args)
    phase("slice", f"server up in {time.perf_counter() - t0:.2f} s "
          f"(load + warm-up batch) on port {server.server_address[1]}")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        health = get_json(port, "/healthz")
        phase("slice", f"/healthz {json.dumps(health)}")
        frames = make_frames(N_FRAMES, SLICE["image_size"], SEED)
        bodies = []
        for f in frames:
            buf = io.BytesIO()
            Image.fromarray(f, "L").save(buf, "PNG")
            bodies.append(buf.getvalue())

        A.flash_forward_cuda.launches = 0
        batches0 = server.batcher.n_batches
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(N_FRAMES) as pool:
            answers = list(pool.map(lambda b: post(port, b), bodies))
        wall = time.perf_counter() - t0
        launches = A.flash_forward_cuda.launches
        n_batches = server.batcher.n_batches - batches0

        lat = sorted(a[3] * 1e3 for a in answers)
        q = {p: lat[min(len(lat) - 1, int(len(lat) * p / 100))]
             for p in (50, 90, 99)}
        phase("slice", f"{N_FRAMES} concurrent POST /predict: {n_batches} "
              f"batches, {launches} flash_fwd launches, wall {wall:.3f} s, "
              f"{N_FRAMES / wall:.2f} img/s, client latency p50 {q[50]:.1f} "
              f"p90 {q[90]:.1f} p99 {q[99]:.1f} ms")
        stats = get_json(port, "/stats")
        phase("slice", f"/stats {json.dumps(stats)}")

        # a JPEG of another size comes back as a PNG mask of that size
        buf = io.BytesIO()
        Image.fromarray(frames[0], "L").resize((600, 480)).save(buf, "JPEG")
        status, headers, data, _ = post(port, buf.getvalue(), "/predict")
        odd = np.asarray(Image.open(io.BytesIO(data)))
        phase("slice", f"600x480 JPEG -> HTTP {status} "
              f"{headers.get('Content-Type')} mask {odd.shape}")
        assert status == 200 and odd.shape == (480, 600)
        assert set(np.unique(odd)) <= {0, 255}
    finally:
        server.shutdown()
        server.close()
        thread.join(timeout=30)

    masks = []
    for status, headers, data, _ in answers:
        assert status == 200, (status, data[:200])
        h, w = int(headers["X-Height"]), int(headers["X-Width"])
        assert (h, w) == frames[0].shape
        masks.append(np.frombuffer(data, np.uint8).reshape(h, w) // 255)
    masks = np.stack(masks)
    assert set(np.unique(masks)) <= {0, 1}
    assert n_batches < N_FRAMES, "requests did not coalesce"
    assert launches == N_LAYERS * n_batches, \
        f"{launches} kernel launches for {n_batches} batches"
    assert stats["images"] >= N_FRAMES and stats["errors"] == 0

    # the same frames through the plain attention path, explicitly chosen
    plain = load_checkpoint_into(
        ckpt, "TransUNet",
        create_model("TransUNet", use_flash_attention=False, **SLICE))
    x = torch.from_numpy(np.stack(frames)[..., None]).cuda()
    A.flash_forward_cuda.launches = 0
    ref = run_batches(plain.cuda(), x, torch.bfloat16)
    assert A.flash_forward_cuda.launches == 0, "the plain path launched"
    flash = load_checkpoint_into(ckpt, "TransUNet",
                                 create_model("TransUNet", **SLICE)).cuda()
    kern = run_batches(flash, x, torch.bfloat16)
    # bf16 noise floor: the flash path with the kernel swapped for its own
    # plain version. Two correct bf16 attentions already differ by about a
    # bf16 ulp, which the bf16 decoder turns into flips of the pixels whose
    # logit lies that close to the threshold.
    launched = A.flash_forward_cuda.launches
    blocks.flash_attention = lambda q, k, v: A.flash_forward_reference(
        q, k, v)[0]
    try:
        twin = run_batches(flash, x, torch.bfloat16)
    finally:
        blocks.flash_attention = A.flash_attention
    assert A.flash_forward_cuda.launches == launched
    floor = float((ref == twin).mean())
    agree = float((ref == kern).mean())
    served = float((ref == masks).mean())
    phase("slice", f"bf16 masks vs plain path: kernel's plain twin (noise "
          f"floor) {floor:.6%}; kernel path batched alike {agree:.6%} "
          f"(limit floor - {KERNEL_MARGIN:g}); served by the daemon "
          f"{served:.6%} (limit floor - {SERVED_MARGIN:g}); served vs "
          f"batched alike {float((kern == masks).mean()):.6%}; foreground "
          f"{masks.mean():.3f}")

    # float32 masks of both paths on every frame: only attention differs,
    # by summation order
    agree32 = float((run_batches(flash, x, torch.float32)
                     == run_batches(plain, x, torch.float32)).mean())
    phase("slice", f"float32 masks: kernel path vs plain path agree on "
          f"{agree32:.6%} of pixels (limit {F32_MASK_AGREE:.1%})")
    # and their logits on two frames
    xf = x[:2].permute(0, 3, 1, 2).float() / 255.0
    with torch.inference_mode():
        lf, lp = flash(xf), plain(xf)
    torch.cuda.synchronize()
    dlogit = (lf - lp).abs().max().item()
    near = (lp.abs() < 1e-2).float().mean().item()
    phase("slice", f"float32 logits kernel vs plain path: max|d| "
          f"{dlogit:.3e} (limit {F32_LOGIT_LIMIT:g}), shape "
          f"{tuple(lf.shape)}, share of |logit| < 1e-2: {near:.5f}")
    size = SLICE["image_size"]
    assert lf.shape == (2, 1, size, size) and torch.isfinite(lf).all()
    assert dlogit <= F32_LOGIT_LIMIT
    assert agree32 >= F32_MASK_AGREE, \
        "float32 masks of the kernel path and the plain path disagree"
    assert agree >= floor - KERNEL_MARGIN, \
        "the kernel path disagrees with the plain path beyond bf16 noise"
    assert served >= floor - SERVED_MARGIN, \
        "the served masks disagree with the plain path beyond bf16 noise"
    assert 0.0 < masks.mean() < 1.0, "degenerate masks"
    return launches, ckpt


def profile_slice(ckpt):
    """Device time of one bf16 batch through ``make_serve_fn`` on both
    attention paths, and where the kernel path's device time goes."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
    from ddti_tpu_torch.train.export import make_serve_fn

    x = torch.from_numpy(np.stack(make_frames(
        BATCH, SLICE["image_size"], SEED + 1))[..., None]).cuda()
    serve = {}
    for path, flash in (("kernel", None), ("plain", False)):
        model = create_model("TransUNet", use_flash_attention=flash, **SLICE)
        serve[path] = make_serve_fn(
            load_checkpoint_into(ckpt, "TransUNet", model).cuda(),
            compute_dtype=torch.bfloat16)
    order = ("plain", "kernel", "kernel", "plain")
    ms = [median_ms(lambda: serve[path](x)) for path in order]
    phase("profile", f"device time per bf16 batch of {BATCH} at "
          f"{SLICE['image_size']}^2 (CUDA events, median of 20), order "
          f"{', '.join(order)}: {', '.join(f'{t:.3f}' for t in ms)} ms")

    torch.cuda.synchronize()
    launches0 = A.flash_forward_cuda.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(BUSY_WINDOW):
            for _ in range(PROFILE_BATCHES):
                serve["kernel"](x)
            torch.cuda.synchronize()
    kernels = device_kernels(prof)
    kernel_us = sum(e.self_device_time_total for e in kernels)
    busy = device_busy(prof)
    phase("profile", f"torch.profiler, {PROFILE_BATCHES} kernel-path "
          f"batches: device {busy['union_us'] / 1e3:.3f} ms, "
          f"{busy_text(busy)}; "
          f"{A.flash_forward_cuda.launches - launches0} flash_fwd launches; "
          f"shares of the summed kernel time {kernel_us / 1e3:.3f} ms:")
    if not kernels:
        phase("profile", "no device time recorded: breakdown not measured")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[
            :PROFILE_TOP]:
        phase("profile", f"{e.self_device_time_total / kernel_us:6.1%} "
              f"{e.count:4d} x {e.self_device_time_total / e.count / 1e3:.4f}"
              f" ms  {e.key[:90]}")


def interval_union_us(intervals, lo=None, hi=None):
    """Length of the union of ``(start, end)`` intervals, each clipped to
    ``[lo, hi]`` first (None: unbounded): time the device was busy at all,
    however many streams overlapped."""
    clipped = sorted((max(a, lo) if lo is not None else a,
                      min(b, hi) if hi is not None else b)
                     for a, b in intervals)
    total, cur_a, cur_b = 0.0, None, None
    for a, b in clipped:
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


BUSY_WINDOW = "chip_smoke.busy_window"
_SUMMED_SHOWN = []  # the old summed reading is printed once a run


def device_kernels(prof):
    """key_averages' device entries that took time, without the user
    annotations: a record_function range (AdamW's ``Optimizer.step``,
    BUSY_WINDOW itself) shows on the device as one more event that spans
    the kernels it holds, so a sum over every entry counts them twice."""
    import torch

    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)]


def _device_spans(prof, window):
    """The ``record_function(window)`` range on the trace's clock and the
    device intervals of the kernels, memcpys and memsets in the trace."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = list(prof.events())
    win = [e for e in events if e.name == window and e.device_type != cuda]
    assert win, f"no {window} range in the trace"
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.device_type == cuda
             and not getattr(e, "is_user_annotation", False)
             and e.time_range.end > e.time_range.start]
    return win[0].time_range.start, win[0].time_range.end, spans


def device_busy(prof, window=BUSY_WINDOW):
    """The device's busy time in a torch.profiler trace, read from its
    events: the union of the device intervals of kernels, memcpys and
    memsets, clipped to the ``record_function(window)`` range (the host's
    span of the measured work). Returns window_us and union_us. The first
    call of a run also prints, once, what the old reading made of the same
    window (summed_text)."""
    lo, hi, spans = _device_spans(prof, window)
    busy = dict(window_us=hi - lo, union_us=interval_union_us(spans, lo, hi))
    if not _SUMMED_SHOWN:
        _SUMMED_SHOWN.append(True)
        phase("busy", summed_text(prof, busy, window))
    return busy


def summed_text(prof, busy, window=BUSY_WINDOW):
    """The old busy reading beside the union, for one window: key_averages'
    self_device_time_total summed over every CUDA entry, the user
    annotations in that sum (counted twice: once as themselves, once as
    the kernels they span), and the kernels that overlapped one another."""
    import torch

    lo, hi, spans = _device_spans(prof, window)
    inside = sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in spans)
    avgs = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0]
    annotations = {e.key: e.self_device_time_total for e in avgs
                   if getattr(e, "is_user_annotation", False)}
    w = max(busy["window_us"], 1e-9)
    return (f"the union of {len(spans)} device intervals reads "
            f"{busy['union_us'] / w:.1%} of a {w / 1e3:.3f} ms window; the "
            f"old reading, key_averages' device time summed over every CUDA "
            f"entry, reads "
            f"{sum(e.self_device_time_total for e in avgs) / w:.1%}, of "
            f"which {sum(annotations.values()) / w:.1%} are the user "
            f"annotations ("
            + ", ".join(f"{k} {v / w:.1%}"
                        for k, v in sorted(annotations.items()))
            + f"); kernels overlapping one another "
            f"{(inside - busy['union_us']) / 1e3:.3f} ms")


def busy_text(b):
    """A busy share as the phases print it: the union's share of the
    window."""
    w = max(b["window_us"], 1e-9)
    return (f"{b['union_us'] / w:.1%} busy (union of the device intervals "
            f"over a {w / 1e3:.3f} ms window)")


def edt_masks(n, h, w, seed):
    """EDT inputs (nonzero = foreground): 1 - the synthetic nodule masks
    (the boundary loss's input), or random discs and salt where the frame
    is not square, with the edge frames first: all zeros, all ones (no
    zero: the cap h + w), a single zero, a single nonzero pixel."""
    import numpy as np
    import torch

    from ddti_tpu_torch.data.synthetic import generate_ddti_like

    if h == w and h >= 64:
        _, masks = generate_ddti_like(n, (h, w), seed)
        m = (masks[..., 0] == 0).astype(np.uint8)
    else:
        rng = np.random.default_rng(seed)
        yy, xx = np.mgrid[0:h, 0:w]
        m = (rng.random((n, h, w)) < 0.01).astype(np.uint8)
        for i in range(n):
            cy, cx = rng.uniform(0, h), rng.uniform(0, w)
            r = rng.uniform(1, max(h, w) / 3)
            m[i] |= ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r)
    edge = [np.zeros((h, w), np.uint8), np.ones((h, w), np.uint8),
            np.ones((h, w), np.uint8), np.zeros((h, w), np.uint8)]
    edge[2][h // 2, w // 3] = 0
    edge[3][h // 3, w // 2] = 1
    k = min(len(edge), n)
    m[:k] = np.stack(edge[:k])
    return torch.from_numpy(m)


def edt_times(shape, seed):
    """The EDT kernel's device time at (N, H, W) on ``edt_masks``, with
    whatever ``ddti_tpu_torch`` is imported: ``queued_ms`` (100 calls
    queued behind a device-side sleep) and its column and row passes apart
    (torch.profiler; None where it recorded no event of one)."""
    import torch

    from ddti_tpu_torch.ops import edt as E

    m = edt_masks(*shape, seed).to(DEVICE)
    times = dict(queued_ms=queued_ms(lambda: E.edt_cuda(m))[1])
    times.update(profiled_ms(lambda: E.edt_cuda(m), {
        "column_ms": ("edt_column",), "row_ms": ("edt_row",)}))
    torch.cuda.synchronize()
    return times


def check_edt():
    """csrc/edt.cu against its plain version (bit for bit, every frame) and
    scipy (every frame with a zero), with kernel and plain timings (one call
    and queued) and the kernel's column and row passes timed apart."""
    import numpy as np
    import torch
    from scipy import ndimage

    from ddti_tpu_torch.ops import edt as E

    rows = []
    for i, (n, h, w) in enumerate(EDT_SHAPES):
        m = edt_masks(n, h, w, SEED + i).to(DEVICE)
        got = E.edt_cuda(m)
        torch.cuda.synchronize()
        want = E.edt_reference(m)
        equal = torch.equal(got, want)
        err = (got - want).abs().max().item()
        host, ref_in = got.cpu().numpy(), m.cpu().numpy()
        scipy_frames = scipy_equal = 0
        for j in range(n):
            if not (ref_in[j] == 0).any():  # scipy has no answer there
                assert (host[j] == h + w).all(), "the cap h + w"
                continue
            scipy_frames += 1
            scipy_equal += np.array_equal(
                host[j], ndimage.distance_transform_edt(ref_in[j]).astype(
                    np.float32))
        row = dict(shape=[n, h, w], max_abs_err=err, bit_equal=equal,
                   scipy_frames=scipy_frames, scipy_equal=scipy_equal)
        timing = ""
        if i < EDT_TIMED:
            row["ms"] = median_ms(lambda: E.edt_cuda(m))
            row["plain_ms"] = median_ms(lambda: E.edt_reference(m))
            row.update(edt_times((n, h, w), SEED + i))
            b = bound("edt", (n, h, w))
            row.update(bound_ms=b[0], bound_by=b[1])
            minplus_ms = (work_counts("edt", (n, h, w))["minplus_flop"]
                          / PEAK_FLOPS["float32"] * 1e3)
            timing = (f", kernel {row['ms']:.4f} ms, queued "
                      f"{row['queued_ms']:.4f} (profiler: column pass "
                      + ", row pass ".join(
                          "not recorded" if row[key] is None
                          else f"{row[key]:.4f}"
                          for key in ("column_ms", "row_ms"))
                      + f") plain {row['plain_ms']:.4f} ms; bound "
                      f"{b[0]:.5f} ms ({b[1]}; the min-plus algorithm's "
                      f"{minplus_ms:.4f})")
        phase("kernels", f"edt_minplus {(n, h, w)} uint8: bit-equal to plain "
              f"{equal} (max|d| {err:.3e}), bit-equal to scipy on "
              f"{scipy_equal}/{scipy_frames} frames with a zero" + timing)
        assert equal, "the EDT kernel disagrees with its plain version"
        assert scipy_equal == scipy_frames, \
            "the EDT kernel disagrees with scipy"
        rows.append(row)
    return rows


def _parse_terms(log_text):
    """Every logged epoch line: (phase, epoch, avg loss, bce, dice, focal,
    boundary, iou)."""
    import re

    pat = re.compile(
        r"(Train|Validate) Epoch: (\d+), Avg Loss: (\S+)\n.*BCE Loss: (\S+), "
        r"Dice Loss: (\S+), Focal Loss: (\S+), Boundary Loss: (\S+)\n"
        r".*IoU: (\S+)\n")
    return [(g[0], int(g[1]), *map(float, g[2:]))
            for g in pat.findall(log_text)]


def _bn_keys(path):
    return {f"params/{path}/scale", f"params/{path}/bias",
            f"batch_stats/{path}/mean", f"batch_stats/{path}/var"}


def _conv_bn_keys(block, convs=("conv1", "conv2"), prelu=False):
    """A ConvBNAct (or, with ``skip``, ResidualBlock) block's keys."""
    keys = {f"params/{block}/{conv}/kernel" for conv in convs}
    keys |= _bn_keys(f"{block}/bn1") | _bn_keys(f"{block}/bn2")
    if prelu:
        keys |= {f"params/{block}/prelu{i}/negative_slope" for i in (1, 2)}
    return keys


def _kernel_keys(name, bias=True):
    """The kernel (and bias) of a conv or dense layer."""
    return {f"params/{name}/kernel"} | ({f"params/{name}/bias"} if bias
                                       else set())


def jax_resunet_keys(depth):
    """The key set ddti_tpu.train.checkpoint.save_params_npz writes for a
    ResUNet of this depth, written out from the flax module tree (encoders,
    bottleneck and decoders are ResidualBlocks)."""
    keys = _kernel_keys("final_conv")
    for b in ([f"encoders_{i}" for i in range(depth)] + ["bottleneck"]
              + [f"decoders_{i}" for i in range(depth)]):
        keys |= _conv_bn_keys(b, ("conv1", "conv2", "skip"))
    for i in range(depth):
        keys |= _kernel_keys(f"upconvs_{i}")
    return keys


def jax_transunet_keys(depth, layers):
    """The key set ddti_tpu.train.checkpoint.save_params_npz writes for a
    TransUNet of this depth and encoder layer count, written out from the
    flax module tree (encoders and decoders are ConvBNAct blocks)."""
    keys = {"params/patchify/kernel", "params/pos_emb"}
    keys |= _kernel_keys("trans_proj") | _kernel_keys("final_conv")
    for b in ([f"encoders_{i}" for i in range(depth)]
              + [f"decoders_{i}" for i in range(depth)]):
        keys |= _conv_bn_keys(b)
    for i in range(depth):
        keys |= _kernel_keys(f"upconvs_{i}")
    for i in range(layers):
        for dense in ("qkv", "out_proj", "fc1", "fc2"):
            keys |= _kernel_keys(f"trans_layers_{i}/{dense}")
        for ln in ("ln1", "ln2"):
            keys |= {f"params/trans_layers_{i}/{ln}/scale",
                     f"params/trans_layers_{i}/{ln}/bias"}
    return keys


def _gate_keys(gate):
    keys = set()
    for conv in ("w_g", "w_x", "psi"):
        keys |= _kernel_keys(f"{gate}/{conv}") | _bn_keys(f"{gate}/{conv}_bn")
    return keys


def jax_zoo_keys(model_type, depth, use_attention=True,
                 deep_supervision=False, aspp_dilations=(1, 6, 12, 18)):
    """The key set ddti_tpu.train.checkpoint.save_params_npz writes for
    UNet, ASPPUNet, AttentionUNet, VNet2D or ImprovedVNet of this depth,
    written out from the flax module tree (ddti_tpu/models/zoo.py)."""
    keys = _kernel_keys("final_conv")
    if model_type in ("VNet2D", "ImprovedVNet"):
        prelu = model_type == "VNet2D"
        for i in range(depth):
            keys |= _conv_bn_keys(f"enc_blocks_{i}", prelu=prelu)
            keys |= _conv_bn_keys(f"dec_blocks_{i}", prelu=prelu)
            keys |= _kernel_keys(f"down_convs_{i}", bias=False)
            keys |= _kernel_keys(f"up_convs_{i}", bias=False)
            if model_type == "ImprovedVNet" and use_attention:
                keys |= _gate_keys(f"attn_gates_{i}")
            if model_type == "ImprovedVNet" and deep_supervision:
                keys |= _kernel_keys(f"ds_heads_{i}")
        return keys | _conv_bn_keys("bottleneck", prelu=prelu)
    for i in range(depth):
        keys |= _conv_bn_keys(f"encoders_{i}")
        keys |= _conv_bn_keys(f"decoders_{i}")
        keys |= _kernel_keys(f"upconvs_{i}")
        if model_type == "AttentionUNet":
            keys |= _gate_keys(f"attn_gates_{i}")
    if model_type != "ASPPUNet":
        return keys | _conv_bn_keys("bottleneck")
    for i in range(len(aspp_dilations)):
        keys |= _kernel_keys(f"aspp/branch{i}", bias=False)
    return (keys | _kernel_keys("aspp/project", bias=False)
            | _bn_keys("aspp/project_bn"))


def _biased_block_keys(block, convs, bns):
    """A block of biased convs and their BatchNorms."""
    keys = set()
    for c in convs:
        keys |= _kernel_keys(f"{block}/{c}")
    for b in bns:
        keys |= _bn_keys(f"{block}/{b}")
    return keys


def jax_legacy_keys(model_type, levels=None, layers=4):
    """The key set ddti_tpu.train.checkpoint.save_params_npz writes for one
    of the nine fixed-architecture models (LEGACY), written out from the
    flax module tree (ddti_tpu/models/legacy.py, models/mores.py);
    ``levels`` is len(features) of a Mores* model (its default when None),
    ``layers`` MoresTransUNet's encoder layers."""
    if model_type in ("LegacyUNet", "MoresUNet"):
        keys = _kernel_keys("final_conv")
        for b in ("encoder1", "encoder2", "encoder3", "encoder4",
                  "middle_block", "decoder3_block", "decoder2_block",
                  "decoder1_block", "final_block"):
            keys |= _biased_block_keys(b, ("conv1", "conv2"), ("bn1", "bn2"))
        for up in ("middle_up", "decoder3_up", "decoder2_up", "decoder1_up"):
            keys |= _kernel_keys(up)
        return keys
    if model_type in ("TripleBranchImprovedVNet", "MoresImprovedVNet"):
        first = 1 if model_type == "TripleBranchImprovedVNet" else 0
        dec = "dec_block" if first else "dec"

        def block(name, n, project):
            keys = _biased_block_keys(
                name, [f"conv{first + i}" for i in range(n)],
                [f"bn{first + i}" for i in range(n)])
            return keys | (_kernel_keys(f"{name}/res_proj") if project
                           else set())

        keys = _kernel_keys("final_conv")
        keys |= _kernel_keys("dec_se_final/fc1") | _kernel_keys(
            "dec_se_final/fc2")
        for b in range(3):
            for i, n in enumerate((2, 2, 3, 3, 3)):
                keys |= block(f"enc_b{b}_l{i}", n, i == 0)
                keys |= _kernel_keys(f"se_b{b}_l{i}/fc1") | _kernel_keys(
                    f"se_b{b}_l{i}/fc2")
                if i < 4:
                    keys |= _kernel_keys(f"down_b{b}_l{i}")
        for j, n in enumerate((3, 3, 2, 2)):
            keys |= _kernel_keys(f"up{6 + j}") | block(f"{dec}{6 + j}", n,
                                                       True)
        return keys
    if model_type == "MoresVNet2D":
        keys = _kernel_keys("final_conv")
        keys |= _conv_bn_keys("bottleneck", prelu=True)
        for i in range(5 if levels is None else levels):
            keys |= _conv_bn_keys(f"enc{i}", prelu=True)
            keys |= _conv_bn_keys(f"dec{i}", prelu=True)
            keys |= _kernel_keys(f"down{i}", bias=False)
            keys |= _kernel_keys(f"up{i}", bias=False)
        return keys
    n = 4 if levels is None else levels
    keys = _kernel_keys("final_conv")
    res = model_type == "MoresResUNet"
    convs = ("conv1", "conv2", "skip") if res else ("conv1", "conv2")
    for i in range(n):
        keys |= _conv_bn_keys(f"enc{i}", convs) | _conv_bn_keys(f"dec{i}",
                                                                convs)
        keys |= _kernel_keys(f"up{i}")
        if model_type == "MoresAttentionUNet":
            keys |= _gate_keys(f"att{i}")
    if model_type == "MoresTransUNet":
        keys |= {"params/patchify/kernel", "params/pos_emb"}
        keys |= _kernel_keys("trans_proj")
        for j in range(layers):
            for dense in ("qkv", "out_proj", "fc1", "fc2"):
                keys |= _kernel_keys(f"trans{j}/{dense}")
            for ln in ("ln1", "ln2"):
                keys |= {f"params/trans{j}/{ln}/scale",
                         f"params/trans{j}/{ln}/bias"}
        return keys
    if model_type == "MoresASPPUNet":
        for k in range(4):
            keys |= _kernel_keys(f"bottleneck/branch{k}", bias=False)
        return (keys | _kernel_keys("bottleneck/project", bias=False)
                | _bn_keys("bottleneck/project_bn"))
    return keys | _conv_bn_keys("bottleneck", convs)


def blank_model(model_type, **model_kw):
    """``create_model``'s module on the CPU without its initialisation
    (made on the meta device, storage left unset): for counting parameters
    and loading a checkpoint strictly, which sets every tensor of its
    state_dict."""
    import torch

    from ddti_tpu_torch.models import create_model

    with torch.device("meta"):
        model = create_model(model_type, **model_kw)
    return model.to_empty(device="cpu")


def run_cli(tmp, name, model_type, model_kw, flags, epochs, keys):
    """The training CLI (--mode both --synthetic, bf16) end to end
    in its own process: exit 0, the parameter count of ``model_kw``, the
    run tree, finite loss terms with a nonzero boundary term, val IoU and
    test metrics with HD95/ASSD, a best .pth that loads strictly and an .npz
    with the key set ``keys`` and the same tensors. Returns the launch count
    of each kernel in that run and the best weights' path without its
    suffix."""
    from ddti_tpu_torch.train.state import count_params

    base = os.path.join(tmp, f"runs_{name}")
    cmd = [sys.executable, "-m", "ddti_tpu_torch.cli.main", "--mode", "both",
           "--synthetic", "--use_amp_autocast", "true", "--base_dir", base,
           "--model_type", model_type, f"--epochs={epochs}", *flags]
    phase(name, " ".join(cmd[1:]))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=TRAIN_TIMEOUT_S)
    wall = time.perf_counter() - t0
    out = res.stdout
    phase(name, f"exit {res.returncode} in {wall:.1f} s")
    if res.returncode != 0:
        print(out[-4000:], res.stderr[-8000:], sep="\n", file=sys.stderr)
    assert res.returncode == 0, "the training CLI failed"
    params = [l for l in out.splitlines() if l.startswith("[PARAMS]")]
    kernels = [l for l in out.splitlines() if l.startswith("[KERNELS]")]
    phase(name, f"{params[0]} {kernels[0]}")
    model = blank_model(model_type, **model_kw)
    assert params[0] == f"[PARAMS] {model_type},{count_params(model)}"
    launches = dict(kv.split("=") for kv in kernels[0].split()[1:])
    launches = {k: int(v) for k, v in launches.items()}

    (run,) = os.listdir(base)
    best = check_run(name, os.path.join(base, run), model_type, model_kw,
                     keys, epochs, "--tta" in flags)
    return launches, best


def check_run(name, run, model_type, model_kw, keys, epochs, tta=False):
    """run_cli's checks of one CLI run's tree ``run``: the run tree, finite
    loss terms with a nonzero boundary term, val IoU and test metrics with
    HD95/ASSD, a best .pth that loads strictly and an .npz with the key set
    ``keys`` and the same tensors. Returns the best weights' path without
    its suffix."""
    import math

    import numpy as np
    import torch

    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into

    model = blank_model(model_type, **model_kw)
    for sub in ("models", "log/train_log.log", "result", "config.yaml"):
        assert os.path.exists(os.path.join(run, sub)), sub
    with open(os.path.join(run, "log", "train_log.log")) as f:
        log = f.read()
    terms = _parse_terms(log)
    for t in terms:
        phase(name, f"{t[0]} epoch {t[1]}: loss {t[2]:.4f} bce {t[3]:.4f} "
              f"dice {t[4]:.4f} focal {t[5]:.4f} boundary {t[6]:.4f} "
              f"IoU {t[7]:.4f}")
    assert len(terms) == 2 * epochs, "an epoch line is missing"
    assert all(math.isfinite(x) for t in terms for x in t[2:7])
    assert all(t[6] > 0 for t in terms), "the boundary term is zero"
    assert all(math.isfinite(t[7]) for t in terms if t[0] == "Validate")
    with open(os.path.join(run, "result", "test_metrics.json")) as f:
        test = json.load(f)
    phase(name, "test: " + ", ".join(
        f"{k} {test[k]:.4f}" for k in ("iou", "f1", "hd95_mean",
                                       "assd_mean", "total_images"))
        + f", tta {test['tta']}")
    for k in ("iou", "f1", "hd95_mean", "assd_mean"):
        assert math.isfinite(test[k]), k
    assert test["total_images"] == SYNTHETIC[2]
    assert test["tta"] is tta, test["tta"]

    best = os.path.join(run, "models", f"{model_type}_best")
    load_checkpoint_into(best + ".pth", model_type, model)  # strict
    with np.load(best + ".npz") as z:
        got = set(z.files)
    assert got == keys, sorted(got ^ keys)[:8]
    twin = load_checkpoint_into(best + ".npz", model_type,
                                blank_model(model_type, **model_kw))
    for k, v in model.state_dict().items():
        assert torch.equal(v, twin.state_dict()[k]), k
    phase(name, f"best .pth loads strictly; .npz holds the JAX layout's "
          f"{len(keys)} keys and the same tensors")
    return best


def _cli_batches(batch):
    """(train steps per epoch, val batches, test batches) of the CLI's
    synthetic splits."""
    return tuple(-(-n // batch) for n in SYNTHETIC)


def run_training(tmp):
    """The ResUNet training CLI, with a torch.profiler trace of its first
    PROFILE_STEPS steps (the trainer phase's --profile check); returns the
    EDT kernel's launch count and the trace's check."""
    model_kw = dict(base_filters=TRAIN["base_filters"], depth=TRAIN["depth"])
    flags = [f"--{k}={v}" for k, v in TRAIN.items()
             if k not in ("model_type", "epochs")] + [
                 "--profile", str(PROFILE_STEPS)]
    launches, best = run_cli(tmp, "train", "ResUNet", model_kw, flags,
                             TRAIN["epochs"], jax_resunet_keys(TRAIN["depth"]))
    steps, val, test_b = _cli_batches(TRAIN["batch_size"])
    expected = TRAIN["epochs"] * (steps + val) + test_b
    phase("train", f"edt_minplus launches {launches['edt_minplus']}, "
          f"expected {TRAIN['epochs']} epochs x ({steps} train + {val} val "
          f"steps) + {test_b} test batches = {expected}")
    assert launches["edt_minplus"] == expected
    return launches["edt_minplus"], check_profile_trace(best, "train"), best


def run_transunet_training(tmp):
    """The TransUNet training CLI from a model YAML with dropout_rate 0.0 and
    --tta (test() predicts each batch four times; validation once);
    returns the launch counts, each checked against its expected value."""
    import yaml

    cfg = os.path.join(tmp, "transunet_bf64_d4_dropout0.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"model": {"model_type": "TransUNet",
                                  "kwargs": TSLICE}}, f)
    flags = ["--config_path", cfg, "--device", DEVICE, "--tta",
             *(f"--{k}={v}" for k, v in TTRAIN.items() if k != "epochs")]
    model_kw = dict(TSLICE, image_size=TTRAIN["image_size"])
    launches, _ = run_cli(tmp, "ttrain", "TransUNet", model_kw, flags,
                          TTRAIN["epochs"],
                          jax_transunet_keys(TSLICE["depth"], N_LAYERS))
    from ddti_tpu_torch.train.state import count_params

    assert count_params(blank_model("TransUNet", **model_kw)) \
        == TSLICE_PARAMS, "not the serving slice's TransUNet"
    steps, val, test_b = _cli_batches(TTRAIN["batch_size"])
    epochs = TTRAIN["epochs"]
    expected = {
        "flash_fwd": N_LAYERS * (epochs * (steps + val)
                                 + INFER_FLIPS * test_b),
        "flash_bwd_dkdv": N_LAYERS * epochs * steps,
        "flash_bwd_dq": N_LAYERS * epochs * steps,
        "edt_minplus": epochs * (steps + val) + test_b,
    }
    phase("ttrain", "launches " + ", ".join(
        f"{k} {launches[k]} (expected {v})" for k, v in expected.items())
        + f": {N_LAYERS} layers, {epochs} epochs x ({steps} train + {val} "
        f"val steps) + {test_b} test batches, each {INFER_FLIPS} forwards "
        f"under --tta; the backward in train steps only")
    assert {k: launches[k] for k in expected} == expected
    return launches


def zoo_entry(model_type):
    """The model kwargs of ``model_type``'s base_filters 64, depth 5 entry of
    configs/config.yaml, with ZOO's additions."""
    import yaml

    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "configs", "config.yaml")) as f:
        (kw,) = [e["model"]["kwargs"] for e in yaml.safe_load(f)
                 if e["model"]["model_type"] == model_type
                 and e["model"]["kwargs"]["base_filters"] == 64
                 and e["model"]["kwargs"]["depth"] == 5]
    return dict(kw, **ZOO[model_type])


def run_zoo_training(tmp, models=tuple(ZOO)):
    """The training CLI for each of ``models`` (default: every model of ZOO)
    from its one-entry model YAML
    (512^2, batch 16, bf16, ZOO_TRAIN's epochs): run_cli's checks, the
    parameter count of the entry as JAX counts it (plus the heads), and
    exactly the expected EDT launches: the boundary term of every train and
    val step and the test batches' surface metrics; the heads' loss runs
    none. Returns {model: EDT launches} and {model: (best weights, YAML)}."""
    import yaml

    from ddti_tpu_torch.train.state import count_params

    t0 = time.perf_counter()
    steps, val, test_b = _cli_batches(ZOO_TRAIN["batch_size"])
    expected = ZOO_TRAIN["epochs"] * (steps + val) + test_b

    def train(model_type):
        kw = zoo_entry(model_type)
        cfg = os.path.join(tmp, f"{model_type}_bf64_d5.yaml")
        with open(cfg, "w") as f:
            yaml.safe_dump({"model": {"model_type": model_type,
                                      "kwargs": kw}}, f)
        plain = {k: v for k, v in kw.items() if k not in ZOO[model_type]}
        heads = (sum(c + 1 for c in blank_model(model_type, **kw).channels)
                 if kw.get("deep_supervision") else 0)
        assert count_params(blank_model(model_type, **plain)) \
            == ZOO_JAX_PARAMS[model_type], f"{model_type}: not the entry"
        flags = ["--config_path", cfg, "--device", DEVICE, "--alpha", "2",
                 *(f"--{k}={v}" for k, v in ZOO_TRAIN.items()
                   if k != "epochs")]
        got, best = run_cli(tmp, f"zoo {model_type}", model_type, kw, flags,
                            ZOO_TRAIN["epochs"],
                            jax_zoo_keys(model_type, kw["depth"],
                                         **ZOO[model_type]))
        phase("zoo train", f"{model_type} {kw}: {ZOO_JAX_PARAMS[model_type]}"
              f" parameters as JAX counts the entry (+ {heads} of the "
              f"heads); edt_minplus launches {got['edt_minplus']}, expected "
              f"{ZOO_TRAIN['epochs']} epoch x ({steps} train + {val} val "
              f"steps) + {test_b} test batches = {expected}")
        assert got["edt_minplus"] == expected
        return got["edt_minplus"], (best, cfg)

    with concurrent.futures.ThreadPoolExecutor(ZOO_TRAIN_PARALLEL) as pool:
        done = dict(zip(models, pool.map(train, models)))
    phase("zoo train", f"phase wall time {time.perf_counter() - t0:.1f} s "
          f"({ZOO_TRAIN_PARALLEL} runs at a time)")
    return ({m: n for m, (n, _) in done.items()},
            {m: c for m, (_, c) in done.items()})


def zoo_serve(ckpts):
    """Each zoo model's best .pth through cli/serve.py's load_predictor on
    the card: one bf16 batch of 16 at 512^2, uint8 {0, 1} masks out, and
    their agreement with the float32 masks; float32 logits on the card (TF32
    off) against the same weights on the CPU at batch ZOO_CPU_BATCH, within
    ZOO_LOGIT_RTOL of the CPU's largest."""
    import numpy as np
    import torch

    from ddti_tpu_torch.cli import serve
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
    from ddti_tpu_torch.train.export import serve_body

    t0 = time.perf_counter()
    size = ZOO_TRAIN["image_size"]
    x = np.stack(make_frames(BATCH, size, SEED + 2))[..., None]
    for model_type, (best, cfg) in ckpts.items():
        args = serve.get_parser().parse_args(
            ["--checkpoint", best + ".pth", "--config_path", cfg,
             "--image_size", str(size), "--batch_size", str(BATCH),
             "--bf16", "--device", "cuda"])
        predict, batch_n, got_size, info = serve.load_predictor(args)
        masks = predict(x)
        assert info["model"] == model_type and (batch_n, got_size) == (
            BATCH, size)
        assert masks.dtype == np.uint8 and masks.shape == x.shape
        assert set(np.unique(masks)) <= {0, 1}
        del predict
        cpu = load_checkpoint_into(best + ".pth", model_type, blank_model(
            model_type, **zoo_entry(model_type))).eval()
        card = copy.deepcopy(cpu).cuda()
        xf = torch.from_numpy(x[:ZOO_CPU_BATCH]).permute(0, 3, 1, 2) / 255.0
        with torch.inference_mode():
            masks32 = serve_body(card.eval(), torch.from_numpy(x).cuda()
                                 ).cpu().numpy()
            on_card = card(xf.cuda())
            on_cpu = cpu(xf)
        on_card, on_cpu = (o[0] if isinstance(o, tuple) else o
                           for o in (on_card, on_cpu))
        on_card = on_card.cpu()
        del card
        torch.cuda.empty_cache()
        rel = float((on_card - on_cpu).abs().max() / on_cpu.abs().max())
        phase("zoo serve", f"{model_type}: load_predictor bf16 batch "
              f"{BATCH} at {size}^2 -> uint8 masks {masks.shape}, "
              f"foreground {masks.mean():.4f}; bf16 masks agree with float32 "
              f"on {float((masks == masks32).mean()):.6%} of pixels; float32 "
              f"logits card vs CPU at batch {ZOO_CPU_BATCH}: max|d| / "
              f"max|logit| {rel:.3e} (limit {ZOO_LOGIT_RTOL:g})")
        assert torch.isfinite(on_card).all() and rel <= ZOO_LOGIT_RTOL
    phase("zoo serve", f"phase wall time {time.perf_counter() - t0:.1f} s")


def make_infer_frames(root, seed):
    """INFER_FRAMES as grayscale JPEGs under ``root/imgs`` (speckle over a
    dark field, one brighter ellipse each, as make_frames draws them) and
    their ellipses as ``root/masks/<stem>_mask.png``. Returns the two
    directories and [(name, (width, height))]."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    imgs, masks = os.path.join(root, "imgs"), os.path.join(root, "masks")
    os.makedirs(imgs)
    os.makedirs(masks)
    frames = []
    for w, h, n in INFER_FRAMES:
        yy, xx = np.mgrid[0:h, 0:w]
        for _ in range(n):
            cy, cx, ry, rx = rng.uniform([0.3, 0.3, 0.08, 0.08],
                                         [0.7, 0.7, 0.25, 0.25])
            inside = ((yy / h - cy) / ry) ** 2 + ((xx / w - cx) / rx) ** 2 < 1
            img = 60 + 90 * inside + rng.normal(0, 25, (h, w))
            stem = f"f{len(frames):02d}"
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                os.path.join(imgs, stem + ".jpg"))
            Image.fromarray(inside.astype(np.uint8) * 255).save(
                os.path.join(masks, stem + "_mask.png"))
            frames.append((stem + ".jpg", (w, h)))
    return imgs, masks, frames


def infer_forwards(sizes, batch, sliding=False):
    """Model forwards of one pass of the infer CLI over frames of ``sizes``
    [(width, height)]: batches of ``batch`` resized frames, or under
    --sliding_window one a chunk of INFER_TILE_BATCH tiles of each frame."""
    if not sliding:
        return -(-len(sizes) // batch)
    from ddti_tpu_torch.eval.sliding_window import tile_coords

    return sum(-(-len(tile_coords(h, w, INFER_WINDOW, INFER_STRIDE)[2])
               // INFER_TILE_BATCH) for w, h in sizes)


def infer_flash_launches(layers, sizes, batch, *, tta=False, members=1,
                         sliding=False, fold_bn=False):
    """The flash forward's launches in one infer CLI run of a model with
    ``layers`` attention layers: one a layer in each forward, four forwards
    under --tta, one a member of an ensemble, and --fold_bn's check (the
    model and its folded copy on one frame, each member)."""
    flips = INFER_FLIPS if tta else 1
    fold = 2 * members if fold_bn else 0
    return layers * (flips * members * infer_forwards(sizes, batch, sliding)
                     + fold)


def parse_infer_output(text):
    """(images, seconds, img/s, flash launches) from the infer CLI's
    ``predicted N images in Ts (R img/s)`` and ``[KERNELS] flash_fwd=K``
    lines."""
    import re

    m = re.search(r"^predicted (\d+) images in ([\d.]+)s \(([\d.]+) img/s\)",
                  text, re.M)
    k = re.search(r"^\[KERNELS\] flash_fwd=(\d+)\b", text, re.M)
    assert m and k, text[-2000:]
    return int(m.group(1)), float(m.group(2)), float(m.group(3)), \
        int(k.group(1))


def run_infer_cli(label, ckpt, model_args, flags, imgs, out, frames,
                  expected):
    """One run of ``python -m ddti_tpu_torch.cli.infer --device cuda``:
    exit 0, a mask of each frame's size (binary, or soft under --prob),
    an overlay of each under --overlay, eval_metrics.json and
    per_image_metrics.csv under --mask_dir, and exactly ``expected`` flash
    launches. Returns its numbers."""
    import numpy as np
    from PIL import Image

    cmd = [sys.executable, "-m", "ddti_tpu_torch.cli.infer", "--device",
           "cuda", "--checkpoint", ckpt, "--input_dir", imgs,
           "--output_dir", out, *model_args, *flags]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=INFER_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-3000:], res.stderr[-6000:], sep="\n",
              file=sys.stderr)
    assert res.returncode == 0, f"infer {label} failed"
    n, secs, rate, flash = parse_infer_output(res.stdout)
    assert n == len(frames)
    soft = 0
    for name, size in frames:
        stem = os.path.splitext(name)[0]
        m = Image.open(os.path.join(out, stem + "_pred.png"))
        assert m.mode == "L" and m.size == size, (stem, m.mode, m.size)
        values = set(np.unique(np.asarray(m)).tolist())
        soft += len(values - {0, 255})
        if "--prob" not in flags:
            assert values <= {0, 255}, (stem, sorted(values)[:8])
        if "--overlay" in flags:
            o = Image.open(os.path.join(out, stem + "_overlay.png"))
            assert o.mode == "RGB" and o.size == size
    if "--prob" in flags:
        assert soft > 0, "--prob wrote binary maps"
    line = ""
    if "--mask_dir" in flags:
        with open(os.path.join(out, "eval_metrics.json")) as f:
            ev = json.load(f)
        assert os.path.exists(os.path.join(out, "per_image_metrics.csv"))
        assert ev["images"] == len(frames)
        line = (f"; --mask_dir IoU {ev['iou']:.4f} F1 {ev['f1']:.4f} "
                f"HD95 {ev.get('hd95_mean', float('nan')):.2f}")
    phase("infer", f"{label}: {' '.join(flags)} -> exit 0 in {wall:.1f} s; "
          f"'predicted {n} images in {secs}s ({rate} img/s)'; flash_fwd "
          f"launches {flash} (expected {expected}){line}")
    assert flash == expected, f"{label}: {flash} flash launches"
    return {"mode": label, "flags": flags, "wall_s": wall, "cli_s": secs,
            "img_per_s": rate, "flash_fwd": flash}


def _resized_batch(imgs, frames, n, size):
    """uint8 (n, size, size, 1) of the first n frames, PIL-bilinear
    resized as the CLI resizes them."""
    import numpy as np
    from PIL import Image

    return np.stack([np.asarray(Image.open(os.path.join(imgs, name))
                                .convert("L").resize((size, size),
                                                     Image.BILINEAR),
                                np.uint8)
                     for name, _ in frames[:n]])[..., None]


def run_infer(tmp, trans_ckpt, attn_ckpt):
    """The infer phase: the inference CLI in its modes on the serving
    slice's TransUNet and on an AttentionUNet (its gates' BatchNorms
    folded), then in-process on the card: TTA'd float32 logits kernel vs
    plain path, folded vs unfolded float32 logits, bf16 vs float32 TTA
    masks, and device times of one bf16 batch (TTA and --fold_bn on and
    off) and of one tiled 1024 x 768 frame."""
    import numpy as np
    import torch

    from PIL import Image

    from ddti_tpu_torch.eval.sliding_window import (
        sliding_window_logits,
        tile_coords,
    )
    from ddti_tpu_torch.eval.tta import tta_logits
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
    from ddti_tpu_torch.train.export import (
        make_serve_fn,
        nhwc_logits,
        serve_body,
    )
    from ddti_tpu_torch.train.fold_bn import fold_batchnorm

    t0 = time.perf_counter()
    root = os.path.join(tmp, "infer")
    imgs, masks, frames = make_infer_frames(root, SEED + 3)
    sizes = [s for _, s in frames]
    # mode (c)'s folder: the first INFER_OVERLAY_FRAMES frames of each size
    imgs_c = os.path.join(root, "imgs_c")
    os.makedirs(imgs_c)
    frames_c = []
    for w, h, _ in INFER_FRAMES:
        frames_c += [f for f in frames if f[1] == (w, h)][
            :INFER_OVERLAY_FRAMES]
    for name, _ in frames_c:
        os.symlink(os.path.join(imgs, name), os.path.join(imgs_c, name))
    sizes_c = [s for _, s in frames_c]
    size = SLICE["image_size"]
    trans_b = os.path.join(tmp, "transunet_seed1.pth")
    torch.save(random_state(create_model("TransUNet", **SLICE), SEED + 1),
               trans_b)
    common = ["--image_size", str(size), "--batch_size", str(BATCH)]
    trans_args = ["--model_type", "TransUNet", "--base_filters",
                  str(SLICE["base_filters"]), "--depth", str(SLICE["depth"]),
                  *common]
    attn_args = ["--model_type", "AttentionUNet", "--base_filters",
                 str(INFER_ATTN["base_filters"]), "--depth",
                 str(INFER_ATTN["depth"]), *common]
    a_flags = ["--bf16", "--tta", "--mask_dir", masks]
    c_flags = ["--fold_bn", "--prob", "--overlay"]
    all_f, c_f = (imgs, frames), (imgs_c, frames_c)
    runs = [  # (label, checkpoint, model args, flags, frames, launches)
        ("TransUNet (a) resized", trans_ckpt, trans_args, a_flags, all_f,
         infer_flash_launches(N_LAYERS, sizes, BATCH, tta=True)),
        ("TransUNet (b) tiled", trans_ckpt, trans_args,
         ["--sliding_window", "--window", str(INFER_WINDOW), "--stride",
          str(INFER_STRIDE)], all_f,
         infer_flash_launches(N_LAYERS, sizes, BATCH, sliding=True)),
        ("TransUNet (c) folded", trans_ckpt, trans_args, c_flags, c_f,
         infer_flash_launches(N_LAYERS, sizes_c, BATCH, fold_bn=True)),
        ("TransUNet (d) ensemble", f"{trans_ckpt},{trans_b}", trans_args, [],
         all_f, infer_flash_launches(N_LAYERS, sizes, BATCH, members=2)),
        ("AttentionUNet (a) resized", attn_ckpt, attn_args, a_flags, all_f,
         0),
        ("AttentionUNet (c) folded", attn_ckpt, attn_args, c_flags, c_f, 0),
    ]
    phase("infer", f"{len(frames)} synthetic JPEG frames "
          f"{', '.join(f'{c} at {w}x{h}' for w, h, c in INFER_FRAMES)}; "
          f"checkpoints: the slice's TransUNet {os.path.basename(trans_ckpt)}"
          f" (+ seed {SEED + 1} for the ensemble), AttentionUNet "
          f"{os.path.basename(attn_ckpt)}; {len(runs)} CLI runs, "
          f"{INFER_PARALLEL} at a time; mode (c) over {len(frames_c)} of "
          f"the frames")

    def one(i):
        label, ck, margs, flags, (src, fr), expected = runs[i]
        return run_infer_cli(label, ck, margs, flags, src,
                             os.path.join(root, f"out{i}"), fr, expected)

    with concurrent.futures.ThreadPoolExecutor(INFER_PARALLEL) as pool:
        cli = list(pool.map(one, range(len(runs))))
    launches = sum(r["flash_fwd"] for r in cli)

    def load(model_type, ck, **kw):
        kw = dict(SLICE, **kw) if model_type == "TransUNet" else \
            dict(INFER_ATTN, **kw)
        return load_checkpoint_into(ck, model_type, blank_model(
            model_type, **kw)).cuda().eval()

    x_u8 = torch.from_numpy(_resized_batch(imgs, frames, BATCH, size)).cuda()
    xf = x_u8[:INFER_CHECK_BATCH].float() / 255.0
    trans = load("TransUNet", trans_ckpt)
    plain = load("TransUNet", trans_ckpt, use_flash_attention=False)
    with torch.inference_mode():
        n0 = A.flash_forward_cuda.launches
        lk = tta_logits(lambda x: nhwc_logits(trans, x), xf)
        n_kernel = A.flash_forward_cuda.launches - n0
        lp = tta_logits(lambda x: nhwc_logits(plain, x), xf)
        n_plain = A.flash_forward_cuda.launches - n0 - n_kernel
    rel = float((lk - lp).abs().max() / lp.abs().max())
    phase("infer", f"float32 TTA logits of {INFER_CHECK_BATCH} frames, "
          f"kernel path ({n_kernel} flash launches) vs plain path "
          f"({n_plain}): max|d| / max|logit| {rel:.3e} (limit "
          f"{INFER_LOGIT_RTOL:g}); finite {bool(torch.isfinite(lk).all())}")
    assert n_kernel == INFER_FLIPS * N_LAYERS and n_plain == 0
    assert torch.isfinite(lk).all() and rel <= INFER_LOGIT_RTOL
    del plain

    agree, fold_rows, folded = {}, {}, {}
    for name, model in (("TransUNet", trans),
                        ("AttentionUNet", load("AttentionUNet", attn_ckpt))):
        tf = time.perf_counter()
        folded[name] = fold_batchnorm(model, name)
        fold_s = time.perf_counter() - tf
        with torch.inference_mode():
            want = nhwc_logits(model, xf)
            got = nhwc_logits(folded[name], xf)
            m32 = serve_body(model, x_u8, tta=True)
            m16 = serve_body(model, x_u8, compute_dtype=torch.bfloat16,
                             tta=True)
        err = float((got - want).abs().max())
        tol = 1e-3 + 0.01 * float(want.abs().max())
        agree[name] = float((m32 == m16).float().mean())
        fold_rows[name] = {"max_abs_err": err, "tol": tol,
                           "fold_s": fold_s}
        phase("infer", f"{name}: fold_batchnorm on the card in {fold_s:.2f}"
              f" s (its own check included); folded vs unfolded float32 "
              f"logits max|d| {err:.3e} (limit 1e-3 + 0.01 max|logit| = "
              f"{tol:.3e}); bf16 vs float32 TTA masks of {BATCH} frames "
              f"agree on {agree[name]:.6%} (limit {INFER_BF16_AGREE:.1%}); "
              f"foreground {float(m32.float().mean()):.4f}")
        assert err <= tol and agree[name] >= INFER_BF16_AGREE
        if name == "AttentionUNet":
            del model, folded[name]

    ms = {}
    for fold in (False, True):
        model = folded["TransUNet"] if fold else trans
        for use_tta in (False, True):
            serve = make_serve_fn(model, compute_dtype=torch.bfloat16,
                                  tta=use_tta)
            ms[f"tta={use_tta} fold_bn={fold}"] = median_ms(
                lambda: serve(x_u8), runs=INFER_TIMED_RUNS)
    phase("infer", f"device time per bf16 batch of {BATCH} at {size}^2 "
          f"(CUDA events, median of {INFER_TIMED_RUNS}): " + ", ".join(
              f"{k} {v:.3f} ms" for k, v in ms.items())
          + f"; TTA / plain {ms['tta=True fold_bn=False'] / ms['tta=False fold_bn=False']:.3f}"
          f", folded / unfolded {ms['tta=False fold_bn=True'] / ms['tta=False fold_bn=False']:.4f}")

    big_w, big_h = INFER_FRAMES[-1][:2]
    big = next((n, s) for n, s in frames if s == (big_w, big_h))
    frame = torch.from_numpy(np.asarray(Image.open(os.path.join(
        imgs, big[0])).convert("L"), np.float32)[..., None] / 255.0).cuda()

    def fwd16(x):
        return nhwc_logits(trans, x, bf16=True)

    with torch.inference_mode():
        n0 = A.flash_forward_cuda.launches
        tiled = sliding_window_logits(fwd16, frame, window=INFER_WINDOW,
                                      stride=INFER_STRIDE,
                                      tile_batch=INFER_TILE_BATCH)
        n_tiled = A.flash_forward_cuda.launches - n0
        tiled_ms = median_ms(lambda: sliding_window_logits(
            fwd16, frame, window=INFER_WINDOW, stride=INFER_STRIDE,
            tile_batch=INFER_TILE_BATCH), runs=INFER_TIMED_RUNS)
    n_tiles = len(tile_coords(big_h, big_w, INFER_WINDOW, INFER_STRIDE)[2])
    phase("infer", f"sliding_window_logits of one {big_w}x{big_h} frame, "
          f"bf16, "
          f"{n_tiles} tiles at window {INFER_WINDOW} stride {INFER_STRIDE} "
          f"({n_tiled} flash launches): {tiled_ms:.3f} ms (CUDA events, "
          f"median of {INFER_TIMED_RUNS}); logits {tuple(tiled.shape)} "
          f"finite {bool(torch.isfinite(tiled).all())}")
    assert tiled.shape == (big_h, big_w, 1) and torch.isfinite(tiled).all()
    assert n_tiled == N_LAYERS * -(-n_tiles // INFER_TILE_BATCH)
    del trans, folded
    torch.cuda.empty_cache()
    phase("infer", f"phase wall time {time.perf_counter() - t0:.1f} s")
    return {"launches": launches, "cli": cli, "tta_logit_rel": rel,
            "fold": fold_rows, "bf16_agree": agree, "batch_ms": ms,
            "tiled_ms": tiled_ms, "tiles": n_tiles}


def _padded_batch(orig, size, jpeg=None):
    """The daemon's batch of one frame: PIL-bilinear resized to size^2, or,
    given the ``jpeg`` bytes the daemon decodes natively, their native
    decode (as ``/predict`` does without ``?overlay=1``); zero-padded to
    BATCH, uint8 (BATCH, size, size, 1)."""
    import numpy as np
    from PIL import Image

    x = np.zeros((BATCH, size, size, 1), np.uint8)
    if jpeg is not None:
        from ddti_tpu_torch.runtime.native import decode_jpeg_bytes

        x[0] = decode_jpeg_bytes(jpeg, size, size)[0]
    else:
        x[0, ..., 0] = np.asarray(orig.resize((size, size), Image.BILINEAR))
    return x


def infer_daemon(ckpt):
    """The daemon with --tta --fold_bn (bf16, the slice's TransUNet): /healthz
    reports both; INFER_DAEMON_POSTS frames POSTed one at a time (each its
    own zero-padded batch) come back as serve_body's masks of the same
    padded batch on the folded model, resized to the frame; one ?overlay=1
    answers the frame with the mask's contours, as _overlay_png draws
    them; 16 flash launches a batch (4 flips x 4 layers). The daemon's
    --threshold is the median TTA probability of the POSTed frames: at 0.5
    this random-weight model's TTA'd masks are empty, and an empty mask has
    no contour to draw."""
    import numpy as np
    import torch
    from PIL import Image

    from ddti_tpu_torch.cli import serve
    from ddti_tpu_torch.eval.tta import tta_probs
    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
    from ddti_tpu_torch.train.export import nhwc_logits, serve_body
    from ddti_tpu_torch.train.fold_bn import fold_batchnorm

    size = SLICE["image_size"]
    rng = np.random.default_rng(SEED + 4)
    posts = []  # (JPEG bytes, the frame as PIL decodes it)
    for i in range(INFER_DAEMON_POSTS):
        w, h = INFER_FRAMES[i % len(INFER_FRAMES)][:2]
        frame = make_frames(1, max(w, h), int(rng.integers(1 << 30)))[0]
        buf = io.BytesIO()
        Image.fromarray(frame[:h, :w], "L").save(buf, "JPEG")
        posts.append((buf.getvalue(),
                      Image.open(io.BytesIO(buf.getvalue())).convert("L")))
    folded = fold_batchnorm(load_checkpoint_into(
        ckpt, "TransUNet", blank_model("TransUNet", **SLICE)).cuda().eval())
    def fwd16(x):
        return nhwc_logits(folded, x, bf16=True)

    with torch.inference_mode():
        probs = torch.cat([tta_probs(fwd16, torch.from_numpy(
            _padded_batch(orig, size)[:1]).cuda().float() / 255.0)
            for _, orig in posts])
    threshold = f"{float(probs.median()):.6f}"

    args = serve.get_parser().parse_args(
        ["--checkpoint", ckpt, "--model_type", "TransUNet",
         "--base_filters", str(SLICE["base_filters"]),
         "--depth", str(SLICE["depth"]), "--image_size", str(size),
         "--batch_size", str(BATCH), "--bf16", "--tta", "--fold_bn",
         "--threshold", threshold, "--device", "cuda", "--port", "0"])
    server = serve.create_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.server_address[1]
        health = get_json(port, "/healthz")
        phase("infer", f"daemon --tta --fold_bn --threshold {threshold} "
              f"(the median TTA probability of the {len(posts)} frames): "
              f"/healthz {json.dumps(health)}")
        assert health["tta"] is True and health["fold_bn"] is True

        def served(x, orig):
            """serve_body's mask of the padded batch ``x``, resized to the
            frame as the daemon resizes it."""
            with torch.inference_mode():
                mask = serve_body(
                    folded, torch.from_numpy(x).cuda(), float(threshold),
                    compute_dtype=torch.bfloat16,
                    tta=True)[0, ..., 0].cpu().numpy()
            return np.asarray(Image.fromarray(mask * 255).resize(
                orig.size, Image.NEAREST))

        batches0 = server.batcher.n_batches
        answers, launches = [], 0
        for i, (body, orig) in enumerate(posts):
            # the daemon's launches alone, not the reference's below
            A.flash_forward_cuda.launches = 0
            status, headers, data, dt = post(port, body)
            launches += A.flash_forward_cuda.launches
            assert status == 200, (status, data[:200])
            got = np.frombuffer(data, np.uint8).reshape(
                int(headers["X-Height"]), int(headers["X-Width"]))
            # the frame as the daemon decoded it: natively where it can
            want = served(_padded_batch(
                orig, size, body if server.native_decode else None), orig)
            same = float((got == want).mean())
            fg = float((got > 0).mean())
            phase("infer", f"daemon POST {orig.size[0]}x{orig.size[1]} JPEG "
                  f"-> {got.shape} mask in {dt * 1e3:.1f} ms, equal to "
                  f"serve_body's on the same padded batch (decoded "
                  f"{'natively' if server.native_decode else 'by PIL'}) on "
                  f"{same:.6%} of pixels, foreground {fg:.4f}")
            assert got.shape == orig.size[::-1] and same == 1.0
            answers.append((abs(fg - 0.5), i, got))
        n_batches = server.batcher.n_batches - batches0
        # the overlay of the frame whose mask is the most mixed
        _, i, got = min(answers)
        body, orig = posts[i]
        status, headers, data, _ = post(port, body, "/predict?overlay=1")
        overlay = np.asarray(Image.open(io.BytesIO(data)))
        # an overlay request decodes with PIL: its mask is the PIL frame's
        want_o = serve._overlay_png(orig, served(_padded_batch(orig, size),
                                                 orig))
        red = int((overlay[..., 0] != overlay[..., 1]).sum()) \
            if overlay.ndim == 3 else 0
        phase("infer", f"daemon ?overlay=1 -> HTTP {status} "
              f"{headers.get('Content-Type')} {overlay.shape}, equal to "
              f"_overlay_png of the frame and its mask: "
              f"{bool(np.array_equal(overlay, want_o))} ({red} contour "
              f"pixels); {launches} flash launches for {n_batches} "
              f"batches (expected {INFER_FLIPS * N_LAYERS} a batch)")
        assert status == 200 and np.array_equal(overlay, want_o)
        assert overlay.shape == (*got.shape, 3) and red > 0
        assert n_batches == INFER_DAEMON_POSTS
        assert launches == INFER_FLIPS * N_LAYERS * n_batches
    finally:
        server.shutdown()
        server.close()
        thread.join(timeout=30)
    return launches


def _train_setup(size, batch, amp, seed=SEED, model_type="ResUNet",
                 model_kw=None, aug_kw=None, cfg_kw=None):
    """A full-width model on the card (the flagship ResUNet unless
    ``model_type`` / ``model_kw`` say otherwise), its train state and step,
    one synthetic batch and its draws: the default chain's, or with
    ``aug_kw`` the branches it enables (their fields drawn on the card);
    ``cfg_kw`` sets the step's options."""
    import torch

    from ddti_tpu_torch.core.config import Config
    from ddti_tpu_torch.data.augment import AugmentConfig, sample_draws
    from ddti_tpu_torch.data.dataset import synthetic_source
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.state import TrainState
    from ddti_tpu_torch.train.steps import make_train_step
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    if model_kw is None:
        model_kw = dict(base_filters=TRAIN["base_filters"],
                        depth=TRAIN["depth"])
    cfg = Config(image_size=size, store_size=size, batch_size=batch,
                 use_amp_autocast=amp, **(cfg_kw or {}))
    model = init_like_flax(create_model(model_type, **model_kw),
                           seed).to(DEVICE)
    src = synthetic_source(batch, (size, size), seed, device=DEVICE)
    images, masks = src.gather(list(range(batch)))
    aug = AugmentConfig(out_size=(size, size), **(aug_kw or {}))
    draws = sample_draws(torch.Generator().manual_seed(seed), batch, aug,
                         (size, size),
                         torch.Generator(device=DEVICE).manual_seed(seed)
                         ).to(DEVICE)
    state = TrainState(model, cfg.lr, 4, cfg.weight_decay)
    return model, state, make_train_step(cfg, aug), (images, masks, draws)


def step_kernel_vs_plain(model_type="ResUNet", model_kw=None, batch=16,
                         label="step"):
    """One float32 step from one state and batch through the kernel EDT and
    through the plain EDT (the boundary loss's EDT swapped explicitly);
    deterministic cuDNN so that only the EDT route differs. The flagship
    ResUNet unless ``model_type`` / ``model_kw`` say otherwise (a
    deep-supervision model's step carries its heads' term)."""
    import torch

    from ddti_tpu_torch.losses import losses
    from ddti_tpu_torch.ops import edt as E
    from ddti_tpu_torch.train.fold_bn import fold_pairs
    from ddti_tpu_torch.train.state import TrainState

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model, _, step, (images, masks, draws) = _train_setup(
        512, batch, False, model_type=model_type, model_kw=model_kw)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    try:
        for route in ("kernel", "plain"):
            model.load_state_dict(sd0)
            state = TrainState(model, 1e-5, 4)
            launched = E.edt_cuda.launches
            if route == "plain":
                losses.edt_batch = E.edt_reference
            m = step(state, images, masks, draws, None)
            torch.cuda.synchronize()
            assert (E.edt_cuda.launches - launched) == (route == "kernel")
            out[route] = (m.boundary.clone(), m.loss.clone(), {
                k: v.clone() for k, v in model.state_dict().items()})
    finally:
        losses.edt_batch = E.edt_batch
        torch.backends.cudnn.deterministic = False
    (bk, lk, pk), (bp, lp, pp) = out["kernel"], out["plain"]
    rel = max(((pk[k] - pp[k]).abs().max()
               / pp[k].abs().max().clamp(min=1e-30)).item() for k in pk)
    # a conv's bias that feeds a BatchNorm has no gradient in exact
    # arithmetic (the batch mean takes it out): its float gradient is
    # rounding noise or an exact zero, so it may keep its initial zeros
    still = {f"{conv}.bias" for conv, _ in fold_pairs(model, model_type)}
    moved = sum(not torch.equal(pk[k], sd0[k]) for k in pk if k not in still)
    want = len([k for k in pk if k not in still])
    phase(label, f"float32 {model_type} 512^2 batch {batch}: boundary "
          f"kernel {bk.item():.9g} plain {bp.item():.9g} (bit-equal "
          f"{torch.equal(bk, bp)}); loss kernel {lk.item():.9g} plain "
          f"{lp.item():.9g}; updated tensors {moved}/{want} (and "
          f"{len(pk) - want} biases ahead of a BatchNorm), max relative "
          f"difference {rel:.3e} (limit {STEP_PARAM_RTOL:g})")
    assert torch.equal(bk, bp), "kernel and plain boundary terms differ"
    assert rel <= STEP_PARAM_RTOL and moved == want
    del model, step, images, masks, out, pk, pp, sd0
    torch.cuda.empty_cache()


def zoo_steps():
    """step_kernel_vs_plain for each zoo model at ZOO_STEP_BATCH."""
    t0 = time.perf_counter()
    for model_type in ZOO:
        step_kernel_vs_plain(model_type, zoo_entry(model_type),
                             ZOO_STEP_BATCH, "zoo step")
    phase("zoo step", f"phase wall time {time.perf_counter() - t0:.1f} s")


def _plain_flash():
    """flash_attention with its kernels swapped for their plain versions
    (flash_forward_reference, flash_backward_reference) on any device."""
    import torch

    from ddti_tpu_torch.ops import attention as A

    class PlainFlash(torch.autograd.Function):
        @staticmethod
        def forward(ctx, q, k, v):
            o, lse = A.flash_forward_reference(q, k, v)
            ctx.save_for_backward(q, k, v, o, lse)
            return o

        @staticmethod
        def backward(ctx, do):
            q, k, v, o, lse = ctx.saved_tensors
            return A.flash_backward_reference(q, k, v, o, lse,
                                              do.contiguous().to(o.dtype))

    return PlainFlash.apply


def _flash_counts():
    from ddti_tpu_torch.ops import attention as A

    bwd = A.flash_backward_cuda
    return [A.flash_forward_cuda.launches, bwd.launches_dkdv, bwd.launches_dq]


def _normwise(a, b):
    """||a - b|| / ||b|| over every tensor of two same-keyed dicts."""
    num = sum(float(((a[k].double() - b[k].double()) ** 2).sum()) for k in b)
    den = sum(float((b[k].double() ** 2).sum()) for k in b)
    return (num / den) ** 0.5


def tstep_kernel_vs_plain():
    """One float32 TransUNet step from one state and batch through the
    flash kernels and through their plain versions (swapped explicitly);
    deterministic cuDNN so that only the attention route differs. Then one
    bf16 step at the default dropout 0.1, where the gate takes the plain
    attention."""
    import math

    import torch

    from ddti_tpu_torch.models import blocks
    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.train.state import TrainState

    size, batch = TTRAIN["image_size"], TTRAIN["batch_size"]
    kw = dict(TSLICE, image_size=size)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    model, _, step, (images, masks, draws) = _train_setup(
        size, batch, False, model_type="TransUNet", model_kw=kw)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    out = {}
    try:
        # the kernel route twice: its own run-to-run floor
        for route in ("kernel", "kernel again", "plain"):
            model.load_state_dict(sd0)
            state = TrainState(model, 1e-5, 4)
            before = _flash_counts()
            if route == "plain":
                blocks.flash_attention = _plain_flash()
            m = step(state, images, masks, draws, None)
            torch.cuda.synchronize()
            moved = [a - b for a, b in zip(_flash_counts(), before)]
            assert moved == [N_LAYERS * (route != "plain")] * 3, moved
            out[route] = (
                torch.stack([m.loss, m.bce, m.dice, m.focal,
                             m.boundary]).double(),
                {k: p.grad.clone() for k, p in model.named_parameters()},
                {k: v.clone() for k, v in model.state_dict().items()})
    finally:
        blocks.flash_attention = A.flash_attention
        torch.backends.cudnn.deterministic = False
    (tk, gk, pk), (tp, gp, pp) = out["kernel"], out["plain"]
    _, g2, p2 = out.pop("kernel again")
    term_rel = float(((tk - tp).abs() / tp.abs().clamp(min=1e-30)).max())
    grad_rel, param_rel = _normwise(gk, gp), _normwise(pk, pp)
    worst = max(gk, key=lambda k: _normwise({k: gk[k]}, {k: gp[k]}))
    phase("tstep", f"kernel route run twice: gradients normwise "
          f"{_normwise(gk, g2):.3e}, parameters {_normwise(pk, p2):.3e}; "
          f"kernels vs plain, the gradient furthest apart: {worst} "
          f"{_normwise({worst: gk[worst]}, {worst: gp[worst]}):.3e}")
    step_gap = max(float((pk[k] - pp[k]).abs().max()) for k in gk) / 1e-5
    n_moved = sum(not torch.equal(pk[k], sd0[k]) for k in pk)
    phase("tstep", f"float32 TransUNet {size}^2 batch {batch}, kernels vs "
          f"plain: loss terms kernel {tk.tolist()} plain {tp.tolist()}, max "
          f"relative difference {term_rel:.3e} (limit "
          f"{TSTEP_TERM_RTOL:g}); gradients normwise {grad_rel:.3e} (limit "
          f"{TSTEP_GRAD_RTOL:g}); updated tensors {n_moved}/{len(pk)}, "
          f"normwise {param_rel:.3e} (limit {TSTEP_PARAM_RTOL:g}), largest "
          f"parameter gap {step_gap:.3f} lr")
    assert term_rel <= TSTEP_TERM_RTOL, "kernel and plain loss terms differ"
    assert grad_rel <= TSTEP_GRAD_RTOL, "kernel and plain gradients differ"
    assert param_rel <= TSTEP_PARAM_RTOL and step_gap <= 2.001
    assert n_moved == len(pk)
    del model, step, images, masks, out, gk, gp, pk, pp, g2, p2, sd0
    torch.cuda.empty_cache()

    kw = {k: v for k, v in kw.items() if k != "dropout_rate"}  # 0.1
    _, state, step, (images, masks, draws) = _train_setup(
        size, batch, True, model_type="TransUNet", model_kw=kw)
    before = _flash_counts()
    m = step(state, images, masks, draws, None)
    torch.cuda.synchronize()
    terms = [float(t) for t in (m.loss, m.bce, m.dice, m.focal, m.boundary)]
    phase("tstep", f"bf16 TransUNet step at the default dropout 0.1: flash "
          f"launches {[a - b for a, b in zip(_flash_counts(), before)]} "
          f"(the gate takes the plain attention with probability dropout), "
          f"terms {terms}")
    assert _flash_counts() == before, "a flash kernel ran with dropout"
    assert all(math.isfinite(t) for t in terms) and terms[4] > 0
    del state, step, images, masks
    torch.cuda.empty_cache()


def _profile_steps(label, size, batch, model_type="ResUNet", model_kw=None,
                   dtype="bfloat16"):
    """Device time per train step in ``dtype`` (bf16 autocast, or float32
    with TF32 off; CUDA events) and a torch.profiler window over
    TRAIN_PROFILE_STEPS steps: busy share, the EDT's and the flash kernels'
    share, the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ddti_tpu_torch.ops import edt as E

    _, state, step, (images, masks, draws) = _train_setup(
        size, batch, dtype == "bfloat16", model_type=model_type,
        model_kw=model_kw)

    def one():
        step(state, images, masks, draws, None)

    ms = median_ms(one, runs=STEP_RUNS, warmup=STEP_WARMUP)
    torch.cuda.synchronize()
    before = [E.edt_cuda.launches, *_flash_counts()]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(BUSY_WINDOW):
            for _ in range(TRAIN_PROFILE_STEPS):
                one()
            torch.cuda.synchronize()
    busy = device_busy(prof)
    window_us = busy["window_us"]
    launched = [a - b for a, b in zip([E.edt_cuda.launches,
                                       *_flash_counts()], before)]
    kernels = device_kernels(prof)
    kernel_us = sum(e.self_device_time_total for e in kernels)
    edt_us = sum(e.self_device_time_total for e in kernels
                 if "edt_" in e.key)
    flash_us = sum(e.self_device_time_total for e in kernels
                   if "flash_" in e.key)
    phase("tprofile", f"{label}: {dtype} train step {size}^2 batch {batch}: "
          f"{ms:.3f} ms device time (CUDA events, median of "
          f"{STEP_RUNS}), {batch / ms * 1e3:.1f} img/s; torch.profiler over "
          f"{TRAIN_PROFILE_STEPS} steps: device kernels "
          f"{kernel_us / 1e3:.3f} ms, {busy_text(busy)}, EDT kernels "
          f"{edt_us / 1e3:.3f} ms ({edt_us / max(kernel_us, 1):.2%} of "
          f"kernel time), flash kernels {flash_us / 1e3:.3f} ms "
          f"({flash_us / max(kernel_us, 1):.2%}); launches edt/flash_fwd/"
          f"flash_bwd_dkdv/flash_bwd_dq {launched}")
    if not kernels:
        phase("tprofile", "no device time recorded: breakdown not measured")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[
            :PROFILE_TOP]:
        phase("tprofile", f"{e.self_device_time_total / kernel_us:6.1%} "
              f"{e.count:4d} x "
              f"{e.self_device_time_total / e.count / 1e3:.4f} ms  "
              f"{e.key[:90]}")
    del state, step, images, masks, prof
    torch.cuda.empty_cache()
    return dict(model=label, dtype=dtype, size=size, batch=batch, ms=ms,
                busy=busy["union_us"] / max(window_us, 1),
                edt_share=edt_us / max(kernel_us, 1),
                flash_share=flash_us / max(kernel_us, 1))


def profile_training():
    """The ResUNet train step at TRAIN_PROFILES."""
    return [_profile_steps("ResUNet bf64 d5", size, batch)
            for size, batch in TRAIN_PROFILES]


def profile_zoo(profiles):
    """Each zoo model's bf16 train step at ``profiles``, (model, image
    size, batch) triples (``--zoo`` alone)."""
    t0 = time.perf_counter()
    rows = [_profile_steps(f"{model_type} bf64 d5", size, batch, model_type,
                           zoo_entry(model_type))
            for model_type, size, batch in profiles]
    phase("zoo profile", f"phase wall time {time.perf_counter() - t0:.1f} s")
    return rows


def profile_transunet(full=True):
    """The TransUNet train step on the kernel and the plain attention path:
    the slice's model at S = 1024, and the S = 4096 one at the largest
    batch of TLONG_BATCHES whose plain path fits in device memory, in bf16;
    then in float32 (the training CLI's default dtype) the slice's model on
    both paths and the S = 4096 one on the kernel path at that batch.
    Without ``full`` (the whole run) only the S = 4096 model's three rows:
    the S = 1024 model's steps are the tstep phase's and the CLI's."""
    import gc

    import torch

    size, batch = TTRAIN["image_size"], TTRAIN["batch_size"]
    rows = []
    for path, flash in (("kernel", None), ("plain", False)) if full else ():
        kw = dict(TSLICE, image_size=size, use_flash_attention=flash)
        rows.append(_profile_steps(f"TransUNet bf64 d4 S=1024 {path}", size,
                                   batch, "TransUNet", kw))
    kw = dict(TLONG, image_size=size)
    for batch in TLONG_BATCHES:
        try:
            plain = _profile_steps(
                "TransUNet bf32 d3 S=4096 plain", size, batch, "TransUNet",
                dict(kw, use_flash_attention=False))
            break
        except torch.cuda.OutOfMemoryError:
            phase("tprofile", f"TransUNet bf32 d3 S=4096 plain path at "
                  f"batch {batch}: out of device memory, halving")
        gc.collect()
        torch.cuda.empty_cache()
    rows.append(_profile_steps("TransUNet bf32 d3 S=4096 kernel", size,
                               batch, "TransUNet", kw))
    rows.append(plain)
    for path, flash in (("kernel", None), ("plain", False)) if full else ():
        rows.append(_profile_steps(
            f"TransUNet bf64 d4 S=1024 {path}", size, TTRAIN["batch_size"],
            "TransUNet", dict(TSLICE, image_size=size,
                              use_flash_attention=flash), "float32"))
    rows.append(_profile_steps("TransUNet bf32 d3 S=4096 kernel", size,
                               batch, "TransUNet", kw, "float32"))
    return rows


def ab_probes():
    """The conv3x3 and gather kernels' queued times at the probes' shapes,
    beside cuDNN's and torch.gather's; exp2_probe's in every mode beside
    torch.exp2's and Tensor.copy_'s; and the EDT's queued time with its
    column and row passes at the EDT_TIMED shapes; all with the tree that
    is imported: {"conv": {ms, library_ms}, "gather": {builder: {ms,
    library_ms}}, "exp2": {modes: {mode: {ms, ...}}, library_ms}, "edt":
    [{shape, queued_ms, column_ms, row_ms}]}."""
    from ddti_tpu_torch.probes import exp2_probe as E2
    from ddti_tpu_torch.probes import gather_probe as G
    from ddti_tpu_torch.probes import gather_probe2 as G2
    from ddti_tpu_torch.probes import gather_probe3 as G3
    from ddti_tpu_torch.probes import pallas_conv_probe as P

    conv = P.run(seed=SEED)
    rows = {}
    for mod in (G, G2, G3):
        rows.update(mod.run(seed=SEED))
    keep = ("ms", "library_ms", "match")
    e2 = E2.run(seed=SEED)
    edt = [dict(shape=list(shape), **edt_times(shape, SEED + i))
           for i, shape in enumerate(EDT_SHAPES[:EDT_TIMED])]
    for r in edt:
        phase("ab", f"edt {tuple(r['shape'])}: queued {r['queued_ms']:.4f} "
              f"ms, column {r['column_ms']}, row {r['row_ms']}")
    return dict(conv={k: conv[k] for k in keep[:2]},
                gather={k: {f: r[f] for f in keep if f in r}
                        for k, r in rows.items() if "torch_call" not in r},
                exp2=dict(modes=e2["modes"], library_ms=e2["library_ms"]),
                edt=edt)


def ab_serve():
    """The slice's TransUNet (random weights, seed SEED) serving one bf16
    batch of BATCH frames through make_serve_fn, with the tree that is
    imported: device ms (CUDA events, median of 20) and torch.profiler's
    top kernels over PROFILE_BATCHES batches: {"ms", "top": [[share,
    kernel], ...]}."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.export import make_serve_fn

    model = create_model("TransUNet", **SLICE)
    model.load_state_dict(random_state(model, SEED))
    serve = make_serve_fn(model.cuda(), compute_dtype=torch.bfloat16)
    x = torch.from_numpy(np.stack(make_frames(
        BATCH, SLICE["image_size"], SEED + 1))[..., None]).cuda()
    ms = median_ms(lambda: serve(x))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_BATCHES):
            serve(x)
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    busy = sum(e.self_device_time_total for e in kernels) or 1.0
    top = [[round(e.self_device_time_total / busy, 4), e.key[:90]]
           for e in sorted(kernels, key=lambda e: -e.self_device_time_total)
           [:PROFILE_TOP]]
    phase("ab", f"bf16 serving batch of {BATCH}: {ms:.3f} ms; top "
          + "; ".join(f"{a:.1%} {k[:60]}" for a, k in top[:4]))
    return dict(ms=ms, top=top)


def ab_side(tree, which=None):
    """One side of a same-card comparison of two trees: kernel_phases() and
    the TransUNet train steps on the kernel path (float32, the training
    CLI's default, then bf16; S = 1024 at batch 16 and S = 4096 at batch 8)
    and the conv3x3 and gather probes (ab_probes); with ``which`` "probes"
    the probes alone, with "serve" the serving batch alone (ab_serve); with
    ``tree``'s ddti_tpu_torch and this file's measurements. Prints one line
    "[ab] {json}"."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ddti_tpu_torch.ops import _build

    _build.build()
    _build.load_library()
    if which in ("probes", "serve"):
        got = ab_probes() if which == "probes" else ab_serve()
        print("[ab] " + json.dumps({"tree": tree, "source": _build.__file__,
                                    which: got}), flush=True)
        return
    fwd, bwd, _ = kernel_phases()
    size = TTRAIN["image_size"]
    steps = [_profile_steps(f"{label} {tree}", size, batch, "TransUNet",
                            dict(kw, image_size=size), dt)
             for dt in ("float32", "bfloat16")
             for label, batch, kw in (("S=1024", TTRAIN["batch_size"], TSLICE),
                                      ("S=4096", 8, TLONG))]
    print("[ab] " + json.dumps(dict(tree=tree, source=_build.__file__,
                                    fwd=fwd, bwd=bwd, steps=steps,
                                    probes=ab_probes())),
          flush=True)


def ab(parent, *which):
    """Compare the tree at ``parent`` (another commit unpacked, e.g. with
    git archive) with this one on one card, in the order parent, this, this,
    parent, each side in its own process (ab_side); ``which`` = ("probes",)
    compares the probes and the EDT alone (ab_probes), ("serve",) the bf16
    serving batch alone (ab_serve)."""
    for tree in (parent, ".", ".", parent):
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--ab-side", tree, *which], check=True)


def _near_integer(t):
    """Where a float32 coordinate lies within RECIPE_TIE of an integer."""
    t = t.double()
    return (t - t.round()).abs() < RECIPE_TIE


def _recipe_frames(n, size, seed=SEED):
    """A synthetic batch as float32 (N, H, W) in [0, 1], on the CPU."""
    import torch

    from ddti_tpu_torch.data.synthetic import generate_ddti_like

    imgs, masks = generate_ddti_like(n, (size, size), seed)
    return (torch.from_numpy(imgs[..., 0]).float() / 255.0,
            torch.from_numpy(masks[..., 0]).float() / 255.0)


def _chain_ties(draws, size):
    """(N, H, W) bool, at the chain's output: the exact warp's ties (a
    source coordinate within RECIPE_TIE of an integer) and the elastic
    mask sample's ties, carried to the output by the same warp. Computed
    on the CPU from the draws."""
    import torch

    from ddti_tpu_torch.ops import resample as R

    n = draws.flip_h.shape[0]
    xs, ys = R._source_coords(draws.angle, size, size)
    xs = torch.where(draws.flip_h[:, None, None], size - xs, xs)
    ys = torch.where(draws.flip_v[:, None, None], size - ys, ys)
    ties = _near_integer(xs) | _near_integer(ys)
    el = torch.zeros(n, size, size)
    idx = draws.elastic_idx
    if len(idx):
        a = draws.elastic_alpha[idx][:, None, None]
        dx = R.gaussian_blur_17(draws.elastic_dx, draws.elastic_sigma[idx]) * a
        dy = R.gaussian_blur_17(draws.elastic_dy, draws.elastic_sigma[idx]) * a
        yy = torch.arange(size, dtype=torch.float32)[:, None]
        xx = torch.arange(size, dtype=torch.float32)[None, :]
        el[idx] = (_near_integer(yy + dy + 0.5)
                   | _near_integer(xx + dx + 0.5)).float()
    moved, _ = R.fused_flip_rotate(el, el, draws.flip_h, draws.flip_v,
                                   draws.angle)
    return ties | (moved > 0)


def recipe_card_vs_cpu():
    """augment_batch with every branch on (the exact warp, whose ties are
    countable pixel by pixel), on the card and on the CPU from the same
    draws, at both TRAIN_PROFILES. Up to CLAHE: masks equal but at ties,
    at most RECIPE_TIE_SHARE of the pixels; images within RECIPE_TOL but
    there; CLAHE's uint8 inputs equal but where a value lies within
    RECIPE_TOL of a rounding boundary. clahe_u8 bit for bit on the same
    uint8 frames, and the whole chain on the card bit-equal to its
    pre-CLAHE frames through clahe_float. The Paeth warp bit for bit in
    every image whose shear shifts agree."""
    import dataclasses

    import torch

    from ddti_tpu_torch.data.augment import (
        AugmentConfig,
        augment_batch,
        sample_draws,
    )
    from ddti_tpu_torch.ops import resample as R
    from ddti_tpu_torch.ops.clahe import clahe_float, clahe_u8

    rows = []
    for size, n in TRAIN_PROFILES:
        t0 = time.perf_counter()
        img, mask = _recipe_frames(n, size)
        cfg = AugmentConfig(out_size=(size, size), fast_warp=False,
                            **RECIPE_ALL)
        pre_cfg = dataclasses.replace(cfg, use_clahe=False)
        draws = sample_draws(torch.Generator().manual_seed(SEED), n, cfg,
                             (size, size))
        gdraws = draws.to(DEVICE)
        x, y = img[..., None], mask[..., None]
        ci, cm = (t[..., 0] for t in augment_batch(x, y, draws, pre_cfg))
        gi, gm = (t[..., 0] for t in augment_batch(
            x.to(DEVICE), y.to(DEVICE), gdraws, pre_cfg))
        full, _ = augment_batch(x.to(DEVICE), y.to(DEVICE), gdraws, cfg)
        idx = gdraws.clahe_idx
        want = gi.index_copy(0, idx, clahe_float(gi[idx]))
        full_equal = torch.equal(full[..., 0], want)
        gi, gm = gi.cpu(), gm.cpu()
        ties = _chain_ties(draws, size)
        tol = RECIPE_TOL * max(size / RECIPE_TOL_SIZE, 1.0)
        dm = cm != gm
        di = (ci - gi).abs() > tol
        uc = torch.clamp(torch.round(ci * 255.0), 0, 255).to(torch.uint8)
        ug = torch.clamp(torch.round(gi * 255.0), 0, 255).to(torch.uint8)
        edge = ((ci * 255.0 - torch.floor(ci * 255.0) - 0.5).abs()
                < 255 * tol)
        du = uc != ug
        cl_equal = torch.equal(clahe_u8(uc), clahe_u8(uc.to(DEVICE)).cpu())
        k4c, sxc, syc = R.paeth_shifts(draws.angle, size)
        k4g, sxg, syg = (t.cpu() for t in R.paeth_shifts(
            draws.angle.to(DEVICE), size))
        same = ((sxc == sxg).all(1) & (syc == syg).all(1) & (k4c == k4g))
        pc = R.paeth_flip_rotate(img, mask, draws.flip_h, draws.flip_v,
                                 draws.angle)
        pg = R.paeth_flip_rotate(img.to(DEVICE), mask.to(DEVICE),
                                 draws.flip_h.to(DEVICE),
                                 draws.flip_v.to(DEVICE),
                                 draws.angle.to(DEVICE))
        paeth_ok = all(torch.equal(a[same], b.cpu()[same])
                       for a, b in zip(pc, pg))
        row = dict(
            shape=[n, size, size], tol=tol, tie_pixels=int(ties.sum()),
            mask_pixels_off=int(dm.sum()), image_pixels_off=int(di.sum()),
            max_abs_err=float((ci - gi).abs().max()),
            max_abs_err_off_ties=float(((ci - gi).abs() * (~ties)).max()),
            clahe_inputs_off=int(du.sum()), clahe_images=len(idx),
            clahe_bit_equal=cl_equal, chain_with_clahe_equal=full_equal,
            paeth_images_with_other_shifts=int((~same).sum()),
            seconds=round(time.perf_counter() - t0, 1))
        phase("recipe", f"card vs CPU, every branch, exact warp, {n} x "
              f"{size}^2: {json.dumps(row)}")
        assert not (dm & ~ties).any(), "a mask pixel off a tie differs"
        assert dm.sum() <= RECIPE_TIE_SHARE * dm.numel(), int(dm.sum())
        assert not (di & ~ties).any(), "an image pixel off a tie differs"
        assert not (du & ~ties & ~edge).any(), "a CLAHE input differs"
        assert cl_equal, "clahe_u8 differs between the card and the CPU"
        assert full_equal, "the chain's CLAHE is not clahe_float's"
        assert paeth_ok, "the Paeth warp differs where its shifts agree"
        rows.append(row)
    return rows


def _recipe_flags():
    """test.sh's flags (the CLI's default ResUNet, bf64 d5, spelled out)."""
    return ["--device", DEVICE, f"--base_filters={TRAIN['base_filters']}",
            f"--depth={TRAIN['depth']}",
            *(f"--{k}={v}" for k, v in RECIPE_TRAIN.items()
              if k != "epochs")]


def run_recipe_cli(tmp):
    """test.sh's six ablation commands (and one with every train-step
    option) through the port's CLI on the card, RECIPE_PARALLEL at a time:
    run_cli's checks, exactly the expected EDT launches (grad_accum k: k a
    train step), and under --freeze --freeze_bn_stats the frozen tensors of
    both saved .npz bit-equal to the seeded initial weights."""
    import numpy as np

    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.torch_interop import flat_flax_from_state_dict
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    t0 = time.perf_counter()
    try:
        import cv2
        phase("recipe", f"import cv2: {cv2.__version__}")
    except Exception as e:  # the host oracle chain needs it
        phase("recipe", f"import cv2: {type(e).__name__}: {e}")
    steps, val, test_b = _cli_batches(RECIPE_TRAIN["batch_size"])
    epochs = RECIPE_TRAIN["epochs"]
    model_kw = dict(base_filters=TRAIN["base_filters"], depth=TRAIN["depth"])
    keys = jax_resunet_keys(TRAIN["depth"])
    runs = {**RECIPE_SETTINGS, "options": RECIPE_OPTIONS}

    def train(name):
        flags = [*_recipe_flags(), *runs[name]]
        got, best = run_cli(tmp, f"recipe {name}", "ResUNet", model_kw,
                            flags, epochs, keys)
        accum = 2 if name == "options" else 1
        expected = epochs * (accum * steps + val) + test_b
        phase("recipe", f"{name}: edt_minplus launches "
              f"{got['edt_minplus']}, expected {epochs} epoch x "
              f"({accum} x {steps} train + {val} val steps) + {test_b} test "
              f"batches = {expected}")
        assert got["edt_minplus"] == expected
        return got["edt_minplus"], best

    with concurrent.futures.ThreadPoolExecutor(RECIPE_PARALLEL) as pool:
        done = dict(zip(runs, pool.map(train, runs)))
    init = flat_flax_from_state_dict("ResUNet", init_like_flax(
        create_model("ResUNet", **model_kw), CLI_SEED).state_dict())
    frozen = [k for k in init if k.split("/")[1] == "encoders_0"]
    for which in ("best", "last"):
        path = done["options"][1][:-len("best")] + which + ".npz"
        with np.load(path) as z:
            for k in frozen:
                assert np.array_equal(z[k], init[k]), (which, k)
            moved = not np.array_equal(z["params/final_conv/kernel"],
                                       init["params/final_conv/kernel"])
        assert moved, f"{which}: the trainable weights did not move"
    phase("recipe", f"options: the {len(frozen)} frozen tensors of "
          f"encoders_0 (parameters and, pinned, BatchNorm statistics) "
          f"bit-equal to the initial weights in the best and last .npz; "
          f"phase wall time {time.perf_counter() - t0:.1f} s "
          f"({RECIPE_PARALLEL} runs at a time)")
    return {name: n for name, (n, _) in done.items()}


def _flat_grads(model):
    import torch

    return torch.cat([p.grad.reshape(-1) for p in model.parameters()])


def recipe_remat():
    """One float32 step at 512^2 / batch 16 without remat, with --remat
    and with --remat 0,1, from one state and batch, deterministic cuDNN:
    loss and gradients within REMAT_RTOL normwise of the plain step,
    running statistics equal, and the peak of allocated memory lower."""
    import torch

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    size, batch = TRAIN_PROFILES[0]
    out = {}
    try:
        for remat in (False, True, (0, 1)):
            model, state, step, (images, masks, draws) = _train_setup(
                size, batch, False, model_kw=dict(
                    base_filters=TRAIN["base_filters"], depth=TRAIN["depth"],
                    remat=remat))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            before = torch.cuda.memory_allocated()
            m = step(state, images, masks, draws, None)
            torch.cuda.synchronize()
            out[remat] = (m.loss.item(), _flat_grads(model).clone(),
                          {k: b.clone() for k, b in model.named_buffers()},
                          torch.cuda.max_memory_allocated(), before)
            del model, state, step, images, masks, draws, m
            torch.cuda.empty_cache()
    finally:
        torch.backends.cudnn.deterministic = False
    loss0, g0, b0, peak0, base0 = out[False]
    rows = {}
    for remat in (True, (0, 1)):
        loss, g, b, peak, base = out[remat]
        rel = ((g - g0).norm() / g0.norm()).item()
        equal = all(torch.equal(b[k], b0[k]) for k in b0)
        label = "all levels" if remat is True else f"levels {remat}"
        rows[label] = dict(loss=loss, loss_plain=loss0, grad_rel=rel,
                           stats_equal=equal, step_gib=(peak - base) / 2**30,
                           plain_step_gib=(peak0 - base0) / 2**30,
                           peak_gib=peak / 2**30, plain_peak_gib=peak0 / 2**30)
        phase("recipe", f"remat {label}: float32 {batch} x {size}^2 step "
              f"loss {loss:.9g} (plain {loss0:.9g}), gradients normwise "
              f"{rel:.3e} (limit {REMAT_RTOL:g}), running statistics equal "
              f"{equal}; peak allocated above the step's start "
              f"{(peak - base) / 2**30:.3f} GiB, plain "
              f"{(peak0 - base0) / 2**30:.3f} GiB (peaks {peak / 2**30:.3f} "
              f"and {peak0 / 2**30:.3f} GiB)")
        assert abs(loss - loss0) <= REMAT_RTOL * abs(loss0)
        assert rel <= REMAT_RTOL and equal
        assert peak - base < peak0 - base0, "remat did not lower the peak"
    return rows


def profile_recipe():
    """Device time per bf16 train step (CUDA events, median of STEP_RUNS) at both
    TRAIN_PROFILES with the default chain, each branch alone, all of them,
    --remat (one model a size, and one with remat), and with the default
    chain --freeze encoders, alone (the frozen tensors out of autograd)
    and with --nan_guard (their gradients computed for its check); beside
    each, augment_batch's own time and its share of the step."""
    import torch

    from ddti_tpu_torch.core.config import Config
    from ddti_tpu_torch.data.augment import (
        AugmentConfig,
        augment_batch,
        sample_draws,
    )
    from ddti_tpu_torch.train.state import TrainState
    from ddti_tpu_torch.train.steps import _to_float, make_train_step

    rows = []
    configs = [("default", {}), *RECIPE_BRANCHES.items(),
               ("all branches", RECIPE_ALL)]
    for size, batch in TRAIN_PROFILES:
        for remat in (False, True):
            model, state, _, (images, masks, _) = _train_setup(
                size, batch, True, model_kw=dict(
                    base_filters=TRAIN["base_filters"], depth=TRAIN["depth"],
                    remat=remat))
            x, y = _to_float(images, masks)
            # (label, branches, --nan_guard under --freeze or None)
            runs = [(label, aug_kw, None) for label, aug_kw in configs] + [
                (f"--freeze {RECIPE_FREEZE}", {}, False),
                (f"--freeze {RECIPE_FREEZE} --nan_guard", {}, True)]
            if remat:
                runs = [("remat (all levels)", {}, None)]
            for label, aug_kw, nan_guard in runs:
                cfg = Config(image_size=size, store_size=size,
                             batch_size=batch, use_amp_autocast=True,
                             nan_guard=bool(nan_guard))
                if nan_guard is not None:
                    state = TrainState(
                        model, cfg.lr, 4, cfg.weight_decay,
                        model_type=TRAIN["model_type"],
                        freeze=(RECIPE_FREEZE,), nan_guard=nan_guard)
                aug = AugmentConfig(out_size=(size, size), **aug_kw)
                draws = sample_draws(
                    torch.Generator().manual_seed(SEED), batch, aug,
                    (size, size),
                    torch.Generator(device=DEVICE).manual_seed(SEED)
                ).to(DEVICE)
                step = make_train_step(cfg, aug)
                ms = median_ms(lambda: step(state, images, masks, draws,
                                            None), runs=STEP_RUNS,
                               warmup=STEP_WARMUP)
                aug_ms = median_ms(lambda: augment_batch(x, y, draws, aug),
                                   runs=STEP_RUNS, warmup=STEP_WARMUP)
                if nan_guard is not None:  # frozen gradients only for it
                    assert all((p.grad is None) != nan_guard
                               for k, p in model.named_parameters()
                               if k in state.frozen)
                rows.append(dict(config=label, size=size, batch=batch, ms=ms,
                                 augment_ms=aug_ms,
                                 augment_share=aug_ms / ms))
                phase("recipe", f"bf16 train step {size}^2 batch {batch}, "
                      f"{label}: {ms:.3f} ms (CUDA events, median of "
                      f"{STEP_RUNS}), "
                      f"augment_batch alone {aug_ms:.3f} ms "
                      f"({aug_ms / ms:.1%} of the step)")
            del model, state, images, masks, draws, step, x, y
            torch.cuda.empty_cache()
    return rows


def run_recipe(tmp, profile=False):
    """The recipe phase: card vs CPU, the CLI runs, remat, and with
    ``profile`` (``--recipe`` alone) the step timings."""
    t0 = time.perf_counter()
    out = dict(card_vs_cpu=recipe_card_vs_cpu(),
               cli_launches=run_recipe_cli(tmp), remat=recipe_remat())
    if profile:
        out["steps"] = profile_recipe()
    phase("recipe", f"phase wall time {time.perf_counter() - t0:.1f} s")
    return out


def lifecycle_cmd(base, *extra):
    """The lifecycle phase's CLI command: the flagship ResUNet at TRAIN's
    size, LIFECYCLE_EPOCHS epochs, LIFECYCLE_FLAGS, bf16."""
    return [sys.executable, "-m", "ddti_tpu_torch.cli.main", "--mode",
            "both", "--synthetic", "--use_amp_autocast", "true",
            "--device", DEVICE, "--base_dir", base, "--model_type", "ResUNet",
            f"--epochs={LIFECYCLE_EPOCHS}",
            *(f"--{k}={v}" for k, v in TRAIN.items()
              if k not in ("model_type", "epochs")),
            *LIFECYCLE_FLAGS, *extra]


def parse_lifecycle_log(text):
    """What the lifecycle phase reads from a CLI run's output: the
    [KERNELS] counts, the tuned threshold, the grids' frames and
    seconds, the resume line's epoch and step, and the epochs trained."""
    import re

    out = {"epochs": [int(e) for e in
                      re.findall(r"Train Epoch: (\d+), Avg Loss", text)]}
    k = re.search(r"^\[KERNELS\] (.*)$", text, re.M)
    if k:
        out["kernels"] = {a: int(b) for a, b in
                          (kv.split("=") for kv in k.group(1).split())}
    t = re.search(r"Threshold sweep \(val IoU\): .* -> using ([\d.]+)$",
                  text, re.M)
    if t:
        out["threshold"] = float(t.group(1))
    g = re.search(r"Contour grids: (\d+) frames in ([\d.]+) s", text)
    if g:
        out["grid_frames"], out["grid_s"] = int(g.group(1)), float(
            g.group(2))
    r = re.search(r"Resuming at epoch (\d+)/(\d+) \(restored step (\d+)\)",
                  text)
    if r:
        out["resumed_epoch"], out["resumed_step"] = int(r.group(1)), int(
            r.group(3))
    return out


def _lifecycle_run(base, name, *extra, preempt=False, env=None):
    """One lifecycle CLI run in its own process, stdout and stderr
    together; with ``preempt`` SIGTERM once the log shows epoch 2's first
    step. Returns (exit code, output, wall seconds, run directory)."""
    import signal

    os.makedirs(base)
    cmd = lifecycle_cmd(base, *extra)
    phase("lifecycle", f"{name}: {' '.join(cmd[1:])}")
    t0 = time.perf_counter()
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         env=dict(os.environ, **(env or {})))
    try:
        seen = []
        if preempt:
            for line in p.stdout:
                seen.append(line)
                if "Epoch 2 step 1:" in line:
                    p.send_signal(signal.SIGTERM)
                    phase("lifecycle", f"{name}: SIGTERM at "
                          f"{time.perf_counter() - t0:.1f} s")
                    break
        out = "".join(seen) + p.communicate(timeout=TRAIN_TIMEOUT_S)[0]
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    wall = time.perf_counter() - t0
    (run,) = os.listdir(base)
    phase("lifecycle", f"{name}: exit {p.returncode} in {wall:.1f} s")
    if p.returncode not in (0, 75):
        print(out[-8000:], file=sys.stderr)
    return p.returncode, out, wall, os.path.join(base, run)


def _check_full_run(name, rc, out, run, epochs):
    """A completed lifecycle run: exit 0, the epochs it trained, the
    periodic directories [2, 3], the tuned threshold in
    test_metrics.json, a decodable test_boundaries_0.png, the full
    states, and exactly one EDT launch a train and val step and a test
    batch. Returns what parse_lifecycle_log read."""
    from PIL import Image

    from ddti_tpu_torch.train.checkpoint import is_full_state

    assert rc == 0, f"{name}: the CLI failed"
    got = parse_lifecycle_log(out)
    assert got["epochs"] == epochs, (name, got["epochs"])
    models = os.path.join(run, "models")
    periodic = sorted(os.listdir(os.path.join(models, "periodic")))
    assert periodic == ["2", "3"], (name, periodic)
    for d in ("ResUNet_last", "ResUNet_best", "periodic/2", "periodic/3"):
        assert is_full_state(os.path.join(models, d)), (name, d)
    with open(os.path.join(run, "result", "test_metrics.json")) as f:
        test = json.load(f)
    grid = [round(0.05 * i, 2) for i in range(1, 20)]
    assert test["threshold"] == got["threshold"] and \
        got["threshold"] in grid, (name, test["threshold"], got)
    with Image.open(os.path.join(run, "result",
                                 "test_boundaries_0.png")) as im:
        im.load()
        size = im.size
    steps, val, test_b = _cli_batches(TRAIN["batch_size"])
    # (a rehearsal on the CPU launches no kernel)
    expected = (len(epochs) * (steps + val) + test_b) * (DEVICE != "cpu")
    assert got["kernels"]["edt_minplus"] == expected, (name, got["kernels"])
    phase("lifecycle", f"{name}: epochs {epochs}, periodic {periodic}, "
          f"tuned threshold {got['threshold']} in test_metrics.json, "
          f"test_boundaries_0.png {size[0]}x{size[1]} "
          f"({got['grid_frames']} frames in {got['grid_s']:.3f} s, "
          f"{got['grid_s'] / got['grid_frames']:.3f} s a frame), "
          f"edt_minplus launches {got['kernels']['edt_minplus']} = "
          f"{len(epochs)} x ({steps} train + {val} val) + {test_b} test")
    return got


def _sync():
    import torch

    if DEVICE != "cpu":
        torch.cuda.synchronize()


def _flagship_state(ema=True):
    """A flagship ResUNet's TrainState on the card, as the CLI makes it
    (weights from CLI_SEED, the synthetic split's 4 steps an epoch)."""
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.state import TrainState
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    model = init_like_flax(create_model(
        "ResUNet", base_filters=TRAIN["base_filters"], depth=TRAIN["depth"]),
        CLI_SEED).to(DEVICE)
    return TrainState(model, 1e-5, _cli_batches(TRAIN["batch_size"])[0],
                      model_type="ResUNet", ema=ema)


def lifecycle_restore(last, tmp):
    """The preempted run's ``_last`` restored on the card, held bit for bit
    to the file (every parameter, statistic, AdamW moment and step, EMA
    tensor, and the step); the full state's bytes and save time; then one
    float32 step from it with the kernel EDT and with the plain EDT (as
    step_kernel_vs_plain): bit-equal boundary terms."""
    import torch

    from ddti_tpu_torch.losses import losses
    from ddti_tpu_torch.ops import edt as E
    from ddti_tpu_torch.train import checkpoint as ck

    tree = ck.read_checkpoint(last)
    state = ck.restore_checkpoint(last, _flagship_state())
    got = ck.to_host(state.full_state_dict())
    n = 0

    def same(a, b, where):
        nonlocal n
        assert a.keys() == b.keys(), where
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k], f"{where}/{k}")
            elif isinstance(a[k], torch.Tensor):
                assert a[k].dtype == b[k].dtype and torch.equal(
                    a[k], b[k]), f"{where}/{k}"
                n += 1
            else:
                assert a[k] == b[k], f"{where}/{k}"

    same(got, {k: v for k, v in tree.items() if k != "format"}, "")
    steps = _cli_batches(TRAIN["batch_size"])[0]
    assert got["step"] // steps == 1, got["step"]  # saved in epoch 2
    nbytes = os.path.getsize(os.path.join(last, ck.STATE_FILE))
    _sync()
    t0 = time.perf_counter()
    ck.save_checkpoint(os.path.join(tmp, "resaved"), state)
    save_s = time.perf_counter() - t0
    phase("lifecycle", f"restored {last} on the card: {n} tensors (model "
          f"{len(tree['model'])}, AdamW {sum(len(v) for v in tree['adam'].values())}, "
          f"EMA {len(tree['ema'])}) and the step {got['step']} bit-equal "
          f"to the file; full state {nbytes} bytes, saved from the card "
          f"in {save_s:.3f} s ({nbytes / save_s / 1e9:.3f} GB/s)")

    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    _, _, step, (images, masks, draws) = _train_setup(
        TRAIN["image_size"], TRAIN["batch_size"], False,
        cfg_kw=dict(ema_decay=0.999))
    out = {}
    try:
        for route in ("kernel", "plain"):
            state.load_full_state_dict(tree)
            launched = E.edt_cuda.launches
            if route == "plain":
                losses.edt_batch = E.edt_reference
            m = step(state, images, masks, draws, None)
            _sync()
            assert (E.edt_cuda.launches - launched) == (
                route == "kernel" and DEVICE != "cpu")
            out[route] = (m.boundary.clone(), {
                k: v.clone() for k, v in state.model.state_dict().items()})
    finally:
        losses.edt_batch = E.edt_batch
        torch.backends.cudnn.deterministic = False
    (bk, pk), (bp, pp) = out["kernel"], out["plain"]
    rel = max(((pk[k] - pp[k]).abs().max()
               / pp[k].abs().max().clamp(min=1e-30)).item() for k in pk)
    phase("lifecycle", f"one float32 step from the restored state: "
          f"boundary kernel {bk.item():.9g} plain {bp.item():.9g} "
          f"(bit-equal {torch.equal(bk, bp)}); parameters max relative "
          f"difference {rel:.3e} (limit {STEP_PARAM_RTOL:g})")
    assert torch.equal(bk, bp), "kernel and plain boundary terms differ"
    assert rel <= STEP_PARAM_RTOL
    del state, step, images, masks, out, pk, pp
    torch.cuda.empty_cache()
    return {"tensors": n, "step": got["step"], "bytes": nbytes,
            "save_s": save_s}


def lifecycle_best_saves(tmp, modes=BEST_SAVE_MODES):
    """What an improving epoch costs the step loop: a flagship Trainer on
    the card (the CLI's synthetic splits, bf16), the time of one train
    epoch alone (median of 3) and of ``_save_best`` and the next train
    epoch, for each (--best_full_state, --async_best_save) of ``modes``;
    the async saver's background write beside."""
    import statistics

    import torch

    from ddti_tpu_torch.cli.main import load_sources
    from ddti_tpu_torch.core.config import Config
    from ddti_tpu_torch.core.logging import create_logger
    from ddti_tpu_torch.train.engine import Trainer

    state = _flagship_state()
    cfg = Config(model_type="ResUNet", use_amp_autocast=True,
                 base_dir=os.path.join(tmp, "best_saves"), log_every=0,
                 ema_decay=0.999, image_size=TRAIN["image_size"],
                 store_size=TRAIN["image_size"],
                 batch_size=TRAIN["batch_size"])
    cfg.make_dirs()
    tr = Trainer(cfg, load_sources(cfg, DEVICE, True),
                 create_logger(os.path.join(cfg.log_dir, "log.log"),
                               console=False), state.model)

    def epoch():
        _sync()
        t0 = time.perf_counter()
        tr.train_one_epoch(0)
        _sync()
        return time.perf_counter() - t0

    epoch()  # warm-up
    plain = statistics.median(epoch() for _ in range(3))
    rows = []
    for full, mode in modes:
        cfg.best_full_state, cfg.async_best_save = full, mode
        _sync()
        t0 = time.perf_counter()
        tr._save_best(0, 0.5)
        save_s = time.perf_counter() - t0
        ep = epoch()
        write_s = None
        if tr._best_saver is not None:
            tr._best_saver.close()
            tr._best_saver = None
            write_s = time.perf_counter() - t0
        rows.append({"best_full_state": full, "async": mode,
                     "save_call_s": save_s, "next_epoch_s": ep,
                     "improving_epoch_s": save_s + ep,
                     "background_write_s": write_s})
        phase("lifecycle", f"best save, full state {full}, async "
              f"{mode}: the call {save_s:.3f} s, the next epoch "
              f"{ep:.3f} s (alone {plain:.3f} s): an improving epoch "
              f"{save_s + ep:.3f} s"
              + (f"; written in the background by {write_s:.3f} s"
                 if write_s is not None else ""))
    del tr, state
    torch.cuda.empty_cache()
    return {"epoch_s": plain, "steps_an_epoch": _cli_batches(
        TRAIN["batch_size"])[0], "rows": rows}


def lifecycle_average(tmp, periodic):
    """cli/average.py over the periodic states in ``periodic`` (the
    BatchNorm pass on LIFECYCLE_RECALIB frames), then cli/infer.py serving
    the average at the frames' sizes. Returns both processes' wall
    seconds."""
    import numpy as np
    from PIL import Image

    avg = os.path.join(tmp, "lc_avg.npz")
    cmd = [sys.executable, "-m", "ddti_tpu_torch.cli.average",
           "--checkpoints", periodic, "--output", avg, "--model_type",
           "ResUNet", f"--base_filters={TRAIN['base_filters']}",
           f"--depth={TRAIN['depth']}",
           f"--image_size={TRAIN['image_size']}",
           f"--recalib_count={LIFECYCLE_RECALIB}", "--device", DEVICE]
    phase("lifecycle", " ".join(cmd[1:]))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=TRAIN_TIMEOUT_S)
    avg_wall = time.perf_counter() - t0
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-8000:], sep="\n",
              file=sys.stderr)
    assert res.returncode == 0, "cli/average.py failed"
    assert sum(line.startswith("averaged ")
               for line in res.stdout.splitlines()) == 2, res.stdout
    assert f"recalibrated BN stats on {LIFECYCLE_RECALIB} images" \
        in res.stdout, res.stdout
    with np.load(avg) as z:
        keys = set(z.files)
        finite = all(np.isfinite(z[k]).all() for k in z.files)
    assert keys == jax_resunet_keys(TRAIN["depth"]) and finite
    phase("lifecycle", f"cli/average.py: periodic 2 and 3, BN recalibrated "
          f"on {LIFECYCLE_RECALIB} frames, in {avg_wall:.1f} s -> the JAX "
          f"layout's {len(keys)} keys, finite")

    root = os.path.join(tmp, "lc_infer")
    imgs, masks, frames = make_infer_frames(root, SEED)
    preds = os.path.join(root, "preds")
    cmd = [sys.executable, "-m", "ddti_tpu_torch.cli.infer", "--checkpoint",
           avg, "--input_dir", imgs, "--output_dir", preds, "--model_type",
           "ResUNet", f"--base_filters={TRAIN['base_filters']}",
           f"--depth={TRAIN['depth']}", f"--image_size={TRAIN['image_size']}",
           "--mask_dir", masks, "--device", DEVICE]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=INFER_TIMEOUT_S)
    infer_wall = time.perf_counter() - t0
    assert res.returncode == 0, res.stderr[-4000:]
    n, secs, ips, _ = parse_infer_output(res.stdout)
    assert n == len(frames)
    for name, size in frames:
        with Image.open(os.path.join(
                preds, name.rsplit(".", 1)[0] + "_pred.png")) as im:
            m = np.asarray(im)
        assert im.size == size and set(np.unique(m)) <= {0, 255}
    phase("lifecycle", f"cli/infer.py on the average: {n} masks at the "
          f"frames' sizes, {secs:.1f} s ({ips:.1f} img/s), {infer_wall:.1f} "
          f"s of process")
    return avg_wall, infer_wall


def run_lifecycle(tmp, best_saves=BEST_SAVE_MODES):
    """The lifecycle phase: the flagship through the CLI uninterrupted and,
    at the same time, preempted in epoch 2 (exit 75, the resume hint, the
    saved state); then resumed, and at the same time cli/average.py over
    the uninterrupted run's periodic states and cli/infer.py serving the
    average; the restored state on the card; the best saves' cost in the
    modes of ``best_saves``."""
    import shutil

    from ddti_tpu_torch.train.checkpoint import is_full_state

    t_phase = time.perf_counter()
    try:
        import matplotlib
        drawn_by = f"matplotlib {matplotlib.__version__}"
    except ImportError as e:
        drawn_by = f"Pillow (import matplotlib: {e})"
    phase("lifecycle", f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB free "
          f"under the temporary directory; the grids are drawn by "
          f"{drawn_by}")
    hint = os.path.join(tmp, "resume_hint.json")
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        full_f = pool.submit(_lifecycle_run, os.path.join(tmp, "lc_full"),
                             "uninterrupted")
        pre_f = pool.submit(_lifecycle_run, os.path.join(tmp, "lc_pre"),
                            "preempted", preempt=True,
                            env={"DDTI_RESUME_HINT": hint})
        rc, out, full_wall, run = full_f.result()
        p_rc, p_out, pre_wall, p_run = pre_f.result()
    full = _check_full_run("uninterrupted", rc, out, run, [1, 2, 3])

    assert p_rc == 75, f"preempted: exit {p_rc}"
    assert "test phase skipped" in p_out.lower() and "Test Metrics" \
        not in p_out
    with open(hint) as f:
        h = json.load(f)
    last = os.path.join(p_run, "models", "ResUNet_last")
    assert h == {"checkpoint_path": last, "epochs": LIFECYCLE_EPOCHS}, h
    assert is_full_state(last)
    for suffix in (".npz", ".pth"):
        assert os.path.exists(last + suffix), suffix
    phase("lifecycle", f"preempted: exit 75, test phase skipped, resume "
          f"hint {h}, ResUNet_last/ .npz .pth on disk")

    # the resumed run, and at the same time cli/average.py over the
    # uninterrupted run's periodic states and cli/infer.py on the average
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        avg_f = pool.submit(lifecycle_average, tmp,
                            os.path.join(run, "models", "periodic"))
        rc, out, res_wall, r_run = _lifecycle_run(
            os.path.join(tmp, "lc_resumed"), "resumed", "--resume",
            "--checkpoint_path", h["checkpoint_path"])
        avg_wall, infer_wall = avg_f.result()
    shutil.rmtree(os.path.join(run, "models"))  # the disk, for what follows
    resumed = _check_full_run("resumed", rc, out, r_run, [2, 3])
    assert resumed["resumed_epoch"] == 2, resumed
    restore = lifecycle_restore(last, tmp)
    assert resumed["resumed_step"] == restore["step"]
    shutil.rmtree(os.path.join(p_run, "models"))
    best = lifecycle_best_saves(tmp, best_saves)
    wall = time.perf_counter() - t_phase
    phase("lifecycle", f"CLI wall times: uninterrupted {full_wall:.1f} s, "
          f"preempted {pre_wall:.1f} s (the two at once), resumed "
          f"{res_wall:.1f} s, average {avg_wall:.1f} s, infer "
          f"{infer_wall:.1f} s; phase wall time {wall:.1f} s")
    return {"launches": {"uninterrupted": full["kernels"]["edt_minplus"],
                         "resumed": resumed["kernels"]["edt_minplus"]},
            "wall_s": {"uninterrupted": full_wall, "preempted": pre_wall,
                       "resumed": res_wall, "average": avg_wall,
                       "infer": infer_wall, "phase": wall},
            "grid_s_a_frame": [r["grid_s"] / r["grid_frames"]
                               for r in (full, resumed)],
            "threshold": [full["threshold"], resumed["threshold"]],
            "grids_drawn_by": drawn_by, "restore": restore,
            "best_saves": best}


def legacy_params():
    """``python -m ddti_tpu_torch.cli.params``: its two sections' 14 counts
    equal what the JAX package's cli/params.py prints (PARAMS_JAX)."""
    t0 = time.perf_counter()
    res = subprocess.run([sys.executable, "-m", "ddti_tpu_torch.cli.params"],
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-4000:]
    got, section = {}, None
    for line in res.stdout.splitlines():
        if line.startswith("# reference"):
            section = got.setdefault("reference", {})
        elif line.startswith("# active"):
            section = got.setdefault("active", {})
        elif ": " in line:
            name, n = line.split(": ")
            section[name] = int(n)
    phase("legacy", f"cli/params.py in {time.perf_counter() - t0:.1f} s: "
          + "; ".join(f"{k} " + ", ".join(f"{m} {n}" for m, n in v.items())
                      for k, v in got.items()))
    assert got == PARAMS_JAX, got
    phase("legacy", "the 14 counts equal the JAX package's cli/params.py")
    return got


def legacy_extra_args():
    """LEGACY_EXTRA as the port's training CLI parses it."""
    import shlex

    from ddti_tpu_torch.cli.main import get_parser

    return get_parser().parse_args(shlex.split(LEGACY_EXTRA))


def _legacy_keys(model_type):
    feats = LEGACY_KW.get("features")
    return jax_legacy_keys(model_type, len(feats) if feats else None,
                           LEGACY_KW.get("num_layers", 4))


def legacy_sweep(tmp):
    """run.sh's path with the port's tools: a nine-entry model matrix
    (LEGACY, LEGACY_KW each) split by cli/split_config.py and swept by
    cli/sweep.py --config_dir, LEGACY_JOBS at a time, with LEGACY_EXTRA:
    every job exits 0 with its parameter count as JAX counts it; each run's
    tree passes check_run (finite terms, test metrics, a best .pth that
    loads strictly and an .npz with the JAX key set) and its log's
    [KERNELS] line has exactly the expected EDT launches and no flash
    launch. Returns ({model: EDT launches}, {model: (best, YAML)},
    experiments dir, sweep wall seconds)."""
    import re

    import yaml

    matrix = os.path.join(tmp, "legacy_matrix.yaml")
    with open(matrix, "w") as f:
        yaml.safe_dump([{"model": {"model_type": m, "kwargs": LEGACY_KW}}
                        for m in LEGACY], f)
    cfg_dir = os.path.join(tmp, "legacy_sweep")
    res = subprocess.run([sys.executable, "-m",
                          "ddti_tpu_torch.cli.split_config", matrix, cfg_dir],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    cfgs = {m: os.path.join(cfg_dir, m, "config1.yaml") for m in LEGACY}
    assert sorted(os.listdir(cfg_dir)) == sorted(LEGACY)
    assert all(os.path.exists(c) for c in cfgs.values())
    exp = os.path.join(tmp, "legacy_exp")
    cmd = [sys.executable, "-m", "ddti_tpu_torch.cli.sweep", "--config_dir",
           cfg_dir, "--max_jobs", str(LEGACY_JOBS), "--min_gap", "1",
           "--extra", f"{LEGACY_EXTRA} --device {DEVICE} --base_dir {exp}"]
    phase("legacy", " ".join(cmd[1:]))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=LEGACY_SWEEP_TIMEOUT_S)
    wall = time.perf_counter() - t0
    phase("legacy", f"cli/sweep.py exit {res.returncode} in {wall:.1f} s "
          f"({len(LEGACY)} jobs, {LEGACY_JOBS} at a time)")
    if res.returncode != 0:
        print(res.stdout[-6000:], res.stderr[-8000:], sep="\n",
              file=sys.stderr)
    assert res.returncode == 0, "a sweep job failed"
    assert "All jobs finished." in res.stdout
    params = dict(l.split()[1].split(",") for l in res.stdout.splitlines()
                  if l.startswith("[PARAMS]"))
    assert {m: int(n) for m, n in params.items()} == {
        m: LEGACY_JAX_PARAMS[m] for m in LEGACY}, params
    runs = {r.rsplit("_", 2)[0]: os.path.join(exp, r)
            for r in os.listdir(exp)}
    assert sorted(runs) == sorted(LEGACY), sorted(runs)
    extra = legacy_extra_args()
    steps, val, test_b = _cli_batches(extra.batch_size)
    epochs = extra.epochs
    # none on the CPU, where the plain versions run
    expected = (epochs * (steps + val) + test_b) if DEVICE == "cuda" else 0
    launches, ckpts = {}, {}
    for m in LEGACY:
        with open(os.path.join(runs[m], "log", "train_log.log")) as f:
            k = re.findall(r"\[KERNELS\] (.*)$", f.read(), re.M)
        got = {a: int(b) for a, b in (kv.split("=") for kv in k[-1].split())}
        phase("legacy", f"{m}: {params[m]} parameters; [KERNELS] {k[-1]} "
              f"(edt_minplus expected {epochs} epoch x ({steps} train + "
              f"{val} val steps) + {test_b} test batches = {expected})")
        assert got["edt_minplus"] == expected, got
        assert got["flash_fwd"] == got["flash_bwd_dkdv"] == 0, got
        best = check_run(f"legacy {m}", runs[m], m, LEGACY_KW,
                         _legacy_keys(m), epochs)
        launches[m], ckpts[m] = got["edt_minplus"], (best, cfgs[m])
    return launches, ckpts, exp, wall


def legacy_aggregate(exp, tmp):
    """cli/aggregate.py over the sweep's experiments tree: one ranked row
    with a finite test IoU per model, in the table and in the CSV."""
    import csv
    import math

    out = os.path.join(tmp, "legacy_summary.csv")
    res = subprocess.run([sys.executable, "-m", "ddti_tpu_torch.cli.aggregate",
                          "--experiments_dir", exp, "--output", out],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.splitlines()
    table = lines[2:2 + len(LEGACY)]
    assert lines[0].split()[:2] == ["run", "model_type"]
    assert sorted(l.split()[0].rsplit("_", 2)[0] for l in table) \
        == sorted(LEGACY), table
    with open(out) as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == len(LEGACY)
    ious = [float(r["iou"]) for r in rows]
    assert all(math.isfinite(v) for v in ious)
    assert ious == sorted(ious, reverse=True), "not ranked by IoU"
    phase("legacy", f"cli/aggregate.py: {len(rows)} ranked rows and a CSV; "
          + ", ".join(f"{r['model_type']} {r['iou']}" for r in rows))
    return {r["model_type"]: float(r["iou"]) for r in rows}


def legacy_serve(best, cfg):
    """MoresTransUNet's best .pth served with load_predictor at
    LEGACY_SERVE's size, bf16, its batch: uint8 {0, 1} masks and exactly 4
    flash_fwd launches a batch (its 1024-token bottleneck at 512^2 takes
    the gate); float32 logits, the kernel path on the card against the
    plain path on the CPU, within ZOO_LOGIT_RTOL of the largest; the bf16
    batch's device time on the kernel and the plain attention path, each
    the median of 20 CUDA-event runs."""
    import numpy as np
    import torch

    from ddti_tpu_torch.cli import serve
    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
    from ddti_tpu_torch.train.export import make_serve_fn

    m, size = "MoresTransUNet", LEGACY_SERVE["image_size"]
    batch, batches = LEGACY_SERVE["batch"], LEGACY_SERVE["batches"]
    args = serve.get_parser().parse_args(
        ["--checkpoint", best + ".pth", "--config_path", cfg,
         "--image_size", str(size), "--batch_size", str(batch), "--bf16",
         "--device", DEVICE])
    predict, batch_n, got_size, info = serve.load_predictor(args)
    assert info["model"] == m and (batch_n, got_size) == (batch, size)
    kw = yaml_kwargs(cfg)
    x = np.stack(make_frames(batch * batches, size, SEED + 5))[..., None]
    on_card = DEVICE == "cuda"
    # one launch a layer; none on the CPU, where the plain versions run
    per_batch = kw.get("num_layers", 4) if on_card else 0
    A.flash_forward_cuda.launches = 0
    masks = [predict(x[i * batch:(i + 1) * batch]) for i in range(batches)]
    launches = A.flash_forward_cuda.launches
    tokens = (size // 2 ** len(kw.get("features", range(4)))) ** 2
    phase("legacy serve", f"{m} load_predictor bf16 {batches} batches of "
          f"{batch} at {size}^2 ({tokens} bottleneck tokens): flash_fwd "
          f"launches {launches} (expected {per_batch} a batch)")
    assert launches == per_batch * batches
    for mk in masks:
        assert mk.dtype == np.uint8 and mk.shape == (batch, size, size, 1)
        assert set(np.unique(mk)) <= {0, 1}
    del predict
    cpu = load_checkpoint_into(best + ".pth", m, blank_model(
        m, use_flash_attention=False, **kw)).eval()
    card = load_checkpoint_into(best + ".pth", m, blank_model(m, **kw)
                                ).to(DEVICE).eval()
    xf = torch.from_numpy(x[:ZOO_CPU_BATCH]).permute(0, 3, 1, 2) / 255.0
    A.flash_forward_cuda.launches = 0
    with torch.inference_mode():
        got = card(xf.to(DEVICE)).cpu()
        want = cpu(xf)
    f32_launches = A.flash_forward_cuda.launches
    rel = float((got - want).abs().max() / want.abs().max())
    phase("legacy serve", f"float32 logits, kernel path on {DEVICE} vs the "
          f"plain path on the CPU at batch {ZOO_CPU_BATCH}: max|d| / "
          f"max|logit| {rel:.3e} (limit {ZOO_LOGIT_RTOL:g}); flash_fwd "
          f"launches {f32_launches}")
    assert torch.isfinite(got).all() and rel <= ZOO_LOGIT_RTOL
    assert f32_launches == per_batch
    out = dict(launches=launches, batches=batches, rel=rel)
    if on_card:
        xb = torch.from_numpy(x[:batch]).cuda()
        plain = load_checkpoint_into(best + ".pth", m, blank_model(
            m, use_flash_attention=False, **kw)).cuda().eval()
        fns = {"kernel": make_serve_fn(card, compute_dtype=torch.bfloat16),
               "plain": make_serve_fn(plain, compute_dtype=torch.bfloat16)}
        order = ("plain", "kernel", "kernel", "plain")
        ms = [median_ms(lambda: fns[p](xb)) for p in order]
        out["ms"] = dict(zip(("plain", "kernel"), (
            [ms[0], ms[3]], [ms[1], ms[2]])))
        phase("legacy serve", f"device time per bf16 batch of {batch} at "
              f"{size}^2 (CUDA events, median of 20), order "
              f"{', '.join(order)}: {', '.join(f'{t:.3f}' for t in ms)} ms")
        del plain, fns
    else:
        phase("legacy serve", "device times: not measured (no card)")
    del card
    if on_card:
        torch.cuda.empty_cache()
    return out


def yaml_kwargs(cfg):
    """The model kwargs of a one-entry model YAML."""
    import yaml

    with open(cfg) as f:
        return dict(yaml.safe_load(f)["model"]["kwargs"])


def legacy_profile():
    """Each of the nine models' bf16 train step at LEGACY_PROFILE (CUDA
    events, the median of LEGACY_PROFILE_RUNS) and its memory peak
    (``max_memory_allocated``); a model that does not fit is profiled at
    the largest halved batch that does. No flash launch (MoresTransUNet
    trains at its fixed dropout 0.1 on the plain path)."""
    import torch

    from ddti_tpu_torch.ops import attention as A

    size, batch0 = LEGACY_PROFILE
    rows = []
    for m in LEGACY:
        batch = batch0
        while True:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            try:
                _, state, step, (images, masks, draws) = _train_setup(
                    size, batch, True, model_type=m, model_kw={})
                before = A.flash_forward_cuda.launches

                def one():
                    step(state, images, masks, draws, None)

                ms = median_ms(one, runs=LEGACY_PROFILE_RUNS, warmup=2)
                torch.cuda.synchronize()
                break
            except torch.cuda.OutOfMemoryError:
                state = step = images = masks = draws = None
                phase("legacy profile", f"{m}: batch {batch} does not fit")
                batch //= 2
                assert batch, f"{m} does not fit at batch 1"
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        flash = A.flash_forward_cuda.launches - before
        phase("legacy profile", f"{m} bf16 train step {size}^2 batch "
              f"{batch}: {ms:.3f} ms device time (CUDA events, median of "
              f"{LEGACY_PROFILE_RUNS}), {batch / ms * 1e3:.1f} img/s; peak "
              f"{peak:.2f} GiB allocated; flash_fwd launches {flash}")
        assert flash == 0
        rows.append(dict(model=m, size=size, batch=batch, ms=ms,
                         peak_gib=peak))
        del state, step, images, masks, draws
    torch.cuda.empty_cache()
    return rows


def run_legacy(tmp, profile=False):
    """The legacy phase: the params tool, the sweep, the aggregate,
    MoresTransUNet served, LegacyUNet's float32 step with the kernel EDT
    and the plain one (on the card only), and with ``profile`` (``--legacy``
    alone) the nine bf16 step profiles."""
    t0 = time.perf_counter()
    # the params tool's process starts beside the sweep's, off its path
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        counted = pool.submit(legacy_params)
        launches, ckpts, exp, sweep_wall = legacy_sweep(tmp)
        counted.result()
    ious = legacy_aggregate(exp, tmp)
    served = legacy_serve(*ckpts["MoresTransUNet"])
    out = dict(launches=launches, sweep_s=sweep_wall, test_iou=ious,
               serve=served)
    if DEVICE == "cuda":
        step_kernel_vs_plain("LegacyUNet", {}, LEGACY_STEP_BATCH,
                             "legacy step")
        if profile:
            out["train_steps"] = legacy_profile()
    else:
        phase("legacy", "the step and the profiles: not run (no card)")
    out["phase_s"] = time.perf_counter() - t0
    phase("legacy", f"phase wall time {out['phase_s']:.1f} s (sweep "
          f"{sweep_wall:.1f} s)")
    return out


def legacy_only():
    """The legacy phase alone: ``python3 chip_smoke.py --legacy``."""
    import torch

    from ddti_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this phase "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["DDTI_POLY_EXP2"] = "0"
    _build.build()  # once, before the CLI processes load it
    with tempfile.TemporaryDirectory() as tmp:
        legacy = run_legacy(tmp, profile=True)
    print(json.dumps({"legacy": legacy}))
    return 0


def lifecycle_only():
    """The lifecycle phase alone: ``python3 chip_smoke.py --lifecycle``."""
    import torch

    from ddti_tpu_torch.ops import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["DDTI_POLY_EXP2"] = "0"
    _build.build()  # once, before the CLI processes load it
    with tempfile.TemporaryDirectory() as tmp:
        lifecycle = run_lifecycle(tmp)
    print(json.dumps({"lifecycle": lifecycle}))
    return 0


def recipe_only():
    """The recipe phase alone: ``python3 chip_smoke.py --recipe``."""
    import torch

    from ddti_tpu_torch.ops import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["DDTI_POLY_EXP2"] = "0"
    _build.build()  # once, before the CLI processes load it
    with tempfile.TemporaryDirectory() as tmp:
        recipe = run_recipe(tmp, profile=True)
    print(json.dumps({"recipe": recipe}))
    return 0


def zoo_only():
    """The zoo phases alone (train, serve, step), then every zoo model's
    bf16 step profiled at both TRAIN_PROFILES: ``python3 chip_smoke.py
    --zoo`` (~6 min)."""
    import torch

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        launches, ckpts = run_zoo_training(tmp)
        zoo_serve(ckpts)
    zoo_steps()
    rows = profile_zoo([(m, *p) for m in ZOO for p in TRAIN_PROFILES])
    print(json.dumps({"zoo_launches": launches, "zoo_train_steps": rows}))
    return 0


def profiles_only():
    """The ResUNet and TransUNet train-step profiles (phase 11) alone:
    ``python3 chip_smoke.py --profiles``."""
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this phase "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps({"train_steps": profile_training(),
                      "transunet_train_steps": profile_transunet()}))
    return 0


def infer_only():
    """The infer phase alone, on the slice's TransUNet with random weights
    (seed SEED, as the slice phase makes it) and the AttentionUNet entry
    trained for ZOO_TRAIN's epoch, as the zoo train phase trains it; then
    the daemon: ``python3 chip_smoke.py --infer``."""
    import torch

    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.ops import _build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["DDTI_POLY_EXP2"] = "0"
    _build.build()  # once, before the CLI processes load it
    with tempfile.TemporaryDirectory() as tmp:
        trans = os.path.join(tmp, "transunet_bf64_d4_512.pth")
        torch.save(random_state(create_model("TransUNet", **SLICE), SEED),
                   trans)
        _, zoo_ckpts = run_zoo_training(tmp, ["AttentionUNet"])
        infer = run_infer(tmp, trans, zoo_ckpts["AttentionUNet"][0] + ".pth")
        infer["daemon_launches"] = infer_daemon(trans)
    print(json.dumps({"infer": infer}))
    return 0


def write_hostdata(root, seed=SEED):
    """HOSTDATA_SPLITS as grayscale JPEG pairs in the reference's layout:
    ``root/<split>/<split>_NNNN.jpg`` (speckle over a dark field, one
    brighter ellipse, as make_frames draws them) and
    ``root/<split>_mask/<split>_NNNN_mask.jpg`` (the ellipse). Returns the
    frame count a split."""
    import numpy as np
    from PIL import Image

    rng = np.random.default_rng(seed)
    counts = {}
    for split, sizes in HOSTDATA_SPLITS.items():
        imgs, masks = (os.path.join(root, split),
                       os.path.join(root, f"{split}_mask"))
        os.makedirs(imgs)
        os.makedirs(masks)
        k = 0
        for w, h, n in sizes:
            yy, xx = np.mgrid[0:h, 0:w]
            for _ in range(n):
                cy, cx, ry, rx = rng.uniform([0.3, 0.3, 0.08, 0.08],
                                             [0.7, 0.7, 0.25, 0.25])
                inside = ((yy / h - cy) / ry) ** 2 + ((xx / w - cx) / rx) \
                    ** 2 < 1
                img = 60 + 90 * inside + rng.normal(0, 25, (h, w))
                stem = f"{split}_{k:04d}"
                Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                    os.path.join(imgs, stem + ".jpg"))
                Image.fromarray(inside.astype(np.uint8) * 255).save(
                    os.path.join(masks, stem + "_mask.jpg"))
                k += 1
        counts[split] = k
    return counts


def hostdata_library():
    """(a) The host loader's library built with g++ into build/, whether its
    libjpeg decode is in it, and what the machine has of libjpeg."""
    from ddti_tpu_torch.runtime import native

    t0 = time.perf_counter()
    path = native.build_library()
    secs = time.perf_counter() - t0
    header = os.path.exists("/usr/include/jpeglib.h")
    try:
        libs = sorted({line.split()[0] for line in subprocess.run(
            ["ldconfig", "-p"], capture_output=True, text=True,
            timeout=30).stdout.splitlines() if "libjpeg" in line})
    except (OSError, subprocess.SubprocessError) as e:
        libs = [f"ldconfig: {e}"]
    decode = native.decode_available()
    phase("hostdata", f"g++ {' '.join(native.CXX_FLAGS)} -> "
          f"{os.path.relpath(path)}: {native.build_seconds:.2f} s compiling "
          f"({secs:.2f} s with the load); decode "
          + ("in it" if decode else
             f"ABSENT ({native.decode_available_reason()})")
          + f"; /usr/include/jpeglib.h {'present' if header else 'absent'};"
          f" ldconfig libjpeg: {libs}")
    assert native.native_available(), "the host loader did not build"
    return dict(build_s=native.build_seconds, load_s=secs, decode=decode,
                header=header, libjpeg=libs,
                reason=native.decode_available_reason())


def hostdata_decode(root, size):
    """(b) The train split's JPEGs decoded to size^2: natively (all threads,
    and one), within HOSTDATA_DECODE_TOL of PIL, and by PIL; host ms a
    frame of each."""
    import numpy as np
    from PIL import Image

    from ddti_tpu_torch.runtime import native

    d = os.path.join(root, "train")
    paths = [os.path.join(d, f) for f in sorted(os.listdir(d))]
    t0 = time.perf_counter()
    pil = np.stack([np.asarray(Image.open(p).convert("L").resize(
        (size, size), Image.BILINEAR)) for p in paths])
    pil_ms = (time.perf_counter() - t0) * 1e3 / len(paths)
    if not native.decode_available():
        phase("hostdata", f"decode: PIL {pil_ms:.3f} ms a frame; native: "
              f"not measured (decode absent)")
        return dict(pil_ms=pil_ms, native_ms=None)
    out = {}
    for threads in (None, 1):
        t0 = time.perf_counter()
        got = native.decode_jpegs(paths, size, size, num_threads=threads)
        out[threads] = (time.perf_counter() - t0) * 1e3 / len(paths)
    diff = int(np.abs(got[..., 0].astype(np.int16)
                      - pil.astype(np.int16)).max())
    off = float((got[..., 0] != pil).mean())
    phase("hostdata", f"decode {len(paths)} JPEGs (600x480, 1024x768) to "
          f"{size}^2: native {out[None]:.3f} ms a frame on "
          f"{min(16, os.cpu_count() or 1)} threads, {out[1]:.3f} on one; "
          f"PIL {pil_ms:.3f}; max |native - PIL| {diff} gray level(s) on "
          f"{off:.4%} of the pixels (limit {HOSTDATA_DECODE_TOL})")
    assert diff <= HOSTDATA_DECODE_TOL
    return dict(native_ms=out[None], native_1t_ms=out[1], pil_ms=pil_ms,
                max_diff=diff, off_share=off)


def _data_lines(log):
    """The CLI's per-split data lines: {split: (source, seconds)}."""
    import re

    return {m[0]: (m[1], float(m[2])) for m in re.findall(
        r"Data: (\w+) \d+ frames at \S+ (decoded|from the \.store_cache) "
        r"in ([\d.]+) s", log)}


def hostdata_cli(tmp, root, name, flags, counts):
    """One training CLI run of the flagship (TRAIN, bf16) from the JPEG
    dataset at ``root``: run_cli's checks, and exactly the expected EDT
    launches on the card. Returns (launches, data lines, wall s)."""
    model_kw = dict(base_filters=TRAIN["base_filters"], depth=TRAIN["depth"])
    base = os.path.join(tmp, f"runs_{name}")
    cmd = [sys.executable, "-m", "ddti_tpu_torch.cli.main", "--mode", "both",
           "--use_amp_autocast", "true", "--device", DEVICE,
           "--dataset_path", root, "--base_dir", base,
           "--model_type", "ResUNet", f"--epochs={TRAIN['epochs']}",
           *(f"--{k}={v}" for k, v in TRAIN.items()
             if k not in ("model_type", "epochs")), *flags]
    phase(name, " ".join(cmd[1:]))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=HOSTDATA_TIMEOUT_S)
    wall = time.perf_counter() - t0
    phase(name, f"exit {res.returncode} in {wall:.1f} s")
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-8000:], sep="\n",
              file=sys.stderr)
    assert res.returncode == 0, "the training CLI failed"
    kernels = [l for l in res.stdout.splitlines()
               if l.startswith("[KERNELS]")]
    launches = {k: int(v) for k, v in (
        kv.split("=") for kv in kernels[0].split()[1:])}
    (run,) = os.listdir(base)
    run = os.path.join(base, run)
    check_run(name, run, "ResUNet", model_kw,
              jax_resunet_keys(TRAIN["depth"]), TRAIN["epochs"])
    with open(os.path.join(run, "log", "train_log.log")) as f:
        data = _data_lines(f.read())
    b = TRAIN["batch_size"]
    steps, val, test_b = (-(-counts[s] // b) for s in ("train", "val",
                                                       "test"))
    expected = TRAIN["epochs"] * (steps + val) + test_b
    phase(name, f"{kernels[0]}; edt_minplus expected {TRAIN['epochs']} "
          f"epochs x ({steps} train + {val} val steps) + {test_b} test "
          f"batches = {expected}" + (" (the card only)" if DEVICE != "cuda"
                                     else "")
          + (f"; data {data}" if data else ""))
    assert launches["edt_minplus"] == (expected if DEVICE == "cuda" else 0)
    return launches["edt_minplus"], data, wall


def _store_cached(root):
    """Every split's .store_cache files are written (atomically, so a
    reader sees whole files) at the CLI runs' store size (the CLI's
    default, 512, unless TRAIN sets one)."""
    from ddti_tpu_torch.data.dataset import MedicalDataset, store_cache_paths

    size = (TRAIN.get("store_size", 512),) * 2
    return all(os.path.isfile(p) for split in HOSTDATA_SPLITS
               for p in store_cache_paths(
                   MedicalDataset(os.path.join(root, split),
                                  os.path.join(root, f"{split}_mask")),
                   size, os.path.join(root, ".store_cache")))


def hostdata_runs(tmp, root, counts):
    """(c) The host chain's run and the native loader's first run at once,
    and the native loader's second run as soon as the first has written
    the .store_cache, which it then reads."""
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        host = pool.submit(hostdata_cli, tmp, root, "host_augment",
                           ["--host_augment", *HOSTDATA_CHAIN], counts)
        native1 = pool.submit(hostdata_cli, tmp, root, "native_loader",
                              ["--native_loader", "on"], counts)
        while not _store_cached(root):
            assert not native1.done(), "the first native run wrote no cache"
            time.sleep(0.2)
        native2 = pool.submit(hostdata_cli, tmp, root, "native_cached",
                              ["--native_loader", "on"], counts)
        host, native1, native2 = (host.result(), native1.result(),
                                  native2.result())
    cold, warm = native1[1], native2[1]
    assert all(src == "decoded" for src, _ in cold.values()), cold
    assert all(src == "from the .store_cache" for src, _ in warm.values()), \
        warm
    saved = sum(t for _, t in cold.values()) - sum(t for _, t in
                                                   warm.values())
    phase("hostdata", f"the .store_cache: first run "
          f"{sum(t for _, t in cold.values()):.3f} s decoding its three "
          f"splits, second run {sum(t for _, t in warm.values()):.3f} s "
          f"reading them: {saved:.3f} s saved; CLI wall times: host chain "
          f"{host[2]:.1f} s, native {native1[2]:.1f} s, cached "
          f"{native2[2]:.1f} s")
    return dict(launches={"host_augment": host[0], "native_loader":
                          native1[0], "native_cached": native2[0]},
                decode_s=sum(t for _, t in cold.values()),
                cached_s=sum(t for _, t in warm.values()), saved_s=saved,
                wall_s={"host_augment": host[2], "native_loader":
                        native1[2], "native_cached": native2[2]})


def _host_batch(root, size, batch, epoch=0):
    """The first host-chain batch (every branch, HostBatchIterator at
    ``epoch``) of the train split at size^2: float32 numpy arrays."""
    from ddti_tpu_torch.data.dataset import HostBatchIterator, MedicalDataset
    from ddti_tpu_torch.data.host_transforms import build_train_chain

    ds = MedicalDataset(os.path.join(root, "train"),
                        os.path.join(root, "train_mask"),
                        build_train_chain(True, True, True, True,
                                          (size, size)))
    it = HostBatchIterator(ds, batch, shuffle=True, seed=SEED)
    it.set_epoch(epoch)
    return next(iter(it))


def hostdata_step(root):
    """(d) One float32 make_host_train_step (TF32 off, mixup on) on one host
    batch, on the card against the CPU from the same weights and draws:
    loss terms and BatchNorm statistics within the stated limits; the
    gradients and updated parameters of both against the same step in
    float64 (on the CPU), the card's error within HOSTDATA_F32_FACTOR of
    the CPU's; on the card the kernel EDT against the plain one, the
    boundary terms bit-equal."""
    import torch

    from ddti_tpu_torch.core.config import Config
    from ddti_tpu_torch.data.augment import mixup, sample_mixup
    from ddti_tpu_torch.data.dataset import to_device
    from ddti_tpu_torch.losses import losses
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.ops import edt as E
    from ddti_tpu_torch.train.state import TrainState
    from ddti_tpu_torch.train.steps import _loss_kw, make_host_train_step
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    size, batch = HOSTDATA_STEP
    images, masks = _host_batch(root, size, batch)
    cfg = Config(image_size=size, batch_size=batch, use_mixup=True,
                 mixup_prob=1.0)
    mix = sample_mixup(torch.Generator().manual_seed(SEED), batch,
                       cfg.mixup_alpha, 1.0)
    step = make_host_train_step(cfg)
    model_kw = dict(base_filters=TRAIN["base_filters"], depth=TRAIN["depth"])
    sd0 = init_like_flax(create_model("ResUNet", **model_kw),
                         SEED).state_dict()
    out = {}
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    try:
        for label, dev, plain in (("card", DEVICE, False),
                                  ("card, plain EDT", DEVICE, True),
                                  ("cpu", "cpu", False)):
            model = create_model("ResUNet", **model_kw)
            model.load_state_dict(sd0)
            state = TrainState(model.to(dev), cfg.lr, 4, cfg.weight_decay)
            if plain:
                losses.edt_batch = E.edt_reference
            launched = E.edt_cuda.launches
            t0 = time.perf_counter()
            m = step(state, to_device(torch.from_numpy(images), dev),
                     to_device(torch.from_numpy(masks), dev), mix.to(dev))
            terms = torch.stack([m.loss, m.bce, m.dice, m.focal,
                                 m.boundary]).cpu()
            losses.edt_batch = E.edt_batch
            out[label] = (terms, {k: v.detach().cpu().double() for k, v in
                                  model.state_dict().items()
                                  if v.is_floating_point()},
                          {k: p.grad.detach().cpu().double() for k, p in
                           model.named_parameters()},
                          E.edt_cuda.launches - launched,
                          time.perf_counter() - t0)
        # the same step in float64 on the CPU: mixup, forward, the weighted
        # loss, backward and the AdamW update, as the step body does them
        t0 = time.perf_counter()
        model = create_model("ResUNet", **model_kw)
        model.load_state_dict(sd0)
        model.double().train()
        x, y = mixup(torch.from_numpy(images).double(),
                     torch.from_numpy(masks).double(), mix)
        logits = model(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        losses.weighted_loss(logits, y, **_loss_kw(cfg)).total.backward()
        TrainState(model, cfg.lr, 4, cfg.weight_decay).apply_gradients()
        grads64 = {k: p.grad.detach() for k, p in model.named_parameters()}
        params64 = {k: p.detach() for k, p in model.named_parameters()}
        s64 = time.perf_counter() - t0
    finally:
        losses.edt_batch = E.edt_batch
        torch.backends.cudnn.deterministic = False
    (tk, pk, gk, lk, sk), (tp, _, _, lp, _), (tc, pc, gc, _, sc) = (
        out["card"], out["card, plain EDT"], out["cpu"])
    term_rel = float(((tk - tc).abs() / tc.abs().clamp(min=1e-30)).max())

    def normwise(a, b, keys):
        num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in keys)
        return (num / sum(float((b[k] ** 2).sum()) for k in keys)) ** 0.5

    stat_rel = normwise(pk, pc, [k for k in pc if "running_" in k])
    err = {side: (normwise(g, grads64, list(grads64)),
                  normwise(p, params64, list(params64)))
           for side, g, p in (("card", gk, pk), ("cpu", gc, pc))}
    card_vs_cpu = (normwise(gk, gc, list(gc)), normwise(pk, pc, list(gc)))
    phase("hostdata", f"float32 host step, ResUNet bf{TRAIN['base_filters']} "
          f"d{TRAIN['depth']} at {size}^2 "
          f"batch {batch} (one host-chain batch, mixup lambda "
          f"{float(mix.lam):.4f}): card {sk:.2f} s, CPU {sc:.2f} s, CPU "
          f"float64 {s64:.2f} s; loss card {tk[0].item():.9g} CPU "
          f"{tc[0].item():.9g}, terms max relative difference "
          f"{term_rel:.3e} (limit {HOSTDATA_TERM_RTOL:g}); BN statistics "
          f"normwise {stat_rel:.3e} (limit {HOSTDATA_STAT_RTOL:g}); "
          f"against float64, gradients / parameters normwise: card "
          f"{err['card'][0]:.3e} / {err['card'][1]:.3e}, CPU "
          f"{err['cpu'][0]:.3e} / {err['cpu'][1]:.3e} (the card's within "
          f"{HOSTDATA_F32_FACTOR:g}x the CPU's); card vs CPU "
          f"{card_vs_cpu[0]:.3e} / {card_vs_cpu[1]:.3e}; boundary kernel "
          f"{tk[4].item():.9g} plain {tp[4].item():.9g} (bit-equal "
          f"{torch.equal(tk[4], tp[4])}; edt launches {lk} / {lp})")
    assert term_rel <= HOSTDATA_TERM_RTOL and stat_rel <= HOSTDATA_STAT_RTOL
    for i in (0, 1):
        assert err["card"][i] <= HOSTDATA_F32_FACTOR * err["cpu"][i] + 1e-12
    assert torch.equal(tk[4], tp[4])
    assert (lk, lp) == ((1, 0) if DEVICE == "cuda" else (0, 0))
    torch.cuda.empty_cache()
    return dict(term_rel=term_rel, stat_rel=stat_rel,
                f64_err={k: list(v) for k, v in err.items()},
                card_vs_cpu=list(card_vs_cpu), card_s=sk, cpu_s=sc,
                cpu64_s=s64)


def hostdata_timing(root):
    """(e) The bf16 flagship train step at TRAIN's 512^2 / batch 16 fed by
    the device store, by the native loader (over the train split's
    .store_cache) and by the host chain (every branch): device ms a step
    (CUDA events around the copy to the card and the step), wall ms a
    step over HOSTDATA_TIMED steps with one synchronize at the end, img/s,
    the host's ms a batch before the step, and the busy share of a
    profiled window of TRAIN_PROFILE_STEPS more steps (the union of its
    device intervals)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ddti_tpu_torch.core.config import Config
    from ddti_tpu_torch.data.augment import sample_draws
    from ddti_tpu_torch.data.dataset import (
        HostBatchIterator,
        MedicalDataset,
        decode_to_store_files,
        synthetic_source,
        to_device,
    )
    from ddti_tpu_torch.data.host_transforms import build_train_chain
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.runtime import NativeBatchLoader, NativeSource
    from ddti_tpu_torch.train.engine import aug_config_from
    from ddti_tpu_torch.train.state import TrainState
    from ddti_tpu_torch.train.steps import (
        make_host_train_step,
        make_train_step,
    )
    from ddti_tpu_torch.utils.weight_init import init_like_flax

    size, batch = TRAIN["image_size"], TRAIN["batch_size"]
    cfg = Config(image_size=size, store_size=size, batch_size=batch,
                 use_amp_autocast=True)
    aug = aug_config_from(cfg)
    model = init_like_flax(create_model(
        "ResUNet", base_filters=TRAIN["base_filters"],
        depth=TRAIN["depth"]), SEED).to(DEVICE)
    state = TrainState(model, cfg.lr, 4, cfg.weight_decay)
    dev_step, host_step = make_train_step(cfg, aug), make_host_train_step(cfg)
    g = torch.Generator().manual_seed(SEED)
    fg = torch.Generator(device=DEVICE).manual_seed(SEED)
    train = (os.path.join(root, "train"), os.path.join(root, "train_mask"))

    def store():
        src = synthetic_source(32, (size, size), SEED, device=DEVICE)
        e = 0
        while True:
            for idx in src.epoch_batches(np.random.default_rng((SEED, e)),
                                         batch):
                yield src.gather(idx)
            e += 1

    def loader():
        ip, mp, n = decode_to_store_files(
            MedicalDataset(*train), (size, size),
            os.path.join(root, ".store_cache"))
        nsrc = NativeSource(NativeBatchLoader(ip, mp, n, size, size, batch,
                                              seed=SEED))
        try:
            while True:
                for x, y in nsrc:
                    yield x, y
        finally:
            nsrc.loader.close()

    def host():
        it = HostBatchIterator(
            MedicalDataset(*train, build_train_chain(
                True, True, True, True, (size, size))),
            batch, shuffle=True, seed=SEED)
        e = 0
        while True:
            it.set_epoch(e)
            for x, y in it:
                if len(x) == batch:
                    yield x, y
            e += 1

    def one(x, y):
        if isinstance(x, np.ndarray):
            x, y = (to_device(torch.from_numpy(t), DEVICE) for t in (x, y))
        if x.dtype == torch.uint8:
            draws = sample_draws(g, batch, aug, tuple(x.shape[1:3]), fg)
            dev_step(state, x, y, draws.to(DEVICE), None)
        else:
            host_step(state, x, y, None)

    rows = []
    for label, gen in (("device store", store()), ("native loader",
                                                    loader()),
                       ("host chain", host())):
        one(*next(gen))  # warm-up
        torch.cuda.synchronize()
        host_ms, dev_ms = [], []
        t_all = time.perf_counter()
        for _ in range(HOSTDATA_TIMED):
            t0 = time.perf_counter()
            xy = next(gen)
            host_ms.append((time.perf_counter() - t0) * 1e3)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            one(*xy)
            end.record()
            dev_ms.append((start, end))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t_all) * 1e3 / HOSTDATA_TIMED
        dev = statistics.median(s.elapsed_time(e) for s, e in dev_ms)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with torch.profiler.record_function(BUSY_WINDOW):
                for _ in range(TRAIN_PROFILE_STEPS):
                    one(*next(gen))
                torch.cuda.synchronize()
        busy = device_busy(prof)
        gen.close()
        row = dict(source=label, device_ms=dev, wall_ms=wall,
                   img_s=batch / wall * 1e3,
                   host_ms=statistics.median(host_ms),
                   busy=busy["union_us"] / max(busy["window_us"], 1e-9))
        rows.append(row)
        phase("hostdata", f"bf16 step at {size}^2 batch {batch} fed by the "
              f"{label}: device {dev:.3f} ms (CUDA events, median of "
              f"{HOSTDATA_TIMED}), wall {wall:.3f} ms a step, "
              f"{row['img_s']:.1f} img/s, host {row['host_ms']:.3f} ms a "
              f"batch before the step; {TRAIN_PROFILE_STEPS} profiled "
              f"steps: {busy_text(busy)}")
        assert row["busy"] <= 1.0 + 1e-9
    del state, model
    torch.cuda.empty_cache()
    return rows


def _metric_series(text):
    """GET /metrics' series names (labels dropped), each value a float."""
    names = set()
    for line in text.splitlines():
        if line and not line.startswith("#"):
            name, value = line.rsplit(" ", 1)
            float(value)
            names.add(name.split("{")[0])
    return names


def hostdata_daemon(tmp, root):
    """(f) The serving slice's TransUNet (random weights from SEED, an .npz)
    in the daemon on DEVICE, bf16, --watch 0.2, at a threshold of the
    frames' median probability (a random model's masks at 0.5 say little):
    JPEG POSTs decoded natively against the same frames as PNGs (PIL) on
    >= HOSTDATA_AGREE of the pixels; POST /reload onto a second checkpoint
    under HOSTDATA_CLIENTS concurrent clients, no error and the masks
    changed; --watch reloading that path once it is rewritten; /metrics'
    series equal to METRICS_JAX; the flash forward's launches (the daemon
    counted alone, its warm-ups included) = N_LAYERS x its batches; the
    host ms a request's decode takes, native and PIL."""
    import numpy as np
    import torch
    from PIL import Image

    from ddti_tpu_torch.cli import serve
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.runtime import native
    from ddti_tpu_torch.train.checkpoint import save_params_npz
    from ddti_tpu_torch.train.export import nhwc_logits

    size = SLICE["image_size"]
    model = create_model("TransUNet", **SLICE)
    ckpts = []
    for k in range(3):
        model.load_state_dict(random_state(model, SEED + k))
        if k < 2:
            ckpts.append(os.path.join(tmp, f"serve_{k}.npz"))
            save_params_npz(ckpts[-1], "TransUNet", model.state_dict())
    third = {k: v.clone() for k, v in model.state_dict().items()}
    d = os.path.join(root, "val")
    bodies = [open(os.path.join(d, f), "rb").read()
              for f in sorted(os.listdir(d))][:HOSTDATA_POSTS]
    frames = [Image.open(io.BytesIO(b)).convert("L") for b in bodies]
    model.load_state_dict(random_state(model, SEED))
    x = torch.from_numpy(np.stack([np.asarray(f.resize(
        (size, size), Image.BILINEAR)) for f in frames])[..., None])
    with torch.inference_mode():
        probs = torch.sigmoid(nhwc_logits(model.to(DEVICE).eval(),
                                          x.to(DEVICE).float() / 255.0,
                                          bf16=True))
    threshold = f"{float(probs.median()):.6f}"
    del model, probs

    t_dec = {"native": [], "pil": []}
    for b in bodies:
        if native.decode_available():
            t0 = time.perf_counter()
            native.decode_jpeg_bytes(b, size, size)
            t_dec["native"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        Image.open(io.BytesIO(b)).convert("L").resize((size, size),
                                                      Image.BILINEAR)
        t_dec["pil"].append((time.perf_counter() - t0) * 1e3)

    args = serve.get_parser().parse_args(
        ["--checkpoint", ckpts[0], "--model_type", "TransUNet",
         "--base_filters", str(SLICE["base_filters"]),
         "--depth", str(SLICE["depth"]), "--image_size", str(size),
         "--batch_size", str(BATCH), "--bf16", "--threshold", threshold,
         "--watch", "0.2", "--device", DEVICE, "--port", "0"])
    A.flash_forward_cuda.launches = 0  # the daemon's, warm-ups included
    server = serve.create_server(args)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    out = {}
    try:
        port = server.server_address[1]
        health = get_json(port, "/healthz")
        phase("hostdata", f"daemon --bf16 --watch 0.2 --threshold "
              f"{threshold}: /healthz {json.dumps(health)}")
        assert health["native_decode"] is native.decode_available()

        def mask(body):
            status, headers, data, dt = post(port, body)
            assert status == 200, (status, data[:200])
            return np.frombuffer(data, np.uint8).reshape(
                int(headers["X-Height"]), int(headers["X-Width"])), dt

        agree, fg, lat = [], [], {"jpeg": [], "png": []}
        for body, frame in zip(bodies, frames):
            png = io.BytesIO()
            frame.save(png, "PNG")
            (mj, tj), (mp, tp) = mask(body), mask(png.getvalue())
            agree.append(float((mj == mp).mean()))
            fg.append(float((mj > 0).mean()))
            lat["jpeg"].append(tj * 1e3)
            lat["png"].append(tp * 1e3)
        share = float(np.mean(agree))
        before, _ = mask(bodies[0])

        statuses = []

        def client():
            for b in bodies[:4]:
                statuses.append(post(port, b)[0])

        with concurrent.futures.ThreadPoolExecutor(HOSTDATA_CLIENTS) as pool:
            jobs = [pool.submit(client) for _ in range(HOSTDATA_CLIENTS)]
            time.sleep(0.05)
            t0 = time.perf_counter()
            rs, _, rdata, _ = post(port, json.dumps(
                {"checkpoint": ckpts[1]}).encode(), "/reload")
            reload_s = time.perf_counter() - t0
            for j in jobs:
                j.result()
        after, _ = mask(bodies[0])
        # --watch: the path /reload installed, rewritten
        model = create_model("TransUNet", **SLICE)
        model.load_state_dict(third)
        t0 = time.perf_counter()
        save_params_npz(ckpts[1], "TransUNet", model.state_dict())
        deadline = time.perf_counter() + 30
        while server.n_reloads < 2 and time.perf_counter() < deadline:
            time.sleep(0.05)
        watch_s = time.perf_counter() - t0
        watched, _ = mask(bodies[0])
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("GET", "/metrics")
        resp = conn.getresponse()
        metrics = resp.read().decode()
        conn.close()
        series = _metric_series(metrics)
        stats = get_json(port, "/stats")
        batches = server.batcher.n_batches
        launches = A.flash_forward_cuda.launches
        warmups = 1 + server.n_reloads
        phase("hostdata", f"daemon: native (JPEG) vs PIL (PNG) masks agree "
              f"on {share:.4%} of pixels over {len(bodies)} frames "
              f"(foreground {np.mean(fg):.3f}; limit {HOSTDATA_AGREE:.1%}); "
              f"request decode at {size}^2: native "
              + (f"{statistics.median(t_dec['native']):.3f}"
                 if t_dec["native"] else "not measured (decode absent)")
              + f" ms, PIL {statistics.median(t_dec['pil']):.3f} ms "
              f"(medians); POST latency JPEG "
              f"{statistics.median(lat['jpeg']):.1f} ms, PNG "
              f"{statistics.median(lat['png']):.1f} ms")
        phase("hostdata", f"daemon: POST /reload -> HTTP {rs} in "
              f"{reload_s:.3f} s under {HOSTDATA_CLIENTS} clients "
              f"({len(statuses)} requests, statuses "
              f"{sorted(set(statuses))}); mask changed "
              f"{not np.array_equal(before, after)}; --watch reloaded the "
              f"rewritten .npz after {watch_s:.3f} s (reloads "
              f"{server.n_reloads}), mask changed "
              f"{not np.array_equal(after, watched)}; /metrics series "
              f"{sorted(series)} equal JAX's {series == set(METRICS_JAX)}; "
              f"/stats reloads {stats['reloads']} batches_by_program "
              f"{stats['batches_by_program']}; flash_fwd launches "
              f"{launches} for {batches} batches + {warmups} warm-ups "
              f"(expected {N_LAYERS} each"
              + (")" if DEVICE == "cuda" else "; the card only)"))
        assert share >= HOSTDATA_AGREE
        assert rs == 200, rdata[:300]
        assert statuses == [200] * (4 * HOSTDATA_CLIENTS)
        assert not np.array_equal(before, after)
        assert server.n_reloads == 2 and not np.array_equal(after, watched)
        assert series == set(METRICS_JAX)
        assert "ddti_reloads_total 2" in metrics
        assert stats["reloads"] == 2
        assert launches == (N_LAYERS * (batches + warmups)
                            if DEVICE == "cuda" else 0)
        out = dict(agree=share, reload_s=reload_s, watch_s=watch_s,
                   launches=launches, batches=batches,
                   decode_ms={k: statistics.median(v) if v else None
                              for k, v in t_dec.items()},
                   post_ms={k: statistics.median(v) for k, v in lat.items()})
    finally:
        server.shutdown()
        server.close()
        thread.join(timeout=30)
    return out


def run_hostdata(tmp):
    """The hostdata phase: (a) the library, (b) decode, (c) the CLI runs,
    (d) the host step card vs CPU, (e) step time by source, (f) the
    daemon; (e) on the card only."""
    t0 = time.perf_counter()
    root = os.path.join(tmp, "hostdata")
    counts = write_hostdata(root)
    out = dict(library=hostdata_library(),
               decode=hostdata_decode(root, TRAIN["image_size"]))
    # the CLI runs' processes wait on the card most of the time: the host
    # step's CPU work goes on beside them
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        runs = pool.submit(hostdata_runs, tmp, root, counts)
        out["step"] = hostdata_step(root)
        out["runs"] = runs.result()
    if DEVICE == "cuda":
        out["steps"] = hostdata_timing(root)
    else:
        phase("hostdata", "(e): not run (no card)")
    out["daemon"] = hostdata_daemon(tmp, root)
    out["phase_s"] = time.perf_counter() - t0
    phase("hostdata", f"phase wall time {out['phase_s']:.1f} s")
    return out


def hostdata_only():
    """The hostdata phase alone: ``python3 chip_smoke.py --hostdata``."""
    import torch

    from ddti_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this phase "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["DDTI_POLY_EXP2"] = "0"
    _build.build()  # once, before the CLI processes load it
    with tempfile.TemporaryDirectory() as tmp:
        hostdata = run_hostdata(tmp)
    print(json.dumps({"hostdata": hostdata}))
    return 0


# ---------------------------------------------------------------------------
# the trainer phase: the rest of single-device training on the flagship


def kernel_launches(names, kernel):
    """Launches of one hand-written kernel among a profiler's kernel names
    (``(anonymous namespace)::edt_row_kernel(float*, ...)``, ``void
    flash_fwd_bf16_kernel<32, false>(...)`` or the bare name): the EDT's by
    its row pass, which runs once a call, the flash forward's by its bf16
    kernel (TRACE_KERNELS)."""
    import re

    pat = re.compile(rf"(^|[\s:]){TRACE_KERNELS[kernel]}\b")
    return sum(1 for n in names if pat.search(n))


def trace_kernel_names(path):
    """The names of the kernel events (``"cat": "kernel"``) of a Chrome
    trace that torch.profiler exported: every launch, a CUDA graph's
    replayed kernels among them."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [e.get("name", "") for e in events
            if str(e.get("cat", "")).lower() == "kernel"]


def _trace_summary(path):
    """What a trace holds, for a count that came out wrong: its event
    categories and the names that mention the EDT."""
    import collections

    with open(path) as f:
        events = json.load(f)["traceEvents"]
    cats = collections.Counter(str(e.get("cat")) for e in events)
    edt = sorted({e.get("name", "")[:80] for e in events
                  if "edt" in str(e.get("name", "")).lower()})
    return f"categories {dict(cats)}, EDT names {edt[:4]}"


def parse_autobatch(text):
    """``--batch_size auto``'s log lines: ([(batch, peak bytes, cap bytes,
    fits)], the selected batch or None; a candidate refused by the card or
    extrapolated over the budget, not run, is (batch, None, None,
    False))."""
    import re

    rows, picked = [], None
    for line in text.splitlines():
        m = re.search(r"\[autobatch\] batch (\d+)/device: measured peak .*"
                      r"\((fits|over); (\d+) B, cap (\d+) B\)", line)
        if m:
            rows.append((int(m[1]), int(m[3]), int(m[4]), m[2] == "fits"))
            continue
        m = re.search(r"\[autobatch\] batch (\d+)/device: (out of memory"
                      r"|.* extrapolated)", line)
        if m:
            rows.append((int(m[1]), None, None, False))
            continue
        m = re.search(r"\[autobatch\] selected --batch_size (\d+)", line)
        if m:
            picked = int(m[1])
    return rows, picked


def parse_fused_run(text):
    """A CLI run's log: each fused epoch's graph replays (``Fused epoch:
    ... N graph replays``) and ``--batch_size auto``'s peak of the run,
    (allocated, reserved) bytes, or None."""
    import re

    replays = [int(m) for m in re.findall(
        r"Fused epoch: step 0 eager, 1 step captured, (\d+) graph replays",
        text)]
    m = re.search(r"\[autobatch\] the run's peak: .*\((\d+) B, (\d+) B\)",
                  text)
    return replays, ((int(m[1]), int(m[2])) if m else None)


def _timed_ms(fn):
    import torch

    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def trainer_bn():
    """(a) The flagship's bf16 step with one-pass and with two-pass
    BatchNorm variance, interleaved (CUDA-event medians of TRAINER_TIMED
    after 2 warm-up steps each), and the running statistics one step of
    each leaves from one start; then the one-pass module on the card
    against its plain float64 formula on the CPU, on the bottleneck's first
    BatchNorm input of that step: statistics, output and input gradient
    within BN_LIMITS. Returns the results and the start's weights (SEED's,
    on the card), which (b) starts from too."""
    import torch

    from ddti_tpu_torch.models import blocks
    from ddti_tpu_torch.train.state import TrainState

    size, batch = TRAIN["image_size"], TRAIN["batch_size"]
    model, state, step, (images, masks, draws) = _train_setup(size, batch,
                                                              True)
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    bns = [m for m in model.modules() if isinstance(m, blocks.BatchNorm2d)]
    probe = max(bns, key=lambda m: m.weight.numel())
    seen = {}
    hook = probe.register_forward_pre_hook(
        lambda mod, args: seen.setdefault("x", args[0].detach().clone()))
    stats = {}
    for label, exact in (("one_pass", False), ("two_pass", True)):
        model.load_state_dict(sd0)
        blocks.set_bn_exact_variance(model, exact)
        step(TrainState(model, 1e-5, 4), images, masks, draws, None)
        _sync()
        stats[label] = {k: v.clone() for k, v in model.named_buffers()}
        hook.remove()
    diff = _normwise(stats["one_pass"], stats["two_pass"])
    var_rel = max(float(((stats["one_pass"][k] - stats["two_pass"][k]).abs()
                         / stats["two_pass"][k].abs().clamp_min(1e-12)).max())
                  for k in stats["two_pass"] if k.endswith("running_var"))
    phase("trainer", f"(a) running statistics after one step, one-pass vs "
          f"two-pass: {diff:.3e} normwise, running_var {var_rel:.3e} "
          f"relative at most")
    assert diff < BN_LIMITS["running"], diff

    # the step with each BatchNorm mode, and one-pass with the AdamW that
    # CUDA runs took before the capturable one (a float lr, its step on the
    # host): what making every CUDA AdamW capturable costs the stepwise loop
    model.load_state_dict(sd0)
    state = TrainState(model, 1e-5, 4)
    host_adamw = TrainState(model, 1e-5, 4)
    host_adamw.optimizer = torch.optim.AdamW(
        host_adamw.trainable, lr=1e-5, betas=(0.9, 0.999), eps=1e-8,
        weight_decay=1e-2)
    host_adamw.capturable = False
    modes = (("one_pass", False, state), ("two_pass", True, state),
             ("one_pass_host_adamw", False, host_adamw))
    times = {label: [] for label, _, _ in modes}
    for r in range(2 + TRAINER_TIMED):
        for label, exact, st in modes:
            blocks.set_bn_exact_variance(model, exact)
            ms = _timed_ms(lambda: step(st, images, masks, draws, None))
            if r >= 2:
                times[label].append(ms)
    del host_adamw
    ms = {k: statistics.median(v) for k, v in times.items()}
    phase("trainer", f"(a) bf16 step at {size}^2 / batch {batch}: one-pass "
          f"{ms['one_pass']:.2f} ms, two-pass {ms['two_pass']:.2f} ms; "
          f"one-pass with the host-scalar AdamW "
          f"{ms['one_pass_host_adamw']:.2f} ms (medians of {TRAINER_TIMED},"
          f" interleaved)")
    top = {}
    for label, exact in (("one_pass", False), ("two_pass", True)):
        blocks.set_bn_exact_variance(model, exact)
        top[label] = _step_kernels(
            f"(a) {label}", lambda: step(state, images, masks, draws, None))
    return dict(step_ms=ms, running_normwise=diff, running_var_rel=var_rel,
                top_kernels=top, probe=_bn_vs_float64(probe, seen["x"])), sd0


def _step_kernels(label, one, steps=1):
    """A torch.profiler window over ``steps`` calls of ``one``: the
    kernels' summed device time a call and the top PROFILE_TOP kernels'
    (share, ms a call, name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            one()
        torch.cuda.synchronize()
    kernels = device_kernels(prof)
    total = sum(e.self_device_time_total for e in kernels)
    rows = [(e.self_device_time_total / max(total, 1),
             e.self_device_time_total / steps / 1e3, e.key[:90])
            for e in sorted(kernels, key=lambda e: -e.self_device_time_total)
            [:PROFILE_TOP]]
    phase("trainer", f"{label}: kernels {total / steps / 1e3:.3f} ms a step")
    for share, ms, name in rows:
        phase("trainer", f"  {share:6.1%} {ms:8.3f} ms  {name}")
    return dict(kernel_ms=total / steps / 1e3, top=rows)


def _bn_vs_float64(bn, x):
    """The one-pass BatchNorm (train mode, a copy) on the card against its
    formula in float64 on the CPU, on activations ``x`` (bf16): mean and
    variance relative to the float64 ones' scale, the bf16 output within
    BN_LIMITS["output"] of max|y|, the input gradient of sum(y * r)
    normwise."""
    import torch

    from ddti_tpu_torch.models import blocks

    bn = copy.deepcopy(bn).train()
    bn.exact_variance = False
    r = torch.randn(x.shape, generator=torch.Generator(device=x.device)
                    .manual_seed(SEED), device=x.device)
    xg = x.clone().requires_grad_()
    y = bn(xg)
    (y.float() * r).sum().backward()
    mean, var = blocks.one_pass_stats(x)

    xd = x.detach().double().cpu().requires_grad_()
    w, b = (t.detach().double().cpu()[None, :, None, None]
            for t in (bn.weight, bn.bias))
    md = xd.mean(dim=(0, 2, 3), keepdim=True)
    vd = (xd * xd).mean(dim=(0, 2, 3), keepdim=True) - md * md
    yd = (xd - md) / torch.sqrt(vd + blocks.BN_EPS) * w + b
    (yd * r.double().cpu()).sum().backward()
    scale = float((xd * xd).mean().sqrt())
    out = dict(
        shape=list(x.shape), dtype=str(x.dtype).replace("torch.", ""),
        mean_err=float((mean.double().cpu() - md.flatten()).abs().max())
        / scale,
        var_err=float((var.double().cpu() - vd.flatten()).abs().max())
        / scale ** 2,
        out_err=float((y.detach().double().cpu() - yd.detach()).abs().max())
        / float(yd.detach().abs().max()),
        grad_err=float((xg.grad.double().cpu() - xd.grad).norm()
                       / xd.grad.norm()))
    phase("trainer", "(a) one-pass BatchNorm " + ", ".join(
        f"{k} {v:.3e}" if isinstance(v, float) else f"{k} {v}"
        for k, v in out.items()) + f" (limits {BN_LIMITS})")
    assert out["mean_err"] < BN_LIMITS["stats"], out
    assert out["var_err"] < BN_LIMITS["stats"], out
    assert out["out_err"] < BN_LIMITS["output"], out
    assert out["grad_err"] < BN_LIMITS["grad"], out
    return out


def _fused_trainers(tmp, store, sd0, n):
    """``n`` Trainers from the weights ``sd0``, the flagship at 512^2 /
    batch 16 in bf16 on ``store``; each (label, fused) in turn."""
    import dataclasses

    from ddti_tpu_torch.core.config import Config
    from ddti_tpu_torch.core.logging import create_logger
    from ddti_tpu_torch.models import create_model
    from ddti_tpu_torch.train.engine import Trainer

    model_kw = dict(base_filters=TRAIN["base_filters"], depth=TRAIN["depth"])
    cfg = Config(model_type="ResUNet", image_size=TRAIN["image_size"],
                 store_size=TRAIN["image_size"],
                 batch_size=TRAIN["batch_size"], use_amp_autocast=True,
                 epochs=1, log_every=0, base_dir=os.path.join(tmp, "fused"))
    for label, fused in n:
        c = dataclasses.replace(cfg, fused_epoch=fused)
        c.make_dirs()
        model = create_model("ResUNet", **model_kw).to(DEVICE)
        model.load_state_dict(sd0)
        yield label, Trainer(c, (store, store, store), create_logger(
            os.path.join(c.log_dir, f"{label}.log"), console=False), model)


def trainer_fused(tmp, sd0):
    """(b) Two stepwise and two fused epochs of the flagship (bf16, 512^2
    / batch 16) from one start state on a TRAINER_STORE-frame store, cuDNN
    deterministic, the second epoch timed and its EDT launches counted by
    the wrapper (a fused epoch's: the eager step's and the capture's);
    then two fused epochs again, the second under torch.profiler. The
    fused epoch's replays; its parameters and statistics equal to the
    stepwise epoch's and to the second fused run's, bit for bit; the EDT's
    launches in the profiled epoch from the exported trace's kernel names,
    against the eager step's plus the captured step's times the replays."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from ddti_tpu_torch.data.dataset import synthetic_source
    from ddti_tpu_torch.ops import edt as E

    size = TRAIN["image_size"]
    store = synthetic_source(TRAINER_STORE, (size, size), SEED,
                             device=DEVICE)
    steps = TRAINER_STORE // TRAIN["batch_size"]
    torch.backends.cudnn.deterministic = True
    ends, out, wrapper, counted = {}, {}, {}, None
    try:
        for label, tr in _fused_trainers(tmp, store, sd0, (
                ("stepwise", False), ("fused", True),
                ("fused_profiled", True))):
            # epoch 1 warms the deterministic algorithms' plans up, which
            # the first timed epoch would pay alone; epoch 2 is measured
            tr.train_one_epoch(0)
            _sync()
            if label == "fused_profiled":
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    tr.train_one_epoch(1)
                    _sync()
                trace = os.path.join(tmp, f"{label}.json")
                prof.export_chrome_trace(trace)
                counted = kernel_launches(trace_kernel_names(trace),
                                          "edt_minplus")
                if counted != steps:
                    phase("trainer", f"(b) {label}: {_trace_summary(trace)}")
            else:
                e0 = E.edt_cuda.launches
                t0 = time.perf_counter()
                tr.train_one_epoch(1)
                _sync()
                out[f"{label}_s"] = time.perf_counter() - t0
                wrapper[label] = E.edt_cuda.launches - e0
            ends[label] = {k: v.detach().clone() for k, v in
                           tr.model.state_dict().items()}
            if tr.fused:
                assert tr.fused_stats == {"captured": 1,
                                          "replays": steps - 1}, (
                    tr.fused_stats)
                out["replays"] = tr.fused_stats["replays"]
            del tr
    finally:
        torch.backends.cudnn.deterministic = False
    # the EDT's launches a fused epoch: the eager step's (a stepwise
    # step's), the captured step's (the wrapper's count less the eager
    # step's) at every replay
    eager = wrapper["stepwise"] // steps
    captured = wrapper["fused"] - eager
    start = {k: v.to(DEVICE) for k, v in sd0.items()}
    diffs, equal = {}, {}
    for what, keys in (("parameters", [k for k in start
                                       if "running_" not in k]),
                       ("statistics", [k for k in start
                                       if "running_" in k])):
        def sub(d):
            return {k: d[k] for k in keys}

        diffs[what] = dict(
            update=_normwise(sub(ends["stepwise"]), sub(start)),
            fused=_normwise(sub(ends["fused"]), sub(ends["stepwise"])),
            fused_again=_normwise(sub(ends["fused_profiled"]),
                                  sub(ends["fused"])))
        equal[what] = all(
            torch.equal(ends["fused"][k], ends[other][k])
            for k in keys for other in ("stepwise", "fused_profiled"))
    out.update(steps=steps, diffs=diffs, bit_equal=equal,
               edt_wrapper=wrapper, edt_profiled=counted,
               edt_total=eager + captured * out["replays"])
    phase("trainer", f"(b) {steps} steps, epoch 2 timed: stepwise epoch "
          f"{out['stepwise_s']:.3f} s, fused {out['fused_s']:.3f} s (1 eager "
          f"step + {out['replays']} replays); "
          + "; ".join(f"{w}: fused vs stepwise {d['fused']:.3e} normwise, "
                      f"fused vs fused {d['fused_again']:.3e}, bit for bit "
                      f"{equal[w]}, the epoch's change {d['update']:.3e}"
                      for w, d in diffs.items())
          + f"; EDT launches: by the wrapper {wrapper} (fused: the eager "
          f"step's {eager} and the capture's {captured}), by the profiler "
          f"{counted} in the profiled fused epoch, eager + captured x "
          f"replays = {out['edt_total']}")
    assert all(equal.values()), diffs
    assert (eager, captured) == (1, 1), wrapper
    return out


def _trainer_cmd(base, *flags, data=None):
    """The training CLI in bf16 on its synthetic frames, or on the dataset
    at ``data``."""
    src = ["--synthetic"] if data is None else ["--dataset_path", data]
    return [sys.executable, "-m", "ddti_tpu_torch.cli.main", *src,
            "--use_amp_autocast", "true", "--base_dir", base,
            "--log_every", "0", *flags]


def trainer_auto_data(tmp):
    """(c)'s dataset: TRAINER_AUTO_FRAMES train frames, 16 val, 16 test at
    TRAIN's size, as JPEGs in the reference's layout."""
    from ddti_tpu_torch.data.synthetic import write_synthetic_dataset

    data = os.path.join(tmp, "trainer_auto_data")
    size = TRAIN["image_size"]
    write_synthetic_dataset(data, TRAINER_AUTO_FRAMES, 16, 16, (size, size),
                            SEED)
    return data


def trainer_autobatch(tmp, data):
    """(c) ``--batch_size auto --fused_epoch --epochs 1 --mode train`` on
    the flagship at 512^2 on ``data`` (``trainer_auto_data``), alone on
    the card (its budget is what is free when it probes): each
    candidate's measured peak (the eager step's, or the probe's state and
    its captured step's graph pool), the pick's within 0.92 of the
    budget; at the pick a fused epoch of an eager step and graph replays,
    and the run's peak, allocated and reserved, within the budget; the
    EDT's wrapper launches: the eager train step's, the capture's and a
    val step's, plus at most two a probe (its eager step and, fused, its
    capture)."""
    import glob

    size = TRAIN["image_size"]
    base = os.path.join(tmp, "trainer_auto")
    cmd = _trainer_cmd(base, "--mode", "train", "--model_type", "ResUNet",
                       "--base_filters", str(TRAIN["base_filters"]),
                       "--depth", str(TRAIN["depth"]),
                       "--image_size", str(size), "--store_size", str(size),
                       "--epochs", "1", "--batch_size", "auto",
                       "--fused_epoch", data=data)
    phase("trainer", "(c) " + " ".join(cmd[1:]))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=TRAIN_TIMEOUT_S)
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-8000:], sep="\n",
              file=sys.stderr)
    assert res.returncode == 0, "the --batch_size auto run failed"
    (log,) = glob.glob(os.path.join(base, "*", "log", "train_log.log"))
    text = open(log).read()
    rows, picked = parse_autobatch(text)
    fit = [r for r in rows if r[0] == picked]
    assert picked and fit and fit[0][3], (rows, picked)
    _, peak, cap, _ = fit[0]
    assert peak <= cap, (peak, cap)
    replays, run_peak = parse_fused_run(text)
    train_b = -(-TRAINER_AUTO_FRAMES // picked)
    val = -(-16 // picked)
    assert replays == [train_b - 1] and train_b >= 2, (replays, picked)
    assert run_peak is not None and max(run_peak) <= cap / 0.92, (run_peak,
                                                                   cap)
    kernels = [l for l in res.stdout.splitlines()
               if l.startswith("[KERNELS]")][0]
    edt = int(kernels.split()[1].split("=")[1])
    low = 2 + val  # the eager step, the capture, the val steps
    probes = sum(1 for r in rows if r[1] is not None)
    wall = time.perf_counter() - t0
    phase("trainer", "(c) autobatch: " + ", ".join(
        f"{b}: {'not run' if p is None else f'{p / 2**30:.2f} GiB'}"
        for b, p, _, _ in rows) + f"; picked {picked} (peak "
        f"{peak / 2**30:.2f} GiB <= cap {cap / 2**30:.2f} GiB = 0.92 of the "
        f"budget); fused epoch of {train_b} steps: 1 eager + {replays[0]} "
        f"replays; the run's peak {run_peak[0] / 2**30:.2f} GiB allocated, "
        f"{run_peak[1] / 2**30:.2f} GiB reserved ({run_peak[1] / cap:.1%} "
        f"of the cap); EDT wrapper launches {edt}, "
        f"{low} for the eager step, the capture and {val} val steps, and "
        f"up to 2 for each of {probes} probes; run {wall:.1f} s")
    assert low <= edt <= low + 2 * probes, (edt, low, rows)
    return dict(candidates=[dict(batch=b, peak_bytes=p, cap_bytes=c,
                                 fits=f) for b, p, c, f in rows],
                picked=picked, train_steps=train_b, replays=replays[0],
                run_peak_bytes=dict(zip(("allocated", "reserved"), run_peak)),
                edt_launches=edt, wall_s=wall)


def check_profile_trace(best, label="trainer"):
    """(c) ``--profile PROFILE_STEPS``' trace of the CLI run whose best
    weights are ``best``: under result/trace, the EDT's row kernel once a
    traced train step."""
    import glob

    run = os.path.dirname(os.path.dirname(best))
    traces = glob.glob(os.path.join(run, "result", "trace", "*.json"))
    assert len(traces) == 1, f"no trace under {run}/result/trace"
    edt = kernel_launches(trace_kernel_names(traces[0]), "edt_minplus")
    phase(label, f"(c) --profile {PROFILE_STEPS}: "
          f"{os.path.basename(traces[0])}, {os.path.getsize(traces[0])} "
          f"bytes, {edt} EDT row-kernel events")
    assert edt == PROFILE_STEPS, edt
    return dict(trace_bytes=os.path.getsize(traces[0]), edt_events=edt)


def trainer_profile_run(tmp):
    """(c) ``--profile PROFILE_STEPS`` on the flagship (512^2 / batch 16, 1
    epoch) when the phase runs alone (the whole smoke traces the train
    phase's run): run_cli's checks and ``check_profile_trace``."""
    model_kw = dict(base_filters=TRAIN["base_filters"], depth=TRAIN["depth"])
    flags = [f"--{k}={v}" for k, v in TRAIN.items()
             if k not in ("model_type", "epochs")] + [
                 "--profile", str(PROFILE_STEPS)]
    _, best = run_cli(tmp, "trainer_profile", "ResUNet", model_kw, flags, 1,
                      jax_resunet_keys(TRAIN["depth"]))
    return check_profile_trace(best)


def trainer_lr_find(tmp):
    """(c) ``--lr_find TRAINER_LR_FIND`` on the flagship at 256^2: that
    many finite rows in lr_find.csv or a stated stop, finite
    suggestions."""
    import glob
    import math

    base = os.path.join(tmp, "trainer_lr_find")
    cmd = _trainer_cmd(base, "--mode", "train", "--model_type", "ResUNet",
                       "--base_filters", str(TRAIN["base_filters"]),
                       "--depth", str(TRAIN["depth"]), "--image_size", "256",
                       "--store_size", "256", "--batch_size", "16",
                       "--lr_find", str(TRAINER_LR_FIND))
    phase("trainer", "(c) " + " ".join(cmd[1:]))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True,
                         timeout=TRAIN_TIMEOUT_S)
    if res.returncode != 0:
        print(res.stdout[-4000:], res.stderr[-8000:], sep="\n",
              file=sys.stderr)
    assert res.returncode == 0, "the --lr_find run failed"
    line = [l for l in res.stdout.splitlines() if l.startswith("[LR_FIND]")]
    sugg = dict(kv.split("=") for kv in line[0].split()[1:])
    sugg = {k: float(v) for k, v in sugg.items()}
    (csv,) = glob.glob(os.path.join(base, "*", "result", "lr_find.csv"))
    rows = [[float(x) for x in r.split(",")]
            for r in open(csv).read().splitlines()[1:]]
    (log,) = glob.glob(os.path.join(base, "*", "log", "train_log.log"))
    said = [l for l in open(log).read().splitlines()
            if "LR range test:" in l][0]
    stop = said.split("(", 1)[1].split(")", 1)[0]
    phase("trainer", f"(c) --lr_find {TRAINER_LR_FIND}: {line[0]}, "
          f"{len(rows)} rows ({stop}) in {time.perf_counter() - t0:.1f} s")
    assert all(math.isfinite(v) for r in rows for v in r)
    assert len(rows) == TRAINER_LR_FIND or stop != "completed", (rows, stop)
    assert all(math.isfinite(v) and v > 0 for v in sugg.values()), sugg
    return dict(rows=len(rows), stop=stop, **sugg)


def trainer_distill_run(tmp, ckpt):
    """(d) One epoch of a UNet student (TRAINER_STUDENT, 512^2 / batch 16,
    bf16) under the TransUNet checkpoint ``ckpt`` as teacher, through the
    CLI: run_cli's checks, the flash forward launched 4 times (one a
    teacher layer) a train step and the EDT once a train and val step and
    test batch."""
    flags = [f"--base_filters={TRAINER_STUDENT['base_filters']}",
             f"--depth={TRAINER_STUDENT['depth']}",
             f"--image_size={TRAIN['image_size']}",
             f"--batch_size={TRAIN['batch_size']}",
             "--distill_checkpoint", ckpt, "--distill_model_type",
             "TransUNet", f"--distill_base_filters={SLICE['base_filters']}",
             f"--distill_depth={SLICE['depth']}"]
    launches, _ = run_cli(tmp, "trainer_distill", "UNet", TRAINER_STUDENT,
                          flags, 1, jax_zoo_keys("UNet",
                                                 TRAINER_STUDENT["depth"]))
    steps, val, test_b = _cli_batches(TRAIN["batch_size"])
    phase("trainer", f"(d) distillation CLI: flash_fwd "
          f"{launches['flash_fwd']} = {N_LAYERS} x {steps} train steps, "
          f"edt_minplus {launches['edt_minplus']} = {steps} + {val} + "
          f"{test_b}")
    assert launches["flash_fwd"] == N_LAYERS * steps, launches
    assert launches["edt_minplus"] == steps + val + test_b, launches
    return launches


def trainer_distill_step(ckpt):
    """(d) The UNet student's bf16 step at 512^2 / batch 16 with and
    without the teacher (CUDA-event medians of TRAINER_TIMED, interleaved)
    and the kernels each step launches."""
    from ddti_tpu_torch.core.config import Config
    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.ops import edt as E
    from ddti_tpu_torch.train.distill import teacher_from_config
    from ddti_tpu_torch.train.steps import make_train_step

    size, batch = TRAIN["image_size"], TRAIN["batch_size"]
    model, state, plain, (images, masks, draws) = _train_setup(
        size, batch, True, model_type="UNet", model_kw=TRAINER_STUDENT)
    cfg = Config(model_type="UNet", image_size=size, batch_size=batch,
                 use_amp_autocast=True, model_kwargs=dict(TRAINER_STUDENT),
                 distill_checkpoint=ckpt, distill_model_type="TransUNet",
                 distill_base_filters=SLICE["base_filters"],
                 distill_depth=SLICE["depth"])
    teacher = teacher_from_config(cfg, DEVICE)
    kd = make_train_step(cfg, _aug_of(size), teacher=teacher)
    times = {"student": [], "with_teacher": []}
    per_step = {}
    for r in range(2 + TRAINER_TIMED):
        for label, fn in (("student", plain), ("with_teacher", kd)):
            f0, e0 = A.flash_forward_cuda.launches, E.edt_cuda.launches
            ms = _timed_ms(lambda: fn(state, images, masks, draws, None))
            per_step[label] = dict(
                flash_fwd=A.flash_forward_cuda.launches - f0,
                edt_minplus=E.edt_cuda.launches - e0)
            if r >= 2:
                times[label].append(ms)
    ms = {k: statistics.median(v) for k, v in times.items()}
    phase("trainer", f"(d) UNet student step: {ms['student']:.2f} ms alone, "
          f"{ms['with_teacher']:.2f} ms with the TransUNet teacher "
          f"(medians of {TRAINER_TIMED}); launches a step {per_step}")
    assert per_step["with_teacher"] == dict(flash_fwd=N_LAYERS,
                                            edt_minplus=1), per_step
    assert per_step["student"] == dict(flash_fwd=0, edt_minplus=1), per_step
    return dict(step_ms=ms, launches_per_step=per_step)


def _aug_of(size):
    from ddti_tpu_torch.data.augment import AugmentConfig

    return AugmentConfig(out_size=(size, size))


def teacher_checkpoint(tmp):
    """The serving slice's TransUNet (SLICE) with run_slice's seeded random
    weights, as a .pth: the teacher of (d) when the phase runs alone."""
    import torch

    from ddti_tpu_torch.models import create_model

    ckpt = os.path.join(tmp, "teacher_transunet_bf64_d4_512.pth")
    torch.save(random_state(create_model("TransUNet", **SLICE), SEED), ckpt)
    return ckpt


def run_trainer(tmp, ckpt, profile=None):
    """The trainer phase: (a) and (b) in this process, then (c)'s and
    (d)'s CLI runs at once: --lr_find, the distillation run, and --profile
    unless the train phase's run traced (``profile``, its check), while
    (c)'s dataset is written; then --batch_size auto alone (a fused
    epoch's graph pool beside another run's memory would not fit what it
    measured free); then (d)'s step times. Each part's wall time is
    printed."""
    import gc

    import torch

    t0 = time.perf_counter()
    out = {}
    out["bn"], sd0 = trainer_bn()
    t1 = time.perf_counter()
    out["fused"] = trainer_fused(tmp, sd0)
    t2 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()  # the card's memory to the CLI runs
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        prof = (pool.submit(trainer_profile_run, tmp) if profile is None
                else None)
        data = pool.submit(trainer_auto_data, tmp)
        lrf = pool.submit(trainer_lr_find, tmp)
        dist = pool.submit(trainer_distill_run, tmp, ckpt)
        out["lr_find"], out["distill_cli"] = lrf.result(), dist.result()
        out["profile"] = profile if prof is None else prof.result()
        data = data.result()
    t_auto = time.perf_counter()
    out["autobatch"] = trainer_autobatch(tmp, data)
    t3 = time.perf_counter()
    out["distill_step"] = trainer_distill_step(ckpt)
    out["phase_s"] = time.perf_counter() - t0
    out["part_s"] = dict(bn=t1 - t0, fused=t2 - t1, cli=t_auto - t2,
                         autobatch=t3 - t_auto,
                         distill_step=out["phase_s"] - (t3 - t0))
    phase("trainer", f"phase wall time {out['phase_s']:.1f} s ("
          + ", ".join(f"{k} {v:.1f} s" for k, v in out["part_s"].items())
          + ")")
    # (b)'s launches by the profiler, checked once every part has printed
    steps = out["fused"]["steps"]
    assert out["fused"]["edt_profiled"] == out["fused"]["edt_total"] \
        == steps, out["fused"]
    return out


def trainer_only():
    """The trainer phase alone: ``python3 chip_smoke.py --trainer``."""
    import torch

    from ddti_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this phase "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["DDTI_POLY_EXP2"] = "0"
    _build.build()  # once, before the CLI processes load it
    with tempfile.TemporaryDirectory() as tmp:
        trainer = run_trainer(tmp, teacher_checkpoint(tmp))
    print(json.dumps({"trainer": trainer}))
    return 0



# ---------------------------------------------------------------------------
# deploy: the int8 conv, QAT, the serving bundles, cli/export, cli/quantize
# and the daemon on a two-program int8 set
# ---------------------------------------------------------------------------

PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core operations per second
# the conv_s8 kernel vs its plain version at every zoo geometry, at a small
# frame with odd sides: (n, h, w)
DEPLOY_GEOMETRY_FRAME = (2, 33, 30)
# the flagship ResUNet's (bf64, d5) first-level 3x3 conv at 512^2, bs16:
# (n, h, w, cin, cout), the kernels line's row; under --deploy every level
DEPLOY_CONV = (16, 512, 512, 64, 64)
DEPLOY_CONV_LEVELS = [(16, 512 >> i, 512 >> i, 64 << i, 64 << i)
                      for i in range(5)]
DEPLOY_BATCHES = (1, 16)
DEPLOY_POSTS = 12
# the daemon's masks against serve_body's: its flushes batch the frames
# otherwise (cuBLAS and cuDNN pick their algorithms by shape), so a float
# op may round an ulp apart and a pixel at the threshold flip
DEPLOY_MASK_AGREE = 0.999


def conv_s8_bound(n, h, w, c, cout, k, stride, dil, pad, bf16):
    """(bound_ms, bound_by) of one conv_s8 call: int8 x read once, the
    int8 weights and the float32 scales and bias, the output written once,
    against 2 * outputs * k^2 * C int8 operations at PEAK_INT8_OPS."""
    from ddti_tpu_torch.ops.conv_s8 import conv_geometry

    _, _, oh, ow = conv_geometry(h, w, k, stride, dil, pad)
    taps = 1 if pad == "T" else k * k
    outs = n * oh * ow * cout
    nbytes = (n * h * w * c + k * k * c * cout + 8 * cout + 4
              + outs * (2 if bf16 else 4))
    ops_ms = 2 * outs * taps * c / PEAK_INT8_OPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def _conv_s8_inputs(n, h, w, c, cout, k, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.integers(-127, 128, (n, h, w, c),
                                      dtype=np.int8)).cuda()
    wq = torch.from_numpy(rng.integers(-127, 128, (k, k, c, cout),
                                       dtype=np.int8)).cuda()
    sx = torch.tensor(np.float32(0.0137)).cuda()
    sw = torch.from_numpy(rng.uniform(1e-4, 2e-2, cout).astype(
        np.float32)).cuda()
    bias = torch.from_numpy(rng.normal(size=cout).astype(np.float32)).cuda()
    return x, wq, sx, sw, bias


def deploy_conv_row(n, h, w, c, cout, seed=SEED):
    """The kernel at one flagship 3x3 shape (bf16 out, as a bf16 model's
    convs): bit-equal to its plain version, the time of one call between
    CUDA events and queued, the plain version's, the bound, and cuDNN's
    bf16 F.conv2d at the same shape (channels_last) as the yardstick: no
    PyTorch call computes an int8 convolution on CUDA."""
    import torch
    import torch.nn.functional as F

    from ddti_tpu_torch.ops import conv_s8 as C

    x, wq, sx, sw, bias = _conv_s8_inputs(n, h, w, c, cout, 3, seed)
    geo = (1, 1, 1, 1, h, w, False, True)
    got = C.conv_s8(x, wq, sx, sw, bias, *geo)
    want = C.conv_s8_reference(x, wq, sx, sw, bias, *geo)
    torch.cuda.synchronize()
    assert torch.equal(got, want), "conv_s8 differs from its plain version"
    ms = median_ms(lambda: C.conv_s8(x, wq, sx, sw, bias, *geo), runs=5,
                   warmup=1)
    _, queue = queued_ms(lambda: C.conv_s8(x, wq, sx, sw, bias, *geo),
                         calls=20)
    plain_ms = median_ms(lambda: C.conv_s8_reference(x, wq, sx, sw, bias,
                                                     *geo), runs=2, warmup=1)
    xf = x.permute(0, 3, 1, 2).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    wf = wq.permute(3, 2, 0, 1).to(torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    _, lib = queued_ms(lambda: F.conv2d(xf, wf, None, 1, 1), calls=20)
    b_ms, b_by = conv_s8_bound(n, h, w, c, cout, 3, 1, 1, 1, True)
    row = dict(shape=[n, h, w, c, cout], k=3, ms=ms, queue_ms=queue,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=lib, max_abs_err=0.0)
    phase("deploy", f"conv_s8 {n}x{h}x{w}x{c}->{cout} 3x3 bf16 out: "
          f"{ms:.3f} ms a call, {queue:.3f} ms queued, plain {plain_ms:.3f} "
          f"ms, bound {b_ms:.4f} ms ({b_by}), cuDNN bf16 F.conv2d "
          f"{lib:.3f} ms queued; bit-equal")
    return row


def deploy_conv_s8(levels=False):
    """conv_s8 against its plain version at every zoo geometry (float32 and
    bf16 out, s32 sums by unit scales), two calls bit-equal; then the
    flagship row (every level under --deploy)."""
    import torch

    from ddti_tpu_torch.ops import conv_s8 as C

    n, h, w = DEPLOY_GEOMETRY_FRAME
    for i, (name, k, s, d, pad, c, cout) in enumerate(C.ZOO_GEOMETRIES):
        x, wq, sx, sw, bias = _conv_s8_inputs(n, h, w, c, cout, k, SEED + i)
        pt, pl, oh, ow = C.conv_geometry(h, w, k, s, d, pad)
        for bf16 in (False, True):
            geo = (s, d, pt, pl, oh, ow, pad == "T", bf16)
            got = C.conv_s8(x, wq, sx, sw, bias, *geo)
            again = C.conv_s8(x, wq, sx, sw, bias, *geo)
            want = C.conv_s8_reference(x, wq, sx, sw, bias, *geo)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (name, bf16)
            assert torch.equal(got, again), (name, bf16)
        one = torch.ones((), device="cuda")
        acc = C.conv_s8(x, wq, one, torch.ones(cout, device="cuda"), None,
                        s, d, pt, pl, oh, ow, pad == "T", False)
        assert torch.equal(acc, C.conv_s8_int32(
            x, wq, s, d, pt, pl, oh, ow, pad == "T").float()), name
    phase("deploy", f"conv_s8 = its plain version bit for bit (s32 sums, "
          f"float32 and bf16 outputs, two calls equal) at all "
          f"{len(C.ZOO_GEOMETRIES)} zoo geometries on {n}x{h}x{w}: "
          + ", ".join(g[0] for g in C.ZOO_GEOMETRIES))
    rows = [deploy_conv_row(*shape) for shape in (
        DEPLOY_CONV_LEVELS if levels else [DEPLOY_CONV])]
    return rows


def deploy_clis(tmp, flagship):
    """At once, each its own process: the serving slice's TransUNet trained
    with --qat --export_serving --serving_dtype int8 --serving_batches 1,16
    (run_cli's checks; the flash and EDT launches counted), cli/export
    (f32) and cli/quantize (--min_channels 128, batch 1 and 16) on the
    flagship ResUNet's best weights; meanwhile this process exports the
    flagship's bf16 and int8 (min_channels 0) bundles
    (``deploy_exports``). Returns the QAT run's launches and models
    directory, the two CLIs' outputs and the bundles' paths."""
    import yaml

    cfg = os.path.join(tmp, "transunet_qat.yaml")
    with open(cfg, "w") as f:
        yaml.safe_dump({"model": {"model_type": "TransUNet",
                                  "kwargs": TSLICE}}, f)
    qat_flags = ["--config_path", cfg, "--device", DEVICE, "--qat",
                 "--export_serving", "--serving_dtype", "int8",
                 "--serving_batches", ",".join(map(str, DEPLOY_BATCHES)),
                 *(f"--{k}={v}" for k, v in TTRAIN.items() if k != "epochs")]
    arch = ["--model_type", "ResUNet", "--base_filters",
            str(TRAIN["base_filters"]), "--depth", str(TRAIN["depth"]),
            "--image_size", str(TRAIN["image_size"])]
    cmds = {
        "export": [sys.executable, "-m", "ddti_tpu_torch.cli.export",
                   "--checkpoint", flagship + ".npz", "--output",
                   os.path.join(tmp, "flag_f32"), "--batch_size", "16",
                   *arch],
        "quantize": [sys.executable, "-m", "ddti_tpu_torch.cli.quantize",
                     "--checkpoint", flagship + ".npz", "--output",
                     os.path.join(tmp, "flag_int8"), "--batch_size", "1,16",
                     "--min_channels", "128", "--calib_count", "16",
                     "--input_dtype", "uint8", "--bf16", *arch]}

    def run(name):
        t0 = time.perf_counter()
        res = subprocess.run(cmds[name], capture_output=True, text=True,
                             timeout=TRAIN_TIMEOUT_S)
        phase("deploy", f"cli/{name} exit {res.returncode} in "
              f"{time.perf_counter() - t0:.1f} s: "
              + " | ".join(res.stdout.strip().splitlines()))
        if res.returncode:
            print(res.stderr[-6000:], file=sys.stderr)
        assert res.returncode == 0, f"cli/{name} failed"
        return res.stdout

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        outs = {n: pool.submit(run, n) for n in cmds}
        exports = pool.submit(deploy_exports, tmp, flagship)
        launches, best = run_cli(tmp, "deploy", "TransUNet",
                                 dict(TSLICE, image_size=TTRAIN["image_size"]),
                                 qat_flags, TTRAIN["epochs"],
                                 jax_transunet_keys(TSLICE["depth"], N_LAYERS)
                                 | qstats_keys())
        outs = {n: f.result() for n, f in outs.items()}
        paths = exports.result()
    steps, val, test_b = _cli_batches(TTRAIN["batch_size"])
    # the flash forward also runs in --qat's one eval forward of a zero
    # frame that finds the tracked convs (qat.tracked_paths) and in the int8
    # export's BatchNorm folding, which checks the folded model against the
    # unfolded one on one frame (two forwards, fold_bn.fold_batchnorm)
    expected = {"flash_fwd": N_LAYERS * (steps + val + test_b + 3),
                "flash_bwd_dkdv": N_LAYERS * steps,
                "flash_bwd_dq": N_LAYERS * steps,
                "edt_minplus": steps + val + test_b, "conv_s8": 0}
    phase("deploy", "QAT run launches " + ", ".join(
        f"{k} {launches[k]} (expected {v})" for k, v in expected.items())
        + ": the flash kernels and the EDT train under --qat (the flash "
        "forward also in its set-up forward and the export's fold check); "
        "the int8 export traces the program, launching nothing")
    assert {k: launches[k] for k in expected} == expected
    return launches, os.path.dirname(best), outs, paths


def qstats_keys():
    """The ``qstats/<path>`` entries of a --qat run's .npz of the serving
    slice's TransUNet: every quantizable conv (all run in eval)."""
    from ddti_tpu_torch.train.quantize import conv_modules

    model = blank_model("TransUNet", **TSLICE,
                        image_size=TTRAIN["image_size"])
    return {f"qstats/{p}" for p in conv_modules(model, "TransUNet")}


def _bundle_batch_ms(path, trace=False):
    """One batch of a bundle at its own batch: the median of 5 calls
    between CUDA events (a whole program's hundreds of launches fill the
    launch queue, so they cannot wait behind queued_ms's sleep; the host's
    time up to the first launch is in it). With ``trace``, also where the
    device time of 2 batches goes (``bundle_trace``)."""
    import torch

    from ddti_tpu_torch.train.export import load_serving_bundle

    fn, batch, size, dt = load_serving_bundle(path)
    x = torch.zeros((batch, size, size, 1), dtype=dt, device="cuda")
    ms = median_ms(lambda: fn(x), runs=5, warmup=2)
    return ms, batch, (bundle_trace(lambda: fn(x)) if trace else None)


DEPLOY_TRACED = 2  # batches in the int8 bundle's torch.profiler window


def bundle_trace(one):
    """torch.profiler over DEPLOY_TRACED calls of ``one`` (a serving
    batch): the device kernels' time a batch, the conv_s8 kernels' share
    of it, the elementwise kernels' (the activations' quantize passes and
    layout copies among them), the busy share of the host's window (the
    exported graph runs node by node in Python), and the top kernels."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(BUSY_WINDOW):
            for _ in range(DEPLOY_TRACED):
                one()
            torch.cuda.synchronize()
    kernels = device_kernels(prof)
    if not kernels:
        phase("deploy", "int8 batch trace: no device time recorded: not "
              "measured")
        return None
    busy = device_busy(prof)
    total = sum(e.self_device_time_total for e in kernels)
    conv = sum(e.self_device_time_total for e in kernels
               if "conv_s8" in e.key)
    elem = sum(e.self_device_time_total for e in kernels
               if "elementwise" in e.key.lower())
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
    out = dict(kernel_ms=total / 1e3 / DEPLOY_TRACED,
               conv_s8_share=conv / total, elementwise_share=elem / total,
               busy=busy["union_us"] / max(busy["window_us"], 1),
               top=[[e.key[:80], e.self_device_time_total / total]
                    for e in top])
    phase("deploy", f"int8 batch trace ({DEPLOY_TRACED} batches): device "
          f"kernels {out['kernel_ms']:.2f} ms a batch, conv_s8 "
          f"{out['conv_s8_share']:.1%}, elementwise kernels "
          f"{out['elementwise_share']:.1%}, {busy_text(busy)}; top: "
          + "; ".join(f"{k} {v:.1%}" for k, v in out["top"]))
    return out


def deploy_exports(tmp, flagship):
    """The flagship ResUNet's bf16 bundle (bf16 weights and compute) and
    int8 bundle at min_channels 0 (calibrated on 16 synthetic frames), batch
    16, uint8 input, exported in this process. Returns {name: path} with
    the CLIs' f32 and int8 (min_channels 128) bundles."""
    import numpy as np
    import torch

    from ddti_tpu_torch.train.checkpoint import load_checkpoint_into
    from ddti_tpu_torch.train.export import (
        PROGRAM_SUFFIX,
        export_serving_program,
        save_bundle,
    )
    from ddti_tpu_torch.train.quantize import export_serving_int8

    model = load_checkpoint_into(
        flagship + ".npz", "ResUNet",
        blank_model("ResUNet", base_filters=TRAIN["base_filters"],
                    depth=TRAIN["depth"])).cuda().eval()
    size = TRAIN["image_size"]
    paths = {"f32": os.path.join(tmp, "flag_f32" + PROGRAM_SUFFIX),
             "int8_mc128": os.path.join(tmp, "flag_int8_b16" + PROGRAM_SUFFIX),
             "bf16": os.path.join(tmp, "flag_bf16" + PROGRAM_SUFFIX),
             "int8_mc0": os.path.join(tmp, "flag_int8_mc0" + PROGRAM_SUFFIX)}
    save_bundle(paths["bf16"], *export_serving_program(
        model, 16, size, input_dtype=torch.uint8, bf16=True,
        weights_dtype=torch.bfloat16))
    calib = torch.from_numpy(np.stack(make_frames(16, size, SEED + 9))[
        ..., None]).cuda().float() / 255.0
    save_bundle(paths["int8_mc0"], *export_serving_int8(
        model, 16, size, calib_images=calib, input_dtype=torch.uint8,
        bf16=True, min_channels=0, model_type="ResUNet"))
    return paths


def deploy_timings(paths):
    """One serving batch of 16 at 512^2 of each flagship bundle: f32
    (cli/export), bf16, int8 at min_channels 0 and 128 (cli/quantize); the
    int8 one at min_channels 0 also traced (``bundle_trace``)."""
    import torch

    out, trace = {}, None
    for name in ("f32", "bf16", "int8_mc0", "int8_mc128"):
        ms, batch, traced = _bundle_batch_ms(paths[name],
                                             trace=name == "int8_mc0")
        assert batch == 16
        out[name] = ms
        trace = trace or traced
        torch.cuda.empty_cache()
    phase("deploy", "flagship ResUNet (bf64 d5) one serving batch of 16 at "
          f"{TRAIN['image_size']}^2, CUDA events, median of 5: "
          + ", ".join(f"{k} {v:.2f} ms" for k, v in out.items()))
    return dict(batch_ms=out, int8_mc0_trace=trace)


def deploy_daemon(models_dir):
    """The daemon on the QAT run's two-program int8 set (batch 1 and 16,
    one copy of the tensors): one frame alone, then DEPLOY_POSTS at once;
    /stats counts both programs; the masks against serve_body's with the
    int8 graph (``quantized_apply``, bf16) on the bundle's own tensors;
    the conv_s8 and flash launches of these requests."""
    import numpy as np
    import torch
    from PIL import Image

    from ddti_tpu_torch.cli import serve
    from ddti_tpu_torch.ops import attention as A
    from ddti_tpu_torch.ops import conv_s8 as C
    from ddti_tpu_torch.train.export import (
        PROGRAM_SUFFIX,
        load_serving_bundle,
        serve_body,
    )
    from ddti_tpu_torch.train.quantize import quantized_apply

    paths = [os.path.join(models_dir, f"TransUNet_b{b}{PROGRAM_SUFFIX}")
             for b in DEPLOY_BATCHES]
    args = serve.get_parser().parse_args([
        "--checkpoint", ",".join(paths), "--port", "0",
        "--max_wait_ms", "200"])
    server = serve.create_server(args)
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()
    port = server.server_address[1]
    size = server.size
    frames = make_frames(DEPLOY_POSTS + 1, size, SEED + 11)
    bodies = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(f, "L").save(buf, "PNG")
        bodies.append(buf.getvalue())
    C.conv_s8_cuda.launches = A.flash_forward_cuda.launches = 0
    try:
        results = [post(port, bodies[0])]
        with concurrent.futures.ThreadPoolExecutor(DEPLOY_POSTS) as pool:
            results += list(pool.map(lambda b: post(port, b), bodies[1:]))
        torch.cuda.synchronize()
        launches = {"conv_s8": C.conv_s8_cuda.launches,
                    "flash_fwd": A.flash_forward_cuda.launches}
        stats = get_json(port, "/stats")
        health = get_json(port, "/healthz")
    finally:
        server.shutdown()
        server.close()
    assert all(r[0] == 200 for r in results)
    got = np.stack([np.frombuffer(r[2], np.uint8).reshape(size, size) > 0
                    for r in results])
    # serve_body on the set's own tensors, the int8 graph live, fed the
    # float32 [0, 1] frames the Trainer's programs take
    fn, *_ = load_serving_bundle(paths[-1])
    variables = fn.variables
    model = blank_model("TransUNet", **TSLICE, image_size=size).cuda().eval()
    x = torch.from_numpy(np.stack(frames)[..., None]).cuda().float() / 255.0
    with torch.inference_mode():
        want = torch.cat([serve_body(
            model, x[i:i + 16], compute_dtype=torch.bfloat16,
            apply_fn=lambda t: quantized_apply(model, variables, t,
                                               model_type="TransUNet"))
            for i in range(0, len(x), 16)])[..., 0].cpu().numpy() > 0
    agree = float((got == want).mean())
    by_program = stats["batches_by_program"]
    phase("deploy", f"daemon on {health['artifact']} (programs "
          f"{health['program_batches']}): {len(results)} POSTs in "
          f"{stats['batches']} batches, by program {by_program}; masks agree "
          f"with serve_body's int8 graph on {agree:.6%} of pixels; launches "
          f"conv_s8 {launches['conv_s8']}, flash_fwd {launches['flash_fwd']}")
    assert health["program_batches"] == list(DEPLOY_BATCHES)
    assert by_program["1"] >= 1 and sum(by_program.values()) \
        == stats["batches"]
    assert agree >= DEPLOY_MASK_AGREE
    assert launches["conv_s8"] > 0 and launches["flash_fwd"] \
        == N_LAYERS * stats["batches"]
    return dict(launches=launches, batches_by_program=by_program,
                mask_agree=agree)


DEPLOY_INFER_FRAMES = 20  # a full batch of 16 and a zero-padded one


def deploy_infer(tmp, models_dir):
    """cli/infer on the QAT run's int8 batch-16 bundle, in its own process:
    DEPLOY_INFER_FRAMES masks written, the flash forward N_LAYERS times a
    batch and conv_s8 the same number of times each batch."""
    from PIL import Image

    from ddti_tpu_torch.train.export import PROGRAM_SUFFIX

    imgs, out = os.path.join(tmp, "deploy_imgs"), os.path.join(tmp,
                                                               "deploy_out")
    os.makedirs(imgs)
    for i, f in enumerate(make_frames(DEPLOY_INFER_FRAMES, 512, SEED + 13)):
        Image.fromarray(f, "L").save(os.path.join(imgs, f"f{i:02d}.png"))
    bundle = os.path.join(models_dir, f"TransUNet_b16{PROGRAM_SUFFIX}")
    res = subprocess.run(
        [sys.executable, "-m", "ddti_tpu_torch.cli.infer", "--checkpoint",
         bundle, "--input_dir", imgs, "--output_dir", out],
        capture_output=True, text=True, timeout=TRAIN_TIMEOUT_S)
    if res.returncode:
        print(res.stderr[-6000:], file=sys.stderr)
    assert res.returncode == 0, "cli/infer on the int8 bundle failed"
    lines = res.stdout.strip().splitlines()
    kernels = dict(kv.split("=") for kv in lines[-1].split()[1:])
    kernels = {k: int(v) for k, v in kernels.items()}
    batches = -(-DEPLOY_INFER_FRAMES // 16)
    preds = [n for n in os.listdir(out) if n.endswith("_pred.png")]
    phase("deploy", f"cli/infer on {os.path.basename(bundle)}: "
          f"{lines[-2]}; {lines[-1]} for {batches} batches")
    assert len(preds) == DEPLOY_INFER_FRAMES
    assert kernels["flash_fwd"] == N_LAYERS * batches
    assert kernels["conv_s8"] > 0 and kernels["conv_s8"] % batches == 0
    return kernels


def run_deploy(tmp, flagship, levels=False):
    """The deploy phase: the int8 conv's checks and row, the CLIs at once,
    the flagship bundles' serving batch times beside cli/infer on the int8
    set's batch-16 bundle, the daemon on the set. Its wall time is
    printed."""
    t0 = time.perf_counter()
    out = {"conv_rows": deploy_conv_s8(levels)}
    launches, models_dir, outs, paths = deploy_clis(tmp, flagship)
    out["qat_launches"] = launches
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        infer = pool.submit(deploy_infer, tmp, models_dir)
        out["timings"] = deploy_timings(paths)
        out["infer_launches"] = infer.result()
    out["daemon"] = deploy_daemon(models_dir)
    out["phase_s"] = time.perf_counter() - t0
    phase("deploy", f"phase wall time {out['phase_s']:.1f} s")
    return out


def deploy_only():
    """The deploy phase alone, with every flagship level's conv_s8 row and
    its own flagship checkpoint (1 epoch): ``python3 chip_smoke.py
    --deploy``."""
    import torch

    from ddti_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this phase "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ["DDTI_POLY_EXP2"] = "0"
    _build.build()
    with tempfile.TemporaryDirectory() as tmp:
        model_kw = dict(base_filters=TRAIN["base_filters"],
                        depth=TRAIN["depth"])
        flags = [f"--{k}={v}" for k, v in TRAIN.items()
                 if k not in ("model_type", "epochs")]
        _, best = run_cli(tmp, "train", "ResUNet", model_kw, flags,
                          TRAIN["epochs"], jax_resunet_keys(TRAIN["depth"]))
        deploy = run_deploy(tmp, best, levels=True)
    print(json.dumps({"deploy": deploy}))
    return 0


def main():
    import torch

    t_start = time.perf_counter()
    # the default build here and in the CLI runs; the probes phase's
    # subprocess sets DDTI_POLY_EXP2=1 for itself
    os.environ["DDTI_POLY_EXP2"] = "0"
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)  # as nvidia-smi prints it: name, power limit
    phase("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from ddti_tpu_torch.ops import _build
    from ddti_tpu_torch.probes import exp2_probe as E2
    from ddti_tpu_torch.probes import flash_mskip_ab as MS

    clock = Clock()
    # the DDTI_POLY_EXP2=1 library, built at the same time by a process of
    # its own (the flag is read once, at import)
    poly_build = subprocess.Popen(
        [sys.executable, "-c", "from ddti_tpu_torch.ops import _build; "
         "print(_build.build()[0])"], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env=dict(os.environ, DDTI_POLY_EXP2="1"))
    path, secs = _build.build()
    phase("build", f"nvcc {' '.join(_build.NVCC_FLAGS)}, one process per "
          f"source: {f'{secs:.2f} s' if secs else 'already built'} -> "
          f"{os.path.relpath(path)}")
    _build.load_library()
    _, default_ops = kernel_report(path)  # while the poly build runs on
    poly_out, poly_err = poly_build.communicate()
    assert poly_build.returncode == 0, f"the poly build failed:\n{poly_err}"
    poly_path = poly_out.split()[-1]
    phase("build", f"with -DDDTI_POLY_EXP2=1 at the same time -> "
          f"{os.path.relpath(poly_path)}")
    check_poly_build(poly_path, default_ops)
    clock.mark("build")

    rows, bwd_rows, ratios = kernel_phases()
    clock.mark("flash kernels")
    edt_rows = check_edt()
    clock.mark("edt")
    t_probes = time.perf_counter()
    probes = check_probes()
    cg = check_conv_gather()
    phase("probes", f"phase wall time {time.perf_counter() - t_probes:.1f} s")
    clock.mark("probes")
    E2.exp2_probe_cuda.launches = MS.flash_forward_mskip_cuda.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        launches, ckpt = run_slice(tmp)
        probe_launches = (E2.exp2_probe_cuda.launches,
                          MS.flash_forward_mskip_cuda.launches)
        clock.mark("slice")
        profile_slice(ckpt)
        clock.mark("slice profile")
        # the two training CLIs at once, each its own process and model
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            trained = pool.submit(run_training, tmp)
            t_launches = run_transunet_training(tmp)
            edt_launches, profiled, flagship = trained.result()
        clock.mark("train CLIs")
        zoo_launches, zoo_ckpts = run_zoo_training(tmp)
        clock.mark("zoo train")
        zoo_serve(zoo_ckpts)
        clock.mark("zoo serve")
        infer = run_infer(tmp, ckpt, zoo_ckpts["AttentionUNet"][0] + ".pth")
        infer["daemon_launches"] = infer_daemon(ckpt)
        clock.mark("infer")
        deploy = run_deploy(tmp, flagship)
        clock.mark("deploy")
    step_kernel_vs_plain()
    zoo_steps()
    tstep_kernel_vs_plain()
    clock.mark("steps")
    ttrain_rows = profile_transunet(full=False)
    clock.mark("train profiles")
    with tempfile.TemporaryDirectory() as tmp:
        recipe = run_recipe(tmp)
    clock.mark("recipe")
    with tempfile.TemporaryDirectory() as tmp:
        lifecycle = run_lifecycle(tmp, WHOLE_RUN_BEST_SAVES)
    clock.mark("lifecycle")
    with tempfile.TemporaryDirectory() as tmp:
        legacy = run_legacy(tmp)
    clock.mark("legacy")
    with tempfile.TemporaryDirectory() as tmp:
        hostdata = run_hostdata(tmp)
    clock.mark("hostdata")
    with tempfile.TemporaryDirectory() as tmp:
        trainer = run_trainer(tmp, teacher_checkpoint(tmp), profiled)
    clock.mark("trainer")
    clock.stop()

    phase("result", f"total wall time {time.perf_counter() - t_start:.1f} s")
    main_row, bwd_row = rows[0], bwd_rows[0]
    f32_row = next(r for r in bwd_rows if r["dtype"] == "float32")
    f32_fwd = next(r for r in rows if r["dtype"] == "float32")
    bwd_shape, bwd_dt = tuple(bwd_row["shape"]), bwd_row["dtype"]
    edt_bound = bound("edt", tuple(edt_rows[0]["shape"]))
    library_covers = ("scaled_dot_product_attention's backward: dq, dk and "
                      "dv together")
    e2, mskip, ab_rows = (probes["exp2_probe"], probes["mskip"],
                          probes["poly_ab"])
    poly = {r["dtype"]: r for r in probes["poly"]}
    e2_bound = bound("exp2_probe", tuple(e2["shape"]))
    ms_shape = tuple(mskip["shape"])
    ms_bound = bound("flash_fwd_mskip", ms_shape)
    conv_bound = bound("conv3x3", tuple(cg["conv"]["shape"]))
    gather_bound = bound("gather", (*cg["gather_a"]["shape"], 4),
                         shared_index=True)
    # the DDTI_POLY_EXP2=1 build's queued times at a and c, and the probe's
    # A/B (poly=0, then 1) at (8, 8, 4096, 32) bf16
    poly_fwd = {dt: r["fwd_queue_ms"] for dt, r in poly.items()}
    poly_pair = {dt: r["pair_queue_ms"] for dt, r in poly.items()}
    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ddti_tpu/ops/attention.py:347",
        "also_replaces": "ddti_tpu/ops/attention.py:104",
        "launches": launches,
        "train_launches": t_launches["flash_fwd"],
        "infer_launches": infer["launches"],
        "infer": infer,
        "legacy_serve_launches": legacy["serve"]["launches"],
        "hostdata_daemon_launches": hostdata["daemon"]["launches"],
        "trainer_distill_launches": trainer["distill_cli"]["flash_fwd"],
        "trainer_distill_step": trainer["distill_step"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "library": f"scaled_dot_product_attention ({main_row['library']})",
        "queue_ms": main_row["queue_ms"],
        "library_queue_ms": main_row["library_queue_ms"],
        "r_fwd": ratios["r_fwd"],
        "r_fwd_queued": ratios["r_fwd_queued"],
        "f32_shape": f32_fwd["shape"],
        "f32_queue_ms": f32_fwd["queue_ms"],
        "f32_prepass_ms": f32_fwd["prepass_ms"],
        "f32_library_queue_ms": f32_fwd["library_queue_ms"],
        "f32_bound_ms": f32_fwd["bound_ms"],
        "poly_queue_ms": poly_fwd,
        "poly_ab": [{k: r[k] for k in ("poly", "fwd_ms", "fwdbwd_ms",
                                       "fwd_err")} for r in ab_rows],
        "shapes": rows,
    }, {
        "name": "flash_bwd_dkdv",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "ddti_tpu/ops/attention.py:405",
        "also_replaces": "ddti_tpu/ops/attention.py:180",
        "launches": t_launches["flash_bwd_dkdv"],
        "max_abs_err": max(max(r["abs_err"]["dk"], r["abs_err"]["dv"])
                           for r in bwd_rows),
        "max_rel_err": max(max(r["rel_err"]["dk"], r["rel_err"]["dv"])
                           for r in bwd_rows),
        "ms": bwd_row["ms_dkdv"],
        "plain_ms": bwd_row["plain_ms"],
        "plain_covers": "flash_backward_reference: dq, dk and dv together",
        "bound_ms": bwd_row["bound_ms_dkdv"],
        "bound_by": bound("flash_bwd_dkdv", bwd_shape, bwd_dt)[1],
        "library_ms": bwd_row["library_ms"],
        "library": f"scaled_dot_product_attention ({bwd_row['library']})",
        "library_covers": library_covers,
        "pair_ms": bwd_row["ms"],
        "pair_queue_ms": bwd_row["queue_ms"],
        "library_queue_ms": bwd_row["library_queue_ms"],
        "pair_bound_ms": bwd_row["bound_ms"],
        "r_bwd": ratios["r_bwd"],
        "r_bwd_queued": ratios["r_bwd_queued"],
        "f32_shape": f32_row["shape"],
        "f32_pair_queue_ms": f32_row["queue_ms"],
        "f32_library_queue_ms": f32_row["library_queue_ms"],
        "f32_pair_bound_ms": f32_row["bound_ms"],
        "poly_ms": {dt: r["dkdv_ms"] for dt, r in poly.items()},
        "poly_pair_queue_ms": poly_pair,
        "shapes": bwd_rows,
        "train_steps": ttrain_rows,
    }, {
        "name": "flash_bwd_dq",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/flash_bwd.cu",
        "replaces": "ddti_tpu/ops/attention.py:450",
        "also_replaces": "ddti_tpu/ops/attention.py:222",
        "launches": t_launches["flash_bwd_dq"],
        "max_abs_err": max(r["abs_err"]["dq"] for r in bwd_rows),
        "max_rel_err": max(r["rel_err"]["dq"] for r in bwd_rows),
        "ms": bwd_row["ms_dq"],
        "plain_ms": bwd_row["plain_ms"],
        "plain_covers": "flash_backward_reference: dq, dk and dv together",
        "bound_ms": bwd_row["bound_ms_dq"],
        "bound_by": bound("flash_bwd_dq", bwd_shape, bwd_dt)[1],
        "library_ms": bwd_row["library_ms"],
        "library": f"scaled_dot_product_attention ({bwd_row['library']})",
        "library_covers": library_covers,
        "poly_ms": {dt: r["dq_ms"] for dt, r in poly.items()},
    }, {
        "name": "edt_minplus",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/edt.cu",
        "replaces": "ddti_tpu/ops/edt.py:81",
        "launches": edt_launches,
        "max_abs_err": max(r["max_abs_err"] for r in edt_rows),
        "ms": edt_rows[0]["ms"],
        "plain_ms": edt_rows[0]["plain_ms"],
        "bound_ms": edt_bound[0],
        "bound_by": edt_bound[1],
        "queue_ms": edt_rows[0]["queued_ms"],
        "column_ms": edt_rows[0]["column_ms"],
        "row_ms": edt_rows[0]["row_ms"],
        "library_ms": None,  # no PyTorch call computes an EDT
        "shapes": edt_rows,
        "train_steps": "the ResUNet's under --profiles",
        "zoo_launches": zoo_launches,
        "recipe": recipe,
        "lifecycle": lifecycle,
        "legacy": legacy,
        "hostdata": hostdata,
        "trainer": trainer,
    }, {
        "name": "exp2_probe",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/exp2_probe.cu",
        "replaces": "benchmarks/exp2_probe.py:50",
        "launches": probe_launches[0],
        "max_abs_err": max(r["abs_vs_plain"] for r in e2["modes"].values()),
        "ms": e2["modes"]["poly6"]["ms"],
        "plain_ms": e2["plain_ms"],
        "bound_ms": e2_bound[0],
        "bound_by": e2_bound[1],
        "library_ms": e2["library_ms"]["torch.exp2"],
        "library": "torch.exp2 (the builtin mode's function)",
        "mode": "poly6; every mode in modes, queued device time",
        "copy_ms": e2["library_ms"]["copy_"],
        "modes": e2["modes"],
        "edge_ulps": e2["edge_ulps"],
    }, {
        "name": "flash_fwd_mskip",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "benchmarks/flash_mskip_ab.py:81",
        "launches": probe_launches[1],
        "max_abs_err": max(r["max_abs_err"] for r in mskip["shapes"]),
        "ms": mskip["m-skip"]["ms"],
        "baseline_ms": mskip["baseline"]["ms"],
        "plain_ms": mskip["shapes"][0]["plain_ms"],
        "bound_ms": ms_bound[0],
        "bound_by": ms_bound[1],
        "exp2_ms": ms_bound[2],
        "library_ms": mskip["shapes"][0]["library_queue_ms"],
        "library": f"scaled_dot_product_attention "
                   f"({mskip['shapes'][0]['library']}), queued",
        "shape": list(ms_shape),
        "max_abs_err_vs_attention_reference": mskip["m-skip"]["max_abs_err"],
        "shapes": mskip["shapes"],
    }, {
        "name": "conv3x3",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/conv3x3.cu",
        "replaces": "benchmarks/pallas_conv_probe.py:42",
        "launches": cg["conv_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in cg["conv_rows"]),
        "ms": cg["conv"]["ms"],
        "plain_ms": cg["conv"]["plain_ms"],
        "bound_ms": conv_bound[0],
        "bound_by": conv_bound[1],
        "library_ms": cg["conv"]["library_ms"],
        "library": "F.conv2d (cuDNN, channels_last, bias) + relu_, queued",
        "shape": cg["conv"]["shape"],
        "pack_ms": cg["conv"]["pack_ms"],
        "cancel_err_by_c": cg["conv_growth"],
        "shapes": cg["conv_rows"],
    }, {
        "name": "gather",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/gather_probe.cu",
        "replaces": "benchmarks/gather_probe.py:55",
        "also_replaces": ["benchmarks/gather_probe.py:77",
                          "benchmarks/gather_probe.py:99",
                          "benchmarks/gather_probe2.py:73",
                          "benchmarks/gather_probe2.py:100",
                          "benchmarks/gather_probe3.py:96",
                          "benchmarks/gather_probe3.py:115",
                          "benchmarks/gather_probe3.py:134"],
        "launches": cg["gather_launches"],
        "max_abs_err": 0.0,  # bit for bit, NaN's bits included
        "ms": cg["gather_a"]["ms"],
        "plain_ms": cg["gather_a"]["plain_ms"],
        "bound_ms": gather_bound[0],
        "bound_by": gather_bound[1],
        "library_ms": cg["gather_a"]["library_ms"],
        "library": "torch.gather, the same call (builder A), queued",
        "builder": "A: flat take, (128, 256, 256) float32, shared index",
        "builders": cg["gather"],
        "edges": cg["gather_edges"],
    }, {
        "name": "conv_s8",
        "route": "cuda",
        "source": "ddti_tpu_torch/csrc/conv_s8.cu",
        "replaces": "ddti_tpu/train/quantize.py:267",
        "also_replaces": "ddti_tpu/train/quantize.py:262",
        "replaces_note": "XLA's s8 x s8 -> s32 convs of the JAX int8 "
                         "serving graph (lax.conv_general_dilated, "
                         "lax.conv_transpose); no Pallas kernel",
        "launches": deploy["daemon"]["launches"]["conv_s8"],
        "max_abs_err": 0.0,  # bit for bit at every zoo geometry
        "ms": deploy["conv_rows"][0]["ms"],
        "queue_ms": deploy["conv_rows"][0]["queue_ms"],
        "plain_ms": deploy["conv_rows"][0]["plain_ms"],
        "bound_ms": deploy["conv_rows"][0]["bound_ms"],
        "bound_by": deploy["conv_rows"][0]["bound_by"],
        "library_ms": deploy["conv_rows"][0]["library_ms"],
        "library": "F.conv2d bf16 (cuDNN, channels_last), queued: no "
                   "PyTorch call computes an int8 conv on CUDA",
        "shape": deploy["conv_rows"][0]["shape"],
        "deploy": deploy,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def cache_bytecode():
    """Keep compiled bytecode under the checkout's ``build/pycache``, for
    this process and every process it starts. The card's machine sets
    PYTHONDONTWRITEBYTECODE and ships torch without ``__pycache__``, so
    each process compiled torch's sources anew: 8.4 s of 45.3 in a
    cProfile of one flagship training CLI run (H100 80GB HBM3, 700.00 W),
    and the smoke starts some forty. Only inside a checkout."""
    root = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(root, "ddti_tpu_torch")):
        return
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ.setdefault("PYTHONPYCACHEPREFIX",
                          os.path.join(root, "build", "pycache"))
    sys.dont_write_bytecode = False
    sys.pycache_prefix = os.environ["PYTHONPYCACHEPREFIX"]


if __name__ == "__main__":
    cache_bytecode()
    if sys.argv[1:2] == ["--ab"]:  # python3 chip_smoke.py --ab TREE [probes]
        sys.exit(ab(*sys.argv[2:4]))
    if sys.argv[1:2] == ["--ab-side"]:
        sys.exit(ab_side(sys.argv[2], *sys.argv[3:4]))
    if sys.argv[1:2] == ["--poly-child"]:
        sys.exit(poly_child())
    if sys.argv[1:2] == ["--zoo"]:
        sys.exit(zoo_only())
    if sys.argv[1:2] == ["--infer"]:
        sys.exit(infer_only())
    if sys.argv[1:2] == ["--recipe"]:
        sys.exit(recipe_only())
    if sys.argv[1:2] == ["--lifecycle"]:
        sys.exit(lifecycle_only())
    if sys.argv[1:2] == ["--legacy"]:
        sys.exit(legacy_only())
    if sys.argv[1:2] == ["--hostdata"]:
        sys.exit(hostdata_only())
    if sys.argv[1:2] == ["--trainer"]:
        sys.exit(trainer_only())
    if sys.argv[1:2] == ["--deploy"]:
        sys.exit(deploy_only())
    if sys.argv[1:2] == ["--profiles"]:
        sys.exit(profiles_only())
    sys.exit(main())
