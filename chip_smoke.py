#!/usr/bin/env python3
"""Smoke run of tpu_mednet_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``tpu_mednet_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes of the main paths
(K1's forward and backward at the five level shapes, K2 plain and indexed
by subject, the sampler's image and label stores in one launch and each
alone), runs the full-width ResidualUNet3D forward on both paths,
prints one bf16 forward's device time by kernel (``torch.profiler``), and
drives the two main paths with launch counts:

- serving: ``predict_volumes_on_device`` on two seeded volumes at the
  ``configs/predict.yaml`` geometry, timing repeated calls and the
  device's idle share, and holding its masks to the plain path's outside
  the logit tie band;
- training: after a full-width train-step parity check of the kernel path
  against the plain path (fp32 and bf16, every parameter's gradient), the
  ``bench.py`` training step (``make_train_step`` with mirror flips, Dice,
  Adam at lr 1e-3, bf16, batch 32 of 96^3) fed by ``DevicePatchSampler``
  over four seeded subjects: patches/s, peak memory, idle share, device
  time by group, exact launches per step, finite losses, and a loss that
  falls on one fixed batch;
- entry points: ``train_seg -c configs/seg_organ.yaml`` and ``predict -c
  configs/predict.yaml`` through the CLIs' ``main(argv)`` on a seeded zarr
  store, K1 and indexed K2 held at their 128^3 shapes, both stitches'
  masks held to each other; then the non-finite guard's cost per step;
- landmarks: K1 forward and backward at the f_maps-64 level shapes (batch
  4, bf16 and fp32, up to 1024 channels), the LandmarkNet model of
  ``configs/landmarks.yaml`` (141,246,661 parameters) kernel path against
  plain path (forward heatmaps and class logits, one bf16 train step's
  gradients, ten steps on one batch at lr 1e-3 and 1e-4), then ``train_ldmks -c configs/landmarks.yaml`` (host sampler
  with ``--resume``, ``--device_sampler``, ``--device_sampler
  --landmark_group``) and a LandmarkNet ``predict`` with both stitches and
  ``prediction.landmarks``, with indexed K2 held on the 4-channel label
  store;
- predict surface (a child process too): ``train_seg -c
  configs/seg_brats_bf16.yaml`` (4 modalities, 4 classes) for 1 epoch from
  a seeded NIfTI directory, ``predict`` on its checkpoint with the
  ``crop``, ``device`` and ``gaussian`` stitches without and with ``tta:
  true`` into ``*.nii`` (volumes/min, peak reserved memory against the HBM
  guard's estimate, idle share), ``tpu_mednet_torch.utils.export`` on a
  zarr prediction, the guard under ``error`` and a forced host spill, and
  a LandmarkNet of ``configs/landmarks.yaml`` width through the Gaussian
  stitch and a ``tta_flips=(0, 2)`` device stitch, with exact K1/K2
  launches per call, TTA ``device`` vs ``crop`` and ``gaussian`` vs its
  spill inside the tie band, K2's 4-channel f16 -> bf16 gather held
  byte-equal, and no more than ``HELD_LIMIT`` of reserved memory held
  between predict calls beyond what the process held before the first;
- training surface (a child process too): the ``bench.py`` step at remat
  0, 1 and all (patches/s, peak memory against ``unet_train_peak_bytes``,
  exact K1 launches per step with the recomputed stages), one step's loss
  and gradients at remat 1 and all against remat 0 (and K1's recomputed
  statistics bit-equal to the forward's), the step with the spatial
  transform (the warp's device ms, labels in-set), ``spatial_3d`` on the
  card against the CPU and ``separable`` against ``exact``, then
  ``train_seg -c configs/seg_organ.yaml --remat 1`` and ``train_ldmks -c
  configs/landmarks.yaml`` with the spatial flags for two epochs each (the
  landmark heatmaps warped linearly by the Trainer's hook);
- tools (a child process too; ``python3 chip_smoke.py --tools <out.json>``
  runs it alone): the quick start as users run it (``demo`` ->
  ``train_seg`` / ``train_ldmks`` -> ``predict`` -> ``evaluate`` on the
  demo's own configs), ``configs/seg_brats_bf16.yaml`` (f_maps 32) and
  ``configs/landmarks.yaml`` (f_maps 64) trained 1 epoch on 160^3 demo
  stores, predicted and scored, the interop round trip on both checkpoints
  (``inspect_ckpt`` against the run's own files, ``export_torch`` ->
  ``import_torch`` with the weights bit-equal, predictions from the
  imported directory and from the ``.ckpt`` equal to the original's or
  inside the tie band, printed which), ``pack`` of a NIfTI demo with
  ``stats`` equal on both stores, with exact K1/K2 launches per training
  step and predict batch and none in the host tools.  The analytic MFU of
  the batch-32 step, the forward and the serving slice (``utils/flops.py``)
  is printed beside their rates;
- deploy (a child process too; ``python3 chip_smoke.py --deploy
  <out.json>`` runs it alone): the native batch loader (its g++ build
  timed in the build step) with every batch of a seg_organ and a
  landmark epoch equal to the numpy sampler's by a checksum on the card,
  ``train_seg -c configs/seg_organ.yaml`` 2 epochs under the default
  (auto -> native) and under ``--no_native_loader`` (native calls equal to
  the batches drawn and 0, step 0's loss bit-equal, patches/s and idle
  share of both) and ``train_ldmks -c configs/landmarks.yaml`` 1 epoch;
  serving export through ``export_serving.main`` of both checkpoints
  (seg_organ symbolic and pinned, the landmark model with ``--tta 0 2``),
  each ``.pt2`` called in a fresh process that imports ``torch`` and
  ``tpu_mednet_torch.ops`` only, against the eager ``make_serving_fn``
  (byte-equal or inside the tie band), K1 launches per call exact, ms per
  call beside the eager function's; the Trainer's profiler hook (a trace
  naming K1, losses equal to an unprofiled run); and the dispatcher's
  host time per K1 op call.

- unet3d (a child process too; ``python3 chip_smoke.py --unet3d
  <out.json>`` runs it alone): K1 at every GroupNorm shape of
  ``UNet3D(1, 3)`` in order ``gcr`` (one channel in one group at the
  input, the 192/384/768-channel concatenations; bf16, batch 8 of 96^3)
  and at one channel a group (``configs/seg_tiny.yaml``'s 8 in 8, the
  input in fp32), each against its plain version and bitwise repeatable;
  the gcr model's forward (kernel vs plain, K1's share), one train step's
  parity and the bench-style step at batch 8 through ``DevicePatchSampler``
  (exact launches, patches/s, peak memory against the double branch of
  ``unet_train_peak_bytes``, a falling loss); the ``cbr`` model's running
  statistics (kernel vs plain path, remat 1 and all against 0, a guarded
  non-finite step); both models served in eval mode through the
  ``device`` and ``crop`` stitches; ``Trainer.fit`` of the cbr model from
  Python with a checkpoint restored bit for bit; ``chip_memory_fit.py``'s
  UNet3D points; ``train_seg -c configs/seg_tiny.yaml`` for 1 epoch.

- parallel (a child process too; ``python3 chip_smoke.py --parallel
  <out.json>`` runs it alone): the MIP visualizer's compute half (the
  hooks' eval-mode forward of a batch's first row, 27 K1 launches of each
  forward kernel a call) at seg_organ's and multitask_dp.yaml's widths
  against the plain path (class maps inside the tie band, heatmaps within
  the bf16 bound, the MIPs the prediction's), ms a call; ``train_seg -c
  configs/seg_organ.yaml`` 1 epoch with ``--neptune_project`` on a fake
  ``neptune`` module (every scalar reaches the sink, which is closed; with
  matplotlib 2 figures and 27 more K1 launches a visualized batch, without
  it one warning and no hook); two data-parallel ranks on the one card
  (``--dp-rank``, gloo) against one process on the same global batch 8 of
  96^3: the bench-style step (ms a step, exact launches, one indexed K2 a
  rank a step), SGD parity in fp32 and bf16 and the cbr UNet3D's running
  statistics, the ranks bit-equal; ``train_ldmks -c
  configs/multitask_dp.yaml --gpus 8`` clamped to the card at its global
  batch 32 (patches/s, peak memory, exact launches, a falling validation
  loss); ``predict`` with ``prediction.gpus: 2`` clamped and byte-equal to
  1, and ``round_robin_placement`` over ``[cuda:0, cuda:0]``.

- spatial (a child process too; ``python3 chip_smoke.py --spatial
  <out.json>`` runs it alone; its ranks are ``chip_smoke.py --sp-rank``
  gloo processes on the one card, killed after ``SP_TIMEOUT``): K1's
  fold-off route (the moments kernel's sums, the backward reduce's A and
  B) at seg_organ's level shapes at two ranks, bf16 and fp32, against its
  plain version and, folded in torch, against the fold-on route, ms
  against the bytes bound; seg_organ's model (f_maps 32, 5 levels, cge)
  trained on 1 x 2 ranks at global batch 4 of 128^3 with mirror flips on
  all three axes against one process on the same batches (bf16; fp32 with
  TF32 off), the ranks bit-equal, exact K1 launches, halo exchanges and
  space sums a step, ms a step, the exchanges' seconds, peak memory by
  rank; a 2 x 2 mesh at 3 levels; remat 1 against 0 on the space axis;
  ``Trainer.fit`` for 2 short epochs with the MIP hook's forward on rank 0
  alone; ``predict_volume_spatial`` of a 192 x 176 x 144 volume in
  ``auto`` (without and with flips 0 and 2) and ``explicit`` against one
  process, apart only inside the tie band, ms a volume and peak by rank.

Any failed check raises, so the script exits non-zero; it also exits
non-zero without a result when CUDA is unavailable or the package is not
beside it.

Output: the card's ``nvidia-smi`` name and power limit, one line per
check, a ``{"kernels": [...]}`` JSON line, and, last,
``{"ok": true, "device": {...}}``.  A kernel's time is its device time
from ``torch.profiler``, the mean over the launch records it kept (at
least ``MIN_KEPT`` of them; the share is ``profiler_kept``).  Where the
profiler keeps fewer, on every try, the time is the mean over CUDA events
recorded around each launch of the kernel behind a queue of device work
(``launch_event_ms``), and ``profiler_kept`` below ``MIN_KEPT`` says so.
CUDA-event times around the wrapper calls, which at small shapes measure
the host, are printed beside it.  Device busy times and idle shares come
from the profiler too, beside the share of K1's counted launches it kept;
an idle share is NaN (not measured) where that share is below
``MIN_KEPT``.  Bounds use the H100 SXM peaks (3.35 TB/s HBM, 67 TFLOP/s
fp32 without tensor cores).
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
MIN_KEPT = 0.5         # a kernel time rests on at least half of its launches' profiler records
QUEUE_CYCLES = 100_000_000  # device sleep ahead of launch_event_ms's calls: ~50 ms at 1.98 GHz
FULL_WIDTH_PARAMS = 35_316_738
BATCH, PATCH, OVERLAP = 8, (96, 96, 96), (16, 16, 16)
GROUPS = 8
# per level i of the full-width net: channels 32*2^i, extent 96/2^i;
# GroupNorms per forward: 3 in the encoder block, 3 in the decoder block
# (none at the deepest level); in each block one of three adds the residual
LEVELS = [(32 * 2**i, 96 // 2**i, 6 if i < 4 else 3) for i in range(5)]
FWD_FP32_ATOL = 1e-3
FWD_BF16_REL = 5e-2    # bf16 logits: max |kernel - plain| <= 5e-2 * max |plain|
# Forward and slice masks, kernel path vs plain path: a voxel's class may
# differ only where the plain path's top-2 logit margin is at most twice the
# largest logit difference between the paths (the tie band); outside it no
# difference of that size can flip the argmax.
SLICE_VOLUMES = (("v0", (160, 160, 160)), ("v1", (192, 176, 144)))
SLICE_REPEATS = 5      # timed runs of the slice after the counted one
# training: bench.py's step (batch 32 of 96^3, bf16, Adam lr 1e-3, mirror
# flips) on four seeded subjects; K1's backward is checked at batch 32 in
# bf16 and batch 8 in fp32
TRAIN_BATCH = 32
TRAIN_SUBJECTS = (("t0", (160, 160, 160)), ("t1", (192, 176, 144)),
                  ("t2", (176, 160, 160)), ("t3", (144, 192, 176)))
TRAIN_WARMUP, TRAIN_STEPS, FIXED_BATCH_STEPS = 3, 10, 10
PARITY_BATCH = 2
# train-step parity, kernel path vs plain path: per parameter,
# max |g_kernel - g_plain| <= bound * max |g_plain|; loss within the same
# bound (fp32 with TF32 off: another fp32 summation order of the GroupNorm
# sums; bf16: that order moves bf16 roundings, as for the forward logits)
PARITY_REL = {"fp32": 1e-3, "bf16": 5e-2}
GN_ACT = "e"            # every GroupNorm of the model fuses its ELU
# entry points: train_seg -c configs/seg_organ.yaml (128^3 patches, batch 4,
# 5 classes, 10 patches per subject) and predict -c configs/predict.yaml on a
# seeded zarr store of six subjects: four train (10 steps per epoch), one
# val, and the val subject plus one more to predict
ORGAN_SUBJECTS = (("o0", (192, 192, 160)), ("o1", (176, 192, 160)),
                  ("o2", (192, 176, 168)), ("o3", (192, 192, 144)),
                  ("o4", (184, 192, 160)), ("o5", (192, 184, 176)))
ORGAN_SPLITS = dict(train=["o0", "o1", "o2", "o3"], val=["o4"], test=["o4", "o5"])
ORGAN_BATCH, ORGAN_CLASSES, ORGAN_STEPS_PER_EPOCH = 4, 5, 10
ORGAN_LEVELS = [(32 * 2**i, 128 // 2**i, 6 if i < 4 else 3) for i in range(5)]
ORGAN_PATCH = (128, 128, 128)
# profiled for the idle share: the host sampler's resumed epoch, the device
# sampler's last
PROFILED_EPOCHS = {("resume", 2), ("device_sampler", 2)}
PREDICT_TURNS = 6      # predict CLI calls per stitch, in turns crop, device
ORGAN_OPTIONS = ("--device_sampler", "--optimizer", "adamw", "--weight_decay", "1e-4",
                 "--lr_schedule", "cosine", "--warmup_steps", "2", "--grad_clip_norm", "1.0",
                 "--ema_decay", "0.99", "--nonfinite", "skip", "--track_grad_norm",
                 "--accumulate_grad_batches", "2")
GUARD_STEPS = 10       # steps per turn of the non-finite guard's cost, off/on/on/off
# landmarks: train_ldmks -c configs/landmarks.yaml (f_maps 64, 3 heatmaps + 2
# classes, 96^3 patches, batch 4, Dice + L2, 10 patches per subject) and a
# LandmarkNet predict -c configs/predict.yaml on a seeded zarr store of six
# subjects with 3 landmarks each: four train (10 steps per epoch), one val,
# and the val subject plus one more to predict
LDMK_PARAMS = 141_246_661
FIXED_BATCH_LRS = (1e-3, 1e-4)  # the config's lr and a tenth (check_landmark_parity)
LDMK_BATCH, LDMK_HEATMAPS, LDMK_SIGMA = 4, 3, 4.0
LDMK_LEVELS = [(64 * 2**i, 96 // 2**i, 6 if i < 4 else 3) for i in range(5)]
LDMK_SUBJECTS = (("l0", (192, 192, 160)), ("l1", (176, 192, 160)),
                 ("l2", (192, 176, 168)), ("l3", (192, 192, 144)),
                 ("l4", (184, 192, 160)), ("l5", (192, 184, 176)))
LDMK_SPLITS = dict(train=["l0", "l1", "l2", "l3"], val=["l4"], test=["l4", "l5"])
LDMK_STEPS_PER_EPOCH = 10
# (tag, epochs, extra flags) of the train_ldmks runs: the host sampler on the
# stored heatmaps, resumed; the device sampler on them; the device sampler
# rendering them from the stored coordinates
LDMK_RUNS = (("ldmk_train", "ldmk", 2, ()),
             ("ldmk_resume", "ldmk", 3, ("--resume",)),
             ("ldmk_device", "ldmk_device", 2, ("--device_sampler",)),
             ("ldmk_landmarks", "ldmk_landmarks", 2,
              ("--device_sampler", "--landmark_group", "landmarks")))
LDMK_PROFILED = {("ldmk_resume", 2), ("ldmk_device", 1), ("ldmk_landmarks", 1)}
LDMK_PREDICT_TURNS = 3
# predict surface: train_seg -c configs/seg_brats_bf16.yaml (4 modalities, 4
# classes, batch 2 of 128^3, 8 patches per subject) for 1 epoch from a seeded
# NIfTI directory of six subjects (four train, one val, the val subject and
# one more to predict), then predict -c configs/predict.yaml with each
# stitch without and with tta, SURFACE_CALLS calls each in turns; and a
# LandmarkNet of configs/landmarks.yaml width on one LDMK_VOLUME
BRATS_SUBJECTS = (("b0", (160, 160, 136)), ("b1", (152, 160, 136)),
                  ("b2", (160, 152, 144)), ("b3", (160, 160, 128)),
                  ("b4", (160, 144, 136)), ("b5", (152, 160, 144)))
BRATS_SPLITS = dict(train=["b0", "b1", "b2", "b3"], val=["b4"], test=["b4", "b5"])
BRATS_MODALITIES, BRATS_CLASSES, BRATS_BATCH, BRATS_PATCHES_PER_SUBJECT = 4, 4, 2, 8
BRATS_AFFINE = np.array([[-1.0, 0.0, 0.0, 90.0], [0.0, -1.0, 0.0, 126.0],
                         [0.0, 0.0, 1.0, -72.0], [0.0, 0.0, 0.0, 1.0]])
STITCHES = ("crop", "device", "gaussian")
SURFACE_CALLS = 3
LDMK_VOLUME = (192, 192, 160)
LDMK_METRICS = {"train_loss", "class_loss", "regression_loss", "lr", "patches_per_sec",
                "val_loss", "val_class_loss", "val_regression_loss", "val_landmark_error",
                "val_dice0", "val_dice1"}
# predict surface: reserved memory a process may hold between predict calls
# beyond what it held before the first (the models of earlier calls freed)
HELD_LIMIT = 0.1 * 2**30
PR6_BRATS_PEAK_GIB = 5.83   # seg_brats_bf16's 1-epoch peak allocated with remat ignored (PR 6)
# training surface: bench.py's step at each remat setting, then with the
# spatial transform; train_seg (seg_organ, --remat 1) and train_ldmks with
# the spatial flags, 1 epoch each
REMATS = (("0", False), ("1", 1), ("all", True))
SURFACE_WARMUP, SURFACE_STEPS = 2, 5
SPATIAL = dict(elastic_sigma=2.0, rotate_deg=15.0, scale_range=(0.85, 1.15))
SPATIAL_FLAGS = ("--aug_elastic_sigma", "2", "--aug_rotate_deg", "15", "--aug_scale", "0.85",
                 "1.15")
SURFACE_EPOCHS = 2     # of each training CLI run: the first holds cuDNN's warm-up
# spatial_3d on the card against the CPU from the same draws, at 2 x 64^3:
# image within 1e-4 x max |x|, class map equal but where the CPU's source
# coordinate lies within WARP_TIE of a rounding boundary, heatmap within 1
# (tests/test_torch_spatial_aug.py's bounds)
WARP_CHECK, WARP_TIE, WARP_IMAGE_REL = (2, 64), 1e-4, 1e-4
# separable vs exact on a smooth image under a small deformation
# (tests/test_spatial_aug.py::test_separable_close_to_exact_for_small_deformations):
# mean |separable - exact| < 0.05 x the image's range, correlation > 0.97
SMALL_DEFORMATION = dict(elastic_sigma=1.0, rotate_deg=3.0)
SEPARABLE_MEAN_REL, SEPARABLE_CORR = 0.05, 0.97
MEMORY_RATIO = (1.0, 1.3)   # unet_train_peak_bytes / max_memory_reserved
# tools phase: the quick start on the demo's own stores and configs (f_maps
# 16, 32^3 patches, batch 2, 4 patches per subject, 2 epochs; predict tiles
# of 32^3 with overlap 4, batch 4), then configs/seg_brats_bf16.yaml (f_maps
# 32) and configs/landmarks.yaml (f_maps 64) for 1 epoch each on demo stores
# of 160^3 (6 train, 2 val and 2 test subjects, the demo's split), predicted
# at configs/predict.yaml's geometry; and a small NIfTI demo for pack/stats
DEMO_TRAIN, DEMO_SIZE, FULL_SIZE = 6, 64, 160
QUICK_EPOCHS, QUICK_GEOMETRY = 2, ((32, 32, 32), (4, 4, 4), 4)
QUICK_STEPS = DEMO_TRAIN * 4 // 2 * QUICK_EPOCHS
TOOLS_BRATS_STEPS = DEMO_TRAIN * 8 // 2
TOOLS_LDMK_STEPS = DEMO_TRAIN * 10 // LDMK_BATCH
TOOLS_NII_DEMO = ("--size", "48", "--train", "2", "--val", "1", "--test", "1")
# the demo's landmarks.yaml leaves --loss_class_weight at its 2-entry
# default, one short of the demo's 3 classes (ROADMAP §3)
QUICK_CLASS_WEIGHTS = ("--loss_class_weight", "0.05", "1.0", "1.0")
H100_BF16_FLOP_PER_S = 989e12   # dense, data sheet (SXM, 700 W)
# UNet3D phase: UNet3D(1, 3) at its defaults (f_maps 64, 4 levels, order gcr:
# a GroupNorm in front of each of its 14 convolutions) and the same model in
# cbr (BatchNorm after each), bf16, batch 8 of 96^3
U3_CLASSES, U3_BATCH, U3_PARAMS = 3, 8, 16_318_821
# the gcr forward's GroupNorms: (channels, groups, extent, how many); the
# input's one channel in one group, the decoders' concatenations at 768,
# 384 and 192 channels
U3_GN_SHAPES = ((1, 1, 96, 1), (32, 8, 96, 1), (64, 8, 48, 2), (128, 8, 24, 2),
                (256, 8, 12, 2), (768, 8, 24, 1), (256, 8, 24, 1), (384, 8, 48, 1),
                (128, 8, 48, 1), (192, 8, 96, 1), (64, 8, 96, 1))
# one channel a group beyond the model: configs/seg_tiny.yaml's level 0 (8
# channels in 8 groups, batch 1 of 64^3) in both dtypes, the C = 1 input in fp32
U3_EXTRA_CASES = (("c8_g8_seg_tiny_bf16", 8, 8, 64, 1, "bf16"),
                  ("c8_g8_seg_tiny_fp32", 8, 8, 64, 1, "fp32"),
                  ("c1_g1_fp32", 1, 1, 96, 8, "fp32"))
U3_WARMUP, U3_STEPS, U3_FIXED_STEPS, U3_BN_STEPS = 2, 6, 6, 3
U3_VOLUME = (160, 160, 160)
# the crop and device stitches run the same tiles in other batches: two bf16
# ulps of a logit of 4-8 at least
U3_TIE_FLOOR = 2.0 ** -5
U3_TRAINER_PATCH, U3_TRAINER_BATCH, U3_TRAINER_SAMPLES = (96, 96, 96), 4, 5
# Device ms of K1's two apply kernels in their grid-stride design (one
# vector a thread, coefficients read per element), before the channel-owned
# walk (PERF.md section 6, profiled on an NVIDIA H100 80GB HBM3 at 700 W),
# printed beside this run's for comparison, never a gate: the apply per
# forward and the backward's apply per step, keyed by (dtype, batch, level-0
# channels, extent); per gcr UNet3D forward and step; per UNet3D shape
# (channels, extent) at batch 8, bf16: (apply, backward apply)
GRID_STRIDE_APPLY_SUMS = {("bf16", 8, 32, 96): 3.992, ("bf16", 4, 64, 96): 4.054}
GRID_STRIDE_BWD_APPLY_SUMS = {("bf16", 32, 32, 96): 19.098, ("bf16", 4, 64, 96): 5.319}
GRID_STRIDE_U3_SUMS = (6.171, 11.283)
GRID_STRIDE_U3_APPLY = {(192, 96): (3.25, 6.24), (384, 48): (1.05, 2.05),
                        (768, 24): (0.27, 0.51), (256, 24): (0.091, None),
                        (1, 96): (0.0382, 0.0467)}
# Device ms of K1's backward reduce in its first design (gn_moments_kernel's
# register path over x and dy, rows only split over blocks, one thread a
# group in the fold), before the walk of plan_bwd_reduce (PERF.md section
# 6, profiled on an NVIDIA H100 80GB HBM3 at 700 W), printed beside this
# run's for comparison, never a gate: per train step keyed by (dtype,
# batch, level-0 channels, extent); per gcr UNet3D step; per UNet3D shape
# (channels, extent) at batch 8, bf16; one call at each fold-off level
# shape, summed, by dtype
FIRST_REDUCE_SUMS = {("bf16", 32, 32, 96): 15.457, ("bf16", 4, 64, 96): 4.341}
FIRST_REDUCE_U3_SUM = 4.583
FIRST_REDUCE_U3 = {(1, 96): 0.0721}
FIRST_REDUCE_FOLD_OFF = {"bf16": 0.3921, "fp32": 0.5310}
# Device ms of K1's moments on the register path (one element a thread and
# row) at the gcr UNet3D's one-channel input, before its packed route
# (PERF.md section 6, profiled on an NVIDIA H100 80GB HBM3 at 700 W),
# printed beside this run's for comparison, never a gate; keyed by
# (channels, extent) at batch 8, bf16
REGISTER_MOMENTS_U3 = {(1, 96): 0.0352}
TINY_SHAPE = (64, 64, 64)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean CUDA-event time of ``fn`` over ``reps`` calls, after a warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, flops: float) -> float:
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


@contextlib.contextmanager
def plain_kernels(gn, P):
    """Route GroupNorm to its plain forward (differentiated by torch
    autograd) and K2 to its plain version, also where the device sampler
    cuts its stores (comparisons only)."""
    def stores_plain(stores, corners, patch_size, subjects, out_dtypes=None):
        dts = out_dtypes or [None] * len(stores)
        return [P.extract_patches_plain(st, corners, patch_size, out_dtype=dt,
                                        subjects=subjects) for st, dt in zip(stores, dts)]

    saved = (gn.group_norm, P.extract_patches, P.extract_patches_stores)
    gn.group_norm = gn.group_norm_plain
    P.extract_patches = P.extract_patches_plain
    P.extract_patches_stores = stores_plain
    try:
        yield
    finally:
        gn.group_norm, P.extract_patches, P.extract_patches_stores = saved


def launch_counts(gn, P):
    return dict(gn_moments=gn.STATS_LAUNCHES, gn_apply=gn.APPLY_LAUNCHES,
                gn_bwd_reduce=gn.BWD_REDUCE_LAUNCHES, gn_bwd_apply=gn.BWD_APPLY_LAUNCHES,
                gather_patches=P.LAUNCHES)


def reset_counts(gn, P):
    gn.STATS_LAUNCHES = gn.APPLY_LAUNCHES = 0
    gn.BWD_REDUCE_LAUNCHES = gn.BWD_APPLY_LAUNCHES = P.LAUNCHES = 0


def device_rows(torch, fn, reps):
    """(ms per call, launches per call, name) of every device activity that
    ``torch.profiler`` records over ``reps`` calls of ``fn``.  Launches per
    call are a fraction where the profiler dropped records: on one H100
    it kept 19 of 20 now and then, and late in the process, after the
    training and entry-point profiles, ``probe_profiler`` saw 4 of 5 and
    then 1 of 5 matmuls; on another it kept 1 of 20 ``gn_apply`` launches
    three times over in the first K1 check."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "device_time_total", None)
        if us is None:
            us = getattr(evt, "cuda_time_total", 0.0)
        if us > 0 and not evt.key.startswith("cuda"):
            rows.append((us / reps / 1e3, evt.count / reps, evt.key))
    return rows


def launch_ms(rows, name):
    """Device ms per launch of the activities of ``device_rows`` whose name
    holds ``name``: the mean over the records the profiler kept."""
    ms = sum(m for m, _, key in rows if name in key)
    n = sum(c for _, c, key in rows if name in key)
    return ms / n if n else 0.0


def launch_event_ms(torch, fn, name, reps):
    """Mean ms per launch of the C entries whose name holds ``name`` over
    ``reps`` calls of ``fn``: CUDA events recorded just before and after
    each such launch on the current stream.  The calls are queued behind
    ``QUEUE_CYCLES`` of device sleep, so each start event runs as the work
    before it ends, not when the host reaches the launch."""
    from tpu_mednet_torch.ops import _build

    pairs = []

    def timing(orig):
        def kernel(entry, argtypes):
            launch = orig(entry, argtypes)
            if name not in entry:
                return launch

            def timed(*args):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                err = launch(*args)
                end.record()
                pairs.append((start, end))
                return err
            return timed
        return kernel

    fn()
    torch.cuda.synchronize()
    with wrapped(_build, "kernel", timing):
        torch.cuda._sleep(QUEUE_CYCLES)
        for _ in range(reps):
            fn()
    torch.cuda.synchronize()
    if not pairs:
        raise AssertionError(f"{name}: no launch over {reps} calls")
    return sum(a.elapsed_time(b) for a, b in pairs) / len(pairs)


def kernel_ms(torch, fn, name, reps=20, tries=3):
    """(device ms per launch of the kernel named ``name``, which ``fn``
    launches once a call; the share of those launches the profiler kept;
    the profile's rows) over ``reps`` calls.  Profiles again while it kept
    fewer than ``MIN_KEPT`` of them; after ``tries`` the time is
    ``launch_event_ms``'s."""
    kept, rows = 0.0, []
    for _ in range(tries):
        rows = device_rows(torch, fn, reps)
        kept = sum(count for _, count, key in rows if name in key)
        if kept >= MIN_KEPT:
            return launch_ms(rows, name), kept, rows
    ms = launch_event_ms(torch, fn, name, reps)
    log(f"torch.profiler kept {kept:g} of {name}'s launches per call over {reps} calls, "
        f"{tries} times: {ms:.4f} ms per launch from launch events instead")
    return ms, kept, rows


def profile_kept(torch, gn, fn, reps):
    """``device_rows`` of ``fn`` and the share of its K1 statistics launches
    (counted by ``gn.STATS_LAUNCHES``) whose records the profiler kept:
    below 1, busy times summed from the rows miss what it dropped."""
    before = gn.STATS_LAUNCHES
    rows = device_rows(torch, fn, reps)
    launched = (gn.STATS_LAUNCHES - before) / reps
    seen = sum(count for _, count, key in rows if "gn_moments" in key)
    return rows, seen / launched if launched else 1.0


def idle_share(busy, wall, kept):
    """1 - busy / wall, or NaN (not measured) where the profiler kept fewer
    than ``MIN_KEPT`` of the counted launches."""
    return 1 - busy / wall if kept >= MIN_KEPT else float("nan")


def log_clocks(tag: str) -> None:
    """The card's SM clock, its maximum, power draw and temperature now."""
    out = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    log(f"clocks {tag}: {out.stdout.strip()} (sm, max sm, power, temperature)")


def probe_profiler(torch, dev):
    """Log what ``torch.profiler`` records of five matmuls."""
    a = torch.randn((1024, 1024), device=dev)
    log(f"profiler probe: {device_rows(torch, lambda: a @ a, 5)}")


def reduce_plan_text(gn, x, dy, residual, groups, act):
    """The backward reduce's plan for these operands and its kernel
    instance: route, grid, ring stage, registers a thread, blocks an SM."""
    plan = gn.reduce_plan(x, dy, residual, act)
    info = gn.reduce_info(x, groups, plan, residual is not None)
    walk = f"ring of {plan.stage_rows}-row stages" if plan.stage_rows else "walk"
    return (f"{plan.route} route, {walk}, {plan.blocks} blocks x {plan.chunks} chunks a "
            f"sample of {plan.threads} threads, {info['registers']} registers a thread, "
            f"{info['blocks_per_sm']} blocks an SM")


def bf16_ulp(ref):
    """One bf16 ulp at each value of ``ref`` (8 significant bits)."""
    import torch

    _, exp = torch.frexp(ref.float())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exp - 8).clamp_min(2.0**-133)


def check_gn(torch, gn, dev, gen, levels=LEVELS, batch=BATCH, dtypes=("bf16", "fp32")):
    """K1 against its plain version at the five level shapes, bf16 and fp32:
    moments to rtol 1e-5 and bitwise equal from call to call, apply within
    one ulp; times per call and per forward."""
    cl3d = torch.channels_last_3d
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    keys = ("moments_ms", "moments_event_ms", "moments_plain_ms", "moments_bound",
            "moments_library_ms", "apply_ms", "apply_event_ms", "apply_plain_ms",
            "apply_bound", "library_ms", "moments_err", "apply_err")
    # the least share of launches the profiler kept for any time in the sum
    totals = {dt: dict(dict.fromkeys(keys, 0.0), moments_kept=1.0, apply_kept=1.0)
              for dt in dtypes}
    for dt_name in dtypes:
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dt_name]
        tot = totals[dt_name]
        for level, (c, e, n_gn) in enumerate(levels):
            shape = (batch, e, e, e, c)
            x = (torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype)
            x = x.permute(0, 4, 1, 2, 3)
            r = torch.randn(shape, generator=gen, device=dev).to(dtype).permute(0, 4, 1, 2, 3)
            assert x.is_contiguous(memory_format=cl3d)
            w = torch.rand(c, generator=gen, device=dev) + 0.5
            b = torch.rand(c, generator=gen, device=dev) - 0.5

            moments = lambda: gn.group_norm_moments(x, GROUPS, w, 1e-5)
            stats = moments()
            again = moments()
            plain = gn.group_norm_moments_plain(x, GROUPS, w, 1e-5)
            for got, ref in zip(stats, plain):
                torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)
            if not all(torch.equal(u, v) for u, v in zip(stats, again)):
                raise AssertionError(f"gn_moments {dt_name} level {level}: two calls "
                                     "differ")
            m_err = max(float((u - v).abs().max()) for u, v in zip(stats, plain))
            mean_c, mul_c, mean_p, mul_p = stats.mean, stats.mul, plain.mean, plain.mul

            errs = []
            for res in (None, r):
                y = gn.group_norm_apply(x, mean_p, mul_p, b, residual=res, act="e")
                y_p = gn.group_norm_apply_plain(x, mean_p, mul_p, b, residual=res, act="e")
                diff = (y.float() - y_p.float()).abs()
                tol = torch.full_like(diff, 1e-5) if dtype == torch.float32 else bf16_ulp(y_p)
                if not bool((diff <= tol).all()):
                    i = int(torch.argmax(diff / tol))
                    raise AssertionError(
                        f"gn_apply {dt_name} level {level} residual={res is not None}: "
                        f"max |diff| {float(diff.max())}; worst vs tolerance at flat index "
                        f"{i}: kernel {float(y.flatten()[i])} plain {float(y_p.flatten()[i])} "
                        f"tolerance {float(tol.flatten()[i])}")
                errs.append(float(diff.max()))

            esz = x.element_size()
            n_el = x.numel()
            plan = gn.plan_moments(batch, e**3, c, esz, x.data_ptr() % 16 == 0, sms)
            route = gn.plan_apply(batch, e**3, c, esz, x.data_ptr() % 16 == 0, sms).route
            # one gn_moments launch a call and nothing else (the first design of
            # the statistics side launched 14); a record the profiler dropped reads below 1
            t_m, kept_m, rows = kernel_ms(torch, moments, "gn_moments")
            launches = sum(count for _, count, _ in rows)
            if any("gn_moments" not in key for *_, key in rows) or launches > 1:
                raise AssertionError(f"the statistics side of one GroupNorm launched "
                                     f"{launches} device activities, not 1: {rows}")
            t_me = cuda_ms(moments)
            t_mp = cuda_ms(lambda: gn.group_norm_moments_plain(x, GROUPS, w, 1e-5), reps=5)
            b_m = bound_ms(n_el * esz + 3 * batch * c * 4 + c * 4, 3 * n_el)
            # yardstick only: the same per-(n, c) moments up to a rescale
            t_sl = cuda_ms(lambda: torch.var_mean(x, dim=(2, 3, 4), correction=0))
            apply = lambda: gn.group_norm_apply(x, mean_c, mul_c, b, act="e")
            apply_r = lambda: gn.group_norm_apply(x, mean_c, mul_c, b, residual=r, act="e")
            t_a, kept_a, _ = kernel_ms(torch, apply, "gn_apply")
            t_ar, kept_ar, _ = kernel_ms(torch, apply_r, "gn_apply")
            t_ae, t_are = cuda_ms(apply), cuda_ms(apply_r)
            t_ap = cuda_ms(lambda: gn.group_norm_apply_plain(x, mean_c, mul_c, b, act="e"), reps=5)
            t_arp = cuda_ms(lambda: gn.group_norm_apply_plain(
                x, mean_c, mul_c, b, residual=r, act="e"), reps=5)
            small = (2 * batch * c + c) * 4
            b_a = bound_ms(2 * n_el * esz + small, 5 * n_el)
            b_ar = bound_ms(3 * n_el * esz + small, 6 * n_el)
            t_lib = cuda_ms(lambda: torch.nn.functional.elu(
                torch.nn.functional.group_norm(x, GROUPS, w.to(dtype), b.to(dtype), 1e-5)))
            log(f"K1 {dt_name} level {level} {tuple(x.shape)}: moments {t_m:.4f} ms device "
                f"(profiler kept {kept_m:g}, apply {min(kept_a, kept_ar):g} of the launches; "
                f"event {t_me:.4f}; plain {t_mp:.4f}, bound {b_m:.4f}, torch.var_mean "
                f"{t_sl:.4f}), {launches:g} launch per GroupNorm, route {plan.route} "
                f"{plan.blocks} blocks/sample, max|err| {m_err:.3g}, two calls bitwise "
                f"equal; apply ({route} route) +elu {t_a:.4f} ms device (event {t_ae:.4f}; "
                f"plain {t_ap:.4f}, "
                f"bound {b_a:.4f}), apply+res+elu {t_ar:.4f} (event {t_are:.4f}; plain "
                f"{t_arp:.4f}, bound {b_ar:.4f}), max|err| {max(errs):.3g}; "
                f"F.group_norm+F.elu {t_lib:.4f} ms")
            # one forward: n_gn moments calls; 2/3 plain and 1/3 residual applies
            k, k_res = n_gn * 2 // 3, n_gn // 3
            tot["moments_ms"] += n_gn * t_m
            tot["moments_event_ms"] += n_gn * t_me
            tot["moments_plain_ms"] += n_gn * t_mp
            tot["moments_bound"] += n_gn * b_m
            tot["moments_library_ms"] += n_gn * t_sl
            tot["apply_ms"] += k * t_a + k_res * t_ar
            tot["apply_event_ms"] += k * t_ae + k_res * t_are
            tot["apply_plain_ms"] += k * t_ap + k_res * t_arp
            tot["apply_bound"] += k * b_a + k_res * b_ar
            tot["library_ms"] += n_gn * t_lib
            tot["moments_err"] = max(tot["moments_err"], m_err)
            tot["apply_err"] = max(tot["apply_err"], max(errs))
            tot["moments_kept"] = min(tot["moments_kept"], kept_m)
            tot["apply_kept"] = min(tot["apply_kept"], kept_a, kept_ar)
            del x, r
        before = GRID_STRIDE_APPLY_SUMS.get((dt_name, batch, *levels[0][:2]), "not recorded")
        log(f"K1 {dt_name} per full-width forward (27 GroupNorms): moments "
            f"{tot['moments_ms']:.4f} ms device (event {tot['moments_event_ms']:.4f}; "
            f"bound {tot['moments_bound']:.4f}, torch.var_mean "
            f"{tot['moments_library_ms']:.4f}), apply {tot['apply_ms']:.4f} ms device "
            f"(event {tot['apply_event_ms']:.4f}; bound {tot['apply_bound']:.4f}; "
            f"grid-stride design {before}), "
            f"F.group_norm+F.elu {tot['library_ms']:.4f} ms")
    return totals


def check_gather(torch, P, grid_corners, dev, gen):
    """K2 against its plain version on the padded 224^3 x 1 f16 volume."""
    corners, padded = grid_corners(SLICE_VOLUMES[0][1], PATCH, OVERLAP)
    corners = corners[:BATCH]
    vol = torch.randn((*padded.tolist(), 1), generator=gen, device=dev).half()
    err = 0.0
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        got = P.extract_patches(vol, corners, PATCH, out_dtype=dtype)
        ref = P.extract_patches_plain(vol, corners, PATCH, out_dtype=dtype)
        if got.shape != ref.shape or not torch.equal(got.view(-1).view(torch.uint8),
                                                     ref.view(-1).view(torch.uint8)):
            raise AssertionError(f"gather_patches {dtype}: not byte-equal to plain")
        err = max(err, float((got.float() - ref.float()).abs().max()))
    gather = lambda: P.extract_patches(vol, corners, PATCH, out_dtype=torch.bfloat16)
    t = cuda_ms(gather)
    t_p = cuda_ms(lambda: P.extract_patches_plain(vol, corners, PATCH,
                                                  out_dtype=torch.bfloat16), reps=5)
    # the kernel's own device time, apart from the wrapper's host work
    reps = 20
    t_dev, kept, rows = kernel_ms(torch, gather, "gather", reps)
    n_el = BATCH * int(np.prod(PATCH))
    b = bound_ms(n_el * (2 + 2), 0)
    # no one PyTorch call gathers N windows at host corners with the cast
    # fused in, so K2 has no library time
    log(f"K2 {tuple(vol.shape)} f16 -> {BATCH}x{PATCH} bf16: kernel device time "
        f"{t_dev:.4f} ms (profiler, {reps} calls, kept {kept:g} of the launches; bound "
        f"{b:.4f}); {t:.4f} ms per wrapper call (event; plain {t_p:.4f}); byte-equal in "
        f"bf16/fp32/f16, max|err| {err}")
    for ms, count, name in sorted(rows, reverse=True):
        log(f"K2 profile: {ms:8.4f} ms  x{count:<4g} {name[:100]}")
    return dict(ms=t_dev, wrapper_ms=t, plain_ms=t_p, bound=b, err=err, kept=kept)


def check_forward(torch, gn, P, ResidualUNet3D, dev, gen):
    """Full-width forward on the kernel path against the plain path."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
        f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.benchmark={torch.backends.cudnn.benchmark}")
    fp32 = ResidualUNet3D(1, 2, f_maps=32, dtype=torch.float32, device=dev,
                          generator=torch.Generator().manual_seed(0))
    n_params = sum(p.numel() for p in fp32.parameters())
    log(f"ResidualUNet3D(1, 2, f_maps=32) parameters: {n_params}")
    if n_params != FULL_WIDTH_PARAMS:
        raise AssertionError(f"expected {FULL_WIDTH_PARAMS} parameters")
    x = torch.randn((BATCH, 1, *PATCH), generator=gen, device=dev)
    bf16 = ResidualUNet3D(1, 2, f_maps=32, dtype=torch.bfloat16, device=dev)
    bf16.load_state_dict(fp32.state_dict())
    with torch.inference_mode():
        y = fp32(x)
        with plain_kernels(gn, P):
            y_p = fp32(x)
        err32 = float((y - y_p).abs().max())
        log(f"forward fp32 {tuple(y.shape)}: max|kernel - plain| {err32:.3g} "
            f"(bound {FWD_FP32_ATOL}), max|logit| {float(y_p.abs().max()):.3g}")
        if not (torch.isfinite(y).all() and err32 <= FWD_FP32_ATOL):
            raise AssertionError("fp32 forward: kernel path disagrees with plain path")
        del y, y_p

        y = bf16(x)
        with plain_kernels(gn, P):
            y_p = bf16(x)
            t_plain = cuda_ms(lambda: bf16(x), reps=3, warmup=1)
        t_fwd = cuda_ms(lambda: bf16(x), reps=5, warmup=1)
        err16 = float((y - y_p).abs().max())
        scale = float(y_p.abs().max())
        # two classes: an argmax can flip only where the plain margin is
        # below twice the largest logit difference
        margin = (y_p[:, 0] - y_p[:, 1]).abs()
        flips = y.argmax(dim=1) != y_p.argmax(dim=1)
        if bool((flips & (margin > 2 * err16)).any()):
            raise AssertionError("bf16 forward: a class flipped outside the tie band")
        log(f"forward bf16: voxels with top-2 margin <= max|kernel - plain|: "
            f"{float((margin <= err16).float().mean()):.6f}; argmax flips "
            f"{float(flips.float().mean()):.6f}, all within the tie band")
        log(f"forward bf16: max|kernel - plain| {err16:.3g} (bound {FWD_BF16_REL} x "
            f"max|logit| {scale:.3g}); {t_fwd:.2f} ms per forward of {BATCH}x96^3 "
            f"(plain path {t_plain:.2f} ms)")
        if not (torch.isfinite(y).all() and err16 <= FWD_BF16_REL * scale):
            raise AssertionError("bf16 forward: kernel path disagrees with plain path")
    return {"fp32": fp32, "bf16": bf16}, dict(fwd_ms=t_fwd, fwd_plain_ms=t_plain)


def profile_forward(torch, gn, model, dev, gen, reps=3):
    """Device time of one bf16 forward by kernel, from torch.profiler."""
    x = torch.randn((BATCH, 1, *PATCH), generator=gen, device=dev)
    n_gn = sum(n for _, _, n in LEVELS)
    with torch.inference_mode():
        model(x)
        before = gn.STATS_LAUNCHES
        rows, kept = profile_kept(torch, gn, lambda: model(x), reps)
        rows = [r for r in rows if not r[2].startswith(("Memcpy", "Memset"))]
    # one statistics launch per GroupNorm, by the counter
    if gn.STATS_LAUNCHES - before != reps * n_gn:
        raise AssertionError(f"forward: {(gn.STATS_LAUNCHES - before) / reps:g} gn_moments "
                             f"launches per forward, not one per GroupNorm ({n_gn})")
    stale = [name for _, _, name in rows if "gn_stats" in name or "gn_combine" in name]
    if stale:
        raise AssertionError(f"forward: the first design's statistics kernels ran: {stale}")
    total = sum(r[0] for r in rows)
    if total == 0:
        log("profile: the profiler saw no device time")
        return
    moments = [(ms, count) for ms, count, name in rows if "gn_moments" in name]
    log(f"profile: statistics side per bf16 forward {sum(ms for ms, _ in moments):.4f} ms "
        f"device in {sum(count for _, count in moments):g} gn_moments launch records of "
        f"{n_gn} launches (profiler kept {kept:g}); "
        f"{sum(count for _, count, _ in rows):g} device launch records per forward")
    groups = {}
    for ms, _, name in rows:
        low = name.lower()
        group = ("K1 groupnorm" if "gn_" in low else "K2 gather" if "gather_stores" in low
                 else "cuDNN conv" if any(t in low for t in ("conv", "xmma", "gemm", "cudnn",
                                                             "cutlass", "dgrad", "wgrad"))
                 else "other")
        groups[group] = groups.get(group, 0.0) + ms
    log(f"profile: device time per bf16 forward {total:.3f} ms; " + ", ".join(
        f"{g} {ms:.3f} ms ({100 * ms / total:.1f}%)" for g, ms in
        sorted(groups.items(), key=lambda kv: -kv[1])))
    for ms, count, name in sorted(rows, reverse=True)[:12]:
        log(f"profile:   {ms:8.3f} ms  x{count:<4g} {name[:110]}")


def tie_band_margin(torch, gn, P, model, vol, grid_corners, dev, classes=slice(None)):
    """The plain path's top-2 logit margin at every voxel of ``vol``'s mask,
    and max |kernel - plain| over its tiles' logits, both over the output
    channels ``classes`` (a landmark model's class logits follow its
    heatmaps).

    Tiles, batches (the tail repeats the last corner) and cores are those of
    ``predict_volumes_on_device``, so each voxel's margin is that of the
    logits its mask value came from.
    """
    import torch.nn.functional as F

    img = np.asarray(vol.shape[1:])
    corners, padded = grid_corners(img, PATCH, OVERLAP)
    corners = np.concatenate([corners, np.repeat(corners[-1:], -len(corners) % BATCH, 0)])
    ov = OVERLAP
    pads = [int(p) for o, pd, n in reversed(list(zip(ov, padded, img)))
            for p in (o, pd - n - o)]
    v = F.pad(torch.from_numpy(vol).to(dev).permute(1, 2, 3, 0).contiguous(), (0, 0, *pads))
    margin = torch.zeros(tuple(padded.tolist()), device=dev)
    err = 0.0
    core = tuple(slice(o, p - o) for o, p in zip(ov, PATCH))
    for i in range(0, len(corners), BATCH):
        batch = corners[i:i + BATCH]
        tiles = P.extract_patches_plain(v, batch, PATCH, out_dtype=model.config.dtype)
        tiles = tiles.permute(0, 4, 1, 2, 3)
        y = model(tiles)[:, classes]
        with plain_kernels(gn, P):
            y_p = model(tiles)[:, classes]
        err = max(err, float((y - y_p).abs().max()))
        top2 = y_p.float().topk(2, dim=1).values
        m = top2[:, 0] - top2[:, 1]
        for (x0, y0, z0), tile in zip(batch.tolist(), m[(slice(None), *core)]):
            margin[x0 + ov[0]:x0 + PATCH[0] - ov[0], y0 + ov[1]:y0 + PATCH[1] - ov[1],
                   z0 + ov[2]:z0 + PATCH[2] - ov[2]] = tile
    margin = margin[ov[0]:ov[0] + img[0], ov[1]:ov[1] + img[1], ov[2]:ov[2] + img[2]]
    return margin.cpu().numpy(), err


def run_slice(torch, gn, P, models, grid_corners, dev):
    """The main path: predict_volumes_on_device on two seeded volumes, bf16
    (launches counted, then timed and profiled), then both dtypes against
    the plain path."""
    from tpu_mednet_torch.data import MemoryReader
    from tpu_mednet_torch.inference import predict_volumes_on_device
    from tpu_mednet_torch.tasks import SegmentationTask

    rng = np.random.default_rng(0)
    store = {"images": {}}
    for key, shape in SLICE_VOLUMES:
        vol = rng.normal(0.0, 0.5, size=(1, *shape)).astype(np.float16)
        vol[0, 40:100, 50:110, 30:90] += 2.0
        store["images"][key] = vol
    keys = list(store["images"])
    kw = dict(patch_size=list(PATCH), patch_overlap=list(OVERLAP), batch_size=BATCH,
              device=dev)

    def predict(task):
        return predict_volumes_on_device(task, None, keys, reader=MemoryReader(store), **kw)

    def timed(task):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = predict(task)
        return out, time.perf_counter() - t0

    tasks = {dt: SegmentationTask(model=m) for dt, m in models.items()}
    predict(tasks["bf16"])  # warm-up
    reset_counts(gn, P)
    got, seconds = timed(tasks["bf16"])
    got = {"bf16": got}
    counts = launch_counts(gn, P)
    n_batches = sum(
        -(-int(np.prod([-(-s // (p - 2 * o)) for s, p, o in zip(shape, PATCH, OVERLAP)]))
          // BATCH) for _, shape in SLICE_VOLUMES)
    log(f"slice bf16: launches {counts} over {n_batches} batches")
    expected = dict(gn_moments=27 * n_batches, gn_apply=27 * n_batches, gn_bwd_reduce=0,
                    gn_bwd_apply=0, gather_patches=n_batches)
    if counts != expected:
        raise AssertionError(f"launch counts {counts}, expected {expected}")

    # host-clock time of the whole call, from f16 host volumes to uint8 host masks
    walls = [seconds] + [timed(tasks["bf16"])[1] for _ in range(SLICE_REPEATS)]
    wall = float(np.median(walls))
    vpm = [len(keys) / w * 60.0 for w in walls]
    log(f"slice bf16: {len(keys)} volumes per call, {len(walls)} calls: "
        f"{' '.join(f'{w:.4f}' for w in walls)} s; median {wall:.4f} s = "
        f"{len(keys) / wall * 60.0:.2f} volumes/min (min {min(vpm):.2f}, max {max(vpm):.2f})")
    rows, kept = profile_kept(torch, gn, lambda: predict(tasks["bf16"]), 1)
    busy = sum(ms for ms, _, _ in rows) / 1e3
    idle = idle_share(busy, wall, kept)
    log(f"slice bf16: device busy {busy:.4f} s per call (profiler, kernels and copies; it "
        f"kept {kept:g} of the gn_moments launches); idle share {idle:.4f} of the median call")

    got["fp32"] = predict(tasks["fp32"])
    agreement = {}
    for dt, task in tasks.items():
        launched = launch_counts(gn, P)
        with plain_kernels(gn, P):
            ref = predict(task)
        if launch_counts(gn, P) != launched:
            raise AssertionError("the plain-path run launched a kernel")
        agree = total = 0
        for k, shape in SLICE_VOLUMES:
            a, b = np.asarray(got[dt][k]), np.asarray(ref[k])
            if a.shape != (1, *shape) or a.dtype != np.uint8 or not set(np.unique(a)) <= {0, 1}:
                raise AssertionError(f"{k}: bad mask {a.shape} {a.dtype}")
            with torch.inference_mode():
                margin, err = tie_band_margin(torch, gn, P, task.model, store["images"][k],
                                              grid_corners, dev)
            flips = a[0] != b[0]
            outside = int((flips & (margin > 2 * err)).sum())
            agree += int((~flips).sum())
            total += flips.size
            log(f"slice {dt} {k} {shape}: foreground {a.mean():.4f}; max|kernel - plain| "
                f"logit {err:.3g}; voxels with margin <= 2x that {(margin <= 2 * err).mean():.6f}; "
                f"mask differs on {flips.mean():.6f}, outside the tie band on {outside}")
            if outside:
                raise AssertionError(f"slice {dt} {k}: {outside} voxels differ from the "
                                     "plain path outside the tie band")
        agreement[dt] = agree / total
        log(f"slice {dt}: voxel agreement with the plain path {agreement[dt]:.6f}")
    return counts, dict(volumes_per_min=len(keys) / wall * 60.0, seconds=walls,
                        device_busy_s=busy, idle_share=idle, profiler_kept=kept,
                        n_batches=n_batches, agreement=agreement)


def backward_errors(torch, got, ref):
    """Max |kernel - plain| per output of K1's backward, and whether each is
    inside its tolerance: dγ, dβ 1e-4 * max |ref| (per-(n, c) sums in
    another fp32 order); dx, d(residual) 1e-5 * max |ref| in fp32 and one
    bf16 ulp of the plain value plus 1e-5 * max |ref| in bf16."""
    errs, ok = {}, True
    for name, g, r in zip(got._fields, got, ref):
        if r is None:
            continue
        g, rf = g.float(), r.float()
        scale = float(rf.abs().max())
        diff = (g - rf).abs()
        if name in ("dweight", "dbias"):
            tol = 1e-4 * scale
        elif r.dtype == torch.float32:
            tol = 1e-5 * scale
        else:
            tol = bf16_ulp(rf) + 1e-5 * scale
        ok = ok and bool((diff <= tol).all())
        errs[name] = float(diff.max())
    return errs, ok


def check_gn_backward(torch, gn, dev, gen, levels=LEVELS,
                      configs=(("bf16", TRAIN_BATCH), ("fp32", BATCH))):
    """K1's backward kernels against ``group_norm_backward_plain`` at the
    five level shapes, bf16 at the training batch and fp32 at batch 8, with
    and without the residual, ELU as in the model; bitwise equal from call
    to call; device times per call and per train step beside the bound,
    the plain version and torch autograd of F.group_norm + F.elu."""
    import torch.nn.functional as F

    cl3d = torch.channels_last_3d
    out = {}
    for dt_name, batch in configs:
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dt_name]
        tot = dict(reduce_ms=0.0, apply_ms=0.0, reduce_bound=0.0, apply_bound=0.0,
                   plain_ms=0.0, library_ms=0.0, err=0.0, reduce_kept=1.0, apply_kept=1.0)
        for level, (c, e, n_gn) in enumerate(levels):
            shape = (batch, e, e, e, c)
            act = lambda: torch.randn(shape, generator=gen, device=dev).to(dtype).permute(
                0, 4, 1, 2, 3)
            x, dy, r = (act() + 0.5), act(), act()
            assert x.is_contiguous(memory_format=cl3d)
            w = torch.rand(c, generator=gen, device=dev) + 0.5
            b = torch.rand(c, generator=gen, device=dev) - 0.5
            stats = gn.group_norm_moments(x, GROUPS, w, 1e-5)
            n_el, esz = x.numel(), x.element_size()
            small = 6 * batch * c * 4 + 2 * c * 4
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            route = gn.plan_apply(batch, e**3, c, esz, x.data_ptr() % 16 == 0, sms).route
            row = {}
            for res in (None, r):
                tag = "res" if res is not None else "plain"
                bwd = lambda: gn.group_norm_backward(x, dy, stats.mean, stats.rstd, w, b,
                                                     GROUPS, res, GN_ACT)
                got, again = bwd(), bwd()
                ref = gn.group_norm_backward_plain(x, dy, stats.mean, stats.rstd, w, b,
                                                   GROUPS, res, GN_ACT)
                errs, ok = backward_errors(torch, got, ref)
                if not ok:
                    raise AssertionError(f"gn_bwd {dt_name} level {level} residual="
                                         f"{res is not None}: {errs} outside tolerance")
                if not all(u is None or torch.equal(u, v) for u, v in zip(got, again)):
                    raise AssertionError(f"gn_bwd {dt_name} level {level}: two calls differ")
                del got, again, ref
                t_r, kept_r, _ = kernel_ms(torch, bwd, "gn_bwd_reduce", reps=10)
                t_a, kept_a, _ = kernel_ms(torch, bwd, "gn_bwd_apply", reps=10)
                tot["reduce_kept"] = min(tot["reduce_kept"], kept_r)
                tot["apply_kept"] = min(tot["apply_kept"], kept_a)
                t_p = cuda_ms(lambda: gn.group_norm_backward_plain(
                    x, dy, stats.mean, stats.rstd, w, b, GROUPS, res, GN_ACT),
                    reps=3, warmup=1)
                k = 3 if res is not None else 2
                b_r = bound_ms(k * n_el * esz + small, 12 * n_el)
                b_a = bound_ms((k + (2 if res is not None else 1)) * n_el * esz + small,
                               14 * n_el)
                # yardstick: torch autograd of F.group_norm + F.elu (+ the add)
                xg = x.detach().requires_grad_()
                wg = w.to(dtype, copy=True).requires_grad_()
                bg = b.to(dtype, copy=True).requires_grad_()
                rg = None if res is None else res.detach().requires_grad_()
                y = F.group_norm(xg, GROUPS, wg, bg, 1e-5)
                y = F.elu(y if rg is None else y + rg)
                ins = (xg, wg, bg) if rg is None else (xg, wg, bg, rg)
                t_lib = cuda_ms(lambda: torch.autograd.grad(y, ins, dy, retain_graph=True),
                                reps=3, warmup=1)
                del y, xg, wg, bg, rg
                row[tag] = dict(reduce=t_r, apply=t_a, plain=t_p, b_r=b_r, b_a=b_a,
                                lib=t_lib, err=max(errs.values()))
                plan_text = reduce_plan_text(gn, x, dy, res, GROUPS, GN_ACT)
                log(f"K1 backward {dt_name} level {level} {tuple(x.shape)} residual="
                    f"{res is not None}: reduce ({plan_text}) "
                    f"{t_r:.4f} ms device (bound {b_r:.4f}), "
                    f"apply ({route} route) {t_a:.4f} ms (bound {b_a:.4f}); profiler kept "
                    f"{kept_r:g} and "
                    f"{kept_a:g} of the launches; plain {t_p:.4f} ms; "
                    f"F.group_norm+F.elu autograd {t_lib:.4f} ms; max|err| {errs}; "
                    "two calls bitwise equal")
            # one train step: n_gn GroupNorms, a third of them with the residual
            k, k_res = n_gn * 2 // 3, n_gn // 3
            for key, field in (("reduce_ms", "reduce"), ("apply_ms", "apply"),
                               ("reduce_bound", "b_r"), ("apply_bound", "b_a"),
                               ("plain_ms", "plain"), ("library_ms", "lib")):
                tot[key] += k * row["plain"][field] + k_res * row["res"][field]
            tot["err"] = max(tot["err"], row["plain"]["err"], row["res"]["err"])
            del x, dy, r, stats
            torch.cuda.empty_cache()
        before = GRID_STRIDE_BWD_APPLY_SUMS.get((dt_name, batch, *levels[0][:2]),
                                                "not recorded")
        first = FIRST_REDUCE_SUMS.get((dt_name, batch, *levels[0][:2]), "not recorded")
        log(f"K1 backward {dt_name} per train step of batch {batch} (27 GroupNorms): "
            f"reduce {tot['reduce_ms']:.4f} ms device (bound {tot['reduce_bound']:.4f}; "
            f"first design {first}), "
            f"apply {tot['apply_ms']:.4f} ms (bound {tot['apply_bound']:.4f}; grid-stride "
            f"design {before}); "
            f"plain {tot['plain_ms']:.4f} ms; F.group_norm+F.elu autograd "
            f"{tot['library_ms']:.4f} ms")
        out[dt_name] = tot
    return out


def check_gather_indexed(torch, P, sampler, batch):
    """Indexed K2 on a training sampler's device stores (bf16 images, uint8
    labels) at one batch of its own draws at its patch size: both stores in
    one launch, as ``DevicePatchSampler.gather`` cuts them, and each store
    alone through the same kernel, byte-equal to plain.  The fused bound
    counts both outputs' bytes twice (read and written) and the windows'
    16 bytes once; a device-to-device ``copy_`` of as many bytes is printed
    beside it as a practical ceiling, not as the bound."""
    subj, corners = sampler.sample_indices(batch)
    patch = tuple(int(p) for p in sampler.patch_size)
    stores = dict(image=sampler.images, label=sampler.labels)
    fused = lambda: P.extract_patches_stores(tuple(stores.values()), corners, patch, subj)
    launched = P.LAUNCHES
    got = dict(zip(stores, fused()))
    if P.LAUNCHES != launched + 1:
        raise AssertionError(f"indexed gather: {P.LAUNCHES - launched} launches for one batch")
    res, moved = {}, 0
    for name, store in stores.items():
        alone = lambda: P.extract_patches(store, corners, patch, subjects=subj)
        ref = P.extract_patches_plain(store, corners, patch, subjects=subj)
        for how, out in (("fused", got[name]), ("alone", alone())):
            if out.shape != ref.shape or not torch.equal(out.view(-1).view(torch.uint8),
                                                         ref.view(-1).view(torch.uint8)):
                raise AssertionError(f"indexed gather {name} ({how}): not byte-equal to plain")
        t_dev, kept, _ = kernel_ms(torch, alone, "gather", reps=20)
        t_p = cuda_ms(lambda: P.extract_patches_plain(store, corners, patch, subjects=subj),
                      reps=3, warmup=1)
        out_bytes = ref.numel() * ref.element_size()
        moved += out_bytes
        res[name] = dict(ms=t_dev, plain_ms=t_p, bound=bound_ms(2 * out_bytes + 16 * batch, 0),
                         kept=kept)
        log(f"K2 indexed {name} store {tuple(store.shape)} {store.dtype} -> "
            f"{tuple(ref.shape)} alone: {t_dev:.4f} ms device (profiler kept {kept:g} of the "
            f"launches; bound {res[name]['bound']:.4f}); plain {t_p:.4f} ms; byte-equal")
    t_dev, kept, _ = kernel_ms(torch, fused, "gather", reps=20)
    src = torch.empty(moved, dtype=torch.uint8, device=sampler.images.device)
    dst = torch.empty_like(src)
    copy_ms = cuda_ms(lambda: dst.copy_(src))  # back to back: the device's time
    bound = bound_ms(2 * moved + 16 * batch, 0)
    log(f"K2 indexed image + label stores, one launch: {t_dev:.4f} ms device (profiler kept "
        f"{kept:g} of the launches; bound {bound:.4f}, {bound / t_dev:.1%} of it); the two "
        f"stores alone {res['image']['ms']:.4f} + {res['label']['ms']:.4f} ms; a "
        f"device-to-device copy_ of the same {moved} bytes {copy_ms:.4f} ms (events); "
        f"byte-equal")
    return dict(ms=t_dev, plain_ms=res["image"]["plain_ms"] + res["label"]["plain_ms"],
                bound=bound, err=0.0, kept=kept, copy_ms=copy_ms, per_store=res)


def check_train_parity(torch, gn, P, models, dev, gen):
    """One full-width train step's loss and gradients, kernel path against
    plain path, same parameters and batch, fp32 (TF32 off) and bf16; every
    parameter must receive a non-zero gradient on the kernel path."""
    from tpu_mednet_torch.tasks import SegmentationTask

    x = torch.randn((PARITY_BATCH, 1, *PATCH), generator=gen, device=dev)
    label = torch.zeros((PARITY_BATCH, 1, *PATCH), dtype=torch.uint8, device=dev)
    label[:, :, 20:70, 30:80, 10:60] = 1
    x = x + label
    batch = {"data": x, "label": label}
    out = {}
    for dt, model in models.items():
        task = SegmentationTask(model=model, loss="DICE")

        def grads():
            model.zero_grad(set_to_none=True)
            loss, _ = task.loss_fn(model(x), batch)
            loss.backward()
            return float(loss.detach()), {k: p.grad for k, p in model.named_parameters()}

        loss, g = grads()
        with plain_kernels(gn, P):
            loss_p, g_p = grads()
        zero = [k for k, v in g.items() if v is None or not bool(v.abs().max() > 0)]
        if zero:
            raise AssertionError(f"train parity {dt}: no gradient on the kernel path for "
                                 f"{zero}")
        rel = {k: float((g[k] - g_p[k]).abs().max()) / float(g_p[k].abs().max()) for k in g}
        worst = max(rel, key=rel.get)
        out[dt] = dict(loss=loss, loss_plain=loss_p, worst_param=worst,
                       worst_rel=rel[worst], params=len(rel))
        log(f"train parity {dt} batch {PARITY_BATCH}: loss kernel {loss:.6f} plain "
            f"{loss_p:.6f}; every one of {len(rel)} parameters has a non-zero gradient; "
            f"max over parameters of max|dg|/max|g| {rel[worst]:.3g} ({worst}; bound "
            f"{PARITY_REL[dt]})")
        if abs(loss - loss_p) > PARITY_REL[dt] or rel[worst] > PARITY_REL[dt]:
            raise AssertionError(f"train parity {dt}: kernel path disagrees with plain path")
        model.zero_grad(set_to_none=True)
    return out


def step_groups(rows):
    """Device ms by group of a training step's kernels (``device_rows``)."""
    groups = {}
    for ms, _, name in rows:
        low = name.lower()
        if low.startswith(("memcpy", "memset")):
            group = "copies"
        elif "gn_bwd" in low:
            group = "K1 backward"
        elif "gn_" in low:
            group = "K1 forward"
        elif "gather_stores" in low:  # not torch's scatter/gather kernels
            group = "K2 gather"
        elif "multi_tensor_apply" in low or "adam" in low:
            group = "Adam"
        elif "dgrad" in low:
            group = "cuDNN dgrad"
        elif "wgrad" in low:
            group = "cuDNN wgrad"
        elif any(t in low for t in ("fprop", "conv", "xmma", "gemm", "cudnn", "cutlass")):
            group = "cuDNN fprop"
        else:
            group = "other"
        groups[group] = groups.get(group, 0.0) + ms
    return groups


def seeded_train_sampler(dev):
    """``DevicePatchSampler`` over ``TRAIN_SUBJECTS``: a class-1 box in noise."""
    from tpu_mednet_torch.data import DevicePatchSampler, MemoryReader

    rng = np.random.default_rng(1)
    store = {"images": {}, "labels": {}}
    for key, shape in TRAIN_SUBJECTS:
        lbl = np.zeros((1, *shape), np.uint8)
        lbl[0, 40:100, 50:110, 30:90] = 1
        store["images"][key] = rng.normal(0.0, 0.5, size=(1, *shape)).astype(np.float32) + lbl
        store["labels"][key] = lbl
    return DevicePatchSampler(None, [k for k, _ in TRAIN_SUBJECTS], TRAIN_BATCH // 4,
                              PATCH, reader=MemoryReader(store),
                              class_probabilities=[0.5, 0.5], seed=0, device=dev)


def endless_batches(sampler, batch):
    while True:
        yield from sampler.batches(batch)


def run_training(torch, gn, P, dev):
    """The training path: DevicePatchSampler -> create_train_state ->
    make_train_step at full width, bf16, batch 32, bench.py's augment;
    launches counted over the timed steps."""
    from tpu_mednet_torch.models import ResidualUNet3D
    from tpu_mednet_torch.ops.augment import AugmentConfig
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.train import create_train_state, make_train_step

    sampler = seeded_train_sampler(dev)
    k2 = check_gather_indexed(torch, P, sampler, TRAIN_BATCH)
    feed = endless_batches(sampler, TRAIN_BATCH)
    model = ResidualUNet3D(1, 2, f_maps=32, dtype=torch.bfloat16, device=dev,
                           generator=torch.Generator().manual_seed(0))
    task = SegmentationTask(model=model, loss="DICE")
    state = create_train_state(model, learning_rate=1e-3, seed=0)
    step = make_train_step(task, augment=AugmentConfig(mirror_axes=(1, 2, 3)))

    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(TRAIN_WARMUP):
        state, metrics = step(state, next(feed))
        if not np.isfinite(float(metrics["train_loss"])):
            raise AssertionError("training: non-finite loss in a warm-up step")
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(TRAIN_STEPS)]
    losses = []
    reset_counts(gn, P)
    t0 = time.perf_counter()
    for start, end in events:
        start.record()
        state, metrics = step(state, next(feed))
        end.record()
        losses.append(metrics["train_loss"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = launch_counts(gn, P)
    peak = torch.cuda.max_memory_allocated(dev)
    log_clocks("after the timed training steps")
    expected = {k: TRAIN_STEPS * v for k, v in dict(
        gn_moments=27, gn_apply=27, gn_bwd_reduce=27, gn_bwd_apply=27,
        gather_patches=1).items()}
    log(f"training: launches {counts} over {TRAIN_STEPS} steps")
    if counts != expected:
        raise AssertionError(f"training launch counts {counts}, expected {expected}")
    losses = [float(v) for v in losses]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"training: non-finite loss {losses}")
    step_ms = [a.elapsed_time(b) for a, b in events]
    median = float(np.median(step_ms))
    log(f"training bf16 batch {TRAIN_BATCH} of 96^3: steps {' '.join(f'{t:.2f}' for t in step_ms)}"
        f" ms (events); median {median:.2f} ms = {TRAIN_BATCH / median * 1e3:.2f} patches/s "
        f"(min {TRAIN_BATCH / max(step_ms) * 1e3:.2f}, max {TRAIN_BATCH / min(step_ms) * 1e3:.2f}); "
        f"host clock {wall / TRAIN_STEPS * 1e3:.2f} ms per step; peak memory "
        f"{peak / 2**30:.2f} GiB; losses {' '.join(f'{v:.4f}' for v in losses)}")

    reps = 2
    rows, kept = profile_kept(torch, gn, lambda: step(state, next(feed)), reps)
    busy = sum(ms for ms, _, _ in rows)
    idle = idle_share(busy, median, kept)
    groups = step_groups(rows)
    logits = torch.randn((TRAIN_BATCH, 2, *PATCH), device=dev, requires_grad=True)
    label = next(feed)["label"]

    def loss_pass():
        loss, _ = task.loss_fn(logits, {"label": label})
        loss.backward()

    loss_ms = sum(ms for ms, _, _ in device_rows(torch, loss_pass, reps))
    log(f"training profile: device time per step {busy:.3f} ms (profiler kept {kept:g} of "
        f"the gn_moments launches); idle share {idle:.4f} of the median step; " + ", ".join(
            f"{g} {ms:.3f} ms ({100 * ms / max(busy, 1e-9):.1f}%)"
            for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
        + f"; the Dice loss forward+backward alone {loss_ms:.3f} ms (inside 'other')")
    for ms, count, name in sorted(rows, reverse=True)[:12]:
        log(f"training profile:   {ms:8.3f} ms  x{count:<4g} {name[:110]}")

    fixed = next(feed)
    plain_step = make_train_step(task)
    fixed_losses = [float(plain_step(state, fixed)[1]["train_loss"])
                    for _ in range(FIXED_BATCH_STEPS)]
    log(f"training: loss on one fixed batch over {FIXED_BATCH_STEPS} steps "
        f"{' '.join(f'{v:.4f}' for v in fixed_losses)}")
    if not (all(np.isfinite(fixed_losses)) and fixed_losses[-1] < fixed_losses[0]):
        raise AssertionError("training: the loss on a fixed batch did not fall")
    return counts, k2, dict(patches_per_s=TRAIN_BATCH / median * 1e3, step_ms=step_ms,
                            median_step_ms=median, peak_memory_bytes=peak,
                            device_ms_per_step=busy, idle_share=idle, profiler_kept=kept,
                            groups=groups, loss_ms=loss_ms, losses=losses,
                            fixed_batch_losses=fixed_losses)


@contextlib.contextmanager
def wrapped(owner, name, wrap):
    """Replace ``owner.name`` by ``wrap(original)`` for the block."""
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def write_organ_store(root: Path) -> None:
    """Six seeded subjects in ``root/organs.zarr``: four ellipsoid organs
    (classes 1-4, apart from one another) in noise, the image brighter by
    class; images fp32 with an affine, labels uint8; and the key files."""
    from tpu_mednet_torch.data import zarrlite

    rng = np.random.default_rng(2)
    z = zarrlite.open(str(root / "organs.zarr"), mode="w")
    centres = ((0.3, 0.3, 0.3), (0.7, 0.3, 0.6), (0.3, 0.7, 0.6), (0.7, 0.7, 0.3))
    for key, shape in ORGAN_SUBJECTS:
        lbl = np.zeros(shape, np.uint8)
        grid = np.ogrid[tuple(slice(0, s) for s in shape)]
        for c, frac in enumerate(centres, start=1):
            centre = np.asarray(frac) * shape + rng.uniform(-8, 8, size=3)
            radii = rng.uniform(14, 26, size=3)
            lbl[sum(((g - m) / r) ** 2 for g, m, r in zip(grid, centre, radii)) <= 1] = c
        img = (rng.normal(0.0, 0.5, size=shape) + 0.75 * lbl).astype(np.float32)
        arr = z.require_group("images").create_dataset(key, data=img[None], compressor=None)
        arr.attrs["affine"] = np.diag([0.8, 0.8, 1.5, 1.0])
        z.require_group("labels").create_dataset(key, data=lbl[None], compressor=None)
    for split, keys in ORGAN_SPLITS.items():
        (root / f"organs_{split}.txt").write_text("\n".join(keys) + "\n")


def organ_train_argv(root: Path, name: str, *extra):
    return ["-c", str(HERE / "configs" / "seg_organ.yaml"),
            "--data_path", str(root / "organs.zarr"),
            "--train_set", str(root / "organs_train.txt"),
            "--val_set", str(root / "organs_val.txt"),
            "--model_dir", str(root / name), "--log_dir", str(root / name / "logs"), *extra]


def organ_predict_argv(root: Path, stitch: str):
    return ["-c", str(HERE / "configs" / "predict.yaml"),
            f"base.data={root / 'organs.zarr'}",
            f"prediction.test_set={root / 'organs_test.txt'}",
            f"prediction.checkpoint={root / 'seg_organ' / 'best'}",
            f"prediction.data={root / f'prediction_{stitch}.zarr'}",
            f"prediction.stitch={stitch}"]


def read_metrics(path: Path):
    return [json.loads(line) for line in path.read_text().splitlines()]


class CliRecorder:
    """Runs the CLIs' ``main(argv)`` in this process, so the launch counters
    see them, and records by run tag: the wall seconds and the launch counts
    after each run, the device's idle share over the epochs in ``profiled``
    ({(tag, epoch)}), every checkpoint save and stitch call, and the
    training samplers for which ``capture(tag, sampler)`` holds; by wrapping
    the Trainer's, the samplers', the checkpoint manager's and the
    stitches' own functions inside ``wrappers()``."""

    def __init__(self, torch, gn, P, profiled, capture, label):
        self.torch, self.gn, self.P = torch, gn, P
        self.profiled, self.capture, self.label = profiled, capture, label
        self.tag = None
        self.profiles, self.saves, self.stitches = {}, [], []
        self.snapshots, self.walls, self.samplers = {}, {}, []
        self.batches = {}  # device-sampler batches by run

    def wrappers(self) -> contextlib.ExitStack:
        from tpu_mednet_torch.data import DevicePatchSampler
        from tpu_mednet_torch.inference import device_sliding, sliding_window, weighted
        from tpu_mednet_torch.train import CheckpointManager, Trainer

        rec, torch = self, self.torch

        def profiled_epoch(orig):
            def train_epoch(self, epoch):
                if (rec.tag, epoch) not in rec.profiled:
                    return orig(self, epoch)
                box = {}

                def go():
                    t = time.perf_counter()
                    box["out"] = orig(self, epoch)  # ends in a synchronize
                    box["wall"] = time.perf_counter() - t

                rows, kept = profile_kept(torch, rec.gn, go, 1)
                busy = sum(ms for ms, _, _ in rows) / 1e3
                rec.profiles[rec.tag] = dict(epoch=epoch, seconds=box["wall"],
                                             device_busy_s=busy, profiler_kept=kept,
                                             idle_share=idle_share(busy, box["wall"], kept))
                return box["out"]
            return train_epoch

        def captured(orig):
            def __init__(self, *args, **kw):
                orig(self, *args, **kw)
                if rec.capture(rec.tag, self):
                    rec.samplers.append(self)
            return __init__

        def timed_save(orig):
            def save(self, step, state, hparams=None):
                t = time.perf_counter()
                orig(self, step, state, hparams)
                seconds = time.perf_counter() - t
                files = (self.directory / str(int(step))).iterdir()
                rec.saves.append(dict(run=rec.tag, best=self.directory.name == "best",
                                      step=int(step), seconds=seconds,
                                      bytes=sum(f.stat().st_size for f in files)))
            return save

        def timed_stitch(orig):
            def stitch(task, data_path, keys, *args, **kw):
                t = time.perf_counter()
                out = orig(task, data_path, keys, *args, **kw)  # host masks: synchronous
                rec.stitches.append(dict(run=rec.tag, volumes=len(keys),
                                         seconds=time.perf_counter() - t))
                return out
            return stitch

        def counted_gather(orig):
            def gather(self, subj, corners):
                rec.batches[rec.tag] = rec.batches.get(rec.tag, 0) + 1
                return orig(self, subj, corners)
            return gather

        stack = contextlib.ExitStack()
        stack.enter_context(wrapped(Trainer, "train_epoch", profiled_epoch))
        stack.enter_context(wrapped(DevicePatchSampler, "__init__", captured))
        stack.enter_context(wrapped(DevicePatchSampler, "gather", counted_gather))
        stack.enter_context(wrapped(CheckpointManager, "save", timed_save))
        stack.enter_context(wrapped(sliding_window, "predict_volumes", timed_stitch))
        stack.enter_context(wrapped(device_sliding, "predict_volumes_on_device",
                                    timed_stitch))
        stack.enter_context(wrapped(weighted, "predict_volumes_weighted_on_device",
                                    timed_stitch))
        return stack

    def cli(self, tag, main, argv):
        self.tag = tag
        t = time.perf_counter()
        rc = main(argv)
        self.torch.cuda.synchronize()
        self.walls[tag] = time.perf_counter() - t
        self.snapshots[tag] = launch_counts(self.gn, self.P)
        log(f"{self.label}: {tag}: exit code {rc} in {self.walls[tag]:.2f} s")
        if rc != 0:
            raise AssertionError(f"{self.label}: {tag} exited with {rc}")

    def per_run(self, counts):
        """Launches by run: each snapshot less the one before, from 0."""
        out, prev = {}, dict.fromkeys(counts, 0)
        for tag, snap in self.snapshots.items():
            out[tag] = {k: snap[k] - prev[k] for k in snap}
            prev = snap
        return out

    def vpm(self, prefix):
        """Volumes/min of each stitch call of the runs whose tag starts with
        ``prefix``: median, min, max and the calls."""
        calls = [s["volumes"] / s["seconds"] * 60 for s in self.stitches
                 if s["run"].startswith(prefix)]
        return dict(median=float(np.median(calls)), min=min(calls), max=max(calls),
                    calls=calls)


def run_entry_points(torch, gn, P, grid_corners, dev):
    """The entry points as a user runs them, in this process so the launch
    counters see them: ``train_seg -c configs/seg_organ.yaml`` for 2 epochs
    with the host sampler, ``--resume`` to 3, 3 epochs with
    ``--device_sampler``, 1 epoch with the device sampler and the optimizer
    options; then ``predict -c configs/predict.yaml`` on ``best/`` with the
    ``crop`` and ``device`` stitches, ``PREDICT_TURNS`` calls of each in
    turns.  Patches/s per epoch are the Trainer's own (``metrics.jsonl``);
    the epochs in ``PROFILED_EPOCHS`` are profiled for the device's idle
    share, and checkpoint saves and stitches are timed (``CliRecorder``).
    After the runs, indexed K2 is held against its plain version on the
    device-sampler run's own training sampler (128^3 windows, batch 4)."""
    import tempfile
    from types import SimpleNamespace

    from tpu_mednet_torch.cli import predict, train_seg
    from tpu_mednet_torch.data import ZarrReader
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.train import CheckpointManager, load_for_inference

    rec = CliRecorder(torch, gn, P, PROFILED_EPOCHS, lambda tag, sampler: (
        tag == "device_sampler" and list(sampler.subject_keys) == ORGAN_SPLITS["train"]),
        "entry points")
    cli, profiles, saves, walls, samplers = (rec.cli, rec.profiles, rec.saves, rec.walls,
                                             rec.samplers)

    spe = ORGAN_STEPS_PER_EPOCH
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_organ_store(root)
        log(f"entry points: seeded zarr store of {len(ORGAN_SUBJECTS)} subjects "
            f"({', '.join(f'{k} {s}' for k, s in ORGAN_SUBJECTS)}) in "
            f"{time.perf_counter() - t0:.1f} s")
        organ = root / "seg_organ"
        with rec.wrappers():
            torch.cuda.empty_cache()
            base_memory = torch.cuda.memory_allocated(dev)
            reset_counts(gn, P)
            torch.cuda.reset_peak_memory_stats(dev)
            cli("train", train_seg.main, organ_train_argv(root, "seg_organ", "--max_epochs", "2"))
            peak_host = torch.cuda.max_memory_allocated(dev)
            steps_after_train = CheckpointManager(organ).available_steps
            cli("resume", train_seg.main, organ_train_argv(
                root, "seg_organ", "--max_epochs", "3", "--resume", str(organ)))
            torch.cuda.reset_peak_memory_stats(dev)
            cli("device_sampler", train_seg.main, organ_train_argv(
                root, "seg_organ_device", "--max_epochs", "3", "--device_sampler"))
            peak_device = torch.cuda.max_memory_allocated(dev)
            cli("options", train_seg.main, organ_train_argv(
                root, "seg_organ_options", "--max_epochs", "1", *ORGAN_OPTIONS))
            predict_tags = []
            for turn in range(1, PREDICT_TURNS + 1):
                for stitch in ("crop", "device"):
                    predict_tags.append(f"predict_{stitch}_{turn}")
                    cli(predict_tags[-1], predict.main, organ_predict_argv(root, stitch))
            counts = launch_counts(gn, P)

        # launches: every kernel of the path ran, K1's backward once per step
        # of the four training runs, K2 indexed only under the device sampler
        # and plain only in the device stitch
        per_run = rec.per_run(counts)
        train_steps = spe * (2 + 1 + 3 + 1)
        gather = {tag: c["gather_patches"] for tag, c in per_run.items()}
        indexed = gather["device_sampler"] + gather["options"]
        plain = sum(gather[t] for t in predict_tags if "device" in t)
        log(f"entry points: launches {counts}; by run {per_run}")
        if (counts["gn_bwd_reduce"] != 27 * train_steps
                or counts["gn_bwd_apply"] != 27 * train_steps):
            raise AssertionError(f"entry points: K1 backward launches {counts}, expected "
                                 f"27 x {train_steps} training steps")
        if counts["gn_moments"] != counts["gn_apply"] or not counts["gn_moments"]:
            raise AssertionError(f"entry points: K1 forward launches {counts}")
        if not indexed or not plain or indexed + plain != counts["gather_patches"]:
            raise AssertionError(f"entry points: K2 launches {gather}")
        # one indexed launch per device-sampler batch (images and labels
        # together), none under the host sampler
        if any(gather[t] != rec.batches.get(t, 0) for t in per_run if t not in predict_tags):
            raise AssertionError(f"entry points: indexed K2 launches {gather}, device-sampler "
                                 f"batches {rec.batches}")
        if any(per_run[t]["gn_moments"] == 0 for t in predict_tags):
            raise AssertionError(f"entry points: a predict run launched no K1: {per_run}")

        # indexed K2 at the path's own shapes: the device-sampler run's
        # training sampler (after the counted runs, so these launches are not
        # counted)
        if len(samplers) != 1 or tuple(int(p) for p in samplers[0].patch_size) != ORGAN_PATCH:
            raise AssertionError("entry points: the device-sampler run built no training "
                                 f"sampler at {ORGAN_PATCH}")
        k2_128 = check_gather_indexed(torch, P, samplers.pop(), ORGAN_BATCH)

        # checkpoints and metrics
        steps_final = CheckpointManager(organ).available_steps
        best = CheckpointManager(organ / "best").available_steps
        log(f"entry points: checkpoints after 2 epochs {steps_after_train}, after the "
            f"resume {steps_final}; best/ {best}")
        if (steps_after_train != [spe, 2 * spe] or steps_final != [spe, 2 * spe, 3 * spe]
                or len(best) != 1 or best[0] not in steps_final):
            raise AssertionError("entry points: wrong checkpoint steps")
        records = read_metrics(organ / "logs" / "metrics.jsonl")
        names = set().union(*(r.keys() for r in records)) - {"step", "time"}
        want = {"train_loss", "lr", "patches_per_sec", "val_loss",
                *(f"val_dice{c}" for c in range(ORGAN_CLASSES))}
        losses = [r["train_loss"] for r in records if "train_loss" in r]
        val = [(r["step"], r["val_loss"]) for r in records if "val_loss" in r]
        log(f"entry points: metrics.jsonl scalars {sorted(names)}; train_loss {losses}; "
            f"val_loss by step {val}")
        if not want <= names or not all(np.isfinite(losses + [v for _, v in val])):
            raise AssertionError("entry points: missing or non-finite scalars")
        options = read_metrics(root / "seg_organ_options" / "logs" / "metrics.jsonl")[0]
        log(f"entry points: first scalars of the options run {options}")
        if not (options["lr"] == 0.0 and options["nonfinite"] == 0.0
                and 0 < options["grad_norm"] < np.inf):
            raise AssertionError("entry points: the options run's first step is wrong")
        if CheckpointManager(root / "seg_organ_options").restore_weights()["ema"] is None:
            raise AssertionError("entry points: the options run saved no EMA weights")
        # patches/s by epoch as the Trainer logs them
        pps = {name: [r["patches_per_sec"] for r in read_metrics(
                   root / name / "logs" / "metrics.jsonl") if "patches_per_sec" in r]
               for name in ("seg_organ", "seg_organ_device", "seg_organ_options")}
        if [len(v) for v in pps.values()] != [3, 3, 1]:
            raise AssertionError(f"entry points: patches_per_sec by epoch {pps}")

        # predictions: both stitches' masks agree outside the tie band of
        # the plain path's top-2 logit margin (over the device tiles)
        weights, hp = load_for_inference(organ / "best")
        task = SegmentationTask.from_hparams(
            SimpleNamespace(**{k: predict._coerce(v) for k, v in hp.items()}), device=dev)
        task.model.load_state_dict(weights)
        test = ORGAN_SPLITS["test"]
        masks = {}
        for stitch in ("crop", "device"):
            with ZarrReader(root / f"prediction_{stitch}.zarr") as r:
                masks[stitch] = dict(zip(test, r.read(test, "prediction", np.uint8)))
        with ZarrReader(root / "organs.zarr") as r:
            vols = dict(zip(test, r.read(test, "images", np.float16)))
            labels = dict(zip(test, r.read(test, "labels", np.uint8)))
        shapes, agreement, dice = dict(ORGAN_SUBJECTS), {}, {}
        for key in test:
            a, b = masks["crop"][key], masks["device"][key]
            for m in (a, b):
                if m.shape != (1, *shapes[key]) or m.dtype != np.uint8 or m.max() >= ORGAN_CLASSES:
                    raise AssertionError(f"entry points: bad mask {key} {m.shape} {m.dtype}")
            with torch.inference_mode():
                margin, err = tie_band_margin(torch, gn, P, task.model, vols[key],
                                              grid_corners, dev)
            flips = a[0] != b[0]
            outside = int((flips & (margin > 2 * err)).sum())
            agreement[key] = float(1 - flips.mean())
            dice[key] = [float(2 * ((a[0] == c) & (labels[key][0] == c)).sum()
                               / max(1, (a[0] == c).sum() + (labels[key][0] == c).sum()))
                         for c in range(1, ORGAN_CLASSES)]
            log(f"entry points: {key} {shapes[key]}: crop and device masks differ on "
                f"{flips.mean():.6f} of voxels, outside the tie band on {outside} (max "
                f"|kernel - plain| logit {err:.3g}); crop mask Dice against the label by "
                f"class {' '.join(f'{d:.3f}' for d in dice[key])}")
            if outside:
                raise AssertionError(f"entry points: {key}: the stitches disagree outside "
                                     "the tie band")
        del task, weights

    for name, values in pps.items():
        log(f"entry points: {name} patches/s by epoch (the Trainer's metrics.jsonl): "
            + " ".join(f"{v:.2f}" for v in values))
    for tag, p in profiles.items():
        log(f"entry points: profiled epoch {tag}/{p['epoch']}: {p['seconds']:.3f} s, device "
            f"busy {p['device_busy_s']:.3f} s (profiler kept {p['profiler_kept']:g} of the "
            f"gn_moments launches), idle share {p['idle_share']:.4f}")
    for s in saves:
        log(f"entry points: save {s['run']} {'best ' if s['best'] else ''}step {s['step']}: "
            f"{s['bytes'] / 1e9:.3f} GB in {s['seconds']:.3f} s")
    for s in rec.stitches:
        log(f"entry points: {s['run']}: {s['volumes']} volumes stitched in "
            f"{s['seconds']:.3f} s = {s['volumes'] / s['seconds'] * 60:.2f} volumes/min; "
            f"the whole CLI call {walls[s['run']]:.3f} s")
    vpm = {st: rec.vpm(f"predict_{st}_") for st in ("crop", "device")}
    main_saves = [s["seconds"] for s in saves if s["run"] == "train" and not s["best"]]
    summary = dict(
        host_sampler_patches_per_s=pps["seg_organ"][1],
        host_sampler_idle_share=profiles["resume"]["idle_share"],
        device_sampler_patches_per_s=pps["seg_organ_device"][1],
        device_sampler_idle_share=profiles["device_sampler"]["idle_share"],
        peak_memory_bytes=dict(host_sampler=peak_host, device_sampler=peak_device,
                               allocated_before=base_memory),
        save_seconds=float(np.median(main_saves)), save_bytes=saves[0]["bytes"],
        predict_volumes_per_min=vpm)
    log(f"entry points: seg_organ training {summary['host_sampler_patches_per_s']:.2f} "
        f"patches/s with the host sampler (idle share {summary['host_sampler_idle_share']:.4f}),"
        f" {summary['device_sampler_patches_per_s']:.2f} with the device sampler (idle share "
        f"{summary['device_sampler_idle_share']:.4f}); peak memory {peak_host / 2**30:.2f} / "
        f"{peak_device / 2**30:.2f} GiB ({base_memory / 2**30:.2f} GiB held before); one "
        f"checkpoint save {summary['save_seconds']:.3f} s for {summary['save_bytes'] / 1e9:.3f}"
        f" GB; predict volumes/min over {PREDICT_TURNS} calls of {len(ORGAN_SPLITS['test'])} "
        f"volumes: " + ", ".join(
            f"{st} median {v['median']:.2f} (min {v['min']:.2f}, max {v['max']:.2f})"
            for st, v in vpm.items()))
    return counts, dict(per_run=per_run, indexed=indexed, plain=plain, check_128=k2_128), dict(
        summary=summary, patches_per_s_by_epoch=pps, profiled_epochs=profiles, saves=saves,
        stitches=rec.stitches, cli_seconds=walls, agreement=agreement, dice=dice,
        gather_indexed_128=k2_128["per_store"])


def guard_cost(torch, dev):
    """The non-finite guard's host read, per seg_organ train step: steps on
    one fixed batch with the guard off and on, in turns off, on, on, off."""
    from types import SimpleNamespace

    from tpu_mednet_torch.ops.augment import AugmentConfig
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.train import create_train_state, make_train_step

    hp = SimpleNamespace(in_channels=1, out_channels=ORGAN_CLASSES, fmaps=32, bf16=True,
                         loss="DICE", loss_weight=None)
    task = SegmentationTask.from_hparams(hp, device=dev,
                                         generator=torch.Generator().manual_seed(0))
    state = create_train_state(task.model, learning_rate=1e-3, seed=0)
    gen = torch.Generator(device=dev).manual_seed(3)
    shape = (ORGAN_BATCH, 128, 128, 128, 1)
    label = torch.randint(0, ORGAN_CLASSES, shape, generator=gen, device=dev,
                          dtype=torch.uint8)
    data = torch.randn(shape, generator=gen, device=dev) + label
    batch = {"data": data.permute(0, 4, 1, 2, 3), "label": label.permute(0, 4, 1, 2, 3)}
    steps = {g: make_train_step(task, augment=AugmentConfig(mirror_axes=(1, 2, 3)),
                                guard_nonfinite=g) for g in (False, True)}
    for g in (False, True):
        steps[g](state, batch)
    times = {False: [], True: []}
    for g in (False, True, True, False):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(GUARD_STEPS):
            steps[g](state, batch)
        torch.cuda.synchronize()
        times[g].append((time.perf_counter() - t) / GUARD_STEPS * 1e3)
    off, on = float(np.mean(times[False])), float(np.mean(times[True]))
    log(f"non-finite guard: seg_organ train step {off:.3f} ms off "
        f"({' '.join(f'{t:.3f}' for t in times[False])}), {on:.3f} ms on "
        f"({' '.join(f'{t:.3f}' for t in times[True])}): {on - off:.3f} ms per step")
    return dict(off_ms=times[False], on_ms=times[True], cost_ms=on - off)


def check_landmark_parity(torch, gn, P, dev, gen):
    """The landmark model at configs/landmarks.yaml width (f_maps 64, 3
    heatmaps + 2 classes, 141,246,661 parameters), kernel path against
    plain path at batch 4 of 96^3: the forward's heatmap channels and class
    logits in fp32 (TF32 off) and bf16, under the forward's limits, class
    flips only inside the tie band; one bf16 train step through
    ``LandmarkTask.loss_fn``: every parameter's gradient non-zero, and
    per parameter max |dg| / max |g| and the loss's relative difference
    within the bf16 train-step bound; then ``FIXED_BATCH_STEPS`` train steps
    on that batch at each lr of ``FIXED_BATCH_LRS`` on both paths, whose
    losses must agree step by step within that bound and fall at the lowest
    lr."""
    from types import SimpleNamespace

    from tpu_mednet_torch.ops.heatmap import batched_gaussian_heatmaps
    from tpu_mednet_torch.tasks import LandmarkTask
    from tpu_mednet_torch.train import create_train_state, make_train_step

    torch.backends.cudnn.allow_tf32 = False  # the fp32 forward limit holds without TF32
    torch.backends.cuda.matmul.allow_tf32 = False

    hp = SimpleNamespace(in_channels=1, out_channels=LDMK_HEATMAPS + 2, fmaps=64, bf16=False,
                         loss_regression_weight=[0.015] * LDMK_HEATMAPS, loss_class="DICE",
                         loss_class_weight=[0.05, 1.0], loss_regression="L2")
    tasks = {"fp32": LandmarkTask.from_hparams(hp, device=dev,
                                               generator=torch.Generator().manual_seed(0))}
    n_params = sum(p.numel() for p in tasks["fp32"].model.parameters())
    log(f"landmarks: ResidualUNet3D(1, 5, f_maps=64) parameters: {n_params}")
    if n_params != LDMK_PARAMS:
        raise AssertionError(f"expected {LDMK_PARAMS} parameters")
    hp.bf16 = True
    tasks["bf16"] = LandmarkTask.from_hparams(hp, device=dev)
    tasks["bf16"].model.load_state_dict(tasks["fp32"].model.state_dict())

    coords = torch.rand((LDMK_BATCH, LDMK_HEATMAPS, 3), generator=gen, device=dev) * 80 + 8
    hm = batched_gaussian_heatmaps(coords, PATCH, LDMK_SIGMA).to(torch.uint8)
    cls = torch.zeros((LDMK_BATCH, 1, *PATCH), dtype=torch.uint8, device=dev)
    cls[:, :, 20:70, 30:80, 10:60] = 1
    x = torch.randn((LDMK_BATCH, 1, *PATCH), generator=gen, device=dev)
    x = x + cls + hm.amax(dim=1, keepdim=True) / 255.0
    batch = {"data": x, "label": torch.cat([hm, cls], dim=1)}
    out = {}
    h = LDMK_HEATMAPS
    with torch.inference_mode():
        for dt, task in tasks.items():
            y = task.model(x).float()
            with plain_kernels(gn, P):
                y_p = task.model(x).float()
            errs = {}
            for part, sl in (("heatmaps", slice(0, h)), ("class logits", slice(h, None))):
                err = float((y[:, sl] - y_p[:, sl]).abs().max())
                scale = float(y_p[:, sl].abs().max())
                bound = FWD_FP32_ATOL if dt == "fp32" else FWD_BF16_REL * scale
                errs[part] = dict(err=err, max_abs=scale, bound=bound)
                if not (torch.isfinite(y[:, sl]).all() and err <= bound):
                    raise AssertionError(f"landmarks forward {dt} {part}: max|kernel - plain| "
                                         f"{err} above {bound}")
            err_c = errs["class logits"]["err"]
            margin = (y_p[:, h] - y_p[:, h + 1]).abs()
            flips = y[:, h:].argmax(dim=1) != y_p[:, h:].argmax(dim=1)
            if bool((flips & (margin > 2 * err_c)).any()):
                raise AssertionError(f"landmarks forward {dt}: a class flipped outside the "
                                     "tie band")
            out[f"forward_{dt}"] = dict(errs, class_flips=float(flips.float().mean()))
            log(f"landmarks forward {dt} {tuple(y.shape)}: " + "; ".join(
                f"{k} max|kernel - plain| {v['err']:.3g} (bound {v['bound']:.3g}, max|plain| "
                f"{v['max_abs']:.3g})" for k, v in errs.items())
                + f"; class flips {float(flips.float().mean()):.6f}, all within the tie band")
            del y, y_p
    del tasks["fp32"]
    torch.cuda.empty_cache()

    task = tasks["bf16"]
    model = task.model

    def grads():
        model.zero_grad(set_to_none=True)
        loss, aux = task.loss_fn(model(x), batch)
        loss.backward()
        return float(loss.detach()), {k: p.grad for k, p in model.named_parameters()}

    torch.cuda.reset_peak_memory_stats(dev)
    loss, g = grads()
    peak = torch.cuda.max_memory_allocated(dev)
    with plain_kernels(gn, P):
        loss_p, g_p = grads()
    zero = [k for k, v in g.items() if v is None or not bool(v.abs().max() > 0)]
    if zero:
        raise AssertionError(f"landmarks train parity: no gradient on the kernel path for {zero}")
    rel = {k: float((g[k] - g_p[k]).abs().max()) / float(g_p[k].abs().max()) for k in g}
    worst = max(rel, key=rel.get)
    loss_rel = abs(loss - loss_p) / abs(loss_p)
    out["train_bf16"] = dict(loss=loss, loss_plain=loss_p, loss_rel=loss_rel,
                             worst_param=worst, worst_rel=rel[worst], params=len(rel),
                             peak_memory_bytes=peak)
    log(f"landmarks train parity bf16 batch {LDMK_BATCH}: loss kernel {loss:.6f} plain "
        f"{loss_p:.6f} (relative {loss_rel:.3g}); every one of {len(rel)} parameters has a "
        f"non-zero gradient; max over parameters of max|dg|/max|g| {rel[worst]:.3g} "
        f"({worst}; bound {PARITY_REL['bf16']}); kernel-path step peak memory "
        f"{peak / 2**30:.2f} GiB")
    if loss_rel > PARITY_REL["bf16"] or rel[worst] > PARITY_REL["bf16"]:
        raise AssertionError("landmarks train parity: kernel path disagrees with plain path")
    model.zero_grad(set_to_none=True)
    del g, g_p

    # FIXED_BATCH_STEPS train steps on this batch at each lr of
    # FIXED_BATCH_LRS, on the kernel path and on the plain path from the same
    # weights and a fresh Adam: the kernel path's loss stays within the bf16
    # train-step bound of the plain path's at every step (a fault in K1's
    # backward that builds up over Adam steps would part them), and at the
    # lowest lr both fall (a CLI run logs one batch's loss an epoch, and
    # whether a patch holds a landmark moves it more than ten steps do)
    init = {k: v.detach().clone() for k, v in model.state_dict().items()}
    step = make_train_step(task)
    curves = {}
    for lr in FIXED_BATCH_LRS:
        for path in ("kernel", "plain"):
            model.load_state_dict(init)
            state = create_train_state(model, learning_rate=lr, seed=0)
            with plain_kernels(gn, P) if path == "plain" else contextlib.nullcontext():
                curves[(lr, path)] = [float(step(state, batch)[1]["train_loss"])
                                      for _ in range(FIXED_BATCH_STEPS)]
            log(f"landmarks: loss on one fixed batch over {FIXED_BATCH_STEPS} train steps, "
                f"{path} path, lr {lr:g}: {' '.join(f'{v:.4f}' for v in curves[(lr, path)])}")
        got, ref = curves[(lr, "kernel")], curves[(lr, "plain")]
        rel = max(abs(u - v) / abs(v) for u, v in zip(got, ref))
        log(f"landmarks: lr {lr:g}, max over steps of |kernel - plain| / |plain| {rel:.3g} "
            f"(bound {PARITY_REL['bf16']})")
        if not (all(np.isfinite(got)) and rel <= PARITY_REL["bf16"]):
            raise AssertionError(f"landmarks: at lr {lr:g} the kernel path's fixed-batch "
                                 "losses part from the plain path's")
    del init, state
    lo = min(FIXED_BATCH_LRS)
    if not all(curves[(lo, p)][-1] < curves[(lo, p)][0] for p in ("kernel", "plain")):
        raise AssertionError(f"landmarks: the loss on a fixed batch did not fall at lr {lo:g}")
    out["fixed_batch_losses"] = {f"{path}_lr{lr:g}": v for (lr, path), v in curves.items()}
    return out


def write_landmark_store(root: Path) -> None:
    """Six seeded subjects in ``root/landmarks.zarr``: a class-1 ellipsoid in
    noise, three fractional landmarks per subject (``landmarks``, (3, 3)
    fp32), their Gaussians at sigma 4 (``gaussian_heatmap`` on the host) as
    a uint8 ``heatmaps`` group (0..255), the image brighter inside the ellipsoid and at the landmarks;
    images fp32 with an affine; and the key files."""
    import torch

    from tpu_mednet_torch.data import zarrlite
    from tpu_mednet_torch.ops.heatmap import gaussian_heatmap

    rng = np.random.default_rng(3)
    z = zarrlite.open(str(root / "landmarks.zarr"), mode="w")
    for key, shape in LDMK_SUBJECTS:
        grid = np.ogrid[tuple(slice(0, s) for s in shape)]
        centre = np.asarray(shape) / 2 + rng.uniform(-10, 10, size=3)
        radii = rng.uniform(20, 32, size=3)
        lbl = (sum(((g - m) / r) ** 2 for g, m, r in zip(grid, centre, radii)) <= 1)
        coords = (rng.uniform(0.15, 0.85, size=(LDMK_HEATMAPS, 3)) * shape).astype(np.float32)
        hm = gaussian_heatmap(torch.from_numpy(coords), shape, LDMK_SIGMA).to(torch.uint8).numpy()
        img = rng.normal(0.0, 0.5, size=shape) + 0.75 * lbl + 1.5 * hm.max(axis=0) / 255.0
        arr = z.require_group("images").create_dataset(
            key, data=img[None].astype(np.float32), compressor=None)
        arr.attrs["affine"] = np.diag([0.8, 0.8, 1.5, 1.0])
        z.require_group("labels").create_dataset(key, data=lbl[None].astype(np.uint8),
                                                 compressor=None)
        z.require_group("heatmaps").create_dataset(key, data=hm, compressor=None)
        z.require_group("landmarks").create_dataset(key, data=coords, compressor=None)
    for split, keys in LDMK_SPLITS.items():
        (root / f"ldmk_{split}.txt").write_text("\n".join(keys) + "\n")


def ldmk_train_argv(root: Path, name: str, epochs: int, *extra):
    if "--resume" in extra:
        extra = (*extra, str(root / name))
    return ["-c", str(HERE / "configs" / "landmarks.yaml"),
            "--data_path", str(root / "landmarks.zarr"),
            "--train_set", str(root / "ldmk_train.txt"), "--val_set", str(root / "ldmk_val.txt"),
            "--model_dir", str(root / name), "--log_dir", str(root / name / "logs"),
            "--max_epochs", str(epochs), *extra]


def ldmk_predict_argv(root: Path, stitch: str):
    return ["-c", str(HERE / "configs" / "predict.yaml"),
            f"base.data={root / 'landmarks.zarr'}",
            f"base.sigma={[LDMK_SIGMA] * LDMK_HEATMAPS}",
            f"prediction.test_set={root / 'ldmk_test.txt'}",
            f"prediction.checkpoint={root / 'ldmk' / 'best'}",
            f"prediction.data={root / f'ldmk_prediction_{stitch}.zarr'}",
            f"prediction.landmarks={root / f'ldmk_landmarks_{stitch}.json'}",
            "prediction.model=LandmarkNet", f"prediction.stitch={stitch}"]


def run_landmarks(torch, gn, P, grid_corners, dev):
    """The landmark workload as a user runs it, launches counted from 0:
    ``train_ldmks -c configs/landmarks.yaml`` (``LDMK_RUNS``: the host
    sampler on the stored heatmaps for 2 epochs, ``--resume`` to 3; 2 epochs
    with ``--device_sampler``; 2 with ``--device_sampler --landmark_group``),
    then LandmarkNet ``predict`` on ``best/`` with both stitches in turns,
    writing ``prediction.landmarks`` as JSON.  Checks: finite losses, a
    later epoch's logged loss below the first (each is one batch's; a fixed
    batch's descent is held in ``check_landmark_parity``), the metric
    names, checkpoint steps and ``best/``; heatmap
    channels of the two stitches within 1 of each other and class maps
    apart only inside the tie band; 3 landmarks per subject inside the
    volume; then indexed K2 byte-equal to plain on the device-sampler run's
    own 4-channel label store."""
    import tempfile
    from types import SimpleNamespace

    from tpu_mednet_torch.cli import predict, train_ldmks
    from tpu_mednet_torch.data import ZarrReader
    from tpu_mednet_torch.inference.serving import detect_task_name
    from tpu_mednet_torch.tasks import LandmarkTask
    from tpu_mednet_torch.train import CheckpointManager, load_for_inference

    rec = CliRecorder(torch, gn, P, LDMK_PROFILED, lambda tag, sampler: (
        tag == "ldmk_device" and list(sampler.subject_keys) == LDMK_SPLITS["train"]),
        "landmarks")
    spe = LDMK_STEPS_PER_EPOCH
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ldmk_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_landmark_store(root)
        log(f"landmarks: seeded zarr store of {len(LDMK_SUBJECTS)} subjects "
            f"({', '.join(f'{k} {s}' for k, s in LDMK_SUBJECTS)}) in "
            f"{time.perf_counter() - t0:.1f} s")
        peaks, predict_tags = {}, []
        with rec.wrappers():
            torch.cuda.empty_cache()
            base_memory = torch.cuda.memory_allocated(dev)
            reset_counts(gn, P)
            for tag, name, epochs, extra in LDMK_RUNS:
                torch.cuda.reset_peak_memory_stats(dev)
                rec.cli(tag, train_ldmks.main, ldmk_train_argv(root, name, epochs, *extra))
                peaks[tag] = torch.cuda.max_memory_allocated(dev)
                if tag == "ldmk_train":
                    steps_after_train = CheckpointManager(root / name).available_steps
            for turn in range(1, LDMK_PREDICT_TURNS + 1):
                for stitch in ("crop", "device"):
                    predict_tags.append(f"ldmk_predict_{stitch}_{turn}")
                    rec.cli(predict_tags[-1], predict.main, ldmk_predict_argv(root, stitch))
            counts = launch_counts(gn, P)

        # launches: K1's backward once per step of the four runs, K2 indexed
        # only under the device sampler and plain only in the device stitch
        per_run = rec.per_run(counts)
        train_steps = spe * sum(e - (2 if "--resume" in x else 0) for _, _, e, x in LDMK_RUNS)
        gather = {tag: c["gather_patches"] for tag, c in per_run.items()}
        indexed = gather["ldmk_device"] + gather["ldmk_landmarks"]
        plain = sum(gather[t] for t in predict_tags if "device" in t)
        log(f"landmarks: launches {counts}; by run {per_run}")
        if (counts["gn_bwd_reduce"] != 27 * train_steps
                or counts["gn_bwd_apply"] != 27 * train_steps):
            raise AssertionError(f"landmarks: K1 backward launches {counts}, expected 27 x "
                                 f"{train_steps} training steps")
        if counts["gn_moments"] != counts["gn_apply"] or not counts["gn_moments"]:
            raise AssertionError(f"landmarks: K1 forward launches {counts}")
        if not indexed or not plain or indexed + plain != counts["gather_patches"]:
            raise AssertionError(f"landmarks: K2 launches {gather}")
        if any(gather[t] != rec.batches.get(t, 0) for t in per_run if t not in predict_tags):
            raise AssertionError(f"landmarks: indexed K2 launches {gather}, device-sampler "
                                 f"batches {rec.batches}")
        if any(per_run[t]["gn_moments"] == 0 for t in predict_tags):
            raise AssertionError(f"landmarks: a predict run launched no K1: {per_run}")

        # indexed K2 on the device-sampler run's 4-channel uint8 label store
        # (after the counted runs: not counted)
        if len(rec.samplers) != 1 or rec.samplers[0].labels.shape[-1] != LDMK_HEATMAPS + 1:
            raise AssertionError("landmarks: the device-sampler run built no training "
                                 "sampler with a 4-channel label store")
        k2 = check_gather_indexed(torch, P, rec.samplers.pop(), LDMK_BATCH)

        # checkpoints, metrics, falling losses
        ldmk = root / "ldmk"
        steps_final = CheckpointManager(ldmk).available_steps
        best = CheckpointManager(ldmk / "best")
        log(f"landmarks: checkpoints after 2 epochs {steps_after_train}, after the resume "
            f"{steps_final}; best/ {best.available_steps}")
        if (steps_after_train != [spe, 2 * spe] or steps_final != [spe, 2 * spe, 3 * spe]
                or len(best.available_steps) != 1
                or best.available_steps[0] not in steps_final):
            raise AssertionError("landmarks: wrong checkpoint steps")
        if detect_task_name(best.restore_hparams()) != "LandmarkNet":
            raise AssertionError("landmarks: best/ hparams do not say LandmarkNet")
        pps, losses = {}, {}
        for name in dict.fromkeys(name for _, name, _, _ in LDMK_RUNS):
            records = read_metrics(root / name / "logs" / "metrics.jsonl")
            names = set().union(*(r.keys() for r in records)) - {"step", "time"}
            losses[name] = [r["train_loss"] for r in records if "train_loss" in r]
            val = [(r["step"], r["val_loss"], r["val_landmark_error"]) for r in records
                   if "val_loss" in r]
            pps[name] = [r["patches_per_sec"] for r in records if "patches_per_sec" in r]
            log(f"landmarks: {name} metrics.jsonl scalars {sorted(names)}; train_loss "
                f"{losses[name]}; (step, val_loss, val_landmark_error) {val}")
            if not LDMK_METRICS <= names:
                raise AssertionError(f"landmarks: {name} lacks {LDMK_METRICS - names}")
            if not all(np.isfinite(losses[name] + [v for _, v, _ in val])):
                raise AssertionError(f"landmarks: {name}: non-finite losses")
            # the first logged loss is the initial model's, whose heatmap
            # outputs are far from the mostly-zero targets
            if not min(losses[name][1:]) < losses[name][0]:
                raise AssertionError(f"landmarks: {name}: the training loss did not fall")
        if [len(v) for v in pps.values()] != [3, 2, 2]:
            raise AssertionError(f"landmarks: patches_per_sec by epoch {pps}")

        # predictions: heatmaps within 1, class maps inside the tie band of
        # the plain path's class-logit margin, 3 landmarks per subject
        weights, hp = load_for_inference(ldmk / "best")
        task = LandmarkTask.from_hparams(
            SimpleNamespace(**{k: predict._coerce(v) for k, v in hp.items()}), device=dev)
        task.model.load_state_dict(weights)
        test, shapes = LDMK_SPLITS["test"], dict(LDMK_SUBJECTS)
        preds, readouts = {}, {}
        for stitch in ("crop", "device"):
            with ZarrReader(root / f"ldmk_prediction_{stitch}.zarr") as r:
                preds[stitch] = dict(zip(test, r.read(test, "prediction", np.uint8)))
            readouts[stitch] = json.loads((root / f"ldmk_landmarks_{stitch}.json").read_text())
        with ZarrReader(root / "landmarks.zarr") as r:
            vols = dict(zip(test, r.read(test, "images", np.float16)))
            truth = dict(zip(test, r.read(test, "landmarks", np.float32)))
        agreement, errors = {}, {}
        for key in test:
            a, b = preds["crop"][key], preds["device"][key]
            for m in (a, b):
                if m.shape != (LDMK_HEATMAPS + 1, *shapes[key]) or m[-1].max() > 1:
                    raise AssertionError(f"landmarks: bad prediction {key} {m.shape}")
            hm_diff = int(np.abs(a[:-1].astype(np.int16) - b[:-1].astype(np.int16)).max())
            with torch.inference_mode():
                margin, err = tie_band_margin(torch, gn, P, task.model, vols[key], grid_corners,
                                              dev, classes=slice(LDMK_HEATMAPS, None))
            flips = a[-1] != b[-1]
            outside = int((flips & (margin > 2 * err)).sum())
            agreement[key] = dict(heatmap_max_diff=hm_diff, class_flips=float(flips.mean()),
                                  heatmap_equal=float((a[:-1] == b[:-1]).mean()))
            for stitch, lms in readouts.items():
                if len(lms[key]) != LDMK_HEATMAPS or not all(
                        0 <= v < s for lm in lms[key] for v, s in zip(lm["voxel"], shapes[key])):
                    raise AssertionError(f"landmarks: {stitch} readout of {key}: {lms[key]}")
            errors[key] = [float(np.linalg.norm(np.asarray(lm["voxel"]) - t))
                           for lm, t in zip(readouts["device"][key], truth[key])]
            log(f"landmarks: {key} {shapes[key]}: crop vs device heatmaps max |diff| {hm_diff} "
                f"(equal on {agreement[key]['heatmap_equal']:.6f}); class maps differ on "
                f"{flips.mean():.6f}, outside the tie band on {outside} (max|kernel - plain| "
                f"class logit {err:.3g}); readout peaks "
                f"{[lm['peak'] for lm in readouts['device'][key]]}, distance to the true "
                f"landmarks {' '.join(f'{e:.1f}' for e in errors[key])} voxels")
            if hm_diff > 1 or outside:
                raise AssertionError(f"landmarks: {key}: the stitches disagree")
        del task, weights

    for tag, p in rec.profiles.items():
        log(f"landmarks: profiled epoch {tag}/{p['epoch']}: {p['seconds']:.3f} s, device busy "
            f"{p['device_busy_s']:.3f} s (profiler kept {p['profiler_kept']:g} of the "
            f"gn_moments launches), idle share {p['idle_share']:.4f}")
    for sv in rec.saves:
        log(f"landmarks: save {sv['run']} {'best ' if sv['best'] else ''}step {sv['step']}: "
            f"{sv['bytes'] / 1e9:.3f} GB in {sv['seconds']:.3f} s")
    vpm = {st: rec.vpm(f"ldmk_predict_{st}_") for st in ("crop", "device")}
    # by run directory: the tags that trained it, the last one profiled
    runs = {"ldmk": ("ldmk_train", "ldmk_resume"), "ldmk_device": ("ldmk_device",),
            "ldmk_landmarks": ("ldmk_landmarks",)}
    by_run = {name: dict(patches_per_s=pps[name],
                         step_ms=[1e3 * LDMK_BATCH / v for v in pps[name]],
                         idle_share=rec.profiles[tags[-1]]["idle_share"],
                         peak_memory_bytes=max(peaks[t] for t in tags))
              for name, tags in runs.items()}
    main_saves = [sv for sv in rec.saves if sv["run"] == "ldmk_train" and not sv["best"]]
    summary = dict(by_run=by_run,
                   save_seconds=float(np.median([sv["seconds"] for sv in main_saves])),
                   save_bytes=main_saves[0]["bytes"], predict_volumes_per_min=vpm,
                   allocated_before=base_memory)
    for name, v in by_run.items():
        log(f"landmarks: {name} patches/s by epoch (the Trainer's metrics.jsonl) "
            f"{' '.join(f'{x:.2f}' for x in v['patches_per_s'])} = step "
            f"{' '.join(f'{x:.2f}' for x in v['step_ms'])} ms (host clock over the epoch); "
            f"idle share {v['idle_share']:.4f}; peak memory {v['peak_memory_bytes'] / 2**30:.2f} GiB")
    log(f"landmarks: one checkpoint save {summary['save_seconds']:.3f} s for "
        f"{summary['save_bytes'] / 1e9:.3f} GB; predict volumes/min over {LDMK_PREDICT_TURNS} "
        f"calls of {len(LDMK_SPLITS['test'])} volumes: " + ", ".join(
            f"{st} median {v['median']:.2f} (min {v['min']:.2f}, max {v['max']:.2f})"
            for st, v in vpm.items()))
    return counts, dict(per_run=per_run, indexed=indexed, plain=plain, check=k2), dict(
        summary=summary, cli_seconds=rec.walls, saves=rec.saves, stitches=rec.stitches,
        profiled_epochs=rec.profiles, agreement=agreement, landmark_errors=errors,
        losses=losses, gather_indexed=k2["per_store"])


def landmarks_phase(torch, gn, P, grid_corners, dev, gen) -> dict:
    """The landmark workload at configs/landmarks.yaml width (f_maps 64): K1
    at its level shapes, the full-width parity, then the entry points."""
    probe_profiler(torch, dev)
    log_clocks("landmarks")
    k1 = check_gn(torch, gn, dev, gen, levels=LDMK_LEVELS, batch=LDMK_BATCH)
    k1b = check_gn_backward(torch, gn, dev, gen, levels=LDMK_LEVELS,
                            configs=(("bf16", LDMK_BATCH), ("fp32", LDMK_BATCH)))
    torch.cuda.empty_cache()
    parity = check_landmark_parity(torch, gn, P, dev, gen)
    torch.cuda.empty_cache()
    counts, k2, ldmk = run_landmarks(torch, gn, P, grid_corners, dev)
    return dict(gn_f64=k1, gn_backward_f64=k1b, parity=parity, counts=counts, k2=k2,
                landmarks=ldmk)


def write_brats_nifti(root: Path) -> None:
    """Six seeded 4-modality subjects as a NIfTI directory: ``images/<key>.nii``
    (X, Y, Z, 4) fp32, uncompressed, and ``labels/<key>.nii.gz`` uint8
    classes 0-3 (three ellipsoids, apart), each modality brighter by class
    with its own gain; an oblique-free RAS affine with an offset; and the
    key files."""
    from tpu_mednet_torch.utils.nifti import save_nifti

    rng = np.random.default_rng(5)
    for group in ("images", "labels"):
        (root / "brats_nii" / group).mkdir(parents=True)
    centres = ((0.35, 0.35, 0.4), (0.65, 0.4, 0.6), (0.45, 0.7, 0.45))
    gains = np.asarray([0.75, 0.5, 1.0, 0.25], np.float32)
    for key, shape in BRATS_SUBJECTS:
        lbl = np.zeros(shape, np.uint8)
        grid = np.ogrid[tuple(slice(0, s) for s in shape)]
        for c, frac in enumerate(centres, start=1):
            centre = np.asarray(frac) * shape + rng.uniform(-6, 6, size=3)
            radii = rng.uniform(14, 24, size=3)
            lbl[sum(((g - m) / r) ** 2 for g, m, r in zip(grid, centre, radii)) <= 1] = c
        img = rng.standard_normal((*shape, BRATS_MODALITIES), np.float32) * 0.5
        img += lbl[..., None].astype(np.float32) * gains
        save_nifti(root / "brats_nii" / "images" / f"{key}.nii", img, BRATS_AFFINE)
        save_nifti(root / "brats_nii" / "labels" / f"{key}.nii.gz", lbl, BRATS_AFFINE)
    for split, keys in BRATS_SPLITS.items():
        (root / f"brats_{split}.txt").write_text("\n".join(keys) + "\n")


def brats_train_argv(root: Path):
    return ["-c", str(HERE / "configs" / "seg_brats_bf16.yaml"),
            "--data_path", str(root / "brats_nii"),
            "--train_set", str(root / "brats_train.txt"),
            "--val_set", str(root / "brats_val.txt"),
            "--model_dir", str(root / "brats"), "--log_dir", str(root / "brats" / "logs"),
            "--max_epochs", "1"]


def brats_predict_argv(root: Path, stitch: str, tta: bool, out: Path):
    return ["-c", str(HERE / "configs" / "predict.yaml"),
            f"base.data={root / 'brats_nii'}",
            f"prediction.test_set={root / 'brats_test.txt'}",
            f"prediction.checkpoint={root / 'brats' / 'best'}",
            f"prediction.data={out}", f"prediction.stitch={stitch}",
            f"prediction.tta={'true' if tta else 'false'}"]


def n_tiles(shape, patch=PATCH, overlap=OVERLAP):
    return int(np.prod([-(-s // (p - 2 * o)) for s, p, o in zip(shape, patch, overlap)]))


def stitch_batches(stitch, shapes, geometry=(PATCH, OVERLAP, BATCH)):
    """Forward batches of one predict call at ``geometry`` (patch, overlap,
    batch): per volume on the card, over the concatenated tile stream on
    the host (``GridPatchSampler``)."""
    patch, overlap, batch = geometry
    if stitch == "crop":
        return -(-sum(n_tiles(s, patch, overlap) for s in shapes) // batch)
    return sum(-(-n_tiles(s, patch, overlap) // batch) for s in shapes)


def tta_band(torch, gn, P, task, vol, grid_corners, dev, flips=()):
    """Tie bands of the TTA-averaged class probabilities of ``task`` on
    ``vol``: the plain path's top-2 margin at every voxel, stitched by tile
    cores (``crop``, ``device``) and Gaussian-weighted (``gaussian``), and
    max |kernel - plain| of those probabilities over the device stitch's
    tiles.  A weighted average of tiles each within that error of the
    plain path stays within it, so the same bound holds for both stitches."""
    import torch.nn.functional as F

    from tpu_mednet_torch.inference.common import tta_split_activations
    from tpu_mednet_torch.inference.weighted import gaussian_window

    nh = getattr(task, "num_heatmaps", 0)
    img = np.asarray(vol.shape[1:])
    corners, padded = grid_corners(img, PATCH, OVERLAP)
    n_valid = len(corners)
    corners = np.concatenate([corners, np.repeat(corners[-1:], -len(corners) % BATCH, 0)])
    pads = [int(p) for o, pd, n in reversed(list(zip(OVERLAP, padded, img)))
            for p in (o, pd - n - o)]
    v = F.pad(torch.from_numpy(vol).to(dev).permute(1, 2, 3, 0).contiguous(), (0, 0, *pads))
    w = torch.from_numpy(gaussian_window(PATCH)).to(dev)
    size = tuple(padded.tolist())
    core_margin = torch.zeros(size, device=dev)
    acc = torch.zeros((task.model.config.out_channels - nh, *size), device=dev)
    wacc = torch.zeros(size, device=dev)
    err = 0.0
    core = tuple(slice(o, p - o) for o, p in zip(OVERLAP, PATCH))
    for i in range(0, len(corners), BATCH):
        batch = corners[i:i + BATCH]
        tiles = P.extract_patches_plain(v, batch, PATCH, out_dtype=task.model.config.dtype)
        tiles = tiles.permute(0, 4, 1, 2, 3)
        probs = tta_split_activations(task, tiles, flips)[:, nh:]
        with plain_kernels(gn, P):
            probs_p = tta_split_activations(task, tiles, flips)[:, nh:]
        err = max(err, float((probs - probs_p).abs().max()))
        top2 = probs_p.topk(2, dim=1).values
        m = top2[:, 0] - top2[:, 1]
        for j, ((x0, y0, z0), tile) in enumerate(zip(batch.tolist(), m[(slice(None), *core)])):
            core_margin[x0 + OVERLAP[0]:x0 + PATCH[0] - OVERLAP[0],
                        y0 + OVERLAP[1]:y0 + PATCH[1] - OVERLAP[1],
                        z0 + OVERLAP[2]:z0 + PATCH[2] - OVERLAP[2]] = tile
            if i + j < n_valid:
                sl = (slice(x0, x0 + PATCH[0]), slice(y0, y0 + PATCH[1]),
                      slice(z0, z0 + PATCH[2]))
                acc[(slice(None), *sl)] += probs_p[j] * w
                wacc[sl] += w
    top2 = (acc / wacc.clamp_min(1e-8)).topk(2, dim=0).values
    crop = tuple(slice(o, o + s) for o, s in zip(OVERLAP, img))
    return dict(core=core_margin[crop].cpu().numpy(),
                weighted=(top2[0] - top2[1])[crop].cpu().numpy(), err=err)


def check_gather_c4(torch, P, grid_corners, dev, gen):
    """K2's 4-channel f16 -> bf16 gather at seg_brats_bf16's predict tiles:
    8 windows of 96^3 x 4 from a test subject's padded volume, byte-equal to
    plain (and in fp32 and f16), timed."""
    shape = dict(BRATS_SUBJECTS)[BRATS_SPLITS["test"][-1]]
    corners, padded = grid_corners(shape, PATCH, OVERLAP)
    corners = corners[-BATCH:]
    vol = torch.randn((*padded.tolist(), BRATS_MODALITIES), generator=gen, device=dev).half()
    for dtype in (torch.bfloat16, torch.float32, torch.float16):
        got = P.extract_patches(vol, corners, PATCH, out_dtype=dtype)
        ref = P.extract_patches_plain(vol, corners, PATCH, out_dtype=dtype)
        if got.shape != ref.shape or not torch.equal(got.view(-1).view(torch.uint8),
                                                     ref.view(-1).view(torch.uint8)):
            raise AssertionError(f"gather_patches 4-channel {dtype}: not byte-equal to plain")
    gather = lambda: P.extract_patches(vol, corners, PATCH, out_dtype=torch.bfloat16)
    t_dev, kept, _ = kernel_ms(torch, gather, "gather", 20)
    t_p = cuda_ms(lambda: P.extract_patches_plain(vol, corners, PATCH,
                                                  out_dtype=torch.bfloat16), reps=5)
    b = bound_ms(BATCH * int(np.prod(PATCH)) * BRATS_MODALITIES * (2 + 2), 0)
    log(f"K2 {tuple(vol.shape)} f16 -> {BATCH}x{PATCH}x{BRATS_MODALITIES} bf16 (seg_brats_bf16 "
        f"tiles): {t_dev:.4f} ms device (profiler kept {kept:g} of the launches; bound "
        f"{b:.4f}); plain {t_p:.4f} ms; byte-equal in bf16/fp32/f16")
    return dict(ms=t_dev, plain_ms=t_p, bound_ms=b, max_abs_err=0.0, profiler_kept=kept,
                per=f"{BATCH} windows of 96^3 x {BRATS_MODALITIES} f16 -> bf16 "
                    "(seg_brats_bf16 predict tiles)")


def run_predict_surface(torch, gn, P, grid_corners, dev, gen):
    """The rest of ``predict`` as a user runs it, launches counted from 0:
    ``train_seg -c configs/seg_brats_bf16.yaml`` for 1 epoch from a seeded
    NIfTI directory (only the paths overridden), then ``predict -c
    configs/predict.yaml`` on its ``best/`` with each stitch without and
    with ``tta: true``, ``SURFACE_CALLS`` calls of each in turns, writing
    ``*.nii``; one more ``device`` call into zarr for
    ``tpu_mednet_torch.utils.export``; the guard under ``error`` (raises
    before any upload) and under ``warn`` with a budget below the estimate
    (the Gaussian stitch spilled to the host); a LandmarkNet of
    ``configs/landmarks.yaml`` width (seeded weights) through one Gaussian
    and one ``tta_flips=(0, 2)`` device call.  Then the checks: exact K1
    and K2 launches of every run, TTA ``device`` against TTA ``crop`` and
    ``gaussian`` against its spill inside the tie band, the NIfTI round
    trip and the export, and K2's 4-channel gather byte-equal."""
    import tempfile
    from types import SimpleNamespace

    from tpu_mednet_torch.cli import predict, train_seg
    from tpu_mednet_torch.data import MemoryReader, NiftiReader, ZarrReader
    from tpu_mednet_torch.inference import (predict_volumes_on_device,
                                            predict_volumes_weighted_on_device)
    from tpu_mednet_torch.tasks import LandmarkTask, SegmentationTask
    from tpu_mednet_torch.train import load_for_inference
    from tpu_mednet_torch.utils import export, memory
    from tpu_mednet_torch.utils.nifti import load_nifti

    rec = CliRecorder(torch, gn, P, set(), lambda tag, sampler: False, "predict surface")
    test, shapes = BRATS_SPLITS["test"], dict(BRATS_SUBJECTS)
    test_shapes = [shapes[k] for k in test]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_surface_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_brats_nifti(root)
        log(f"predict surface: seeded NIfTI directory of {len(BRATS_SUBJECTS)} subjects x "
            f"{BRATS_MODALITIES} modalities ({', '.join(f'{k} {s}' for k, s in BRATS_SUBJECTS)})"
            f" in {time.perf_counter() - t0:.1f} s")
        outs, reserved, tags = {}, {}, []
        with rec.wrappers():
            torch.cuda.empty_cache()
            reset_counts(gn, P)
            torch.cuda.reset_peak_memory_stats(dev)
            rec.cli("brats_train", train_seg.main, brats_train_argv(root))
            peak_train = dict(allocated=torch.cuda.max_memory_allocated(dev),
                              reserved=torch.cuda.max_memory_reserved(dev))
            for turn in range(1, SURFACE_CALLS + 1):
                for tta in (False, True):
                    for stitch in STITCHES:
                        tag = f"predict_{stitch}_{'tta' if tta else 'plain'}_{turn}"
                        outs[stitch, tta] = root / f"pred_{stitch}_{int(tta)}.nii"
                        gc.collect()  # the training run's cycles hold card tensors
                        torch.cuda.empty_cache()
                        torch.cuda.reset_peak_memory_stats(dev)
                        held = torch.cuda.memory_reserved(dev)
                        rec.cli(tag, predict.main,
                                brats_predict_argv(root, stitch, tta, outs[stitch, tta]))
                        reserved[tag] = (torch.cuda.max_memory_reserved(dev), held)
                        tags.append(tag)
            rec.cli("predict_device_zarr", predict.main,
                    brats_predict_argv(root, "device", False, root / "pred_device.zarr"))

            weights, hp = load_for_inference(root / "brats" / "best")
            task = SegmentationTask.from_hparams(
                SimpleNamespace(**{k: predict._coerce(v) for k, v in hp.items()}), device=dev)
            task.model.load_state_dict(weights)
            kw = dict(patch_size=list(PATCH), patch_overlap=list(OVERLAP), batch_size=BATCH,
                      device=dev)
            # the guard under error: raises before anything is read or uploaded
            launched, held = launch_counts(gn, P), torch.cuda.memory_allocated(dev)
            try:
                predict_volumes_weighted_on_device(task, root / "brats_nii", test,
                                                   hbm_guard="error", hbm_budget=1 << 20, **kw)
            except memory.HBMBudgetError as exc:
                log(f"predict surface: hbm_guard error: {str(exc)[:160]}...")
            else:
                raise AssertionError("predict surface: hbm_guard error did not raise")
            if (launch_counts(gn, P) != launched
                    or torch.cuda.memory_allocated(dev) != held):
                raise AssertionError("predict surface: the guard's error came after an upload")
            # the guard under warn with a budget below the estimate: every
            # volume goes to the host Gaussian stitch
            spilled = predict_volumes_weighted_on_device(
                task, root / "brats_nii", test, hbm_guard="warn", hbm_budget=1 << 20, **kw)
            rec.snapshots["gaussian_spill"] = launch_counts(gn, P)

            # LandmarkNet at configs/landmarks.yaml width, seeded weights
            ldmk = LandmarkTask.from_hparams(SimpleNamespace(
                in_channels=1, out_channels=LDMK_HEATMAPS + 2, fmaps=64, bf16=True,
                loss_regression_weight=[0.015] * LDMK_HEATMAPS), device=dev,
                generator=torch.Generator().manual_seed(7))
            vol = np.random.default_rng(8).standard_normal(
                (1, *LDMK_VOLUME), np.float32).astype(np.float16)
            ldmk_store = MemoryReader({"images": {"l0": vol}})
            ldmk_out = {}
            ldmk_out["gaussian"] = predict_volumes_weighted_on_device(
                ldmk, None, ["l0"], reader=ldmk_store, **kw)["l0"].array
            rec.snapshots["ldmk_gaussian"] = launch_counts(gn, P)
            ldmk_out["device_tta"] = predict_volumes_on_device(
                ldmk, None, ["l0"], reader=ldmk_store, tta_flips=(0, 2), **kw)["l0"].array
            rec.snapshots["ldmk_device_tta02"] = launch_counts(gn, P)
            counts = launch_counts(gn, P)

        # launches: K2 once per batch on the card's stitches whatever the
        # TTA, none on the host's; K1 27 x 2^k per batch
        per_run = rec.per_run(counts)
        log(f"predict surface: launches {counts}; by run {per_run}")
        steps = len(BRATS_SPLITS["train"]) * BRATS_PATCHES_PER_SUBJECT // BRATS_BATCH
        if (per_run["brats_train"]["gn_bwd_reduce"] != 27 * steps
                or per_run["brats_train"]["gather_patches"]):
            raise AssertionError(f"predict surface: brats training launches "
                                 f"{per_run['brats_train']}, expected 27 x {steps} steps")
        expected = {}
        for tag in tags:
            stitch, mode = tag.split("_")[1:3]
            n_b = stitch_batches(stitch, test_shapes)
            expected[tag] = (27 * n_b * (8 if mode == "tta" else 1),
                             0 if stitch == "crop" else n_b)
        expected["predict_device_zarr"] = (27 * stitch_batches("device", test_shapes),
                                           stitch_batches("device", test_shapes))
        expected["gaussian_spill"] = (27 * stitch_batches("crop", test_shapes), 0)
        n_l = stitch_batches("device", [LDMK_VOLUME])
        expected["ldmk_gaussian"] = (27 * n_l, n_l)
        expected["ldmk_device_tta02"] = (27 * 4 * n_l, n_l)
        for tag, (k1, k2) in expected.items():
            c = per_run[tag]
            if (c["gn_moments"], c["gn_apply"], c["gather_patches"], c["gn_bwd_reduce"]) != (
                    k1, k1, k2, 0):
                raise AssertionError(f"predict surface: {tag} launched {c}, expected K1 {k1}, "
                                     f"K2 {k2}")

        # outputs: shapes, classes, the affine carried, NIfTI read back
        reader = NiftiReader(root / "brats_nii")
        vols = dict(zip(test, reader.read(test, "images", np.float16)))
        affine_in = reader.get_data_attribute(test, "images", "affine")
        masks = {}
        for (stitch, tta), path in outs.items():
            r = NiftiReader(path)
            masks[stitch, tta] = dict(zip(test, r.read(test, "prediction", dtype=None)))
            for key in test:
                m = masks[stitch, tta][key]
                if m.shape != (1, *shapes[key]) or m.dtype != np.uint8 or m.max() >= BRATS_CLASSES:
                    raise AssertionError(f"predict surface: bad mask {stitch} {tta} {key} "
                                         f"{m.shape} {m.dtype}")
                if not np.array_equal(r.get_data_attribute([key], "prediction", "affine")[key],
                                      affine_in[key]):
                    raise AssertionError(f"predict surface: {stitch} {key}: the affine changed")
        with ZarrReader(root / "pred_device.zarr") as r:
            zarr_masks = dict(zip(test, r.read(test, "prediction", np.uint8)))
        for key in test:
            data, affine = load_nifti(outs["device", False] / "prediction" / f"{key}.nii.gz")
            if not (np.array_equal(data[None], zarr_masks[key])
                    and np.array_equal(affine, affine_in[key])):
                raise AssertionError(f"predict surface: {key}: load_nifti does not read back "
                                     "what to_nifti wrote")
        # the export tool on the zarr store
        rc = export.main(["--data_path", str(root / "pred_device.zarr"), "--data_group",
                          "prediction", "--export_dir", str(root / "export")])
        exported = sorted((root / "export" / "pred_device" / "prediction").iterdir())
        log(f"predict surface: export exit code {rc}: {[p.name for p in exported]}")
        for key in test:
            data, affine = load_nifti(root / "export" / "pred_device" / "prediction"
                                      / f"{key}_prediction_c0.nii.gz")
            if rc or data.dtype != np.float32 or not np.array_equal(data, zarr_masks[key][0]):
                raise AssertionError(f"predict surface: export of {key} differs from the store")

        # TTA device vs TTA crop, gaussian vs its spill: inside the tie band
        agreement = {}
        with torch.inference_mode():
            for key in test:
                bands = {flips: tta_band(torch, gn, P, task, vols[key], grid_corners, dev, flips)
                         for flips in ((0, 1, 2), ())}
                for name, a, b, band in (
                        ("device_vs_crop_tta", masks["device", True][key],
                         masks["crop", True][key], bands[0, 1, 2]["core"]),
                        ("gaussian_vs_spill", masks["gaussian", False][key],
                         spilled[key].array, bands[()]["weighted"])):
                    err = bands[(0, 1, 2) if "tta" in name else ()]["err"]
                    flips = a[0] != b[0]
                    outside = int((flips & (band > 2 * err)).sum())
                    agreement[f"{name}_{key}"] = dict(differ=float(flips.mean()),
                                                      outside_band=outside, err=err)
                    log(f"predict surface: {key} {name}: class maps differ on "
                        f"{flips.mean():.6f} of voxels, outside the tie band on {outside} "
                        f"(max |kernel - plain| probability {err:.3g})")
                    if outside:
                        raise AssertionError(f"predict surface: {key} {name}: outside the "
                                             "tie band")
        # LandmarkNet outputs
        for name, out in ldmk_out.items():
            if out.shape != (LDMK_HEATMAPS + 1, *LDMK_VOLUME) or out[-1].max() > 1:
                raise AssertionError(f"predict surface: LandmarkNet {name} {out.shape}")
        ldmk_diff = int(np.abs(ldmk_out["gaussian"][:-1].astype(np.int16)
                               - ldmk_out["device_tta"][:-1].astype(np.int16)).max())
        log(f"predict surface: LandmarkNet f_maps 64 {LDMK_VOLUME}: gaussian and tta [0, 2] "
            f"device heatmaps max |diff| {ldmk_diff}, class maps differ on "
            f"{float((ldmk_out['gaussian'][-1] != ldmk_out['device_tta'][-1]).mean()):.6f}")

        # the predictor of a call keeps no task alive: what the process holds
        # before each call is what it held before the first
        helds = [reserved[tag][1] for tag in tags]
        held_growth = max(helds) - helds[0]
        log(f"predict surface: reserved memory held before each predict call "
            f"{' '.join(f'{h / 2**30:.3f}' for h in helds)} GiB; at most "
            f"{held_growth / 2**30:.3f} GiB beyond the first (limit {HELD_LIMIT / 2**30:.1f})")
        if held_growth > HELD_LIMIT:
            raise AssertionError("predict surface: predict calls leave memory held")

        # memory: each card stitch's peak reserved over what the process held
        # before the call (the CLI builds its model inside it), against the
        # guard's estimate (which counts the model's parameters)
        params_b = memory.param_bytes(task.model)
        mem = {}
        for stitch in ("device", "gaussian"):
            for tta in (False, True):
                est = max(memory.device_stitch_bytes(
                    s, PATCH, OVERLAP, BATCH, BRATS_MODALITIES, 1, task.model.config.feature_maps,
                    stitch=stitch, params_bytes=params_b, n_tta=8 if tta else 1,
                    acc_channels=BRATS_CLASSES)[0] for s in test_shapes)
                mode = "tta" if tta else "plain"
                peak, held = max(reserved[f"predict_{stitch}_{mode}_{t}"]
                                 for t in range(1, SURFACE_CALLS + 1))
                mem[f"{stitch}_{mode}"] = dict(max_memory_reserved=peak, held_before=held,
                                               estimate=est, ratio=est / (peak - held))
                log(f"predict surface: {stitch} tta {tta}: max_memory_reserved "
                    f"{peak / 2**30:.3f} GiB over its calls, {held / 2**30:.3f} GiB held "
                    f"before the call; the guard's estimate {est / 2**30:.3f} GiB (ratio to "
                    f"the call's own {est / (peak - held):.3f})")

        # idle share of one predict call of each stitch, profiled apart
        idle = {}
        for stitch in STITCHES:
            box = {}

            def go():
                t = time.perf_counter()
                if predict.main(brats_predict_argv(root, stitch, False,
                                                   root / "profiled.nii")) != 0:
                    raise AssertionError("predict surface: a profiled call failed")
                box["wall"] = time.perf_counter() - t

            rows, kept = profile_kept(torch, gn, go, 1)
            busy = sum(ms for ms, _, _ in rows) / 1e3
            idle[stitch] = dict(seconds=box["wall"], device_busy_s=busy, profiler_kept=kept,
                                idle_share=idle_share(busy, box["wall"], kept))
            log(f"predict surface: profiled {stitch} call: {box['wall']:.3f} s, device busy "
                f"{busy:.3f} s (profiler kept {kept:g} of the gn_moments launches), idle share "
                f"{idle[stitch]['idle_share']:.4f}")
        del task, weights, ldmk

    k2 = check_gather_c4(torch, P, grid_corners, dev, gen)
    vpm = {f"{st}_{mode}": rec.vpm(f"predict_{st}_{mode}_")
           for mode in ("plain", "tta") for st in STITCHES}
    log(f"predict surface: seg_brats_bf16 (remat: 1) training 1 epoch in "
        f"{rec.walls['brats_train']:.2f} s, peak memory allocated "
        f"{peak_train['allocated'] / 2**30:.2f} GiB (PR 6, remat ignored: "
        f"{PR6_BRATS_PEAK_GIB} GiB), reserved "
        f"{peak_train['reserved'] / 2**30:.2f} GiB; predict volumes/min over {SURFACE_CALLS} "
        f"calls of {len(test)} volumes: " + ", ".join(
            f"{k} median {v['median']:.2f} (min {v['min']:.2f}, max {v['max']:.2f})"
            for k, v in vpm.items()))
    return counts, dict(per_run=per_run, brats_check=k2), dict(
        predict_volumes_per_min=vpm, idle=idle, memory=mem, peak_train=peak_train,
        agreement=agreement, cli_seconds=rec.walls, stitches=rec.stitches,
        landmark_heatmap_max_diff=ldmk_diff, held_before_calls=helds)


def predict_surface_phase(torch, gn, P, grid_corners, dev, gen) -> dict:
    probe_profiler(torch, dev)
    log_clocks("predict surface")
    counts, k2, surface = run_predict_surface(torch, gn, P, grid_corners, dev, gen)
    return dict(counts=counts, k2=k2, surface=surface)


def k1_per_step(remat_levels: int, n_levels: int = 5) -> dict:
    """K1 launches of one full-width train step: 27 GroupNorms forward and
    backward, and each recomputed stage's 3 forwards again in the backward
    (encoder stage i when i < k, the decoder stage whose output level is < k)."""
    k = min(remat_levels, n_levels)
    again = 3 * (k + min(k, n_levels - 1))
    return dict(gn_moments=27 + again, gn_apply=27 + again, gn_bwd_reduce=27, gn_bwd_apply=27)


def timed_steps(torch, step, state, feed, n):
    """``n`` steps, each between CUDA events: (state, step ms, losses)."""
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(n)]
    losses = []
    torch.cuda.synchronize()
    for start, end in events:
        start.record()
        state, metrics = step(state, next(feed))
        end.record()
        losses.append(metrics["train_loss"])
    torch.cuda.synchronize()
    return state, [a.elapsed_time(b) for a, b in events], [float(v) for v in losses]


def remat_surface(torch, gn, P, dev, sampler):
    """bench.py's step (batch 32 of 96^3, bf16, Dice, Adam, mirror flips,
    ``DevicePatchSampler``) at remat 0, 1 and all on one model: patches/s,
    peak memory against ``unet_train_peak_bytes``, exact K1 launches per step."""
    import dataclasses

    from tpu_mednet_torch.models import ResidualUNet3D
    from tpu_mednet_torch.ops.augment import AugmentConfig
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.train import create_train_state, make_train_step
    from tpu_mednet_torch.utils import memory

    model = ResidualUNet3D(1, 2, f_maps=32, dtype=torch.bfloat16, device=dev,
                           generator=torch.Generator().manual_seed(0))
    task = SegmentationTask(model=model, loss="DICE")
    n_params = sum(p.numel() for p in model.parameters())
    feed = endless_batches(sampler, TRAIN_BATCH)
    out = {}
    for name, remat in REMATS:
        model.config = dataclasses.replace(model.config, remat=remat)
        model.zero_grad(set_to_none=True)
        state = create_train_state(model, learning_rate=1e-3, seed=0)
        step = make_train_step(task, augment=AugmentConfig(mirror_axes=(1, 2, 3)))
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        for _ in range(SURFACE_WARMUP):
            state, _ = step(state, next(feed))
        before = launch_counts(gn, P)
        state, step_ms, losses = timed_steps(torch, step, state, feed, SURFACE_STEPS)
        after = launch_counts(gn, P)
        per_step = {k: (after[k] - before[k]) / SURFACE_STEPS for k in after}
        want = dict(k1_per_step(model.config.remat_levels), gather_patches=1)
        reserved = torch.cuda.max_memory_reserved(dev)
        allocated = torch.cuda.max_memory_allocated(dev)
        est = memory.unet_train_peak_bytes(TRAIN_BATCH, PATCH, model.config.feature_maps, 1, 2,
                                           n_params, remat=remat)
        median = float(np.median(step_ms))
        out[name] = dict(patches_per_s=TRAIN_BATCH / median * 1e3, step_ms=step_ms,
                         max_memory_allocated=allocated, max_memory_reserved=reserved,
                         estimate=est, ratio=est / reserved, launches_per_step=per_step,
                         losses=losses)
        log(f"training surface: remat {name}: median step {median:.2f} ms = "
            f"{TRAIN_BATCH / median * 1e3:.2f} patches/s (steps "
            f"{' '.join(f'{t:.2f}' for t in step_ms)}); max_memory_allocated "
            f"{allocated / 2**30:.3f} GiB, max_memory_reserved {reserved / 2**30:.3f} GiB; "
            f"unet_train_peak_bytes {est / 2**30:.3f} GiB (ratio {est / reserved:.3f}); "
            f"launches per step {per_step}")
        if per_step != want:
            raise AssertionError(f"training surface: remat {name}: launches per step "
                                 f"{per_step}, expected {want}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"training surface: remat {name}: non-finite loss {losses}")
        if not MEMORY_RATIO[0] <= est / reserved <= MEMORY_RATIO[1]:
            raise AssertionError(f"training surface: remat {name}: estimate / reserved "
                                 f"{est / reserved:.3f} outside {list(MEMORY_RATIO)}")
        del state, step
    peaks = [out[name]["max_memory_reserved"] for name, _ in REMATS]
    if not peaks[0] > peaks[1] > peaks[2]:
        raise AssertionError(f"training surface: reserved peaks by remat {peaks} do not fall")
    model.config = dataclasses.replace(model.config, remat=False)
    model.zero_grad(set_to_none=True)
    return model, task, out


def remat_parity(torch, gn, dev, gen):
    """One step's loss and every parameter's gradient at remat 1 and all
    against remat 0, same weights and batch, fp32 (TF32 off) and bf16,
    held to the train-step parity bounds with cuDNN's default algorithms
    and with its deterministic ones (the default wgrad sums in a varying
    order, so that even two identical steps may differ in the last bits);
    bit-equality printed.  And K1 under the recompute, with deterministic
    cuDNN: at remat 1 the statistics the backward recomputes for the
    level-0 stages (decoder, then encoder) must equal the forward's bit for
    bit where K1's input does, which must be somewhere."""
    import dataclasses

    from tpu_mednet_torch.models import ResidualUNet3D
    from tpu_mednet_torch.tasks import SegmentationTask

    x = torch.randn((PARITY_BATCH, 1, *PATCH), generator=gen, device=dev)
    label = torch.zeros((PARITY_BATCH, 1, *PATCH), dtype=torch.uint8, device=dev)
    label[:, :, 20:70, 30:80, 10:60] = 1
    x = x + label
    out = {}
    deterministic = torch.backends.cudnn.deterministic
    try:
        for mode in ("default", "deterministic"):
            torch.backends.cudnn.deterministic = mode == "deterministic"
            for dt, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
                out[f"{dt}_{mode}"] = remat_parity_case(
                    torch, gn, ResidualUNet3D(1, 2, f_maps=32, dtype=dtype, device=dev,
                                              generator=torch.Generator().manual_seed(0)),
                    SegmentationTask, dataclasses, x, label, dt, mode)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return out


def remat_parity_case(torch, gn, model, SegmentationTask, dataclasses, x, label, dt, mode):
    task = SegmentationTask(model=model, loss="DICE")
    calls = []  # (K1's input, its statistics) per moments call

    def recording(orig):
        def group_norm_moments(xin, *args, **kw):
            st = orig(xin, *args, **kw)
            calls.append((xin.clone(), [t.clone() for t in st]))
            return st
        return group_norm_moments

    def grads(remat):
        model.config = dataclasses.replace(model.config, remat=remat)
        model.zero_grad(set_to_none=True)
        del calls[:]
        with wrapped(gn, "group_norm_moments", recording):
            loss, _ = task.loss_fn(model(x), {"label": label})
            loss.backward()
        return float(loss.detach()), {k: p.grad.clone() for k, p in model.named_parameters()}

    ref = grads(False)
    res = {"1": grads(1)}
    # backward order: decoder stage 3 (GroupNorms 24-26), then encoder stage 0 (0-2)
    pairs = list(zip(range(27, 33), (24, 25, 26, 0, 1, 2))) if len(calls) == 33 else []
    same_input = [(i, j) for i, j in pairs if torch.equal(calls[i][0], calls[j][0])]
    k1_equal = bool(same_input) and all(
        torch.equal(a, b) for i, j in same_input for a, b in zip(calls[i][1], calls[j][1]))
    del calls[:]
    res["all"] = grads(True)
    again = grads(1)
    repeatable = again[0] == res["1"][0] and all(
        torch.equal(again[1][k], res["1"][1][k]) for k in again[1])
    out = dict(k1_recompute_bit_equal=k1_equal, k1_inputs_bit_equal=len(same_input),
               remat1_twice_bit_equal=repeatable)
    tag = f"{dt}, cuDNN {mode}"
    for name, (loss, g) in res.items():
        rel = {k: float((g[k] - ref[1][k]).abs().max()) / float(ref[1][k].abs().max())
               for k in g}
        worst = max(rel, key=rel.get)
        bit_equal = loss == ref[0] and all(torch.equal(g[k], ref[1][k]) for k in g)
        out[name] = dict(loss=loss, loss_remat0=ref[0], worst_param=worst,
                         worst_rel=rel[worst], bit_equal=bit_equal)
        log(f"training surface: remat {name} vs 0, {tag}, batch {PARITY_BATCH}: loss "
            f"{loss:.6f} vs {ref[0]:.6f}; max over {len(rel)} parameters of max|dg|/max|g| "
            f"{rel[worst]:.3g} ({worst}; bound {PARITY_REL[dt]}); bit-equal {bit_equal}")
        if abs(loss - ref[0]) > PARITY_REL[dt] or rel[worst] > PARITY_REL[dt]:
            raise AssertionError(f"training surface: remat {name} ({tag}) disagrees with "
                                 "remat 0")
    log(f"training surface: {tag}: under remat 1, K1's input to the 6 recomputed "
        f"GroupNorms bit-equal to the forward's in {len(same_input)}, the statistics there "
        f"bit-equal: {k1_equal}; remat 1 twice bit-equal: {repeatable}")
    if mode == "deterministic" and not k1_equal:
        raise AssertionError(f"training surface: K1's recompute under remat 1 ({tag}) "
                             "differs from its forward")
    return out


def spatial_surface(torch, dev, task, sampler):
    """bench.py's step with the spatial transform (SPATIAL, the separable
    warp) added to the mirror flips: patches/s, the warp's device ms per
    step from CUDA events around ``spatial_3d``, peak memory; every warped
    label value must lie in the input's label set, every loss be finite."""
    from tpu_mednet_torch.ops import augment as A
    from tpu_mednet_torch.train import create_train_state, make_train_step

    model = task.model
    state = create_train_state(model, learning_rate=1e-3, seed=0)
    step = make_train_step(task, augment=A.AugmentConfig(mirror_axes=(1, 2, 3), **SPATIAL))
    feed = endless_batches(sampler, TRAIN_BATCH)
    pairs, outside = [], []

    def timing(orig):
        def spatial_3d(x, draws, label=None, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            y, lab = orig(x, draws, label=label, **kw)
            end.record()
            pairs.append((start, end))
            outside.append(int((~torch.isin(lab, torch.unique(label))).sum()))
            return y, lab
        return spatial_3d

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    with wrapped(A, "spatial_3d", timing):
        for _ in range(SURFACE_WARMUP):
            state, _ = step(state, next(feed))
        del pairs[:]
        state, step_ms, losses = timed_steps(torch, step, state, feed, SURFACE_STEPS)
    warp_ms = [a.elapsed_time(b) for a, b in pairs]
    median = float(np.median(step_ms))
    res = dict(patches_per_s=TRAIN_BATCH / median * 1e3, step_ms=step_ms, warp_ms=warp_ms,
               max_memory_allocated=torch.cuda.max_memory_allocated(dev),
               max_memory_reserved=torch.cuda.max_memory_reserved(dev), losses=losses,
               labels_outside_set=sum(outside))
    log(f"training surface: spatial {SPATIAL} + mirror, remat 0: median step {median:.2f} ms = "
        f"{res['patches_per_s']:.2f} patches/s; spatial_3d {np.mean(warp_ms):.3f} ms per step "
        f"(events; {' '.join(f'{t:.3f}' for t in warp_ms)}); max_memory_allocated "
        f"{res['max_memory_allocated'] / 2**30:.3f} GiB, reserved "
        f"{res['max_memory_reserved'] / 2**30:.3f} GiB; losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}; warped label voxels outside the input's "
        f"label set: {sum(outside)}")
    if sum(outside) or not all(np.isfinite(losses)):
        raise AssertionError("training surface: spatial step: labels left the set or a loss "
                             "is not finite")
    del state, step
    return res


def warp_ambiguous(coords, apply, method, bands, tie=WARP_TIE):
    """(N, X, Y, Z) bool: label voxels whose nearest pick, at the source
    positions ``coords`` (N, X, Y, Z, 3), lies within ``tie`` of a rounding
    boundary, followed through the separable passes."""
    shape = coords.shape[1:4]
    near = lambda src: np.abs(src - np.floor(src) - 0.5) < tie
    base = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                                indexing="ij"), -1)
    if method == "exact":
        amb = near(np.clip(coords, 0.0, np.asarray(shape, np.float32) - 1.0)).any(-1)
    else:
        disp = np.clip(coords - base, -np.asarray(bands, np.float32),
                       np.asarray(bands, np.float32))
        amb = np.zeros(coords.shape[:4], bool)
        for axis in range(3):
            src = np.clip(base[..., axis] + disp[..., axis], 0.0, shape[axis] - 1.0)
            lo = np.floor(src)
            idx = (lo + (src - lo > 0.5)).astype(np.int64)
            amb = np.take_along_axis(amb, idx, axis=axis + 1) | near(src)
    return amb & np.asarray(apply).reshape(-1, 1, 1, 1)


def smooth_volume(n, extent, seed):
    """(n, 1, e, e, e) fp32: sines along each axis and a little noise."""
    rng = np.random.default_rng(seed)
    g = np.meshgrid(*[np.arange(extent, dtype=np.float32)] * 3, indexing="ij")
    x = np.sin(0.2 * g[0]) + np.cos(0.15 * g[1]) + np.sin(0.25 * g[2])
    return (x[None, None] + 0.1 * rng.normal(size=(n, 1, *x.shape))).astype(np.float32)


def check_warp_devices(torch, dev):
    """``spatial_3d`` on the card against the CPU from the same draws (both
    methods, a heatmap channel warped linearly and a class map), then
    ``separable`` against ``exact`` on the card under a small deformation."""
    from tpu_mednet_torch.ops import augment as A

    n, e = WARP_CHECK
    shape = (e,) * 3
    x = torch.from_numpy(smooth_volume(n, e, 6))
    g = np.meshgrid(*[np.arange(e, dtype=np.float32)] * 3, indexing="ij")
    heat = 255.0 * np.exp(-sum((a - e / 2) ** 2 for a in g) / (2 * 6.0**2))
    label = torch.from_numpy(np.concatenate(
        [np.broadcast_to(heat, (n, 1, *shape)).astype(np.uint8),
         ((x > 0.5).numpy() + (x > 1.5).numpy()).astype(np.uint8)], 1))
    draws = A.draw_spatial(n, torch.Generator().manual_seed(5), **SPATIAL)
    on_card = A.SpatialDraws(*[None if t is None else t.to(dev) for t in draws])
    coords = A.sample_coords(shape, draws).permute(0, 2, 3, 4, 1).numpy()
    bands = [A.axis_band(shape, ax, **SPATIAL) for ax in range(3)]
    out = {}
    for method in ("separable", "exact"):
        kw = dict(method=method, label_trilinear_channels=1, **SPATIAL)
        y_c, l_c = A.spatial_3d(x, draws, label=label, **kw)
        y_d, l_d = A.spatial_3d(x.to(dev), on_card, label=label.to(dev), **kw)
        err = float((y_d.cpu() - y_c).abs().max())
        amb = warp_ambiguous(coords, draws.apply, method, bands)
        cls = (l_d.cpu()[:, 1] != l_c[:, 1]).numpy()
        heat_diff = int((l_d.cpu()[:, 0].int() - l_c[:, 0].int()).abs().max())
        out[method] = dict(image_err=err, image_bound=WARP_IMAGE_REL * float(x.abs().max()),
                           class_differ=int(cls.sum()), class_outside_tie=int((cls & ~amb).sum()),
                           tie_share=float(amb.mean()), heatmap_max_diff=heat_diff)
        log(f"training surface: spatial_3d {method} at {n} x {e}^3, card vs CPU: image "
            f"max|diff| {err:.3g} (bound {out[method]['image_bound']:.3g}); class map differs "
            f"on {int(cls.sum())} voxels, {out[method]['class_outside_tie']} outside the "
            f"{WARP_TIE} tie ({amb.mean():.2e} of voxels); heatmap max|diff| {heat_diff}")
        if (err > out[method]["image_bound"] or out[method]["class_outside_tie"]
                or heat_diff > 1):
            raise AssertionError(f"training surface: spatial_3d {method} on the card "
                                 "disagrees with the CPU")
    small = A.draw_spatial(n, torch.Generator(device=dev).manual_seed(3), **SMALL_DEFORMATION)
    xd = x.to(dev)
    kw = dict(elastic_sigma=SMALL_DEFORMATION["elastic_sigma"],
              rotate_deg=SMALL_DEFORMATION["rotate_deg"])
    sep = A.spatial_3d(xd, small, method="separable", **kw).cpu().numpy()
    ex = A.spatial_3d(xd, small, method="exact", **kw).cpu().numpy()
    span = float(x.max() - x.min())
    mean = float(np.abs(sep - ex).mean())
    corr = float(np.corrcoef(sep.ravel(), ex.ravel())[0, 1])
    out["separable_vs_exact"] = dict(mean_abs=mean, bound=SEPARABLE_MEAN_REL * span, corr=corr,
                                     moved=float(np.abs(sep - x.numpy()).mean()))
    log(f"training surface: separable vs exact on the card, {SMALL_DEFORMATION}: mean|diff| "
        f"{mean:.4g} (bound {SEPARABLE_MEAN_REL} x range = {SEPARABLE_MEAN_REL * span:.4g}), "
        f"correlation {corr:.5f} (bound {SEPARABLE_CORR}); mean |warped - input| "
        f"{out['separable_vs_exact']['moved']:.4g}")
    if not (mean < SEPARABLE_MEAN_REL * span and corr > SEPARABLE_CORR
            and out["separable_vs_exact"]["moved"] > 0):
        raise AssertionError("training surface: separable and exact disagree on the card")
    return out


def training_surface_entry_points(torch, gn, P, dev):
    """``train_seg -c configs/seg_organ.yaml --remat 1`` and ``train_ldmks -c
    configs/landmarks.yaml``, both with the spatial flags, ``SURFACE_EPOCHS``
    each through ``main(argv)`` on the seeded stores: patches/s by epoch,
    peak memory, launches.  The landmark run's first warped label must keep its heatmap
    channels within the unwarped range and its class map in-set, and its
    heatmap channels must differ from a nearest warp of the same draws (the
    Trainer's hook warps them linearly)."""
    import tempfile

    from tpu_mednet_torch.cli import train_ldmks, train_seg
    from tpu_mednet_torch.ops import augment as A

    seen = {}

    def capture(orig):
        def spatial_3d(x, draws, label=None, **kw):
            out = orig(x, draws, label=label, **kw)
            if label is not None and label.shape[1] > 1 and "ldmk" not in seen:
                seen["ldmk"] = (label.clone(), out[1].clone(), draws, kw)
            return out
        return spatial_3d

    runs = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_training_") as tmp:
        root = Path(tmp)
        t0 = time.perf_counter()
        write_organ_store(root)
        write_landmark_store(root)
        log(f"training surface: seeded organ and landmark stores in "
            f"{time.perf_counter() - t0:.1f} s")
        for tag, main, name, argv, steps in (
                ("seg_organ_spatial_remat1", train_seg.main, "seg_organ",
                 organ_train_argv(root, "seg_organ", "--max_epochs", str(SURFACE_EPOCHS),
                                  "--remat", "1", *SPATIAL_FLAGS),
                 SURFACE_EPOCHS * ORGAN_STEPS_PER_EPOCH),
                ("landmarks_spatial", train_ldmks.main, "ldmk",
                 ldmk_train_argv(root, "ldmk", SURFACE_EPOCHS, *SPATIAL_FLAGS),
                 SURFACE_EPOCHS * LDMK_STEPS_PER_EPOCH)):
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            before = launch_counts(gn, P)
            t = time.perf_counter()
            with wrapped(A, "spatial_3d", capture):
                rc = main(argv)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t
            after = launch_counts(gn, P)
            pps = [r["patches_per_sec"] for r in read_metrics(
                root / name / "logs" / "metrics.jsonl") if "patches_per_sec" in r]
            runs[tag] = dict(exit_code=rc, seconds=seconds, patches_per_s=pps,
                             max_memory_allocated=torch.cuda.max_memory_allocated(dev),
                             max_memory_reserved=torch.cuda.max_memory_reserved(dev),
                             launches={k: after[k] - before[k] for k in after})
            log(f"training surface: {tag}: exit code {rc} in {seconds:.2f} s; patches/s "
                f"{pps}; max_memory_allocated {runs[tag]['max_memory_allocated'] / 2**30:.3f} "
                f"GiB, reserved {runs[tag]['max_memory_reserved'] / 2**30:.3f} GiB; launches "
                f"{runs[tag]['launches']}")
            if rc != 0 or len(pps) != SURFACE_EPOCHS:
                raise AssertionError(f"training surface: {tag} exited with {rc}")
            if runs[tag]["launches"]["gn_bwd_reduce"] != 27 * steps:
                raise AssertionError(f"training surface: {tag}: K1 backward launches "
                                     f"{runs[tag]['launches']}, expected 27 x {steps} steps")
        # remat 1 recomputes 6 GroupNorms a step on top of the forwards'
        seg = runs["seg_organ_spatial_remat1"]["launches"]
        steps = SURFACE_EPOCHS * ORGAN_STEPS_PER_EPOCH
        val = seg["gn_moments"] - 33 * steps
        if val <= 0 or val % 27:
            raise AssertionError(f"training surface: seg_organ --remat 1 launched {seg}, "
                                 f"expected 33 x {steps} steps + 27 per validation batch")

    lab_in, lab_out, draws, kw = seen["ldmk"]
    k = kw["label_trilinear_channels"]
    heat_in, heat_out = lab_in[:, :k].float(), lab_out[:, :k].float()
    nearest = A.spatial_3d(torch.zeros_like(lab_in[:, :1], dtype=torch.float32), draws,
                           label=lab_in, **{**kw, "label_trilinear_channels": 0})[1]
    hook = dict(label_trilinear_channels=k,
                heatmap_range_in=[float(heat_in.min()), float(heat_in.max())],
                heatmap_range_out=[float(heat_out.min()), float(heat_out.max())],
                class_outside_set=int((~torch.isin(lab_out[:, k:], torch.unique(
                    lab_in[:, k:]))).sum()),
                voxels_unlike_nearest=int((nearest[:, :k] != lab_out[:, :k]).sum()))
    log(f"training surface: landmark hook: {hook}")
    if not (k == LDMK_HEATMAPS and heat_out.min() >= heat_in.min()
            and heat_out.max() <= heat_in.max() and hook["class_outside_set"] == 0
            and hook["voxels_unlike_nearest"] > 0):
        raise AssertionError("training surface: the landmark heatmaps were not warped "
                             "linearly within their range, or the class map left its set")
    return dict(runs=runs, landmark_hook=hook)


def training_surface_phase(torch, gn, P, grid_corners, dev, gen) -> dict:
    """remat 0/1/all and the spatial transform at full width, their parity
    and card checks, then the two training CLIs with the new flags;
    launches counted from 0."""
    log_clocks("training surface")
    torch.backends.cudnn.allow_tf32 = False  # the fp32 parity bound holds without TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    reset_counts(gn, P)
    sampler = seeded_train_sampler(dev)
    model, task, remat = remat_surface(torch, gn, P, dev, sampler)
    spatial = spatial_surface(torch, dev, task, sampler)
    del model, task, sampler
    torch.cuda.empty_cache()
    parity = remat_parity(torch, gn, dev, gen)
    warp = check_warp_devices(torch, dev)
    torch.cuda.empty_cache()
    entry = training_surface_entry_points(torch, gn, P, dev)
    counts = launch_counts(gn, P)
    seconds = time.perf_counter() - t0
    log(f"training surface: launches {counts}; {seconds:.1f} s")
    return dict(counts=counts, surface=dict(remat=remat, parity=parity, spatial=spatial,
                                            warp_checks=warp, entry_points=entry,
                                            seconds=seconds))


def tools_scores(label, result, truth, keys, n_classes):
    """Check an ``evaluate`` result against what a model that outputs
    nothing scores on the same truth: Dice finite and in [0, 1]; for a
    segmentation model the foreground Dice above an all-background mask's;
    for a landmark model (whose class head is auxiliary) every landmark's
    mean error finite and below that of all-zero heatmaps (whose argmax is
    voxel 0).  Returns the means printed."""
    from tpu_mednet_torch.data import ZarrReader
    from tpu_mednet_torch.data.readers import read_single_volume
    from tpu_mednet_torch.utils.evaluation import (aggregate, landmark_errors,
                                                   overlap_metrics, spacing_from_affine)

    seg = result["mean"]["segmentation"]
    dice = np.array([row["dice"] for row in seg], np.float64)
    landmarks = "landmarks" in result["mean"]
    with ZarrReader(truth) as r:
        rows, hm_rows = [], []
        for key in keys:
            true = read_single_volume(r, key, "labels")[-1]
            rows.append(overlap_metrics(np.zeros_like(true), true, n_classes))
            if landmarks:
                hm = read_single_volume(r, key, "heatmaps").astype(np.float32)
                spacing = spacing_from_affine(
                    r.get_data_attribute([key], "labels", "affine")[key])
                hm_rows.append(landmark_errors(np.zeros_like(hm), hm, spacing=spacing))
    background = np.array([row["dice"] for row in aggregate(rows)], np.float64)
    out = dict(mean_dice=float(np.nanmean(dice)), foreground_dice=float(np.nanmean(dice[1:])),
               all_background_foreground_dice=float(np.nanmean(background[1:])),
               dice_by_class=dice.tolist())
    finite = dice[~np.isnan(dice)]
    if not (finite.size and ((finite >= 0) & (finite <= 1)).all()):
        raise AssertionError(f"tools: {label}: evaluate Dice {dice.tolist()}")
    if not landmarks and out["foreground_dice"] <= out["all_background_foreground_dice"]:
        raise AssertionError(f"tools: {label}: foreground Dice {out['foreground_dice']}, an "
                             f"all-background mask's {out['all_background_foreground_dice']}")
    text = ""
    if landmarks:
        errs = np.array([row["voxels"] for row in result["mean"]["landmarks"]], np.float64)
        zero = np.array([row["voxels"] for row in aggregate(hm_rows)], np.float64)
        out.update(landmark_error_voxels=errs.tolist(),
                   landmark_error_mm=[row["mm"] for row in result["mean"]["landmarks"]],
                   all_zero_heatmap_error_voxels=zero.tolist())
        if not (np.isfinite(out["landmark_error_mm"]).all() and (errs < zero).all()):
            raise AssertionError(f"tools: {label}: landmark errors {errs.tolist()} voxels, "
                                 f"all-zero heatmaps' {zero.tolist()}")
        text = (f"; landmark error {[round(v, 3) for v in errs.tolist()]} voxels (all-zero "
                f"heatmaps: {[round(v, 3) for v in zero.tolist()]}), "
                f"{[round(v, 3) for v in out['landmark_error_mm']]} mm")
    log(f"tools: {label}: evaluate over {result['n_subjects']} subjects, {result['n_classes']} "
        f"classes: mean Dice {out['mean_dice']:.4f}, foreground {out['foreground_dice']:.4f} "
        f"(an all-background mask: {out['all_background_foreground_dice']:.4f}); by class "
        f"{[round(d, 4) for d in dice.tolist()]}{text}")
    return out


def tools_round_trip(torch, gn, P, grid_corners, dev, rec, name, model_dir, predict_argv,
                     keys, images, n_heatmaps):
    """The interop round trip on a trained checkpoint directory: inspect
    (its parameter count and best-val record against the run's own files),
    export to a reference ``.ckpt``, import that into a new directory
    (weights bit-equal to the export's), then predict from both; their
    outputs against the original directory's prediction (``pred.zarr``
    beside ``model_dir``): byte-equal, else heatmaps within 1 and class
    maps apart only inside the tie band of the original's weights."""
    import contextlib
    import io
    from types import SimpleNamespace

    from tpu_mednet_torch.cli import export_torch, import_torch, inspect_ckpt, predict
    from tpu_mednet_torch.data import ZarrReader
    from tpu_mednet_torch.tasks import LandmarkTask, SegmentationTask

    root = model_dir.parent
    gc.collect()
    held = torch.cuda.memory_allocated(dev)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        rec.cli(f"{name}_inspect", inspect_ckpt.main,
                ["--checkpoint", str(model_dir), "--json"])
    info = json.loads(text.getvalue().splitlines()[0])  # then rec.cli's own line
    step = max(int(d.name) for d in model_dir.iterdir() if d.name.isdigit())
    weights = torch.load(model_dir / str(step) / "model.pt", weights_only=True)["params"]
    n_params = sum(v.numel() for v in weights.values())
    best = json.loads(next((model_dir / "best").glob("*/hparams.json")).read_text())
    if (info["model"]["params"] != n_params or info["best"] != best["_best_monitor"]
            or info["latest_step"] != step):
        raise AssertionError(f"tools: {name}: inspect {info} against {n_params} parameters, "
                             f"best {best['_best_monitor']}, step {step}")
    ckpt, imported = root / "X.ckpt", root / "imported"
    rec.cli(f"{name}_export", export_torch.main,
            ["--checkpoint", str(model_dir), "--output", str(ckpt)])
    rec.cli(f"{name}_import", import_torch.main,
            ["--checkpoint", str(ckpt), "--output", str(imported)])
    if torch.cuda.memory_allocated(dev) > held:
        raise AssertionError(f"tools: {name}: a host tool left card memory allocated")
    exported = torch.load(ckpt, weights_only=False)["state_dict"]
    got = torch.load(imported / str(step) / "model.pt", weights_only=True)["params"]
    if not (sorted(got) == sorted(exported) == sorted(weights)
            and all(torch.equal(got[k], exported[k]) and torch.equal(exported[k], weights[k])
                    for k in weights)):
        raise AssertionError(f"tools: {name}: the imported weights differ from the export")
    outs = {"original": root / "pred.zarr"}
    for tag, source in (("import", imported), ("ckpt", ckpt)):
        outs[tag] = root / f"pred_{tag}.zarr"
        rec.cli(f"{name}_predict_{tag}", predict.main, predict_argv(source, outs[tag]))
    preds = {}
    for tag, path in outs.items():
        with ZarrReader(path) as r:
            preds[tag] = dict(zip(keys, r.read(keys, "prediction", dtype=None)))
    held_as, task = {}, None
    for tag in ("import", "ckpt"):
        held_as[tag] = "byte-equal"
        for key in keys:
            a, b = preds["original"][key], preds[tag][key]
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"tools: {name}: {tag} {key} {b.shape} {b.dtype}")
            if np.array_equal(a, b):
                continue
            held_as[tag] = "tie band"
            if task is None:
                hp = json.loads((model_dir / str(step) / "hparams.json").read_text())
                ns = SimpleNamespace(**{k: predict._coerce(v) for k, v in hp.items()})
                task = (LandmarkTask if n_heatmaps else SegmentationTask).from_hparams(
                    ns, device=dev)
                task.model.load_state_dict(weights)
            hm = int(np.abs(a[:-1].astype(np.int16) - b[:-1].astype(np.int16)).max(initial=0))
            with torch.inference_mode():
                margin, err = tie_band_margin(torch, gn, P, task.model, images[key],
                                              grid_corners, dev, slice(n_heatmaps, None))
            outside = int(((a[-1] != b[-1]) & (margin > 2 * err)).sum())
            log(f"tools: {name}: {tag} {key}: class maps differ on "
                f"{float((a[-1] != b[-1]).mean()):.6f} of voxels, outside the tie band on "
                f"{outside}; heatmaps max |diff| {hm}")
            if outside or hm > 1:
                raise AssertionError(f"tools: {name}: {tag} {key} outside the tie band")
    del task
    log(f"tools: {name}: inspect {n_params} parameters, best {info['best']}; export, import "
        f"(weights bit-equal); predict from the import: {held_as['import']}, from the .ckpt: "
        f"{held_as['ckpt']} to the original's")
    return dict(params=n_params, best=info["best"], step=step, held=held_as)


def run_tools(torch, gn, P, grid_corners, dev):
    """The user's tools around the card's training and prediction, each CLI
    through ``main(argv)`` in this process (launches counted from 0): the
    quick start (``demo`` -> ``train_seg`` / ``train_ldmks`` -> ``predict``
    -> ``evaluate``) on the demo's own configs; ``train_seg -c
    configs/seg_brats_bf16.yaml`` and ``train_ldmks -c configs/landmarks.yaml``
    (paths overridden, 1 epoch) on demo stores of 160^3 written on the host
    meanwhile, each predicted (``device`` stitch) and scored; the interop
    round trip on both checkpoints (``tools_round_trip``); ``pack`` of a
    NIfTI demo to zarr with ``stats`` equal on both, and ``evaluate`` of a
    NIfTI prediction directory equal to its zarr one.  Then the exact K1/K2
    launches of every run (none for the host tools)."""
    import concurrent.futures
    import contextlib
    import io
    import tempfile

    from tpu_mednet_torch.cli import demo, evaluate, pack, predict, stats, train_ldmks, train_seg
    from tpu_mednet_torch.data import ZarrReader
    from tpu_mednet_torch.models import ResidualUNet3D

    rec = CliRecorder(torch, gn, P, set(), lambda tag, sampler: False, "tools")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tools_") as tmp, \
            concurrent.futures.ThreadPoolExecutor(2) as pool:
        root = Path(tmp)
        q, b, lm, nii = root / "quick", root / "brats", root / "ldmk", root / "nii"
        t0 = time.perf_counter()
        # the 160^3 stores are written on the host while the quick start trains
        full = {"brats": pool.submit(demo.main, [
                    "--out", str(b), "--size", str(FULL_SIZE), "--modalities", "4",
                    "--format", "zarr", "--log_level", "WARNING"]),
                "ldmk": pool.submit(demo.main, [
                    "--out", str(lm), "--size", str(FULL_SIZE), "--heatmaps", "3",
                    "--classes", "2", "--format", "zarr", "--log_level", "WARNING"])}
        scores, evals = {}, {}

        def score(tag, pred, truth, keys, n_classes, *extra):
            out = root / f"{tag}.json"
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rec.cli(tag, evaluate.main, ["--pred", str(pred), "--truth", str(truth),
                                             "--subjects", str(truth.parent / "test.txt"),
                                             "--json", str(out), "--log_level", "WARNING",
                                             *extra])
            evals[tag] = json.loads(out.read_text())
            scores[tag] = tools_scores(tag, evals[tag], truth, keys, n_classes)

        with rec.wrappers():
            reset_counts(gn, P)
            # a. the quick start as users run it
            rec.cli("quick_demo", demo.main, ["--out", str(q), "--format", "zarr",
                                              "--log_level", "WARNING"])
            q_keys = (q / "test.txt").read_text().split()
            for short, main, extra in (("seg", train_seg.main, ()),
                                       ("ldmks", train_ldmks.main, QUICK_CLASS_WEIGHTS)):
                yaml_name = "seg.yaml" if short == "seg" else "landmarks.yaml"
                rec.cli(f"quick_{short}_train", main,
                        ["-c", str(q / yaml_name), "--max_epochs", str(QUICK_EPOCHS), *extra])
                rec.cli(f"quick_{short}_predict", predict.main,
                        ["-c", str(q / f"predict_{short}.yaml"),
                         f"prediction.data={q / f'pred_{short}.zarr'}"])
                score(f"quick_{short}_evaluate", q / f"pred_{short}.zarr", q / "data.zarr",
                      q_keys, 3, *(("--surface",) if short == "seg" else ()))
            t_quick = time.perf_counter() - t0
            for name, future in full.items():
                if future.result() != 0:
                    raise AssertionError(f"tools: demo of the {name} store failed")
            t_demos = time.perf_counter() - t0
            log(f"tools: quick start {t_quick:.1f} s; the 160^3 demo stores ready at "
                f"{t_demos:.1f} s")

            # b. full width: seg_brats_bf16 (f_maps 32) and landmarks.yaml (f_maps 64)
            b_keys = (b / "test.txt").read_text().split()
            l_keys = (lm / "test.txt").read_text().split()

            def train_argv(config, d, model):
                return ["-c", str(HERE / "configs" / config), "--data_path", str(d / "data.zarr"),
                        "--train_set", str(d / "train.txt"), "--val_set", str(d / "val.txt"),
                        "--model_dir", str(d / model), "--log_dir", str(d / model / "logs"),
                        "--max_epochs", "1"]

            def brats_argv(source, out):
                return ["-c", str(HERE / "configs" / "predict.yaml"),
                        f"base.data={b / 'data.zarr'}", f"prediction.test_set={b / 'test.txt'}",
                        f"prediction.checkpoint={source}", f"prediction.data={out}",
                        "prediction.stitch=device"]

            def ldmk_argv(source, out):
                return ["-c", str(HERE / "configs" / "predict.yaml"),
                        f"base.data={lm / 'data.zarr'}", "base.sigma=[4, 4, 4]",
                        f"prediction.test_set={lm / 'test.txt'}",
                        f"prediction.checkpoint={source}", f"prediction.data={out}",
                        "prediction.model=LandmarkNet", "prediction.stitch=device",
                        f"prediction.landmarks={out.with_suffix('.json')}"]

            rec.cli("brats_train", train_seg.main, train_argv("seg_brats_bf16.yaml", b, "model"))
            rec.cli("brats_predict", predict.main, brats_argv(b / "model", b / "pred.zarr"))
            score("brats_evaluate", b / "pred.zarr", b / "data.zarr", b_keys, 4,
                  "--classes", "4", "--surface")
            rec.cli("ldmk_train", train_ldmks.main, train_argv("landmarks.yaml", lm, "model"))
            rec.cli("ldmk_predict", predict.main, ldmk_argv(lm / "model", lm / "pred.zarr"))
            score("ldmk_evaluate", lm / "pred.zarr", lm / "data.zarr", l_keys, 2)
            readout = json.loads((lm / "pred.json").read_text())
            if sorted(readout) != sorted(l_keys) or any(
                    len(v) != LDMK_HEATMAPS for v in readout.values()):
                raise AssertionError(f"tools: landmark readout {readout}")
            gc.collect()
            torch.cuda.empty_cache()

            # c. the interop round trip on both full-width checkpoints
            images = {}
            for d, keys in ((b, b_keys), (lm, l_keys)):
                with ZarrReader(d / "data.zarr") as r:
                    images.update({(d.name, k): v for k, v in
                                   zip(keys, r.read(keys, "images", np.float16))})
            trips = {}
            for name, d, argv, keys, nh in (("brats", b, brats_argv, b_keys, 0),
                                            ("ldmk", lm, ldmk_argv, l_keys, LDMK_HEATMAPS)):
                trips[name] = tools_round_trip(
                    torch, gn, P, grid_corners, dev, rec, name, d / "model", argv, keys,
                    {k: images[d.name, k] for k in keys}, nh)
                gc.collect()
                torch.cuda.empty_cache()
            if trips["ldmk"]["params"] != LDMK_PARAMS:
                raise AssertionError(f"tools: the landmark model has {trips['ldmk']['params']} "
                                     f"parameters, not {LDMK_PARAMS}")
            brats_params = sum(p.numel() for p in ResidualUNet3D(
                4, 4, f_maps=32, device="meta").parameters())
            if trips["brats"]["params"] != brats_params:
                raise AssertionError(f"tools: the seg_brats_bf16 model has "
                                     f"{trips['brats']['params']} parameters, not {brats_params}")

            # d. pack and stats on a small NIfTI demo; evaluate of a NIfTI prediction
            rec.cli("nii_demo", demo.main, ["--out", str(nii), "--format", "nii",
                                            *TOOLS_NII_DEMO, "--log_level", "WARNING"])
            rec.cli("nii_pack", pack.main, ["--src", str(nii / "data.nii"),
                                            "--dst", str(nii / "data.zarr"),
                                            "--log_level", "WARNING"])
            got_stats = {}
            for src in ("data.nii", "data.zarr"):
                text = io.StringIO()
                with contextlib.redirect_stdout(text):
                    rec.cli(f"stats_{src}", stats.main,
                            ["--data", str(nii / src), "--heatmap_group", "heatmaps",
                             "--json", str(nii / f"{src}.json"), "--log_level", "WARNING"])
                got_stats[src] = json.loads((nii / f"{src}.json").read_text())
                got_stats[src].pop("data")
            if got_stats["data.nii"] != got_stats["data.zarr"]:
                raise AssertionError(f"tools: stats differ on the packed store: {got_stats}")
            rec.cli("pred_pack", pack.main, ["--src", str(q / "pred_seg.zarr"),
                                             "--dst", str(q / "pred_seg.nii"),
                                             "--log_level", "WARNING"])
            score("quick_seg_evaluate_nii", q / "pred_seg.nii", q / "data.zarr", q_keys, 3,
                  "--surface")
            a, c = (json.dumps({k: v for k, v in evals[t].items() if k != "pred"}, sort_keys=True)
                    for t in ("quick_seg_evaluate", "quick_seg_evaluate_nii"))
            if a != c:
                raise AssertionError("tools: evaluate of the NIfTI prediction differs from zarr")
            log(f"tools: pack nii -> zarr: stats --json equal on both stores "
                f"({got_stats['data.zarr']['images']['subjects']} subjects, "
                f"{got_stats['data.zarr']['labels']['classes']} classes); evaluate of the "
                "NIfTI prediction directory equal to the zarr one")
            counts = launch_counts(gn, P)

    # e. exact launches: K1 backward 27 a training step (the host sampler
    # gathers no window on the card); K1 forward 27 and K2 1 a predict batch
    per_run = rec.per_run(counts)
    quick_batches = stitch_batches("device", [(DEMO_SIZE,) * 3] * 2, QUICK_GEOMETRY)
    full_batches = stitch_batches("device", [(FULL_SIZE,) * 3] * 2)
    expected = {}
    for tag in per_run:
        if tag.endswith("_train"):
            steps = dict(quick_seg_train=QUICK_STEPS, quick_ldmks_train=QUICK_STEPS,
                         brats_train=TOOLS_BRATS_STEPS, ldmk_train=TOOLS_LDMK_STEPS)[tag]
            expected[tag] = dict(gn_bwd_reduce=27 * steps, gn_bwd_apply=27 * steps,
                                 gather_patches=0)
        elif "_predict" in tag:
            n_b = quick_batches if tag.startswith("quick") else full_batches
            expected[tag] = dict(gn_moments=27 * n_b, gn_apply=27 * n_b, gn_bwd_reduce=0,
                                 gn_bwd_apply=0, gather_patches=n_b)
        else:  # the host tools
            expected[tag] = dict.fromkeys(counts, 0)
    for tag, want in expected.items():
        c = per_run[tag]
        if any(c[k] != v for k, v in want.items()) or c["gn_moments"] != c["gn_apply"]:
            raise AssertionError(f"tools: {tag} launched {c}, expected {want}")
    seconds = time.perf_counter() - t0
    log(f"tools: launches {counts}: K1 backward 27 a training step "
        f"({QUICK_STEPS}, {QUICK_STEPS}, {TOOLS_BRATS_STEPS}, {TOOLS_LDMK_STEPS} steps), K1 "
        f"forward 27 and K2 1 a predict batch ({quick_batches} batches a quick-start call, "
        f"{full_batches} a full-width one), none in the host tools; {seconds:.1f} s")
    return counts, dict(scores=scores, round_trip=trips, per_run=per_run,
                        cli_seconds=rec.walls, stitches=rec.stitches,
                        quick_start_seconds=t_quick, demo_stores_ready_seconds=t_demos,
                        seconds=seconds)


def tools_phase(torch, gn, P, grid_corners, dev, gen) -> dict:
    log_clocks("tools")
    counts, tools = run_tools(torch, gn, P, grid_corners, dev)
    return dict(counts=counts, tools=tools)


# -- deploy: the native batch loader, serving export, the profiler hook ------

DEPLOY_SEG_EPOCHS, DEPLOY_LDMK_EPOCHS = 2, 1
DEPLOY_PROFILED = {("native", 1), ("numpy", 1)}
DEPLOY_FLIPS = (0, 2)              # the landmark artifact's baked-in TTA
DEPLOY_REPS, DEPLOY_WARMUP = 12, 3  # timed calls per turn (eager/artifact/artifact/eager),
                                   # after warm-up calls
DEPLOY_TOP = 8                     # device rows kept of each route's profiled call
PROFILE_STEPS, PROFILE_RUN_STEPS = 2, 4
DISPATCH_CALLS = 2000              # host-timed calls per turn of the dispatcher probe
DISPATCH_SHAPE = (1, 32, 8, 8, 8)  # small: the loop is host-bound
K1_TRACE_NAME = "gn_moments_kernel"  # K1's statistics kernel in a profiler trace
SERVE_CHILD = r'''
import json, sys
import numpy as np
import torch
import tpu_mednet_torch.ops
from tpu_mednet_torch.ops import groupnorm as gn

spec = json.loads(sys.argv[1])
dev = torch.device("cuda", 0)
tiles = np.random.default_rng(spec["seed"]).normal(
    size=(spec["tiles"], *spec["patch"], 1)).astype(np.float32)
out = {}
for name, path in spec["artifacts"].items():
    prog = torch.export.load(path).module()
    out[name] = {}
    for n in (spec["tiles"], 1):
        x = torch.from_numpy(tiles[:n]).to(dev)
        before = [gn.STATS_LAUNCHES, gn.APPLY_LAUNCHES, gn.BWD_REDUCE_LAUNCHES,
                  gn.BWD_APPLY_LAUNCHES]
        with torch.no_grad():
            y = prog(x)
        torch.cuda.synchronize()
        after = [gn.STATS_LAUNCHES, gn.APPLY_LAUNCHES, gn.BWD_REDUCE_LAUNCHES,
                 gn.BWD_APPLY_LAUNCHES]
        np.save(f"{spec['dir']}/{name}_{n}.npy", y.cpu().numpy())
        out[name][str(n)] = [a - b for a, b in zip(after, before)]
out["modules"] = sorted(m for m in sys.modules
                        if m.split(".")[0] in ("tpu_mednet_torch", "tpu_mednet", "jax"))
print(json.dumps(out))
'''


@contextlib.contextmanager
def uncounted(gn, P):
    """Launches inside the block (comparisons, probes) leave the counters as
    they were."""
    saved = launch_counts(gn, P)
    try:
        yield
    finally:
        gn.STATS_LAUNCHES, gn.APPLY_LAUNCHES = saved["gn_moments"], saved["gn_apply"]
        gn.BWD_REDUCE_LAUNCHES = saved["gn_bwd_reduce"]
        gn.BWD_APPLY_LAUNCHES = saved["gn_bwd_apply"]
        P.LAUNCHES = saved["gather_patches"]


def device_checksum(torch, t) -> int:
    """Checksum of a batch tensor's bytes, computed on the card: its
    (N, X, Y, Z, C) words (fp32 bits or uint8 values) weighted by position."""
    raw = t.permute(0, 2, 3, 4, 1).contiguous().view(-1)
    words = (raw.view(torch.int32) if raw.dtype == torch.float32 else raw).to(torch.int64)
    weights = torch.arange(words.numel(), device=t.device, dtype=torch.int64) % 65521 + 1
    return int((words * weights).sum())


def check_native_batches(torch, dev, root):
    """One epoch of the seg_organ and the landmark training samplers, each
    batch through ``device_prefetch`` at the Trainer's ``BUFFER_SIZE``:
    the native pipeline (pinned pool) against the numpy sampler of the same
    seed, batch by batch, by a checksum computed on the card.  A pinned
    buffer reused before its copy ended would change the device bytes."""
    from tpu_mednet_torch import native
    from tpu_mednet_torch.data import PatchSampler
    from tpu_mednet_torch.data.native_loader import NativeBatchPipeline
    from tpu_mednet_torch.data.prefetch import BUFFER_SIZE, device_prefetch

    out = {}
    for name, store, keys, patch, batch, heatmaps, probs in (
            ("seg_organ", "organs.zarr", ORGAN_SPLITS["train"], ORGAN_PATCH, ORGAN_BATCH,
             None, [0.2] * ORGAN_CLASSES),
            ("landmarks", "landmarks.zarr", LDMK_SPLITS["train"], PATCH, LDMK_BATCH,
             "heatmaps", None)):
        def sampler():
            return PatchSampler(str(root / store), keys, 10, patch, heatmap_group=heatmaps,
                                class_probabilities=probs, seed=0)

        before = native.ASSEMBLE_CALLS
        t = time.perf_counter()
        pipe = NativeBatchPipeline(sampler(), pinned=True)
        n, sums = 0, []
        for a, b in zip(device_prefetch(pipe.batches(batch), dev),
                        device_prefetch(sampler().batches(batch), dev)):
            for k in ("data", "label"):
                if a[k].shape != b[k].shape or a[k].device != dev:
                    raise AssertionError(f"deploy: {name} batch {n} {k}: {a[k].shape} "
                                         f"on {a[k].device} vs {b[k].shape}")
                pair = (device_checksum(torch, a[k]), device_checksum(torch, b[k]))
                if pair[0] != pair[1]:
                    raise AssertionError(f"deploy: {name} batch {n} {k}: native checksum "
                                         f"{pair[0]} vs numpy {pair[1]}")
                sums.append(pair[0])
            n += 1
        calls = native.ASSEMBLE_CALLS - before
        if n != len(keys) * 10 // batch or calls != n:
            raise AssertionError(f"deploy: {name}: {n} batches, {calls} native calls")
        out[name] = dict(batches=n, native_calls=calls, buffer_size=BUFFER_SIZE,
                         seconds=time.perf_counter() - t, label_channels=int(a["label"].shape[1]))
        log(f"deploy: native batches of {name}: {n} of {n} equal to the numpy sampler's by "
            f"a device checksum (data and labels, {out[name]['label_channels']} label "
            f"channels; BUFFER_SIZE {BUFFER_SIZE}) in {out[name]['seconds']:.2f} s")
    return out


def serving_band(torch, gn, P, task, x, flips):
    """The plain path's top-2 margin of the class logits (of the averaged
    class probabilities with ``flips``) on ``x`` (N, C, X, Y, Z), and max
    |kernel - plain| of the same values."""
    from tpu_mednet_torch.inference.common import tta_split_activations

    nh = getattr(task, "num_heatmaps", 0)

    def values():
        if flips:
            return tta_split_activations(task, x, flips)[:, nh:]
        return task.model(x.to(task.model.config.dtype))[:, nh:].float()

    with torch.no_grad():
        got = values()
        with plain_kernels(gn, P):
            ref = values()
    top2 = ref.topk(2, dim=1).values
    return (top2[:, 0] - top2[:, 1]).cpu().numpy(), float((got - ref).abs().max())


def compare_serving(name, got, want, band):
    """uint8 (N, X, Y, Z, C') ``got`` against ``want``: byte-equal, else
    heatmaps within 1 and class maps apart only inside the tie band."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"deploy: {name}: {got.shape} {got.dtype} vs {want.shape} "
                             f"{want.dtype}")
    if np.array_equal(got, want):
        return "byte-equal"
    margin, err = band
    differ = got[..., -1] != want[..., -1]
    outside = int((differ & (margin[:got.shape[0]] > 2 * err)).sum())
    hm = int(np.abs(got[..., :-1].astype(np.int16) - want[..., :-1].astype(np.int16))
             .max(initial=0))
    log(f"deploy: {name}: class maps differ on {float(differ.mean()):.6f} of voxels, outside "
        f"the tie band on {outside}; heatmaps max |diff| {hm}")
    if outside or hm > 1:
        raise AssertionError(f"deploy: {name}: outside the tie band")
    return "tie band"


def export_and_serve(torch, gn, P, dev, root, seg_dir, ldmk_dir):
    """(b) ``export_serving.main(argv)`` on the two checkpoints the phase
    wrote (seg_organ symbolic; landmarks.yaml with ``--tta 0 2``; seg_organ
    pinned to ``BATCH``), each ``.pt2`` loaded and called in a fresh child
    that imports ``torch`` and ``tpu_mednet_torch.ops`` only (8 tiles of
    96^3 and 1), against the eager ``make_serving_fn`` of the same weights;
    K1 launches per call; the artifact's and the eager function's ms per
    8-tile call in this process, in turns."""
    from types import SimpleNamespace

    from tpu_mednet_torch.cli import export_serving
    from tpu_mednet_torch.cli.predict import _coerce
    from tpu_mednet_torch.inference import serving
    from tpu_mednet_torch.tasks import LandmarkTask, SegmentationTask
    from tpu_mednet_torch.train import load_for_inference

    specs = {"seg": (seg_dir, (), ()), "ldmk": (ldmk_dir, DEPLOY_FLIPS,
                                                ("--tta", *map(str, DEPLOY_FLIPS))),
             "seg_pinned": (seg_dir, (), ("--batch_size", str(BATCH)))}
    paths, exports = {}, {}
    for name, (ckpt, _, extra) in specs.items():
        paths[name] = root / f"{name}.pt2"
        t = time.perf_counter()
        rc = export_serving.main(["--checkpoint", str(ckpt), "--out", str(paths[name]),
                                  "--patch_size", *map(str, PATCH), "--log_level", "WARNING",
                                  *extra])
        if rc != 0:
            raise AssertionError(f"deploy: export {name} exited with {rc}")
        exports[name] = dict(seconds=time.perf_counter() - t,
                             bytes=paths[name].stat().st_size)
        log(f"deploy: export_serving {name}: {exports[name]['seconds']:.2f} s, "
            f"{exports[name]['bytes'] / 2**20:.1f} MiB .pt2")

    # a fresh process: torch and the op registration only
    t = time.perf_counter()
    spec = dict(artifacts={k: str(paths[k]) for k in ("seg", "ldmk")}, seed=0, tiles=BATCH,
                patch=list(PATCH), dir=str(root))
    proc = subprocess.run([sys.executable, "-c", SERVE_CHILD, json.dumps(spec)], cwd=HERE,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"deploy: the serving child failed:\n{proc.stderr[-4000:]}")
    child = json.loads(proc.stdout.splitlines()[-1])
    child_seconds = time.perf_counter() - t
    banned = [m for m in child["modules"] if m.split(".")[0] in ("jax", "tpu_mednet")
              or m.split(".")[1:2] and m.split(".")[1] in ("models", "tasks", "train",
                                                             "inference")]
    if banned:
        raise AssertionError(f"deploy: loading the artifacts imported {banned}")
    log(f"deploy: serving child ({child_seconds:.1f} s) loaded both .pt2 with modules "
        f"{child['modules']}")

    tiles = np.random.default_rng(0).normal(size=(BATCH, *PATCH, 1)).astype(np.float32)
    x = torch.from_numpy(tiles).to(dev)
    out = dict(exports=exports, child_seconds=child_seconds)
    child_counts = dict.fromkeys(("gn_moments", "gn_apply", "gn_bwd_reduce", "gn_bwd_apply",
                                  "gather_patches"), 0)
    for name in ("seg", "ldmk"):
        ckpt, flips, _ = specs[name]
        weights, hp = load_for_inference(ckpt)
        ns = SimpleNamespace(**{k: _coerce(v) for k, v in hp.items()})
        task = (LandmarkTask if name == "ldmk" else SegmentationTask).from_hparams(
            ns, device=dev)
        task.model.load_state_dict(weights)
        eager = serving.make_serving_fn(task, flips)
        forwards = 2 ** len(flips)
        for n, launched in child[name].items():
            if launched != [27 * forwards, 27 * forwards, 0, 0]:
                raise AssertionError(f"deploy: {name} artifact at N={n} launched K1 "
                                     f"{launched}, expected {27 * forwards} moments and "
                                     "apply, no backward")
            for key, v in zip(("gn_moments", "gn_apply", "gn_bwd_reduce", "gn_bwd_apply"),
                              launched):
                child_counts[key] += v
        artifact = serving.load_exported(paths[name]).module()
        with torch.no_grad(), uncounted(gn, P):
            want = eager(x).cpu().numpy()
            band = serving_band(torch, gn, P, task, x.permute(0, 4, 1, 2, 3), flips)
        held = {}
        for n in (BATCH, 1):
            got = np.load(root / f"{name}_{n}.npy")
            held[n] = compare_serving(f"{name} N={n}", got, want[:n], band)
        before = launch_counts(gn, P)
        with torch.no_grad():
            here = artifact(x).cpu().numpy()
        after = launch_counts(gn, P)
        if (after["gn_moments"] - before["gn_moments"] != 27 * forwards
                or after["gn_bwd_reduce"] != before["gn_bwd_reduce"]):
            raise AssertionError(f"deploy: {name} artifact launches {before} -> {after}")
        if not np.array_equal(here, np.load(root / f"{name}_{BATCH}.npy")):
            raise AssertionError(f"deploy: {name}: the artifact differs between processes")
        routes = dict(eager=lambda: eager(x), artifact=lambda: artifact(x))
        turns, memory = [], {}
        with torch.no_grad():
            for fn in ("eager", "artifact", "artifact", "eager"):
                torch.cuda.reset_peak_memory_stats(dev)
                stats0 = torch.cuda.memory_stats(dev)
                with uncounted(gn, P) if fn == "eager" else contextlib.nullcontext():
                    turns.append((fn, cuda_ms(routes[fn], DEPLOY_REPS, DEPLOY_WARMUP)))
                stats1 = torch.cuda.memory_stats(dev)
                mem = memory.setdefault(fn, dict(max_reserved=0, max_allocated=0,
                                                 device_allocs=0, alloc_retries=0))
                mem["max_reserved"] = max(mem["max_reserved"],
                                          torch.cuda.max_memory_reserved(dev))
                mem["max_allocated"] = max(mem["max_allocated"],
                                           torch.cuda.max_memory_allocated(dev))
                for key, stat in (("device_allocs", "num_device_alloc"),
                                  ("alloc_retries", "num_alloc_retries")):
                    mem[key] += stats1.get(stat, 0) - stats0.get(stat, 0)
            # one profiled call of each route: where the device time goes
            breakdown = {}
            with uncounted(gn, P):
                for fn, call in routes.items():
                    rows = sorted(device_rows(torch, call, 1), reverse=True)
                    breakdown[fn] = dict(device_ms=sum(r[0] for r in rows),
                                         records=sum(r[1] for r in rows),
                                         top=[list(r) for r in rows[:DEPLOY_TOP]])
        ms = {k: float(np.mean([v for f, v in turns if f == k])) for k in ("eager", "artifact")}
        margin_min = float(band[0].min())
        out[name] = dict(held={str(k): v for k, v in held.items()}, ms=ms, turns=turns,
                         memory=memory, breakdown=breakdown,
                         forwards=forwards, band_err=band[1], margin_min=margin_min,
                         launches_per_call=27 * forwards,
                         heatmaps=int(getattr(task, "num_heatmaps", 0)),
                         params=sum(p.numel() for p in task.model.parameters()))
        log(f"deploy: {name} artifact ({out[name]['params']} parameters, {forwards} "
            f"forward(s) a call): N={BATCH} {held[BATCH]}, N=1 {held[1]} to the eager "
            f"function; K1 {27 * forwards} moments + {27 * forwards} apply a call, no "
            f"backward; ms per {BATCH} x 96^3 call: artifact {ms['artifact']:.2f}, eager "
            f"{ms['eager']:.2f} (turns {[round(v, 2) for _, v in turns]}, {DEPLOY_REPS} "
            f"calls each after {DEPLOY_WARMUP})")
        for fn in routes:
            log(f"deploy: {name} {fn}: peak reserved {memory[fn]['max_reserved'] / 2**30:.3f} "
                f"GiB, allocated {memory[fn]['max_allocated'] / 2**30:.3f} GiB, "
                f"{memory[fn]['device_allocs']} device allocations and "
                f"{memory[fn]['alloc_retries']} retries over its turns; one profiled call "
                f"{breakdown[fn]['device_ms']:.3f} ms of device time in "
                f"{breakdown[fn]['records']:g} records, top "
                f"{[(round(m, 3), c, k[:40]) for m, c, k in breakdown[fn]['top'][:4]]}")
        del task, eager, artifact, weights, routes
        torch.cuda.empty_cache()

    pinned = serving.load_exported(paths["seg_pinned"]).module()
    with torch.no_grad():
        if pinned(x).shape != (BATCH, *PATCH, 1):
            raise AssertionError("deploy: the pinned artifact's output shape")
        try:
            pinned(x[:1])
        except Exception as exc:  # torch's guard: the batch axis is pinned
            out["pinned_refusal"] = f"{type(exc).__name__}: {str(exc).splitlines()[0][:120]}"
        else:
            raise AssertionError(f"deploy: the artifact pinned to N={BATCH} ran at N=1")
    log(f"deploy: the artifact pinned to N={BATCH} refuses N=1 ({out['pinned_refusal']})")
    return out, child_counts


def profile_hook(torch, gn, dev, root):
    """(c) ``Trainer(profile_dir=...)`` over ``PROFILE_RUN_STEPS`` steps of
    the seg_organ model on the host sampler with ``profile_steps=2``: the
    trace file exists and names K1's kernels; the step losses equal an
    unprofiled run of the same seeds."""
    from types import SimpleNamespace

    from tpu_mednet_torch.data import PatchSampler
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.train import Trainer

    def fit(profile_dir):
        hp = SimpleNamespace(in_channels=1, out_channels=ORGAN_CLASSES, fmaps=32, bf16=True)
        task = SegmentationTask.from_hparams(hp, device=dev,
                                             generator=torch.Generator().manual_seed(0))
        sampler = PatchSampler(str(root / "organs.zarr"), ORGAN_SPLITS["train"], 10,
                               ORGAN_PATCH, class_probabilities=[0.2] * ORGAN_CLASSES, seed=0)
        trainer = Trainer(task, sampler, batch_size=ORGAN_BATCH, max_epochs=1,
                          limit_train_batches=PROFILE_RUN_STEPS, profile_dir=profile_dir,
                          profile_steps=PROFILE_STEPS)
        losses, step = [], trainer.train_step

        def recorded(state, arrays):
            state, metrics = step(state, arrays)
            losses.append(metrics["train_loss"])
            return state, metrics

        trainer.train_step = recorded
        trainer.fit()
        return [float(v) for v in losses]

    t = time.perf_counter()
    plain = fit(None)
    prof_dir = root / "profile"
    profiled = fit(str(prof_dir))
    files = sorted(prof_dir.iterdir())
    if len(files) != 1:
        raise AssertionError(f"deploy: profile_dir holds {files}")
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    kernels = sorted(n for n in names if "gn_moments" in n or "gn_apply" in n)
    steps = sum(e.get("name") == "tpu_mednet_torch.train.step" for e in events
                if e.get("ph") == "X")
    log(f"deploy: profiler hook: {files[0].name} ({files[0].stat().st_size / 2**20:.1f} MiB, "
        f"{len(events)} events, {steps} train_step spans) names K1 as {kernels}; "
        f"losses unprofiled {plain}, profiled {profiled}")
    if not any(K1_TRACE_NAME in k for k in kernels):
        raise AssertionError("deploy: the profiler trace names no K1 kernel")
    if profiled != plain:
        raise AssertionError("deploy: profiling changed the step losses")
    return dict(file=files[0].name, bytes=files[0].stat().st_size, events=len(events),
                train_step_spans=steps, k1_kernels=kernels, losses=plain,
                seconds=time.perf_counter() - t)


def dispatcher_cost(torch, gn, dev):
    """Host microseconds per K1 forward call through the custom op and
    through its wrapper called directly (as ``GroupNormFunction`` does in
    training), at a small shape (the loop is host-bound), in turns
    op/direct/direct/op; the difference is the dispatcher's added host time
    per call, which only the no-grad route (serving, export) pays."""
    x = torch.randn(DISPATCH_SHAPE, device=dev, dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last_3d)
    c = DISPATCH_SHAPE[1]
    w, b = torch.ones(c, device=dev), torch.zeros(c, device=dev)
    mean, mul, _ = gn.group_norm_moments(x, GROUPS, w, 1e-5)
    calls = dict(
        moments_op=lambda: torch.ops.tpu_mednet_torch.gn_moments(x, GROUPS, w, 1e-5),
        moments_direct=lambda: gn.group_norm_moments(x, GROUPS, w, 1e-5),
        apply_op=lambda: torch.ops.tpu_mednet_torch.gn_apply(x, mean, mul, b, None, "e"),
        apply_direct=lambda: gn.group_norm_apply(x, mean, mul, b, None, "e"),
        group_norm=lambda: gn.group_norm(x, GROUPS, w, b, act="e"))

    def host_us(fn):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(DISPATCH_CALLS):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / DISPATCH_CALLS * 1e6

    us = {k: [] for k in calls}
    for kernel in ("moments", "apply"):
        for route in ("op", "direct", "direct", "op"):
            us[f"{kernel}_{route}"].append(host_us(calls[f"{kernel}_{route}"]))
    us["group_norm"].append(host_us(calls["group_norm"]))
    out = {k: float(np.mean(v)) for k, v in us.items()}
    out["moments_added"] = out["moments_op"] - out["moments_direct"]
    out["apply_added"] = out["apply_op"] - out["apply_direct"]
    log(f"deploy: host us per K1 forward call at {DISPATCH_SHAPE} bf16 ({DISPATCH_CALLS} "
        f"calls a turn): moments op {out['moments_op']:.2f} vs direct "
        f"{out['moments_direct']:.2f} (+{out['moments_added']:.2f}), apply op "
        f"{out['apply_op']:.2f} vs direct {out['apply_direct']:.2f} "
        f"(+{out['apply_added']:.2f}); group_norm (both, no grad) {out['group_norm']:.2f}")
    return out


def run_deploy(torch, gn, P, dev):
    """The deploy slice, launches counted from 0: (a) the native batch
    loader (``check_native_batches``; ``train_seg -c configs/seg_organ.yaml``
    2 epochs under the default, auto -> native, then under
    ``--no_native_loader``, and ``train_ldmks -c configs/landmarks.yaml`` 1
    epoch, through ``main(argv)``: native calls equal to the batches drawn,
    none without it, step 0's loss bit-equal across the routes, K1's
    launches exact); (b) serving export (``export_and_serve``); (c) the
    profiler hook (``profile_hook``); then the dispatcher's host cost, not
    counted."""
    import tempfile

    from tpu_mednet_torch import native
    from tpu_mednet_torch.cli import train_ldmks, train_seg
    from tpu_mednet_torch.train import Trainer

    rec = CliRecorder(torch, gn, P, DEPLOY_PROFILED, lambda tag, sampler: False, "deploy")
    drawn, calls = {}, {}

    def counted(orig):
        def _batches(self, sampler, shuffle):
            for batch in orig(self, sampler, shuffle):
                drawn[rec.tag] = drawn.get(rec.tag, 0) + 1
                yield batch
        return _batches

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_deploy_") as tmp:
        root = Path(tmp)
        write_organ_store(root)
        write_landmark_store(root)
        log(f"deploy: seeded organ and landmark stores in {time.perf_counter() - t0:.1f} s")
        batches = check_native_batches(torch, dev, root)

        reset_counts(gn, P)
        with rec.wrappers(), wrapped(Trainer, "_batches", counted):
            for tag, main, argv in (
                    ("native", train_seg.main, organ_train_argv(
                        root, "seg_native", "--max_epochs", str(DEPLOY_SEG_EPOCHS))),
                    ("numpy", train_seg.main, organ_train_argv(
                        root, "seg_numpy", "--max_epochs", str(DEPLOY_SEG_EPOCHS),
                        "--no_native_loader")),
                    ("ldmk", train_ldmks.main, ldmk_train_argv(
                        root, "ldmk", DEPLOY_LDMK_EPOCHS))):
                before = native.ASSEMBLE_CALLS
                rec.cli(tag, main, argv)
                calls[tag] = native.ASSEMBLE_CALLS - before
        train_counts = launch_counts(gn, P)
        per_run = rec.per_run(train_counts)
        steps = dict(native=ORGAN_STEPS_PER_EPOCH * DEPLOY_SEG_EPOCHS,
                     numpy=ORGAN_STEPS_PER_EPOCH * DEPLOY_SEG_EPOCHS,
                     ldmk=LDMK_STEPS_PER_EPOCH * DEPLOY_LDMK_EPOCHS)
        for tag, c in per_run.items():
            if (c["gn_bwd_reduce"] != 27 * steps[tag] or c["gn_bwd_apply"] != 27 * steps[tag]
                    or c["gn_moments"] != c["gn_apply"] or c["gather_patches"]):
                raise AssertionError(f"deploy: {tag} launched {c}, expected 27 K1 backward "
                                     f"launches a step over {steps[tag]} steps, no K2")
        log(f"deploy: native calls by run {calls}, batches drawn {drawn}")
        if calls["native"] != drawn["native"] or calls["ldmk"] != drawn["ldmk"] \
                or calls["numpy"] != 0:
            raise AssertionError(f"deploy: native calls {calls} against batches {drawn}")
        metrics = {tag: read_metrics(root / d / "logs" / "metrics.jsonl") for tag, d in (
            ("native", "seg_native"), ("numpy", "seg_numpy"), ("ldmk", "ldmk"))}
        first = {tag: next(r["train_loss"] for r in m if "train_loss" in r)
                 for tag, m in metrics.items()}
        pps = {tag: [r["patches_per_sec"] for r in m if "patches_per_sec" in r]
               for tag, m in metrics.items()}
        idle = {tag: p["idle_share"] for tag, p in rec.profiles.items()}
        log(f"deploy: step 0 loss native {first['native']!r}, numpy {first['numpy']!r}; "
            f"patches/s by epoch {pps}; idle share of epoch 1 {idle} (kept "
            f"{ {t: p['profiler_kept'] for t, p in rec.profiles.items()} })")
        if first["native"] != first["numpy"]:
            raise AssertionError("deploy: step 0's loss differs between the native and the "
                                 "numpy route")

        serve, child_counts = export_and_serve(torch, gn, P, dev, root, root / "seg_native",
                                               root / "ldmk")
        prof = profile_hook(torch, gn, dev, root)
        counts = launch_counts(gn, P)
        with uncounted(gn, P):
            dispatch = dispatcher_cost(torch, gn, dev)
    for k, v in child_counts.items():
        counts[k] += v
    if counts["gather_patches"]:
        raise AssertionError(f"deploy: K2 launched {counts['gather_patches']} times")
    seconds = time.perf_counter() - t0
    log(f"deploy: launches {counts} (the serving child's {child_counts} included); the phase "
        f"in {seconds:.1f} s")
    return counts, dict(batches=batches, native_calls=calls, drawn=drawn, per_run=per_run,
                        step0_loss=first, patches_per_s=pps, idle_share=idle,
                        profiles=rec.profiles, walls=rec.walls, serving=serve, profile=prof,
                        dispatcher_us=dispatch, seconds=seconds)


def deploy_phase(torch, gn, P, grid_corners, dev, gen) -> dict:
    log_clocks("deploy")
    counts, deploy = run_deploy(torch, gn, P, dev)
    return dict(counts=counts, deploy=deploy)


# -- the UNet3D phase --------------------------------------------------------------

def u3_model(torch, dev, order, out_channels=U3_CLASSES):
    """``UNet3D(1, out_channels)`` at its defaults in ``order``, bf16,
    seeded weights."""
    from tpu_mednet_torch.models import UNet3D

    return UNet3D(1, out_channels, layer_order=order, dtype=torch.bfloat16, device=dev,
                  generator=torch.Generator().manual_seed(0))


def check_gn_case(torch, gn, dev, gen, c, groups, e, batch, dt_name, reps=5):
    """K1's four kernels at one GroupNorm shape of the ``gcr`` order (no
    fused nonlinearity, no residual: the convolution follows the
    GroupNorm): moments to rtol 1e-5, apply within one ulp, the backward
    within ``backward_errors``' bounds, each bitwise equal from call to
    call; device ms per call of each kernel beside its bound, its plain
    version and the PyTorch call of the same function."""
    import torch.nn.functional as F

    dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dt_name]
    shape = (batch, e, e, e, c)
    x = (torch.randn(shape, generator=gen, device=dev) + 0.5).to(dtype).permute(0, 4, 1, 2, 3)
    dy = torch.randn(shape, generator=gen, device=dev).to(dtype).permute(0, 4, 1, 2, 3)
    w = torch.rand(c, generator=gen, device=dev) + 0.5
    b = torch.rand(c, generator=gen, device=dev) - 0.5
    tag = f"K1 C={c} groups={groups} {dt_name} {tuple(x.shape)}"
    moments = lambda: gn.group_norm_moments(x, groups, w, 1e-5)
    stats, again = moments(), moments()
    plain = gn.group_norm_moments_plain(x, groups, w, 1e-5)
    for got, ref in zip(stats, plain):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=0)
    apply = lambda: gn.group_norm_apply(x, stats.mean, stats.mul, b)
    y, y2 = apply(), apply()
    y_p = gn.group_norm_apply_plain(x, stats.mean, stats.mul, b)
    diff = (y.float() - y_p.float()).abs()
    tol = torch.full_like(diff, 1e-5) if dtype == torch.float32 else bf16_ulp(y_p)
    bwd = lambda: gn.group_norm_backward(x, dy, stats.mean, stats.rstd, w, b, groups)
    grads, grads2 = bwd(), bwd()
    errs, ok = backward_errors(torch, grads, gn.group_norm_backward_plain(
        x, dy, stats.mean, stats.rstd, w, b, groups))
    repeat = (all(torch.equal(u, v) for u, v in zip(stats, again)) and torch.equal(y, y2)
              and all(u is None or torch.equal(u, v) for u, v in zip(grads, grads2)))
    if not (bool((diff <= tol).all()) and ok and repeat):
        raise AssertionError(f"{tag}: apply max|err| {float(diff.max())}, backward {errs}, "
                             f"bitwise repeatable {repeat}")
    m_err = max(float((u - v).abs().max()) for u, v in zip(stats, plain))
    del again, y2, grads, grads2, plain, y_p, diff, tol
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = gn.plan_moments(batch, e**3, c, x.element_size(), x.data_ptr() % 16 == 0, sms)
    route = gn.plan_apply(batch, e**3, c, x.element_size(), x.data_ptr() % 16 == 0, sms).route
    reduce_route = gn.reduce_plan(x, dy, act=None).route
    reduce_text = reduce_plan_text(gn, x, dy, None, groups, None)
    n_el, esz = x.numel(), x.element_size()
    t = {name: kernel_ms(torch, fn, name, reps=reps)[:2] for name, fn in (
        ("gn_moments", moments), ("gn_apply", apply), ("gn_bwd_reduce", bwd),
        ("gn_bwd_apply", bwd))}
    small = 6 * batch * c * 4 + 2 * c * 4
    out = dict(
        c=c, groups=groups, extent=e, batch=batch, dtype=dt_name, moments_route=plan.route,
        apply_route=route, reduce_route=reduce_route,
        blocks_per_sample=plan.blocks, moments_err=m_err, apply_err=float(
            (y.float() - gn.group_norm_apply_plain(x, stats.mean, stats.mul, b).float())
            .abs().max()), bwd_err=max(errs.values()),
        moments_ms=t["gn_moments"][0], apply_ms=t["gn_apply"][0],
        reduce_ms=t["gn_bwd_reduce"][0], bwd_apply_ms=t["gn_bwd_apply"][0],
        kept=min(k for _, k in t.values()),
        moments_bound=bound_ms(n_el * esz + 3 * batch * c * 4 + c * 4, 3 * n_el),
        apply_bound=bound_ms(2 * n_el * esz + (2 * batch * c + c) * 4, 3 * n_el),
        reduce_bound=bound_ms(2 * n_el * esz + small, 12 * n_el),
        bwd_apply_bound=bound_ms(3 * n_el * esz + small, 14 * n_el),
        moments_plain_ms=cuda_ms(lambda: gn.group_norm_moments_plain(x, groups, w, 1e-5),
                                 reps=2, warmup=1),
        apply_plain_ms=cuda_ms(lambda: gn.group_norm_apply_plain(x, stats.mean, stats.mul, b),
                               reps=2, warmup=1),
        bwd_plain_ms=cuda_ms(lambda: gn.group_norm_backward_plain(
            x, dy, stats.mean, stats.rstd, w, b, groups), reps=2, warmup=1),
        moments_library_ms=cuda_ms(lambda: torch.var_mean(x, dim=(2, 3, 4), correction=0),
                                   reps=5),
        library_ms=cuda_ms(lambda: F.group_norm(x, groups, w.to(dtype), b.to(dtype), 1e-5),
                           reps=5))
    xg = x.detach().requires_grad_()
    wg = w.to(dtype, copy=True).requires_grad_()
    bg = b.to(dtype, copy=True).requires_grad_()
    yl = F.group_norm(xg, groups, wg, bg, 1e-5)
    out["bwd_library_ms"] = cuda_ms(lambda: torch.autograd.grad(yl, (xg, wg, bg), dy,
                                                                retain_graph=True),
                                    reps=2, warmup=1)
    before = GRID_STRIDE_U3_APPLY.get((c, e), (None, None)) \
        if (batch, dt_name) == (U3_BATCH, "bf16") else (None, None)
    first = FIRST_REDUCE_U3.get((c, e)) if (batch, dt_name) == (U3_BATCH, "bf16") else None
    register = REGISTER_MOMENTS_U3.get((c, e)) if (batch, dt_name) == (U3_BATCH, "bf16") \
        else None
    log(f"{tag}: moments route {plan.route} {plan.blocks} blocks/sample, apply route {route}; "
        f"moments {out['moments_ms']:.4f} ms device (bound {out['moments_bound']:.4f}, plain "
        f"{out['moments_plain_ms']:.4f}, torch.var_mean {out['moments_library_ms']:.4f}; "
        f"register path {register or 'not recorded'}), apply "
        f"{out['apply_ms']:.4f} (bound {out['apply_bound']:.4f}, plain "
        f"{out['apply_plain_ms']:.4f}, F.group_norm {out['library_ms']:.4f}), backward reduce "
        f"({reduce_text}) {out['reduce_ms']:.4f} (bound {out['reduce_bound']:.4f}; first "
        f"design {first or 'not recorded'}) and apply "
        f"{out['bwd_apply_ms']:.4f} (bound {out['bwd_apply_bound']:.4f}; plain "
        f"{out['bwd_plain_ms']:.4f}, F.group_norm autograd {out['bwd_library_ms']:.4f}); "
        f"grid-stride design's apply {before[0] or 'not recorded'}, backward apply "
        f"{before[1] or 'not recorded'}; "
        f"profiler kept {out['kept']:g}; max|err| moments {m_err:.3g}, apply "
        f"{out['apply_err']:.3g}, backward {out['bwd_err']:.3g}; bitwise repeatable")
    return out


def u3_gn(torch, gn, dev, gen):
    """K1 at every GroupNorm shape of the ``gcr`` UNet3D's forward (bf16,
    batch 8 of 96^3: C = 1 in one group, the 192/384/768-channel
    concatenations), summed per forward and per step; then one channel a
    group beyond it (``U3_EXTRA_CASES``)."""
    cases = {}
    keys = ("moments_ms", "apply_ms", "reduce_ms", "bwd_apply_ms", "moments_bound",
            "apply_bound", "reduce_bound", "bwd_apply_bound", "moments_plain_ms",
            "apply_plain_ms", "bwd_plain_ms", "moments_library_ms", "library_ms",
            "bwd_library_ms")
    per = dict.fromkeys(keys, 0.0)
    per.update(kept=1.0, moments_err=0.0, apply_err=0.0, bwd_err=0.0)
    for c, groups, e, count in U3_GN_SHAPES:
        r = check_gn_case(torch, gn, dev, gen, c, groups, e, U3_BATCH, "bf16")
        cases[f"c{c}_e{e}_bf16"] = r
        for k in keys:
            per[k] += count * r[k]
        for k in ("moments_err", "apply_err", "bwd_err"):
            per[k] = max(per[k], r[k])
        per["kept"] = min(per["kept"], r["kept"])
        torch.cuda.empty_cache()
    n_gn = sum(n for *_, n in U3_GN_SHAPES)
    log(f"K1 per gcr UNet3D bf16 forward of batch {U3_BATCH} ({n_gn} GroupNorms): moments "
        f"{per['moments_ms']:.4f} ms device (bound {per['moments_bound']:.4f}), apply "
        f"{per['apply_ms']:.4f} (bound {per['apply_bound']:.4f}); per step, backward reduce "
        f"{per['reduce_ms']:.4f} (bound {per['reduce_bound']:.4f}), apply "
        f"{per['bwd_apply_ms']:.4f} (bound {per['bwd_apply_bound']:.4f}); the grid-stride "
        f"design's apply {GRID_STRIDE_U3_SUMS[0]} per forward, backward apply "
        f"{GRID_STRIDE_U3_SUMS[1]} per step; the reduce's first design "
        f"{FIRST_REDUCE_U3_SUM} per step")
    for name, c, groups, e, batch, dt in U3_EXTRA_CASES:
        cases[name] = check_gn_case(torch, gn, dev, gen, c, groups, e, batch, dt)
    # the one-channel input reads 16-byte vectors of 8 (bf16) or 4 (fp32)
    # rows in every kernel, the moments included
    for name in ("c1_e96_bf16", "c1_g1_fp32"):
        routes = [cases[name][k] for k in ("moments_route", "apply_route", "reduce_route")]
        if routes != ["packed"] * 3:
            raise AssertionError(f"K1 {name}: routes {routes}, not packed")
    return dict(per_forward=per, cases=cases, n_gn=n_gn)


def u3_parity(torch, gn, P, model, dev, gen):
    """One bf16 train step's loss and gradients, kernel path against plain
    path: the loss within ``PARITY_REL``, and every parameter's max |dg|
    within it times the model's largest max |g| (the residual model's
    check holds each against its own max; in the gcr order the input
    side's gradients are cancelling sums, the one-channel GroupNorm's scale
    3.5e-7 of the largest in fp32 and bf16 rounding noise at 1e-2 of it,
    which no bound on its own scale can hold).  Each parameter's ratio to
    its own max is printed beside it."""
    from tpu_mednet_torch.tasks import SegmentationTask

    x = torch.randn((PARITY_BATCH, 1, *PATCH), generator=gen, device=dev)
    label = torch.zeros((PARITY_BATCH, 1, *PATCH), dtype=torch.uint8, device=dev)
    label[:, :, 20:70, 30:80, 10:60] = 1
    label[:, :, 70:90, 30:80, 10:60] = 2
    x = x + label
    task = SegmentationTask(model=model, loss="DICE")
    model.train()

    def grads():
        model.zero_grad(set_to_none=True)
        loss, _ = task.loss_fn(model(x), {"label": label})
        loss.backward()
        return float(loss.detach()), {k: p.grad.float().clone()
                                      for k, p in model.named_parameters()}

    loss, g = grads()
    with plain_kernels(gn, P):
        loss_p, g_p = grads()
    model.zero_grad(set_to_none=True)
    top = max(float(v.abs().max()) for v in g_p.values())
    diff = {k: float((g[k] - g_p[k]).abs().max()) for k in g}
    own = {k: diff[k] / float(g_p[k].abs().max()) for k in g}
    worst = max(diff, key=diff.get)
    log(f"UNet3D gcr train parity bf16 batch {PARITY_BATCH}: loss kernel {loss:.6f} plain "
        f"{loss_p:.6f}; max over {len(diff)} parameters of max|dg| / the largest max|g| "
        f"({top:.3g}) {diff[worst] / top:.3g} ({worst}; bound {PARITY_REL['bf16']}); the "
        "largest ratios to their own max|g| " + ", ".join(
            f"{k} {own[k]:.3g}" for k in sorted(own, key=own.get)[-4:]))
    if abs(loss - loss_p) > PARITY_REL["bf16"] or diff[worst] > PARITY_REL["bf16"] * top:
        raise AssertionError("UNet3D train parity: kernel path disagrees with plain path")
    return dict(loss=loss, loss_plain=loss_p, worst_param=worst, worst_rel=diff[worst] / top,
                own_rel=own)


def u3_forward(torch, gn, P, model, dev, gen, counts):
    """The gcr model's bf16 forward of 8 x 96^3 in eval mode: kernel path
    against plain path (logits within ``FWD_BF16_REL``, argmax apart only
    inside the tie band), 14 moments and 14 apply launches, ms per forward
    and K1's share of its device time."""
    x = torch.randn((U3_BATCH, 1, *PATCH), generator=gen, device=dev)
    model.eval()
    with torch.inference_mode():
        before = launch_counts(gn, P)
        y = model(x)
        add_counts(counts, before, launch_counts(gn, P))
        per = {k: launch_counts(gn, P)[k] - before[k] for k in before}
        want = dict(gn_moments=14, gn_apply=14, gn_bwd_reduce=0, gn_bwd_apply=0,
                    gather_patches=0)
        if per != want:
            raise AssertionError(f"UNet3D forward launches {per}, expected {want}")
        with plain_kernels(gn, P):
            y_p = model(x)
            t_plain = cuda_ms(lambda: model(x), reps=2, warmup=1)
        t_fwd = cuda_ms(lambda: model(x), reps=5, warmup=1)
        err = float((y - y_p).abs().max())
        scale = float(y_p.abs().max())
        top2 = y_p.topk(2, dim=1).values
        margin = top2[:, 0] - top2[:, 1]
        flips = y.argmax(dim=1) != y_p.argmax(dim=1)
        outside = int((flips & (margin > 2 * err)).sum())
        rows, kept = profile_kept(torch, gn, lambda: model(x), 2)
    busy = sum(ms for ms, _, name in rows if not name.startswith(("Memcpy", "Memset")))
    k1 = sum(ms for ms, _, name in rows if "gn_" in name)
    conv = sum(ms for ms, _, name in rows if any(
        t in name.lower() for t in ("conv", "xmma", "gemm", "cudnn", "cutlass")))
    log(f"UNet3D gcr forward bf16 {tuple(y.shape)}: max|kernel - plain| {err:.3g} (bound "
        f"{FWD_BF16_REL} x max|logit| {scale:.3g}); argmax flips {float(flips.float().mean()):.6f}"
        f", outside the tie band {outside}; {t_fwd:.2f} ms per forward (plain path "
        f"{t_plain:.2f}); device {busy:.3f} ms: K1 {k1:.3f} ({100 * k1 / max(busy, 1e-9):.1f}%),"
        f" cuDNN {conv:.3f} ({100 * conv / max(busy, 1e-9):.1f}%); profiler kept {kept:g}")
    if not (torch.isfinite(y).all() and err <= FWD_BF16_REL * scale and not outside):
        raise AssertionError("UNet3D forward: kernel path disagrees with plain path")
    return dict(fwd_ms=t_fwd, fwd_plain_ms=t_plain, err=err, device_ms=busy, k1_ms=k1,
                cudnn_ms=conv, k1_share=k1 / max(busy, 1e-9), profiler_kept=kept)


def add_counts(total, before, after):
    for k in after:
        total[k] = total.get(k, 0) + after[k] - before[k]


def u3_training(torch, gn, P, dev, model, sampler, counts):
    """The gcr model's bf16 train step (Dice, Adam 1e-3, mirror flips) at
    batch 8 of 96^3 fed by ``DevicePatchSampler``: exact launches (14 of
    each K1 kernel and one indexed K2 a step), patches/s, peak reserved
    memory against the double branch of ``unet_train_peak_bytes``, device
    time by group, and a falling loss on one fixed batch."""
    from tpu_mednet_torch.ops.augment import AugmentConfig
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.train import create_train_state, make_train_step
    from tpu_mednet_torch.utils import memory

    task = SegmentationTask(model=model, loss="DICE")
    n_params = sum(p.numel() for p in model.parameters())
    state = create_train_state(model, learning_rate=1e-3, seed=0)
    step = make_train_step(task, augment=AugmentConfig(mirror_axes=(1, 2, 3)))
    feed = endless_batches(sampler, U3_BATCH)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    for _ in range(U3_WARMUP):
        state, _ = step(state, next(feed))
    before = launch_counts(gn, P)
    state, step_ms, losses = timed_steps(torch, step, state, feed, U3_STEPS)
    after = launch_counts(gn, P)
    add_counts(counts, before, after)
    per = {k: (after[k] - before[k]) / U3_STEPS for k in after}
    want = dict(gn_moments=14, gn_apply=14, gn_bwd_reduce=14, gn_bwd_apply=14,
                gather_patches=1)
    reserved = torch.cuda.max_memory_reserved(dev)
    est = memory.unet_train_peak_bytes(U3_BATCH, PATCH, model.config.feature_maps, 1,
                                       U3_CLASSES, n_params, block="double", remat=False)
    median = float(np.median(step_ms))
    rows, kept = profile_kept(torch, gn, lambda: step(state, next(feed)), 2)
    busy = sum(ms for ms, _, _ in rows)
    groups = step_groups(rows)
    fixed = next(feed)
    plain_step = make_train_step(task)
    fixed_losses = [float(plain_step(state, fixed)[1]["train_loss"])
                    for _ in range(U3_FIXED_STEPS)]
    log(f"UNet3D gcr training bf16 batch {U3_BATCH} of 96^3: steps "
        f"{' '.join(f'{t:.2f}' for t in step_ms)} ms; median {median:.2f} ms = "
        f"{U3_BATCH / median * 1e3:.2f} patches/s; launches per step {per}; "
        f"max_memory_reserved {reserved / 2**30:.3f} GiB, unet_train_peak_bytes "
        f"{est / 2**30:.3f} GiB (ratio {est / reserved:.3f}); losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}; device {busy:.3f} ms a step (profiler kept "
        f"{kept:g}): " + ", ".join(f"{g} {ms:.3f} ms ({100 * ms / max(busy, 1e-9):.1f}%)"
                                   for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
        + f"; fixed batch {' '.join(f'{v:.4f}' for v in fixed_losses)}")
    if per != want:
        raise AssertionError(f"UNet3D training launches per step {per}, expected {want}")
    if not (all(np.isfinite(losses + fixed_losses)) and fixed_losses[-1] < fixed_losses[0]):
        raise AssertionError("UNet3D training: a non-finite loss, or the loss on a fixed "
                             "batch did not fall")
    if not MEMORY_RATIO[0] <= est / reserved <= MEMORY_RATIO[1]:
        raise AssertionError(f"UNet3D training: estimate / reserved {est / reserved:.3f} "
                             f"outside {list(MEMORY_RATIO)}")
    return dict(patches_per_s=U3_BATCH / median * 1e3, step_ms=step_ms, losses=losses,
                fixed_batch_losses=fixed_losses, max_memory_reserved=reserved, estimate=est,
                ratio=est / reserved, device_ms_per_step=busy, groups=groups,
                idle_share=idle_share(busy, median, kept), profiler_kept=kept,
                launches_per_step=per)


def u3_stats(model):
    from tpu_mednet_torch.models.blocks import batch_stat_buffers

    return [t.detach().clone() for t in batch_stat_buffers(model)]


def u3_batchnorm(torch, gn, P, dev, counts):
    """The ``cbr`` model at the same width, training steps of batch 8 of
    96^3 (the device sampler's indexed K2 is the path's one kernel):
    running statistics of the kernel path against the plain path (another
    sampler of the same seed, cut by K2's plain version); remat 1 and all
    against remat 0 under deterministic cuDNN (bit-equal after one step:
    the recompute moves nothing; after three within the parity bound); a
    forced non-finite step under the guard leaves them bit-equal."""
    import dataclasses

    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.train import create_train_state, make_train_step

    def run(remat=False, plain=False, steps=U3_BN_STEPS):
        model = u3_model(torch, dev, "cbr")
        model.config = dataclasses.replace(model.config, remat=remat)
        state = create_train_state(model, learning_rate=1e-3, seed=0)
        step = make_train_step(SegmentationTask(model=model, loss="DICE"))
        feed = endless_batches(seeded_train_sampler(dev), U3_BATCH)
        stats, losses = [], []
        with plain_kernels(gn, P) if plain else contextlib.nullcontext():
            for _ in range(steps):
                before = launch_counts(gn, P)
                state, m = step(state, next(feed))
                if not plain:
                    add_counts(counts, before, launch_counts(gn, P))
                losses.append(float(m["train_loss"]))
                stats.append(u3_stats(model))
        return model, state, stats, losses

    def rel(a, b):
        return max(float((u - v).abs().max()) / max(float(v.abs().max()), 1e-30)
                   for u, v in zip(a, b))

    model, state, stats, losses = run()
    _, _, stats_p, losses_p = run(plain=True)
    kernel_vs_plain = rel(stats[-1], stats_p[-1])
    moved = max(float((u - v).abs().max())
                for u, v in zip(stats[-1], u3_stats(u3_model(torch, dev, "cbr"))))
    log(f"UNet3D cbr training bf16 batch {U3_BATCH}: losses {losses} (plain path {losses_p}); "
        f"running statistics after {U3_BN_STEPS} steps, kernel path vs plain path max "
        f"|diff| / max|plain| {kernel_vs_plain:.3g} (bound {PARITY_REL['bf16']}); max |moved| "
        f"from their init {moved:.3g}")
    if kernel_vs_plain > PARITY_REL["bf16"] or not moved > 0:
        raise AssertionError("UNet3D cbr: running statistics of the kernel path disagree")
    remat = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        ref = run()[2]
        for name, r in (("1", 1), ("all", True)):
            got = run(remat=r)[2]
            first = all(torch.equal(u, v) for u, v in zip(got[0], ref[0]))
            last = all(torch.equal(u, v) for u, v in zip(got[-1], ref[-1]))
            remat[name] = dict(first_step_bit_equal=first, last_step_bit_equal=last,
                               last_rel=rel(got[-1], ref[-1]))
            log(f"UNet3D cbr remat {name} vs 0 (deterministic cuDNN): running statistics "
                f"bit-equal after step 1 {first}, after step {U3_BN_STEPS} {last} (max rel "
                f"{remat[name]['last_rel']:.3g}, bound {PARITY_REL['bf16']})")
            if not first or remat[name]["last_rel"] > PARITY_REL["bf16"]:
                raise AssertionError(f"UNet3D cbr remat {name}: the running statistics "
                                     "moved otherwise than at remat 0")
    finally:
        torch.backends.cudnn.deterministic = deterministic
    guard_step = make_train_step(SegmentationTask(model=model, loss="DICE"),
                                 guard_nonfinite=True)
    bad = next(endless_batches(seeded_train_sampler(dev), U3_BATCH))
    bad["data"][0, 0, 0, 0, 0] = float("nan")
    before_stats, before_step = u3_stats(model), state.step
    state, m = guard_step(state, bad)
    held = all(torch.equal(u, v) for u, v in zip(u3_stats(model), before_stats))
    log(f"UNet3D cbr non-finite guard: nonfinite {float(m['nonfinite'])}, step "
        f"{before_step} -> {state.step}, running statistics bit-equal {held}")
    if not (float(m["nonfinite"]) == 1.0 and state.step == before_step and held):
        raise AssertionError("UNet3D cbr: a skipped step moved the running statistics")
    return model, dict(losses=losses, losses_plain=losses_p, kernel_vs_plain=kernel_vs_plain,
                       remat=remat, guard_held=held)


def u3_serving(torch, gn, P, models, grid_corners, dev, counts):
    """Both models in eval mode through ``predict_volumes_on_device``
    (``device``) and ``predict_volumes`` (``crop``) at the
    ``configs/predict.yaml`` geometry on two seeded 160^3 volumes: exact
    launches, class maps of the two stitches apart only inside the tie band
    (twice the kernel-vs-plain logit difference, at least ``U3_TIE_FLOOR``),
    volumes/min, and the device stitch's peak reserved memory against the
    HBM guard's estimate."""
    from tpu_mednet_torch.data import MemoryReader
    from tpu_mednet_torch.inference import predict_volumes, predict_volumes_on_device
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.utils import memory

    rng = np.random.default_rng(3)
    store, attrs = {"images": {}}, {"images": {}}
    for key in ("u0", "u1"):
        vol = rng.normal(0.0, 0.5, size=(1, *U3_VOLUME)).astype(np.float16)
        vol[0, 40:100, 50:110, 30:90] += 2.0
        store["images"][key] = vol
        attrs["images"][key] = {"affine": np.eye(4)}
    keys = list(store["images"])
    kw = dict(patch_size=list(PATCH), patch_overlap=list(OVERLAP), batch_size=BATCH, device=dev)
    # the device stitch batches each volume's tiles, the crop stitch the
    # stream of both volumes' tiles
    n_batches = dict(device=len(keys) * -(-n_tiles(U3_VOLUME) // BATCH),
                     crop=-(-len(keys) * n_tiles(U3_VOLUME) // BATCH))
    out = {}
    for order, model in models.items():
        task = SegmentationTask(model=model)
        fns = {"device": lambda: predict_volumes_on_device(
                   task, None, keys, reader=MemoryReader(store, attrs), **kw),
               "crop": lambda: predict_volumes(task, None, keys,
                                               reader=MemoryReader(store, attrs), **kw)}
        res, walls = {}, {}
        for stitch, fn in fns.items():
            fn()  # warm-up
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            before = launch_counts(gn, P)
            t0 = time.perf_counter()
            res[stitch] = fn()
            walls[stitch] = [time.perf_counter() - t0]
            after = launch_counts(gn, P)
            add_counts(counts, before, after)
            if stitch == "device":
                reserved = torch.cuda.max_memory_reserved(dev)
            per = {k: after[k] - before[k] for k in after}
            k1 = 14 * n_batches[stitch] if order == "gcr" else 0
            want = dict(gn_moments=k1, gn_apply=k1, gn_bwd_reduce=0, gn_bwd_apply=0,
                        gather_patches=n_batches[stitch] if stitch == "device" else 0)
            if per != want:
                raise AssertionError(f"UNet3D {order} {stitch}: launches {per}, expected {want}")
            for _ in range(2):
                before = launch_counts(gn, P)
                t0 = time.perf_counter()
                fn()
                walls[stitch].append(time.perf_counter() - t0)
                add_counts(counts, before, launch_counts(gn, P))
        est, _ = memory.device_stitch_bytes(U3_VOLUME, PATCH, OVERLAP, BATCH, 1, 1,
                                            model.config.feature_maps, stitch="device",
                                            params_bytes=memory.param_bytes(model),
                                            acc_channels=U3_CLASSES, block="double",
                                            layer_order=order)
        agreement = {}
        for key in keys:
            a, b = np.asarray(res["device"][key]), np.asarray(res["crop"][key])
            if a.shape != (1, *U3_VOLUME) or a.dtype != np.uint8 or a.max() >= U3_CLASSES:
                raise AssertionError(f"UNet3D {order} serving: bad mask {a.shape} {a.dtype}")
            with torch.inference_mode():
                margin, err = tie_band_margin(torch, gn, P, model, store["images"][key],
                                              grid_corners, dev)
            band = max(2 * err, U3_TIE_FLOOR)
            flips = a[0] != b[0]
            outside = int((flips & (margin > band)).sum())
            agreement[key] = float(1 - flips.mean())
            log(f"UNet3D {order} serving {key} {U3_VOLUME}: device and crop class maps "
                f"differ on {flips.mean():.6f} of voxels, outside the tie band ({band:.3g}) on "
                f"{outside}; max|kernel - plain| logit {err:.3g}")
            if outside:
                raise AssertionError(f"UNet3D {order} serving {key}: the stitches disagree "
                                     "outside the tie band")
        vpm = {s: len(keys) / float(np.median(w)) * 60.0 for s, w in walls.items()}
        out[order] = dict(volumes_per_min=vpm, seconds=walls, agreement=agreement,
                          device_reserved=reserved, guard_estimate=est,
                          guard_ratio=est / reserved, n_batches=n_batches)
        log(f"UNet3D {order} serving: volumes/min device {vpm['device']:.2f}, crop "
            f"{vpm['crop']:.2f} ({len(keys)} volumes a call, 3 calls each); the device "
            f"stitch's peak reserved {reserved / 2**30:.3f} GiB, the HBM guard's estimate "
            f"of one volume {est / 2**30:.3f} GiB (ratio {est / reserved:.3f}; its fit, "
            "chip_memory_fit.py --double-only, is of one volume alone in a process)")
    return out


def u3_trainer(torch, gn, P, dev, root, counts, serve_counts):
    """``Trainer.fit`` of ``SegmentationTask(model=UNet3D(1, 5, "cbr"))``
    from Python on the seeded organ store (host sampler, 96^3 patches,
    batch 4, 2 epochs), a ``--resume``-style restore of its last checkpoint
    into a fresh model (running statistics and weights bit-equal), and
    ``predict_volumes_on_device`` from the restored model equal to the
    trained model's."""
    import json

    from tpu_mednet_torch.data import PatchSampler, ZarrReader
    from tpu_mednet_torch.inference import predict_volumes_on_device
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.train import CheckpointManager, Trainer, create_train_state

    write_organ_store(root)
    data = root / "organs.zarr"
    sampler = lambda keys, seed, probs: PatchSampler(
        data, keys, U3_TRAINER_SAMPLES, U3_TRAINER_PATCH, class_probabilities=probs, seed=seed)
    model = u3_model(torch, dev, "cbr", ORGAN_CLASSES)
    task = SegmentationTask(model=model, loss="DICE")
    trainer = Trainer(task, sampler(ORGAN_SPLITS["train"], 0, [0.2] * ORGAN_CLASSES),
                      val_sampler=sampler(ORGAN_SPLITS["val"], 1, None),
                      batch_size=U3_TRAINER_BATCH, max_epochs=2, model_dir=str(root / "u3"),
                      log_dir=str(root / "u3" / "logs"), log_every=1,
                      hparams={"fmaps": list(model.config.feature_maps)})
    before = launch_counts(gn, P)
    t0 = time.perf_counter()
    state = trainer.fit()
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    after = launch_counts(gn, P)
    add_counts(counts, before, after)
    records = [json.loads(line) for line in
               (root / "u3" / "logs" / "metrics.jsonl").read_text().splitlines()]
    losses = [r["train_loss"] for r in records if "train_loss" in r]
    val = [r["val_loss"] for r in records if "val_loss" in r]
    fresh = u3_model(torch, dev, "cbr", ORGAN_CLASSES)
    fresh.config = model.config
    restored, _ = CheckpointManager(root / "u3").restore(create_train_state(fresh, seed=1))
    a, b = model.state_dict(), restored.model.state_dict()
    bit_equal = sorted(a) == sorted(b) and all(torch.equal(a[k], b[k]) for k in a)
    n_stats = sum(1 for k in a if "running_" in k)
    test = ORGAN_SPLITS["test"]
    kw = dict(patch_size=list(PATCH), patch_overlap=list(OVERLAP), batch_size=BATCH, device=dev)
    before = launch_counts(gn, P)
    masks = [predict_volumes_on_device(SegmentationTask(model=m), data, test, **kw)
             for m in (model, restored.model)]
    add_counts(serve_counts, before, launch_counts(gn, P))
    with ZarrReader(data) as r:
        labels = dict(zip(test, r.read(test, "labels", np.uint8)))
    same = all(np.array_equal(np.asarray(masks[0][k]), np.asarray(masks[1][k])) for k in test)
    dice = {k: [float(2 * ((np.asarray(masks[1][k])[0] == c) & (labels[k][0] == c)).sum()
                      / max(1, (np.asarray(masks[1][k])[0] == c).sum()
                            + (labels[k][0] == c).sum())) for c in range(1, ORGAN_CLASSES)]
            for k in test}
    per = {k: after[k] - before[k] for k in after}
    log(f"UNet3D cbr Trainer.fit: {state.step} steps, 2 epochs in {fit_s:.2f} s; train losses "
        f"{' '.join(f'{v:.4f}' for v in losses)}; val_loss {val}; launches {per}; restored "
        f"state ({n_stats} running statistics) bit-equal {bit_equal}; masks from the restored "
        f"model equal the trained model's {same}; Dice by class "
        + "; ".join(f"{k} {' '.join(f'{d:.3f}' for d in v)}" for k, v in dice.items()))
    steps = 2 * (len(ORGAN_SPLITS["train"]) * U3_TRAINER_SAMPLES // U3_TRAINER_BATCH)
    if not (state.step == steps and bit_equal and same and n_stats == 28
            and all(np.isfinite(losses + val))):
        raise AssertionError("UNet3D Trainer: steps, restore or prediction failed")
    return dict(steps=state.step, fit_seconds=fit_s, losses=losses, val_loss=val,
                restored_bit_equal=bit_equal, masks_equal=same, dice=dice)


def u3_seg_tiny(torch, gn, P, root, counts):
    """``train_seg -c configs/seg_tiny.yaml`` (BASELINE config 1: f_maps 8,
    so 8 channels in 8 groups at level 0) for 1 epoch through the CLI's
    ``main(argv)`` on a seeded 64^3 store, the paths and the epoch count
    overridden."""
    from tpu_mednet_torch.cli import train_seg
    from tpu_mednet_torch.data import zarrlite

    rng = np.random.default_rng(4)
    z = zarrlite.open(str(root / "tiny.zarr"), mode="w")
    lbl = np.zeros(TINY_SHAPE, np.uint8)
    lbl[16:44, 20:48, 12:40] = 1
    img = (rng.normal(0.0, 0.5, size=TINY_SHAPE) + lbl).astype(np.float32)
    z.require_group("images").create_dataset("t0", data=img[None], compressor=None)
    z.require_group("labels").create_dataset("t0", data=lbl[None], compressor=None)
    (root / "tiny.txt").write_text("t0\n")
    argv = ["-c", str(HERE / "configs" / "seg_tiny.yaml"), "--data_path",
            str(root / "tiny.zarr"), "--train_set", str(root / "tiny.txt"), "--val_set",
            str(root / "tiny.txt"), "--model_dir", str(root / "tiny"), "--log_dir",
            str(root / "tiny" / "logs"), "--max_epochs", "1"]
    before = launch_counts(gn, P)
    t0 = time.perf_counter()
    rc = train_seg.main(argv)
    seconds = time.perf_counter() - t0
    after = launch_counts(gn, P)
    add_counts(counts, before, after)
    per = {k: after[k] - before[k] for k in after}
    log(f"seg_tiny: train_seg rc {rc} in {seconds:.2f} s; launches {per}")
    # 4 patches of the one subject at batch 1: 4 steps of 27 GroupNorms
    if rc != 0 or per["gn_bwd_reduce"] != 4 * 27 or per["gn_moments"] < 4 * 27:
        raise AssertionError(f"seg_tiny: rc {rc}, launches {per}")
    return dict(seconds=seconds, launches=per)


def unet3d_phase(torch, gn, P, grid_corners, dev, gen) -> dict:
    """The UNet3D family: K1 at its shapes, the gcr and cbr models at full
    width trained and served, the Trainer from Python, the memory fit's
    UNet3D points and configs/seg_tiny.yaml; launches of the main paths
    counted from 0."""
    import tempfile

    import chip_memory_fit
    from tpu_mednet_torch.utils import memory

    log_clocks("unet3d")
    t0 = time.perf_counter()
    k1 = u3_gn(torch, gn, dev, gen)
    torch.cuda.empty_cache()
    reset_counts(gn, P)
    # launches of the main paths: training (the device sampler's indexed K2)
    # and serving (the device stitch's K2) apart
    counts = dict.fromkeys(launch_counts(gn, P), 0)
    serve_counts = dict(counts)
    gcr = u3_model(torch, dev, "gcr")
    n_params = sum(p.numel() for p in gcr.parameters())
    log(f"UNet3D(1, {U3_CLASSES}) gcr parameters: {n_params}")
    if n_params != U3_PARAMS:
        raise AssertionError(f"expected {U3_PARAMS} parameters")
    fwd = u3_forward(torch, gn, P, gcr, dev, gen, serve_counts)
    parity = u3_parity(torch, gn, P, gcr, dev, gen)
    train = u3_training(torch, gn, P, dev, gcr, seeded_train_sampler(dev), counts)
    torch.cuda.empty_cache()
    cbr, bn = u3_batchnorm(torch, gn, P, dev, counts)
    torch.cuda.empty_cache()
    serving = u3_serving(torch, gn, P, {"gcr": gcr, "cbr": cbr}, grid_corners, dev,
                         serve_counts)
    del gcr, cbr
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_unet3d_") as tmp:
        trainer = u3_trainer(torch, gn, P, dev, Path(tmp), counts, serve_counts)
        torch.cuda.empty_cache()
        tiny = u3_seg_tiny(torch, gn, P, Path(tmp), counts)
    torch.cuda.empty_cache()
    fit = chip_memory_fit.train_fit(torch, dev, memory, double_only=True)
    if not fit["ok"]:
        raise AssertionError("UNet3D memory fit: a ratio outside [1, 1.3]")
    seconds = time.perf_counter() - t0
    total = {k: counts[k] + serve_counts[k] for k in counts}
    log(f"unet3d: launches {total} (training {counts}, serving {serve_counts}); "
        f"{seconds:.1f} s")
    return dict(counts=total, gather_serving=serve_counts["gather_patches"],
                gather_indexed=counts["gather_patches"], gn=k1, unet3d=dict(
                    forward=fwd, parity=parity, training=train, batchnorm=bn, serving=serving,
                    trainer=trainer, seg_tiny=tiny, memory_fit=fit["points"],
                    seconds=seconds))


# -- parallel: the MIP visualizer, Neptune, data parallelism, round-robin predict --

# the visualizer's compute half at the widths of seg_organ.yaml (f_maps 32, 5
# classes, a validation batch of 4 x 128^3) and of multitask_dp.yaml's
# LandmarkNet (f_maps 32, 6 heatmaps + 2 classes, 96^3)
VIS_CASES = (("seg_organ", 0, 5, ORGAN_PATCH, 4), ("multitask_dp", 6, 2, PATCH, 2))
VIS_REPS = 5
# seg_organ 1 epoch: 10 steps of batch 4; validation 10 patches in batches of
# 4 (2 batches, the trailing 2 dropped), the visualizer on batch 0
# (log_interval 5)
OBS_VAL_BATCHES, OBS_VISUALIZED = 2, 1
# two data-parallel ranks on the one card (gloo: NCCL refuses two ranks on
# one device), global batch 8 of 96^3; a bench-style run (bf16, Adam 1e-3,
# mirror flips) of DP_STEPS compared steps and DP_TIMED timed ones; a parity
# run per dtype (SGD with momentum, as the CPU tests: Adam turns summation-
# order noise in a near-zero gradient into a full +-lr step); the cbr
# UNet3D at global batch 2
DP_WORLD, DP_BATCH, DP_STEPS, DP_TIMED, DP_CBR_BATCH = 2, 8, 3, 5, 2
DP_SGD = dict(name="sgd", learning_rate=0.01, momentum=0.9)
DP_TIMEOUT = 300
# multitask_dp.yaml: train_ldmks --gpus 8 (clamped to the one card) at its
# global batch 32 of 96^3 on a seeded store of five 128 x 128 x 112 subjects
# (four train with 24 patches each: 3 steps an epoch; one val: one batch,
# padded), 6 stored heatmaps + a 2-class map; 4 epochs, the validation loss
# falling from the first to the last
MT_SUBJECTS = tuple((f"m{i}", (128, 128, 112)) for i in range(5))
MT_SPLITS = dict(train=["m0", "m1", "m2", "m3"], val=["m4"])
MT_HEATMAPS, MT_PATCHES, MT_EPOCHS, MT_BATCH = 6, 24, 4, 32
MT_STEPS = len(MT_SPLITS["train"]) * MT_PATCHES // MT_BATCH


def vis_compute(torch, gn, P, dev, counts):
    """The visualizer hooks' compute half on the card at full width: one
    eval-mode forward of the batch's first row (27 K1 launches of each
    forward kernel a call), against the plain path: class maps apart only
    inside the tie band, heatmaps within the bf16 bound, the MIPs those of
    the prediction."""
    from types import SimpleNamespace

    from tpu_mednet_torch.models import ResidualUNet3D
    from tpu_mednet_torch.utils import plots

    out = {}
    for name, n_hm, classes, patch, rows in VIS_CASES:
        gen = torch.Generator(device=dev).manual_seed(1)
        label = torch.zeros((rows, n_hm + 1, *patch), dtype=torch.uint8, device=dev)
        label[:, -1, 20:70, 30:80, 10:60] = 1
        if n_hm:
            label[:, :n_hm] = torch.randint(0, 256, (rows, n_hm, *patch), generator=gen,
                                            device=dev, dtype=torch.uint8)
        data = torch.randn((rows, 1, *patch), generator=gen, device=dev) + label[:, -1:]
        batch = {"data": data.contiguous(memory_format=torch.channels_last_3d),
                 "label": label.contiguous(memory_format=torch.channels_last_3d)}
        model = ResidualUNet3D(1, n_hm + classes, f_maps=32, dtype=torch.bfloat16, device=dev,
                               generator=torch.Generator().manual_seed(0))
        trainer = SimpleNamespace(state=SimpleNamespace(model=model, step=0))

        def compute():
            return (plots.landmark_sample_arrays(trainer, batch, n_hm) if n_hm
                    else plots.seg_sample_arrays(trainer, batch))

        before = launch_counts(gn, P)
        arrays = compute()
        torch.cuda.synchronize()
        add_counts(counts, before, launch_counts(gn, P))
        with uncounted(gn, P):
            launched = launch_counts(gn, P)
            compute()
            torch.cuda.synchronize()
            per_call = {k: v - launched[k] for k, v in launch_counts(gn, P).items()}
            t0 = time.perf_counter()
            for _ in range(VIS_REPS):
                compute()
            ms = (time.perf_counter() - t0) / VIS_REPS * 1e3
            logits = torch.from_numpy(plots.first_row_logits(trainer, batch))
            with plain_kernels(gn, P):
                logits_p = torch.from_numpy(plots.first_row_logits(trainer, batch))
        want = dict(gn_moments=27, gn_apply=27, gn_bwd_reduce=0, gn_bwd_apply=0,
                    gather_patches=0)
        if per_call != want:
            raise AssertionError(f"visualizer {name}: launches a call {per_call}, expected {want}")
        cls, cls_p = logits[n_hm:], logits_p[n_hm:]
        err = float((cls - cls_p).abs().max())
        top2 = cls_p.topk(2, dim=0).values
        margin = (top2[0] - top2[1]).numpy()
        pred_p = cls_p.argmax(dim=0).numpy()
        apart = arrays["pred"] != pred_p
        outside = int((apart & (margin > 2 * err)).sum())
        mips_ok = np.array_equal(plots.label_mips(arrays["label"], arrays["pred"]),
                                 np.stack([arrays["pred"].max(axis=1),
                                           arrays["label"].max(axis=1)]))
        row = dict(ms_per_call=ms, launches_per_call=per_call, class_err=err,
                   voxels_apart=int(apart.sum()), apart_outside_band=outside,
                   pred_equals_argmax=bool(np.array_equal(arrays["pred"],
                                                          cls.argmax(dim=0).numpy())))
        if n_hm:
            hm_err = float((logits[:n_hm] - logits_p[:n_hm]).abs().max())
            hm_bound = FWD_BF16_REL * float(logits_p[:n_hm].abs().max())
            mips_ok &= np.array_equal(
                plots.heatmap_mips(arrays["out_heatmaps"], arrays["gt_heatmaps"]),
                np.concatenate([arrays["gt_heatmaps"].max(axis=2),
                                arrays["out_heatmaps"].max(axis=2)]))
            mips_ok &= np.array_equal(arrays["out_heatmaps"], logits[:n_hm].numpy())
            row.update(heatmap_err=hm_err, heatmap_bound=hm_bound)
        row["mips_equal_numpy"] = bool(mips_ok)
        log(f"visualizer {name} ({n_hm} heatmaps + {classes} classes, f_maps 32, bf16, first "
            f"row of {rows} x {patch[0]}^3): {ms:.2f} ms a call (host clock, synchronized), "
            f"launches {per_call}; class logits max |kernel - plain| {err:.4g}, "
            f"{row['voxels_apart']} voxels apart, {outside} outside the tie band"
            + (f"; heatmaps max |diff| {row['heatmap_err']:.4g} (bound "
               f"{row['heatmap_bound']:.4g})" if n_hm else "")
            + f"; MIPs equal numpy's {row['mips_equal_numpy']}")
        if outside or not row["pred_equals_argmax"] or not mips_ok or (
                n_hm and row["heatmap_err"] > row["heatmap_bound"]):
            raise AssertionError(f"visualizer {name}: the compute half disagrees")
        out[name] = row
        del model, batch
        torch.cuda.empty_cache()
    return out


class FakeNeptune:
    """A duck-typed ``neptune`` module: ``init_run`` records a run whose
    appends, assignments and ``stop`` are kept (no client, no network)."""

    class Run:
        def __init__(self, **kwargs):
            self.kwargs, self.appends, self.assigned, self.stopped = kwargs, {}, {}, False

        def __getitem__(self, key):
            run = self

            class Handle:
                def append(self, value, step=None):
                    run.appends.setdefault(key, []).append((value, step))

            return Handle()

        def __setitem__(self, key, value):
            self.assigned[key] = value

        def stop(self):
            self.stopped = True

    def __init__(self):
        self.runs = []

    def init_run(self, **kwargs):
        self.runs.append(self.Run(**kwargs))
        return self.runs[-1]


def par_observability(torch, gn, P, dev, root, counts):
    """``train_seg -c configs/seg_organ.yaml`` 1 epoch with a validation set
    and ``--neptune_project`` (a fake client, a dummy token): every scalar
    of ``metrics.jsonl`` reaches the sink, which is closed; the visualizer
    logs 2 figures and 27 more K1 launches a visualized batch where
    matplotlib imports, and where it does not one warning and the launches
    of a run without it."""
    import logging
    import os

    from tpu_mednet_torch.cli import train_seg

    fake = FakeNeptune()
    have_mpl = importlib.util.find_spec("matplotlib") is not None
    records = []
    handler = logging.Handler(logging.WARNING)
    handler.emit = records.append
    logging.getLogger("tpu_mednet_torch.utils.plots").addHandler(handler)
    saved = sys.modules.get("neptune")
    sys.modules["neptune"] = fake
    os.environ["NEPTUNE_API_TOKEN"] = "dummy-token"
    write_organ_store(root)
    before = launch_counts(gn, P)
    t0 = time.perf_counter()
    try:
        rc = train_seg.main(organ_train_argv(root, "seg_organ", "--max_epochs", "1",
                                             "--neptune_project", "ws/chip-smoke"))
    finally:
        del os.environ["NEPTUNE_API_TOKEN"]
        if saved is None:
            sys.modules.pop("neptune")
        else:
            sys.modules["neptune"] = saved
        logging.getLogger("tpu_mednet_torch.utils.plots").removeHandler(handler)
    seconds = time.perf_counter() - t0
    got = {k: v - before[k] for k, v in launch_counts(gn, P).items()}
    add_counts(counts, before, launch_counts(gn, P))
    if rc != 0:
        raise AssertionError(f"observability: train_seg exited {rc}")
    fwd = (ORGAN_STEPS_PER_EPOCH + OBS_VAL_BATCHES + (OBS_VISUALIZED if have_mpl else 0)) * 27
    want = dict(gn_moments=fwd, gn_apply=fwd, gn_bwd_reduce=ORGAN_STEPS_PER_EPOCH * 27,
                gn_bwd_apply=ORGAN_STEPS_PER_EPOCH * 27, gather_patches=0)
    (run,) = fake.runs
    metrics = read_metrics(root / "seg_organ" / "logs" / "metrics.jsonl")
    scalars = sorted((r["step"], k, float(v)) for r in metrics for k, v in r.items()
                     if k not in ("step", "time"))
    figures = {k: len(v) for k, v in run.appends.items() if k in ("images", "labels")}
    appended = sorted((s, k, float(v)) for k, vs in run.appends.items() if k not in figures
                      for v, s in vs)
    warnings = [r.getMessage() for r in records]
    out = dict(matplotlib=have_mpl, launches=got, expected=want, scalars=len(scalars),
               sink_scalars_equal=appended == scalars, closed=run.stopped, figures=figures,
               warnings=warnings, seconds=seconds, tags=run.kwargs["tags"])
    log(f"observability: matplotlib {'imported' if have_mpl else 'absent'}; train_seg "
        f"seg_organ 1 epoch with --neptune_project in {seconds:.1f} s: {len(scalars)} scalars "
        f"in metrics.jsonl, the sink got them all {out['sink_scalars_equal']}, closed "
        f"{run.stopped}; figures to the sink {figures}; plots warnings {warnings}; launches "
        f"{got} (expected {want})")
    ok = out["sink_scalars_equal"] and run.stopped and got == want and scalars
    if have_mpl:
        ok = ok and figures == {"images": OBS_VISUALIZED, "labels": OBS_VISUALIZED}
    else:
        ok = ok and not figures and len(warnings) == 1 and "matplotlib" in warnings[0]
    if not ok:
        raise AssertionError("observability: the sink, the figures or the launches disagree")
    return out


def dp_models(torch, dev, dtype, order=None):
    """The data-parallel runs' models from seeded weights: the full-width
    ResidualUNet3D, or the UNet3D in ``order``."""
    from tpu_mednet_torch.models import ResidualUNet3D

    if order:
        return u3_model(torch, dev, order)
    return ResidualUNet3D(1, 2, f_maps=32, dtype=dtype, device=dev,
                          generator=torch.Generator().manual_seed(0))


def dp_runs(torch, gn, P, dev, mesh, out_dir: Path, tag: str, counts=None):
    """The runs of the dp comparison, on ``mesh`` (two ranks) or without it
    (one process on the global batch); tensors saved as ``<tag>_<run>.pt``
    under ``out_dir``, a summary returned.  ``counts`` gathers the launches
    of every step."""
    from tpu_mednet_torch.ops.augment import AugmentConfig
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.train import OptimizerConfig, create_train_state, make_train_step

    rows = mesh.rows(DP_BATCH) if mesh is not None else None
    cbr_rows = mesh.rows(DP_CBR_BATCH) if mesh is not None else None
    summary = {}

    def feed(batch, which_rows):
        while True:
            yield from seeded_train_sampler(dev).batches(batch, rows=which_rows)

    def stepped(step, state, batches):
        before = launch_counts(gn, P)  # the batch's gather counts too
        state, m = step(state, next(batches))
        if counts is not None:
            add_counts(counts, before, launch_counts(gn, P))
        return state, float(m["train_loss"])

    # bench-style: bf16, Adam 1e-3, mirror flips
    model = dp_models(torch, dev, torch.bfloat16)
    task = SegmentationTask(model=model, loss="DICE")
    state = create_train_state(model, learning_rate=1e-3, seed=0)
    step = make_train_step(task, augment=AugmentConfig(mirror_axes=(1, 2, 3)), mesh=mesh)
    batches = feed(DP_BATCH, rows)
    losses = []
    for _ in range(DP_STEPS):
        state, loss = stepped(step, state, batches)
        losses.append(loss)
    torch.cuda.synchronize()
    before = launch_counts(gn, P)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(DP_TIMED)]
    for start, end in events:
        start.record()
        state, m = step(state, next(batches))
        end.record()
    torch.cuda.synchronize()
    timed = {k: v - before[k] for k, v in launch_counts(gn, P).items()}
    if counts is not None:
        add_counts(counts, before, launch_counts(gn, P))
    step_ms = [a.elapsed_time(b) for a, b in events]
    torch.save({k: v.cpu() for k, v in model.state_dict().items()},
               out_dir / f"{tag}_bench.pt")
    summary["bench"] = dict(losses=losses, step_ms=step_ms, timed_launches=timed,
                            final_loss=float(m["train_loss"]))
    del model, task, state, step
    torch.cuda.empty_cache()

    # parity: SGD with momentum, no augmentation, fp32 (TF32 off) and bf16
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    for dt_name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = \
            dt_name != "fp32"
        try:
            model = dp_models(torch, dev, dt)
            state = create_train_state(model, optimizer=OptimizerConfig(**DP_SGD), seed=0)
            step = make_train_step(SegmentationTask(model=model, loss="DICE"), mesh=mesh)
            batches = feed(DP_BATCH, rows)
            losses = []
            for _ in range(DP_STEPS):
                state, loss = stepped(step, state, batches)
                losses.append(loss)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        torch.save({k: v.cpu() for k, v in model.state_dict().items()},
                   out_dir / f"{tag}_{dt_name}.pt")
        summary[dt_name] = dict(losses=losses)
        del model, state, step
        torch.cuda.empty_cache()

    # the cbr UNet3D: global BatchNorm statistics
    model = dp_models(torch, dev, torch.bfloat16, order="cbr")
    state = create_train_state(model, optimizer=OptimizerConfig(**DP_SGD), seed=0)
    step = make_train_step(SegmentationTask(model=model, loss="DICE"), mesh=mesh)
    batches = feed(DP_CBR_BATCH, cbr_rows)
    losses = []
    for _ in range(DP_STEPS):
        state, loss = stepped(step, state, batches)
        losses.append(loss)
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, out_dir / f"{tag}_cbr.pt")
    summary["cbr"] = dict(losses=losses)
    del model, state, step
    torch.cuda.empty_cache()
    return summary


def dp_rank(torch, gn, P, dev, out_dir: Path) -> None:
    """One rank of ``par_dp``: joins the gloo group the parent's variables
    describe (both ranks on the one card), runs ``dp_runs`` on its rows and
    writes ``rank<r>.json`` beside its tensors."""
    from tpu_mednet_torch.parallel import make_mesh, maybe_initialize_distributed

    if not maybe_initialize_distributed("gloo"):
        raise AssertionError("dp rank: no process group to join")
    mesh = make_mesh(dev, devices=[dev] * DP_WORLD)
    reset_counts(gn, P)
    counts = dict.fromkeys(launch_counts(gn, P), 0)
    summary = dp_runs(torch, gn, P, dev, mesh, out_dir, f"rank{mesh.rank}", counts)
    summary["launches"] = counts
    (out_dir / f"rank{mesh.rank}.json").write_text(json.dumps(summary))
    torch.distributed.destroy_process_group()


def par_dp(torch, gn, P, dev, root, counts):
    """Two data-parallel ranks on the one card against one process on the
    same global batches: the losses and every parameter after the parity
    runs within the train-step parity bounds (max |diff| over max |p| of
    the parameter), the ranks' parameters and running statistics bit-equal
    to each other, the cbr model's running statistics against one
    process's at the bf16 bound, exact launches a step on each rank (K2
    indexed: 1, for its rows alone), ms a step."""
    import os

    from tpu_mednet_torch.parallel.multihost import free_port

    out_dir = root / "dp"
    out_dir.mkdir()
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(DP_WORLD), LOCAL_WORLD_SIZE=str(DP_WORLD))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-rank",
                               str(out_dir)], env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(DP_WORLD)]
    try:
        rcs = [p.wait(timeout=DP_TIMEOUT) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    if rcs != [0] * DP_WORLD:
        raise AssertionError(f"dp: the ranks exited {rcs}")
    ranks = [json.loads((out_dir / f"rank{r}.json").read_text()) for r in range(DP_WORLD)]
    one = dp_runs(torch, gn, P, dev, None, out_dir, "one", counts)
    rank_counts = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    for k, v in rank_counts.items():
        counts[k] += v

    def load(tag, run):
        return torch.load(out_dir / f"{tag}_{run}.pt")

    out = dict(seconds=seconds, rank_launches=[r["launches"] for r in ranks])
    for run in ("bench", "fp32", "bf16", "cbr"):
        r0, r1, ref = load("rank0", run), load("rank1", run), load("one", run)
        bit_equal = all(torch.equal(r0[k], r1[k]) for k in r0)
        bound = PARITY_REL["fp32" if run == "fp32" else "bf16"]
        # the parity runs: every parameter; the cbr run: the running statistics
        keys = [k for k in ref if ref[k].is_floating_point()
                and (run != "cbr" or k.endswith(("running_mean", "running_var")))]
        rel = {k: float((r0[k].float() - ref[k].float()).abs().max())
               / max(float(ref[k].float().abs().max()), 1e-30) for k in keys}
        worst = max(rel, key=rel.get)
        losses = [r["bench" if run == "bench" else run]["losses"] for r in ranks]
        ref_losses = one[run]["losses"]
        loss_err = max(abs(a - b) for a, b in zip(losses[0], ref_losses))
        out[run] = dict(ranks_bit_equal=bit_equal, worst=worst, worst_rel=rel[worst],
                        loss_err=loss_err, losses=losses[0], one_process_losses=ref_losses,
                        bound=bound)
        log(f"dp {run}: rank 0 losses {' '.join(f'{v:.5f}' for v in losses[0])}, one process "
            f"{' '.join(f'{v:.5f}' for v in ref_losses)} (max |diff| {loss_err:.3g}); "
            f"state after {DP_STEPS if run != 'bench' else DP_STEPS + DP_TIMED} steps: ranks "
            f"bit-equal {bit_equal}, rank vs one process max|diff|/max|ref| {rel[worst]:.3g} "
            f"({worst}; " + ("not held: Adam's steps are +-lr where a gradient is noise"
                              if run == "bench" else f"bound {bound}") + ")")
        if not bit_equal or losses[0] != losses[1]:
            raise AssertionError(f"dp {run}: the two ranks disagree")
        if run != "bench" and (loss_err > bound or rel[worst] > bound):
            raise AssertionError(f"dp {run}: the ranks disagree with one process")
        if run == "bench" and loss_err > bound:
            raise AssertionError("dp bench: the ranks' losses disagree with one process")
    want = dict(gn_moments=27 * DP_TIMED, gn_apply=27 * DP_TIMED, gn_bwd_reduce=27 * DP_TIMED,
                gn_bwd_apply=27 * DP_TIMED, gather_patches=DP_TIMED)
    timed = [r["bench"]["timed_launches"] for r in ranks]
    step_ms = [float(np.median(r["bench"]["step_ms"])) for r in ranks]
    out["bench"].update(timed_launches=timed, median_step_ms=step_ms,
                        one_process_median_step_ms=float(np.median(one["bench"]["step_ms"])))
    log(f"dp bench step, global batch {DP_BATCH} of 96^3 (two ranks time-sliced on one card, "
        f"gloo through the host: not a dp scaling figure): median {step_ms} ms a step by rank "
        f"(CUDA events), one process {out['bench']['one_process_median_step_ms']:.2f} ms; "
        f"launches over {DP_TIMED} timed steps by rank {timed}; the ranks took {seconds:.1f} s")
    if timed != [want] * DP_WORLD:
        raise AssertionError(f"dp: launches by rank {timed}, expected {want} each")
    return out


def write_multitask_store(root: Path) -> None:
    """``root/multitask.zarr``: MT_SUBJECTS with a sphere of class 1 in
    noise and MT_HEATMAPS stored uint8 Gaussian heatmaps (sigma 4, peak
    255) around points inside it; and the key files."""
    from tpu_mednet_torch.data import zarrlite

    rng = np.random.default_rng(5)
    z = zarrlite.open(str(root / "multitask.zarr"), mode="w")
    for key, shape in MT_SUBJECTS:
        grid = np.ogrid[tuple(slice(0, s) for s in shape)]
        centre = np.asarray(shape) / 2 + rng.uniform(-8, 8, size=3)
        dist2 = sum((g - c) ** 2 for g, c in zip(grid, centre))
        lbl = (dist2 <= 30.0 ** 2).astype(np.uint8)
        img = (rng.normal(0.0, 0.5, size=shape) + lbl).astype(np.float32)
        hms = np.zeros((MT_HEATMAPS, *shape), np.uint8)
        for h in range(MT_HEATMAPS):
            point = centre + rng.uniform(-20, 20, size=3)
            d2 = sum((g - c) ** 2 for g, c in zip(grid, point))
            hms[h] = (255.0 * np.exp(-d2 / (2 * 4.0 ** 2))).astype(np.uint8)
        z.require_group("images").create_dataset(key, data=img[None], compressor=None)
        z.require_group("labels").create_dataset(key, data=lbl[None], compressor=None)
        z.require_group("heatmaps").create_dataset(key, data=hms, compressor=None)
    for split, keys in MT_SPLITS.items():
        (root / f"mt_{split}.txt").write_text("\n".join(keys) + "\n")


def par_multitask(torch, gn, P, dev, root, counts):
    """``train_ldmks -c configs/multitask_dp.yaml --gpus 8`` on the one card:
    the clamp printed, every step at the global batch of 32 x 96^3, exact
    launches, patches/s and peak memory, finite losses and a validation
    loss that falls from the first epoch to the last."""
    import io

    from tpu_mednet_torch.cli import train_ldmks
    from tpu_mednet_torch.train import loop

    write_multitask_store(root)
    shapes = []

    def recording(orig):
        def make(*args, **kw):
            step = orig(*args, **kw)

            def recorded(state, batch):
                shapes.append(tuple(batch["data"].shape))
                return step(state, batch)
            return recorded
        return make

    argv = ["-c", str(HERE / "configs" / "multitask_dp.yaml"), "--gpus", "8",
            "--data_path", str(root / "multitask.zarr"), "--train_set", str(root / "mt_train.txt"),
            "--val_set", str(root / "mt_val.txt"), "--model_dir", str(root / "multitask"),
            "--log_dir", str(root / "multitask" / "logs"), "--max_epochs", str(MT_EPOCHS),
            "--patches_per_subject", str(MT_PATCHES)]
    stdout = io.StringIO()
    torch.cuda.reset_peak_memory_stats(dev)
    before = launch_counts(gn, P)
    t0 = time.perf_counter()
    with wrapped(loop, "make_train_step", recording), contextlib.redirect_stdout(stdout):
        rc = train_ldmks.main(argv)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    got = {k: v - before[k] for k, v in launch_counts(gn, P).items()}
    add_counts(counts, before, launch_counts(gn, P))
    printed = stdout.getvalue()
    log(f"multitask_dp: printed {printed.strip()!r}")
    if rc != 0:
        raise AssertionError(f"multitask_dp: train_ldmks exited {rc}")
    steps = MT_STEPS * MT_EPOCHS
    vis = 1 if importlib.util.find_spec("matplotlib") else 0
    val_batches = max(MT_PATCHES // MT_BATCH, 1)  # an epoch shorter than a batch is padded
    fwd = (steps + MT_EPOCHS * (val_batches + vis)) * 27
    want = dict(gn_moments=fwd, gn_apply=fwd, gn_bwd_reduce=steps * 27,
                gn_bwd_apply=steps * 27, gather_patches=0)
    metrics = read_metrics(root / "multitask" / "logs" / "metrics.jsonl")
    train = [r["train_loss"] for r in metrics if "train_loss" in r]
    val = [r["val_loss"] for r in metrics if "val_loss" in r]
    val_parts = [(r["val_class_loss"], r["val_regression_loss"]) for r in metrics
                 if "val_loss" in r]
    pps = [r["patches_per_sec"] for r in metrics if "patches_per_sec" in r]
    out = dict(printed=printed.strip(), batch_shapes=sorted(set(shapes)), steps=len(shapes),
               launches=got, expected=want, train_losses=train, val_losses=val,
               val_class_and_regression=val_parts,
               patches_per_s=pps, peak_allocated_gib=peak / 2**30, seconds=seconds)
    log(f"multitask_dp: {len(shapes)} steps at {sorted(set(shapes))}; patches/s by epoch "
        f"{' '.join(f'{v:.2f}' for v in pps)}; peak allocated {peak / 2**30:.3f} GiB; launches "
        f"{got} (expected {want}); train losses {train}, val losses {val} (class, regression "
        f"{val_parts}); {seconds:.1f} s")
    ok = ("--gpus 8 clamped to 1" in printed and len(shapes) == steps
          and set(shapes) == {(MT_BATCH, 1, *PATCH)} and got == want
          and all(np.isfinite(train + val)) and len(val) == MT_EPOCHS and val[-1] < val[0])
    if not ok:
        raise AssertionError("multitask_dp: the clamp, the batch, the launches or the losses")
    return out


def par_round_robin(torch, gn, P, dev, root, counts):
    """``predict`` of the observability run's checkpoint with
    ``prediction.gpus: 2`` (clamped to 1, printed) byte-equal to ``gpus:
    1``; ``round_robin_placement`` over ``[cuda:0, cuda:0]`` places one more
    copy of the weights (the first entry is the model itself) and its masks
    through the device stitch equal one device's."""
    import io

    from tpu_mednet_torch.cli import predict
    from tpu_mednet_torch.data import MemoryReader
    from tpu_mednet_torch.data.readers import ZarrReader
    from tpu_mednet_torch.inference import predict_volumes_on_device
    from tpu_mednet_torch.inference.common import round_robin_placement
    from tpu_mednet_torch.models import ResidualUNet3D
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.utils.memory import param_bytes

    masks, printed = {}, {}
    for gpus in (1, 2):
        argv = organ_predict_argv(root, "device")
        argv = [a.replace("prediction_device.zarr", f"prediction_gpus{gpus}.zarr") for a in argv]
        stdout = io.StringIO()
        before = launch_counts(gn, P)
        with contextlib.redirect_stdout(stdout):
            rc = predict.main([*argv, f"prediction.gpus={gpus}"])
        add_counts(counts, before, launch_counts(gn, P))
        if rc != 0:
            raise AssertionError(f"round robin: predict with gpus {gpus} exited {rc}")
        printed[gpus] = stdout.getvalue().strip()
        with ZarrReader(root / f"prediction_gpus{gpus}.zarr") as r:
            keys = ORGAN_SPLITS["test"]
            masks[gpus] = dict(zip(keys, r.read(keys, "prediction", np.uint8)))
    cli_equal = all(np.array_equal(masks[1][k], masks[2][k]) for k in masks[1])

    model = ResidualUNet3D(1, ORGAN_CLASSES, f_maps=32, dtype=torch.bfloat16, device=dev,
                           generator=torch.Generator().manual_seed(0))
    task = SegmentationTask(model=model, loss="DICE")
    rng = np.random.default_rng(3)
    reader = MemoryReader({"images": {f"r{i}": rng.normal(size=(1, 160, 160, 160))
                                      .astype(np.float32) for i in range(2)}})
    kw = dict(patch_size=PATCH, patch_overlap=OVERLAP, batch_size=BATCH, reader=reader,
              device=dev)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    placement = round_robin_placement(task, [dev, dev])
    placed = torch.cuda.memory_allocated(dev) - held
    before = launch_counts(gn, P)
    one = predict_volumes_on_device(task, None, ["r0", "r1"], **kw)
    two = predict_volumes_on_device(task, None, ["r0", "r1"], devices=placement, **kw)
    again = predict_volumes_on_device(task, None, ["r0", "r1"], devices=placement, **kw)
    add_counts(counts, before, launch_counts(gn, P))
    after = torch.cuda.memory_allocated(dev) - held
    lib_equal = all(np.array_equal(one[k].array, two[k].array) and
                    np.array_equal(one[k].array, again[k].array) for k in ("r0", "r1"))
    copies = placed / param_bytes(model)
    out = dict(printed=printed, cli_byte_equal=cli_equal, library_byte_equal=lib_equal,
               entries=len(placement.tasks), placed_bytes=placed,
               param_bytes=param_bytes(model), copies_placed=copies,
               held_after_calls_bytes=after)
    log(f"round robin: predict prediction.gpus 2 printed {printed[2]!r}; masks byte-equal to "
        f"gpus 1 {cli_equal}; round_robin_placement over [{dev}, {dev}]: {len(placement.tasks)} "
        f"entries, {placed} bytes placed = {copies:.3f} x the model's {param_bytes(model)}; "
        f"device-stitch masks of two calls byte-equal to one device {lib_equal}; allocated "
        f"after the calls {after} bytes above the start")
    if not ("prediction.gpus 2 clamped to 1" in printed[2] and cli_equal and lib_equal
            and placement.tasks[0] is task and abs(copies - 1.0) < 0.01):
        raise AssertionError("round robin: the clamp, the placement or the masks disagree")
    return out


def parallel_phase(torch, gn, P, grid_corners, dev, gen) -> dict:
    """Training observability and data parallelism: the visualizer's
    compute half at full width, Neptune and figures through ``train_seg``,
    two dp ranks against one process, ``configs/multitask_dp.yaml`` on the
    card, round-robin prediction; launches of this process and of the
    ranks counted from 0."""
    import tempfile

    log_clocks("parallel")
    t0 = time.perf_counter()
    reset_counts(gn, P)
    counts = dict.fromkeys(launch_counts(gn, P), 0)
    serve_counts = dict(counts)
    vis = vis_compute(torch, gn, P, dev, counts)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_parallel_") as tmp:
        root = Path(tmp)
        obs = par_observability(torch, gn, P, dev, root, counts)
        torch.cuda.empty_cache()
        dp = par_dp(torch, gn, P, dev, root, counts)
        torch.cuda.empty_cache()
        mt = par_multitask(torch, gn, P, dev, root, counts)
        torch.cuda.empty_cache()
        rr = par_round_robin(torch, gn, P, dev, root, serve_counts)
    torch.cuda.empty_cache()
    seconds = time.perf_counter() - t0
    total = {k: counts[k] + serve_counts[k] for k in counts}
    log(f"parallel: launches {total} (training {counts}, serving {serve_counts}); "
        f"{seconds:.1f} s")
    return dict(counts=total, gather_serving=serve_counts["gather_patches"],
                gather_indexed=counts["gather_patches"], parallel=dict(
                    visualizer=vis, observability=obs, dp=dp, multitask_dp=mt,
                    round_robin=rr, seconds=seconds))


SP_TIMEOUT = 420       # seconds for one launch of the spatial ranks, start to exit
# seg_organ's level shapes at two space ranks: batch 4 of a 64 x 128 x 128 slab
SP_LEVELS = [(32 * 2**i, (64 >> i, 128 >> i, 128 >> i)) for i in range(5)]
SP_BATCH, SP_EXTENT, SP_CLASSES, SP_STEPS, SP_TIMED = 4, (128, 128, 128), 5, 3, 3
SP_SGD = dict(name="sgd", learning_rate=0.01, momentum=0.9)
# the 2 x 2 mesh: f_maps 32, 3 levels, global batch 4 of 64^3; remat: 2 steps
SP_SMALL = dict(f_maps=32, num_levels=3, extent=(64, 64, 64))
SP_VOLUME = (192, 176, 144)
# a train step of the 5-level residual net: 3^3 convolutions (3 a block,
# 9 blocks) and transposed convolutions (4) exchange their rows in the
# forward, and all but the first (its input needs no gradient) in the
# backward; each GroupNorm adds its sums over the row once in each pass
SP_EXCHANGES_PER_STEP = 2 * (27 + 4) - 1
SP_SPACE_SUMS_PER_STEP = 2 * 27
# halo exchanges a spatial rank posted and their host seconds (count_halo_posts)
HALO_POSTS = [0, 0.0]


def count_halo_posts(halo) -> None:
    """Count and time, in ``HALO_POSTS``, every exchange this rank posts
    (``halo._post``, called once an exchange that moves rows)."""
    orig = halo._post

    def post(*args):
        t0 = time.perf_counter()
        orig(*args)
        HALO_POSTS[0] += 1
        HALO_POSTS[1] += time.perf_counter() - t0
    halo._post = post


def sp_gn(torch, gn, dev, gen):
    """K1's fold-off route at seg_organ's level shapes at two ranks, bf16
    and fp32: the moments kernel's sums and the backward reduce's A and B
    against their plain versions within 1e-4 x max |ref| (per-(n, c) sums of
    another fp32 order, K1's backward bound), and the fold-off route, then
    the fold in torch, against the fold-on kernel within rtol 1e-5 (another
    order of the group sum, and torch's rsqrt against ``__frsqrt_rn``);
    device times against the bytes bound, the plain version and
    torch.var_mean."""
    out = {}
    for dt_name in ("bf16", "fp32"):
        dtype = {"bf16": torch.bfloat16, "fp32": torch.float32}[dt_name]
        tot = dict(moments_ms=0.0, moments_bound=0.0, moments_plain_ms=0.0,
                   moments_library_ms=0.0, reduce_ms=0.0, reduce_bound=0.0,
                   reduce_plain_ms=0.0, moments_err=0.0, reduce_err=0.0, kept=1.0, levels=[])
        for level, (c, ext) in enumerate(SP_LEVELS):
            shape = (SP_BATCH, *ext, c)
            act = lambda: torch.randn(shape, generator=gen, device=dev).to(dtype).permute(
                0, 4, 1, 2, 3)
            x, dy = act() + 0.5, act()
            w = torch.rand(c, generator=gen, device=dev) + 0.5
            b = torch.rand(c, generator=gen, device=dev) - 0.5
            sums = gn.group_norm_sums(x)
            ref = torch.stack(gn.group_norm_stats_plain(x))
            m_err = float((sums - ref).abs().max())
            if m_err > 1e-4 * float(ref.abs().max()):
                raise AssertionError(f"gn_moments fold off {dt_name} level {level}: max|err| "
                                     f"{m_err} against max |ref| {float(ref.abs().max())}")
            spatial = x.numel() // (SP_BATCH * c)
            folded = gn.fold_group_stats(sums[0], sums[1], spatial, GROUPS, w, 1e-5)
            for got, want in zip(folded, gn.group_norm_moments(x, GROUPS, w, 1e-5)):
                torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
            stats = gn.group_norm_moments(x, GROUPS, w, 1e-5)
            ab = gn.group_norm_backward_sums(x, dy, stats.mean, stats.rstd, w, b, GROUPS,
                                             None, GN_ACT)
            *_, a_p, b_p = gn.backward_sums_plain(x, dy, stats.mean, stats.rstd, w, b, None,
                                                  GN_ACT)
            ab_ref = torch.stack((a_p, b_p))
            r_err = float((ab - ab_ref).abs().max())
            if r_err > 1e-4 * float(ab_ref.abs().max()):
                raise AssertionError(f"gn_bwd_reduce fold off {dt_name} level {level}: "
                                     f"max|err| {r_err}")
            coef = gn._bwd_reduce_cuda(x, dy, gn._backward_inputs(
                x, dy, stats.mean, stats.rstd, w, b, None), GROUPS, None, GN_ACT)
            cb, cc = gn.backward_coefficients(ab[0], ab[1], stats.rstd, w, GROUPS,
                                              spatial * (c // GROUPS))
            for got, want in ((cb, coef[2]), (cc, coef[3])):
                torch.testing.assert_close(got, want, rtol=1e-5,
                                           atol=1e-5 * float(want.abs().max()))
            n_el, esz = x.numel(), x.element_size()
            t_m, kept_m, _ = kernel_ms(torch, lambda: gn.group_norm_sums(x), "gn_moments")
            t_r, kept_r, _ = kernel_ms(torch, lambda: gn.group_norm_backward_sums(
                x, dy, stats.mean, stats.rstd, w, b, GROUPS, None, GN_ACT), "gn_bwd_reduce",
                reps=10)
            b_m = bound_ms(n_el * esz + 2 * SP_BATCH * c * 4, 3 * n_el)
            b_r = bound_ms(2 * n_el * esz + 4 * SP_BATCH * c * 4 + 2 * c * 4, 12 * n_el)
            t_mp = cuda_ms(lambda: gn.group_norm_stats_plain(x), reps=5)
            t_rp = cuda_ms(lambda: gn.backward_sums_plain(x, dy, stats.mean, stats.rstd, w, b,
                                                          None, GN_ACT), reps=3, warmup=1)
            t_lib = cuda_ms(lambda: torch.var_mean(x, dim=(2, 3, 4), correction=0))
            row = dict(level=level, shape=list(x.shape), moments_ms=t_m, moments_bound=b_m,
                       reduce_ms=t_r, reduce_bound=b_r, moments_err=m_err, reduce_err=r_err,
                       moments_plain_ms=t_mp, reduce_plain_ms=t_rp, var_mean_ms=t_lib)
            tot["levels"].append(row)
            for k, v in (("moments_ms", t_m), ("moments_bound", b_m), ("reduce_ms", t_r),
                         ("reduce_bound", b_r), ("moments_plain_ms", t_mp),
                         ("reduce_plain_ms", t_rp), ("moments_library_ms", t_lib)):
                tot[k] += v
            tot["moments_err"] = max(tot["moments_err"], m_err)
            tot["reduce_err"] = max(tot["reduce_err"], r_err)
            tot["kept"] = min(tot["kept"], kept_m, kept_r)
            log(f"K1 fold off {dt_name} level {level} {tuple(x.shape)}: moments {t_m:.4f} ms "
                f"device (bound {b_m:.4f}, {b_m / t_m:.0%}; plain {t_mp:.4f}, torch.var_mean "
                f"{t_lib:.4f}), max|err| {m_err:.3g}; backward reduce ("
                f"{reduce_plan_text(gn, x, dy, None, GROUPS, GN_ACT)}) {t_r:.4f} ms (bound "
                f"{b_r:.4f}, {b_r / t_r:.0%}; plain {t_rp:.4f}), max|err| {r_err:.3g}; "
                f"profiler kept {kept_m:g} and {kept_r:g}; folded after: equal to the fold-on "
                "route within rtol 1e-5")
            del x, dy, stats, ab, ab_ref, coef, ref, sums
            torch.cuda.empty_cache()
        log(f"K1 fold off {dt_name}, one call at each of the 5 level shapes: moments "
            f"{tot['moments_ms']:.4f} ms (bound {tot['moments_bound']:.4f}), reduce "
            f"{tot['reduce_ms']:.4f} ms (bound {tot['reduce_bound']:.4f}; first design "
            f"{FIRST_REDUCE_FOLD_OFF[dt_name]})")
        out[dt_name] = tot
    return out


def sp_batches(torch, dev, steps, extent, batch=SP_BATCH, classes=SP_CLASSES, seed=17):
    """Seeded global batches on the card, the same in every process: nested
    spheres of classes 1.. in noise, the image brighter by class."""
    g = torch.Generator(device=dev).manual_seed(seed)
    grid = torch.stack(torch.meshgrid(*(torch.arange(e, device=dev, dtype=torch.float32)
                                        for e in extent), indexing="ij"))
    out = []
    for _ in range(steps):
        centre = (torch.rand((batch, 3, 1, 1, 1), generator=g, device=dev) * 0.4 + 0.3) \
            * torch.tensor(extent, device=dev).view(1, 3, 1, 1, 1)
        dist = ((grid[None] - centre) ** 2).sum(1, keepdim=True).sqrt() / min(extent)
        label = (classes - 1 - (dist * 2 * classes).clamp(0, classes - 1)).round().clamp_min(0)
        label = label.to(torch.uint8)
        data = torch.randn((batch, 1, *extent), generator=g, device=dev) * 0.5 + 0.4 * label
        out.append({"data": data.contiguous(memory_format=torch.channels_last_3d),
                    "label": label})
    return out


def sp_model(torch, dev, dtype, f_maps=32, num_levels=5, remat=False):
    from tpu_mednet_torch.models import ResidualUNet3D

    return ResidualUNet3D(1, SP_CLASSES, f_maps=f_maps, num_levels=num_levels, dtype=dtype,
                          device=dev, remat=remat, generator=torch.Generator().manual_seed(0))


def sp_train(torch, gn, P, dev, mesh, batches, dtype, *, f_maps=32, num_levels=5,
             remat=False, timed=0, counts=None):
    """SGD steps with mirror flips on all three axes on ``mesh`` (None: one
    process) over the global ``batches``: losses, the state dict, and with
    ``timed``, ms a step and the exchanges, space sums and K1/K2 launches
    of each step."""
    from tpu_mednet_torch.ops.augment import AugmentConfig
    from tpu_mednet_torch.parallel.mesh import DataMesh
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.train import OptimizerConfig, create_train_state, make_train_step

    model = sp_model(torch, dev, dtype, f_maps, num_levels, remat)
    state = create_train_state(model, optimizer=OptimizerConfig(**SP_SGD), seed=0)
    step = make_train_step(SegmentationTask(model=model, loss="DICE"), mesh=mesh,
                           augment=AugmentConfig(brightness_sigma=0.0, gamma_range=None,
                                                 contrast_range=None, mirror_axes=(1, 2, 3)))
    sums = [0]

    def counting(orig):
        def space_sum_(self, t):
            sums[0] += 1
            return orig(self, t)
        return space_sum_

    losses, per_step, step_ms = [], [], []
    with wrapped(DataMesh, "space_sum_", counting):
        for i, batch in enumerate(batches):
            rows = mesh.rows(batch["data"].shape[0]) if mesh is not None else slice(None)
            local = {k: v[rows] for k, v in batch.items()}
            torch.cuda.synchronize()
            before = (launch_counts(gn, P), HALO_POSTS[0], sums[0], HALO_POSTS[1])
            t0 = time.perf_counter()
            state, m = step(state, local)
            losses.append(float(m["train_loss"]))  # waits for the step
            step_ms.append(1e3 * (time.perf_counter() - t0))
            after = launch_counts(gn, P)
            if counts is not None:
                add_counts(counts, before[0], after)
            per_step.append(dict(launches={k: after[k] - before[0][k] for k in after},
                                 exchanges=HALO_POSTS[0] - before[1],
                                 space_sums=sums[0] - before[2],
                                 exchange_s=HALO_POSTS[1] - before[3]))
    out = dict(losses=losses, state={k: v.detach().cpu() for k, v in model.state_dict().items()},
               per_step=per_step, step_ms=step_ms[-timed:] if timed else step_ms)
    del model, state, step
    torch.cuda.empty_cache()
    return out


def sp_trainer(torch, dev, root, mesh, tag, visualized=None):
    """``Trainer.fit`` of the seg_organ model (bf16, 5 classes, host sampler
    of 128^3 patches, batch 4) for 2 short epochs with validation on
    ``mesh`` (None: one process); rank 0 of a mesh runs the MIP
    visualizer's compute half (one eval forward of a batch's first row)."""
    from tpu_mednet_torch.data import PatchSampler
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.train import Trainer
    from tpu_mednet_torch.utils.plots import seg_sample_arrays

    def keys(split):
        return (root / f"organs_{split}.txt").read_text().split()

    common = dict(patch_size=ORGAN_PATCH, image_group="images", label_group="labels")
    train = PatchSampler(str(root / "organs.zarr"), keys("train"), 4,
                         class_probabilities=[0.2] * 5, seed=0, **common)
    val = PatchSampler(str(root / "organs.zarr"), keys("val"), 4, seed=1, **common)
    hook = None
    if visualized is not None:
        def hook(trainer, batch, epoch, i):
            arrays = seg_sample_arrays(trainer, batch)
            visualized.append(list(arrays["pred"].shape))
    task = SegmentationTask(model=sp_model(torch, dev, torch.bfloat16), loss="DICE")
    trainer = Trainer(task, train, val_sampler=val, batch_size=ORGAN_BATCH, max_epochs=2,
                      learning_rate=1e-3, log_dir=str(root / tag / "logs"),
                      model_dir=str(root / tag / "model"), log_every=1,
                      limit_train_batches=2, limit_val_batches=1, sample_visualizer=hook,
                      log_interval=1, mesh=mesh)
    t0 = time.perf_counter()
    trainer.fit()
    seconds = time.perf_counter() - t0
    del trainer, task
    torch.cuda.empty_cache()
    return seconds


def sp_predict(torch, dev, mesh, vol):
    """``predict_volume_spatial`` of the seeded volume in each mode on
    ``mesh``: class maps, ms a volume and the peak allocated memory; and
    this rank's slab of the logits the ``auto`` forward takes its map from
    (fp32, on the host)."""
    from tpu_mednet_torch.inference import predict_volume_spatial
    from tpu_mednet_torch.models.blocks import space_axis
    from tpu_mednet_torch.parallel import SpaceAxis, slab_plan
    from tpu_mednet_torch.tasks import SegmentationTask

    task = SegmentationTask(model=sp_model(torch, dev, torch.bfloat16).eval(), loss="DICE")
    plan = slab_plan(vol.shape[1], mesh.n_space, 16)
    x = torch.from_numpy(vol)[None][:, :, plan.slab(mesh.space_index)].to(dev)
    with torch.inference_mode(), space_axis(task.model, SpaceAxis(mesh, plan)):
        logits = task.model(x.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last_3d))[0].float().cpu()
    out = {"logits": logits}
    for mode, flips in (("auto", ()), ("auto", (0, 2)), ("explicit", ())):
        tag = f"{mode}{''.join(map(str, flips))}"
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        times = []
        for _ in range(2):  # the first call warms the kernels' plans
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            maps = predict_volume_spatial(task, vol, mesh, mode=mode, tta_flips=flips)
            times.append(1e3 * (time.perf_counter() - t0))
        out[tag] = dict(maps=maps, ms=times[-1],
                        peak_gib=torch.cuda.max_memory_allocated() / 2**30)
    del task
    torch.cuda.empty_cache()
    return out


def sp_rank(torch, gn, P, dev, out_dir: Path, n_space: int) -> None:
    """One rank of the spatial phase: joins the gloo group the parent's
    variables describe (every rank on the one card) as a mesh of
    ``world / n_space`` x ``n_space``; with one data row, the full-width
    training (bf16 timed, fp32 with TF32 off), remat, ``Trainer.fit`` and
    whole-volume inference, else the 2 x 2 run; writes ``rank<r>.pt``."""
    from tpu_mednet_torch.parallel import halo, make_mesh, maybe_initialize_distributed

    if not maybe_initialize_distributed("gloo"):
        raise AssertionError("spatial rank: no process group to join")
    world = torch.distributed.get_world_size()
    mesh = make_mesh(dev, devices=[dev] * world, n_space=n_space)
    count_halo_posts(halo)
    reset_counts(gn, P)
    counts = dict.fromkeys(launch_counts(gn, P), 0)
    out = {}
    if mesh.n_data == 1:
        torch.cuda.reset_peak_memory_stats()
        batches = sp_batches(torch, dev, SP_STEPS + SP_TIMED, SP_EXTENT)
        out["bf16"] = sp_train(torch, gn, P, dev, mesh, batches, torch.bfloat16,
                               timed=SP_TIMED, counts=counts)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            out["fp32"] = sp_train(torch, gn, P, dev, mesh, batches[:SP_STEPS], torch.float32,
                                   counts=counts)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        del batches
        small = sp_batches(torch, dev, 2, SP_SMALL["extent"])
        kw = dict(f_maps=SP_SMALL["f_maps"], num_levels=SP_SMALL["num_levels"],
                  counts=counts)
        out["remat0"] = sp_train(torch, gn, P, dev, mesh, small, torch.bfloat16, **kw)
        out["remat1"] = sp_train(torch, gn, P, dev, mesh, small, torch.bfloat16, remat=1, **kw)
        visualized = [] if mesh.rank == 0 else None
        out["trainer_s"] = sp_trainer(torch, dev, out_dir, mesh, "trainer", visualized)
        out["visualized"] = visualized
        vol = np.random.default_rng(4).normal(size=(1, *SP_VOLUME)).astype(np.float32)
        out["predict"] = sp_predict(torch, dev, mesh, vol)
    else:
        batches = sp_batches(torch, dev, SP_STEPS, SP_SMALL["extent"])
        out["mesh22"] = sp_train(torch, gn, P, dev, mesh, batches, torch.bfloat16,
                                 f_maps=SP_SMALL["f_maps"], num_levels=SP_SMALL["num_levels"],
                                 counts=counts)
    out["launches"] = counts
    out["exchange_s"] = HALO_POSTS[1]
    torch.save(out, out_dir / f"rank{mesh.rank}.pt")
    torch.distributed.destroy_process_group()


def sp_launch(out_dir: Path, world: int, n_space: int):
    """Start ``world`` ranks of ``chip_smoke.py --sp-rank`` on the card
    (gloo), wait at most ``SP_TIMEOUT`` seconds, kill them on expiry, and
    return each rank's output and the seconds it took."""
    import os

    from tpu_mednet_torch.parallel.multihost import free_port

    out_dir.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
               WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--sp-rank",
                               str(out_dir), str(n_space)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(world)]
    rcs = []
    try:
        deadline = t0 + SP_TIMEOUT
        for p in procs:
            rcs.append(p.wait(timeout=max(1.0, deadline - time.perf_counter())))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    if rcs != [0] * world:
        raise AssertionError(f"spatial ranks ({world} x {n_space}) exited {rcs}")
    import torch

    return [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in range(world)], \
        seconds


def sp_compare(torch, run, ranks, one, bound):
    """Losses and every parameter of ranks against one process, within
    ``bound`` x max |p|; the ranks bit-equal to each other."""
    states = [r[run]["state"] for r in ranks]
    bit_equal = all(torch.equal(states[0][k], s[k]) for s in states[1:] for k in states[0])
    ref = one["state"]
    keys = [k for k in ref if ref[k].is_floating_point()]
    rel = {k: float((states[0][k].float() - ref[k].float()).abs().max())
           / max(float(ref[k].float().abs().max()), 1e-30) for k in keys}
    worst = max(rel, key=rel.get)
    loss_err = max(abs(a - b) for a, b in zip(ranks[0][run]["losses"], one["losses"]))
    return dict(ranks_bit_equal=bit_equal, worst=worst, worst_rel=rel[worst], loss_err=loss_err,
                losses=ranks[0][run]["losses"], one_process_losses=one["losses"], bound=bound)


def sp_maps_band(torch, gn, P, task, x, flips=()):
    """One process's class map of (1, C, X, Y, Z) ``x`` (the kernel path),
    the plain path's top-2 margin of the same activations, and max
    |kernel - plain|: a class may differ only where that margin is at most
    twice the difference (the tie band)."""
    from tpu_mednet_torch.inference.common import tta_split_activations

    with torch.inference_mode():
        if flips:
            act = tta_split_activations(task, x, flips)
            with plain_kernels(gn, P):
                act_p = tta_split_activations(task, x, flips)
        else:
            act = task.model(x.to(task.model.config.dtype))
            with plain_kernels(gn, P):
                act_p = task.model(x.to(task.model.config.dtype))
        err = float((act.float() - act_p.float()).abs().max())
        top2 = act_p.float().topk(2, dim=1).values
        margin = (top2[:, 0] - top2[:, 1])[0]
        maps = act.argmax(dim=1).to(torch.uint8)
    return maps.cpu().numpy(), margin.cpu().numpy(), err


def sp_inference_checks(torch, gn, P, dev, ranks):
    """Each mode's class maps of both ranks against one process: the whole-
    volume forward (``auto``), its ``tta_split_activations`` (``auto``
    with flips 0 and 2), and for ``explicit`` the forward of each slab's
    window of the volume zero-padded by the default halo, cropped; apart
    only inside the tie band.  The ranks' ``auto`` logits are held to one
    process's within the bf16 forward bound (``FWD_BF16_REL`` x max
    |plain|), and the band takes the larger of their difference and the
    kernel path's from the plain path."""
    import torch.nn.functional as F

    from tpu_mednet_torch.inference import receptive_halo
    from tpu_mednet_torch.parallel import slab_plan
    from tpu_mednet_torch.tasks import SegmentationTask

    vol = np.random.default_rng(4).normal(size=(1, *SP_VOLUME)).astype(np.float32)
    task = SegmentationTask(model=sp_model(torch, dev, torch.bfloat16).eval(), loss="DICE")
    x = torch.from_numpy(vol)[None].to(dev).contiguous(memory_format=torch.channels_last_3d)
    halo = -(-receptive_halo(5) // 16) * 16
    want = {"auto": sp_maps_band(torch, gn, P, task, x),
            "auto02": sp_maps_band(torch, gn, P, task, x, (0, 2))}
    padded = F.pad(x, (0, 0, 0, 0, halo, halo))
    plan = slab_plan(SP_VOLUME[0], 2, 16)
    parts = [sp_maps_band(torch, gn, P, task,
                          padded[:, :, a:a + n + 2 * halo].contiguous(
                              memory_format=torch.channels_last_3d))
             for a, n in zip(plan.offsets, plan.lengths)]
    want["explicit"] = tuple(np.concatenate([p[i][:, halo:-halo] if i == 0 else
                                             p[i][halo:-halo] for p in parts],
                                            axis=1 if i == 0 else 0) for i in (0, 1)) + \
        (max(p[2] for p in parts),)
    with torch.inference_mode():
        one = task.model(x.to(torch.bfloat16)).float()[0]
        with plain_kernels(gn, P):
            scale = float(task.model(x.to(torch.bfloat16)).float().abs().max())
        split = torch.cat([r["predict"]["logits"] for r in ranks], dim=1).to(dev)
        err_sp = float((split - one).abs().max())
    del one, split
    if err_sp > FWD_BF16_REL * scale:
        raise AssertionError(f"spatial predict: the ranks' logits {err_sp} from one "
                             f"process's, bound {FWD_BF16_REL} x {scale}")
    out = {"logits_err": err_sp, "logits_scale": scale}
    for tag, (maps, margin, err) in want.items():
        err = max(err, err_sp)
        row = {}
        for r, rank in enumerate(ranks):
            got = rank["predict"][tag]
            flips = got["maps"][0] != maps[0]
            outside = int((flips & (margin > 2 * err)).sum())
            row[f"rank{r}"] = dict(differ=int(flips.sum()), outside=outside, ms=got["ms"],
                                   peak_gib=got["peak_gib"])
            if got["maps"].shape != (1, *SP_VOLUME) or outside:
                raise AssertionError(f"spatial predict {tag} rank {r}: {int(flips.sum())} "
                                     f"voxels differ from one process, {outside} outside the "
                                     "tie band")
        row["band_err"] = err
        out[tag] = row
        log(f"spatial predict {tag} of {SP_VOLUME} over 2 ranks: differs from one process on "
            f"{[row[f'rank{r}']['differ'] for r in range(len(ranks))]} voxels, none outside "
            f"the tie band (max |logit difference| {err:.3g}; the ranks' auto logits "
            f"{err_sp:.3g} from one process's, bound {FWD_BF16_REL} x {scale:.3g}); "
            f"ms a volume by rank "
            f"{[round(row[f'rank{r}']['ms'], 2) for r in range(len(ranks))]}, peak "
            f"{[round(row[f'rank{r}']['peak_gib'], 3) for r in range(len(ranks))]} GiB")
    del task, x, padded
    torch.cuda.empty_cache()
    return out


def spatial_phase(torch, gn, P, grid_corners, dev, gen) -> dict:
    """Spatial partitioning: K1's fold-off route against its plain version;
    seg_organ's model at full width trained on 1 x 2 ranks against one
    process (bf16 and fp32), a 2 x 2 mesh, remat 1 under the space axis,
    ``Trainer.fit`` with the MIP hook, whole-volume inference in both
    modes; launches of this process and of the ranks counted from 0."""
    import tempfile

    log_clocks("spatial")
    t0 = time.perf_counter()
    reset_counts(gn, P)
    k1 = sp_gn(torch, gn, dev, gen)
    reset_counts(gn, P)
    counts = dict.fromkeys(launch_counts(gn, P), 0)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_spatial_") as tmp:
        root = Path(tmp)
        (root / "sp12").mkdir()
        write_organ_store(root / "sp12")
        ranks, seconds12 = sp_launch(root / "sp12", 2, 2)
        ranks22, seconds22 = sp_launch(root / "sp22", 4, 2)
        for r in ranks + ranks22:
            add_counts(counts, dict.fromkeys(counts, 0), r["launches"])
        # one process on the same global batches
        one_counts = dict.fromkeys(counts, 0)
        torch.cuda.reset_peak_memory_stats()
        batches = sp_batches(torch, dev, SP_STEPS + SP_TIMED, SP_EXTENT)
        one = {"bf16": sp_train(torch, gn, P, dev, None, batches, torch.bfloat16,
                                timed=SP_TIMED, counts=one_counts)}
        one_peak = torch.cuda.max_memory_allocated() / 2**30
        tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            one["fp32"] = sp_train(torch, gn, P, dev, None, batches[:SP_STEPS], torch.float32)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        del batches
        one["mesh22"] = sp_train(torch, gn, P, dev, None,
                                 sp_batches(torch, dev, SP_STEPS, SP_SMALL["extent"]),
                                 torch.bfloat16, f_maps=SP_SMALL["f_maps"],
                                 num_levels=SP_SMALL["num_levels"])
        trainer_one_s = sp_trainer(torch, dev, root / "sp12", None, "one")
        got_log = read_metrics(root / "sp12" / "trainer" / "logs" / "metrics.jsonl")
        want_log = read_metrics(root / "sp12" / "one" / "logs" / "metrics.jsonl")
        predict = sp_inference_checks(torch, gn, P, dev, ranks)

    out = dict(k1=k1, seconds_1x2=seconds12, seconds_2x2=seconds22, launches=counts)
    for run, bound in (("bf16", PARITY_REL["bf16"]), ("fp32", PARITY_REL["fp32"])):
        out[run] = sp_compare(torch, run, ranks, one[run], bound)
    out["mesh22"] = sp_compare(torch, "mesh22", ranks22, one["mesh22"], PARITY_REL["bf16"])
    out["remat1"] = sp_compare(torch, "remat1", ranks, ranks[0]["remat0"], PARITY_REL["bf16"])
    for run, row in out.items():
        if run not in ("bf16", "fp32", "mesh22", "remat1"):
            continue
        log(f"spatial {run}: rank 0 losses {' '.join(f'{v:.5f}' for v in row['losses'])}, "
            f"reference {' '.join(f'{v:.5f}' for v in row['one_process_losses'])} (max |diff| "
            f"{row['loss_err']:.3g}); parameters: ranks bit-equal {row['ranks_bit_equal']}, "
            f"rank vs reference max|diff|/max|ref| {row['worst_rel']:.3g} ({row['worst']}; "
            f"bound {row['bound']})")
        if not row["ranks_bit_equal"] or row["worst_rel"] > row["bound"] \
                or row["loss_err"] > row["bound"]:
            raise AssertionError(f"spatial {run}: the ranks disagree with each other or with "
                                 "the reference")
    # exact launches, exchanges and space sums of each full-width bf16 step
    want = dict(gn_moments=27, gn_apply=27, gn_bwd_reduce=27, gn_bwd_apply=27,
                gather_patches=0)
    for r, rank in enumerate(ranks):
        for i, s in enumerate(rank["bf16"]["per_step"]):
            if s["launches"] != want or s["exchanges"] != SP_EXCHANGES_PER_STEP \
                    or s["space_sums"] != SP_SPACE_SUMS_PER_STEP:
                raise AssertionError(f"spatial bf16 step {i} rank {r}: {s}, expected launches "
                                     f"{want}, {SP_EXCHANGES_PER_STEP} exchanges and "
                                     f"{SP_SPACE_SUMS_PER_STEP} space sums")
    step_ms = [float(np.median(r["bf16"]["step_ms"])) for r in ranks]
    exch = [float(np.mean([s["exchange_s"] for s in r["bf16"]["per_step"][-SP_TIMED:]]))
            for r in ranks]
    out["step"] = dict(median_step_ms=step_ms,
                       one_process_median_step_ms=float(np.median(one["bf16"]["step_ms"])),
                       exchange_s_per_step=exch, peak_gib=[r["peak_gib"] for r in ranks],
                       one_process_peak_gib=one_peak, exchange_s_total=[r["exchange_s"]
                                                                        for r in ranks])
    log(f"spatial step, global batch {SP_BATCH} of 128^3 bf16 at f_maps 32 over 1 x 2 ranks "
        f"(time-sliced on one card, gloo staged through the host: not a scaling figure): "
        f"median {step_ms} ms a step by rank, one process "
        f"{out['step']['one_process_median_step_ms']:.2f} ms; exchanges {exch} s a step; "
        f"peak allocated {out['step']['peak_gib']} GiB by rank, one process {one_peak:.3f} "
        f"GiB; {SP_EXCHANGES_PER_STEP} exchanges and {SP_SPACE_SUMS_PER_STEP} space sums a "
        "step, 27 launches of each K1 kernel")
    # Trainer.fit: the logged losses against one process; the hook ran on rank 0
    trainer = dict(seconds=ranks[0]["trainer_s"], one_process_seconds=trainer_one_s,
                   visualized=ranks[0]["visualized"])
    worst = 0.0
    for name in ("train_loss", "val_loss"):
        g = {rec["step"]: rec[name] for rec in got_log if name in rec}
        w = {rec["step"]: rec[name] for rec in want_log if name in rec}
        if sorted(g) != sorted(w) or not g:
            raise AssertionError(f"spatial Trainer.fit: {name} logged at {sorted(g)}, one "
                                 f"process at {sorted(w)}")
        worst = max(worst, max(abs(g[s] - w[s]) for s in w))
    trainer["loss_err"] = worst
    if worst > PARITY_REL["bf16"] or len(ranks[0]["visualized"]) != 2:
        raise AssertionError(f"spatial Trainer.fit: losses {worst} apart, visualizer calls "
                             f"{ranks[0]['visualized']}")
    log(f"spatial Trainer.fit (1 x 2, 2 epochs of 2 steps, validation, the MIP hook's forward "
        f"on rank 0 alone: {ranks[0]['visualized']}): logged losses within {worst:.3g} of one "
        f"process; {trainer['seconds']:.1f} s, one process {trainer_one_s:.1f} s")
    out["trainer"] = trainer
    out["predict"] = predict
    out["seconds"] = time.perf_counter() - t0
    log(f"spatial: launches {counts} (ranks); {out['seconds']:.1f} s, the 1 x 2 ranks "
        f"{seconds12:.1f} s, the 2 x 2 ranks {seconds22:.1f} s")
    return dict(counts=counts, spatial=out)


def analytic_mfu(fwd, slice_, train) -> dict:
    """The analytic model FLOPs (``utils/flops.py``: 3x the forward's
    convolutions a train step) over the measured time, against the H100's
    989 TFLOP/s bf16 dense: the batch-32 step, the 8 x 96^3 forward and the
    serving slice's predict call.  A reading, not a check."""
    from tpu_mednet_torch.utils.flops import unet_forward_flops, unet_train_step_flops

    f_maps = [32 * 2**k for k in range(5)]
    step = unet_train_step_flops(1, 2, f_maps, PATCH, TRAIN_BATCH)
    tile = unet_forward_flops(1, 2, f_maps, PATCH)
    tiles = sum(n_tiles(s) for _, s in SLICE_VOLUMES)
    slice_s = len(SLICE_VOLUMES) * 60.0 / slice_["volumes_per_min"]
    out = dict(train_step=step / (train["median_step_ms"] / 1e3) / H100_BF16_FLOP_PER_S,
               forward=BATCH * tile / (fwd["fwd_ms"] / 1e3) / H100_BF16_FLOP_PER_S,
               slice=tiles * tile / slice_s / H100_BF16_FLOP_PER_S,
               train_step_tflop=step / 1e12, forward_tflop=BATCH * tile / 1e12)
    log(f"analytic MFU against {H100_BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s bf16 dense: "
        f"train step {out['train_step']:.4f} ({out['train_step_tflop']:.3f} TFLOP at "
        f"{train['patches_per_s']:.2f} patches/s), forward {out['forward']:.4f} "
        f"({out['forward_tflop']:.3f} TFLOP in {fwd['fwd_ms']:.2f} ms), serving slice "
        f"{out['slice']:.4f} ({tiles} tiles a call at {slice_['volumes_per_min']:.2f} "
        "volumes/min)")
    return out


def run_child(flag: str, tag: str) -> dict:
    """A phase in a child process on the same card (it reuses the built
    library), which writes its results as JSON; it fails the run if the
    child does."""
    import tempfile

    with tempfile.TemporaryDirectory(prefix=f"chip_smoke_{tag}_") as tmp:
        out = Path(tmp) / f"{tag}.json"
        rc = subprocess.run([sys.executable, str(Path(__file__).resolve()), flag, str(out)],
                            timeout=900).returncode
        if rc != 0:
            raise AssertionError(f"{tag} phase: the child process exited with {rc}")
        return json.loads(out.read_text())


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this run needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    try:
        import tpu_mednet_torch
    except ImportError as exc:
        print(f"chip_smoke: tpu_mednet_torch is not beside this script: {exc}",
              file=sys.stderr)
        return 2
    if Path(tpu_mednet_torch.__file__).resolve().parent.parent != HERE:
        print(f"chip_smoke: imported {tpu_mednet_torch.__file__}, not this checkout's",
              file=sys.stderr)
        return 2
    from tpu_mednet_torch.inference.device_sliding import _grid_corners
    from tpu_mednet_torch.models import ResidualUNet3D
    from tpu_mednet_torch.ops import _build
    from tpu_mednet_torch.ops import groupnorm as gn
    from tpu_mednet_torch.ops import patches as P

    # 1. card
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    log(smi.stdout.strip())
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} python {sys.version.split()[0]}")
    log("optional packages: " + ", ".join(
        f"{name} {'present' if importlib.util.find_spec(name) else 'absent'}"
        for name in ("yaml", "h5py", "zarr", "tensorboardX")))
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    children = {"--landmarks": landmarks_phase, "--predict-surface": predict_surface_phase,
                "--training-surface": training_surface_phase, "--tools": tools_phase,
                "--deploy": deploy_phase, "--unet3d": unet3d_phase,
                "--parallel": parallel_phase, "--spatial": spatial_phase}
    if argv[:1] == ["--dp-rank"]:  # a rank of par_dp, started by the --parallel child
        _build.build()
        dp_rank(torch, gn, P, dev, Path(argv[1]))
        return 0
    if argv[:1] == ["--sp-rank"]:  # a rank of sp_launch, started by the --spatial child
        _build.build()
        sp_rank(torch, gn, P, dev, Path(argv[1]), int(argv[2]))
        return 0
    if argv[:1] and argv[0] in children:  # a child of run_child
        _build.build()
        out = children[argv[0]](torch, gn, P, _grid_corners, dev, gen)
        Path(argv[1]).write_text(json.dumps(out))
        return 0

    # 2. build: the CUDA kernels, then the native batch loader's host library
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    from tpu_mednet_torch import native
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         timeout=60).stdout.splitlines()[0]
    t0 = time.perf_counter()
    native_lib = native.build()
    native_build = dict(compiler=gxx, seconds=time.perf_counter() - t0, library=native_lib.name)
    log(f"build: {native_lib.name} ({gxx}) in {native_build['seconds']:.2f} s")
    log_clocks("after the build")
    for line in _build.BUILD_LOG.splitlines():
        if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            log(f"ptxas: {line.strip()}")

    # 3-5. kernels against their plain versions, then the full-width forward
    k1 = check_gn(torch, gn, dev, gen)
    k1b = check_gn_backward(torch, gn, dev, gen)
    # K1 at the entry points' seg_organ shapes: batch 4 of 128^3, bf16
    k1_organ = check_gn(torch, gn, dev, gen, levels=ORGAN_LEVELS, batch=ORGAN_BATCH,
                        dtypes=("bf16",))
    k1b_organ = check_gn_backward(torch, gn, dev, gen, levels=ORGAN_LEVELS,
                                  configs=(("bf16", ORGAN_BATCH),))
    torch.cuda.empty_cache()
    k2 = check_gather(torch, P, _grid_corners, dev, gen)
    models, fwd = check_forward(torch, gn, P, ResidualUNet3D, dev, gen)

    profile_forward(torch, gn, models["bf16"], dev, gen)

    # 6. the serving path
    counts, slice_ = run_slice(torch, gn, P, models, _grid_corners, dev)

    # 7. the training path: full-width parity, then the counted steps
    parity = check_train_parity(torch, gn, P, models, dev, gen)
    del models
    torch.cuda.empty_cache()
    train_counts, k2i, train = run_training(torch, gn, P, dev)
    torch.cuda.empty_cache()

    mfu = analytic_mfu(fwd, slice_, train)

    # 8. the entry points at the seg_organ width, then the guard's cost
    probe_profiler(torch, dev)
    log_clocks("entry points")
    entry_counts, entry_k2, entry = run_entry_points(torch, gn, P, _grid_corners, dev)
    torch.cuda.empty_cache()
    guard = guard_cost(torch, dev)
    torch.cuda.empty_cache()

    # 9. the landmark workload, in a fresh process: late in this one the
    # profiler drops records (device_rows)
    ldmk_all = run_child("--landmarks", "landmarks")
    ldmk_counts, ldmk_k2, ldmk = ldmk_all["counts"], ldmk_all["k2"], ldmk_all["landmarks"]
    k1_ldmk, k1b_ldmk = ldmk_all["gn_f64"], ldmk_all["gn_backward_f64"]
    ldmk_parity = ldmk_all["parity"]

    # 10. the rest of predict (seg_brats_bf16 from NIfTI, the Gaussian
    # stitch, TTA, the guard, the export tool), in a fresh process too
    surface_all = run_child("--predict-surface", "predict_surface")
    surface_counts, surface_k2 = surface_all["counts"], surface_all["k2"]

    # 11. the training surface (remat, spatial_3d, the training CLIs' new
    # flags), in a fresh process too
    training_all = run_child("--training-surface", "training_surface")
    training_counts = training_all["counts"]

    # 12. the user's tools around training and prediction (the quick start,
    # seg_brats_bf16 and landmarks.yaml from demo stores, the interop round
    # trip, pack and stats), in a fresh process too
    tools_all = run_child("--tools", "tools")
    tools_counts = tools_all["counts"]

    # 13. the deploy slice: the native batch loader on the card's training
    # paths, serving export (torch.export artifacts through K1's custom ops)
    # and the Trainer's profiler hook, in a fresh process too
    deploy_all = run_child("--deploy", "deploy")
    deploy_counts = deploy_all["counts"]

    # 14. the UNet3D family (DoubleConv, concat join) and BatchNorm orders:
    # K1 at its shapes, gcr and cbr trained and served at full width, the
    # Trainer from Python, the memory fit's UNet3D points, seg_tiny.yaml
    u3_all = run_child("--unet3d", "unet3d")
    u3_counts = u3_all["counts"]

    # 15. training observability (the MIP visualizer's compute half,
    # Neptune and figures through train_seg) and data parallelism (two gloo
    # ranks against one process, multitask_dp.yaml clamped to the card,
    # round-robin prediction), in a fresh process too
    par_all = run_child("--parallel", "parallel")
    par_counts = par_all["counts"]

    # 16. spatial partitioning (K1's fold-off route, the dp x sp mesh at
    # seg_organ's width against one process, remat, Trainer.fit, whole-
    # volume inference in both modes), in a fresh process too; its ranks
    # are gloo processes on the one card
    sp_all = run_child("--spatial", "spatial")
    sp_counts = sp_all["counts"]

    def launches(name):
        by_path = dict(serving=counts[name], training=train_counts[name],
                       entry_points=entry_counts[name], landmarks=ldmk_counts[name],
                       predict_surface=surface_counts[name],
                       training_surface=training_counts[name], tools=tools_counts[name],
                       deploy=deploy_counts[name], unet3d=u3_counts[name],
                       parallel=par_counts[name], spatial=sp_counts[name])
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)

    def gather_launches(path, entry, landmarks, surface, training_surface, tools, deploy=0,
                        unet3d=0, parallel=0):
        by_path = dict(serving=0, training=0, entry_points=entry, landmarks=landmarks,
                       predict_surface=surface, training_surface=training_surface, tools=tools,
                       deploy=deploy, unet3d=unet3d, parallel=parallel,
                       spatial=sp_counts["gather_patches"])
        by_path[path] = counts["gather_patches"] if path == "serving" \
            else train_counts["gather_patches"]
        return dict(launches=sum(by_path.values()), launches_by_path=by_path)

    b16, bwd = k1["bf16"], k1b["bf16"]
    l16, lbwd = k1_ldmk["bf16"], k1b_ldmk["bf16"]
    # K1's UNet3D shapes: per gcr forward (moments, apply) or step (the
    # backward), and the C = 1 input's own call
    k1_keys = dict(gn_moments=("moments_ms", "moments_plain_ms", "moments_bound",
                               "moments_library_ms", "moments_err"),
                   gn_apply=("apply_ms", "apply_plain_ms", "apply_bound", "library_ms",
                             "apply_err"),
                   gn_bwd_reduce=("reduce_ms", "bwd_plain_ms", "reduce_bound",
                                  "bwd_library_ms", "bwd_err"),
                   gn_bwd_apply=("bwd_apply_ms", "bwd_plain_ms", "bwd_apply_bound",
                                 "bwd_library_ms", "bwd_err"))

    def u3_checks(name):
        ms, plain, bound, lib, err = k1_keys[name]
        step = name.startswith("gn_bwd")
        n_gn = u3_all["gn"]["n_gn"]
        row = lambda r, per: dict(ms=r[ms], plain_ms=r[plain], bound_ms=r[bound],
                                  library_ms=r[lib], max_abs_err=r[err],
                                  profiler_kept=r["kept"], per=per)
        c1 = u3_all["gn"]["cases"]["c1_e96_bf16"]
        c1_route = (c1["apply_route"] if name in ("gn_apply", "gn_bwd_apply")
                    else c1["reduce_route"] if name == "gn_bwd_reduce" else c1["moments_route"])
        return dict(unet3d_check=row(u3_all["gn"]["per_forward"], (
                        f"gcr UNet3D bf16 {'train step' if step else 'forward'} of batch "
                        f"{U3_BATCH}, {n_gn} calls")),
                    c1_check=row(c1, f"one call at C = 1 in one group (the gcr input), batch "
                                     f"{U3_BATCH} of 96^3, bf16, the {c1_route} route"))

    def by_shape(ms, bound, lib, route="apply_route", names=None, **extra):
        """A kernel's row per UNet3D shape (U3_GN_SHAPES, then the
        one-channel-a-group cases), or per case of ``names``; ``extra``
        maps more keys of the row to the case's."""
        cases = u3_all["gn"]["cases"]
        return [dict(shape=f"{r['batch']} x {r['extent']}^3 x {r['c']} {r['dtype']}",
                     ms=r[ms], bound_ms=r[bound], library_ms=r[lib], **{route: r[route]},
                     **{k: r[v] for k, v in extra.items()})
                for r in (cases[k] for k in (names or cases))]

    spk = {dt: sp_all["spatial"]["k1"][dt] for dt in ("bf16", "fp32")}

    def fold_off(kind):
        """The fold-off route's row: one call at each of seg_organ's five
        level shapes at two ranks."""
        row = lambda dt: dict(
            ms=spk[dt][f"{kind}_ms"], bound_ms=spk[dt][f"{kind}_bound"],
            plain_ms=spk[dt][f"{kind}_plain_ms"],
            library_ms=spk[dt]["moments_library_ms"] if kind == "moments" else None,
            max_abs_err=spk[dt][f"{kind}_err"], profiler_kept=spk[dt]["kept"],
            per=f"fold off, one call at each of seg_organ's 5 level shapes at two ranks "
                f"(batch 4 of 64 x 128 x 128 at level 0), {dt}")
        return dict(spatial_check=row("bf16"), spatial_check_fp32=row("fp32"))

    common = dict(route="cuda", bound_by="bytes", ok=True)
    kernels = [
        dict(name="gn_moments", source="tpu_mednet_torch/csrc/groupnorm.cu",
             **u3_checks("gn_moments"),
             replaces="tpu_mednet/ops/pallas/groupnorm.py:94",
             **launches("gn_moments"), max_abs_err=b16["moments_err"],
             ms=b16["moments_ms"], event_ms=b16["moments_event_ms"],
             plain_ms=b16["moments_plain_ms"], bound_ms=b16["moments_bound"],
             library_ms=b16["moments_library_ms"], profiler_kept=b16["moments_kept"],
             library_call="torch.var_mean (the same moments up to a rescale)",
             per="full-width bf16 forward, 27 calls", **fold_off("moments"),
             by_shape=by_shape("moments_ms", "moments_bound", "moments_library_ms",
                               "moments_route", ("c1_e96_bf16", "c1_g1_fp32"),
                               plain_ms="moments_plain_ms"),
             landmarks_check=dict(ms=l16["moments_ms"], plain_ms=l16["moments_plain_ms"],
                                  bound_ms=l16["moments_bound"],
                                  library_ms=l16["moments_library_ms"],
                                  max_abs_err=l16["moments_err"],
                                  profiler_kept=l16["moments_kept"],
                                  per=f"f_maps-64 bf16 forward of batch {LDMK_BATCH}, 27 calls"),
             **common),
        dict(name="gn_apply", source="tpu_mednet_torch/csrc/groupnorm.cu",
             **u3_checks("gn_apply"),
             by_shape=by_shape("apply_ms", "apply_bound", "library_ms"),
             replaces="tpu_mednet/ops/pallas/groupnorm.py:94",
             **launches("gn_apply"), max_abs_err=b16["apply_err"],
             ms=b16["apply_ms"], event_ms=b16["apply_event_ms"],
             plain_ms=b16["apply_plain_ms"], bound_ms=b16["apply_bound"],
             library_ms=b16["library_ms"], profiler_kept=b16["apply_kept"],
             library_call="F.group_norm + F.elu (statistics and apply together)",
             per="full-width bf16 forward, 27 calls",
             landmarks_check=dict(ms=l16["apply_ms"], plain_ms=l16["apply_plain_ms"],
                                  bound_ms=l16["apply_bound"], library_ms=l16["library_ms"],
                                  max_abs_err=l16["apply_err"],
                                  profiler_kept=l16["apply_kept"],
                                  per=f"f_maps-64 bf16 forward of batch {LDMK_BATCH}, 27 calls"),
             **common),
        dict(name="gather_patches", source="tpu_mednet_torch/csrc/patches.cu",
             replaces="tpu_mednet/ops/pallas/patches.py:95",
             **gather_launches("serving", entry_k2["plain"], ldmk_k2["plain"],
                               surface_counts["gather_patches"], 0,
                               tools_counts["gather_patches"],
                               deploy_counts["gather_patches"], u3_all["gather_serving"],
                               par_all["gather_serving"]),
             max_abs_err=k2["err"],
             ms=k2["ms"], event_ms=k2["wrapper_ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound"], library_ms=None, profiler_kept=k2["kept"],
             library_call="none: no one PyTorch call gathers N windows at host "
                          "corners with the cast fused in",
             per="one batch of 8 tiles of 96^3, f16 -> bf16",
             brats_check=surface_k2["brats_check"], **common),
        dict(name="gn_bwd_reduce", source="tpu_mednet_torch/csrc/groupnorm.cu",
             **u3_checks("gn_bwd_reduce"),
             replaces="tpu_mednet/ops/pallas/groupnorm.py:149-175 (custom VJP of the "
                      "kernel at :94) with the normalize chain's autodiff",
             **launches("gn_bwd_reduce"), max_abs_err=bwd["err"], **fold_off("reduce"),
             ms=bwd["reduce_ms"], plain_ms=bwd["plain_ms"], bound_ms=bwd["reduce_bound"],
             profiler_kept=bwd["reduce_kept"],
             library_ms=bwd["library_ms"],
             library_call="torch autograd of F.group_norm + F.elu (both backward passes "
                          "together; plain_ms likewise)",
             per=f"train step of batch {TRAIN_BATCH}, bf16, 27 calls",
             landmarks_check=dict(ms=lbwd["reduce_ms"], plain_ms=lbwd["plain_ms"],
                                  bound_ms=lbwd["reduce_bound"], library_ms=lbwd["library_ms"],
                                  max_abs_err=lbwd["err"],
                                  profiler_kept=lbwd["reduce_kept"],
                                  per=f"f_maps-64 bf16 train step of batch {LDMK_BATCH}, "
                                      "27 calls"),
             **common),
        dict(name="gn_bwd_apply", source="tpu_mednet_torch/csrc/groupnorm.cu",
             **u3_checks("gn_bwd_apply"),
             by_shape=by_shape("bwd_apply_ms", "bwd_apply_bound", "bwd_library_ms"),
             replaces="tpu_mednet/ops/pallas/groupnorm.py:149-175 (custom VJP of the "
                      "kernel at :94) with the normalize chain's autodiff",
             **launches("gn_bwd_apply"), max_abs_err=bwd["err"],
             ms=bwd["apply_ms"], plain_ms=bwd["plain_ms"], bound_ms=bwd["apply_bound"],
             profiler_kept=bwd["apply_kept"],
             library_ms=bwd["library_ms"],
             library_call="torch autograd of F.group_norm + F.elu (both backward passes "
                          "together; plain_ms likewise)",
             per=f"train step of batch {TRAIN_BATCH}, bf16, 27 calls",
             landmarks_check=dict(ms=lbwd["apply_ms"], plain_ms=lbwd["plain_ms"],
                                  bound_ms=lbwd["apply_bound"], library_ms=lbwd["library_ms"],
                                  max_abs_err=lbwd["err"],
                                  profiler_kept=lbwd["apply_kept"],
                                  per=f"f_maps-64 bf16 train step of batch {LDMK_BATCH}, "
                                      "27 calls"),
             **common),
        dict(name="gather_patches_indexed", source="tpu_mednet_torch/csrc/patches.cu",
             replaces="tpu_mednet/ops/pallas/patches.py:95 (and the sampler's gather, "
                      "tpu_mednet/data/device_sampler.py:171-190)",
             **gather_launches("training", entry_k2["indexed"], ldmk_k2["indexed"], 0,
                               training_counts["gather_patches"], 0, 0,
                               u3_all["gather_indexed"], par_all["gather_indexed"]),
             max_abs_err=k2i["err"],
             ms=k2i["ms"], plain_ms=k2i["plain_ms"], bound_ms=k2i["bound"],
             profiler_kept=k2i["kept"], per_store=k2i["per_store"], copy_ms=k2i["copy_ms"],
             library_ms=None,
             library_call="none: no one PyTorch call gathers N windows of N subjects at "
                          "host corners",
             per=f"train step: images bf16 + labels uint8 in one launch, {TRAIN_BATCH} "
                 "windows of 96^3 (per_store: each store alone through the same kernel; "
                 "copy_ms: a device-to-device copy_ of the same bytes, a ceiling, not the "
                 "bound)",
             entry_points_check=dict(
                 ms=entry_k2["check_128"]["ms"], plain_ms=entry_k2["check_128"]["plain_ms"],
                 bound_ms=entry_k2["check_128"]["bound"], max_abs_err=0.0,
                 profiler_kept=entry_k2["check_128"]["kept"],
                 per_store=entry_k2["check_128"]["per_store"],
                 copy_ms=entry_k2["check_128"]["copy_ms"],
                 per=f"seg_organ device sampler: images bf16 + labels uint8 in one launch, "
                     f"{ORGAN_BATCH} windows of 128^3"),
             landmarks_check=dict(
                 ms=ldmk_k2["check"]["ms"], plain_ms=ldmk_k2["check"]["plain_ms"],
                 bound_ms=ldmk_k2["check"]["bound"], max_abs_err=0.0,
                 profiler_kept=ldmk_k2["check"]["kept"],
                 per_store=ldmk_k2["check"]["per_store"],
                 copy_ms=ldmk_k2["check"]["copy_ms"],
                 per=f"landmark device sampler: images bf16 + 4-channel uint8 labels "
                     f"(3 heatmaps + class map) in one launch, {LDMK_BATCH} windows of 96^3"),
             **common),
    ]
    log(smi.stdout.strip())  # again, so that the tail of a long log holds it
    log(json.dumps({"slice": slice_, **fwd}))
    log(json.dumps({"training": train, "parity": parity,
                    "gn_backward": k1b, "gather_indexed": k2i["per_store"]}))
    log(json.dumps({"entry_points": entry, "launches_by_run": entry_k2["per_run"],
                    "nonfinite_guard": guard, "gn_128": k1_organ, "gn_backward_128": k1b_organ}))
    log(json.dumps({"landmarks": ldmk, "launches_by_run": ldmk_k2["per_run"],
                    "parity": ldmk_parity, "gn_f64": k1_ldmk, "gn_backward_f64": k1b_ldmk}))
    log(json.dumps({"predict_surface": surface_all["surface"],
                    "launches_by_run": surface_k2["per_run"]}))
    log(json.dumps({"training_surface": training_all["surface"]}))
    tools = tools_all["tools"]
    log(json.dumps({"tools": {k: tools[k] for k in (
        "scores", "round_trip", "per_run", "cli_seconds", "quick_start_seconds",
        "demo_stores_ready_seconds", "seconds")}}))
    log(json.dumps({"tools_summary": dict(
        evaluate_mean_dice={k: v["mean_dice"] for k, v in tools["scores"].items()},
        round_trip={k: v["held"] for k, v in tools["round_trip"].items()},
        launches=tools_counts, seconds=tools["seconds"])}))
    deploy = deploy_all["deploy"]
    log(json.dumps({"deploy": deploy, "native_build": native_build}))
    log(json.dumps({"deploy_summary": dict(
        native_build=native_build, native_calls=deploy["native_calls"],
        batches_drawn=deploy["drawn"], step0_loss=deploy["step0_loss"],
        patches_per_s=deploy["patches_per_s"], idle_share=deploy["idle_share"],
        serving={k: deploy["serving"][k] for k in ("seg", "ldmk", "exports", "pinned_refusal")},
        profile={k: deploy["profile"][k] for k in ("file", "k1_kernels", "train_step_spans")},
        dispatcher_us=deploy["dispatcher_us"], launches=deploy_counts,
        seconds=deploy["seconds"])}))
    u3 = u3_all["unet3d"]
    log(json.dumps({"unet3d": u3, "gn_cases": u3_all["gn"]["cases"]}))
    log(json.dumps({"unet3d_summary": dict(
        forward_ms=u3["forward"]["fwd_ms"], k1_share=u3["forward"]["k1_share"],
        patches_per_s=u3["training"]["patches_per_s"],
        train_reserved_gib=u3["training"]["max_memory_reserved"] / 2**30,
        train_estimate_ratio=u3["training"]["ratio"],
        volumes_per_min={k: v["volumes_per_min"] for k, v in u3["serving"].items()},
        guard_ratio={k: v["guard_ratio"] for k, v in u3["serving"].items()},
        memory_fit_ratios=[round(pt["ratio"], 4) for pt in u3["memory_fit"]],
        launches=u3_counts, seconds=u3["seconds"])}))
    par = par_all["parallel"]
    log(json.dumps({"parallel": par}))
    log(json.dumps({"parallel_summary": dict(
        visualizer_ms={k: v["ms_per_call"] for k, v in par["visualizer"].items()},
        matplotlib=par["observability"]["matplotlib"],
        dp_median_step_ms_by_rank=par["dp"]["bench"]["median_step_ms"],
        dp_worst_rel={k: par["dp"][k]["worst_rel"] for k in ("fp32", "bf16", "cbr")},
        multitask_patches_per_s=par["multitask_dp"]["patches_per_s"],
        multitask_peak_gib=par["multitask_dp"]["peak_allocated_gib"],
        launches=par_counts, seconds=par["seconds"])}))
    sp = sp_all["spatial"]
    log(json.dumps({"spatial": {k: v for k, v in sp.items() if k != "k1"},
                    "k1_fold_off": sp["k1"]}))
    log(json.dumps({"spatial_summary": dict(
        worst_rel={k: sp[k]["worst_rel"] for k in ("bf16", "fp32", "mesh22", "remat1")},
        median_step_ms_by_rank=sp["step"]["median_step_ms"],
        one_process_step_ms=sp["step"]["one_process_median_step_ms"],
        peak_gib_by_rank=sp["step"]["peak_gib"],
        one_process_peak_gib=sp["step"]["one_process_peak_gib"],
        exchange_s_per_step=sp["step"]["exchange_s_per_step"],
        predict_ms={k: [v[f"rank{r}"]["ms"] for r in range(2)]
                    for k, v in sp["predict"].items() if k.startswith(("auto", "explicit"))},
        trainer_loss_err=sp["trainer"]["loss_err"], launches=sp_counts,
        seconds=sp["seconds"])}))
    log(json.dumps({"mfu": mfu}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
