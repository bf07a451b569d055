#!/usr/bin/env python3
"""Fit of the device-memory model's constants on one NVIDIA card.

    python3 chip_memory_fit.py [--out memory_fit.json] [--train-only | --double-only | --swin-only]

Inference (the HBM guard's constants; skipped with ``--train-only``):

Runs one volume at a time through the two on-device stitches
(``predict_volumes_on_device`` and ``predict_volumes_weighted_on_device``,
``hbm_guard='off'``) with full-width ``ResidualUNet3D``s (f_maps 32, bf16,
seeded weights) at the ``configs/predict.yaml`` geometry (96^3 tiles,
overlap 16, batch 8): 1 input channel and 2 classes (the flagship), 4 and
2, and 4 and 4 (``configs/seg_brats_bf16.yaml``); volumes of 192^3, 320^3
and 512^3; n_tta 1 and 8 (``tta_flips=(0, 1, 2)``); and, per model, one
call of two 192^3 volumes (the pipeline holds one volume's result while
it dispatches the next).  Before each run it empties the allocator's
cache and resets its peak; after it, it reads
``torch.cuda.max_memory_reserved`` (what the card must hold) and
``max_memory_allocated``.  For every point it prints the guard's estimate
(``utils/memory.device_stitch_bytes`` with the module's constants) and the
ratio estimate / measured, which must lie in [1, 1.3], and the least
``INFER_WORK_UNITS`` and ``TTA_WORK_UNITS`` that would cover every point
with the other constants as they are.  Last, the guard's edge: the
largest cube (a multiple of 16 voxels) of the 4-input, 4-class model whose
Gaussian-stitch estimate the guard admits under its default budget
(``utils/memory.hbm_budget_bytes``: the card's free memory plus the
allocator's reservation) runs with ``hbm_guard='error'``; it must pass the
guard, fit the card and hold the same ratio.

Training (``unet_train_peak_bytes``): the train step (Adam, mirror flips,
bf16, seeded weights, a seeded batch on the card) of ``ResidualUNet3D``
f_maps 32 with 1 input channel and 2 classes at batch 8, 16 and 32 of
96^3 with remat 0, 1 and all; of ``configs/seg_brats_bf16.yaml``'s model
(4 inputs, 4 classes, Dice) at batch 2 of 128^3 and of
``configs/landmarks.yaml``'s ``LandmarkTask`` (f_maps 64, 3 heatmaps and 2
classes) at batch 4 of 96^3, each with remat 0 and 1; and of ``UNet3D``
(the ``double`` family at its defaults: f_maps 64, 4 levels, order
``gcr``; 1 input channel, 3 classes) at batch 4, 8 and 16 of 96^3 with
remat 0 and 1.  After ``empty_cache`` and ``reset_peak_memory_stats``,
three steps; then ``max_memory_reserved`` against the estimate with the
module's constants, printed with the estimate's terms (the stored
activations, the fp32 GroupNorm units, the double family's join
temporaries, the full-resolution unit and the parameters) from which the
constants are fit.  ``--train-only`` runs this half alone; ``--double-only``
runs its UNet3D points and the inference half's UNet3D points alone:
``UNet3D(1, 3)`` in orders ``gcr`` and ``cbr`` through both stitches, one
volume of 192^3 and 320^3 (n_tta 1) and of 192^3 (n_tta 8), each against
the guard's estimate with its double-family terms, with the windows of
``JOIN_INFER_UNITS`` and ``NORM_FIRST_UNITS`` that keep them all in [1, 1.3].
``--swin-only`` runs Swin UNETR's inference points alone
(``infer_swin_fit``): the estimate from the model's own
``config.infer_peak_bytes`` and the window of ``SWIN_INFER_WORK_UNITS``.

It exits non-zero where a ratio leaves [1, 1.3] or the edge volume does
not fit.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
SIZES = (192, 320, 512)
MODELS = ((1, 2), (4, 2), (4, 4))  # (input channels, classes)
PATCH, OVERLAP, BATCH = (96, 96, 96), (16, 16, 16), 8
TTAS = ((), (0, 1, 2))
RATIO = (1.0, 1.3)
# training points: (name, input channels, classes, heatmaps, f_maps, patch,
# batches, remat settings, block)
TRAIN_MODELS = (("f_maps 32, 1 -> 2", 1, 2, 0, 32, (96, 96, 96), (8, 16, 32), (0, 1, True),
                 "residual"),
                ("seg_brats_bf16", 4, 4, 0, 32, (128, 128, 128), (2,), (0, 1), "residual"),
                ("landmarks", 1, 2, 3, 64, (96, 96, 96), (4,), (0, 1), "residual"),
                ("UNet3D gcr", 1, 3, 0, 64, (96, 96, 96), (4, 8, 16), (0, 1), "double"))
TRAIN_STEPS = 3


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_memory_fit: CUDA is not available; this run needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from tpu_mednet_torch.data import MemoryReader
    from tpu_mednet_torch.inference import (predict_volumes_on_device,
                                            predict_volumes_weighted_on_device)
    from tpu_mednet_torch.models import ResidualUNet3D
    from tpu_mednet_torch.ops import _build
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.utils import memory

    out_path = Path(argv[argv.index("--out") + 1]) if "--out" in argv else None
    double_only = "--double-only" in argv
    train_only = "--train-only" in argv or double_only
    smi = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    _build.build()
    dev = torch.device("cuda", 0)
    stitches = {"device": predict_volumes_on_device,
                "gaussian": predict_volumes_weighted_on_device}
    kw = dict(patch_size=list(PATCH), patch_overlap=list(OVERLAP), batch_size=BATCH,
              device=dev, hbm_guard="off")
    rng = np.random.default_rng(0)
    points = []
    if "--swin-only" in argv:
        swin = infer_swin_fit(torch, dev, memory, kw, rng)
        if out_path is not None:
            out_path.parent.mkdir(parents=True, exist_ok=True)
            out_path.write_text(json.dumps(dict(card=smi, infer_swin=swin), indent=1))
        return 0 if swin["ok"] else 1
    if train_only:
        double = infer_double_fit(torch, dev, memory, kw, rng) if double_only else None
        train = train_fit(torch, dev, memory, double_only)
        result = dict(card=smi, train=train, ok=train["ok"] and (double or {}).get("ok", True),
                      infer_double=double)
        print(json.dumps({k: v for k, v in train.items() if k != "points"}), flush=True)
        if out_path is not None:
            out_path.parent.mkdir(parents=True, exist_ok=True)
            out_path.write_text(json.dumps(result, indent=1))
        return 0 if result["ok"] else 1

    def measure(fn, task, store, keys, tta):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        fn(task, None, keys, reader=MemoryReader(store), tta_flips=tta, **kw)
        torch.cuda.synchronize()
        return (torch.cuda.max_memory_reserved(dev), torch.cuda.max_memory_allocated(dev),
                time.perf_counter() - t0)

    for c_in, classes in MODELS:
        model = ResidualUNet3D(c_in, classes, f_maps=32, dtype=torch.bfloat16, device=dev,
                               generator=torch.Generator().manual_seed(0))
        task = SegmentationTask(model=model)
        fmaps = model.config.feature_maps
        params_b = memory.param_bytes(model)
        unit0 = memory._unit_bytes(BATCH, PATCH, 0, fmaps[0], 2)
        tta_unit = BATCH * float(np.prod(PATCH)) * classes * 4
        warm = {"images": {"w": rng.standard_normal((c_in, 96, 96, 96), np.float32)
                           .astype(np.float16)}}
        for fn in stitches.values():  # cuDNN and cuBLAS handles, the kernels' library
            fn(task, None, ["w"], reader=MemoryReader(warm), **kw)
        for size in SIZES:
            vol = rng.standard_normal((c_in, size, size, size), np.float32).astype(np.float16)
            store = {"images": {"v": vol, "v2": vol}}
            for stitch, fn in stitches.items():
                for tta in TTAS:
                    runs = [(1, ["v"])] + ([(2, ["v", "v2"])] if size == SIZES[0] and not tta
                                           else [])
                    for n_vol, keys in runs:
                        reserved, allocated, seconds = measure(fn, task, store, keys, tta)
                        n_tta = 2 ** len(tta)
                        est, breakdown = memory.device_stitch_bytes(
                            (size,) * 3, PATCH, OVERLAP, BATCH, c_in, 1, fmaps, stitch=stitch,
                            params_bytes=params_b, n_tta=n_tta, acc_channels=classes)
                        # the estimate without its fitted terms: what they must cover
                        fixed = est - memory.INFER_WORK_UNITS * unit0 - (
                            memory.TTA_WORK_UNITS * tta_unit if n_tta > 1 else 0)
                        if breakdown["peak_phase_scan"] < breakdown["peak_phase_final"]:
                            fixed = est  # the finalize phase sets the peak
                        points.append(dict(
                            in_channels=c_in, classes=classes, stitch=stitch, size=size,
                            volumes=n_vol, n_tta=n_tta, reserved=reserved,
                            allocated=allocated, estimate=est, ratio=est / reserved,
                            residual=reserved - fixed, unit0=unit0, tta_unit=tta_unit,
                            seconds=seconds, breakdown=breakdown))
                        print(f"in {c_in} classes {classes} {stitch:8s} {n_vol} x {size}^3 "
                              f"n_tta {n_tta}: max_memory_reserved {reserved / 2**30:.3f} GiB "
                              f"(allocated {allocated / 2**30:.3f}), estimate "
                              f"{est / 2**30:.3f} GiB, ratio {est / reserved:.3f}; "
                              f"{seconds:.2f} s", flush=True)
            del vol, store
        del model, task

    work = max(p["residual"] / p["unit0"] for p in points if p["n_tta"] == 1)
    tta = max((p["residual"] - work * p["unit0"]) / p["tta_unit"]
              for p in points if p["n_tta"] > 1)
    ok = all(RATIO[0] <= p["ratio"] <= RATIO[1] for p in points)
    print(f"least constants covering every point: INFER_WORK_UNITS {work:.3f}, "
          f"TTA_WORK_UNITS {tta:.3f} (module: {memory.INFER_WORK_UNITS}, "
          f"{memory.TTA_WORK_UNITS}); every ratio in {list(RATIO)}: {ok}", flush=True)
    edge = guard_edge(torch, dev, rng, kw, memory, ResidualUNet3D, SegmentationTask,
                      MemoryReader, predict_volumes_weighted_on_device)
    ok = ok and edge["fits"] and RATIO[0] <= edge["ratio"] <= RATIO[1]
    double = infer_double_fit(torch, dev, memory, kw, rng)
    train = train_fit(torch, dev, memory)
    result = dict(card=smi, infer_work_units=memory.INFER_WORK_UNITS,
                  tta_work_units=memory.TTA_WORK_UNITS, least_infer_work_units=work,
                  least_tta_work_units=tta, ok=ok and train["ok"] and double["ok"], edge=edge,
                  points=points, infer_double=double, train=train)
    print(json.dumps({k: v for k, v in result.items() if k not in ("points", "train")}),
          flush=True)
    print(json.dumps({k: v for k, v in train.items() if k != "points"}), flush=True)
    if out_path is not None:
        out_path.parent.mkdir(parents=True, exist_ok=True)
        out_path.write_text(json.dumps(result, indent=1))
    return 0 if ok else 1


def infer_double_fit(torch, dev, memory, kw, rng):
    """The HBM guard's double-family term: ``UNet3D(1, 3)`` at its defaults
    in orders ``gcr`` and ``cbr`` (seeded weights, bf16) through both
    on-device stitches, one volume of 192^3 and 320^3 with n_tta 1 and of
    192^3 with n_tta 8: peak reserved memory against the estimate, and the
    window of ``JOIN_INFER_UNITS`` and of ``NORM_FIRST_UNITS`` (each with
    the other as it is) that keeps every point in [1, 1.3]."""
    from tpu_mednet_torch.data import MemoryReader
    from tpu_mednet_torch.inference import (predict_volumes_on_device,
                                            predict_volumes_weighted_on_device)
    from tpu_mednet_torch.models import UNet3D
    from tpu_mednet_torch.tasks import SegmentationTask

    stitches = {"device": predict_volumes_on_device,
                "gaussian": predict_volumes_weighted_on_device}
    points = []
    for order in ("gcr", "cbr"):
        model = UNet3D(1, 3, layer_order=order, dtype=torch.bfloat16, device=dev,
                       generator=torch.Generator().manual_seed(0))
        task = SegmentationTask(model=model)
        fmaps = model.config.feature_maps
        params_b = memory.param_bytes(model)
        join = memory._unit_bytes(BATCH, PATCH, 0, fmaps[0] + fmaps[1], 2)
        first = memory.norm_before_conv(order)
        warm = {"images": {"w": rng.standard_normal((1, 96, 96, 96), np.float32)
                           .astype(np.float16)}}
        for fn in stitches.values():
            fn(task, None, ["w"], reader=MemoryReader(warm), **kw)
        for size, tta in ((192, ()), (320, ()), (192, (0, 1, 2))):
            vol = rng.standard_normal((1, size, size, size), np.float32).astype(np.float16)
            for stitch, fn in stitches.items():
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                fn(task, None, ["v"], reader=MemoryReader({"images": {"v": vol}}),
                   tta_flips=tta, **kw)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
                reserved = torch.cuda.max_memory_reserved(dev)
                n_tta = 2 ** len(tta)
                est, _ = memory.device_stitch_bytes(
                    (size,) * 3, PATCH, OVERLAP, BATCH, 1, 1, fmaps, stitch=stitch,
                    params_bytes=params_b, n_tta=n_tta, acc_channels=3, block="double",
                    layer_order=order)
                rest = est - (memory.JOIN_INFER_UNITS
                              + (memory.NORM_FIRST_UNITS if first else 0.0)) * join
                points.append(dict(order=order, stitch=stitch, size=size, n_tta=n_tta,
                                   reserved=reserved, estimate=est, ratio=est / reserved,
                                   rest=rest, join=join, norm_first=first,
                                   seconds=seconds))
                print(f"infer UNet3D {order} {stitch:8s} {size}^3 n_tta {n_tta}: "
                      f"max_memory_reserved {reserved / 2**30:.3f} GiB, estimate "
                      f"{est / 2**30:.3f} GiB, ratio {est / reserved:.3f}; {seconds:.2f} s",
                      flush=True)
            del vol
        del model, task
    # the window of each constant with the other as it is
    windows = {}
    for name, sel in (("JOIN_INFER_UNITS", lambda p: True),
                      ("NORM_FIRST_UNITS", lambda p: p["norm_first"])):
        held = [p for p in points if sel(p)]
        windows[name] = [getattr(memory, name) + max(
                             (RATIO[0] * p["reserved"] - p["estimate"]) / p["join"]
                             for p in held),
                         getattr(memory, name) + min(
                             (RATIO[1] * p["reserved"] - p["estimate"]) / p["join"]
                             for p in held)]
    ok = all(RATIO[0] <= p["ratio"] <= RATIO[1] for p in points)
    print(f"inference, UNet3D: JOIN_INFER_UNITS {memory.JOIN_INFER_UNITS}, NORM_FIRST_UNITS "
          f"{memory.NORM_FIRST_UNITS}; each one's window with the other as it is, keeping "
          f"every point in {list(RATIO)}: " + ", ".join(
              f"{k} [{lo:.3f}, {hi:.3f}]" for k, (lo, hi) in windows.items())
          + f"; every ratio in {list(RATIO)}: {ok}", flush=True)
    return dict(ok=ok, join_infer_units=memory.JOIN_INFER_UNITS,
                norm_first_units=memory.NORM_FIRST_UNITS, windows=windows, points=points)


def infer_swin_fit(torch, dev, memory, kw, rng):
    """The HBM guard's Swin UNETR term: ``SwinUNETR`` at BTCV's widths
    (feature_size 48, 1 input channel, 14 classes; seeded weights, bf16)
    through both on-device stitches, one volume of 192^3 and 320^3 with
    n_tta 1 and of 192^3 with n_tta 8 at batch 8, and of 192^3 at batch 2
    and 1 (where the masks, which do not grow with the batch, weigh most):
    peak reserved (and allocated) memory against the estimate from the
    model's own ``config.infer_peak_bytes``, and the window of
    ``SWIN_INFER_WORK_UNITS`` that keeps every point in [1, 1.3]."""
    from tpu_mednet_torch.data import MemoryReader
    from tpu_mednet_torch.inference import (predict_volumes_on_device,
                                            predict_volumes_weighted_on_device)
    from tpu_mednet_torch.models import SwinUNETR, SwinUNETRConfig
    from tpu_mednet_torch.tasks import SegmentationTask

    stitches = {"device": predict_volumes_on_device,
                "gaussian": predict_volumes_weighted_on_device}
    classes = 14
    model = SwinUNETR(SwinUNETRConfig(1, classes, 48), device=dev,
                      generator=torch.Generator().manual_seed(0))
    task = SegmentationTask(model=model)
    params_b = memory.param_bytes(model)
    points = []
    warm = {"images": {"w": rng.standard_normal((1, 96, 96, 96), np.float32)
                       .astype(np.float16)}}
    for batch in (8, 2, 1):
        for fn in stitches.values():
            fn(task, None, ["w"], reader=MemoryReader(warm), **dict(kw, batch_size=batch))
    for size, tta, batch in ((192, (), 8), (320, (), 8), (192, (0, 1, 2), 8), (192, (), 2),
                             (192, (), 1)):
        vol = rng.standard_normal((1, size, size, size), np.float32).astype(np.float16)
        unit0 = memory._unit_bytes(batch, PATCH, 0, 48, 2)
        for stitch, fn in stitches.items():
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.perf_counter()
            fn(task, None, ["v"], reader=MemoryReader({"images": {"v": vol}}),
               tta_flips=tta, **dict(kw, batch_size=batch))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            reserved = torch.cuda.max_memory_reserved(dev)
            allocated = torch.cuda.max_memory_allocated(dev)
            n_tta = 2 ** len(tta)
            est, _ = memory.device_stitch_bytes(
                (size,) * 3, PATCH, OVERLAP, batch, 1, 1, stitch=stitch,
                params_bytes=params_b, n_tta=n_tta, acc_channels=classes,
                net_bytes=model.config.infer_peak_bytes(batch, PATCH))
            points.append(dict(stitch=stitch, size=size, n_tta=n_tta, batch=batch,
                               reserved=reserved, allocated=allocated, estimate=est,
                               ratio=est / reserved, unit0=unit0, seconds=seconds))
            print(f"infer Swin UNETR {stitch:8s} {size}^3 n_tta {n_tta} batch {batch}: "
                  f"max_memory_reserved {reserved / 2**30:.3f} GiB (allocated "
                  f"{allocated / 2**30:.3f}), estimate {est / 2**30:.3f} GiB, ratio "
                  f"{est / reserved:.3f}; {seconds:.2f} s", flush=True)
        del vol
    window = [memory.SWIN_INFER_WORK_UNITS + max((RATIO[0] * p["reserved"] - p["estimate"])
                                                 / p["unit0"] for p in points),
              memory.SWIN_INFER_WORK_UNITS + min((RATIO[1] * p["reserved"] - p["estimate"])
                                                 / p["unit0"] for p in points)]
    ok = all(RATIO[0] <= p["ratio"] <= RATIO[1] for p in points)
    print(f"inference, Swin UNETR: SWIN_INFER_WORK_UNITS {memory.SWIN_INFER_WORK_UNITS}; "
          f"the window keeping every point in {list(RATIO)}: [{window[0]:.3f}, "
          f"{window[1]:.3f}]; every ratio in {list(RATIO)}: {ok}", flush=True)
    return dict(ok=ok, swin_infer_work_units=memory.SWIN_INFER_WORK_UNITS, window=window,
                points=points)


def train_terms(memory, **kw):
    """The estimate's terms at one point: the stored activations (bytes
    before the overhead factor), the bytes of one fp32 GroupNorm unit per
    stored full-resolution conv, the double family's join temporaries and
    the parameters' bytes."""
    consts = ("TRAIN_OVERHEAD", "DOUBLE_OVERHEAD", "GN_F32_UNITS", "TRAIN_WORK_UNITS",
              "JOIN_UNITS")
    saved = [getattr(memory, c) for c in consts]
    try:
        def est(overhead, gn, join, params):
            (memory.TRAIN_OVERHEAD, memory.DOUBLE_OVERHEAD, memory.GN_F32_UNITS,
             memory.TRAIN_WORK_UNITS, memory.JOIN_UNITS) = overhead, overhead, gn, 0.0, join
            return memory.unet_train_peak_bytes(**{**kw, "n_params": params})
        act = est(1.0, 0.0, 0.0, 0)
        return dict(activations=act, gn_f32_unit=est(1.0, 1.0, 0.0, 0) - act,
                    join=est(0.0, 0.0, 1.0, 0), params=est(0.0, 0.0, 0.0, kw["n_params"]))
    finally:
        for c, v in zip(consts, saved):
            setattr(memory, c, v)


def train_fit(torch, dev, memory, double_only=False):
    """Peak reserved memory of the train step at every ``TRAIN_MODELS``
    point (the UNet3D points alone with ``double_only``) against
    ``unet_train_peak_bytes``."""
    import dataclasses

    from tpu_mednet_torch.models import ResidualUNet3D, UNet3D
    from tpu_mednet_torch.ops.augment import AugmentConfig
    from tpu_mednet_torch.tasks import LandmarkTask, SegmentationTask
    from tpu_mednet_torch.train import create_train_state, make_train_step

    points = []
    for (name, c_in, classes, heatmaps, f_maps, patch, batches, remats,
         block) in TRAIN_MODELS:
        if double_only and block != "double":
            continue
        build = UNet3D if block == "double" else ResidualUNet3D
        model = build(c_in, classes + heatmaps, f_maps=f_maps, dtype=torch.bfloat16,
                      device=dev, generator=torch.Generator().manual_seed(0))
        task = (LandmarkTask(model=model, loss_regression_weight=[0.015] * heatmaps)
                if heatmaps else SegmentationTask(model=model, loss="DICE"))
        n_params = sum(p.numel() for p in model.parameters())
        fmaps = model.config.feature_maps
        gen = torch.Generator(device=dev).manual_seed(1)
        for batch in batches:
            data = torch.randn((batch, c_in, *patch), generator=gen, device=dev,
                               dtype=torch.bfloat16)
            cls = torch.randint(0, classes, (batch, 1, *patch), generator=gen, device=dev,
                                dtype=torch.uint8)
            hm = torch.randint(0, 256, (batch, heatmaps, *patch), generator=gen, device=dev,
                               dtype=torch.uint8)
            batch_ = {"data": data, "label": torch.cat([hm, cls], 1)}
            for remat in remats:
                model.config = dataclasses.replace(model.config, remat=remat)
                model.zero_grad(set_to_none=True)
                state = create_train_state(model, learning_rate=1e-3, seed=0)
                step = make_train_step(task, augment=AugmentConfig(mirror_axes=(1, 2, 3)))
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.perf_counter()
                for _ in range(TRAIN_STEPS):
                    state, metrics = step(state, batch_)
                loss = float(metrics["train_loss"])
                seconds = time.perf_counter() - t0
                reserved = torch.cuda.max_memory_reserved(dev)
                allocated = torch.cuda.max_memory_allocated(dev)
                kw = dict(batch=batch, patch=patch, feature_maps=fmaps, in_channels=c_in,
                          out_channels=classes + heatmaps, n_params=n_params, remat=remat,
                          block=block)
                est = memory.unet_train_peak_bytes(**kw)
                terms = train_terms(memory, **kw)
                points.append(dict(model=name, batch=batch, remat=str(remat).lower(),
                                   reserved=reserved, allocated=allocated, estimate=est,
                                   ratio=est / reserved, loss=loss, seconds=seconds,
                                   unit0=memory._unit_bytes(batch, patch, 0, fmaps[0], 2),
                                   **terms))
                print(f"train {name} batch {batch} of {patch[0]}^3 remat {str(remat).lower()}: "
                      f"max_memory_reserved {reserved / 2**30:.3f} GiB (allocated "
                      f"{allocated / 2**30:.3f}), estimate {est / 2**30:.3f} GiB, ratio "
                      f"{est / reserved:.3f}; terms {json.dumps(terms)}; loss {loss:.4f}; "
                      f"{seconds:.2f} s", flush=True)
                del state, step
            del data, cls, hm, batch_
        del model, task
    ok = all(RATIO[0] <= p["ratio"] <= RATIO[1] for p in points)
    print(f"training: every ratio in {list(RATIO)}: {ok} (TRAIN_OVERHEAD "
          f"{memory.TRAIN_OVERHEAD}, GN_F32_UNITS {memory.GN_F32_UNITS}, TRAIN_WORK_UNITS "
          f"{memory.TRAIN_WORK_UNITS}, DOUBLE_OVERHEAD {memory.DOUBLE_OVERHEAD}, JOIN_UNITS "
          f"{memory.JOIN_UNITS})", flush=True)
    return dict(ok=ok, train_overhead=memory.TRAIN_OVERHEAD, gn_f32_units=memory.GN_F32_UNITS,
                train_work_units=memory.TRAIN_WORK_UNITS,
                double_overhead=memory.DOUBLE_OVERHEAD, join_units=memory.JOIN_UNITS,
                points=points)


def guard_edge(torch, dev, rng, kw, memory, ResidualUNet3D, SegmentationTask, MemoryReader,
               predict):
    """The largest 4-input, 4-class cube the guard admits on the Gaussian
    stitch, run with the guard on: does what it admits fit?"""
    c_in, classes = MODELS[-1]
    model = ResidualUNet3D(c_in, classes, f_maps=32, dtype=torch.bfloat16, device=dev,
                           generator=torch.Generator().manual_seed(0))
    task = SegmentationTask(model=model)
    fmaps, params_b = model.config.feature_maps, memory.param_bytes(model)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    budget = memory.hbm_budget_bytes(dev)

    def estimate(size):
        return memory.device_stitch_bytes((size,) * 3, PATCH, OVERLAP, BATCH, c_in, 1, fmaps,
                                          stitch="gaussian", params_bytes=params_b,
                                          acc_channels=classes)[0]

    size = SIZES[-1]
    while estimate(size + 16) <= budget:
        size += 16
    # seeded 16-plane slabs repeated along z: the memory does not depend on the values
    vol = np.empty((c_in, size, size, size), np.float16)
    slab = rng.standard_normal((c_in, size, size, 16), np.float32).astype(np.float16)
    for z in range(0, size, 16):
        vol[..., z:z + 16] = slab[..., :size - z]
    del slab
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    try:
        out = predict(task, None, ["edge"], reader=MemoryReader({"images": {"edge": vol}}),
                      **{**kw, "hbm_guard": "error"})
        torch.cuda.synchronize()
        fits, error = out["edge"].shape == (1, size, size, size), None
    except torch.cuda.OutOfMemoryError as exc:
        fits, error = False, str(exc).splitlines()[0]
    seconds = time.perf_counter() - t0
    reserved = torch.cuda.max_memory_reserved(dev)
    allocated = torch.cuda.max_memory_allocated(dev)
    est = estimate(size)
    edge = dict(in_channels=c_in, classes=classes, stitch="gaussian", size=size,
                budget=budget, estimate=est, next_estimate=estimate(size + 16),
                reserved=reserved, allocated=allocated, ratio=est / reserved, fits=fits,
                error=error, seconds=seconds)
    print(f"guard edge: in {c_in} classes {classes} gaussian {size}^3 n_tta 1: estimate "
          f"{est / 2**30:.3f} GiB of a {budget / 2**30:.3f} GiB budget ({size + 16}^3 would "
          f"need {edge['next_estimate'] / 2**30:.3f}); admitted and "
          f"{'fits' if fits else 'does NOT fit: ' + str(error)}: max_memory_reserved "
          f"{reserved / 2**30:.3f} GiB (allocated {allocated / 2**30:.3f}), ratio "
          f"{est / reserved:.3f}; {seconds:.2f} s", flush=True)
    return edge


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
