#!/usr/bin/env python3
"""Smoke run of tpu_mednet_torch on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``tpu_mednet_torch/csrc``, holds each
kernel against its plain PyTorch version at the shapes of the main paths
(K1's forward and backward at the five level shapes, K2 plain and indexed
by subject), runs the full-width ResidualUNet3D forward on both paths,
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
  falls on one fixed batch.

Any failed check raises, so the script exits non-zero; it also exits
non-zero without a result when CUDA is unavailable or the package is not
beside it.

Output: the card's ``nvidia-smi`` name and power limit, one line per
check, a ``{"kernels": [...]}`` JSON line, and, last,
``{"ok": true, "device": {...}}``.  A kernel's time is its device time
from ``torch.profiler``; CUDA-event times around the wrapper calls, which
at small shapes measure the host, are printed beside it.  Bounds use the
H100 SXM peaks (3.35 TB/s HBM, 67 TFLOP/s fp32 without tensor cores).
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
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
    autograd) and K2 to its plain version (comparisons only)."""
    saved = (gn.group_norm, P.extract_patches)
    gn.group_norm = gn.group_norm_plain
    P.extract_patches = P.extract_patches_plain
    try:
        yield
    finally:
        gn.group_norm, P.extract_patches = saved


def launch_counts(gn, P):
    return dict(gn_moments=gn.STATS_LAUNCHES, gn_apply=gn.APPLY_LAUNCHES,
                gn_bwd_reduce=gn.BWD_REDUCE_LAUNCHES, gn_bwd_apply=gn.BWD_APPLY_LAUNCHES,
                gather_patches=P.LAUNCHES)


def reset_counts(gn, P):
    gn.STATS_LAUNCHES = gn.APPLY_LAUNCHES = 0
    gn.BWD_REDUCE_LAUNCHES = gn.BWD_APPLY_LAUNCHES = P.LAUNCHES = 0


def device_rows(torch, fn, reps):
    """(ms per call, launches per call, name) of every device activity that
    ``torch.profiler`` records over ``reps`` calls of ``fn``."""
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
            rows.append((us / reps / 1e3, evt.count // reps, evt.key))
    return rows


def kernel_ms(torch, fn, name, reps=20):
    """(device ms per call of the kernels whose name holds ``name``, device
    activities launched per call) over ``reps`` calls of ``fn``."""
    rows = device_rows(torch, fn, reps)
    return (sum(ms for ms, _, key in rows if name in key),
            sum(count for _, count, _ in rows))


def bf16_ulp(ref):
    """One bf16 ulp at each value of ``ref`` (8 significant bits)."""
    import torch

    _, exp = torch.frexp(ref.float())
    return torch.ldexp(torch.ones_like(ref, dtype=torch.float32), exp - 8).clamp_min(2.0**-133)


def check_gn(torch, gn, dev, gen):
    """K1 against its plain version at the five level shapes, bf16 and fp32:
    moments to rtol 1e-5 and bitwise equal from call to call, apply within
    one ulp; times per call and per forward."""
    cl3d = torch.channels_last_3d
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    keys = ("moments_ms", "moments_event_ms", "moments_plain_ms", "moments_bound",
            "moments_library_ms", "apply_ms", "apply_event_ms", "apply_plain_ms",
            "apply_bound", "library_ms", "moments_err", "apply_err")
    totals = {dt: dict.fromkeys(keys, 0.0) for dt in ("bf16", "fp32")}
    for dt_name, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
        tot = totals[dt_name]
        for level, (c, e, n_gn) in enumerate(LEVELS):
            shape = (BATCH, e, e, e, c)
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
            plan = gn.plan_moments(BATCH, e**3, c, esz, x.data_ptr() % 16 == 0, sms)
            t_m, launches = kernel_ms(torch, moments, "gn_moments")
            if launches != 1:
                raise AssertionError(f"the statistics side of one GroupNorm launched "
                                     f"{launches} device activities, not 1")
            t_me = cuda_ms(moments)
            t_mp = cuda_ms(lambda: gn.group_norm_moments_plain(x, GROUPS, w, 1e-5), reps=5)
            b_m = bound_ms(n_el * esz + 3 * BATCH * c * 4 + c * 4, 3 * n_el)
            # yardstick only: the same per-(n, c) moments up to a rescale
            t_sl = cuda_ms(lambda: torch.var_mean(x, dim=(2, 3, 4), correction=0))
            apply = lambda: gn.group_norm_apply(x, mean_c, mul_c, b, act="e")
            apply_r = lambda: gn.group_norm_apply(x, mean_c, mul_c, b, residual=r, act="e")
            t_a, t_ar = kernel_ms(torch, apply, "gn_apply")[0], kernel_ms(torch, apply_r, "gn_apply")[0]
            t_ae, t_are = cuda_ms(apply), cuda_ms(apply_r)
            t_ap = cuda_ms(lambda: gn.group_norm_apply_plain(x, mean_c, mul_c, b, act="e"), reps=5)
            t_arp = cuda_ms(lambda: gn.group_norm_apply_plain(
                x, mean_c, mul_c, b, residual=r, act="e"), reps=5)
            small = (2 * BATCH * c + c) * 4
            b_a = bound_ms(2 * n_el * esz + small, 5 * n_el)
            b_ar = bound_ms(3 * n_el * esz + small, 6 * n_el)
            t_lib = cuda_ms(lambda: torch.nn.functional.elu(
                torch.nn.functional.group_norm(x, GROUPS, w.to(dtype), b.to(dtype), 1e-5)))
            log(f"K1 {dt_name} level {level} {tuple(x.shape)}: moments {t_m:.4f} ms device "
                f"(event {t_me:.4f}; plain {t_mp:.4f}, bound {b_m:.4f}, torch.var_mean "
                f"{t_sl:.4f}), {launches} launch per GroupNorm, bulk={plan.bulk} "
                f"{plan.blocks} blocks/sample, max|err| {m_err:.3g}, two calls bitwise "
                f"equal; apply+elu {t_a:.4f} ms device (event {t_ae:.4f}; plain {t_ap:.4f}, "
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
            del x, r
        log(f"K1 {dt_name} per full-width forward (27 GroupNorms): moments "
            f"{tot['moments_ms']:.4f} ms device (event {tot['moments_event_ms']:.4f}; "
            f"bound {tot['moments_bound']:.4f}, torch.var_mean "
            f"{tot['moments_library_ms']:.4f}), apply {tot['apply_ms']:.4f} ms device "
            f"(event {tot['apply_event_ms']:.4f}; bound {tot['apply_bound']:.4f}), "
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
    rows = device_rows(torch, gather, reps)
    t_dev = sum(ms for ms, _, name in rows if "gather" in name.lower())
    n_el = BATCH * int(np.prod(PATCH))
    b = bound_ms(n_el * (2 + 2), 0)
    # no one PyTorch call gathers N windows at host corners with the cast
    # fused in, so K2 has no library time
    log(f"K2 {tuple(vol.shape)} f16 -> {BATCH}x{PATCH} bf16: kernel device time "
        f"{t_dev:.4f} ms (profiler, {reps} calls; bound {b:.4f}); {t:.4f} ms per wrapper "
        f"call (event; plain {t_p:.4f}); byte-equal in bf16/fp32/f16, max|err| {err}")
    for ms, count, name in sorted(rows, reverse=True):
        log(f"K2 profile: {ms:8.4f} ms  x{count:<3d} {name[:100]}")
    if t_dev == 0:
        raise AssertionError("the profiler saw no gather kernel")
    return dict(ms=t_dev, wrapper_ms=t, plain_ms=t_p, bound=b, err=err)


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


def profile_forward(torch, model, dev, gen, reps=3):
    """Device time of one bf16 forward by kernel, from torch.profiler."""
    x = torch.randn((BATCH, 1, *PATCH), generator=gen, device=dev)
    with torch.inference_mode():
        model(x)
        rows = [r for r in device_rows(torch, lambda: model(x), reps)
                if not r[2].startswith(("Memcpy", "Memset"))]
    total = sum(r[0] for r in rows)
    if total == 0:
        log("profile: the profiler saw no device time")
        return
    moments = [(ms, count) for ms, count, name in rows if "gn_moments" in name]
    stale = [name for _, _, name in rows if "gn_stats" in name or "gn_combine" in name]
    if stale or sum(count for _, count in moments) != sum(n for _, _, n in LEVELS):
        raise AssertionError(f"forward: expected one gn_moments launch per GroupNorm, "
                             f"got {moments} and {stale}")
    log(f"profile: statistics side per bf16 forward {sum(ms for ms, _ in moments):.4f} ms "
        f"device in {sum(count for _, count in moments)} gn_moments launches; "
        f"{sum(count for _, count, _ in rows)} device launches per forward")
    groups = {}
    for ms, _, name in rows:
        low = name.lower()
        group = ("K1 groupnorm" if "gn_" in low else "K2 gather" if "gather" in low
                 else "cuDNN conv" if any(t in low for t in ("conv", "xmma", "gemm", "cudnn",
                                                             "cutlass", "dgrad", "wgrad"))
                 else "other")
        groups[group] = groups.get(group, 0.0) + ms
    log(f"profile: device time per bf16 forward {total:.3f} ms; " + ", ".join(
        f"{g} {ms:.3f} ms ({100 * ms / total:.1f}%)" for g, ms in
        sorted(groups.items(), key=lambda kv: -kv[1])))
    for ms, count, name in sorted(rows, reverse=True)[:12]:
        log(f"profile:   {ms:8.3f} ms  x{count:<4d} {name[:110]}")


def tie_band_margin(torch, gn, P, model, vol, grid_corners, dev):
    """The plain path's top-2 logit margin at every voxel of ``vol``'s mask,
    and max |kernel - plain| over its tiles' logits.

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
        y = model(tiles)
        with plain_kernels(gn, P):
            y_p = model(tiles)
        err = max(err, float((y - y_p).abs().max()))
        m = (y_p[:, 0] - y_p[:, 1]).abs()
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
    rows = device_rows(torch, lambda: predict(tasks["bf16"]), 1)
    busy = sum(ms for ms, _, _ in rows) / 1e3
    log(f"slice bf16: device busy {busy:.4f} s per call (profiler, kernels and copies); "
        f"idle share {1 - busy / wall:.4f} of the median call")

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
                        device_busy_s=busy, n_batches=n_batches, agreement=agreement)


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


def check_gn_backward(torch, gn, dev, gen):
    """K1's backward kernels against ``group_norm_backward_plain`` at the
    five level shapes, bf16 at the training batch and fp32 at batch 8, with
    and without the residual, ELU as in the model; bitwise equal from call
    to call; device times per call and per train step beside the bound,
    the plain version and torch autograd of F.group_norm + F.elu."""
    import torch.nn.functional as F

    cl3d = torch.channels_last_3d
    out = {}
    for dt_name, dtype, batch in (("bf16", torch.bfloat16, TRAIN_BATCH),
                                  ("fp32", torch.float32, BATCH)):
        tot = dict(reduce_ms=0.0, apply_ms=0.0, reduce_bound=0.0, apply_bound=0.0,
                   plain_ms=0.0, library_ms=0.0, err=0.0)
        for level, (c, e, n_gn) in enumerate(LEVELS):
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
                t_r = kernel_ms(torch, bwd, "gn_bwd_reduce", reps=10)[0]
                t_a = kernel_ms(torch, bwd, "gn_bwd_apply", reps=10)[0]
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
                log(f"K1 backward {dt_name} level {level} {tuple(x.shape)} residual="
                    f"{res is not None}: reduce {t_r:.4f} ms device (bound {b_r:.4f}), "
                    f"apply {t_a:.4f} ms (bound {b_a:.4f}); plain {t_p:.4f} ms; "
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
        log(f"K1 backward {dt_name} per train step of batch {batch} (27 GroupNorms): "
            f"reduce {tot['reduce_ms']:.4f} ms device (bound {tot['reduce_bound']:.4f}), "
            f"apply {tot['apply_ms']:.4f} ms (bound {tot['apply_bound']:.4f}); plain "
            f"{tot['plain_ms']:.4f} ms; F.group_norm+F.elu autograd {tot['library_ms']:.4f} ms")
        out[dt_name] = tot
    return out


def check_gather_indexed(torch, P, sampler):
    """Indexed K2 on the training sampler's device stores (bf16 images,
    uint8 labels) at one batch of its own draws: byte-equal to plain."""
    subj, corners = sampler.sample_indices(TRAIN_BATCH)
    res = {}
    for name, store in (("image", sampler.images), ("label", sampler.labels)):
        gather = lambda: P.extract_patches(store, corners, PATCH, subjects=subj)
        got = gather()
        ref = P.extract_patches_plain(store, corners, PATCH, subjects=subj)
        if got.shape != ref.shape or not torch.equal(got.view(-1).view(torch.uint8),
                                                     ref.view(-1).view(torch.uint8)):
            raise AssertionError(f"indexed gather {name}: not byte-equal to plain")
        t_dev = kernel_ms(torch, gather, "gather", reps=20)[0]
        t_p = cuda_ms(lambda: P.extract_patches_plain(store, corners, PATCH, subjects=subj),
                      reps=3, warmup=1)
        n_bytes = 2 * got.numel() * got.element_size() + 16 * len(corners)
        res[name] = dict(ms=t_dev, plain_ms=t_p, bound=bound_ms(n_bytes, 0))
        log(f"K2 indexed {name} store {tuple(store.shape)} {store.dtype} -> "
            f"{tuple(got.shape)}: {t_dev:.4f} ms device (bound {res[name]['bound']:.4f}); "
            f"plain {t_p:.4f} ms; byte-equal")
    return dict(ms=res["image"]["ms"] + res["label"]["ms"],
                plain_ms=res["image"]["plain_ms"] + res["label"]["plain_ms"],
                bound=res["image"]["bound"] + res["label"]["bound"], err=0.0,
                per_store=res)


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
        elif "gather" in low:
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


def run_training(torch, gn, P, dev):
    """The training path: DevicePatchSampler -> create_train_state ->
    make_train_step at full width, bf16, batch 32, bench.py's augment;
    launches counted over the timed steps."""
    from tpu_mednet_torch.data import DevicePatchSampler, MemoryReader
    from tpu_mednet_torch.models import ResidualUNet3D
    from tpu_mednet_torch.ops.augment import AugmentConfig
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.train import create_train_state, make_train_step

    rng = np.random.default_rng(1)
    store = {"images": {}, "labels": {}}
    for key, shape in TRAIN_SUBJECTS:
        lbl = np.zeros((1, *shape), np.uint8)
        lbl[0, 40:100, 50:110, 30:90] = 1
        store["images"][key] = rng.normal(0.0, 0.5, size=(1, *shape)).astype(np.float32) + lbl
        store["labels"][key] = lbl
    sampler = DevicePatchSampler(None, [k for k, _ in TRAIN_SUBJECTS], TRAIN_BATCH // 4,
                                 PATCH, reader=MemoryReader(store),
                                 class_probabilities=[0.5, 0.5], seed=0, device=dev)
    k2 = check_gather_indexed(torch, P, sampler)

    def batches():
        while True:
            yield from sampler.batches(TRAIN_BATCH)

    feed = batches()
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
    expected = {k: TRAIN_STEPS * v for k, v in dict(
        gn_moments=27, gn_apply=27, gn_bwd_reduce=27, gn_bwd_apply=27,
        gather_patches=2).items()}
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
    rows = device_rows(torch, lambda: step(state, next(feed)), reps)
    busy = sum(ms for ms, _, _ in rows)
    groups = step_groups(rows)
    logits = torch.randn((TRAIN_BATCH, 2, *PATCH), device=dev, requires_grad=True)
    label = next(feed)["label"]

    def loss_pass():
        loss, _ = task.loss_fn(logits, {"label": label})
        loss.backward()

    loss_ms = sum(ms for ms, _, _ in device_rows(torch, loss_pass, reps))
    log(f"training profile: device time per step {busy:.3f} ms; idle share "
        f"{1 - busy / median:.4f} of the median step; " + ", ".join(
            f"{g} {ms:.3f} ms ({100 * ms / busy:.1f}%)"
            for g, ms in sorted(groups.items(), key=lambda kv: -kv[1]))
        + f"; the Dice loss forward+backward alone {loss_ms:.3f} ms (inside 'other')")
    for ms, count, name in sorted(rows, reverse=True)[:12]:
        log(f"training profile:   {ms:8.3f} ms  x{count:<4d} {name[:110]}")

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
                            device_ms_per_step=busy, idle_share=1 - busy / median,
                            groups=groups, loss_ms=loss_ms, losses=losses,
                            fixed_batch_losses=fixed_losses)


def main() -> int:
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
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    # 2. build
    t0 = time.perf_counter()
    lib = _build.build()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.BUILD_LOG.splitlines():
        if "spill" in line and "0 bytes spill stores, 0 bytes spill loads" not in line:
            log(f"ptxas: {line.strip()}")

    # 3-5. kernels against their plain versions, then the full-width forward
    k1 = check_gn(torch, gn, dev, gen)
    k1b = check_gn_backward(torch, gn, dev, gen)
    k2 = check_gather(torch, P, _grid_corners, dev, gen)
    models, fwd = check_forward(torch, gn, P, ResidualUNet3D, dev, gen)

    profile_forward(torch, models["bf16"], dev, gen)

    # 6. the serving path
    counts, slice_ = run_slice(torch, gn, P, models, _grid_corners, dev)

    # 7. the training path: full-width parity, then the counted steps
    parity = check_train_parity(torch, gn, P, models, dev, gen)
    del models
    torch.cuda.empty_cache()
    train_counts, k2i, train = run_training(torch, gn, P, dev)

    def launches(name):
        return dict(launches=counts[name] + train_counts[name],
                    launches_by_path=dict(serving=counts[name], training=train_counts[name]))

    b16, bwd = k1["bf16"], k1b["bf16"]
    common = dict(route="cuda", bound_by="bytes", ok=True)
    kernels = [
        dict(name="gn_moments", source="tpu_mednet_torch/csrc/groupnorm.cu",
             replaces="tpu_mednet/ops/pallas/groupnorm.py:94",
             **launches("gn_moments"), max_abs_err=b16["moments_err"],
             ms=b16["moments_ms"], event_ms=b16["moments_event_ms"],
             plain_ms=b16["moments_plain_ms"], bound_ms=b16["moments_bound"],
             library_ms=b16["moments_library_ms"],
             library_call="torch.var_mean (the same moments up to a rescale)",
             per="full-width bf16 forward, 27 calls", **common),
        dict(name="gn_apply", source="tpu_mednet_torch/csrc/groupnorm.cu",
             replaces="tpu_mednet/ops/pallas/groupnorm.py:94",
             **launches("gn_apply"), max_abs_err=b16["apply_err"],
             ms=b16["apply_ms"], event_ms=b16["apply_event_ms"],
             plain_ms=b16["apply_plain_ms"], bound_ms=b16["apply_bound"],
             library_ms=b16["library_ms"],
             library_call="F.group_norm + F.elu (statistics and apply together)",
             per="full-width bf16 forward, 27 calls", **common),
        dict(name="gather_patches", source="tpu_mednet_torch/csrc/patches.cu",
             replaces="tpu_mednet/ops/pallas/patches.py:95",
             launches=counts["gather_patches"], max_abs_err=k2["err"],
             ms=k2["ms"], event_ms=k2["wrapper_ms"], plain_ms=k2["plain_ms"],
             bound_ms=k2["bound"], library_ms=None,
             library_call="none: no one PyTorch call gathers N windows at host "
                          "corners with the cast fused in",
             per="one batch of 8 tiles of 96^3, f16 -> bf16", **common),
        dict(name="gn_bwd_reduce", source="tpu_mednet_torch/csrc/groupnorm.cu",
             replaces="tpu_mednet/ops/pallas/groupnorm.py:149-175 (custom VJP of the "
                      "kernel at :94) with the normalize chain's autodiff",
             launches=train_counts["gn_bwd_reduce"], max_abs_err=bwd["err"],
             ms=bwd["reduce_ms"], plain_ms=bwd["plain_ms"], bound_ms=bwd["reduce_bound"],
             library_ms=bwd["library_ms"],
             library_call="torch autograd of F.group_norm + F.elu (both backward passes "
                          "together; plain_ms likewise)",
             per=f"train step of batch {TRAIN_BATCH}, bf16, 27 calls", **common),
        dict(name="gn_bwd_apply", source="tpu_mednet_torch/csrc/groupnorm.cu",
             replaces="tpu_mednet/ops/pallas/groupnorm.py:149-175 (custom VJP of the "
                      "kernel at :94) with the normalize chain's autodiff",
             launches=train_counts["gn_bwd_apply"], max_abs_err=bwd["err"],
             ms=bwd["apply_ms"], plain_ms=bwd["plain_ms"], bound_ms=bwd["apply_bound"],
             library_ms=bwd["library_ms"],
             library_call="torch autograd of F.group_norm + F.elu (both backward passes "
                          "together; plain_ms likewise)",
             per=f"train step of batch {TRAIN_BATCH}, bf16, 27 calls", **common),
        dict(name="gather_patches_indexed", source="tpu_mednet_torch/csrc/patches.cu",
             replaces="tpu_mednet/ops/pallas/patches.py:95 (and the sampler's gather, "
                      "tpu_mednet/data/device_sampler.py:171-190)",
             launches=train_counts["gather_patches"], max_abs_err=k2i["err"],
             ms=k2i["ms"], plain_ms=k2i["plain_ms"], bound_ms=k2i["bound"],
             library_ms=None,
             library_call="none: no one PyTorch call gathers N windows of N subjects at "
                          "host corners",
             per=f"train step: images bf16 + labels uint8, {TRAIN_BATCH} windows of 96^3",
             **common),
    ]
    log(json.dumps({"slice": slice_, **fwd}))
    log(json.dumps({"training": train, "parity": parity,
                    "gn_backward": k1b, "gather_indexed": k2i["per_store"]}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
