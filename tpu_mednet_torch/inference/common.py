"""Shared plumbing for the inference pipelines.

Counterpart of ``tpu_mednet/inference/common.py``: the depth-1
dispatch/finalize pipeline over volumes (CUDA launches
are asynchronous, so dispatching the next volume queues its work on the
card while the previous volume's result is copied back to the host — the
same overlap JAX's async dispatch gave), and mirror test-time
augmentation with its activation-space pair (``split_activations`` /
``postprocess_activations``), which every stitch shares.  Tensors are
NCDHW: TTA's spatial axis ``a`` is tensor dim ``a + 2``.  Also the body
both on-device stitches share (``predict_on_device``: the grid plan, the
HBM guard's split, the upload, the spill to a host stitch), and the
round-robin placement of data-parallel inference: one process deals
volume ``i`` (a ``crop`` stitch, batch ``i``) to ``devices[i % n]``, each
device holding its own copy of the weights, placed once and reused.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from itertools import chain, combinations, count
from typing import Callable, Iterable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_mednet_torch._device import DeviceLike, resolve_device
from tpu_mednet_torch.data.readers import DataReader, open_reader
from tpu_mednet_torch.data.stores import VolumeGroup
from tpu_mednet_torch.utils import tracing
from tpu_mednet_torch.utils.memory import check_stitch_budget, param_bytes


def run_pipelined(items: Iterable[Tuple], dispatch: Callable,
                  finalize: Callable) -> None:
    """Depth-1 software pipeline: dispatch item i+1, then finalize item i.

    ``dispatch`` queues an item's device work and returns without waiting;
    ``finalize`` waits for one (the device-to-host copy) and stores it.
    """
    pending = None
    for item in items:
        queued = dispatch(*item)
        if pending is not None:
            finalize(*pending)
        pending = queued
    if pending is not None:
        finalize(*pending)


class RoundRobinPlacement(NamedTuple):
    """One task per device for round-robin dispatch, ``tasks[i]``'s model
    on ``devices[i]``.  Build it once with ``round_robin_placement`` and
    pass it to every call (the predict CLI's chunks), so the weights are
    placed once."""

    devices: List[torch.device]
    tasks: List


def round_robin_placement(task, devices) -> Optional[RoundRobinPlacement]:
    """Place ``task``'s weights on every entry of ``devices`` (the same
    device twice places them twice); an existing placement passes through,
    and no devices mean no placement (None: the task's own device).  The
    first entry reuses ``task`` itself when its model already lives there."""
    if isinstance(devices, RoundRobinPlacement):
        return devices
    devs = [torch.device(d) for d in devices or ()]
    if not devs:
        return None
    tasks = []
    for i, d in enumerate(devs):
        try:
            check_model_device(task, d)
            here = i == 0
        except ValueError:
            here = False
        tasks.append(task if here else
                     dataclasses.replace(task, model=copy.deepcopy(task.model).to(d)))
    return RoundRobinPlacement(devs, tasks)


def normalize_tta(tta) -> Tuple[int, ...]:
    """Canonicalize a config ``tta`` value to a tuple of spatial axes.

    ``False``/``None``/``()`` -> no TTA; ``True`` -> all three spatial axes;
    an int or a list of ints -> those axes (0=X, 1=Y, 2=Z in patch-size
    order).
    """
    if tta is True:
        return (0, 1, 2)
    if tta is False or tta is None:
        return ()
    if isinstance(tta, str):
        raise ValueError(f"tta must be true/false or a list of spatial axes, got {tta!r}")
    # a bare int axis (0 is a valid axis, so this precedes the falsiness test)
    if isinstance(tta, (int, float)):
        tta = [int(tta)]
    if not tta:
        return ()
    axes = tuple(sorted({int(a) for a in tta}))
    if any(a < 0 or a > 2 for a in axes):
        raise ValueError(f"tta axes must be spatial (0..2), got {tta!r}")
    return axes


def split_activations(task, patches: torch.Tensor) -> torch.Tensor:
    """Model forward on (N, C, X, Y, Z) patches, then the reference's
    predict split: heatmap channels raw, class channels softmaxed
    (reference ``landmarks.py:88-94``); fp32."""
    model = task.model
    num_heatmaps = getattr(task, "num_heatmaps", 0)
    logits = model(patches.to(model.config.dtype))
    if num_heatmaps:
        probs = torch.softmax(logits[:, num_heatmaps:], dim=1)
        return torch.cat([logits[:, :num_heatmaps], probs], dim=1)
    return torch.softmax(logits, dim=1)


def tta_split_activations(task, patches: torch.Tensor,
                          flips: Tuple[int, ...] = ()) -> torch.Tensor:
    """Mirror TTA: the mean of ``split_activations`` over every subset of
    the ``flips`` spatial axes (each subset's patches mirrored, run and
    mirrored back), in JAX's subset order.  Class channels average in
    probability space, heatmaps in raw regression space.  ``flips=()`` is
    ``split_activations`` alone."""
    flips = tuple(flips)
    if not flips:
        return split_activations(task, patches)
    subsets = list(chain.from_iterable(
        combinations(flips, r) for r in range(len(flips) + 1)))
    acc = None
    for subset in subsets:
        dims = [a + 2 for a in subset]  # batch and channel lead
        x = torch.flip(patches, dims) if dims else patches
        act = split_activations(task, x)
        act = torch.flip(act, dims) if dims else act
        acc = act if acc is None else acc + act
    return acc / len(subsets)


def postprocess_activations(task, act: torch.Tensor) -> torch.Tensor:
    """The activation-space twin of ``task.predict_postprocess``: (N, C, ...)
    averaged activations -> (N, L + 1, ...) uint8, the heatmaps clipped to
    [0, 255] first, then the argmax of the class probabilities.  Used where
    TTA averages before the argmax."""
    num_heatmaps = getattr(task, "num_heatmaps", 0)
    cls = torch.argmax(act[:, num_heatmaps:], dim=1, keepdim=True).to(torch.uint8)
    if num_heatmaps:
        hm = act[:, :num_heatmaps].clamp(0.0, 255.0).to(torch.uint8)
        return torch.cat([hm, cls], dim=1)
    return cls


def grid_corners(img_size, patch_size, overlap):
    """Static tile corners in the padded volume (reference stride geometry)."""
    img_size = np.asarray(img_size, dtype=np.int64)
    patch_size = np.asarray(patch_size, dtype=np.int64)
    overlap = np.asarray(overlap, dtype=np.int64)
    stride = patch_size - 2 * overlap
    if np.any(stride <= 0):
        raise ValueError("patch_overlap too large for patch_size")
    n = np.ceil(img_size / stride).astype(np.int64)
    corners = np.stack(np.meshgrid(
        *[np.arange(nk) * sk for nk, sk in zip(n, stride)], indexing="ij"
    ), axis=-1).reshape(-1, 3)
    overhead = (-img_size) % stride
    padded = img_size + 2 * overlap + overhead
    return corners.astype(np.int32), padded


def tile_plan(img_size, patch_size, patch_overlap, batch_size: int):
    """(corners, n_tiles, pads) of one volume: the grid's ``n_tiles``
    corners as (n_batches, batch_size, 3) int32, the tail batch filled by
    repeating the last corner, and the per-axis (before, after) zero
    padding of the padded domain."""
    img_size = np.asarray(img_size, dtype=np.int64)
    corners, padded = grid_corners(img_size, patch_size, patch_overlap)
    n_tiles = corners.shape[0]
    pad_n = -n_tiles % batch_size
    if pad_n:
        corners = np.concatenate([corners, np.repeat(corners[-1:], pad_n, 0)])
    pads = tuple((int(o), int(p - s - o))
                 for o, p, s in zip(patch_overlap, padded, img_size))
    return corners.reshape(-1, batch_size, 3), n_tiles, pads


def check_model_device(task, dev: torch.device) -> None:
    param_dev = next(task.model.parameters()).device
    if param_dev.type != dev.type or (dev.index is not None and param_dev != dev):
        raise ValueError(f"model parameters live on {param_dev}, not on {dev}")


def upload_volume(vol: np.ndarray, device: torch.device) -> torch.Tensor:
    """Host (C, X, Y, Z) f16 -> device (X, Y, Z, C), without blocking the
    host on the card's queue (a pageable copy would synchronize)."""
    t = torch.from_numpy(np.ascontiguousarray(vol))
    if device.type == "cuda":
        t = t.pin_memory().to(device, non_blocking=True)
    return t.permute(1, 2, 3, 0).contiguous()


def budget_split(task, shapes, subject_keys, patch_size, patch_overlap, batch_size,
                 stitch: str, tta_flips, hbm_guard: str, hbm_budget, device):
    """(keys that fit the ``stitch`` on the card, keys to stitch on the
    host), by ``utils/memory.check_stitch_budget`` for each volume; raises
    ``HBMBudgetError`` under ``hbm_guard='error'``."""
    cfg = task.model.config
    params_b = param_bytes(task.model)
    n_tta = 2 ** len(tta_flips)
    # a model that sizes its own forward gives it (Swin UNETR); a U-Net's is
    # read from its widths
    if hasattr(cfg, "infer_peak_bytes"):
        net = dict(net_bytes=cfg.infer_peak_bytes(batch_size, patch_size))
    else:
        net = dict(feature_maps=cfg.feature_maps, block=cfg.block, layer_order=cfg.layer_order)
    fit, spill = [], []
    for key in subject_keys:
        ok = check_stitch_budget(
            key, shapes[key][1:], patch_size, patch_overlap, batch_size,
            cfg.in_channels, getattr(task, "num_heatmaps", 0) + 1,
            stitch=stitch, dtype_bytes=torch.finfo(cfg.dtype).bits // 8,
            params_bytes=params_b, n_tta=n_tta, budget_bytes=hbm_budget, guard=hbm_guard,
            acc_channels=cfg.out_channels, device=device, **net)
        (fit if ok else spill).append(key)
    return fit, spill


def predict_on_device(
    task,
    data_path,
    subject_keys: Sequence[str],
    patch_size: Sequence[int],
    patch_overlap: Sequence[int],
    batch_size: int,
    image_group: str,
    reader_cls,
    reader: Optional[DataReader],
    device: DeviceLike,
    tta_flips: Tuple[int, ...],
    hbm_guard: str,
    hbm_budget: Optional[int],
    *,
    stitch: str,
    make_predictor: Callable,
    spill: Callable,
    devices=None,
) -> VolumeGroup:
    """The shared body of an on-device stitch.

    Sizes every volume for ``stitch`` (``device`` or ``gaussian``) before
    anything is read or uploaded, reads those that fit in f16 (the
    reference/host pipeline's preload, dataset.py:441), and runs each
    through ``make_predictor(task)(volume, corners, n_tiles, pads)`` (the
    unpadded (X, Y, Z, C) volume on the card and its ``tile_plan``; returns
    the (L + 1, X, Y, Z) uint8 result on the card) in the depth-1
    pipeline.  With ``devices`` (a list, or a ``RoundRobinPlacement``),
    volume ``i`` runs whole on ``devices[i % n]`` with that device's copy
    of the weights, so the results equal one device's.  The volumes the
    guard turned away go to ``spill(keys, reader, device)``, a host stitch
    on ``device``.  An owned reader is closed either way.  While a profiler
    records, the call is traced (``utils/tracing.py``): ``serve.call``,
    ``serve.prepare``, and per volume ``serve.upload``, ``serve.launch``,
    ``serve.wait`` (a stream synchronisation, the wait the blocking copy back
    would make) and ``serve.copy_back``.
    """
    with tracing.span("serve.call"), contextlib.ExitStack() as owned:
        with tracing.span("serve.prepare"):
            dev = resolve_device(device)
            check_model_device(task, dev)
            placement = round_robin_placement(task, devices)
            runs = ([(d, make_predictor(t)) for d, t in zip(placement.devices, placement.tasks)]
                    if placement is not None else [(dev, make_predictor(task))])
            for t in placement.tasks if placement is not None else (task,):
                t.model.eval()  # BatchNorm on its running statistics
            out_c = getattr(task, "num_heatmaps", 0) + 1
            r = reader if reader is not None else owned.enter_context(
                contextlib.closing(open_reader(data_path, reader_cls)))
            shapes = r.get_data_shape(subject_keys, image_group)
            affines = r.get_data_attribute(subject_keys, image_group, "affine")
            fit_keys, spill_keys = budget_split(
                task, shapes, subject_keys, patch_size, patch_overlap, batch_size, stitch,
                tta_flips, hbm_guard, hbm_budget, dev)
            volumes = list(r.read(fit_keys, image_group, dtype=np.float16))
            results = VolumeGroup()

        def dispatch(i, key, vol):
            on, predictor = runs[i % len(runs)]
            with tracing.span("serve.upload", request=i):
                # popped into the call, so that the predictor alone holds the
                # unpadded volume and frees it once it has padded it
                staged = [upload_volume(vol, on)]
            with tracing.span("serve.launch", request=i):
                corners, n_tiles, pads = tile_plan(vol.shape[1:], patch_size, patch_overlap,
                                                   batch_size)
                return i, key, vol.shape[1:], predictor(staged.pop(), corners, n_tiles, pads)

        def finalize(i, key, img_size, out):
            with tracing.span("serve.wait", request=i):
                if out.is_cuda and tracing.enabled():
                    # the wait the blocking copy below would make, timed apart from it
                    torch.cuda.current_stream(out.device).synchronize()
            with tracing.span("serve.copy_back", request=i):
                ds = results.require_dataset(key, (out_c, *img_size), np.uint8)
                ds[:] = out.cpu().numpy()
                ds.attrs["affine"] = np.asarray(affines[key]).tolist()

        with torch.inference_mode():
            run_pipelined(zip(count(), fit_keys, volumes), dispatch, finalize)
        del volumes
        for key, ds in (spill(spill_keys, r, dev) if spill_keys else {}).items():
            dst = results.require_dataset(key, ds.array.shape, ds.array.dtype)
            dst[:] = ds.array
            dst.attrs.update(ds.attrs)
    return results
