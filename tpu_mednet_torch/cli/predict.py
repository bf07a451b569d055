"""Sliding-window prediction CLI: ``python -m tpu_mednet_torch.cli.predict``.

The port's counterpart of ``tpu_mednet/cli/predict.py`` (the reference's
hydra entry point, ``examples/predict.py:20-115``): a YAML config with
``base.*`` / ``prediction.*`` groups plus dotted ``key=value`` overrides;
checkpoint -> model -> stitch -> an HDF5 or zarr store, or a directory of
NIfTI volumes (``prediction.data`` named ``*.nii``).  ``base.data`` may be
an HDF5 file, a zarr store or a ``<root>/<group>/<key>.nii[.gz]``
directory.  Subjects go in chunks of ``prediction.chunk_size`` to bound
host memory.  ``prediction.stitch`` is ``crop`` (the reference's host
stitch, the default), ``device`` (tiles cut by K2 and stitched on the
card) or ``gaussian`` (tiles cut by K2, Gaussian-weighted fp32
accumulation on the card).  ``prediction.tta`` (``true`` or a list of
spatial axes 0..2) averages 2^k mirrored forwards per tile before the
argmax, in every stitch.  ``prediction.hbm_guard`` (``warn``, the
default; ``error``; ``off``) sizes each volume for the two on-device
stitches before it is uploaded and, under ``warn``, stitches a volume
that would not fit the card on the host (``utils/memory.py``).  A
LandmarkNet checkpoint writes its heatmap channels (clipped to uint8)
before the class map, and ``prediction.landmarks`` (a ``.json`` or
``.csv`` path) gets one argmax readout per subject and landmark.  The
checkpoint is a training directory of the port (EMA weights unless
``prediction.use_ema=false``; ``prediction.checkpoint_step`` pins a step)
or a reference-style ``.ckpt`` file.  It runs on CUDA unless ``--device
cpu`` is given.  ``prediction.gpus`` above 1 deals volumes (in the ``crop``
stitch, tile batches) round-robin over that many cards, the weights placed
once on each; it is clamped to the cards visible (to 1 on the CPU), as the
JAX CLI clamps it to ``len(jax.devices())``, and the clamp is printed.
"""

from __future__ import annotations

import argparse
import logging
import sys
import types
from typing import Optional, Sequence

import numpy as np

from tpu_mednet_torch.config import (
    add_device_arg,
    load_dotenv,
    load_yaml_config,
    read_keyfile,
    replace_env,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-c", "--config", required=True,
                        help="YAML config with base.* / prediction.* groups")
    parser.add_argument("overrides", nargs="*",
                        help="dotted overrides, e.g. prediction.batch_size=16")
    parser.add_argument("--log_level", type=str, default="INFO")
    add_device_arg(parser)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    load_dotenv()
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level)
    logger = logging.getLogger("predict")

    from tpu_mednet_torch._device import resolve_device

    try:
        device = resolve_device(args.device)
    except RuntimeError as exc:
        print(f"predict: {exc}", file=sys.stderr)
        return 2

    cfg = load_yaml_config(args.config, args.overrides)
    base = cfg.get("base", {})
    pred = cfg.get("prediction", {})
    data_path = replace_env(base["data"])
    image_group = base.get("image_group", "images")
    num_heatmaps = len(base.get("sigma") or [])
    test_set = replace_env(pred["test_set"])
    patch_size = pred.get("patch_size", [96, 96, 96])
    patch_overlap = pred.get("patch_overlap", [16, 16, 16])
    channel_selection = pred.get("channel_selection")
    batch_size = pred.get("batch_size", 8)
    prediction_path = pred.get("data")
    prediction_group = pred.get("group", "prediction")
    landmarks_path = pred.get("landmarks")
    checkpoint_path = replace_env(pred["checkpoint"])
    checkpoint_step = pred.get("checkpoint_step")
    chunk_size = pred.get("chunk_size", 16)
    model_name = pred.get("model")  # default: detected from the hparams
    stitch = pred.get("stitch", "crop")
    use_ema = bool(pred.get("use_ema", True))
    if stitch not in ("crop", "device", "gaussian"):
        raise ValueError(f"prediction.stitch must be crop, device or gaussian, got {stitch!r}")
    hbm_guard = pred.get("hbm_guard", "warn")
    n_gpus = int(pred.get("gpus", 1) or 1)
    if checkpoint_step is not None:
        try:
            checkpoint_step = int(checkpoint_step)
        except (TypeError, ValueError):
            raise ValueError(
                f"prediction.checkpoint_step must be an integer step, got "
                f"{checkpoint_step!r} (for the best-val checkpoint point "
                f"prediction.checkpoint at <model_dir>/best)") from None

    import torch

    from tpu_mednet_torch.inference.common import normalize_tta, round_robin_placement
    from tpu_mednet_torch.inference.device_sliding import predict_volumes_on_device
    from tpu_mednet_torch.inference.serving import detect_task_name
    from tpu_mednet_torch.inference.sliding_window import predict_volumes
    from tpu_mednet_torch.inference.weighted import predict_volumes_weighted_on_device
    from tpu_mednet_torch.tasks import LandmarkTask, SegmentationTask
    from tpu_mednet_torch.train.checkpoint import load_for_inference
    from tpu_mednet_torch.utils.evaluation import landmark_readout

    tta_flips = normalize_tta(pred.get("tta", False))
    if tta_flips:
        logger.info("mirror TTA on axes %s (%d forwards per patch)", tta_flips,
                    2 ** len(tta_flips))
    test_keys = read_keyfile(test_set)
    logger.info("total number of keys %d", len(test_keys))
    chunk_num = max(len(test_keys) // chunk_size, 1)
    chunks = np.array_split(np.asarray(test_keys), chunk_num)

    logger.info("loading model from %s ...", checkpoint_path)
    state_dict, hp_restored = load_for_inference(checkpoint_path, step=checkpoint_step,
                                                 use_ema=use_ema)
    if hp_restored is None:
        raise ValueError(
            f"checkpoint at {checkpoint_path} has no hparams side-car; "
            "predict needs the training hparams to rebuild the model")
    detected = detect_task_name(hp_restored)
    if model_name is None:
        model_name = detected
        logger.info("prediction.model not set; detected %s from the checkpoint "
                    "hparams", model_name)
    elif model_name != detected:
        raise ValueError(
            f"prediction.model={model_name!r} but the checkpoint hparams "
            f"say it was trained as {detected!r} (loss_regression_weight "
            f"{'present' if detected == 'LandmarkNet' else 'absent'}); "
            f"restoring into the wrong task silently bakes the wrong "
            f"postprocess — fix prediction.model or the checkpoint path")
    hparams = types.SimpleNamespace(**{k: _coerce(v) for k, v in hp_restored.items()})
    task_cls = LandmarkTask if model_name == "LandmarkNet" else SegmentationTask
    task = task_cls.from_hparams(hparams, device=device)
    if landmarks_path and getattr(task, "num_heatmaps", 0) == 0:
        raise ValueError(
            "prediction.landmarks is set but the checkpoint is a "
            f"{model_name} with no heatmap channels — coordinates can only "
            "be read out of a landmark model's predictions")
    if landmarks_path and channel_selection is not None:
        raise ValueError(
            "prediction.landmarks needs the full heatmaps-first channel "
            "layout; drop prediction.channel_selection (the readout would "
            "index the wrong channels of a subset)")
    task.model.load_state_dict(state_dict, strict=True)
    visible = torch.cuda.device_count() if device.type == "cuda" else 1
    if n_gpus > visible:
        print(f"predict: prediction.gpus {n_gpus} clamped to {visible}, the devices "
              "visible", flush=True)
    n_gpus = min(n_gpus, visible)
    # the weights go to every card once; each chunk's call reuses them
    placement = round_robin_placement(
        task, [torch.device("cuda", i) for i in range(n_gpus)] if n_gpus > 1 else None)

    all_landmarks: dict = {}
    for c, chunk in enumerate(chunks):
        logger.info("chunk %d/%d", c, chunk_num)
        kw = dict(patch_size=patch_size, patch_overlap=patch_overlap,
                  batch_size=batch_size, image_group=image_group, device=device,
                  tta_flips=tta_flips, devices=placement)
        if stitch == "device":
            results = predict_volumes_on_device(task, data_path, list(chunk),
                                                hbm_guard=hbm_guard, **kw)
        elif stitch == "gaussian":
            results = predict_volumes_weighted_on_device(task, data_path, list(chunk),
                                                         hbm_guard=hbm_guard, **kw)
        else:
            results = predict_volumes(task, data_path, list(chunk),
                                      out_channels=num_heatmaps + 1,
                                      channel_selection=channel_selection, **kw)
        if prediction_path:
            results.save(replace_env(prediction_path), group=prediction_group)
            logger.info("saved %d volumes to %s", len(results), prediction_path)
        if landmarks_path:
            for key, ds in results.items():
                all_landmarks[key] = landmark_readout(ds.array, task.num_heatmaps,
                                                      affine=ds.attrs.get("affine"))
    if landmarks_path:
        _write_landmarks(replace_env(landmarks_path), all_landmarks)
        logger.info("wrote landmark coordinates for %d subjects to %s",
                    len(all_landmarks), landmarks_path)
    return 0


def _write_landmarks(path: str, per_subject: dict) -> None:
    """Write {subject: [readouts]} as JSON, or flat rows as CSV."""
    import csv
    import json

    if str(path).endswith(".csv"):
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["subject", "landmark", "x_vox", "y_vox", "z_vox", "peak",
                        "x_mm", "y_mm", "z_mm"])
            for key, rows in per_subject.items():
                for i, r in enumerate(rows):
                    w.writerow([key, i, *r["voxel"], r["peak"],
                                *r.get("physical", [None, None, None])])
    else:
        with open(path, "w") as f:
            json.dump(per_subject, f, indent=2)


def _coerce(v):
    """JSON round-trips turn tuples into lists and, at times, numbers into
    strings; best-effort numeric coercion of hparams values (recursing into
    lists)."""
    if isinstance(v, list):
        return [_coerce(x) for x in v]
    if isinstance(v, str):
        for cast in (int, float):
            try:
                return cast(v)
            except ValueError:
                pass
        if v in ("True", "False"):
            return v == "True"
        if v == "None":
            return None
    return v


if __name__ == "__main__":
    sys.exit(main())
