"""Segmentation training CLI: ``python -m tpu_mednet_torch.cli.train_seg``.

The port's counterpart of ``tpu_mednet/cli/train_seg.py`` (the reference's
``examples/train_seg.py``): the same flag surface (``-c`` YAML config plus
CLI overrides, ``$DATA``/``$MODEL`` expansion, key files, augmentation,
resume) and exit codes (3 when training stops on non-finite values), then
sampler -> task -> Trainer -> checkpoints.  It runs on CUDA unless
``--device cpu`` is given.

The host sampler runs through the native batch pipeline unless
``--no_native_loader`` (``--native_loader`` requires it).  Not ported: more
than one GPU (``--gpus``/``--spatial_shards`` above 1), Neptune
(``--neptune_project``) and the MIP sample visualizer.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional, Sequence

import numpy as np

from tpu_mednet_torch.config import (
    add_common_train_args,
    add_device_arg,
    add_seg_model_args,
    augment_config_from_hparams,
    load_dotenv,
    parse_with_config,
    read_keyfile,
    validate_task_config,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_train_args(parser)
    add_seg_model_args(parser)
    add_device_arg(parser)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    load_dotenv()
    hparams = parse_with_config(build_parser(), argv)
    logging.basicConfig(level=hparams.log_level)
    logger = logging.getLogger("train_seg")

    import torch

    from tpu_mednet_torch._device import resolve_device

    try:
        device = resolve_device(hparams.device)
    except RuntimeError as exc:
        print(f"train_seg: {exc}", file=sys.stderr)
        return 2
    if hparams.neptune_project:
        raise NotImplementedError("--neptune_project: the port has no Neptune client "
                                  "(ROADMAP §1, 'Neptune'); metrics go to --log_dir")
    if hparams.gpus > 1 or hparams.spatial_shards > 1:
        raise NotImplementedError(
            f"--gpus {hparams.gpus} --spatial_shards {hparams.spatial_shards}: the "
            "port trains on one GPU (ROADMAP §1, 'Multi-GPU')")

    from tpu_mednet_torch.data import DevicePatchSampler, PatchSampler
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.train import NonFiniteError, OptimizerConfig, Trainer

    np.random.seed(hparams.seed)
    train_keys = read_keyfile(hparams.train_set)
    val_keys = read_keyfile(hparams.val_set) if hparams.val_set else []
    logger.info("train keys: %d, val keys: %d", len(train_keys), len(val_keys))
    validate_task_config(hparams, "seg")
    augment = augment_config_from_hparams(hparams)

    if hparams.device_sampler:
        sampler_cls, extra = DevicePatchSampler, {"device": device}
    else:
        sampler_cls, extra = PatchSampler, {}
    common = dict(image_group=hparams.image_group, label_group=hparams.label_group,
                  heatmap_group=None, **extra)
    train_ds = sampler_cls(hparams.data_path, train_keys, hparams.patches_per_subject,
                           hparams.patch_size, class_probabilities=hparams.class_probabilities,
                           seed=hparams.seed, **common)
    val_ds = None
    if val_keys:
        val_ds = sampler_cls(hparams.data_path, val_keys, hparams.patches_per_subject,
                             hparams.patch_size, class_probabilities=None,
                             seed=hparams.seed + 1, **common)

    task = SegmentationTask.from_hparams(
        hparams, device=device, generator=torch.Generator().manual_seed(hparams.seed))
    trainer = Trainer(
        task, train_ds, val_sampler=val_ds,
        batch_size=hparams.batch_size,
        max_epochs=hparams.max_epochs,
        learning_rate=hparams.learning_rate,
        model_dir=hparams.model_dir,
        log_dir=hparams.log_dir,
        augment=augment,
        seed=hparams.seed,
        hparams=vars(hparams),
        native_loader=hparams.native_loader,
        optim=OptimizerConfig.from_hparams(hparams),
        check_val_every_n_epoch=hparams.check_val_every_n_epoch,
        early_stop_patience=hparams.early_stop_patience,
        early_stop_min_delta=hparams.early_stop_min_delta,
        limit_train_batches=hparams.limit_train_batches,
        limit_val_batches=hparams.limit_val_batches,
        nonfinite=hparams.nonfinite,
        track_grad_norm=hparams.track_grad_norm,
        keep_checkpoints=hparams.keep_checkpoints,
    )
    try:
        trainer.fit(resume=hparams.resume)
    except NonFiniteError as exc:
        # a clean stop, not a crash: the last checkpoint holds finite params
        logger.error("training stopped: %s", exc)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
