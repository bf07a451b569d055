"""Landmark training CLI: ``python -m tpu_mednet_torch.cli.train_ldmks``.

The port's counterpart of ``tpu_mednet/cli/train_ldmks.py`` (the
reference's ``examples/train_ldmks.py``): the same flag surface and config
loading as ``train_seg`` plus the LandmarkNet flags; the heatmap group goes
into the sampler (heatmap channels before the class map), or, with
``--landmark_group`` and ``--device_sampler``, the heatmaps are rendered on
the device from stored coordinates; augmentation is always on, as in the
reference (``AugmentConfig()`` when no ``--aug_*`` flag is given).  Exit
code 3 when training stops on non-finite values.  It runs on CUDA unless
``--device cpu`` is given.

The host sampler runs through the native batch pipeline unless
``--no_native_loader``.  ``--log_vis_mip``, ``--neptune_project`` and
``--gpus`` as in ``train_seg``: the MIP sample figures (with the heatmap
MIPs; they need matplotlib, and without it one warning says so and the run
trains without them), a Neptune sink where the token and the client are
there, and data-parallel ranks over one global batch, rank 0 alone
writing.  ``--spatial_shards`` splits each sample's X extent over that
many of the ranks, as in ``train_seg``.
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
    add_landmark_model_args,
    augment_config_from_hparams,
    load_dotenv,
    parse_with_config,
    read_keyfile,
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_train_args(parser)
    add_landmark_model_args(parser)
    add_device_arg(parser)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    load_dotenv()
    argv = list(sys.argv[1:] if argv is None else argv)
    hparams = parse_with_config(build_parser(), argv)
    logging.basicConfig(level=hparams.log_level)
    logger = logging.getLogger("train_ldmks")

    import torch

    from tpu_mednet_torch._device import resolve_device

    try:
        device = resolve_device(hparams.device)
    except RuntimeError as exc:
        print(f"train_ldmks: {exc}", file=sys.stderr)
        return 2
    if hparams.landmark_group and not hparams.device_sampler:
        raise SystemExit("--landmark_group (heatmaps rendered on the device) requires "
                         "--device_sampler")
    from tpu_mednet_torch.parallel.multihost import join_or_launch

    mesh, rc = join_or_launch("tpu_mednet_torch.cli.train_ldmks", argv, hparams, device,
                              "ldmk")
    if mesh is None:
        return rc
    try:
        return _train(hparams, mesh, logger)
    finally:
        if mesh.parallel:
            torch.distributed.destroy_process_group()


def _train(hparams, mesh, logger) -> int:
    import torch

    from tpu_mednet_torch.data import DevicePatchSampler, PatchSampler
    from tpu_mednet_torch.ops.augment import AugmentConfig
    from tpu_mednet_torch.parallel.mesh import shard_subject_keys
    from tpu_mednet_torch.tasks import LandmarkTask
    from tpu_mednet_torch.train import NonFiniteError, OptimizerConfig, Trainer
    from tpu_mednet_torch.utils.neptune_logger import maybe_create_neptune_run
    from tpu_mednet_torch.utils.plots import make_landmark_sample_visualizer

    device = mesh.device
    np.random.seed(hparams.seed)
    writer = mesh.rank == 0
    neptune_sink = maybe_create_neptune_run(
        hparams.neptune_project, hparams.experiment_name, hparams=vars(hparams),
        source_files=[__file__] + ([hparams.config] if hparams.config else [])) \
        if writer else None
    train_keys = read_keyfile(hparams.train_set)
    val_keys = read_keyfile(hparams.val_set) if hparams.val_set else []
    if not hparams.device_sampler:  # a node's host sampler draws from its own keys
        train_keys, val_keys = (shard_subject_keys(k, mesh.node_index, mesh.node_count)
                                for k in (train_keys, val_keys))
    logger.info("train keys: %d, val keys: %d", len(train_keys), len(val_keys))
    # the reference always augments landmarks (train_ldmks.py:82-84); the
    # --aug_* flags extend the intensity chain
    augment = augment_config_from_hparams(hparams) or AugmentConfig()

    if hparams.landmark_group:
        extra = {"landmark_group": hparams.landmark_group,
                 "heatmap_sigma": hparams.heatmap_sigma, "heatmap_group": None}
    else:
        extra = {"heatmap_group": hparams.heatmap_group}
    if hparams.device_sampler:
        sampler_cls = DevicePatchSampler
        extra["device"] = device
    else:
        sampler_cls = PatchSampler
    common = dict(image_group=hparams.image_group, label_group=hparams.label_group, **extra)
    train_ds = sampler_cls(hparams.data_path, train_keys, hparams.patches_per_subject,
                           hparams.patch_size, class_probabilities=hparams.class_probabilities,
                           seed=hparams.seed, **common)
    val_ds = None
    if val_keys:
        val_ds = sampler_cls(hparams.data_path, val_keys, hparams.patches_per_subject,
                             hparams.patch_size, class_probabilities=None,
                             seed=hparams.seed + 1, **common)

    task = LandmarkTask.from_hparams(
        hparams, device=device, generator=torch.Generator().manual_seed(hparams.seed))
    # the first num_heatmaps output channels regress the store's heatmaps
    # (landmarks.py:74-75): a store with another count would fail later as
    # a shape error inside the loss
    n_store = train_ds.num_heatmap_channels
    if n_store is not None and n_store != task.num_heatmaps:
        raise SystemExit(
            f"store group {hparams.landmark_group or hparams.heatmap_group!r} has "
            f"{n_store} heatmap channels/landmarks per subject but "
            f"--loss_regression_weight has {task.num_heatmaps} entries — one weight "
            "per heatmap channel")
    trainer = Trainer(
        task, train_ds, val_sampler=val_ds,
        batch_size=hparams.batch_size,
        max_epochs=hparams.max_epochs,
        learning_rate=hparams.learning_rate,
        model_dir=hparams.model_dir,
        log_dir=hparams.log_dir,
        augment=augment,
        seed=hparams.seed,
        log_interval=hparams.log_interval,
        sample_visualizer=make_landmark_sample_visualizer(
            task.num_heatmaps, hparams.log_vis_mip) if writer else None,
        hparams=vars(hparams),
        metric_sinks=(neptune_sink,),
        mesh=mesh,
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
