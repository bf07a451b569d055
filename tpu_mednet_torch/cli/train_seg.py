"""Segmentation training CLI: ``python -m tpu_mednet_torch.cli.train_seg``.

The port's counterpart of ``tpu_mednet/cli/train_seg.py`` (the reference's
``examples/train_seg.py``): the same flag surface (``-c`` YAML config plus
CLI overrides, ``$DATA``/``$MODEL`` expansion, key files, augmentation,
resume) and exit codes (3 when training stops on non-finite values), then
sampler -> task -> Trainer -> checkpoints.  It runs on CUDA unless
``--device cpu`` is given.

The host sampler runs through the native batch pipeline unless
``--no_native_loader`` (``--native_loader`` requires it).  ``--log_vis_mip``
(``mean`` or ``max``) logs the MIP sample figures of every
``--log_interval``-th validation batch; they need matplotlib, and where it
is absent one warning says so and the run trains without them (the JAX
CLI fails at import there).  ``--neptune_project`` adds a Neptune sink
where ``NEPTUNE_API_TOKEN`` is set and the client imports (else it warns,
as the JAX CLI does).  ``--gpus N`` trains data-parallel on N ranks, one a
card, over one global batch of ``--batch_size``: it joins a ``torchrun``
group where one launched it, else it starts the ranks of this host itself
(NCCL); ``--device cpu --gpus N`` runs N gloo ranks on the CPU.  Rank 0
alone writes logs, figures and checkpoints.  ``--spatial_shards S``
splits each sample's X extent over S of those ranks (a (gpus / S) x S
mesh of data and space, as the JAX CLI's ``make_mesh(n_data, n_space)``;
S must divide the device count, and the host sampler is required).
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
)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_train_args(parser)
    add_seg_model_args(parser)
    add_device_arg(parser)
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    load_dotenv()
    argv = list(sys.argv[1:] if argv is None else argv)
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
    from tpu_mednet_torch.parallel.multihost import join_or_launch

    mesh, rc = join_or_launch("tpu_mednet_torch.cli.train_seg", argv, hparams, device, "seg")
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
    from tpu_mednet_torch.parallel.mesh import shard_subject_keys
    from tpu_mednet_torch.tasks import SegmentationTask
    from tpu_mednet_torch.train import NonFiniteError, OptimizerConfig, Trainer
    from tpu_mednet_torch.utils.neptune_logger import maybe_create_neptune_run
    from tpu_mednet_torch.utils.plots import make_seg_sample_visualizer

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
        log_interval=hparams.log_interval,
        sample_visualizer=make_seg_sample_visualizer(hparams.log_vis_mip) if writer else None,
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
