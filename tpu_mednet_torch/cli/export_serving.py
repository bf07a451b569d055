"""Export a trained checkpoint to a standalone serving artifact.

    python -m tpu_mednet_torch.cli.export_serving --checkpoint runs/model \\
        --out model.pt2 --patch_size 96 96 96

The port's counterpart of ``tpu_mednet/cli/export_serving.py``, with the
same flags, refusals and exit codes: the forward + postprocess is traced
by ``torch.export`` with the trained weights baked in and written to ONE
``.pt2`` file (``inference/serving.py``).  ``--platforms`` names the one
device it is traced on, ``cuda`` (the default) or ``cpu``: a ``.pt2``
holds its weights on that device, so two platforms are refused, and so is
``tpu``.  At serve time the host needs torch and the port's K1 op
registration, no model code and no checkpoint::

    import torch
    import tpu_mednet_torch.ops          # registers the K1 custom ops
    serve = torch.export.load("model.pt2").module()
    with torch.no_grad():
        pred = serve(batch)   # (N, 96, 96, 96, C) float32, any N
"""

from __future__ import annotations

import argparse
import logging
import sys
import types
from typing import Optional, Sequence

from tpu_mednet_torch.config import load_dotenv, replace_env


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--checkpoint", required=True,
                        help="checkpoint directory (with hparams side-car) or a "
                             "reference-style .ckpt file")
    parser.add_argument("--out", required=True,
                        help="output artifact path (e.g. model.pt2)")
    parser.add_argument("--patch_size", type=int, nargs=3,
                        default=[96, 96, 96])
    parser.add_argument("--batch_size", type=int, default=None,
                        help="pin the batch axis; default: symbolic (any N)")
    parser.add_argument("--model", default=None,
                        choices=["SegmentationNet", "LandmarkNet"],
                        help="default: auto-detect from the checkpoint "
                             "hparams (landmark runs carry "
                             "loss_regression_weight)")
    parser.add_argument("--platforms", nargs="*", default=None,
                        help="the one device to trace on and serve from: cuda "
                             "(default) or cpu")
    parser.add_argument("--tta", nargs="*", type=int, default=None,
                        metavar="AXIS",
                        help="bake mirror test-time augmentation into the "
                             "artifact: bare --tta flips all three spatial "
                             "axes; --tta 0 2 flips a subset (8x/4x compute "
                             "per call)")
    parser.add_argument("--no_ema", action="store_true",
                        help="bake the raw final params instead of the EMA "
                             "weights an --ema_decay checkpoint carries")
    parser.add_argument("--log_level", type=str, default="INFO")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    load_dotenv()
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level)
    logger = logging.getLogger("export_serving")

    from tpu_mednet_torch import resolve_device
    from tpu_mednet_torch.cli.predict import _coerce
    from tpu_mednet_torch.inference.common import normalize_tta
    from tpu_mednet_torch.inference.serving import (
        check_platforms,
        detect_task_name,
        export_predictor,
        save_exported,
    )
    from tpu_mednet_torch.tasks import LandmarkTask, SegmentationTask
    from tpu_mednet_torch.train.checkpoint import load_for_inference

    platform = check_platforms(args.platforms or ["cuda"])
    device = resolve_device(platform)
    checkpoint_path = replace_env(args.checkpoint)
    state_dict, hp = load_for_inference(checkpoint_path, use_ema=not args.no_ema)
    if hp is None:
        raise ValueError(
            f"checkpoint at {checkpoint_path} has no hparams side-car; "
            "export needs the training hparams to rebuild the model"
        )
    hparams = types.SimpleNamespace(**{k: _coerce(v) for k, v in hp.items()})

    detected = detect_task_name(hp)
    model_name = args.model
    if model_name is None:
        model_name = detected
        logger.info("--model not set; detected %s from the checkpoint "
                    "hparams", model_name)
    elif model_name != detected:
        raise ValueError(
            f"--model {model_name} but the checkpoint hparams say it was "
            f"trained as {detected} (loss_regression_weight "
            f"{'present' if detected == 'LandmarkNet' else 'absent'}); "
            f"exporting into the wrong task would bake the wrong "
            f"postprocess into the artifact"
        )
    task_cls = LandmarkTask if model_name == "LandmarkNet" else SegmentationTask
    task = task_cls.from_hparams(hparams, device=device)
    task.model.load_state_dict(state_dict, strict=True)

    # bare --tta (empty list) means all three axes; absent means none
    tta_flips = () if args.tta is None else (normalize_tta(args.tta) or (0, 1, 2))

    exported = export_predictor(
        task, args.patch_size, batch_size=args.batch_size, platforms=(platform,),
        tta_flips=tta_flips,
    )
    save_exported(exported, args.out)
    logger.info(
        "exported %s (%s, patch %s, batch %s, platform %s, tta %s) -> %s",
        model_name, checkpoint_path, args.patch_size,
        args.batch_size if args.batch_size is not None else "symbolic",
        platform, tta_flips or "off", args.out,
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
