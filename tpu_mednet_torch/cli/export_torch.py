"""Export a checkpoint of the port as a reference (midasmednet) ``.ckpt``:
``python -m tpu_mednet_torch.cli.export_torch``.

The port's copy of ``tpu_mednet/cli/export_torch.py``, the inverse of
``import_torch``.  A model trained here loads into the reference's torch
tooling (``load_from_checkpoint`` semantics, ``examples/predict.py:46-50``)
or a plain ``model.load_state_dict``::

    python -m tpu_mednet_torch.cli.export_torch --checkpoint runs/model \\
        --output model.ckpt

The EMA weights of an ``--ema_decay`` run are exported unless
``--no_ema``; ``--step`` picks a retained step (default: the latest).
It reads the checkpoint's files on the host and builds no model.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional, Sequence

from tpu_mednet_torch.config import load_dotenv, replace_env

logger = logging.getLogger("export_torch")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--checkpoint", required=True,
                        help="checkpoint directory of the port")
    parser.add_argument("--output", required=True,
                        help="output .ckpt path (torch.save format)")
    parser.add_argument("--step", type=int, default=None,
                        help="checkpoint step to export (default: latest)")
    parser.add_argument("--no_ema", action="store_true",
                        help="export the raw final params instead of the "
                             "EMA weights an --ema_decay checkpoint carries")
    parser.add_argument("--log_level", type=str, default="INFO")
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    load_dotenv()
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level)

    from tpu_mednet_torch.inference.serving import detect_task_name
    from tpu_mednet_torch.train.checkpoint import CheckpointManager, load_for_inference
    from tpu_mednet_torch.utils.torch_export import save_reference_checkpoint

    ckpt_dir = replace_env(args.checkpoint)
    mgr = CheckpointManager(ckpt_dir)
    hp = mgr.restore_hparams(step=args.step)
    if hp is None:
        raise SystemExit(
            f"checkpoint at {ckpt_dir} has no hparams side-car; export "
            "needs the training hparams to rebuild the model"
        )
    step = args.step if args.step is not None else mgr.latest_step
    state_dict, _ = load_for_inference(ckpt_dir, step=args.step, use_ema=not args.no_ema)
    save_reference_checkpoint(replace_env(args.output), state_dict, hparams=hp,
                              step=step or 0)
    logger.info("exported %s (step %s) -> %s", detect_task_name(hp), step, args.output)
    return 0


if __name__ == "__main__":
    sys.exit(main())
