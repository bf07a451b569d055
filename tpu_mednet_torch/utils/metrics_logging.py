"""Metric sinks: JSONL always, TensorBoard where ``tensorboardX`` imports, and extra sinks.

Counterpart of ``tpu_mednet/utils/metrics_logging.py``.  Scalar names are
the reference's (``train_loss``, ``val_loss``, ``val_dice{c}``) so
dashboards transfer.  Figures (the MIP sample visualizer's,
``utils/plots.py``) go to TensorBoard, or without it to
``<log_dir>/figures/<tag>_<step>.png``, so none is dropped.  Extra sinks
(``utils/neptune_logger.NeptuneSink``) get every scalar, every figure and
the ``close``.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict


class MetricsLogger:
    """Scalar and figure logger: ``<log_dir>/metrics.jsonl``, TensorBoard
    events in the same directory where ``tensorboardX`` imports (and
    ``use_tensorboard``), and ``extra_sinks`` with the same methods."""

    def __init__(self, log_dir, use_tensorboard: bool = True, extra_sinks=()):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self._tb = None
        if use_tensorboard:
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                pass
            else:
                self._tb = SummaryWriter(logdir=str(self.log_dir))
        self.extra_sinks = [s for s in extra_sinks if s is not None]

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        record = {"step": step, "time": time.time()}
        record.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)
        for sink in self.extra_sinks:
            sink.log_scalars(step, scalars)

    def log_figure(self, tag: str, figure, step: int) -> None:
        """Log a matplotlib figure: to TensorBoard, else as
        ``<log_dir>/figures/<tag>_<step:06d>.png`` ('/' in the tag becomes
        '_'); then to every extra sink."""
        if self._tb is not None:
            self._tb.add_figure(tag, figure, step)
        else:
            fig_dir = self.log_dir / "figures"
            fig_dir.mkdir(parents=True, exist_ok=True)
            safe_tag = tag.replace("/", "_")
            figure.savefig(fig_dir / f"{safe_tag}_{step:06d}.png", bbox_inches="tight")
        for sink in self.extra_sinks:
            sink.log_figure(tag, figure, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
        for sink in self.extra_sinks:
            sink.close()
