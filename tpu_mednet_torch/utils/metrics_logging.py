"""Metric sinks: JSONL always, TensorBoard where ``tensorboardX`` imports.

Counterpart of ``tpu_mednet/utils/metrics_logging.py``.  Scalar names are
the reference's (``train_loss``, ``val_loss``, ``val_dice{c}``) so
dashboards transfer.  Figures are not logged: the MIP sample visualizer is
not ported.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Dict


class MetricsLogger:
    """Scalar logger: ``<log_dir>/metrics.jsonl``, and TensorBoard events in
    the same directory where ``tensorboardX`` imports."""

    def __init__(self, log_dir):
        self.log_dir = Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(self.log_dir / "metrics.jsonl", "a")
        self._tb = None
        try:
            from tensorboardX import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(logdir=str(self.log_dir))

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        record = {"step": step, "time": time.time()}
        record.update({k: float(v) for k, v in scalars.items()})
        self._jsonl.write(json.dumps(record) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            for k, v in scalars.items():
                self._tb.add_scalar(k, float(v), step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
