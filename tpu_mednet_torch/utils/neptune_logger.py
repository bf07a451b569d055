"""Optional Neptune experiment-tracking sink.

Counterpart of ``tpu_mednet/utils/neptune_logger.py`` (the reference logs
hparams, tags, source files, scalars and MIP figures to Neptune,
``examples/train_seg.py:74-79``).  The sink is import-gated as in the JAX
package: without a project or ``NEPTUNE_API_TOKEN`` there is no run;
without the ``neptune`` client a warning says so and training goes on with
the JSONL/TensorBoard sinks alone.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, Optional, Sequence

logger = logging.getLogger(__name__)


class NeptuneSink:
    """Scalar and figure sink over a Neptune run, with the methods
    ``MetricsLogger`` calls on its extra sinks."""

    def __init__(self, run):
        self.run = run

    def log_scalars(self, step: int, scalars: Dict[str, float]) -> None:
        for k, v in scalars.items():
            self.run[k].append(float(v), step=step)

    def log_figure(self, tag: str, figure, step: int) -> None:
        self.run[tag].append(figure, step=step)

    def close(self) -> None:
        self.run.stop()


def maybe_create_neptune_run(
    project: Optional[str],
    experiment_name: str,
    hparams: Optional[dict] = None,
    tags: Optional[Sequence[str]] = None,
    source_files: Optional[Sequence[str]] = None,
) -> Optional[NeptuneSink]:
    """A sink over a new Neptune run when a project, the token and the
    client are there, else None; the hparams are logged as strings under
    ``parameters``, the tags default to the experiment name."""
    if not project or not os.environ.get("NEPTUNE_API_TOKEN"):
        return None
    try:
        import neptune
    except ImportError:
        logger.warning("neptune_project=%s set but the neptune client is "
                       "not installed; skipping Neptune logging", project)
        return None
    run = neptune.init_run(
        project=project,
        name=experiment_name,
        tags=list(tags or [experiment_name]),
        source_files=list(source_files or []),
    )
    if hparams:
        run["parameters"] = {k: str(v) for k, v in hparams.items()}
    return NeptuneSink(run)
