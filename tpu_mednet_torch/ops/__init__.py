"""Kernels of the port and their plain PyTorch versions, and the plain ops
around them.

``groupnorm`` (K1: GroupNorm statistics + fused normalize/act, and its
backward under a ``torch.autograd.Function``), ``patches`` (K2: batched
window gather, from one volume or indexed by subject from a stacked
store); ``_build`` compiles ``csrc/``.  ``losses``, ``augment`` and
``heatmap`` (Gaussian landmark heatmaps) are plain PyTorch.

Importing this package registers K1's forward custom ops
(``torch.ops.tpu_mednet_torch.gn_moments`` and ``.gn_apply``), which is all
a serving artifact of ``inference/serving.py`` needs to load.
"""

from tpu_mednet_torch.ops import groupnorm  # noqa: F401  (registers the custom ops)
