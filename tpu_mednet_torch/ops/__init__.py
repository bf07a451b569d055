"""Kernels of the port and their plain PyTorch versions, and the plain ops
around them.

``groupnorm`` (K1: GroupNorm statistics + fused normalize/act, and its
backward under a ``torch.autograd.Function``), ``patches`` (K2: batched
window gather, from one volume or indexed by subject from a stacked
store); ``_build`` compiles ``csrc/``.  ``losses`` and ``augment`` are
plain PyTorch.
"""
