"""Kernels of the port and their plain PyTorch versions.

``groupnorm`` (K1, GroupNorm statistics + fused normalize/act) and
``patches`` (K2, batched window gather); ``_build`` compiles ``csrc/``.
"""
