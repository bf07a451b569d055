"""Plain PyTorch reference of what the benchmarked cells compute.

Frozen and self-contained: it imports nothing of ``tpu_mednet_torch`` (nor
JAX or ``tpu_mednet``), takes only the inputs the benchmark made from the
seed, and works out again everything the program derives from them.
"""
