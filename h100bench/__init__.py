"""The benchmark of ``tpu_mednet_torch`` on one NVIDIA H100 (see README.md)."""
