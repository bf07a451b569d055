"""Utilities of the port: the device-memory guard of the on-device
stitches, NIfTI I/O, evaluation metrics and readouts, metrics logging
(with the Neptune sink and the MIP figures of ``plots``),
analytic FLOPs, log-level parsing, the weights bridge from the JAX tree and
the reference checkpoint interop (``torch_import``, ``torch_export``);
``python -m tpu_mednet_torch.utils.export`` dumps stores to NIfTI."""

from tpu_mednet_torch.utils.memory import (HBMBudgetError, check_stitch_budget,
                                           device_stitch_bytes, hbm_budget_bytes)
from tpu_mednet_torch.utils.nifti import load_nifti, read_nifti_header, save_nifti

__all__ = ["HBMBudgetError", "check_stitch_budget", "device_stitch_bytes", "hbm_budget_bytes",
           "load_nifti", "read_nifti_header", "save_nifti"]
