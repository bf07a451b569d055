"""The precisions the reference runs in and rounds to, shared by every family.

``exact_fp32`` turns TF32 off for the reference's matrix products and
convolutions; ``fp8_round`` is the precision control's rounding of every
matmul or convolution operand (a family's reference forward applies it as
its ``quant``).
"""

from __future__ import annotations

import contextlib

import torch


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 with a per-tensor scale (its
    absolute maximum onto 448), back in ``t``'s dtype; the gradient passes
    straight through.  The precision control's conv operands."""
    with torch.no_grad():
        scale = 448.0 / t.detach().abs().amax().clamp_min(1e-12)
        r = (t.detach() * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale
    return t + (r - t).detach() if t.requires_grad else r


@contextlib.contextmanager
def exact_fp32():
    """fp32 matrix products and convolutions without TF32 inside the block."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
