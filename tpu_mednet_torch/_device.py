"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and absent.

    There is no fallback to the CPU: a caller that wants the CPU says so.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available "
            "(torch.cuda.is_available() is False); pass device='cpu' to run "
            "on the CPU"
        )
    return dev
