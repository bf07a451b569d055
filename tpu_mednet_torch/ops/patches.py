"""K2: batched window gather from one channels-last volume.

Counterpart of ``tpu_mednet/ops/pallas/patches.py`` (``extract_patches_xla``
/ ``extract_patches_pallas``): N windows of (px, py, pz, C) cut from an
(X, Y, Z, C) volume at N in-bounds int32 corners.  The output dtype cast
(e.g. the f16 volume -> the model's compute dtype) is fused in.

On a CUDA volume the kernel of ``csrc/patches.cu`` runs; on a CPU volume
its plain version (a stack of slices) runs instead; any other device
raises.  Corners come from the host, as the TPU kernel's scalar-prefetched
corners did: they are validated here and uploaded with the launch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from tpu_mednet_torch.ops import _build

# launch counter: +1 where the wrapper launches its kernel, nowhere else
LAUNCHES = 0

_GATHER_ARGS = [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
]


def _host_corners(volume: torch.Tensor, corners, patch_size: Sequence[int]
                  ) -> np.ndarray:
    """Validate corners on the host: (N, 3) integers, every window in bounds."""
    if isinstance(corners, torch.Tensor):
        if corners.device.type != "cpu":
            raise ValueError("extract_patches: corners must be on the host")
        corners = corners.numpy()
    arr = np.asarray(corners)
    if arr.ndim != 2 or arr.shape[1] != 3 or not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"extract_patches: corners must be (N, 3) integers, "
                         f"got {arr.shape} {arr.dtype}")
    if volume.dim() != 4:
        raise ValueError(f"extract_patches: volume must be (X, Y, Z, C), got "
                         f"{tuple(volume.shape)}")
    lo = arr.min(axis=0) if len(arr) else np.zeros(3, np.int64)
    hi = (arr.max(axis=0) + np.asarray(patch_size)) if len(arr) else lo
    if np.any(lo < 0) or np.any(hi > np.asarray(volume.shape[:3])):
        raise ValueError(f"extract_patches: windows of {tuple(patch_size)} at "
                         f"corners in [{lo.tolist()}, {hi.tolist()}) leave the "
                         f"volume {tuple(volume.shape[:3])}")
    return np.ascontiguousarray(arr, dtype=np.int32)


def extract_patches_plain(volume: torch.Tensor, corners, patch_size: Sequence[int],
                          out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """(X, Y, Z, C) volume -> (N, px, py, pz, C) windows, cast to out_dtype."""
    px, py, pz = (int(p) for p in patch_size)
    arr = _host_corners(volume, corners, patch_size)
    out = torch.stack([volume[x:x + px, y:y + py, z:z + pz] for x, y, z in arr.tolist()])
    return out.to(out_dtype or volume.dtype)


def _extract_patches_cuda(volume, corners, patch_size, out_dtype=None):
    global LAUNCHES
    _build.require_cuda(volume, "extract_patches")
    arr = _host_corners(volume, corners, patch_size)
    out_dtype = out_dtype or volume.dtype
    for dt in (volume.dtype, out_dtype):
        if dt not in _build.DTYPE_CODES:
            raise ValueError(f"extract_patches: dtype {dt} not supported")
    if not volume.is_contiguous():
        raise ValueError("extract_patches: volume must be contiguous (X, Y, Z, C)")
    px, py, pz = (int(p) for p in patch_size)
    n = arr.shape[0]
    _, ye, ze, c = volume.shape
    if max(px * py, pz * c) >= 2**31:
        raise ValueError("extract_patches: a patch's rows must stay below 2^31 elements")
    out = torch.empty((n, px, py, pz, c), dtype=out_dtype, device=volume.device)
    if out.numel() == 0:
        return out
    dev_corners = torch.from_numpy(arr).pin_memory().to(volume.device, non_blocking=True)
    fn = _build.kernel("tmt_gather_patches", _GATHER_ARGS)
    err = fn(volume.data_ptr(), _build.DTYPE_CODES[volume.dtype],
             dev_corners.data_ptr(), n, out.data_ptr(),
             _build.DTYPE_CODES[out_dtype], ye, ze, c, px, py, pz,
             _build.stream_of(volume))
    _build.check(err, "tmt_gather_patches")
    LAUNCHES += 1
    return out


def extract_patches(volume: torch.Tensor, corners, patch_size: Sequence[int],
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """K2: gather N windows; ``corners`` is a host (N, 3) integer array."""
    if volume.device.type == "cpu":
        return extract_patches_plain(volume, corners, patch_size, out_dtype)
    return _extract_patches_cuda(volume, corners, patch_size, out_dtype)
