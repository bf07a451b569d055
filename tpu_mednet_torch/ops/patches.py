"""K2: batched window gather from a channels-last volume or a stacked store.

Counterpart of ``tpu_mednet/ops/pallas/patches.py`` (``extract_patches_xla``
/ ``extract_patches_pallas``): N windows of (px, py, pz, C) cut from an
(X, Y, Z, C) volume at N in-bounds int32 corners; and of the device
sampler's gather (``tpu_mednet/data/device_sampler.py:171-190``): with
``subjects``, window i is cut from ``store[subjects[i]]`` of a stacked
(S, X, Y, Z, C) store.  The output dtype cast (e.g. the f16 volume -> the
model's compute dtype) is fused in; uint8 (label) stores are only copied.

On a CUDA volume the kernel of ``csrc/patches.cu`` runs; on a CPU volume
its plain version (a stack of slices) runs instead; any other device
raises.  Corners and subjects come from the host, as the TPU kernel's
scalar-prefetched corners did: they are validated here and uploaded with
the launch.
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
    ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
]


def _host_array(a, what: str) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.device.type != "cpu":
            raise ValueError(f"extract_patches: {what} must be on the host")
        a = a.numpy()
    return np.asarray(a)


def _host_windows(volume: torch.Tensor, corners, patch_size: Sequence[int],
                  subjects=None) -> np.ndarray:
    """Validate windows on the host: (N, 3) integer corners, every window in
    bounds, and with ``subjects`` N integers in [0, S) of an (S, X, Y, Z, C)
    store.  Returns (N, 4) int32 rows (x, y, z, subject)."""
    arr = _host_array(corners, "corners")
    if arr.ndim != 2 or arr.shape[1] != 3 or not np.issubdtype(arr.dtype, np.integer):
        raise ValueError(f"extract_patches: corners must be (N, 3) integers, "
                         f"got {arr.shape} {arr.dtype}")
    dims = 4 if subjects is None else 5
    if volume.dim() != dims:
        want = "(X, Y, Z, C)" if subjects is None else "(S, X, Y, Z, C) with subjects"
        raise ValueError(f"extract_patches: volume must be {want}, got "
                         f"{tuple(volume.shape)}")
    extent = volume.shape[dims - 4:dims - 1]
    lo = arr.min(axis=0) if len(arr) else np.zeros(3, np.int64)
    hi = (arr.max(axis=0) + np.asarray(patch_size)) if len(arr) else lo
    if np.any(lo < 0) or np.any(hi > np.asarray(extent)):
        raise ValueError(f"extract_patches: windows of {tuple(patch_size)} at "
                         f"corners in [{lo.tolist()}, {hi.tolist()}) leave the "
                         f"volume {tuple(extent)}")
    out = np.zeros((len(arr), 4), np.int32)
    out[:, :3] = arr
    if subjects is not None:
        subj = _host_array(subjects, "subjects")
        if subj.shape != (len(arr),) or not np.issubdtype(subj.dtype, np.integer):
            raise ValueError(f"extract_patches: subjects must be ({len(arr)},) "
                             f"integers, got {subj.shape} {subj.dtype}")
        if len(subj) and (subj.min() < 0 or subj.max() >= volume.shape[0]):
            raise ValueError(f"extract_patches: subjects in [{subj.min()}, "
                             f"{subj.max()}] leave the store of {volume.shape[0]}")
        out[:, 3] = subj
    return out


def _check_dtypes(volume: torch.Tensor, out_dtype: torch.dtype) -> None:
    for dt in (volume.dtype, out_dtype):
        if dt not in _build.DTYPE_CODES:
            raise ValueError(f"extract_patches: dtype {dt} not supported")
    if (volume.dtype == torch.uint8) != (out_dtype == torch.uint8):
        raise ValueError(f"extract_patches: uint8 is only copied, not cast "
                         f"({volume.dtype} -> {out_dtype})")


def extract_patches_plain(volume: torch.Tensor, corners, patch_size: Sequence[int],
                          out_dtype: Optional[torch.dtype] = None,
                          subjects=None) -> torch.Tensor:
    """(X, Y, Z, C) volume, or (S, X, Y, Z, C) store with ``subjects`` ->
    (N, px, py, pz, C) windows, cast to out_dtype."""
    out_dtype = out_dtype or volume.dtype
    _check_dtypes(volume, out_dtype)
    px, py, pz = (int(p) for p in patch_size)
    windows = _host_windows(volume, corners, patch_size, subjects)
    store = volume if subjects is not None else volume[None]
    out = torch.stack([store[s, x:x + px, y:y + py, z:z + pz]
                       for x, y, z, s in windows.tolist()])
    return out.to(out_dtype)


def _extract_patches_cuda(volume, corners, patch_size, out_dtype=None, subjects=None):
    global LAUNCHES
    _build.require_cuda(volume, "extract_patches")
    windows = _host_windows(volume, corners, patch_size, subjects)
    out_dtype = out_dtype or volume.dtype
    _check_dtypes(volume, out_dtype)
    if not volume.is_contiguous():
        raise ValueError("extract_patches: volume must be contiguous")
    px, py, pz = (int(p) for p in patch_size)
    n = windows.shape[0]
    ye, ze, c = volume.shape[-3:]
    if max(px * py, pz * c) >= 2**31:
        raise ValueError("extract_patches: a patch's rows must stay below 2^31 elements")
    out = torch.empty((n, px, py, pz, c), dtype=out_dtype, device=volume.device)
    if out.numel() == 0:
        return out
    stride = volume[0].numel() if subjects is not None else 0
    dev_windows = torch.from_numpy(windows).pin_memory().to(volume.device,
                                                            non_blocking=True)
    fn = _build.kernel("tmt_gather_patches", _GATHER_ARGS)
    err = fn(volume.data_ptr(), _build.DTYPE_CODES[volume.dtype],
             dev_windows.data_ptr(), n, out.data_ptr(),
             _build.DTYPE_CODES[out_dtype], ye, ze, c, px, py, pz, stride,
             _build.stream_of(volume))
    _build.check(err, "tmt_gather_patches")
    LAUNCHES += 1
    return out


def extract_patches(volume: torch.Tensor, corners, patch_size: Sequence[int],
                    out_dtype: Optional[torch.dtype] = None,
                    subjects=None) -> torch.Tensor:
    """K2: gather N windows; ``corners`` is a host (N, 3) integer array and
    ``subjects``, where given, a host (N,) integer array into the store."""
    if volume.device.type == "cpu":
        return extract_patches_plain(volume, corners, patch_size, out_dtype, subjects)
    return _extract_patches_cuda(volume, corners, patch_size, out_dtype, subjects)
