"""Native (C++) host runtime of the port: build on demand + ctypes bindings.

Counterpart of ``tpu_mednet/native/__init__.py``: the per-batch host work
of the training input pipeline (crop + f16->f32 + channels-last transpose)
compiled from the port's own ``patchloader.cpp`` and driven from
``tpu_mednet_torch/data/native_loader.py``.  ctypes drops the GIL for the
duration of each call, so native assembly overlaps the card's work.

The library is compiled with ``g++ -O3 -std=c++17 -shared -fPIC`` at first
use (never at import) into ``tpu_mednet_torch/csrc/build/`` (listed in
``.gitignore``), named by a hash of the source, so an edit rebuilds; it is
compiled into a temporary file and renamed, so processes that build
together race safely.  ``available()`` is False when the build fails (the
compiler's error is logged once as a warning) or ``TPU_MEDNET_NO_NATIVE``
is set; :func:`build` raises with the compiler's error instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import numpy as np
import torch

logger = logging.getLogger(__name__)

SRC = Path(__file__).resolve().parent / "patchloader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "csrc" / "build"
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC"]

# +1 per assemble_batch call, nowhere else: a run can show the native path ran
ASSEMBLE_CALLS = 0

_lib: Optional[ctypes.CDLL] = None
# the failed build's message under auto (warned once, not retried)
BUILD_ERROR: Optional[str] = None
_TORCH_DTYPES = {np.dtype(np.float32): torch.float32, np.dtype(np.uint8): torch.uint8}


def library_path() -> Path:
    """Path of the library for the current source (built or not)."""
    digest = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libpatchloader_{digest}.so"


def build() -> Path:
    """Compile ``patchloader.cpp`` if its library is missing; return its path.
    Raises ``RuntimeError`` with the compiler's output when g++ fails."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", tmp],
                              capture_output=True, text=True, timeout=120)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC.name} (exit {proc.returncode}):\n"
                               f"{proc.stderr.strip()}")
        os.replace(tmp, lib)
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f"g++ could not build {SRC.name}: {e}") from e
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    logger.info("built native patchloader: %s", lib)
    return lib


def load() -> ctypes.CDLL:
    """The built library with its ``argtypes`` set; builds it first."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        i64 = ctypes.c_int64
        pp = ctypes.POINTER(ctypes.c_void_p)
        pi64 = ctypes.POINTER(i64)
        lib.assemble_batch.restype = None
        lib.assemble_batch.argtypes = [
            i64,                    # n
            pp, pi64,               # img ptrs, dims
            pp, pi64,               # lbl ptrs, dims
            pp, pi64,               # hm ptrs, dims (nullable)
            pi64,                   # corners
            i64, i64, i64,          # patch dims
            ctypes.c_void_p,        # out_data
            ctypes.c_void_p,        # out_label
        ]
        _lib = lib
    return _lib


def available() -> bool:
    """True when the native assembly core is built and loadable (and
    ``TPU_MEDNET_NO_NATIVE`` is unset).  A failed build is logged once, with
    the compiler's error, and not retried in this process."""
    global BUILD_ERROR
    if os.environ.get("TPU_MEDNET_NO_NATIVE"):
        return False
    if _lib is not None:
        return True
    if BUILD_ERROR is not None:
        return False
    try:
        load()
    except (RuntimeError, OSError) as e:
        BUILD_ERROR = str(e)
        logger.warning("native patchloader build failed; falling back to the numpy "
                       "pipeline: %s", BUILD_ERROR)
        return False
    return True


def _ptr_array(vols, dtype) -> "ctypes.Array":
    arr = (ctypes.c_void_p * len(vols))()
    for i, v in enumerate(vols):
        if v is None:
            arr[i] = None
            continue
        if v.dtype != dtype or not v.flags.c_contiguous:
            raise ValueError(f"volume {i}: need C-contiguous {dtype}")
        arr[i] = v.ctypes.data
    return arr


def _dims_array(vols) -> np.ndarray:
    dims = np.zeros((len(vols), 4), dtype=np.int64)
    for i, v in enumerate(vols):
        if v is not None:
            dims[i] = v.shape
    return dims


def _out_ptr(out, shape, dtype: np.dtype, what: str) -> int:
    """Address of a C-contiguous host output (numpy array or CPU tensor,
    pinned or not) of ``shape`` and ``dtype``."""
    if isinstance(out, torch.Tensor):
        ok = (out.device.type == "cpu" and tuple(out.shape) == shape
              and out.dtype == _TORCH_DTYPES[np.dtype(dtype)] and out.is_contiguous())
        ptr = out.data_ptr()
    else:
        ok = out.shape == shape and out.dtype == dtype and out.flags.c_contiguous
        ptr = out.ctypes.data
    if not ok:
        raise ValueError(f"{what} must be C-contiguous "
                         f"({','.join(str(s) for s in shape)}) {np.dtype(dtype).name}")
    return ptr


def assemble_batch(
    images,                     # list[np.ndarray (C,X,Y,Z) f16], one per sample
    labels,                     # list[np.ndarray (Cl,X,Y,Z) u8]
    heatmaps,                   # list[np.ndarray (Ch,X,Y,Z) u8] or None
    corners: np.ndarray,        # (n, 3) int64 patch corners
    patch_size,                 # (px, py, pz)
    out_data,                   # (n, px,py,pz, C) float32, preallocated
    out_label,                  # (n, px,py,pz, Ch+Cl) uint8, preallocated
) -> None:
    """One fused native pass: crop + f16->f32 + channels-last transpose.

    The outputs are numpy arrays or CPU tensors (pinned ones included),
    written through their addresses.  Output layout matches
    ``PatchSampler.batches`` (heatmap channels first, class map last);
    equivalence is held by tests/test_torch_native_loader.py.
    """
    global ASSEMBLE_CALLS
    lib = load()
    n = len(images)
    px, py, pz = (int(p) for p in patch_size)
    c_img = int(images[0].shape[0])
    c_out = int(labels[0].shape[0]) + (
        int(heatmaps[0].shape[0]) if heatmaps is not None else 0)
    data_ptr = _out_ptr(out_data, (n, px, py, pz, c_img), np.float32, "out_data")
    label_ptr = _out_ptr(out_label, (n, px, py, pz, c_out), np.uint8, "out_label")
    corners = np.ascontiguousarray(corners, dtype=np.int64)
    img_dims = _dims_array(images)
    lbl_dims = _dims_array(labels)
    hm_list = heatmaps if heatmaps is not None else [None] * n
    hm_dims = _dims_array(hm_list)
    # the C++ pass reads without bounds checks: every window must lie inside
    # every volume it is cut from
    if corners.shape != (n, 3):
        raise ValueError(f"corners must be ({n}, 3), got {corners.shape}")
    far = corners + np.asarray([px, py, pz], dtype=np.int64)
    for dims, what in ((img_dims, "image"), (lbl_dims, "label"), (hm_dims, "heatmap")):
        if what == "heatmap" and heatmaps is None:
            continue
        if np.any(corners < 0) or np.any(far > dims[:, 1:]):
            raise ValueError(f"a patch window lies outside its {what} volume: corners "
                             f"{corners.tolist()}, patch {(px, py, pz)}, extents "
                             f"{dims[:, 1:].tolist()}")
    hm_ptrs = (_ptr_array(hm_list, np.uint8) if any(h is not None for h in hm_list)
               else (ctypes.c_void_p * n)())
    pi64 = ctypes.POINTER(ctypes.c_int64)
    lib.assemble_batch(
        n,
        _ptr_array(images, np.float16), img_dims.ctypes.data_as(pi64),
        _ptr_array(labels, np.uint8), lbl_dims.ctypes.data_as(pi64),
        hm_ptrs, hm_dims.ctypes.data_as(pi64),
        corners.ctypes.data_as(pi64),
        px, py, pz,
        data_ptr, label_ptr,
    )
    ASSEMBLE_CALLS += 1
