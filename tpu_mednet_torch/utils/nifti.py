"""NIfTI-1 I/O without external dependencies.

The port's own copy of ``tpu_mednet/utils/nifti.py`` (the reference uses
nibabel and a SimpleITK adapter, ``midasmednet/utils/nifti.py``): a
minimal NIfTI-1 reader and writer (``.nii`` / ``.nii.gz``, sform affine,
common dtypes), the ITK-metadata affine helpers, and ``sitk_make_affine``/``sitk_to_nifti``
for SimpleITK images (SimpleITK is imported only by ``sitk_to_nifti``).
"""

from __future__ import annotations

import gzip
import logging
import struct
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_DTYPE_TO_CODE = {
    np.dtype(np.uint8): (2, 8),
    np.dtype(np.int16): (4, 16),
    np.dtype(np.int32): (8, 32),
    np.dtype(np.float32): (16, 32),
    np.dtype(np.float64): (64, 64),
    np.dtype(np.int8): (256, 8),
    np.dtype(np.uint16): (512, 16),
    np.dtype(np.uint32): (768, 32),
    np.dtype(np.int64): (1024, 64),
    np.dtype(np.uint64): (1280, 64),
}
_CODE_TO_DTYPE = {code: dt for dt, (code, _) in _DTYPE_TO_CODE.items()}

_HEADER_SIZE = 348
_VOX_OFFSET = 352.0


def save_nifti(path, data: np.ndarray, affine: Optional[np.ndarray] = None) -> None:
    """Write a 3D/4D array as NIfTI-1 (.nii or .nii.gz by suffix)."""
    data = np.asarray(data)
    if data.ndim not in (3, 4):
        raise ValueError(f"NIfTI writer supports 3D/4D arrays, got {data.ndim}D")
    if data.dtype not in _DTYPE_TO_CODE:
        # lossless widenings stay quiet; anything else is worth a warning
        target = np.uint8 if data.dtype == np.bool_ else np.float32
        if data.dtype not in (np.bool_, np.float16):
            logger.warning(
                "NIfTI-1 has no dtype %s; writing %s as %s",
                data.dtype, path, np.dtype(target).name,
            )
        data = data.astype(target)
    affine = np.eye(4) if affine is None else np.asarray(affine, dtype=np.float64)
    if affine.shape != (4, 4):
        raise ValueError(f"affine must be 4x4, got {affine.shape}")

    code, bitpix = _DTYPE_TO_CODE[data.dtype]
    dim = np.ones(8, dtype=np.int16)
    dim[0] = data.ndim
    dim[1 : 1 + data.ndim] = data.shape
    pixdim = np.zeros(8, dtype=np.float32)
    pixdim[1:4] = np.linalg.norm(affine[:3, :3], axis=0)
    pixdim[4:] = 1.0

    hdr = bytearray(_HEADER_SIZE)
    struct.pack_into("<i", hdr, 0, _HEADER_SIZE)           # sizeof_hdr
    # byte 39 (dim_info) stays 0: no freq/phase/slice encoding claimed
    struct.pack_into("<8h", hdr, 40, *dim)                  # dim
    struct.pack_into("<h", hdr, 70, code)                   # datatype
    struct.pack_into("<h", hdr, 72, bitpix)                 # bitpix
    struct.pack_into("<8f", hdr, 76, *pixdim)               # pixdim
    struct.pack_into("<f", hdr, 108, _VOX_OFFSET)           # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)                   # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)                   # scl_inter
    struct.pack_into("<h", hdr, 252, 0)                     # qform_code
    struct.pack_into("<h", hdr, 254, 2)                     # sform_code: aligned
    struct.pack_into("<4f", hdr, 280, *affine[0])           # srow_x
    struct.pack_into("<4f", hdr, 296, *affine[1])           # srow_y
    struct.pack_into("<4f", hdr, 312, *affine[2])           # srow_z
    hdr[344:348] = b"n+1\x00"                               # magic

    # 4 bytes extension flag padding between header and data
    payload = bytes(hdr) + b"\x00\x00\x00\x00" + np.asfortranarray(data).tobytes(order="F")
    path = Path(str(path))
    if path.suffix == ".gz" or str(path).endswith(".nii.gz"):
        with gzip.open(path, "wb") as f:
            f.write(payload)
    else:
        path.write_bytes(payload)


def _parse_header(raw: bytes, path) -> Tuple[tuple, np.dtype, np.ndarray, int]:
    """Parse a NIfTI-1 header blob -> (shape, dtype, affine, vox_offset)."""
    if struct.unpack_from("<i", raw, 0)[0] != _HEADER_SIZE:
        raise ValueError(f"{path} is not a little-endian NIfTI-1 file")
    magic = raw[344:348]
    if magic not in (b"n+1\x00", b"ni1\x00"):
        raise ValueError(f"bad NIfTI magic {magic!r}")
    dim = struct.unpack_from("<8h", raw, 40)
    ndim = dim[0]
    shape = tuple(dim[1 : 1 + ndim])
    code = struct.unpack_from("<h", raw, 70)[0]
    if code not in _CODE_TO_DTYPE:
        raise ValueError(f"unsupported NIfTI datatype code {code}")
    dtype = _CODE_TO_DTYPE[code]
    vox_offset = int(struct.unpack_from("<f", raw, 108)[0])

    sform_code = struct.unpack_from("<h", raw, 254)[0]
    affine = np.eye(4)
    if sform_code > 0:
        affine[0] = struct.unpack_from("<4f", raw, 280)
        affine[1] = struct.unpack_from("<4f", raw, 296)
        affine[2] = struct.unpack_from("<4f", raw, 312)
    else:
        pixdim = struct.unpack_from("<8f", raw, 76)
        affine[0, 0], affine[1, 1], affine[2, 2] = pixdim[1:4]
    return shape, dtype, affine, vox_offset


def read_nifti_header(path) -> Tuple[tuple, np.dtype, np.ndarray]:
    """Read just the header of a .nii/.nii.gz; returns (shape, dtype, affine).

    Streams the first 348 bytes only — for .gz this decompresses a single
    deflate block, so shape/affine queries over a directory of volumes
    (``NiftiReader.get_data_shape``) never touch the voxel payload.
    """
    path = Path(str(path))
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        raw = f.read(_HEADER_SIZE)
    if len(raw) < _HEADER_SIZE:
        raise ValueError(f"{path}: truncated NIfTI header")
    shape, dtype, affine, _ = _parse_header(raw, path)
    return shape, dtype, affine


def load_nifti(path) -> Tuple[np.ndarray, np.ndarray]:
    """Read a NIfTI-1 file; returns (data, affine)."""
    path = Path(str(path))
    if str(path).endswith(".gz"):
        with gzip.open(path, "rb") as f:
            raw = f.read()
    else:
        raw = path.read_bytes()
    shape, dtype, affine, vox_offset = _parse_header(raw, path)
    count = int(np.prod(shape))
    data = np.frombuffer(
        raw, dtype=dtype, count=count, offset=vox_offset
    ).reshape(shape, order="F").copy()
    return data, affine


def lps_affine_from_meta(direction, spacing, origin) -> np.ndarray:
    """Index->physical (LPS) affine from ITK-style image metadata.

    ITK's index->point map is ``point = origin + D @ diag(spacing) @ idx``
    with ``D`` the direction-cosine matrix — the same map the reference's
    ``make_affine`` (utils/nifti.py:39-54) probes one unit index step at a
    time via ``TransformContinuousIndexToPhysicalPoint``.

    ``direction`` may be a (3, 3) matrix or the flat row-major 9-tuple that
    ``SimpleITK.Image.GetDirection()`` returns.
    """
    direction = np.asarray(direction, dtype=np.float64).reshape(3, 3)
    spacing = np.asarray(spacing, dtype=np.float64).reshape(3)
    origin = np.asarray(origin, dtype=np.float64).reshape(3)
    affine = np.eye(4)
    affine[:3, :3] = direction * spacing[None, :]
    affine[:3, 3] = origin
    return affine


_LPS_TO_RAS = np.diag([-1.0, -1.0, 1.0, 1.0])


def ras_affine_from_meta(direction, spacing, origin) -> np.ndarray:
    """RAS (NIfTI-convention) affine from ITK-style (LPS) metadata.

    The reference flips the x/y rows after building the LPS affine
    (``make_affine``'s final ``np.matmul(np.diag([-1,-1,1,1]), affine)``,
    utils/nifti.py:53); same here.
    """
    return _LPS_TO_RAS @ lps_affine_from_meta(direction, spacing, origin)


def sitk_make_affine(simpleitk_image) -> np.ndarray:
    """The RAS affine of a SimpleITK (LPS) image, as the reference's
    ``make_affine`` (utils/nifti.py:39-54) builds it: ITK's index->point
    map, then x and y flipped (``ras_affine_from_meta``).  Any object with
    ``GetDirection``/``GetSpacing``/``GetOrigin`` will do."""
    img = simpleitk_image
    return ras_affine_from_meta(img.GetDirection(), img.GetSpacing(), img.GetOrigin())


def sitk_to_nifti(simpleitk_image, out_path) -> None:
    """Save a SimpleITK image as NIfTI with its RAS affine (the reference's
    ``SimpleITKAsNibabel`` adapter); SimpleITK is imported here, so only
    this call needs it."""
    import SimpleITK as sitk

    arr = sitk.GetArrayFromImage(simpleitk_image).transpose()
    save_nifti(out_path, arr, sitk_make_affine(simpleitk_image))
