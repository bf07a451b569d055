"""K2: batched window gather from channels-last volumes or stacked stores.

Counterpart of ``tpu_mednet/ops/pallas/patches.py`` (``extract_patches_xla``
/ ``extract_patches_pallas``): N windows of (px, py, pz, C) cut from an
(X, Y, Z, C) volume at N in-bounds int32 corners; and of the device
sampler's gather (``tpu_mednet/data/device_sampler.py:171-190``): with
``subjects``, window i is cut from ``store[subjects[i]]`` of a stacked
(S, X, Y, Z, C) store.  ``extract_patches_stores`` cuts the same windows
from several stores that share their subjects and extent (the sampler's
image and label stores) in one launch.  The output dtype cast (e.g. the f16
volume -> the model's compute dtype) is fused in; uint8 (label) stores are
only copied.

On CUDA stores the kernel of ``csrc/patches.cu`` runs; on CPU stores its
plain version (a stack of slices per store) runs instead; any other device
raises.  Corners and subjects come from the host, as the TPU kernel's
scalar-prefetched corners did: they are validated here once and uploaded
with the launch.
"""

from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from tpu_mednet_torch.ops import _build

# launch counter: +1 where the wrapper launches its kernel, nowhere else
LAUNCHES = 0

# launch plan; _STAGE_BYTES and _BLOCKS_PER_SM must match kMaxStageBytes
# and kBlocksPerSM in csrc/patches.cu (whose ring has kStages = 3 stages)
_STAGE_BYTES = 20 * 1024    # one stage: a 96^3 bf16 plane's source spans
_BLOCKS_PER_SM = 3          # persistent grid: 3 blocks of a 3-stage ring per SM
_PIECE_BYTES = 4096         # longest piece of a row, in the wider dtype
_MAX_STORES = 2             # store descriptors a launch takes


class _Store(ctypes.Structure):
    """``GatherStore`` of csrc/patches.cu."""

    _fields_ = [("vol", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("subject_bytes", ctypes.c_longlong), ("line_bytes", ctypes.c_longlong),
                ("voxel_bytes", ctypes.c_int), ("ye", ctypes.c_int),
                ("in_dtype", ctypes.c_int), ("out_dtype", ctypes.c_int),
                ("row_len", ctypes.c_int), ("piece_len", ctypes.c_int),
                ("pieces_per_row", ctypes.c_int), ("pieces_per_unit", ctypes.c_int),
                ("in_slot", ctypes.c_int), ("pieces", ctypes.c_int), ("blocks", ctypes.c_int),
                ("magic", ctypes.c_uint * 6), ("shift", ctypes.c_int * 6)]


_GATHER_ARGS = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p]


def fast_divisor(d: int) -> Tuple[int, int]:
    """(magic, shift) with n // d == (n * magic >> 32) >> shift for every
    0 <= n < 2^31 (the kernel's ``fdiv``); magic 0 stands for d = 1."""
    if d == 1:
        return 0, 0
    log2 = (d - 1).bit_length()  # ceil(log2 d)
    return -(-(1 << (31 + log2)) // d), log2 - 1


class StorePlan(NamedTuple):
    """How ``gather_stores_kernel`` walks one store.  Elements are the
    kernel's: bytes for a copy of equal dtypes, else the dtypes' elements.
    The output is N * px * py rows of ``row_len`` elements, each cut into
    ``pieces_per_row`` pieces of at most ``piece_len``: ``pieces`` pieces in
    output order.  A unit is ``pieces_per_unit`` consecutive pieces (whole
    planes' rows, across planes), each loaded into a slot of ``in_slot``
    bytes of one stage; ``blocks`` blocks walk the store's ``units`` units
    with a grid stride."""

    row_len: int
    in_size: int
    out_size: int
    piece_len: int
    pieces_per_row: int
    pieces_per_unit: int
    in_slot: int
    pieces: int
    units: int
    blocks: int


def plan_gather(n: int, px: int, py: int, rows: Sequence[Tuple[int, int, int]],
                sms: int) -> Tuple[List[StorePlan], int]:
    """Launch plan for N windows of (px, py, ...) from stores whose output
    rows are ``rows`` = (row_len, in_size, out_size) each.  Returns the
    stores' plans and the stage's bytes (the slots, then a byte per piece).
    The grid holds about ``_BLOCKS_PER_SM`` blocks per SM, split between the
    stores in proportion to their bytes, at least one each and none without
    a unit."""
    plans = []
    for row_len, in_size, out_size in rows:
        piece_len = min(row_len, _PIECE_BYTES // max(in_size, out_size))
        per_row = -(-row_len // piece_len)
        # a span of L bytes at any 16-byte phase lies in ceil16(L + 15) bytes
        in_slot = (piece_len * in_size + 31) // 16 * 16
        pieces = n * px * py * per_row
        per_unit = max(1, min(pieces, (_STAGE_BYTES - 15) // (in_slot + 1)))
        units = -(-pieces // per_unit)
        per_unit = -(-pieces // units)       # even units
        units = -(-pieces // per_unit)
        plans.append(StorePlan(row_len, in_size, out_size, piece_len, per_row, per_unit,
                               in_slot, pieces, units, 0))
    grid = min(sms * _BLOCKS_PER_SM, sum(p.units for p in plans))
    nbytes = [p.pieces // p.pieces_per_row * p.row_len * (p.in_size + p.out_size)
              for p in plans]
    blocks, left = [], grid
    for i, p in enumerate(plans):
        rest = len(plans) - i - 1
        share = left if not rest else round(grid * nbytes[i] / sum(nbytes))
        blocks.append(min(p.units, max(1, min(share, left - rest))))
        left -= blocks[-1]
    plans = [p._replace(blocks=b) for p, b in zip(plans, blocks)]
    stage = max(p.pieces_per_unit * p.in_slot + -(-p.pieces_per_unit // 16) * 16
                for p in plans)
    return plans, stage


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


def _gather_plain(store: torch.Tensor, windows: np.ndarray, patch_size: Sequence[int],
                  out_dtype: torch.dtype, indexed: bool) -> torch.Tensor:
    px, py, pz = (int(p) for p in patch_size)
    store = store if indexed else store[None]
    if not len(windows):
        return torch.empty((0, px, py, pz, store.shape[-1]), dtype=out_dtype)
    out = torch.stack([store[s, x:x + px, y:y + py, z:z + pz]
                       for x, y, z, s in windows.tolist()])
    return out.to(out_dtype)


def extract_patches_plain(volume: torch.Tensor, corners, patch_size: Sequence[int],
                          out_dtype: Optional[torch.dtype] = None,
                          subjects=None) -> torch.Tensor:
    """(X, Y, Z, C) volume, or (S, X, Y, Z, C) store with ``subjects`` ->
    (N, px, py, pz, C) windows, cast to out_dtype."""
    out_dtype = out_dtype or volume.dtype
    _check_dtypes(volume, out_dtype)
    windows = _host_windows(volume, corners, patch_size, subjects)
    return _gather_plain(volume, windows, patch_size, out_dtype, subjects is not None)


def _gather_cuda(stores: Sequence[torch.Tensor], windows: np.ndarray,
                 patch_size: Sequence[int], out_dtypes: Sequence[torch.dtype],
                 indexed: bool) -> List[torch.Tensor]:
    """One launch of ``gather_stores_kernel`` over validated windows."""
    global LAUNCHES
    if len(stores) > _MAX_STORES:
        raise ValueError(f"extract_patches: one launch takes at most {_MAX_STORES} stores, "
                         f"got {len(stores)}")
    if any(s.device != stores[0].device for s in stores):
        raise ValueError("extract_patches: the stores lie on different devices")
    px, py, pz = (int(p) for p in patch_size)
    n = windows.shape[0]
    outs, rows = [], []
    for store, out_dtype in zip(stores, out_dtypes):
        _build.require_cuda(store, "extract_patches")
        if not store.is_contiguous():
            raise ValueError("extract_patches: volume must be contiguous")
        es = store.element_size()
        c = store.shape[-1]
        if n * px * py * pz * c * es >= 2**31:
            raise ValueError("extract_patches: a launch's output must stay below 2^31 bytes "
                             "a store")
        outs.append(torch.empty((n, px, py, pz, c), dtype=out_dtype, device=store.device))
        copy = store.dtype == out_dtype
        rows.append((pz * c * es, 1, 1) if copy else
                    (pz * c, es, torch.empty((), dtype=out_dtype).element_size()))
    if n * px * py * pz == 0:
        return outs
    dev = stores[0].device
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans, stage_bytes = plan_gather(n, px, py, rows, sms)
    descs = (_Store * len(stores))()
    for d, store, out, plan in zip(descs, stores, outs, plans):
        es = store.element_size()
        xe, ye, ze, c = store.shape[-4:]
        d.vol, d.out = store.data_ptr(), out.data_ptr()
        d.subject_bytes = xe * ye * ze * c * es if indexed else 0
        d.line_bytes, d.voxel_bytes, d.ye = ze * c * es, c * es, ye
        d.in_dtype = _build.DTYPE_CODES[store.dtype]
        d.out_dtype = _build.DTYPE_CODES[out.dtype]
        for name in ("row_len", "piece_len", "pieces_per_row", "pieces_per_unit", "in_slot",
                     "pieces", "blocks"):
            setattr(d, name, getattr(plan, name))
        for i, divisor in enumerate((plan.row_len, plan.piece_len, plan.pieces_per_row,
                                     plan.in_slot // 16, py, px)):
            d.magic[i], d.shift[i] = fast_divisor(divisor)
    dev_windows = torch.from_numpy(windows).pin_memory().to(dev, non_blocking=True)
    fn = _build.kernel("tmt_gather_stores", _GATHER_ARGS)
    err = fn(ctypes.addressof(descs), len(stores), dev_windows.data_ptr(), px, py, stage_bytes,
             _build.stream_of(stores[0]))
    _build.check(err, "tmt_gather_stores")
    LAUNCHES += 1
    return outs


def extract_patches(volume: torch.Tensor, corners, patch_size: Sequence[int],
                    out_dtype: Optional[torch.dtype] = None,
                    subjects=None) -> torch.Tensor:
    """K2: gather N windows; ``corners`` is a host (N, 3) integer array and
    ``subjects``, where given, a host (N,) integer array into the store."""
    return extract_patches_stores([volume], corners, patch_size, subjects, [out_dtype])[0]


def extract_patches_stores(stores: Sequence[torch.Tensor], corners, patch_size: Sequence[int],
                           subjects, out_dtypes: Optional[Sequence[torch.dtype]] = None
                           ) -> List[torch.Tensor]:
    """K2 over stores that share their subjects and extent (their channels
    and dtypes may differ): the same N windows of each, cast to its entry of
    ``out_dtypes`` (default: its own dtype), one output per store.  On CUDA
    one launch cuts them all (up to two stores), with the windows validated
    and uploaded once; on the CPU, the plain version per store.
    ``subjects`` as in :func:`extract_patches` (None for (X, Y, Z, C)
    volumes)."""
    stores = list(stores)
    if not stores:
        raise ValueError("extract_patches_stores: no store given")
    out_dtypes = list(out_dtypes) if out_dtypes is not None else [None] * len(stores)
    if len(out_dtypes) != len(stores):
        raise ValueError(f"extract_patches_stores: {len(out_dtypes)} out_dtypes for "
                         f"{len(stores)} stores")
    out_dtypes = [dt or s.dtype for s, dt in zip(stores, out_dtypes)]
    windows = _host_windows(stores[0], corners, patch_size, subjects)
    for store, out_dtype in zip(stores, out_dtypes):
        _check_dtypes(store, out_dtype)
        if store.shape[:-1] != stores[0].shape[:-1]:
            raise ValueError(f"extract_patches_stores: stores of {tuple(store.shape)} and "
                             f"{tuple(stores[0].shape)} differ in subject count or extent")
    on_cpu = [s.device.type == "cpu" for s in stores]
    if all(on_cpu):
        return [_gather_plain(s, windows, patch_size, dt, subjects is not None)
                for s, dt in zip(stores, out_dtypes)]
    if any(on_cpu):
        raise ValueError("extract_patches_stores: the stores lie on different devices")
    return _gather_cuda(stores, windows, patch_size, out_dtypes, subjects is not None)
