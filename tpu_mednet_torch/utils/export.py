"""NIfTI export: ``python -m tpu_mednet_torch.utils.export``.

The port's counterpart of ``tpu_mednet/utils/export.py`` (reference
``midasmednet/utils/export.py:15-89``), with the same flags, written with
argparse: dump the volumes of one group of an HDF5 file or a zarr store
(``.zarr`` directory or ``.zip``) to per-key ``.nii.gz`` files under
``<export_dir>/<store stem>/<group>/``, one file per channel
(``<key>_<group>_c<c>.nii.gz``) or, with ``--sum_channels``, the sum of
the ``--select_channels`` subset (``heatmaps`` = all but the last channel,
``mask`` = the last, ``all``) as ``<key>_<group>_<selection>_sum.nii.gz``;
``--dtype float`` writes float32, ``int`` uint8.  Each file carries the
stored ``affine`` attribute.  The store is read through the port's
readers (``zarrlite`` where ``zarr`` is absent; h5py only for an HDF5
file).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from tpu_mednet_torch.config import load_dotenv, read_keyfile
from tpu_mednet_torch.data.readers import open_reader
from tpu_mednet_torch.utils.nifti import save_nifti

SUFFIXES = (".h5", ".hdf5", ".zip", ".zarr")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--data_path", required=True)
    parser.add_argument("--data_group", default="images")
    parser.add_argument("--export_dir", required=True)
    parser.add_argument("--sum_channels", action="store_true")
    parser.add_argument("--test_keys", default=None)
    parser.add_argument("--select_channels", default="all", type=str.lower,
                        choices=["heatmaps", "mask", "all"])
    parser.add_argument("--dtype", default="float", type=str.lower, choices=["float", "int"])
    return parser


def main(argv: Optional[Sequence[str]] = None) -> int:
    load_dotenv()
    parser = build_parser()
    args = parser.parse_args(argv)
    data_path = Path(args.data_path)
    if data_path.suffix not in SUFFIXES:
        parser.error(f"unsupported storage suffix {data_path.suffix}")
    group = args.data_group
    out_dir = Path(args.export_dir) / data_path.stem / group
    out_dir.mkdir(exist_ok=True, parents=True)
    dtype = np.float32 if args.dtype == "float" else np.uint8
    channels = {"all": slice(None), "heatmaps": slice(None, -1), "mask": slice(-1, None)}
    with open_reader(data_path) as reader:
        keys = read_keyfile(args.test_keys) if args.test_keys else reader.list_keys(group)
        affines = reader.get_data_attribute(keys, group, "affine")
        for key, vol in zip(keys, reader.read(keys, group, dtype=None)):
            affine = np.asarray(affines[key])
            if args.sum_channels:
                img = np.asarray(vol[channels[args.select_channels]], dtype=dtype).sum(axis=0)
                save_nifti(out_dir / f"{key}_{group}_{args.select_channels}_sum.nii.gz",
                           img, affine)
            else:
                for c in range(vol.shape[0]):
                    save_nifti(out_dir / f"{key}_{group}_c{c}.nii.gz",
                               np.asarray(vol[c], dtype=dtype), affine)
    print(f"exported {len(keys)} keys to {out_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
