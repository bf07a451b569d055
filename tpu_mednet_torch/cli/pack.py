"""Convert datasets between store formats:
``python -m tpu_mednet_torch.cli.pack``.

The port's copy of ``tpu_mednet/cli/pack.py`` (the reference only exports
containers to NIfTI, ``midasmednet/utils/export.py``).  It copies groups
and keys from any store the port reads (HDF5, zarr directory or zip,
NIfTI directories) into any store it writes, with per-volume affines::

    python -m tpu_mednet_torch.cli.pack --src data/ --dst data.zarr    # nii dir -> zarr
    python -m tpu_mednet_torch.cli.pack --src data.h5 --dst data.zarr  # HDF5 -> zarr
    python -m tpu_mednet_torch.cli.pack --src data.zip --dst out.nii   # zarr zip -> nii dir
    python -m tpu_mednet_torch.cli.pack --src data.zarr --dst small.zarr \
        --groups images labels --subjects train.txt                    # subset

Volumes keep their stored dtype and go one at a time.  Host numpy: it
creates no tensor and uses no card.
"""

from __future__ import annotations

import argparse
import logging
import sys
from typing import Optional, Sequence

import numpy as np

from tpu_mednet_torch.config import load_dotenv, replace_env

logger = logging.getLogger("pack")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--src", required=True,
                        help="source store (h5/zarr/.zip/.nii directory)")
    parser.add_argument("--dst", required=True,
                        help="destination: *.h5/*.hdf5, *.zarr, *.zip, or a "
                             "*.nii directory")
    parser.add_argument("--groups", nargs="+", default=None,
                        help="groups to copy (default: every group in src)")
    parser.add_argument("--subjects", default=None,
                        help="key file restricting which subjects copy "
                             "(default: every key per group)")
    parser.add_argument("--log_level", type=str, default="INFO")
    return parser


def pack(src, dst, groups=None, subjects=None) -> int:
    """Copy ``groups`` (default: all) from ``src`` into ``dst``.

    Returns the number of volumes copied.  The destination format is
    routed by suffix exactly like ``VolumeGroup.save``.
    """
    from tpu_mednet_torch.data.readers import open_reader
    from tpu_mednet_torch.data.stores import VolumeGroup

    reader = open_reader(src)
    try:
        if groups is None:
            groups = reader.list_groups()
            if not groups:
                raise SystemExit(f"no groups found in {src}")
            logger.info("copying all groups: %s", groups)
        n = 0
        for group in groups:
            try:
                keys = (subjects if subjects is not None
                        else reader.list_keys(group))
            except KeyError:
                raise SystemExit(f"group {group!r} not found in {src}")
            if not keys:
                raise SystemExit(f"no keys to copy from group {group!r}")
            # stream one volume at a time: every destination format appends,
            # so peak memory is a single volume, not the whole group
            for key, vol in zip(keys,
                                reader.read(keys, group, dtype=None)):
                vol = np.asarray(vol)
                out = VolumeGroup()
                ds = out.require_dataset(key, vol.shape, vol.dtype)
                ds[:] = vol
                try:  # per-key: stores may carry affines on some volumes only
                    affine = reader.get_data_attribute(
                        [key], group, "affine")[key]
                except KeyError:
                    affine = None
                if affine is not None:
                    ds.attrs["affine"] = np.asarray(affine)
                out.save(dst, group=group)
                n += 1
            logger.info("group %s: %d volumes", group, len(keys))
        return n
    finally:
        reader.close()


def main(argv: Optional[Sequence[str]] = None) -> int:
    load_dotenv()
    args = build_parser().parse_args(argv)
    logging.basicConfig(level=args.log_level)

    subjects = None
    if args.subjects:
        text = open(replace_env(args.subjects)).read()
        subjects = [line.strip() for line in text.splitlines() if line.strip()]

    n = pack(replace_env(args.src), replace_env(args.dst),
             groups=args.groups, subjects=subjects)
    logger.info("copied %d volumes from %s to %s", n, args.src, args.dst)
    return 0


if __name__ == "__main__":
    sys.exit(main())
