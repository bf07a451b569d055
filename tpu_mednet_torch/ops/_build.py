"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``), one
process per source started together, and linked into ONE shared library
with a plain C interface under ``csrc/build/`` (listed in ``.gitignore``).
The library is named by a hash of the sources and headers, so an edit to
any of them rebuilds on first use.  It is loaded with ``ctypes``; every C
entry returns ``cudaGetLastError()`` and :func:`check` raises on non-zero.

Nothing here runs at import time: the CPU tests import the ops modules on
hosts without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# must match enum DType in csrc/common.cuh; uint8 is copied, never cast
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.uint8: 3}

_LIB: Optional[ctypes.CDLL] = None
_FUNCS: Dict[str, object] = {}
# compiler output of the last build (ptxas register / spill report)
BUILD_LOG = ""


def _nvcc() -> str:
    cands = [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    home = os.environ.get("CUDA_HOME")
    if home:
        cands.insert(0, str(Path(home) / "bin" / "nvcc"))
    for cand in cands:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin, PATH, /usr/local/cuda/bin): "
        "the CUDA kernels of tpu_mednet_torch cannot be built on this host"
    )


def library_path() -> Path:
    """Path of the library for the current sources (built or not)."""
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libtpu_mednet_torch_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources if their library is missing; return its path."""
    global BUILD_LOG
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(dir=BUILD_DIR))
    try:
        jobs = []
        for src in sorted(CSRC.glob("*.cu")):
            obj = tmp / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            jobs.append((src, obj, proc))
        logs, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"== {src.name}\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        BUILD_LOG = "\n".join(logs)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{BUILD_LOG}")
        out_so = tmp / lib.name
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(out_so), *(str(o) for _, o, _ in jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(out_so, lib)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.tmt_error_string.argtypes = [ctypes.c_int]
        lib.tmt_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def kernel(name: str, argtypes: list):
    """The C entry ``name`` with its ``argtypes`` set (pointers and the
    stream as ``c_void_p``, so ctypes does not cut them to 32 bits)."""
    fn = _FUNCS.get(name)
    if fn is None:
        fn = getattr(_library(), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FUNCS[name] = fn
    return fn


def check(err: int, what: str) -> None:
    """Raise if a C entry reported a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err:
        msg = _library().tmt_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(t: torch.Tensor, what: str) -> None:
    """A wrapper reaches its kernel only for a CUDA tensor, else raises."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA or CPU tensor, got {t.device}")
