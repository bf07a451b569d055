#!/usr/bin/env python3
"""Where the time of ``gn_moments_kernel`` goes, block by block, on one NVIDIA card.

    python3 chip_trace_moments.py

Copies ``tpu_mednet_torch`` into ``_archive/trace_moments/`` (gitignored)
with ``%globaltimer`` stamps, taken by thread 0 of every block at eight
points of ``gn_moments_kernel``, builds that copy, and runs the moments of
the full-width forward's five bf16 GroupNorm shapes (``chip_smoke.LEVELS``).
Per level it prints the stamped kernel's device time (``torch.profiler``;
the stamps add a little) and the medians over blocks of: start skew,
barrier set-up, streaming (median and slowest block), the row-slot fold,
and for each sample's last block the partial + fence + ticket, the
combine of the partials, the group fold and the write.  Exits non-zero
without a result when CUDA is unavailable.
"""

from __future__ import annotations

import ctypes
import shutil
import sys
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
DEST = HERE / "_archive" / "trace_moments"
SAMPLES, BLOCKS, STAMPS = 8, 64, 8

_HELPERS = """
__device__ unsigned long long g_trace[%d];
__device__ __forceinline__ void tstamp(int n, int b, int k) {
  if (n < %d && b < %d) {
    unsigned long long t;
    asm volatile("mov.u64 %%0, %%globaltimer;" : "=l"(t));
    g_trace[(n * %d + b) * %d + k] = t;
  }
}
""" % (SAMPLES * BLOCKS * STAMPS, SAMPLES, BLOCKS, BLOCKS, STAMPS)

_ACCESS = """
int tmt_trace_read(void* host) {
  return cudaMemcpyFromSymbol(host, g_trace, sizeof(g_trace));
}
int tmt_trace_clear() {
  void* p = nullptr;
  cudaError_t err = cudaGetSymbolAddress(&p, g_trace);
  return err != cudaSuccess ? err : cudaMemset(p, 0, sizeof(g_trace));
}
"""

_MOMENTS = "__global__ void gn_moments_kernel("
_SUMS = "__device__ __forceinline__ bool sample_sums("

# (function of csrc/groupnorm.cu, anchor in its body, stamp index, stamp
# after the anchor).  The cross-block sum (stamps 4) lives in sample_sums,
# which the backward's reduce shares; only the moments run here.
_POINTS = [
    (_MOMENTS, "const T* xs = static_cast<const T*>(p.x) + (long long)n * p.s * c;", 0, True),
    (_MOMENTS, 'asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: "memory");\n    }\n'
     "    __syncthreads();", 1, True),
    (_MOMENTS, "    // every issued stage was waited for: the ring is free for the fold\n"
     "    __syncthreads();", 2, True),
    (_MOMENTS, "  if (!sample_sums(", 3, False),
    (_SUMS, "    if (!last_block) return false;", 4, True),
    (_MOMENTS, "  // the fold of ops/packed.py packed_group_norm_stats", 5, False),
    (_MOMENTS, "    g_rstd[g] = __frsqrt_rn(__fadd_rn(var, p.eps));\n  }\n  __syncthreads();",
     6, True),
    (_MOMENTS, "    p.rstd[(long long)n * c + ch] = g_rstd[g];\n  }", 7, True),
]


def _find(s: str, function: str, anchor: str) -> int:
    """Offset of ``anchor`` in the body of ``function``, where it must stand once."""
    if s.count(function) != 1:
        raise RuntimeError(f"not found once in groupnorm.cu: {function!r}")
    start = s.index(function)
    body = s[start:s.index("\n}\n", start)]
    if body.count(anchor) != 1:
        raise RuntimeError(f"anchor not found once in {function!r}: {anchor!r}")
    return start + body.index(anchor)


def stamped_copy(dest: Path = DEST) -> Path:
    """Copy the package to ``dest`` with the stamps in gn_moments_kernel."""
    if dest.exists():
        shutil.rmtree(dest)
    shutil.copytree(HERE / "tpu_mednet_torch", dest / "tpu_mednet_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    src = dest / "tpu_mednet_torch" / "csrc" / "groupnorm.cu"
    s = src.read_text()
    for function, anchor, k, after in _POINTS:
        i = _find(s, function, anchor) + (len(anchor) if after else 0)
        s = s[:i] + f"\n  if (threadIdx.x == 0) tstamp(blockIdx.y, blockIdx.x, {k});\n" + s[i:]
    s = s.replace("template <int V>\n__device__ __forceinline__ void accumulate",
                  _HELPERS + "template <int V>\n__device__ __forceinline__ void accumulate", 1)
    s = s.replace('extern "C" {', 'extern "C" {\n' + _ACCESS, 1)
    src.write_text(s)
    return dest


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_trace_moments: CUDA is not available; this run needs an NVIDIA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(HERE))
    from chip_smoke import BATCH, GROUPS, LEVELS, kernel_ms

    sys.path.insert(0, str(stamped_copy()))
    from tpu_mednet_torch.ops import _build
    from tpu_mednet_torch.ops import groupnorm as gn

    if not Path(gn.__file__).resolve().is_relative_to(DEST):
        raise RuntimeError(f"imported {gn.__file__}, not the stamped copy")
    clear = _build.kernel("tmt_trace_clear", [])
    read = _build.kernel("tmt_trace_read", [ctypes.c_void_p])
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    buf = np.zeros(SAMPLES * BLOCKS * STAMPS, np.uint64)
    med = lambda a: float(np.median(a)) / 1e3  # ns -> us
    for level, (c, e, _) in enumerate(LEVELS):
        x = (torch.randn((BATCH, e, e, e, c), generator=gen, device=dev) + 0.5)
        x = x.to(torch.bfloat16).permute(0, 4, 1, 2, 3)
        w = torch.rand(c, generator=gen, device=dev) + 0.5
        f = lambda: gn.group_norm_moments(x, GROUPS, w, 1e-5)
        t, _ = kernel_ms(torch, f, "gn_moments", reps=50)
        for _ in range(3):
            _build.check(clear(), "tmt_trace_clear")
            f()
            torch.cuda.synchronize()
            _build.check(read(buf.ctypes.data), "tmt_trace_read")
            tr = buf.reshape(SAMPLES, BLOCKS, STAMPS).astype(np.int64)
            used = tr[:, :, 0] > 0
            rel = np.where(tr > 0, tr - tr[:, :, 0][used].min(), -1)
            d = lambda a, b: (rel[:, :, b] - rel[:, :, a])[used]
            last = rel[:, :, 4] >= 0
            dl = lambda a, b: (rel[:, :, b] - rel[:, :, a])[last]
            print(f"L{level} {tuple(x.shape)}: kernel {t * 1e3:.2f} us (stamped) | "
                  f"{int(used.sum())} blocks, start skew max {rel[:, :, 0][used].max() / 1e3:.2f} | "
                  f"set-up {med(d(0, 1)):.2f} | stream median {med(d(1, 2)):.2f} "
                  f"slowest {d(1, 2).max() / 1e3:.2f} | row-slot fold {med(d(2, 3)):.2f} | "
                  f"last block: partial+fence+ticket {med(dl(3, 4)):.2f} combine "
                  f"{med(dl(4, 5)):.2f} group fold {med(dl(5, 6)):.2f} write "
                  f"{med(dl(6, 7)):.2f} | slowest block's fold done at "
                  f"{rel[:, :, 3][used].max() / 1e3:.2f}, last write at "
                  f"{rel[:, :, 7][last].max() / 1e3:.2f} us", flush=True)
        del x
    return 0


if __name__ == "__main__":
    sys.exit(main())
