// Batched window gather on Hopper: N patches cut from a channels-last
// volume, or from one subject each of a stacked store of volumes, at int32
// corners, with the output dtype cast fused in.
//
// Replaces tpu_mednet/ops/pallas/patches.py `extract_patches_pallas` (one
// DMA per patch with scalar-prefetched corners; the same gather is inlined
// in tpu_mednet/inference/device_sliding.py as a vmap'd dynamic_slice, and
// in tpu_mednet/data/device_sampler.py:171-190 as a dynamic_slice of
// images[s] and labels[s] per window).
//
// Bound: pure data movement, N*px*py*pz*C elements read and written once
// (8 x 96^3 f16 in, bf16 out is ~28 MB, ~8 us at 3.35 TB/s), so memory
// bandwidth and the launch itself bound it.
//
// Design: scalar prefetch becomes each block loading its patch's window
// (x, y, z, subject) itself; the subject selects a volume of the store,
// subject_stride elements apart (0 for a single volume).  uint8 label
// stores are copied byte for byte, never converted.  A patch is px*py rows of pz*C contiguous elements in both the
// volume and the output.  A row (cut into pieces of at most kPieceBytes
// where rows are long) is copied by one warp in three steps:
//   1. 16-byte cp.async copies of the aligned span [floor16(start),
//      ceil16(end)) of its source bytes into a shared-memory slot, so the
//      reads are full 16-byte sectors whatever the corner's alignment;
//   2. element by element from the slot, converted to the output dtype,
//      into a second slot at the output address's 16-byte phase;
//   3. 16-byte vector stores of every aligned vector inside the output
//      span, scalar stores only at an unaligned head or tail.
// Each warp carries up to kMaxPiecesPerWarp pieces at once, so a warp has
// several rows' loads in flight.  Rows, pieces and the patch come from
// blockIdx and the warp index: one lane per piece finds its row with 32-bit
// divisions and the warp shares the result by shuffles, so no element and
// no step repeats that index math.
// The 16-byte granules read around a span hold at least one byte of the
// volume, so they never leave its allocation's pages.  Corners are
// validated to be in bounds by the Python wrapper before the launch.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

using namespace tmt;

namespace {

constexpr int kGatherWarps = 8;
constexpr int kPieceBytes = 1024;  // longest piece of a row, in the wider dtype
constexpr int kWarpBytes = 1024;   // bytes a warp aims to have in flight
constexpr int kMaxPiecesPerWarp = 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(reinterpret_cast<uint64_t>(gmem))
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename Tin, typename Tout>
__device__ __forceinline__ Tout convert(Tin v) {
  if constexpr (std::is_same_v<Tin, Tout>) {
    return v;
  } else {
    return from_float<Tout>(to_float(v));
  }
}

struct GatherParams {
  const void* vol;
  const int* windows;   // (N, 4): x, y, z corner and subject
  long long subject_stride;  // elements between subjects of the store
  void* out;
  int ye, ze, c, px, py, pz;
  int piece_len;        // elements
  int pieces_per_row;
  int pieces_per_warp;
  int in_slot, out_slot;  // bytes, multiples of 16
};

template <typename Tin, typename Tout>
__global__ void __launch_bounds__(kGatherWarps * 32)
    gather_kernel(const GatherParams g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.y;
  const int row_len = g.pz * g.c;
  const int rows = g.px * g.py;
  const int first = (blockIdx.x * kGatherWarps + warp) * g.pieces_per_warp;
  unsigned char* in_buf = smem + warp * g.pieces_per_warp * (g.in_slot + g.out_slot);
  unsigned char* out_buf = in_buf + g.pieces_per_warp * g.in_slot;

  // lane k < pieces_per_warp finds piece first + k (32-bit index math, the
  // only divisions of the kernel); the warp shares them by shuffles
  long long my_src = 0, my_dst = 0;
  int my_len = 0;
  const int q = first + lane;
  if (lane < g.pieces_per_warp && q < rows * g.pieces_per_row) {
    const int row = g.pieces_per_row == 1 ? q : q / g.pieces_per_row;
    const int j0 = (q - row * g.pieces_per_row) * g.piece_len;
    const int i = row / g.py;
    const int jy = row - i * g.py;
    const int* w = g.windows + 4 * p;
    my_src = (long long)w[3] * g.subject_stride +
             (((long long)(w[0] + i) * g.ye + (w[1] + jy)) * g.ze + w[2]) * g.c + j0;
    my_dst = ((long long)p * rows + row) * row_len + j0;
    my_len = min(g.piece_len, row_len - j0);
  }
  const Tin* src[kMaxPiecesPerWarp];
  Tout* dst[kMaxPiecesPerWarp];
  int len[kMaxPiecesPerWarp];
#pragma unroll
  for (int k = 0; k < kMaxPiecesPerWarp; ++k) {
    src[k] = static_cast<const Tin*>(g.vol) + __shfl_sync(0xffffffffu, my_src, k);
    dst[k] = static_cast<Tout*>(g.out) + __shfl_sync(0xffffffffu, my_dst, k);
    len[k] = __shfl_sync(0xffffffffu, my_len, k);  // 0: no piece
  }

  // 1. aligned 16-byte copies of each piece's source span
#pragma unroll
  for (int k = 0; k < kMaxPiecesPerWarp; ++k) {
    if (len[k] == 0) break;
    const uintptr_t s = reinterpret_cast<uintptr_t>(src[k]);
    const uintptr_t a = s & ~uintptr_t(15);
    const int nv = (int)((((s + len[k] * sizeof(Tin) + 15) & ~uintptr_t(15)) - a) >> 4);
    for (int v = lane; v < nv; v += 32)
      cp_async16(in_buf + k * g.in_slot + 16 * v,
                 reinterpret_cast<const void*>(a + 16 * v));
  }
  cp_async_wait_all();
  __syncwarp();

  // 2. convert into the output slot at the output's 16-byte phase
#pragma unroll
  for (int k = 0; k < kMaxPiecesPerWarp; ++k) {
    if (len[k] == 0) break;
    const Tin* in = reinterpret_cast<const Tin*>(
        in_buf + k * g.in_slot + (reinterpret_cast<uintptr_t>(src[k]) & 15));
    Tout* out = reinterpret_cast<Tout*>(
        out_buf + k * g.out_slot + (reinterpret_cast<uintptr_t>(dst[k]) & 15));
    for (int e = lane; e < len[k]; e += 32) out[e] = convert<Tin, Tout>(in[e]);
  }
  __syncwarp();

  // 3. 16-byte stores inside the output span, scalar ones at its ends
#pragma unroll
  for (int k = 0; k < kMaxPiecesPerWarp; ++k) {
    if (len[k] == 0) break;
    const uintptr_t d = reinterpret_cast<uintptr_t>(dst[k]);
    const uintptr_t de = d + len[k] * sizeof(Tout);
    const uintptr_t da = d & ~uintptr_t(15);
    const int nv = (int)((de + 15 - da) >> 4);
    const unsigned char* slot = out_buf + k * g.out_slot;
    for (int v = lane; v < nv; v += 32) {
      const uintptr_t lo = da + 16 * v;
      const uintptr_t hi = lo + 16;
      if (lo >= d && hi <= de) {
        *reinterpret_cast<uint4*>(lo) = *reinterpret_cast<const uint4*>(slot + 16 * v);
      } else {
        for (uintptr_t b = lo < d ? d : lo; b < (hi < de ? hi : de); b += sizeof(Tout))
          *reinterpret_cast<Tout*>(b) = *reinterpret_cast<const Tout*>(slot + (b - da));
      }
    }
  }
}

template <typename Tin, typename Tout>
cudaError_t launch_gather(GatherParams g, int n, cudaStream_t stream) {
  const int row_len = g.pz * g.c;
  const int es = (int)std::max(sizeof(Tin), sizeof(Tout));
  g.piece_len = std::min(row_len, kPieceBytes / es);
  g.pieces_per_row = (row_len + g.piece_len - 1) / g.piece_len;
  g.pieces_per_warp =
      std::clamp(kWarpBytes / (g.piece_len * es), 1, kMaxPiecesPerWarp);
  // a span of L bytes at any 16-byte phase covers at most floor16(L + 30)
  g.in_slot = (g.piece_len * (int)sizeof(Tin) + 31) & ~15;
  g.out_slot = (g.piece_len * (int)sizeof(Tout) + 31) & ~15;
  const size_t smem = (size_t)kGatherWarps * g.pieces_per_warp * (g.in_slot + g.out_slot);
  // piece indices of a patch stay 32-bit
  const long long pieces = (long long)g.px * g.py * g.pieces_per_row;
  const long long per_block = (long long)kGatherWarps * g.pieces_per_warp;
  const long long blocks = (pieces + per_block - 1) / per_block;
  if (blocks * per_block + 32 > 0x7fffffffLL || n > 65535 || smem > 48 * 1024)
    return cudaErrorInvalidValue;
  gather_kernel<Tin, Tout>
      <<<dim3((unsigned)blocks, n), kGatherWarps * 32, smem, stream>>>(g);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_gather_to(int out_dtype, const GatherParams& g, int n,
                             cudaStream_t stream) {
  switch (out_dtype) {
    case kF32:
      return launch_gather<Tin, float>(g, n, stream);
    case kBF16:
      return launch_gather<Tin, __nv_bfloat16>(g, n, stream);
    case kF16:
      return launch_gather<Tin, __half>(g, n, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out (N, px, py, pz, C) = windows of the store vol (S, X, Y, Z, C) at
// windows (N, 4) int32 = (x, y, z, subject), subjects subject_stride
// = X*Y*Z*C elements apart (S = 1 and any stride for one volume), cast
// from in_dtype to out_dtype (dtype codes of common.cuh; uint8 only to
// uint8).  Every extent is at least 1.
int tmt_gather_patches(const void* vol, int in_dtype, const void* windows,
                       int n, void* out, int out_dtype, int ye, int ze, int c,
                       int px, int py, int pz, long long subject_stride,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || c < 1 || px < 1 || py < 1 || pz < 1) return cudaErrorInvalidValue;
  const GatherParams g{vol, static_cast<const int*>(windows), subject_stride, out,
                       ye, ze, c, px, py, pz, 0, 0, 0, 0, 0};
  if (in_dtype == kU8 || out_dtype == kU8)
    return in_dtype == out_dtype ? launch_gather<uint8_t, uint8_t>(g, n, st)
                                 : cudaErrorInvalidValue;
  switch (in_dtype) {
    case kF32:
      return launch_gather_to<float>(out_dtype, g, n, st);
    case kBF16:
      return launch_gather_to<__nv_bfloat16>(out_dtype, g, n, st);
    case kF16:
      return launch_gather_to<__half>(out_dtype, g, n, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
