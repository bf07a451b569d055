// Batched window gather on Hopper: N patches cut from one channels-last
// volume at int32 corners, with the output dtype cast fused in.
//
// Replaces tpu_mednet/ops/pallas/patches.py `extract_patches_pallas` (one
// DMA per patch with scalar-prefetched corners; the same gather is inlined
// in tpu_mednet/inference/device_sliding.py as a vmap'd dynamic_slice).
//
// Bound: pure data movement, N*px*py*pz*C elements read and written once
// (8 x 96^3 f16 in, bf16 out is ~28 MB, ~8 us at 3.35 TB/s), so memory
// bandwidth and the launch itself bound it.
//
// Design: scalar prefetch becomes each block loading its patch's corner
// itself.  A patch is px*py rows of pz*C contiguous elements in both the
// volume and the output; grid (row groups, patch), and the threads of a
// block walk a group of rows element by element, so neighbouring threads
// touch neighbouring addresses on both sides.  Corners are not 16-byte
// aligned in general, so accesses are scalar.  The per-element index math
// is 32-bit.  Corners are validated to be
// in bounds by the Python wrapper before the launch.
#include <algorithm>

#include "common.cuh"

using namespace tmt;

namespace {

constexpr int kGatherThreads = 256;
constexpr int kElementsPerBlock = 1024;

template <typename Tin, typename Tout>
__global__ void gather_kernel(const Tin* __restrict__ vol,
                              const int* __restrict__ corners,
                              Tout* __restrict__ out, int ye, int ze, int c,
                              int px, int py, int pz, int rows_per_block) {
  const int p = blockIdx.y;
  const int x0 = corners[3 * p];
  const int y0 = corners[3 * p + 1];
  const int z0 = corners[3 * p + 2];
  const int row_len = pz * c;
  const int rows = px * py;
  const int row_begin = blockIdx.x * rows_per_block;
  const int row_end = min(rows, row_begin + rows_per_block);
  const int count = (row_end - row_begin) * row_len;
  // 64-bit only in the per-block bases and the row offset; the per-element
  // index math is 32-bit (the wrapper keeps a block's span below 2^31)
  Tout* dst = out + ((long long)p * rows + row_begin) * row_len;
  for (int k = threadIdx.x; k < count; k += blockDim.x) {
    const int r = k / row_len;
    const int j = k - r * row_len;
    const int row = row_begin + r;
    const int i = row / py;
    const int jy = row - i * py;
    const long long src =
        (((long long)(x0 + i) * ye + (y0 + jy)) * ze + z0) * c + j;
    dst[k] = from_float<Tout>(to_float(vol[src]));
  }
}

template <typename Tin, typename Tout>
cudaError_t launch_gather(const void* vol, const int* corners, int n, void* out,
                          int ye, int ze, int c, int px, int py, int pz,
                          cudaStream_t stream) {
  const int row_len = pz * c;
  const int rows_per_block = std::max(1, kElementsPerBlock / row_len);
  const int rows = px * py;
  const dim3 grid((rows + rows_per_block - 1) / rows_per_block, n);
  gather_kernel<Tin, Tout><<<grid, kGatherThreads, 0, stream>>>(
      static_cast<const Tin*>(vol), corners, static_cast<Tout*>(out), ye, ze,
      c, px, py, pz, rows_per_block);
  return cudaGetLastError();
}

template <typename Tin>
cudaError_t launch_gather_to(int out_dtype, const void* vol, const int* corners,
                             int n, void* out, int ye, int ze, int c, int px,
                             int py, int pz, cudaStream_t stream) {
  switch (out_dtype) {
    case kF32:
      return launch_gather<Tin, float>(vol, corners, n, out, ye, ze, c, px, py, pz, stream);
    case kBF16:
      return launch_gather<Tin, __nv_bfloat16>(vol, corners, n, out, ye, ze, c, px, py, pz, stream);
    case kF16:
      return launch_gather<Tin, __half>(vol, corners, n, out, ye, ze, c, px, py, pz, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out (N, px, py, pz, C) = vol (X, Y, Z, C) windows at corners (N, 3) int32,
// cast from in_dtype to out_dtype (dtype codes of common.cuh).
int tmt_gather_patches(const void* vol, int in_dtype, const void* corners,
                       int n, void* out, int out_dtype, int ye, int ze, int c,
                       int px, int py, int pz, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* cr = static_cast<const int*>(corners);
  switch (in_dtype) {
    case kF32:
      return launch_gather_to<float>(out_dtype, vol, cr, n, out, ye, ze, c, px, py, pz, st);
    case kBF16:
      return launch_gather_to<__nv_bfloat16>(out_dtype, vol, cr, n, out, ye, ze, c, px, py, pz, st);
    case kF16:
      return launch_gather_to<__half>(out_dtype, vol, cr, n, out, ye, ze, c, px, py, pz, st);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
