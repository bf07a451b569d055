// GroupNorm forward on Hopper: per-(sample, channel) moments and the fused
// normalize + affine (+ residual) (+ nonlinearity) pass.
//
// Replaces tpu_mednet/ops/pallas/groupnorm.py `lane_moments_pallas` (the
// Pallas kernel that streams an activation once and carries fp32 sums in
// VMEM scratch across a sequential grid), and takes over the epilogue that
// the JAX package left to XLA (ops/packed.py `packed_group_norm`, flax
// `nn.GroupNorm` + the block's ELU / residual add).
//
// Input: a channels-last 3D activation, physically (N, S, C) with S = D*H*W
// spatial rows of C contiguous channels, bf16 or fp32.
//
// Bound: both kernels move bytes and do a few flops per element, far below
// the card's ~295 flop/byte balance, so memory bandwidth bounds them.
// Stats reads the tensor once; apply reads x (and the residual) and writes y.
//
// Design:
//  - Stats: Hopper blocks run in parallel and in no order, so the TPU's
//    sequential-grid accumulator becomes a (chunk, n) grid of blocks that
//    each sum a contiguous range of rows.  A thread owns one 16-byte vector
//    of channels and walks rows with a stride, so a warp reads contiguous
//    memory.  Per-thread register sums are reduced across the block's row
//    slots in shared memory in a fixed order and written as per-block
//    partials; gn_combine_kernel then adds the partials in chunk order.
//    No atomics: the statistics are identical from run to run.
//  - Apply: one grid-stride elementwise pass over 16-byte vectors, computing
//    y = (x - mean[n,c]) * mul[n,c] + beta[c] (+ residual) in fp32, then the
//    nonlinearity, rounding once to the input dtype.  mean and mul = rstd *
//    gamma are per-(n, c) fp32 arrays folded from the stats on the host side
//    (tiny (N, C) torch ops), exactly flax's normalize arithmetic, with the
//    same fp32 roundings as the plain version (no FMA contraction).
#include <algorithm>

#include "common.cuh"

using namespace tmt;

namespace {

constexpr int kStatsThreads = 256;
constexpr int kApplyThreads = 256;

template <typename T, int V>
__global__ void gn_stats_kernel(const T* __restrict__ x, long long s, int c,
                                long long rows_per_chunk,
                                float* __restrict__ part_sum,
                                float* __restrict__ part_sq) {
  const int vecs = c / V;                 // channel vectors in a row
  const int row_slots = blockDim.x / vecs;  // rows read at once by the block
  const int cv = threadIdx.x % vecs;
  const int slot = threadIdx.x / vecs;
  const int chunk = blockIdx.x;
  const int n = blockIdx.y;

  const long long row0 = chunk * rows_per_chunk;
  const long long row1 = row0 + rows_per_chunk < s ? row0 + rows_per_chunk : s;
  const T* base = x + (long long)n * s * c + (long long)cv * V;

  float sum[V], sq[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sum[i] = sq[i] = 0.f;
#pragma unroll 4
  for (long long row = row0 + slot; row < row1; row += row_slots) {
    float v[V];
    load_vec<T, V>(base + row * c, v);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      sum[i] += v[i];
      sq[i] += v[i] * v[i];
    }
  }

  extern __shared__ float smem[];
  float* s_sum = smem;
  float* s_sq = smem + row_slots * c;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    s_sum[slot * c + cv * V + i] = sum[i];
    s_sq[slot * c + cv * V + i] = sq[i];
  }
  __syncthreads();

  float* ps = part_sum + ((long long)n * gridDim.x + chunk) * c;
  float* pq = part_sq + ((long long)n * gridDim.x + chunk) * c;
  for (int ch = threadIdx.x; ch < c; ch += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int k = 0; k < row_slots; ++k) {
      a += s_sum[k * c + ch];
      b += s_sq[k * c + ch];
    }
    ps[ch] = a;
    pq[ch] = b;
  }
}

__global__ void gn_combine_kernel(const float* __restrict__ part_sum,
                                  const float* __restrict__ part_sq, int chunks,
                                  int c, float* __restrict__ sum,
                                  float* __restrict__ sq) {
  const int n = blockIdx.y;
  const int ch = blockIdx.x * blockDim.x + threadIdx.x;
  if (ch >= c) return;
  const float* ps = part_sum + (long long)n * chunks * c + ch;
  const float* pq = part_sq + (long long)n * chunks * c + ch;
  float a = 0.f, b = 0.f;
  for (int k = 0; k < chunks; ++k) {
    a += ps[(long long)k * c];
    b += pq[(long long)k * c];
  }
  sum[(long long)n * c + ch] = a;
  sq[(long long)n * c + ch] = b;
}

template <typename T, int V>
cudaError_t launch_stats(const void* x, long long n, long long s, int c,
                         int chunks, long long rows_per_chunk, float* part_sum,
                         float* part_sq, cudaStream_t stream) {
  const int vecs = c / V;
  if (vecs > 1024) return cudaErrorInvalidValue;
  const int threads = vecs * std::max(1, kStatsThreads / vecs);
  const size_t smem = 2ull * (threads / vecs) * c * sizeof(float);
  if (smem > 48 * 1024) return cudaErrorInvalidValue;
  gn_stats_kernel<T, V><<<dim3(chunks, n), threads, smem, stream>>>(
      static_cast<const T*>(x), s, c, rows_per_chunk, part_sum, part_sq);
  return cudaGetLastError();
}

__device__ __forceinline__ float activate(float t, int act, float slope) {
  switch (act) {
    case 1:  // ReLU
      return t < 0.f ? 0.f : t;
    case 2:  // LeakyReLU
      return t >= 0.f ? t : t * slope;
    case 3:  // ELU (alpha 1)
      return t > 0.f ? t : expm1f(t);
    default:
      return t;
  }
}

template <typename T, int V, bool kResidual>
__global__ void gn_apply_kernel(const T* __restrict__ x,
                                const T* __restrict__ residual,
                                T* __restrict__ y,
                                const float* __restrict__ mean,
                                const float* __restrict__ mul,
                                const float* __restrict__ beta,
                                long long per_sample, int c, long long vecs,
                                int act, float slope) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < vecs; i += stride) {
    const long long e = i * V;
    const long long n = e / per_sample;
    const int c0 = (int)(e % c);  // C % V == 0: the vector stays in one row
    const float* mn = mean + n * c + c0;
    const float* ml = mul + n * c + c0;
    float v[V];
    load_vec<T, V>(x + e, v);
    float r[V];
    if constexpr (kResidual) load_vec<T, V>(residual + e, r);
    // explicit round-to-nearest ops, never contracted into an FMA: the
    // same fp32 roundings as the plain version, so the one rounding to the
    // input dtype differs from it by at most an ulp even where the terms
    // cancel
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float t = __fadd_rn(__fmul_rn(__fsub_rn(v[k], mn[k]), ml[k]), beta[c0 + k]);
      if constexpr (kResidual) t = __fadd_rn(t, r[k]);
      v[k] = activate(t, act, slope);
    }
    store_vec<T, V>(y + e, v);
  }
}

template <typename T, int V>
cudaError_t launch_apply(const void* x, const void* residual, void* y,
                         const float* mean, const float* mul, const float* beta,
                         long long n, long long s, int c, int act, float slope,
                         cudaStream_t stream) {
  const long long vecs = n * s * c / V;
  const long long blocks =
      std::min((vecs + kApplyThreads - 1) / kApplyThreads, 1LL << 30);
  if (residual != nullptr) {
    gn_apply_kernel<T, V, true><<<(unsigned)blocks, kApplyThreads, 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(residual),
        static_cast<T*>(y), mean, mul, beta, s * c, c, vecs, act, slope);
  } else {
    gn_apply_kernel<T, V, false><<<(unsigned)blocks, kApplyThreads, 0, stream>>>(
        static_cast<const T*>(x), nullptr, static_cast<T*>(y), mean, mul, beta,
        s * c, c, vecs, act, slope);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Per-(n, c) fp32 sum and sum of squares of x (N, S, C) into sum/sq (N, C).
// part_sum/part_sq are (N, chunks, C) fp32 scratch; chunk k covers rows
// [k * rows_per_chunk, (k + 1) * rows_per_chunk).
int tmt_gn_stats(const void* x, int dtype, long long n, long long s, int c,
                 int chunks, long long rows_per_chunk, void* part_sum,
                 void* part_sq, void* sum, void* sq, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ps = static_cast<float*>(part_sum);
  float* pq = static_cast<float*>(part_sq);
  const bool vec = aligned16(x);
  cudaError_t err;
  if (dtype == kBF16) {
    err = (vec && c % 8 == 0)
              ? launch_stats<__nv_bfloat16, 8>(x, n, s, c, chunks, rows_per_chunk, ps, pq, st)
              : launch_stats<__nv_bfloat16, 1>(x, n, s, c, chunks, rows_per_chunk, ps, pq, st);
  } else if (dtype == kF32) {
    err = (vec && c % 4 == 0)
              ? launch_stats<float, 4>(x, n, s, c, chunks, rows_per_chunk, ps, pq, st)
              : launch_stats<float, 1>(x, n, s, c, chunks, rows_per_chunk, ps, pq, st);
  } else {
    return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  gn_combine_kernel<<<dim3((c + 127) / 128, n), 128, 0, st>>>(
      ps, pq, chunks, c, static_cast<float*>(sum), static_cast<float*>(sq));
  return cudaGetLastError();
}

// y = act((x - mean[n,c]) * mul[n,c] + beta[c] (+ residual)), x/residual/y
// (N, S, C) of one dtype, mean/mul (N, C) and beta (C) fp32.
// act: 0 none, 1 ReLU, 2 LeakyReLU(slope), 3 ELU.  residual may be null.
int tmt_gn_apply(const void* x, const void* residual, void* y, const void* mean,
                 const void* mul, const void* beta, int dtype, long long n,
                 long long s, int c, int act, float slope, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* mn = static_cast<const float*>(mean);
  const float* ml = static_cast<const float*>(mul);
  const float* bt = static_cast<const float*>(beta);
  const bool vec = aligned16(x) && aligned16(y) &&
                   (residual == nullptr || aligned16(residual));
  if (dtype == kBF16) {
    return (vec && c % 8 == 0)
               ? launch_apply<__nv_bfloat16, 8>(x, residual, y, mn, ml, bt, n, s, c, act, slope, st)
               : launch_apply<__nv_bfloat16, 1>(x, residual, y, mn, ml, bt, n, s, c, act, slope, st);
  }
  if (dtype == kF32) {
    return (vec && c % 4 == 0)
               ? launch_apply<float, 4>(x, residual, y, mn, ml, bt, n, s, c, act, slope, st)
               : launch_apply<float, 1>(x, residual, y, mn, ml, bt, n, s, c, act, slope, st);
  }
  return cudaErrorInvalidValue;
}

const char* tmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
