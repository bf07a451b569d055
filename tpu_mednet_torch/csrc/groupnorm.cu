// GroupNorm forward on Hopper: per-(sample, channel) mean and mul = rstd *
// gamma in one launch, and the fused normalize + affine (+ residual)
// (+ nonlinearity) pass.
//
// Replaces tpu_mednet/ops/pallas/groupnorm.py `lane_moments_pallas` (the
// Pallas kernel that streams an activation once and carries fp32 sums in
// VMEM scratch across a sequential grid) together with the group fold that
// the JAX package left to XLA (ops/packed.py `packed_group_norm_stats`), and
// takes over the epilogue (`packed_group_norm`, flax `nn.GroupNorm` + the
// block's ELU / residual add).
//
// Input: a channels-last 3D activation, physically (N, S, C) with S = D*H*W
// spatial rows of C contiguous channels, bf16 or fp32.
//
// Bound: both kernels move bytes and do a few flops per element, far below
// the card's ~295 flop/byte balance, so memory bandwidth bounds them.
// Moments read the tensor once; apply reads x (and the residual) and writes y.
//
// Design:
//  - Moments (gn_moments_kernel): Hopper blocks run in parallel and in no
//    order, so the TPU's sequential-grid accumulator becomes a (block, n)
//    grid in which each block sums a contiguous range of rows; the grid is
//    sized from the bytes (about two blocks per SM at the largest shapes,
//    at least 64 KB of input per block).  A block's rows are one
//    contiguous span, streamed by the Tensor Memory Accelerator: one
//    producer thread keeps a ring of kStages 16 KB stages in flight with
//    1-D bulk copies that complete on an mbarrier, so a few instructions
//    keep tens of KB per SM in flight.  Consumer threads each own one
//    16-byte channel vector and a row slot, read their vectors from shared
//    memory and accumulate in fp32 registers, then release the stage.  A
//    shape the bulk copy cannot take (C * esize not a multiple of 16, an
//    unaligned base) runs the register path, a strided scalar loop over
//    rows in device memory; the wrapper chooses by shape.
//    The block folds its row slots in shared memory in a fixed order and
//    writes one partial per channel.  The block that draws a sample's last
//    ticket adds the partials in block order, folds channels into groups
//    (flax's fast variance clamped at 0, rsqrt(var + eps), times gamma) and
//    resets the ticket; a sample of one block skips the ticket.  The order
//    of every sum is fixed, so the results are identical from run to run.
//  - Apply: one grid-stride elementwise pass over 16-byte vectors, computing
//    y = (x - mean[n,c]) * mul[n,c] + beta[c] (+ residual) in fp32, then the
//    nonlinearity, rounding once to the input dtype, with the same fp32
//    roundings as the plain version (no FMA contraction).
#include <algorithm>

#include "common.cuh"

using namespace tmt;

namespace {

// kMaxStageBytes and kConsumers must match _STAGE_BYTES and _CONSUMERS in
// ops/groupnorm.py
constexpr int kStages = 4;
constexpr int kMaxStageBytes = 16 * 1024;
constexpr int kConsumers = 256;
constexpr int kBarrierBytes = 128;  // 2 * kStages mbarriers, padded
constexpr int kMaxBulkSmem = kBarrierBytes + kStages * kMaxStageBytes;
constexpr int kApplyThreads = 256;

// -- mbarrier and bulk-copy helpers (PTX) -----------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the completion of the barrier's phase of the given parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// bytes (a multiple of 16) from 16-byte aligned device memory into shared
// memory; completion is counted on bar's transaction count
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -- moments ------------------------------------------------------------------

struct MomentsParams {
  const void* x;         // (N, S, C)
  const float* gamma;    // (C)
  float* part;           // (N, blocks, 2, C) scratch
  int* tickets;          // (>= N), 0 between launches
  float* mean;           // (N, C) out
  float* mul;            // (N, C) out
  long long s;           // rows per sample
  long long rows_per_block;
  int c, groups, stage_rows;
  float eps;
};

template <int V>
__device__ __forceinline__ void accumulate(const float (&v)[V], float (&sum)[V],
                                           float (&sq)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    sum[i] += v[i];
    sq[i] += v[i] * v[i];
  }
}

// blockDim = consumers (+ 32 for the producer warp on the bulk path).
// Consumer thread t sums channel vector t % vecs over the rows of slot
// t / vecs; threads past vecs * row_slots only take part in the barriers.
template <typename T, int V, bool kBulk>
__global__ void gn_moments_kernel(const MomentsParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last_block;
  const int c = p.c;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int consumers = kBulk ? blockDim.x - 32 : blockDim.x;
  const int vecs = c / V;
  const int row_slots = consumers / vecs;
  const int slot = tid / vecs;
  const int cv = tid - slot * vecs;
  const bool active = slot < row_slots;
  const long long row0 = blockIdx.x * p.rows_per_block;
  const long long row1 = min(row0 + p.rows_per_block, p.s);
  const T* xs = static_cast<const T*>(p.x) + (long long)n * p.s * c;

  float sum[V], sq[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sum[i] = sq[i] = 0.f;

  float* red;  // 2 * row_slots * c floats, then the fold's 2 * (c + groups)
  if constexpr (kBulk) {
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + kStages;
    T* ring = reinterpret_cast<T*>(smem + kBarrierBytes);
    red = reinterpret_cast<float*>(smem + kBarrierBytes);
    const int stage_elems = p.stage_rows * c;
    const int stages =
        row1 > row0 ? (int)((row1 - row0 + p.stage_rows - 1) / p.stage_rows) : 0;
    if (tid == 0) {
      for (int st = 0; st < kStages; ++st) {
        mbar_init(&full[st], 1);
        mbar_init(&empty[st], consumers / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid >= consumers) {
      if (tid == consumers) {  // the producer
        for (int k = 0; k < stages; ++k) {
          const int st = k % kStages;
          if (k >= kStages) mbar_wait(&empty[st], ((k / kStages) - 1) & 1);
          const long long r = row0 + (long long)k * p.stage_rows;
          const long long rows = min((long long)p.stage_rows, row1 - r);
          const uint32_t bytes = (uint32_t)(rows * c * sizeof(T));
          mbar_expect_tx(&full[st], bytes);
          bulk_load(ring + st * stage_elems, xs + r * c, bytes, &full[st]);
        }
      }
    } else {
      for (int k = 0; k < stages; ++k) {
        const int st = k % kStages;
        mbar_wait(&full[st], (k / kStages) & 1);
        if (active) {
          const long long r = row0 + (long long)k * p.stage_rows;
          const int rows = (int)min((long long)p.stage_rows, row1 - r);
          const T* buf = ring + st * stage_elems + cv * V;
#pragma unroll 4
          for (int j = slot; j < rows; j += row_slots) {
            float v[V];
            load_vec<T, V>(buf + j * c, v);
            accumulate<V>(v, sum, sq);
          }
        }
        __syncwarp();
        if ((tid & 31) == 0) mbar_arrive(&empty[st]);
      }
    }
    // every issued stage was waited for: the ring is free for the fold
    __syncthreads();
  } else {
    red = reinterpret_cast<float*>(smem);
    if (active) {
      const T* base = xs + cv * V;
#pragma unroll 4
      for (long long row = row0 + slot; row < row1; row += row_slots) {
        float v[V];
        load_vec<T, V>(base + row * c, v);
        accumulate<V>(v, sum, sq);
      }
    }
  }

  // the block's partial: row slots folded in a fixed order, one thread per
  // (sum or sum of squares, channel)
  if (active) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[slot * c + cv * V + i] = sum[i];
      red[(row_slots + slot) * c + cv * V + i] = sq[i];
    }
  }
  __syncthreads();
  // a sample of one block keeps its sums in shared memory
  const bool single = gridDim.x == 1;
  float* tot = red + 2 * row_slots * c;  // (2, c), then mean and rstd per group
  float* part = single ? tot : p.part + ((long long)n * gridDim.x + blockIdx.x) * 2 * c;
  for (int j = tid; j < 2 * c; j += blockDim.x) {
    const float* col = red + (j < c ? j : row_slots * c + j - c);
    float a = 0.f;
    for (int k = 0; k < row_slots; ++k) a += col[k * c];
    part[j] = a;
  }
  if (!single) {
    __threadfence();
    __syncthreads();
    if (tid == 0) last_block = atomicAdd(p.tickets + n, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!last_block) return;
    __threadfence();
    // the sample's last block: partials in block order, read from L2
    const float* part_n = p.part + (long long)n * gridDim.x * 2 * c;
    for (int j = tid; j < 2 * c; j += blockDim.x) {
      float a = 0.f;
      for (int k = 0; k < (int)gridDim.x; ++k) a += __ldcg(part_n + (long long)k * 2 * c + j);
      tot[j] = a;
    }
  }
  __syncthreads();
  // the fold of ops/packed.py packed_group_norm_stats with flax's clamp,
  // each fp32 operation rounded on its own as in the plain version
  const int cg = c / p.groups;
  const float count = (float)(p.s * cg);
  float* g_mean = tot + 2 * c;
  float* g_rstd = g_mean + p.groups;
  for (int g = tid; g < p.groups; g += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < cg; ++j) {
      a += tot[g * cg + j];
      b += tot[c + g * cg + j];
    }
    const float mean = __fdiv_rn(a, count);
    const float var =
        fmaxf(0.f, __fsub_rn(__fdiv_rn(b, count), __fmul_rn(mean, mean)));
    g_mean[g] = mean;
    g_rstd[g] = __frsqrt_rn(__fadd_rn(var, p.eps));
  }
  __syncthreads();
  for (int ch = tid; ch < c; ch += blockDim.x) {
    const int g = ch / cg;
    p.mean[(long long)n * c + ch] = g_mean[g];
    p.mul[(long long)n * c + ch] = __fmul_rn(g_rstd[g], p.gamma[ch]);
  }
  if (tid == 0 && !single) p.tickets[n] = 0;
}

template <typename T, int V, bool kBulk>
cudaError_t launch_moments(const MomentsParams& p, long long n, int blocks,
                           cudaStream_t stream) {
  const int vecs = p.c / V;
  const int consumers = vecs <= kConsumers ? kConsumers : (vecs + 31) / 32 * 32;
  const int row_slots = consumers / vecs;
  size_t smem = 2ull * (row_slots * p.c + p.c + p.groups) * sizeof(float);
  int threads = consumers;
  if constexpr (kBulk) {
    const size_t ring = (size_t)kStages * p.stage_rows * p.c * sizeof(T);
    if (vecs > kConsumers || p.stage_rows < 1 ||
        (size_t)p.stage_rows * p.c * sizeof(T) > kMaxStageBytes)
      return cudaErrorInvalidValue;
    smem = kBarrierBytes + std::max(smem, ring);
    threads += 32;
    // above 48 KB of dynamic shared memory only after opting in, once per
    // device
    static bool attr_set[64] = {};
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    if (dev >= 64) return cudaErrorInvalidDevice;
    if (!attr_set[dev]) {
      err = cudaFuncSetAttribute(gn_moments_kernel<T, V, kBulk>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxBulkSmem);
      if (err != cudaSuccess) return err;
      attr_set[dev] = true;
    }
  }
  if (threads > 1024 || smem > (kBulk ? kMaxBulkSmem : 48 * 1024))
    return cudaErrorInvalidValue;
  gn_moments_kernel<T, V, kBulk>
      <<<dim3(blocks, (unsigned)n), threads, smem, stream>>>(p);
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

// Per-(n, c) fp32 mean and mul = rstd * gamma of x (N, S, C), C channels in
// `groups` groups, into mean/mul (N, C).  blocks * rows_per_block >= S rows
// per sample; part is (N, blocks, 2, C) fp32 scratch and tickets (>= N)
// int32 zeros, left zero again.  bulk != 0 streams rows with bulk copies in
// stages of stage_rows rows (x 16-byte aligned, C * esize a multiple of 16).
int tmt_gn_moments(const void* x, int dtype, long long n, long long s, int c,
                   int groups, const void* gamma, float eps, int blocks,
                   long long rows_per_block, int bulk, int stage_rows,
                   void* part, void* tickets, void* mean, void* mul,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 65535 || c < 1 || groups < 1 || c % groups || blocks < 1 ||
      (long long)blocks * rows_per_block < s)
    return cudaErrorInvalidValue;
  MomentsParams p{x, static_cast<const float*>(gamma), static_cast<float*>(part),
                  static_cast<int*>(tickets), static_cast<float*>(mean),
                  static_cast<float*>(mul), s, rows_per_block, c, groups,
                  stage_rows, eps};
  if (dtype == kBF16) {
    if (!bulk) return launch_moments<__nv_bfloat16, 1, false>(p, n, blocks, st);
    if (!aligned16(x) || c % 8) return cudaErrorInvalidValue;
    return launch_moments<__nv_bfloat16, 8, true>(p, n, blocks, st);
  }
  if (dtype == kF32) {
    if (!bulk) return launch_moments<float, 1, false>(p, n, blocks, st);
    if (!aligned16(x) || c % 4) return cudaErrorInvalidValue;
    return launch_moments<float, 4, true>(p, n, blocks, st);
  }
  return cudaErrorInvalidValue;
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
