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
// The backward (gn_bwd_reduce_kernel, gn_bwd_apply_kernel) replaces the
// custom VJP of `lane_moments` (tpu_mednet/ops/pallas/groupnorm.py:149-175,
// dx = g_s + 2 x g_q) together with XLA's autodiff of the normalize chain.
//
// Input: a channels-last 3D activation, physically (N, S, C) with S = D*H*W
// spatial rows of C contiguous channels, bf16 or fp32.
//
// Bound: all four kernels move bytes and do a few flops per element, far
// below the card's ~295 flop/byte balance, so memory bandwidth bounds them.
// Moments read the tensor once; apply reads x (and the residual) and writes
// y; the backward's reduce reads x and dy (and the residual), its apply
// reads them again and writes dx (and the residual's gradient).
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
//    ticket adds the partials in block order and resets the ticket
//    (sample_sums, shared with the backward's reduce), then folds channels
//    into groups (flax's fast variance clamped at 0, rsqrt(var + eps),
//    times gamma); a sample of one block skips the ticket.  The order of
//    every sum is fixed, so the results are identical from run to run.
//  - Apply: one grid-stride elementwise pass over 16-byte vectors, computing
//    y = (x - mean[n,c]) * mul[n,c] + beta[c] (+ residual) in fp32, then the
//    nonlinearity, rounding once to the input dtype, with the same fp32
//    roundings as the plain version (no FMA contraction).
//  - Backward: z is recomputed from x (and the residual) and the saved
//    per-(n, c) mean and rstd instead of being stored, with the forward's
//    roundings, so act' (ReLU/LeakyReLU by the sign of z, ELU exp(z)) sees
//    the forward's z.  With xhat = (x - mean) * rstd and dz = dy * act'(z):
//      A = sum_s dz,  B = sum_s dz * xhat       (per (n, c); dbeta, dgamma
//                                                 are their sums over n)
//      dx = rstd*gamma*dz - rstd/M * sum_g gamma*A - (x - mean)*rstd^2/M * sum_g gamma*B
//    The reduce is gn_moments_kernel's register path over x and dy with
//    its own tickets and the same sample_sums: fixed-order partials, and
//    the last block of a sample folds its groups into dx's two
//    coefficients, so two calls are bitwise equal.  Its threads hold about 100 registers (two blocks per
//    SM), so its grid is planned for several waves, not one, and B is
//    summed as dz * (x - mean) and scaled by rstd once per partial.  The
//    apply is one elementwise pass of 16-byte vectors that writes dx and,
//    for a residual, its gradient dz.
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
  float* rstd;           // (N, C) out: the backward needs it where gamma is 0
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

// The cross-block sum of gn_moments_kernel and gn_bwd_reduce_kernel: its
// fixed order is what makes both deterministic.  Called by every thread of
// the block after a __syncthreads, with red holding two sums per channel
// for each of row_slots row slots (slot k's at red[k * c + ch] and
// red[(row_slots + k) * c + ch]).  The block folds its slots in a fixed
// order into its partial, one thread per (sum, channel).  A sample of
// several blocks writes the partials to part (N, blocks, 2, c) and draws
// the sample's ticket; the block that draws the last one adds the partials
// in block order, read from L2, and leaves the ticket 0 for the next
// launch.  Returns false in every other block; in the one that goes on,
// tot = red + 2 * row_slots * c holds the sample's (2, c) sums.
__device__ __forceinline__ bool sample_sums(float* red, int row_slots, int c,
                                            float* part, int* tickets) {
  __shared__ int last_block;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  // a sample of one block keeps its sums in shared memory
  const bool single = gridDim.x == 1;
  float* tot = red + 2 * row_slots * c;
  float* mine = single ? tot : part + ((long long)n * gridDim.x + blockIdx.x) * 2 * c;
  for (int j = tid; j < 2 * c; j += blockDim.x) {
    const float* col = red + (j < c ? j : row_slots * c + j - c);
    float a = 0.f;
    for (int k = 0; k < row_slots; ++k) a += col[k * c];
    mine[j] = a;
  }
  if (!single) {
    __threadfence();
    __syncthreads();
    if (tid == 0) last_block = atomicAdd(tickets + n, 1) == (int)gridDim.x - 1;
    __syncthreads();
    if (!last_block) return false;
    __threadfence();
    const float* part_n = part + (long long)n * gridDim.x * 2 * c;
    for (int j = tid; j < 2 * c; j += blockDim.x) {
      float a = 0.f;
      for (int k = 0; k < (int)gridDim.x; ++k) a += __ldcg(part_n + (long long)k * 2 * c + j);
      tot[j] = a;
    }
    // every block of the sample has drawn
    if (tid == 0) tickets[n] = 0;
  }
  __syncthreads();
  return true;
}

// blockDim = consumers (+ 32 for the producer warp on the bulk path).
// Consumer thread t sums channel vector t % vecs over the rows of slot
// t / vecs; threads past vecs * row_slots only take part in the barriers.
template <typename T, int V, bool kBulk>
__global__ void gn_moments_kernel(const MomentsParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
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
  if (!sample_sums(red, row_slots, c, p.part, p.tickets)) return;
  float* tot = red + 2 * row_slots * c;  // (2, c), then mean and rstd per group
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
    p.rstd[(long long)n * c + ch] = g_rstd[g];
  }
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

// -- backward -----------------------------------------------------------------

__device__ __forceinline__ float activate_grad(float t, int act, float slope) {
  switch (act) {
    case 1:  // ReLU
      return t > 0.f ? 1.f : 0.f;
    case 2:  // LeakyReLU
      return t > 0.f ? 1.f : slope;
    case 3:  // ELU (alpha 1): d expm1(t) / dt = exp(t)
      return t > 0.f ? 1.f : expf(t);
    default:
      return 1.f;
  }
}

// dz = dy * act'(z) of one element, z = xm * mul + beta (+ r) with
// xm = x - mean, rounded as gn_apply_kernel rounds the forward, so act' is
// taken on the sign the forward saw.
template <bool kResidual>
__device__ __forceinline__ float grad_z(float xm, float dy, float r, float mul,
                                        float beta, int act, float slope) {
  float t = __fadd_rn(__fmul_rn(xm, mul), beta);
  if constexpr (kResidual) t = __fadd_rn(t, r);
  return __fmul_rn(dy, activate_grad(t, act, slope));
}

struct BwdParams {
  const void* x;         // (N, S, C) GroupNorm input
  const void* dy;        // (N, S, C) gradient of the output
  const void* r;         // (N, S, C) residual, or null
  const float* mean;     // (N, C)
  const float* rstd;     // (N, C)
  const float* gamma;    // (C)
  const float* beta;     // (C)
  float* part;           // (N, blocks, 2, C) scratch
  int* tickets;          // (>= N), 0 between launches
  float* out;            // (4, N, C) out: A, B, coeff_b, coeff_c
  long long n;
  long long s;           // rows per sample
  long long rows_per_block;
  int c, groups, act;
  float slope;
};

// blockDim = consumer threads; thread t owns channel vector t % vecs in row
// slot t / vecs, as in gn_moments_kernel's register path.  A_nc = sum dz and
// B_nc = sum dz * xhat over the block's rows, summed across blocks by
// sample_sums; the sample's last block folds groups into dx's coefficients.
template <typename T, int V, bool kResidual>
__global__ void gn_bwd_reduce_kernel(const BwdParams p) {
  extern __shared__ __align__(16) float red[];
  const int c = p.c;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int vecs = c / V;
  const int row_slots = blockDim.x / vecs;
  const int slot = tid / vecs;
  const int cv = tid - slot * vecs;
  const bool active = slot < row_slots;
  const long long row0 = blockIdx.x * p.rows_per_block;
  const long long row1 = min(row0 + p.rows_per_block, p.s);
  const long long base = (long long)n * p.s * c + cv * V;
  const T* xs = static_cast<const T*>(p.x) + base;
  const T* gs = static_cast<const T*>(p.dy) + base;
  const T* rs = kResidual ? static_cast<const T*>(p.r) + base : nullptr;

  // sb sums dz * (x - mean); times rstd once, for the block's partial
  float sa[V], sb[V], mn[V], ml[V], bt[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const int ch = cv * V + i;
    mn[i] = p.mean[(long long)n * c + ch];
    ml[i] = __fmul_rn(p.rstd[(long long)n * c + ch], p.gamma[ch]);
    bt[i] = p.beta[ch];
    sa[i] = sb[i] = 0.f;
  }
  if (active) {
#pragma unroll 2
    for (long long row = row0 + slot; row < row1; row += row_slots) {
      float v[V], g[V], r[V];
      load_vec<T, V>(xs + row * c, v);
      load_vec<T, V>(gs + row * c, g);
      if constexpr (kResidual) load_vec<T, V>(rs + row * c, r);
#pragma unroll
      for (int i = 0; i < V; ++i) {
        const float xm = __fsub_rn(v[i], mn[i]);
        const float dz = grad_z<kResidual>(xm, g[i], kResidual ? r[i] : 0.f, ml[i],
                                           bt[i], p.act, p.slope);
        sa[i] += dz;
        sb[i] += dz * xm;
      }
    }
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[slot * c + cv * V + i] = sa[i];
      red[(row_slots + slot) * c + cv * V + i] =
          sb[i] * p.rstd[(long long)n * c + cv * V + i];
    }
  }
  __syncthreads();
  if (!sample_sums(red, row_slots, c, p.part, p.tickets)) return;
  float* tot = red + 2 * row_slots * c;  // (2, c), then (gamma A, gamma B) per group
  // per group: sum of gamma * A and of gamma * B over its channels, then
  // dx = mul * dz + coeff_b * (x - mean) + coeff_c with
  // coeff_b = -rstd^2 * sum(gamma B) / M and coeff_c = -rstd * sum(gamma A) / M
  const int cg = c / p.groups;
  const float count = (float)(p.s * cg);
  float* g_a = tot + 2 * c;
  float* g_b = g_a + p.groups;
  for (int g = tid; g < p.groups; g += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < cg; ++j) {
      const int ch = g * cg + j;
      a = __fadd_rn(a, __fmul_rn(p.gamma[ch], tot[ch]));
      b = __fadd_rn(b, __fmul_rn(p.gamma[ch], tot[c + ch]));
    }
    g_a[g] = a;
    g_b[g] = b;
  }
  __syncthreads();
  const long long nc = p.n * c;
  for (int ch = tid; ch < c; ch += blockDim.x) {
    const int g = ch / cg;
    const long long i = (long long)n * c + ch;
    const float r = p.rstd[i];
    p.out[i] = tot[ch];
    p.out[nc + i] = tot[c + ch];
    p.out[2 * nc + i] = -__fdiv_rn(__fmul_rn(__fmul_rn(r, r), g_b[g]), count);
    p.out[3 * nc + i] = -__fdiv_rn(__fmul_rn(r, g_a[g]), count);
  }
}

template <typename T, int V, bool kResidual>
cudaError_t launch_bwd_reduce(const BwdParams& p, int blocks, cudaStream_t stream) {
  const int vecs = p.c / V;
  const int threads = vecs <= kConsumers ? kConsumers : (vecs + 31) / 32 * 32;
  const int row_slots = threads / vecs;
  const size_t smem = 2ull * (row_slots * p.c + p.c + p.groups) * sizeof(float);
  if (threads > 1024 || smem > 48 * 1024) return cudaErrorInvalidValue;
  gn_bwd_reduce_kernel<T, V, kResidual>
      <<<dim3(blocks, (unsigned)p.n), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t launch_bwd_reduce_any(const BwdParams& p, int blocks, cudaStream_t stream) {
  return p.r != nullptr ? launch_bwd_reduce<T, V, true>(p, blocks, stream)
                        : launch_bwd_reduce<T, V, false>(p, blocks, stream);
}

// Elementwise: dx = mul * dz + coeff_b * (x - mean) + coeff_c, and
// dr = dz where the forward added a residual; every fp32 operation rounded
// on its own, as in the plain version.
template <typename T, int V, bool kResidual>
__global__ void gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                                    const T* __restrict__ residual, T* __restrict__ dx,
                                    T* __restrict__ dr, const float* __restrict__ mean,
                                    const float* __restrict__ rstd,
                                    const float* __restrict__ gamma,
                                    const float* __restrict__ beta,
                                    const float* __restrict__ coef, long long nc,
                                    long long per_sample, int c, long long vecs, int act,
                                    float slope) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < vecs;
       i += stride) {
    const long long e = i * V;
    const long long n = e / per_sample;
    const int c0 = (int)(e % c);  // C % V == 0: the vector stays in one row
    const long long k0 = n * c + c0;
    float v[V], g[V], r[V];
    load_vec<T, V>(x + e, v);
    load_vec<T, V>(dy + e, g);
    if constexpr (kResidual) load_vec<T, V>(residual + e, r);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xm = __fsub_rn(v[k], mean[k0 + k]);
      const float ml = __fmul_rn(rstd[k0 + k], gamma[c0 + k]);
      const float dz = grad_z<kResidual>(xm, g[k], kResidual ? r[k] : 0.f, ml,
                                         beta[c0 + k], act, slope);
      v[k] = __fadd_rn(__fadd_rn(__fmul_rn(ml, dz), __fmul_rn(coef[2 * nc + k0 + k], xm)),
                       coef[3 * nc + k0 + k]);
      if constexpr (kResidual) r[k] = dz;
    }
    store_vec<T, V>(dx + e, v);
    if constexpr (kResidual) store_vec<T, V>(dr + e, r);
  }
}

template <typename T, int V>
cudaError_t launch_bwd_apply(const void* x, const void* dy, const void* residual, void* dx,
                             void* dr, const float* mean, const float* rstd,
                             const float* gamma, const float* beta, const float* coef,
                             long long n, long long s, int c, int act, float slope,
                             cudaStream_t stream) {
  const long long vecs = n * s * c / V;
  const long long blocks =
      std::min((vecs + kApplyThreads - 1) / kApplyThreads, 1LL << 30);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  if (residual != nullptr) {
    gn_bwd_apply_kernel<T, V, true><<<(unsigned)blocks, kApplyThreads, 0, stream>>>(
        xt, gt, static_cast<const T*>(residual), static_cast<T*>(dx), static_cast<T*>(dr),
        mean, rstd, gamma, beta, coef, n * c, s * c, c, vecs, act, slope);
  } else {
    gn_bwd_apply_kernel<T, V, false><<<(unsigned)blocks, kApplyThreads, 0, stream>>>(
        xt, gt, nullptr, static_cast<T*>(dx), nullptr, mean, rstd, gamma, beta, coef,
        n * c, s * c, c, vecs, act, slope);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Per-(n, c) fp32 mean, mul = rstd * gamma and rstd of x (N, S, C), C
// channels in `groups` groups, into mean/mul/rstd (N, C).  blocks * rows_per_block >= S rows
// per sample; part is (N, blocks, 2, C) fp32 scratch and tickets (>= N)
// int32 zeros, left zero again.  bulk != 0 streams rows with bulk copies in
// stages of stage_rows rows (x 16-byte aligned, C * esize a multiple of 16).
int tmt_gn_moments(const void* x, int dtype, long long n, long long s, int c,
                   int groups, const void* gamma, float eps, int blocks,
                   long long rows_per_block, int bulk, int stage_rows,
                   void* part, void* tickets, void* mean, void* mul,
                   void* rstd, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 65535 || c < 1 || groups < 1 || c % groups || blocks < 1 ||
      (long long)blocks * rows_per_block < s)
    return cudaErrorInvalidValue;
  MomentsParams p{x, static_cast<const float*>(gamma), static_cast<float*>(part),
                  static_cast<int*>(tickets), static_cast<float*>(mean),
                  static_cast<float*>(mul), static_cast<float*>(rstd), s,
                  rows_per_block, c, groups, stage_rows, eps};
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

// GroupNorm backward, pass 1: from x, dy (and the residual) of (N, S, C)
// and the forward's per-(n, c) mean and rstd, out (4, N, C) fp32 =
// A = sum dz, B = sum dz * xhat, and dx's coefficients coeff_b, coeff_c
// (see gn_bwd_reduce_kernel).  act as in tmt_gn_apply; residual may be null.
// part is (N, blocks, 2, C) fp32 scratch, tickets (>= N) int32 zeros, left
// zero again.
int tmt_gn_bwd_reduce(const void* x, const void* dy, const void* residual, int dtype,
                      long long n, long long s, int c, int groups, const void* mean,
                      const void* rstd, const void* gamma, const void* beta, int act,
                      float slope, int blocks, long long rows_per_block, void* part,
                      void* tickets, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 65535 || c < 1 || groups < 1 || c % groups || blocks < 1 ||
      (long long)blocks * rows_per_block < s)
    return cudaErrorInvalidValue;
  const BwdParams p{x, dy, residual, static_cast<const float*>(mean),
                    static_cast<const float*>(rstd), static_cast<const float*>(gamma),
                    static_cast<const float*>(beta), static_cast<float*>(part),
                    static_cast<int*>(tickets), static_cast<float*>(out), n, s,
                    rows_per_block, c, groups, act, slope};
  const bool vec = aligned16(x) && aligned16(dy) &&
                   (residual == nullptr || aligned16(residual));
  if (dtype == kBF16) {
    return (vec && c % 8 == 0) ? launch_bwd_reduce_any<__nv_bfloat16, 8>(p, blocks, st)
                               : launch_bwd_reduce_any<__nv_bfloat16, 1>(p, blocks, st);
  }
  if (dtype == kF32) {
    return (vec && c % 4 == 0) ? launch_bwd_reduce_any<float, 4>(p, blocks, st)
                               : launch_bwd_reduce_any<float, 1>(p, blocks, st);
  }
  return cudaErrorInvalidValue;
}

// GroupNorm backward, pass 2: dx (and dr = dz where residual is not null),
// (N, S, C) in x's dtype, from coef = tmt_gn_bwd_reduce's out.
int tmt_gn_bwd_apply(const void* x, const void* dy, const void* residual, void* dx,
                     void* dr, int dtype, long long n, long long s, int c,
                     const void* mean, const void* rstd, const void* gamma,
                     const void* beta, const void* coef, int act, float slope,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || c < 1 || (residual == nullptr) != (dr == nullptr))
    return cudaErrorInvalidValue;
  const float* mn = static_cast<const float*>(mean);
  const float* rs = static_cast<const float*>(rstd);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  const float* cf = static_cast<const float*>(coef);
  const bool vec = aligned16(x) && aligned16(dy) && aligned16(dx) &&
                   (residual == nullptr || (aligned16(residual) && aligned16(dr)));
  if (dtype == kBF16) {
    return (vec && c % 8 == 0)
               ? launch_bwd_apply<__nv_bfloat16, 8>(x, dy, residual, dx, dr, mn, rs, gm, bt, cf, n, s, c, act, slope, st)
               : launch_bwd_apply<__nv_bfloat16, 1>(x, dy, residual, dx, dr, mn, rs, gm, bt, cf, n, s, c, act, slope, st);
  }
  if (dtype == kF32) {
    return (vec && c % 4 == 0)
               ? launch_bwd_apply<float, 4>(x, dy, residual, dx, dr, mn, rs, gm, bt, cf, n, s, c, act, slope, st)
               : launch_bwd_apply<float, 1>(x, dy, residual, dx, dr, mn, rs, gm, bt, cf, n, s, c, act, slope, st);
  }
  return cudaErrorInvalidValue;
}

const char* tmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
