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
//    row of C < V channels (C dividing V and S * C, the gcr UNet3D's
//    one-channel input) takes the packed route: the same ring over the
//    sample read as S * C / V 16-byte vectors of V / C rows each, every
//    lane on channel lane % C, V virtual channels to the consumers, and
//    the lanes folded into channels in the block's partial.  Until then
//    such a shape took the register path at one element a thread and row,
//    12 % of its bound at 8 x 96^3 bf16 on an H100 (0.0352 ms against
//    0.0042).  Any other shape the bulk copy cannot take (an unaligned
//    base, C * esize not a multiple of 16 and no packed row) runs the
//    register path, a strided scalar loop over rows in device memory; the
//    wrapper's planner chooses the route and the C entry checks it.
//    The block folds its row slots in shared memory in a fixed order and
//    writes one partial per channel.  The block that draws a sample's last
//    ticket adds the partials in block order and resets the ticket
//    (sample_sums), then folds channels into groups (flax's fast variance
//    clamped at 0, rsqrt(var + eps), times gamma); a sample of one block
//    skips the ticket.  The order of
//    every sum is fixed, so the results are identical from run to run.
//  - Apply: y = (x - mean[n,c]) * mul[n,c] + beta[c] (+ residual) in fp32,
//    then the nonlinearity, rounding once to the input dtype, with the same
//    fp32 roundings as the plain version (no FMA contraction).  Its bound is
//    the bytes of x (and the residual) read and y written once.  The first
//    design (a grid-stride loop, one 16-byte vector a thread, a 64-bit
//    division and modulo for its sample and channel, the coefficients read
//    per element) reached 86-88 % of that bound at 32-64 channels and
//    37-50 % at 192-768: at 768 bf16 channels a warp's 32 vectors hold 32
//    channel vectors, so each scalar coefficient load spans 8 L1 lines.
//    Measured on an H100 with variants of that design (8 x 24^3 x 768
//    bf16): the coefficients held in registers took it from 38 % to 76 %
//    of the bound, the division and modulo removed alone from 38 % to
//    37 %.  The walk is therefore per sample and channel-owned (see "apply" below): each thread loads its V
//    coefficients once, as 16-byte loads, then streams rows with 16-byte
//    loads and stores, four rows' loads issued before the first is used.
//    A row of C < V channels (the gcr UNet3D's one-channel input) is read
//    as packed 16-byte vectors of V / C rows, every lane on a fixed channel.
//  - Backward: z is recomputed from x (and the residual) and the saved
//    per-(n, c) mean and rstd instead of being stored, with the forward's
//    roundings, so act' (ReLU/LeakyReLU by the sign of z, ELU exp(z)) sees
//    the forward's z.  With xhat = (x - mean) * rstd and dz = dy * act'(z):
//      A = sum_s dz,  B = sum_s dz * xhat       (per (n, c); dbeta, dgamma
//                                                 are their sums over n)
//      dx = rstd*gamma*dz - rstd/M * sum_g gamma*A - (x - mean)*rstd^2/M * sum_g gamma*B
//    The reduce (gn_bwd_reduce_kernel) reads x and dy (and the residual)
//    once; its bound is those bytes.  Its first design was the moments
//    kernel's register path: one thread a channel vector, two rows' loads
//    in flight, rows split over blocks only, a thread per group walking
//    gamma in device memory for the fold; 65 % of the bound over a batch-32
//    step, under half at C = 1 and at 6^3-12^3.  Measured on an H100
//    (chip_bwd_reduce.py): the consumers are bound by latency and issue
//    (an ELU step costs about 20 instructions an element), so resident
//    warps decide the rate; a pairwise slot tree (integer divisions) and
//    grids of several short waves made a first redesign slower than the
//    old kernel at 6^3-12^3; a TMA ring beats the walk at ELU shapes only
//    where it runs three blocks an SM (72 registers) with stages of whole
//    rows a slot, and a second wave never helped.  So the
//    reduce now takes the apply kernels' walk (see "backward reduce" below):
//    one wave of blocks, channel chunks over grid z, a packed route at
//    C < V, the rows of long ELU blocks streamed through a ring of bulk
//    copies, slots folded in segments, and the sample's last block folding
//    each group with a warp from gamma and rstd staged in shared memory.
//    Every sum keeps a fixed order, so two calls are bitwise equal.  The
//    apply writes dx and, for a residual, its gradient dz; its bound is x,
//    dy (and the residual) read and dx (and dz) written once.  The first
//    design was the forward apply's grid-stride loop with six coefficient
//    arrays read per element: 29-30 % of the bound at 384-768 channels.
//    It now takes the forward's channel-owned walk, with mean, mul = rstd *
//    gamma (the product taken once per thread), beta, coeff_b and coeff_c
//    held in registers.
//  - Spatial partitioning: where a volume is split along X over ranks, a
//    GroupNorm's statistics span every slab.  A slab's folded mean and rstd
//    cannot be turned back into sums exactly (the variance is clamped at 0,
//    rstd went through rsqrt), so with fold = 0 the moments kernel stops at
//    the per-(n, c) sum and sum of squares and the backward's reduce at A
//    and B, as the TPU kernel stops at its per-lane sums.  The caller adds
//    them over the slab's ranks and folds them from the global count
//    (ops/groupnorm.py fold_group_stats, backward_coefficients); the applies
//    are unchanged.
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

// must match MOMENTS_ROUTES in ops/groupnorm.py
enum MomentsRoute : int { kMomentsBulk = 0, kMomentsPacked = 1, kMomentsRegister = 2 };

struct MomentsParams {
  const void* x;         // (N, S, C)
  const float* gamma;    // (C)
  float* part;           // (N, blocks, 2, C) scratch
  int* tickets;          // (>= N), 0 between launches
  float* mean;           // (N, C) out
  float* mul;            // (N, C) out
  float* rstd;           // (N, C) out: the backward needs it where gamma is 0
  long long s;           // rows per sample (the packed route reads S * C / V vectors)
  long long rows_per_block;
  int c, groups, stage_rows;
  float eps;
  int fold;              // 0: mean/mul get the per-(n, c) sum/sum of squares
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

// The cross-block sum of gn_moments_kernel: its fixed order is what makes
// it deterministic.  Called by every thread of
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

// The packed route's block partial, before sample_sums: red holds two
// sums per lane for each of row_slots row slots (slot k's at
// red[k * V + lane] and red[(row_slots + k) * V + lane]), lane on channel
// lane % c.  Each of the 2 V columns adds its slots in segments of
// consecutive slots (consumers / (2 V) segments at once), then the
// segments in order; then channel ch adds its lanes ch, ch + c, ... in
// order.  Called by every thread of the block after a __syncthreads; leaves
// the block's (2, c) partial in red as sample_sums takes one row slot
// (red[ch], red[c + ch]), and syncs.
template <int V>
__device__ __forceinline__ void fold_lanes(float* red, int row_slots, int c, int consumers) {
  constexpr int cols = 2 * V;
  const int tid = threadIdx.x;
  const int segs = max(1, min(consumers / cols, row_slots));
  const int per = (row_slots + segs - 1) / segs;
  float a = 0.f;
  if (tid < cols * segs) {
    const int col = tid % cols, sg = tid / cols;
    const float* src = red + (col / V) * row_slots * V + col % V;
    const int k1 = min(row_slots, (sg + 1) * per);
    for (int k = sg * per; k < k1; ++k) a += src[k * V];
  }
  __syncthreads();
  if (tid < cols * segs) red[tid] = a;  // segment sums (segs, cols)
  __syncthreads();
  float* colsum = red + segs * cols;  // (2, V), past every segment sum and the partial
  if (tid < cols) {
    float b = 0.f;
    for (int sg = 0; sg < segs; ++sg) b += red[sg * cols + tid];
    colsum[tid] = b;
  }
  __syncthreads();
  if (tid < 2 * c) {
    const float* lanes = colsum + (tid < c ? 0 : V);
    float b = 0.f;
    for (int lane = tid % c; lane < V; lane += c) b += lanes[lane];
    red[tid] = b;
  }
  __syncthreads();
}

// blockDim = consumers (+ 32 for the producer warp on the bulk and packed
// routes).  The walk takes rows of `width` elements: a spatial row of C
// channels (bulk, register), or one 16-byte vector of V / C spatial rows
// (packed: V virtual channels, lane k on channel k % C).  Consumer thread t
// sums vector t % vecs of a row over the rows of slot t / vecs; threads
// past vecs * row_slots only take part in the barriers.
template <typename T, int V, int kRoute>
__global__ void gn_moments_kernel(const MomentsParams p) {
  constexpr bool kBulk = kRoute != kMomentsRegister;  // rows streamed by bulk copies
  extern __shared__ __align__(128) unsigned char smem[];
  const int c = p.c;
  const int width = kRoute == kMomentsPacked ? V : c;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int consumers = kBulk ? blockDim.x - 32 : blockDim.x;
  const int vecs = width / V;
  const int row_slots = consumers / vecs;
  const int slot = tid / vecs;
  const int cv = tid - slot * vecs;
  const bool active = slot < row_slots;
  const long long walk_rows = kRoute == kMomentsPacked ? p.s * c / V : p.s;
  const long long row0 = blockIdx.x * p.rows_per_block;
  const long long row1 = min(row0 + p.rows_per_block, walk_rows);
  const T* xs = static_cast<const T*>(p.x) + (long long)n * p.s * c;

  float sum[V], sq[V];
#pragma unroll
  for (int i = 0; i < V; ++i) sum[i] = sq[i] = 0.f;

  float* red;  // 2 * row_slots * width floats, then the fold's 2 * (c + groups)
  if constexpr (kBulk) {
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + kStages;
    T* ring = reinterpret_cast<T*>(smem + kBarrierBytes);
    red = reinterpret_cast<float*>(smem + kBarrierBytes);
    const int stage_elems = p.stage_rows * width;
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
          const uint32_t bytes = (uint32_t)(rows * width * sizeof(T));
          mbar_expect_tx(&full[st], bytes);
          bulk_load(ring + st * stage_elems, xs + r * width, bytes, &full[st]);
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
            load_vec<T, V>(buf + j * width, v);
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

  // the block's partial: row slots (on the packed route, then the lanes of
  // a channel) folded in a fixed order, one thread per (sum or sum of
  // squares, channel)
  if (active) {
#pragma unroll
    for (int i = 0; i < V; ++i) {
      red[slot * width + cv * V + i] = sum[i];
      red[(row_slots + slot) * width + cv * V + i] = sq[i];
    }
  }
  __syncthreads();
  int slots = row_slots;  // row slots of red after the packed route's fold
  if constexpr (kRoute == kMomentsPacked) {
    fold_lanes<V>(red, row_slots, c, consumers);
    slots = 1;
  }
  if (!sample_sums(red, slots, c, p.part, p.tickets)) return;
  float* tot = red + 2 * slots * c;  // (2, c), then mean and rstd per group
  if (!p.fold) {  // the sums alone, to be added over a slab's ranks and folded
    for (int ch = tid; ch < c; ch += blockDim.x) {
      p.mean[(long long)n * c + ch] = tot[ch];
      p.mul[(long long)n * c + ch] = tot[c + ch];
    }
    return;
  }
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

template <typename T, int V, int kRoute>
cudaError_t launch_moments(const MomentsParams& p, long long n, int blocks,
                           cudaStream_t stream) {
  constexpr bool kBulk = kRoute != kMomentsRegister;
  const int width = kRoute == kMomentsPacked ? V : p.c;
  const int vecs = width / V;
  const int consumers = vecs <= kConsumers ? kConsumers : (vecs + 31) / 32 * 32;
  const int row_slots = consumers / vecs;
  size_t smem = 2ull * (row_slots * width + p.c + p.groups) * sizeof(float);
  int threads = consumers;
  if constexpr (kBulk) {
    const size_t ring = (size_t)kStages * p.stage_rows * width * sizeof(T);
    if (vecs > kConsumers || p.stage_rows < 1 ||
        (size_t)p.stage_rows * width * sizeof(T) > kMaxStageBytes)
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
      err = cudaFuncSetAttribute(gn_moments_kernel<T, V, kRoute>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kMaxBulkSmem);
      if (err != cudaSuccess) return err;
      attr_set[dev] = true;
    }
  }
  if (threads > 1024 || smem > (kBulk ? kMaxBulkSmem : 48 * 1024))
    return cudaErrorInvalidValue;
  gn_moments_kernel<T, V, kRoute>
      <<<dim3(blocks, (unsigned)n), threads, smem, stream>>>(p);
  return cudaGetLastError();
}

// The moments instance of one route: V-element vectors on the bulk and
// packed routes, one element on the register path.
template <typename T, int V>
cudaError_t launch_moments_route(const MomentsParams& p, int route, long long n, int blocks,
                                 cudaStream_t stream) {
  if (route == kMomentsBulk) return launch_moments<T, V, kMomentsBulk>(p, n, blocks, stream);
  if (route == kMomentsPacked) return launch_moments<T, V, kMomentsPacked>(p, n, blocks, stream);
  return launch_moments<T, 1, kMomentsRegister>(p, n, blocks, stream);
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

// -- apply: a per-sample walk of channel-owned threads -------------------
//
// Both apply kernels walk a sample as `rows` rows of `row` elements: a
// spatial row of C channels on the vector and scalar routes, a 16-byte
// vector that spans V / C spatial rows of one sample on the packed route
// (C < V).  Block (bx, n, z) takes rows [bx * rows_per_block, ...) of sample
// n and channel vectors [z * chunk, (z + 1) * chunk) of each; thread t owns
// vector z * chunk + t % chunk in row slot t / chunk, so its V lanes keep
// their channels, (vector * V + lane) % C, for the whole walk.  It loads
// its coefficients once, then streams its rows: kApplyRows rows' loads
// issued before the first is used, pointers advanced by whole rows.

// must match _APPLY_MAX_THREADS in ops/groupnorm.py
constexpr int kApplyMaxThreads = 512;
constexpr int kApplyRows = 4;
enum ApplyRoute : int { kRouteVector = 0, kRoutePacked = 1, kRouteScalar = 2 };

struct ApplyWalk {
  long long rows;            // rows per sample
  long long rows_per_block;
  int row;                   // elements per row
  int c;                     // channels
  int vecs;                  // V-element vectors per row
  int chunk;                 // vectors per block (threads = chunk * slots)
};

// V elements at p as raw bits: one 16-byte load, or one element
template <typename T, int V>
struct Raw {
  using type = uint4;
};
template <typename T>
struct Raw<T, 1> {
  using type = T;
};

template <typename T, int V>
__device__ __forceinline__ typename Raw<T, V>::type load_raw(const T* p) {
  return *reinterpret_cast<const typename Raw<T, V>::type*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void unpack(const typename Raw<T, V>::type& raw,
                                       float (&out)[V]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = to_float(e[i]);
}

// A thread's place in the walk: false for a thread past the last vector
// or the sample's last row.  off is the element offset of its first row's
// vector, step the elements between its rows, r and r1 its first row and
// its block's end, slots the block's row slots.
struct Lane {
  long long off, step, r, r1;
  int cv, slots;
};

__device__ __forceinline__ bool lane_of(const ApplyWalk& w, int v, Lane& l) {
  l.slots = blockDim.x / w.chunk;
  const int slot = threadIdx.x / w.chunk;
  l.cv = blockIdx.z * w.chunk + (threadIdx.x - slot * w.chunk);
  const long long b0 = blockIdx.x * w.rows_per_block;
  l.r = b0 + slot;
  l.r1 = min(b0 + w.rows_per_block, w.rows);
  if (l.cv >= w.vecs || l.r >= l.r1) return false;
  l.off = ((long long)blockIdx.y * w.rows + l.r) * w.row + (long long)l.cv * v;
  l.step = (long long)l.slots * w.row;
  return true;
}

// A lane's V per-channel coefficients of one (N, C) or (C) array, loaded
// once: 16-byte loads where the lanes hold V consecutive channels (the
// vector route; p 16-byte aligned), else one load per lane.
template <int V>
__device__ __forceinline__ void load_coef(const float* p, const ApplyWalk& w, int cv,
                                          float (&out)[V]) {
  if constexpr (V >= 4) {
    if (w.row == w.c) {
      const float4* q = reinterpret_cast<const float4*>(p + cv * V);
#pragma unroll
      for (int j = 0; j < V / 4; ++j) {
        const float4 f = q[j];
        out[4 * j] = f.x;
        out[4 * j + 1] = f.y;
        out[4 * j + 2] = f.z;
        out[4 * j + 3] = f.w;
      }
      return;
    }
  }
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = p[(cv * V + i) % w.c];
}

struct ApplyParams {
  const float* mean;     // (N, C)
  const float* mul;      // (N, C)
  const float* beta;     // (C)
  ApplyWalk w;
  int act;
  float slope;
};

template <typename T, int V, bool kResidual>
__global__ void __launch_bounds__(kApplyMaxThreads)
    gn_apply_kernel(const T* __restrict__ x, const T* __restrict__ residual,
                    T* __restrict__ y, const ApplyParams p) {
  Lane l;
  if (!lane_of(p.w, V, l)) return;
  const long long nc = (long long)blockIdx.y * p.w.c;
  float mn[V], ml[V], bt[V];
  load_coef<V>(p.mean + nc, p.w, l.cv, mn);
  load_coef<V>(p.mul + nc, p.w, l.cv, ml);
  load_coef<V>(p.beta, p.w, l.cv, bt);
  const T* xp = x + l.off;
  const T* rp = kResidual ? residual + l.off : nullptr;
  T* yp = y + l.off;
  // explicit round-to-nearest ops, never contracted into an FMA: the
  // same fp32 roundings as the plain version, so the one rounding to the
  // input dtype differs from it by at most an ulp even where the terms
  // cancel
  auto one = [&](const typename Raw<T, V>::type& rx, const typename Raw<T, V>::type& rr,
                 T* out) {
    float v[V], r[V];
    unpack<T, V>(rx, v);
    if constexpr (kResidual) unpack<T, V>(rr, r);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float t = __fadd_rn(__fmul_rn(__fsub_rn(v[k], mn[k]), ml[k]), bt[k]);
      if constexpr (kResidual) t = __fadd_rn(t, r[k]);
      v[k] = activate(t, p.act, p.slope);
    }
    store_vec<T, V>(out, v);
  };
  for (; l.r + (kApplyRows - 1) * l.slots < l.r1; l.r += kApplyRows * l.slots) {
    typename Raw<T, V>::type rx[kApplyRows], rr[kApplyRows];
#pragma unroll
    for (int j = 0; j < kApplyRows; ++j) {
      rx[j] = load_raw<T, V>(xp + j * l.step);
      if constexpr (kResidual) rr[j] = load_raw<T, V>(rp + j * l.step);
    }
#pragma unroll
    for (int j = 0; j < kApplyRows; ++j) one(rx[j], rr[j], yp + j * l.step);
    xp += kApplyRows * l.step;
    if constexpr (kResidual) rp += kApplyRows * l.step;
    yp += kApplyRows * l.step;
  }
  for (; l.r < l.r1; l.r += l.slots) {
    typename Raw<T, V>::type rx = load_raw<T, V>(xp), rr{};
    if constexpr (kResidual) rr = load_raw<T, V>(rp);
    one(rx, rr, yp);
    xp += l.step;
    if constexpr (kResidual) rp += l.step;
    yp += l.step;
  }
}

// The walk of one launch from the plan's fields, or false where they do
// not describe a walk the kernels take (see tmt_gn_apply).
bool apply_walk(int route, int dtype, long long n, long long s, int c, int blocks,
                long long rows_per_block, int threads, int chunk, ApplyWalk& w, int& v) {
  if (n < 1 || n > 65535 || s < 1 || c < 1 || blocks < 1 || rows_per_block < 1 ||
      threads < 1 || threads > kApplyMaxThreads || chunk < 1 || threads % chunk)
    return false;
  const int esize = dtype == kBF16 ? 2 : 4;
  const int wide = 16 / esize;
  if (route == kRouteVector) {
    if (c % wide) return false;
    v = wide;
    w.row = c;
  } else if (route == kRoutePacked) {
    if (c >= wide || wide % c || (s * c) % wide) return false;
    v = wide;
    w.row = wide;
  } else if (route == kRouteScalar) {
    v = 1;
    w.row = c;
  } else {
    return false;
  }
  w.c = c;
  w.rows = s * c / w.row;
  w.rows_per_block = rows_per_block;
  w.vecs = w.row / v;
  w.chunk = chunk;
  const long long chunks = (w.vecs + chunk - 1) / chunk;
  // every row in one block, no block empty; every vector in one chunk
  return chunk <= w.vecs && chunks <= 65535 && (long long)blocks * rows_per_block >= w.rows &&
         (long long)(blocks - 1) * rows_per_block < w.rows;
}

template <typename T, int V>
cudaError_t launch_apply(const void* x, const void* residual, void* y, const ApplyParams& p,
                         long long n, int blocks, int threads, cudaStream_t stream) {
  const dim3 grid(blocks, (unsigned)n, (p.w.vecs + p.w.chunk - 1) / p.w.chunk);
  const T* xt = static_cast<const T*>(x);
  if (residual != nullptr) {
    gn_apply_kernel<T, V, true><<<grid, threads, 0, stream>>>(
        xt, static_cast<const T*>(residual), static_cast<T*>(y), p);
  } else {
    gn_apply_kernel<T, V, false><<<grid, threads, 0, stream>>>(xt, nullptr,
                                                                static_cast<T*>(y), p);
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

// -- backward reduce: the apply walk, partials in a fixed order ------------
//
// gn_bwd_reduce_kernel walks a sample as the apply kernels do (ApplyWalk,
// grid (blocks, N, chunks), thread t on vector z * chunk + t % chunk in row
// slot t / chunk): its lanes keep their channels for the whole walk, on the
// vector, packed (one 16-byte vector spans V / C rows, lane k on channel
// k % C) and scalar routes.  Each thread sums dz and dz * (x - mean) per
// lane in registers.  On the walk (kRing false) it streams its rows from
// device memory, kReduceRows rows' loads of every operand (half with the
// residual) issued before the first is used; on the ring (kRing true: one
// chunk spans the row, so a block's rows are one contiguous span of each
// operand) a producer thread keeps kStages stages of stage_rows rows of x,
// dy (and the residual) in flight with bulk copies counted on one mbarrier
// a stage, and the consumers read their vectors from shared memory.  The
// block then adds its row slots in shared memory (segments of consecutive
// slots at once, then the segments, in order), the lanes of each channel
// in lane order, and writes one partial per channel of its chunk.  The block
// that draws a sample's last ticket (blocks x chunks of them) adds the
// partials in block order (16-byte loads, segments of blocks at once),
// leaves the ticket 0, and, with fold on, stages gamma and rstd in shared
// memory and folds each group with one warp (a fixed butterfly).

// must match _REDUCE_THREADS, _REDUCE_ROWS and the blocks an SM holds
// (_WALK_BLOCKS_PER_SM, _RING_BLOCKS_PER_SM) in ops/groupnorm.py: the
// launch bounds (and the ring's producer warp) leave a thread 96 registers
// on the walk, 72 on the ring
constexpr int kReduceMaxThreads = 256;
constexpr int kWalkBlocksPerSm = 2;
constexpr int kRingBlocksPerSm = 3;
constexpr int kReduceRows = 4;
constexpr int kMaxRingBytes = 192 * 1024;   // kStages stages of every operand

struct BwdParams {
  const float* mean;     // (N, C)
  const float* rstd;     // (N, C)
  const float* gamma;    // (C)
  const float* beta;     // (C)
  float* part;           // (N, blocks, 2, C) scratch
  int* tickets;          // (>= N), 0 between launches
  float* out;            // (4, N, C) out: A, B, coeff_b, coeff_c; (2, N, C) unfolded
  ApplyWalk w;
  long long n;
  long long s;           // spatial rows per sample
  int groups, act;
  float slope;
  int fold;              // 0: A and B alone
  int stage_rows;        // rows of one ring stage (the ring only)
  int tail_at;           // byte offset of the sample's sums after the ring
};

// Shared memory of one block: the ring's barriers and stages (the ring
// only), overlaid after the walk by the slot sums (2 x slots x chunk * V
// floats) or the cross-block segments (2 C floats, or 4 a thread); then the
// sample's sums, gamma, rstd (C each, the sums 2 C) and two per group.
struct ReduceSmem {
  size_t ring, reuse, tail, total;
};

inline ReduceSmem reduce_smem(const ApplyWalk& w, int v, int threads, int groups, int ops,
                              int stage_rows, int esize) {
  ReduceSmem m{};
  m.ring = stage_rows > 0 ? (size_t)kStages * ops * stage_rows * w.row * esize : 0;
  const size_t red = 2ull * threads * v * sizeof(float);
  const size_t seg = std::max<size_t>(4ull * (threads + 32), 2ull * w.c) * sizeof(float);
  m.reuse = std::max({m.ring, red, seg});
  m.reuse = (m.reuse + 15) / 16 * 16;
  m.tail = (4ull * w.c + 2ull * groups) * sizeof(float);
  m.total = (stage_rows > 0 ? kBarrierBytes : 0) + m.reuse + m.tail;
  return m;
}

template <typename T, int V, bool kResidual, bool kRing>
__global__ void __launch_bounds__(kReduceMaxThreads + 32,
                                  kRing ? kRingBlocksPerSm : kWalkBlocksPerSm)
    gn_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                         const T* __restrict__ residual, const BwdParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const ApplyWalk& w = p.w;
  const int c = w.c;
  const int n = blockIdx.y;
  const int tid = threadIdx.x;
  const int consumers = kRing ? blockDim.x - 32 : blockDim.x;
  const int slots = consumers / w.chunk;
  const int slot = tid / w.chunk;
  const int cl = tid - slot * w.chunk;
  const int cv = blockIdx.z * w.chunk + cl;
  const bool active = slot < slots && cv < w.vecs;
  const long long b0 = blockIdx.x * w.rows_per_block;
  const long long b1 = min(b0 + w.rows_per_block, w.rows);
  const long long nc = (long long)n * c;
  using R = typename Raw<T, V>::type;

  const long long base = (long long)n * w.rows * w.row;
  // the walk: a thread's rows r, r + slots, ... < b1, kRows rows of every
  // operand loaded at a time (half as many with the residual's third
  // operand: the same bytes in flight, registers for two blocks an SM);
  // the first batch is issued before the coefficients, so the two loads'
  // latencies overlap
  constexpr int kRows = kResidual ? kReduceRows / 2 : kReduceRows;
  long long r = b0 + slot;
  const long long step = (long long)slots * w.row;
  const long long off = base + r * w.row + (long long)cv * V;
  const T* xp = x + off;
  const T* gp = dy + off;
  const T* rp = kResidual ? residual + off : nullptr;
  R rx[kRows], rg[kRows], rr[kRows];
  auto batch = [&]() {
    if (!active || r + (kRows - 1) * slots >= b1) return false;
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      rx[j] = load_raw<T, V>(xp + j * step);
      rg[j] = load_raw<T, V>(gp + j * step);
      if constexpr (kResidual) rr[j] = load_raw<T, V>(rp + j * step);
    }
    return true;
  };
  bool loaded = !kRing && batch();

  float mn[V], ml[V], bt[V], sa[V], sb[V];
#pragma unroll
  for (int k = 0; k < V; ++k) mn[k] = ml[k] = bt[k] = sa[k] = sb[k] = 0.f;
  if (active) {
    load_coef<V>(p.mean + nc, w, cv, mn);
    load_coef<V>(p.rstd + nc, w, cv, ml);
    load_coef<V>(p.gamma, w, cv, bt);
#pragma unroll
    for (int k = 0; k < V; ++k) ml[k] = __fmul_rn(ml[k], bt[k]);
    load_coef<V>(p.beta, w, cv, bt);
  }
  // dz = dy * act'(z) per lane, z recomputed with the forward's roundings
  auto one = [&](const R& rx, const R& rg, const R& rr) {
    float v[V], g[V], r[V];
    unpack<T, V>(rx, v);
    unpack<T, V>(rg, g);
    if constexpr (kResidual) unpack<T, V>(rr, r);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xm = __fsub_rn(v[k], mn[k]);
      const float dz = grad_z<kResidual>(xm, g[k], kResidual ? r[k] : 0.f, ml[k], bt[k],
                                         p.act, p.slope);
      sa[k] = __fadd_rn(sa[k], dz);
      sb[k] = __fmaf_rn(dz, xm, sb[k]);
    }
  };
  unsigned char* region = smem;
  if constexpr (kRing) {
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* empty = full + kStages;
    region = smem + kBarrierBytes;
    T* ring = reinterpret_cast<T*>(region);
    constexpr int ops = kResidual ? 3 : 2;
    const int stage_elems = p.stage_rows * w.row;
    const int stages =
        b1 > b0 ? (int)((b1 - b0 + p.stage_rows - 1) / p.stage_rows) : 0;
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
          const long long r = b0 + (long long)k * p.stage_rows;
          const long long rows = min((long long)p.stage_rows, b1 - r);
          const uint32_t bytes = (uint32_t)(rows * w.row * sizeof(T));
          const long long at = base + r * w.row;
          T* buf = ring + (long long)st * ops * stage_elems;
          mbar_expect_tx(&full[st], ops * bytes);
          bulk_load(buf, x + at, bytes, &full[st]);
          bulk_load(buf + stage_elems, dy + at, bytes, &full[st]);
          if constexpr (kResidual)
            bulk_load(buf + 2 * stage_elems, residual + at, bytes, &full[st]);
        }
      }
    } else {
      for (int k = 0; k < stages; ++k) {
        const int st = k % kStages;
        mbar_wait(&full[st], (k / kStages) & 1);
        if (active) {
          const long long r = b0 + (long long)k * p.stage_rows;
          const int rows = (int)min((long long)p.stage_rows, b1 - r);
          const T* buf = ring + (long long)st * ops * stage_elems + cv * V;
#pragma unroll 2
          for (int j = slot; j < rows; j += slots) {
            R rr{};
            if constexpr (kResidual) rr = load_raw<T, V>(buf + 2 * stage_elems + j * w.row);
            one(load_raw<T, V>(buf + j * w.row), load_raw<T, V>(buf + stage_elems + j * w.row),
                rr);
          }
        }
        __syncwarp();
        if ((tid & 31) == 0) mbar_arrive(&empty[st]);
      }
    }
    // every issued stage was waited for: the ring is free for the sums
    __syncthreads();
  } else if (active) {
    while (loaded) {
#pragma unroll
      for (int j = 0; j < kRows; ++j) one(rx[j], rg[j], rr[j]);
      r += kRows * slots;
      xp += kRows * step;
      gp += kRows * step;
      if constexpr (kResidual) rp += kRows * step;
      loaded = batch();
    }
    for (; r < b1; r += slots) {
      R rr{};
      if constexpr (kResidual) rr = load_raw<T, V>(rp);
      one(load_raw<T, V>(xp), load_raw<T, V>(gp), rr);
      xp += step;
      gp += step;
      if constexpr (kResidual) rp += step;
    }
  }

  // the block's partial.  red (2, slots, L) holds each thread's lane sums
  // by lane column lc = (t % chunk) * V + k, B's scaled by rstd once.  The
  // slots of each of the 2 L columns are added in order, in segs segments
  // of consecutive slots at once (then the segments in order, into the
  // first slot's row); channel j of the chunk then adds its lane columns
  // j, j + C, ... (several only on the packed route) in order
  const int L = w.chunk * V;
  float* red = reinterpret_cast<float*>(region);
  float* tot = reinterpret_cast<float*>(region + p.tail_at);  // (2, c)
  if (slot < slots) {
    float rs[V] = {};
    if (active) load_coef<V>(p.rstd + nc, w, cv, rs);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[slot * L + cl * V + k] = active ? sa[k] : 0.f;
      red[(slots + slot) * L + cl * V + k] = active ? __fmul_rn(sb[k], rs[k]) : 0.f;
    }
  }
  __syncthreads();
  {
    const int cols = 2 * L;
    const int segs = max(1, min((int)blockDim.x / cols, slots));
    const int per = (slots + segs - 1) / segs;
    float a[2] = {0.f, 0.f};  // columns tid and tid + blockDim.x where segs is 1
    if (tid < cols * segs) {
      for (int q = 0; q < (segs == 1 ? 2 : 1); ++q) {
        const int j = tid + q * blockDim.x;
        if (j >= cols * segs) break;
        const int col = j % cols, sg = j / cols;
        const float* src = red + (col / L) * slots * L + col % L;
        const int k1 = min(slots, (sg + 1) * per);
        for (int k = sg * per; k < k1; ++k) a[q] = __fadd_rn(a[q], src[k * L]);
      }
    }
    __syncthreads();
    if (segs == 1) {
      for (int q = 0; q < 2; ++q) {
        const int col = tid + q * blockDim.x;
        if (col < cols) red[(col / L) * slots * L + col % L] = a[q];
      }
    } else if (tid < cols * segs) {
      red[(tid / cols) * cols + tid % cols] = a[0];  // segment sums (segs, 2, L)
    }
    __syncthreads();
    if (segs > 1) {
      float b[2] = {0.f, 0.f};
      for (int q = 0; q < 2; ++q) {
        const int col = tid + q * blockDim.x;
        if (col < cols)
          for (int sg = 0; sg < segs; ++sg) b[q] = __fadd_rn(b[q], red[sg * cols + col]);
      }
      __syncthreads();
      for (int q = 0; q < 2; ++q) {
        const int col = tid + q * blockDim.x;
        if (col < cols) red[(col / L) * slots * L + col % L] = b[q];
      }
      __syncthreads();
    }
  }
  const int ch0 = (int)(((long long)blockIdx.z * L) % c);
  const int cb = min(L, c - ch0);
  const int nb = gridDim.x, blocks = gridDim.x * gridDim.z;
  float* part = blocks == 1 ? tot : p.part + ((long long)n * nb + blockIdx.x) * 2 * c;
  for (int j = tid; j < 2 * cb; j += blockDim.x) {
    const int sum = j / cb, ch = j - sum * cb;
    const float* row = red + sum * slots * L;
    float a = 0.f;
    for (int lc = ch; lc < L; lc += c) a = __fadd_rn(a, row[lc]);
    part[sum * c + ch0 + ch] = a;
  }
  float* s_gamma = tot + 2 * c;  // the fold's gamma and rstd of the sample
  float* s_rstd = s_gamma + c;
  if (blocks > 1) {
    __shared__ int last_block;
    __threadfence();
    __syncthreads();
    if (tid == 0) last_block = atomicAdd(p.tickets + n, 1) == blocks - 1;
    __syncthreads();
    if (!last_block) return;
    __threadfence();
  }
  // the sample's last block: gamma and rstd staged while the partials load
  if (p.fold) {
    for (int ch = tid; ch < c; ch += blockDim.x) {
      s_gamma[ch] = p.gamma[ch];
      s_rstd[ch] = p.rstd[nc + ch];
    }
  }
  if (blocks > 1) {
    // the partials of the sample's nb blocks in block order: each thread
    // takes q values (one 16-byte load where 2 C is a multiple of 4) over
    // a segment of consecutive blocks, segs segments at once; then each
    // value adds its segments in order
    const float* part_n = p.part + (long long)n * nb * 2 * c;
    const int vals = 2 * c;
    const int q = vals % 4 ? 1 : 4;
    const int loads = vals / q;
    const int segs = max(1, min((int)blockDim.x / loads, nb));
    const int per = (nb + segs - 1) / segs;
    for (int j = tid; j < loads * segs; j += blockDim.x) {
      const int v = j % loads, sg = j / loads;
      const int k1 = min(nb, (sg + 1) * per);
      float* out = red + sg * vals + v * q;
      if (q == 4) {
        float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4* src = reinterpret_cast<const float4*>(part_n) + v;
#pragma unroll 8
        for (int k = sg * per; k < k1; ++k) {
          const float4 f = __ldcg(src + (long long)k * loads);
          a.x = __fadd_rn(a.x, f.x);
          a.y = __fadd_rn(a.y, f.y);
          a.z = __fadd_rn(a.z, f.z);
          a.w = __fadd_rn(a.w, f.w);
        }
        out[0] = a.x;
        out[1] = a.y;
        out[2] = a.z;
        out[3] = a.w;
      } else {
        float a = 0.f;
#pragma unroll 8
        for (int k = sg * per; k < k1; ++k)
          a = __fadd_rn(a, __ldcg(part_n + (long long)k * vals + v));
        out[0] = a;
      }
    }
    __syncthreads();
    for (int v = tid; v < vals; v += blockDim.x) {
      float a = 0.f;
      for (int sg = 0; sg < segs; ++sg) a = __fadd_rn(a, red[sg * vals + v]);
      tot[v] = a;
    }
    // every block of the sample has drawn
    if (tid == 0) p.tickets[n] = 0;
  }
  __syncthreads();
  const long long all = p.n * c;
  if (!p.fold) {  // A and B alone: the coefficients wait for the sums of every slab
    for (int ch = tid; ch < c; ch += blockDim.x) {
      p.out[nc + ch] = tot[ch];
      p.out[all + nc + ch] = tot[c + ch];
    }
    return;
  }
  // per group: sum of gamma * A and of gamma * B over its channels, one
  // warp a group (lanes stride its channels, then a butterfly), then
  // dx = mul * dz + coeff_b * (x - mean) + coeff_c with
  // coeff_b = -rstd^2 * sum(gamma B) / M and coeff_c = -rstd * sum(gamma A) / M
  float* g_a = s_rstd + c;
  float* g_b = g_a + p.groups;
  const int cg = c / p.groups;
  const float count = (float)(p.s * cg);
  const int warps = blockDim.x / 32, lane = tid & 31;
  for (int g = tid / 32; g < p.groups && tid / 32 < warps; g += warps) {
    float a = 0.f, b = 0.f;
    for (int j = lane; j < cg; j += 32) {
      const int ch = g * cg + j;
      a = __fadd_rn(a, __fmul_rn(s_gamma[ch], tot[ch]));
      b = __fadd_rn(b, __fmul_rn(s_gamma[ch], tot[c + ch]));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, o));
      b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, o));
    }
    if (lane == 0) {
      g_a[g] = a;
      g_b[g] = b;
    }
  }
  __syncthreads();
  for (int ch = tid; ch < c; ch += blockDim.x) {
    const int g = ch / cg;
    const float r = s_rstd[ch];
    p.out[nc + ch] = tot[ch];
    p.out[all + nc + ch] = tot[c + ch];
    p.out[2 * all + nc + ch] = -__fdiv_rn(__fmul_rn(__fmul_rn(r, r), g_b[g]), count);
    p.out[3 * all + nc + ch] = -__fdiv_rn(__fmul_rn(r, g_a[g]), count);
  }
}

// The kernel instance of one launch.
template <typename T, int V>
const void* reduce_fn(bool res, bool ring) {
  return res ? (ring ? (const void*)gn_bwd_reduce_kernel<T, V, true, true>
                     : (const void*)gn_bwd_reduce_kernel<T, V, true, false>)
             : (ring ? (const void*)gn_bwd_reduce_kernel<T, V, false, true>
                     : (const void*)gn_bwd_reduce_kernel<T, V, false, false>);
}

const void* pick_reduce(int dtype, int v, bool res, bool ring) {
  if (dtype == kBF16)
    return v == 8 ? reduce_fn<__nv_bfloat16, 8>(res, ring) : reduce_fn<__nv_bfloat16, 1>(res, ring);
  return v == 4 ? reduce_fn<float, 4>(res, ring) : reduce_fn<float, 1>(res, ring);
}

// dynamic shared memory a block may take: Hopper's 227 KB less room for
// the kernel's static shared memory
constexpr int kMaxSmem = 224 * 1024;

// Every reduce instance may take up to kMaxSmem of dynamic shared memory
// (above 48 KB only after opting in), once per device.
cudaError_t allow_reduce_smem() {
  static bool set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (set[dev]) return cudaSuccess;
  for (int dtype : {kBF16, kF32})
    for (int v : {1, 16 / (dtype == kBF16 ? 2 : 4)})
      for (bool res : {false, true})
        for (bool ring : {false, true}) {
          err = cudaFuncSetAttribute(pick_reduce(dtype, v, res, ring),
                                     cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
          if (err != cudaSuccess) return err;
        }
  set[dev] = true;
  return cudaSuccess;
}

// A reduce launch from the plan's fields, checked (see tmt_gn_bwd_reduce):
// its kernel, block threads and shared memory, or false.
bool reduce_launch(int dtype, long long n, long long s, int c, int groups, bool res, int route,
                   int blocks, long long rows_per_block, int threads, int chunk, int stage_rows,
                   BwdParams& p, const void*& fn, int& block, ReduceSmem& m) {
  int v = 0;
  if ((dtype != kBF16 && dtype != kF32) || groups < 1 || c % groups || stage_rows < 0 ||
      threads > kReduceMaxThreads ||
      !apply_walk(route, dtype, n, s, c, blocks, rows_per_block, threads, chunk, p.w, v))
    return false;
  const bool ring = stage_rows > 0;
  const int esize = dtype == kBF16 ? 2 : 4;
  // the ring copies whole rows of 16-byte vectors, one chunk a row, and
  // its consumers arrive a warp at a time
  if (ring && (v == 1 || chunk != p.w.vecs || threads % 32 ||
               (long long)kStages * (res ? 3 : 2) * stage_rows * p.w.row * esize > kMaxRingBytes))
    return false;
  m = reduce_smem(p.w, v, threads, groups, res ? 3 : 2, stage_rows, esize);
  if (m.total > kMaxSmem) return false;
  p.n = n;
  p.s = s;
  p.groups = groups;
  p.stage_rows = stage_rows;
  p.tail_at = (int)m.reuse;
  fn = pick_reduce(dtype, v, res, ring);
  block = threads + (ring ? 32 : 0);
  return true;
}

struct BwdApplyParams {
  const float* mean;     // (N, C)
  const float* rstd;     // (N, C)
  const float* gamma;    // (C)
  const float* beta;     // (C)
  const float* coef_b;   // (N, C): tmt_gn_bwd_reduce's out[2]
  const float* coef_c;   // (N, C): out[3]
  ApplyWalk w;
  int act;
  float slope;
};

// dx = mul * dz + coeff_b * (x - mean) + coeff_c, and dr = dz where the
// forward added a residual; every fp32 operation rounded on its own, as
// in the plain version.  The walk is gn_apply_kernel's; a thread's
// mul = rstd * gamma is taken once, with its other coefficients.
template <typename T, int V, bool kResidual>
__global__ void __launch_bounds__(kApplyMaxThreads)
    gn_bwd_apply_kernel(const T* __restrict__ x, const T* __restrict__ dy,
                        const T* __restrict__ residual, T* __restrict__ dx,
                        T* __restrict__ dr, const BwdApplyParams p) {
  Lane l;
  if (!lane_of(p.w, V, l)) return;
  const long long nc = (long long)blockIdx.y * p.w.c;
  float mn[V], ml[V], bt[V], cb[V], cc[V];
  load_coef<V>(p.mean + nc, p.w, l.cv, mn);
  load_coef<V>(p.rstd + nc, p.w, l.cv, ml);
  load_coef<V>(p.gamma, p.w, l.cv, bt);
#pragma unroll
  for (int k = 0; k < V; ++k) ml[k] = __fmul_rn(ml[k], bt[k]);
  load_coef<V>(p.beta, p.w, l.cv, bt);
  load_coef<V>(p.coef_b + nc, p.w, l.cv, cb);
  load_coef<V>(p.coef_c + nc, p.w, l.cv, cc);
  const T* xp = x + l.off;
  const T* gp = dy + l.off;
  const T* rp = kResidual ? residual + l.off : nullptr;
  T* dxp = dx + l.off;
  T* drp = kResidual ? dr + l.off : nullptr;
  using R = typename Raw<T, V>::type;
  auto one = [&](const R& rx, const R& rg, const R& rr, T* out, T* out_r) {
    float v[V], g[V], r[V];
    unpack<T, V>(rx, v);
    unpack<T, V>(rg, g);
    if constexpr (kResidual) unpack<T, V>(rr, r);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xm = __fsub_rn(v[k], mn[k]);
      const float dz = grad_z<kResidual>(xm, g[k], kResidual ? r[k] : 0.f, ml[k], bt[k],
                                         p.act, p.slope);
      v[k] = __fadd_rn(__fadd_rn(__fmul_rn(ml[k], dz), __fmul_rn(cb[k], xm)), cc[k]);
      if constexpr (kResidual) r[k] = dz;
    }
    store_vec<T, V>(out, v);
    if constexpr (kResidual) store_vec<T, V>(out_r, r);
  };
  for (; l.r + (kApplyRows - 1) * l.slots < l.r1; l.r += kApplyRows * l.slots) {
    R rx[kApplyRows], rg[kApplyRows], rr[kApplyRows];
#pragma unroll
    for (int j = 0; j < kApplyRows; ++j) {
      rx[j] = load_raw<T, V>(xp + j * l.step);
      rg[j] = load_raw<T, V>(gp + j * l.step);
      if constexpr (kResidual) rr[j] = load_raw<T, V>(rp + j * l.step);
    }
#pragma unroll
    for (int j = 0; j < kApplyRows; ++j)
      one(rx[j], rg[j], rr[j], dxp + j * l.step, kResidual ? drp + j * l.step : nullptr);
    xp += kApplyRows * l.step;
    gp += kApplyRows * l.step;
    dxp += kApplyRows * l.step;
    if constexpr (kResidual) {
      rp += kApplyRows * l.step;
      drp += kApplyRows * l.step;
    }
  }
  for (; l.r < l.r1; l.r += l.slots) {
    R rx = load_raw<T, V>(xp), rg = load_raw<T, V>(gp), rr{};
    if constexpr (kResidual) rr = load_raw<T, V>(rp);
    one(rx, rg, rr, dxp, drp);
    xp += l.step;
    gp += l.step;
    dxp += l.step;
    if constexpr (kResidual) {
      rp += l.step;
      drp += l.step;
    }
  }
}

template <typename T, int V>
cudaError_t launch_bwd_apply(const void* x, const void* dy, const void* residual, void* dx,
                             void* dr, const BwdApplyParams& p, long long n, int blocks,
                             int threads, cudaStream_t stream) {
  const dim3 grid(blocks, (unsigned)n, (p.w.vecs + p.w.chunk - 1) / p.w.chunk);
  const T* xt = static_cast<const T*>(x);
  const T* gt = static_cast<const T*>(dy);
  if (residual != nullptr) {
    gn_bwd_apply_kernel<T, V, true><<<grid, threads, 0, stream>>>(
        xt, gt, static_cast<const T*>(residual), static_cast<T*>(dx), static_cast<T*>(dr), p);
  } else {
    gn_bwd_apply_kernel<T, V, false><<<grid, threads, 0, stream>>>(
        xt, gt, nullptr, static_cast<T*>(dx), nullptr, p);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Per-(n, c) fp32 mean, mul = rstd * gamma and rstd of x (N, S, C), C
// channels in `groups` groups, into mean/mul/rstd (N, C).  The launch
// follows ops/groupnorm.py plan_moments: route 0 (bulk: x 16-byte aligned,
// C a multiple of V = 16 / esize; rows streamed by bulk copies in stages of
// stage_rows rows), 1 (packed: x 16-byte aligned, C < V dividing V and
// S * C; the walk's rows are the S * C / V 16-byte vectors of a sample,
// stage_rows of them a stage) or 2 (register: any shape); blocks *
// rows_per_block covers the walk's rows of a sample.  part is
// (N, blocks, 2, C) fp32 scratch and tickets (>= N) int32 zeros, left zero
// again.  fold == 0 stops at the per-(n, c) fp32 sum and sum of squares,
// written to mean and mul; gamma, eps and rstd are then unused.
int tmt_gn_moments(const void* x, int dtype, long long n, long long s, int c,
                   int groups, const void* gamma, float eps, int blocks,
                   long long rows_per_block, int route, int stage_rows,
                   void* part, void* tickets, void* mean, void* mul,
                   void* rstd, int fold, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > 65535 || s < 1 || c < 1 || groups < 1 || c % groups || blocks < 1 ||
      (dtype != kBF16 && dtype != kF32))
    return cudaErrorInvalidValue;
  const int wide = dtype == kBF16 ? 8 : 4;  // V
  long long rows = s;
  if (route == kMomentsBulk) {
    if (!aligned16(x) || c % wide) return cudaErrorInvalidValue;
  } else if (route == kMomentsPacked) {
    if (!aligned16(x) || c >= wide || wide % c || (s * c) % wide) return cudaErrorInvalidValue;
    rows = s * c / wide;
  } else if (route != kMomentsRegister) {
    return cudaErrorInvalidValue;
  }
  if ((long long)blocks * rows_per_block < rows) return cudaErrorInvalidValue;
  MomentsParams p{x, static_cast<const float*>(gamma), static_cast<float*>(part),
                  static_cast<int*>(tickets), static_cast<float*>(mean),
                  static_cast<float*>(mul), static_cast<float*>(rstd), s, rows_per_block,
                  c, groups, stage_rows, eps, fold};
  if (dtype == kBF16) return launch_moments_route<__nv_bfloat16, 8>(p, route, n, blocks, st);
  return launch_moments_route<float, 4>(p, route, n, blocks, st);
}

// y = act((x - mean[n,c]) * mul[n,c] + beta[c] (+ residual)), x/residual/y
// (N, S, C) of one dtype, mean/mul (N, C) and beta (C) fp32.
// act: 0 none, 1 ReLU, 2 LeakyReLU(slope), 3 ELU.  residual may be null.
// The launch follows ops/groupnorm.py plan_apply: route 0 (vector: C a
// multiple of V = 16 / esize), 1 (packed: C < V divides V and S * C, one
// vector spans V / C rows) or 2 (scalar, any C); grid (blocks, N, chunks)
// of threads, each block rows_per_block rows of chunk vectors.  The vector
// and packed routes need 16-byte aligned tensors, the vector route 16-byte
// aligned statistics too.
int tmt_gn_apply(const void* x, const void* residual, void* y, const void* mean,
                 const void* mul, const void* beta, int dtype, long long n,
                 long long s, int c, int act, float slope, int route, int blocks,
                 long long rows_per_block, int threads, int chunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ApplyParams p{static_cast<const float*>(mean), static_cast<const float*>(mul),
                static_cast<const float*>(beta), {}, act, slope};
  int v = 0;
  if ((dtype != kBF16 && dtype != kF32) ||
      !apply_walk(route, dtype, n, s, c, blocks, rows_per_block, threads, chunk, p.w, v))
    return cudaErrorInvalidValue;
  if (v > 1 && !(aligned16(x) && aligned16(y) && (residual == nullptr || aligned16(residual))))
    return cudaErrorInvalidValue;
  if (route == kRouteVector && !(aligned16(mean) && aligned16(mul) && aligned16(beta)))
    return cudaErrorInvalidValue;
  if (dtype == kBF16) {
    return v == 8 ? launch_apply<__nv_bfloat16, 8>(x, residual, y, p, n, blocks, threads, st)
                  : launch_apply<__nv_bfloat16, 1>(x, residual, y, p, n, blocks, threads, st);
  }
  return v == 4 ? launch_apply<float, 4>(x, residual, y, p, n, blocks, threads, st)
                : launch_apply<float, 1>(x, residual, y, p, n, blocks, threads, st);
}

// GroupNorm backward, pass 1: from x, dy (and the residual) of (N, S, C)
// and the forward's per-(n, c) mean and rstd, out (4, N, C) fp32 =
// A = sum dz, B = sum dz * xhat, and dx's coefficients coeff_b, coeff_c
// (see gn_bwd_reduce_kernel).  act as in tmt_gn_apply; residual may be null.
// The launch follows ops/groupnorm.py plan_bwd_reduce: route, blocks, rows
// per block, threads and chunk as tmt_gn_apply's (and its alignment
// rules), stage_rows > 0 for the ring (vector or packed route, one chunk a
// row, threads a multiple of 32; one producer warp more).  part is
// (N, blocks, 2, C) fp32 scratch, tickets (>= N) int32 zeros, left zero
// again.  fold == 0 stops at A and B, out (2, N, C).
int tmt_gn_bwd_reduce(const void* x, const void* dy, const void* residual, int dtype,
                      long long n, long long s, int c, int groups, const void* mean,
                      const void* rstd, const void* gamma, const void* beta, int act,
                      float slope, int route, int blocks, long long rows_per_block, int threads,
                      int chunk, int stage_rows, void* part, void* tickets, void* out, int fold,
                      void* stream) {
  BwdParams p{static_cast<const float*>(mean), static_cast<const float*>(rstd),
              static_cast<const float*>(gamma), static_cast<const float*>(beta),
              static_cast<float*>(part), static_cast<int*>(tickets), static_cast<float*>(out),
              {}, 0, 0, 0, act, slope, fold, 0, 0};
  const void* fn = nullptr;
  int block = 0;
  ReduceSmem m{};
  if (!reduce_launch(dtype, n, s, c, groups, residual != nullptr, route, blocks,
                     rows_per_block, threads, chunk, stage_rows, p, fn, block, m))
    return cudaErrorInvalidValue;
  if (route != kRouteScalar &&
      !(aligned16(x) && aligned16(dy) && (residual == nullptr || aligned16(residual))))
    return cudaErrorInvalidValue;
  if (route == kRouteVector &&
      !(aligned16(mean) && aligned16(rstd) && aligned16(gamma) && aligned16(beta)))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_reduce_smem();
  if (err != cudaSuccess) return err;
  void* args[] = {const_cast<void**>(&x), const_cast<void**>(&dy),
                  const_cast<void**>(&residual), &p};
  const dim3 grid(blocks, (unsigned)n, (p.w.vecs + chunk - 1) / chunk);
  err = cudaLaunchKernel(fn, grid, dim3(block), args, m.total,
                         static_cast<cudaStream_t>(stream));
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The reduce's instance for one plan: info[0] registers a thread, info[1]
// blocks an SM can hold, info[2] dynamic shared memory a block (bytes).
int tmt_gn_bwd_reduce_info(int dtype, long long n, long long s, int c, int groups, int residual,
                           int route, int blocks, long long rows_per_block, int threads,
                           int chunk, int stage_rows, int* info) {
  BwdParams p{};
  const void* fn = nullptr;
  int block = 0;
  ReduceSmem m{};
  if (!reduce_launch(dtype, n, s, c, groups, residual != 0, route, blocks, rows_per_block,
                     threads, chunk, stage_rows, p, fn, block, m))
    return cudaErrorInvalidValue;
  cudaError_t err = allow_reduce_smem();
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr{};
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, block, m.total);
  if (err != cudaSuccess) return err;
  info[0] = attr.numRegs;
  info[1] = per_sm;
  info[2] = (int)m.total;
  return cudaSuccess;
}

// GroupNorm backward, pass 2: dx (and dr = dz where residual is not null),
// (N, S, C) in x's dtype, from coef = tmt_gn_bwd_reduce's out.  The launch
// and its requirements are tmt_gn_apply's (dx and dr aligned as x).
int tmt_gn_bwd_apply(const void* x, const void* dy, const void* residual, void* dx,
                     void* dr, int dtype, long long n, long long s, int c,
                     const void* mean, const void* rstd, const void* gamma,
                     const void* beta, const void* coef, int act, float slope, int route,
                     int blocks, long long rows_per_block, int threads, int chunk,
                     void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* cf = static_cast<const float*>(coef);
  BwdApplyParams p{static_cast<const float*>(mean), static_cast<const float*>(rstd),
                   static_cast<const float*>(gamma), static_cast<const float*>(beta),
                   cf + 2 * n * c, cf + 3 * n * c, {}, act, slope};
  int v = 0;
  if ((residual == nullptr) != (dr == nullptr) || (dtype != kBF16 && dtype != kF32) ||
      !apply_walk(route, dtype, n, s, c, blocks, rows_per_block, threads, chunk, p.w, v))
    return cudaErrorInvalidValue;
  if (v > 1 && !(aligned16(x) && aligned16(dy) && aligned16(dx) &&
                 (residual == nullptr || (aligned16(residual) && aligned16(dr)))))
    return cudaErrorInvalidValue;
  if (route == kRouteVector &&
      !(aligned16(mean) && aligned16(rstd) && aligned16(gamma) && aligned16(beta) &&
        aligned16(p.coef_b) && aligned16(p.coef_c)))
    return cudaErrorInvalidValue;
  if (dtype == kBF16) {
    return v == 8 ? launch_bwd_apply<__nv_bfloat16, 8>(x, dy, residual, dx, dr, p, n, blocks,
                                                        threads, st)
                  : launch_bwd_apply<__nv_bfloat16, 1>(x, dy, residual, dx, dr, p, n, blocks,
                                                        threads, st);
  }
  return v == 4 ? launch_bwd_apply<float, 4>(x, dy, residual, dx, dr, p, n, blocks, threads, st)
                : launch_bwd_apply<float, 1>(x, dy, residual, dx, dr, p, n, blocks, threads, st);
}

const char* tmt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
