// Batched window gather on Hopper: N windows cut from one or two
// channels-last stores at the same int32 windows, each store a volume or a
// stack of subject volumes, with each store's output dtype cast fused in.
//
// Replaces tpu_mednet/ops/pallas/patches.py `extract_patches_pallas` (one
// DMA per patch with scalar-prefetched corners; the same gather is inlined
// in tpu_mednet/inference/device_sliding.py as a vmap'd dynamic_slice, and
// in tpu_mednet/data/device_sampler.py:171-190 as a dynamic_slice of
// images[s] and labels[s] per window, both in one vmapped function).
//
// Bound: pure data movement.  Every output byte is written once and its
// source read once (32 x 96^3 bf16 images + uint8 labels: 170 MB moved,
// 50.7 us at 3.35 TB/s), so memory bandwidth bounds the kernel; at serving
// sizes the launch and the first loads' latency do too.
//
// Design, against what held the earlier row-per-warp gather back:
//  1. One launch for a sampler batch.  The launch takes up to two store
//     descriptors sharing one window table (x, y, z, subject per window);
//     the grid's blocks are split between the stores in proportion to their
//     bytes (planned by ops/patches.py `plan_gather`).
//  2. Work is sized by bytes.  A store's output is N * px * py rows of
//     pz*C contiguous elements (a row longer than a 4 KB piece is cut into
//     pieces), contiguous in output order; a unit is a run of consecutive
//     pieces whose source spans fill a stage of kMaxStageBytes (a whole
//     96^3 bf16 plane, or about two uint8 ones), so every unit of every store
//     moves about as many bytes.  The grid is persistent, about kBlocksPerSM
//     blocks per SM, and each block walks the units of its store with a
//     grid stride.  Both phases index flattened (piece, 16-byte granule) and
//     output granules, so all 256 threads issue loads and stores whatever
//     the row length; their divisions are multiplies and shifts with
//     constants from the host.
//  3. Loads stay in flight.  A ring of kStages shared-memory stages, filled
//     by 16-byte cp.async copies committed as one group per unit: while a
//     unit is written out, the next kStages - 1 units' bytes arrive.  Each
//     piece's load covers its aligned span [floor16(start), ceil16(end)),
//     so reads are whole sectors, and a 16-byte granule that holds a byte of
//     the volume never leaves its allocation's pages.
//  4. No element pass.  Each thread takes one 16-byte granule of the
//     output: where its elements come from one piece, it reads the source
//     bytes from the stage as aligned 16-byte vectors, realigns them to the
//     output's phase in registers (funnel shifts), converts them there if
//     the dtypes differ, and stores one 16-byte vector.  A copy of equal
//     dtypes (uint8 labels, bf16 into bf16) moves bytes and converts
//     nothing.  Only granules that straddle two pieces or the ends of a
//     unit go element by element.
// Windows and subjects are validated by the Python wrapper before the
// launch.
#include <cstring>
#include <type_traits>

#include "common.cuh"

namespace tmt {

// One store's part of a launch.  Elements are the kernel's: bytes for a
// copy of equal dtypes, else the input and output dtypes' elements.  It
// stays outside the anonymous namespace: the C entry takes it, and a type
// of internal linkage would give the entry internal linkage too.
struct GatherStore {
  const void* vol;          // (S, X, Y, Z, C) or (X, Y, Z, C)
  void* out;                // (N, px, py, pz, C)
  long long subject_bytes;  // between subjects of the store (0 for a volume)
  long long line_bytes;     // between y lines: Z * C * input size
  int voxel_bytes;          // C * input size
  int ye;                   // Y
  int in_dtype, out_dtype;  // dtype codes of common.cuh
  int row_len;              // elements of an output row: pz * C
  int piece_len;            // elements of a piece (a row or a part of one)
  int pieces_per_row;
  int pieces_per_unit;      // consecutive pieces a unit loads into one stage
  int in_slot;              // bytes of a piece's slot in a stage, a multiple of 16
  int pieces;               // pieces of the whole output: N * px * py * pieces_per_row
  int blocks;               // blocks of the grid that walk this store
  // fast division by row_len, piece_len, pieces_per_row, in_slot / 16, py
  // and px (indices kDivRow ... kDivPx)
  unsigned int magic[6];
  int shift[6];
};

enum Divisor : int { kDivRow, kDivPiece, kDivPerRow, kDivGranules, kDivPy, kDivPx };

}  // namespace tmt

using namespace tmt;

namespace {

// kMaxStageBytes and kBlocksPerSM must match _STAGE_BYTES and
// _BLOCKS_PER_SM in ops/patches.py
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kMaxStageBytes = 20 * 1024;
constexpr int kBlocksPerSM = 3;
constexpr int kMaxStores = 2;

// copy of equal dtypes, else 1 + 3 * in + out
enum Kind : int {
  kCopy = 0,
  kF32ToBF16 = 2,
  kF32ToF16 = 3,
  kBF16ToF32 = 4,
  kBF16ToF16 = 6,
  kF16ToF32 = 7,
  kF16ToBF16 = 8,
};

struct GatherLaunch {
  GatherStore store[kMaxStores];
  int kind[kMaxStores];
  const int4* windows;  // (N): x, y, z corner and subject
  int px, py, stage_bytes;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(smem))),
               "l"(reinterpret_cast<uint64_t>(gmem))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// NB bytes of shared memory from any byte address into registers: the
// aligned 16-byte vectors that cover them, shifted down by the address's
// phase (word selects, then funnel shifts).  Reads no vector past the one
// holding the last byte.
template <int NB>
__device__ __forceinline__ void load_shifted(const unsigned char* a, uint32_t (&out)[NB / 4]) {
  constexpr int NW = NB / 4;
  constexpr int NV = (NB + 15) / 16 + 1;
  const uintptr_t ai = reinterpret_cast<uintptr_t>(a);
  const uint4* v = reinterpret_cast<const uint4*>(ai & ~uintptr_t(15));
  const int sh = static_cast<int>(ai & 15);
  uint32_t raw[4 * NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    uint4 x = make_uint4(0, 0, 0, 0);
    if (16 * i < sh + NB) x = v[i];
    raw[4 * i] = x.x;
    raw[4 * i + 1] = x.y;
    raw[4 * i + 2] = x.z;
    raw[4 * i + 3] = x.w;
  }
  const int q = sh >> 2;
  const uint32_t bits = (sh & 3) * 8;
  uint32_t w[NW + 1];
#pragma unroll
  for (int i = 0; i <= NW; ++i)
    w[i] = q == 0 ? raw[i] : q == 1 ? raw[i + 1] : q == 2 ? raw[i + 2] : raw[i + 3];
#pragma unroll
  for (int i = 0; i < NW; ++i) out[i] = __funnelshift_r(w[i], w[i + 1], bits);
}

template <typename Tin, typename Tout>
__device__ __forceinline__ Tout convert(Tin v) {
  if constexpr (std::is_same_v<Tin, Tout>) {
    return v;
  } else {
    return from_float<Tout>(to_float(v));
  }
}

// 16 output bytes from the source elements at stage address a
template <typename Tin, typename Tout>
__device__ __forceinline__ uint4 gather16(const unsigned char* a) {
  constexpr int V = 16 / sizeof(Tout);
  constexpr int NB = V * sizeof(Tin);
  uint32_t w[NB / 4];
  load_shifted<NB>(a, w);
  uint4 r;
  if constexpr (std::is_same_v<Tin, Tout>) {
    r = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    Tin in[V];
    Tout o[V];
    memcpy(in, w, NB);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = convert<Tin, Tout>(in[i]);
    memcpy(&r, o, 16);
  }
  return r;
}

// n / d for 0 <= n < 2^31 by a multiply and a shift (magic and shift from
// ops/patches.py `fast_divisor`; magic 0 stands for d = 1)
__device__ __forceinline__ int fdiv(const GatherStore& g, int which, int n) {
  const unsigned int m = g.magic[which];
  return m ? static_cast<int>(__umulhi(static_cast<unsigned int>(n), m) >> g.shift[which]) : n;
}

// piece Q of the store's output, in order: global row R = Q / pieces_per_row
// (window p, x index i, y index r), part j of the row
struct Piece {
  const unsigned char* src;  // its first source byte
  int elem, len;             // its first output element and its length
};

template <typename Tin>
__device__ __forceinline__ Piece piece_at(const GatherStore& g, const GatherLaunch& L, int q) {
  const int row = fdiv(g, kDivPerRow, q);
  const int j0 = (q - row * g.pieces_per_row) * g.piece_len;
  const int plane = fdiv(g, kDivPy, row);
  const int r = row - plane * L.py;
  const int p = fdiv(g, kDivPx, plane);
  const int i = plane - p * L.px;
  const int4 w = L.windows[p];
  const unsigned char* src =
      static_cast<const unsigned char*>(g.vol) + w.w * g.subject_bytes +
      ((long long)(w.x + i) * g.ye + w.y + r) * g.line_bytes + (long long)w.z * g.voxel_bytes +
      (long long)j0 * sizeof(Tin);
  return {src, row * g.row_len + j0, min(g.piece_len, g.row_len - j0)};
}

// a unit's stage: its pieces' slots, then one byte per piece, the 16-byte
// phase of the piece's source
__device__ __forceinline__ unsigned char* phases(const GatherStore& g, unsigned char* stage) {
  return stage + g.pieces_per_unit * g.in_slot;
}

// cp.async of every 16-byte granule of the unit's source spans into its
// stage, a flattened (piece, granule) index per thread
template <typename Tin>
__device__ __forceinline__ void issue(const GatherStore& g, const GatherLaunch& L, int first,
                                      int count, unsigned char* stage) {
  const int granules = g.in_slot >> 4;
  unsigned char* phase = phases(g, stage);
  for (int f = threadIdx.x; f < count * granules; f += kThreads) {
    const int k = fdiv(g, kDivGranules, f);
    const int v = f - k * granules;
    const Piece pc = piece_at<Tin>(g, L, first + k);
    const uintptr_t s = reinterpret_cast<uintptr_t>(pc.src);
    const uintptr_t a = (s & ~uintptr_t(15)) + 16 * v;
    if (v == 0) phase[k] = static_cast<unsigned char>(s & 15);
    if (a < s + pc.len * sizeof(Tin))
      cp_async16(stage + k * g.in_slot + 16 * v, reinterpret_cast<const void*>(a));
  }
}

// the unit's output span (contiguous: its pieces are consecutive) from its
// stage, one 16-byte output granule a thread
template <typename Tin, typename Tout>
__device__ __forceinline__ void store(const GatherStore& g, const GatherLaunch& L, int first,
                                      int count, unsigned char* stage) {
  constexpr int V = 16 / sizeof(Tout);
  const unsigned char* phase = phases(g, stage);
  const Piece p0 = piece_at<Tin>(g, L, first);
  const Piece p1 = piece_at<Tin>(g, L, first + count - 1);
  const uintptr_t base = reinterpret_cast<uintptr_t>(g.out);
  const uintptr_t d = base + (uintptr_t)p0.elem * sizeof(Tout);
  const uintptr_t de = base + (uintptr_t)(p1.elem + p1.len) * sizeof(Tout);
  const uintptr_t da = d & ~uintptr_t(15);
  const int nv = static_cast<int>((de - da + 15) >> 4);
  // the piece of output element e: slot k, e's offset in it, the piece's length
  auto locate = [&](int e, int& k, int& off, int& len) {
    const int row = fdiv(g, kDivRow, e);
    const int c = e - row * g.row_len;
    const int j = fdiv(g, kDivPiece, c);
    off = c - j * g.piece_len;
    len = min(g.piece_len, g.row_len - j * g.piece_len);
    k = row * g.pieces_per_row + j - first;
  };
  auto at = [&](int k, int off) {
    return stage + k * g.in_slot + phase[k] + off * sizeof(Tin);
  };
  for (int v = threadIdx.x; v < nv; v += kThreads) {
    const uintptr_t lo = da + 16 * v;
    const bool full = lo >= d && lo + 16 <= de;
    int k, off, len;
    if (full) {
      locate(static_cast<int>((lo - base) / sizeof(Tout)), k, off, len);
      if (off + V <= len) {
        *reinterpret_cast<uint4*>(lo) = gather16<Tin, Tout>(at(k, off));
        continue;
      }
    }
    // straddles two pieces or an end of the span: element by element
    Tout o[V];
#pragma unroll
    for (int m = 0; m < V; ++m) {
      const uintptr_t b = lo + m * sizeof(Tout);
      if (b < d || b >= de) continue;
      locate(static_cast<int>((b - base) / sizeof(Tout)), k, off, len);
      o[m] = convert<Tin, Tout>(*reinterpret_cast<const Tin*>(at(k, off)));
      if (!full) *reinterpret_cast<Tout*>(b) = o[m];
    }
    if (full) {
      uint4 r;
      memcpy(&r, o, 16);
      *reinterpret_cast<uint4*>(lo) = r;
    }
  }
}

// a block's units of its store: b, b + blocks, ...; the ring holds the
// next kStages - 1 units' loads while one is stored
template <typename Tin, typename Tout>
__device__ void walk(const GatherStore& g, const GatherLaunch& L, int b,
                     unsigned char* smem) {
  const int units = (g.pieces + g.pieces_per_unit - 1) / g.pieces_per_unit;
  const int mine = b < units ? (units - 1 - b) / g.blocks + 1 : 0;
  auto first = [&](int t) { return (b + t * g.blocks) * g.pieces_per_unit; };
  auto count = [&](int t) { return min(g.pieces_per_unit, g.pieces - first(t)); };
#pragma unroll 1
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < mine) issue<Tin>(g, L, first(t), count(t), smem + t * L.stage_bytes);
    cp_async_commit();
  }
#pragma unroll 1
  for (int t = 0; t < mine; ++t) {
    const int next = t + kStages - 1;
    if (next < mine)
      issue<Tin>(g, L, first(next), count(next), smem + (next % kStages) * L.stage_bytes);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    store<Tin, Tout>(g, L, first(t), count(t), smem + (t % kStages) * L.stage_bytes);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    gather_stores_kernel(const GatherLaunch L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const bool second = static_cast<int>(blockIdx.x) >= L.store[0].blocks;
  const GatherStore g = second ? L.store[1] : L.store[0];
  const int b = blockIdx.x - (second ? L.store[0].blocks : 0);
  switch (second ? L.kind[1] : L.kind[0]) {
    case kCopy:
      walk<uint8_t, uint8_t>(g, L, b, smem);
      break;
    case kF32ToBF16:
      walk<float, __nv_bfloat16>(g, L, b, smem);
      break;
    case kF32ToF16:
      walk<float, __half>(g, L, b, smem);
      break;
    case kBF16ToF32:
      walk<__nv_bfloat16, float>(g, L, b, smem);
      break;
    case kBF16ToF16:
      walk<__nv_bfloat16, __half>(g, L, b, smem);
      break;
    case kF16ToF32:
      walk<__half, float>(g, L, b, smem);
      break;
    case kF16ToBF16:
      walk<__half, __nv_bfloat16>(g, L, b, smem);
      break;
  }
}

int kind_of(int in_dtype, int out_dtype) {
  const bool known = in_dtype >= kF32 && in_dtype <= kU8 && out_dtype >= kF32 && out_dtype <= kU8;
  if (!known) return -1;
  if (in_dtype == out_dtype) return kCopy;
  if (in_dtype == kU8 || out_dtype == kU8) return -1;  // labels are copied, never cast
  return 1 + 3 * in_dtype + out_dtype;
}

}  // namespace

extern "C" {

// For each of nstores (1 or 2) store descriptors: out = the windows of the
// store at windows (N, 4) int32 = (x, y, z, subject), cast as the
// descriptor says, in one launch.  The plan fields (pieces, slots,
// divisors, blocks) come from ops/patches.py `plan_gather`; the stage
// holds stage_bytes.  Every extent is at least 1.
int tmt_gather_stores(const GatherStore* stores, int nstores, const void* windows, int px,
                      int py, int stage_bytes, void* stream) {
  if (nstores < 1 || nstores > kMaxStores || px < 1 || py < 1 ||
      stage_bytes < 16 || stage_bytes % 16 || stage_bytes > kMaxStageBytes)
    return cudaErrorInvalidValue;
  GatherLaunch L{};
  long long blocks = 0;
  for (int s = 0; s < nstores; ++s) {
    const GatherStore& g = stores[s];
    L.store[s] = g;
    L.kind[s] = kind_of(g.in_dtype, g.out_dtype);
    if (L.kind[s] < 0 || g.row_len < 1 || g.piece_len < 1 || g.pieces_per_row < 1 ||
        g.pieces_per_unit < 1 || g.in_slot < 16 || g.in_slot % 16 || g.pieces < 1 ||
        (long long)g.pieces_per_unit * (g.in_slot + 1) > stage_bytes || g.blocks < 1)
      return cudaErrorInvalidValue;
    blocks += g.blocks;
  }
  L.windows = static_cast<const int4*>(windows);
  L.px = px;
  L.py = py;
  L.stage_bytes = stage_bytes;
  const int smem = kStages * stage_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      gather_stores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  gather_stores_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(L);
  return cudaGetLastError();
}

}  // extern "C"
