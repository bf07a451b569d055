// Shared helpers of the tpu_mednet_torch kernels: dtype codes, float
// conversion and 16-byte vector loads/stores.
//
// Built by tpu_mednet_torch/ops/_build.py with plain nvcc into one shared
// library with a C interface (no PyTorch headers), loaded with ctypes.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace tmt {

// Must match DTYPE_CODES in tpu_mednet_torch/ops/_build.py.  kU8 (label
// volumes) is only ever copied, never converted to or from a float type.
enum DType : int { kF32 = 0, kBF16 = 1, kF16 = 2, kU8 = 3 };

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) { return __float2half_rn(v); }

// V consecutive elements <-> float[V].  V is 1 (scalar access) or
// 16 / sizeof(T) (one 16-byte access; the pointer must be 16-byte aligned).
template <typename T, int V>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[V]) {
  if constexpr (V == 1) {
    out[0] = to_float(*p);
  } else {
    static_assert(V * sizeof(T) == 16, "vector accesses are 16 bytes");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) out[i] = to_float(e[i]);
  }
}

template <typename T, int V>
__device__ __forceinline__ void store_vec(T* p, const float (&in)[V]) {
  if constexpr (V == 1) {
    *p = from_float<T>(in[0]);
  } else {
    static_assert(V * sizeof(T) == 16, "vector accesses are 16 bytes");
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < V; ++i) e[i] = from_float<T>(in[i]);
    *reinterpret_cast<uint4*>(p) = raw;
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15u) == 0;
}

}  // namespace tmt
