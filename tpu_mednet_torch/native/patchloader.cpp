// Native batch-assembly core of the port's host training input pipeline.
//
// The port's own copy of tpu_mednet/native/patchloader.cpp (the JAX
// package's counterpart of the reference's C++ DataLoader workers): the
// hot per-batch host work -- crop, f16->f32 conversion, and the
// (C,X,Y,Z) -> (X,Y,Z,C) channels-last layout transform -- runs in ONE
// fused native pass per sample.  The Python side
// (tpu_mednet_torch/data/native_loader.py) drives it from the producer
// thread of data/prefetch.py's device_prefetch; ctypes releases the GIL
// for the whole call, so assembly of batch N+1 overlaps the card's step on
// batch N.  The outputs may be pinned host tensors, copied to the card
// asynchronously afterwards.
//
// The arithmetic is the JAX package's, byte for byte, so both packages'
// batches are equal.  One repair: half_table() fills its table inside a
// function-local static initializer, which C++11 runs exactly once even
// when two loader threads call it together (the original filled a static
// array behind an unsynchronized pointer check).
//
// Contract (mirrors PatchSampler.sample / batches,
// tpu_mednet_torch/data/patch_sampler.py):
//   - images stored (C, X, Y, Z) float16  -> out_data  (N, px,py,pz, C) f32
//   - labels stored (Cl,X, Y, Z) uint8   --+
//   - heatmaps     (Ch,X, Y, Z) uint8 or  +-> out_label (N, px,py,pz, Ch+Cl)
//     null                                    heatmap channels FIRST,
//                                             class map LAST (dataset.py:322-330)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC (tpu_mednet_torch/native/__init__.py).

#include <cstdint>
#include <cstring>

namespace {

// f16 -> f32 via a one-time 65536-entry table: branch-free inner loop,
// 256 KiB (resident after first touch).  The table is static storage filled
// by the lambda that initializes `table`: a function-local static, so the
// fill runs once and a concurrent first call waits for it.
const float* half_table() {
    static const float* const table = [] {
        static float storage[65536];
        for (uint32_t h = 0; h < 65536; ++h) {
            uint32_t sign = (h & 0x8000u) << 16;
            uint32_t exp = (h >> 10) & 0x1Fu;
            uint32_t mant = h & 0x3FFu;
            uint32_t bits;
            if (exp == 0) {
                if (mant == 0) {
                    bits = sign;  // +-0
                } else {
                    // subnormal: normalize
                    int e = -1;
                    uint32_t m = mant;
                    do { m <<= 1; ++e; } while (!(m & 0x400u));
                    bits = sign | ((127 - 15 - e) << 23) | ((m & 0x3FFu) << 13);
                }
            } else if (exp == 0x1Fu) {
                bits = sign | 0x7F800000u | (mant << 13);  // inf / nan
            } else {
                bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
            }
            float f;
            std::memcpy(&f, &bits, sizeof(f));
            storage[h] = f;
        }
        return static_cast<const float*>(storage);
    }();
    return table;
}

}  // namespace

extern "C" {

// Assemble one channels-last training batch straight from the preloaded
// (C,X,Y,Z) volumes.  Per-sample volume pointers + dims allow subjects of
// different shapes in one batch.  All index math is int64.
//
//   img_ptrs[n]   f16 volumes, dims img_dims[4*i..] = (C,X,Y,Z)
//   lbl_ptrs[n]   u8 class-map volumes, dims lbl_dims[4*i..]
//   hm_ptrs[n]    u8 heatmap volumes (may be null), dims hm_dims[4*i..]
//   corners[3*i]  patch corner (x,y,z) per sample
//   out_data      (n, px,py,pz, Cimg) float32, C contiguous (minor)
//   out_label     (n, px,py,pz, Chm+Clbl) uint8, heatmaps first
void assemble_batch(
    int64_t n,
    const uint16_t** img_ptrs, const int64_t* img_dims,
    const uint8_t** lbl_ptrs, const int64_t* lbl_dims,
    const uint8_t** hm_ptrs, const int64_t* hm_dims,
    const int64_t* corners,
    int64_t px, int64_t py, int64_t pz,
    float* out_data, uint8_t* out_label) {
    const float* h2f = half_table();

    for (int64_t i = 0; i < n; ++i) {
        const int64_t cx = corners[3 * i], cy = corners[3 * i + 1],
                      cz = corners[3 * i + 2];

        // ---- image: f16 (C,X,Y,Z) crop -> f32 (px,py,pz,C) ----
        {
            const uint16_t* vol = img_ptrs[i];
            const int64_t C = img_dims[4 * i];
            const int64_t VY = img_dims[4 * i + 2], VZ = img_dims[4 * i + 3];
            const int64_t VX = img_dims[4 * i + 1];
            float* out = out_data + i * (px * py * pz * C);
            for (int64_t x = 0; x < px; ++x)
                for (int64_t y = 0; y < py; ++y)
                    for (int64_t c = 0; c < C; ++c) {
                        const uint16_t* src = vol
                            + ((c * VX + (cx + x)) * VY + (cy + y)) * VZ
                            + cz;
                        float* dst = out + ((x * py + y) * pz) * C + c;
                        for (int64_t z = 0; z < pz; ++z)
                            dst[z * C] = h2f[src[z]];
                    }
        }

        // ---- label: u8 heatmaps (first) + class map (last) ----
        const int64_t Chm = hm_ptrs && hm_ptrs[i] ? hm_dims[4 * i] : 0;
        const int64_t Clbl = lbl_dims[4 * i];
        const int64_t Cout = Chm + Clbl;
        uint8_t* out = out_label + i * (px * py * pz * Cout);

        if (Chm) {
            const uint8_t* vol = hm_ptrs[i];
            const int64_t VX = hm_dims[4 * i + 1], VY = hm_dims[4 * i + 2],
                          VZ = hm_dims[4 * i + 3];
            for (int64_t x = 0; x < px; ++x)
                for (int64_t y = 0; y < py; ++y)
                    for (int64_t c = 0; c < Chm; ++c) {
                        const uint8_t* src = vol
                            + ((c * VX + (cx + x)) * VY + (cy + y)) * VZ
                            + cz;
                        uint8_t* dst = out + ((x * py + y) * pz) * Cout + c;
                        for (int64_t z = 0; z < pz; ++z)
                            dst[z * Cout] = src[z];
                    }
        }
        {
            const uint8_t* vol = lbl_ptrs[i];
            const int64_t VX = lbl_dims[4 * i + 1], VY = lbl_dims[4 * i + 2],
                          VZ = lbl_dims[4 * i + 3];
            for (int64_t x = 0; x < px; ++x)
                for (int64_t y = 0; y < py; ++y)
                    for (int64_t c = 0; c < Clbl; ++c) {
                        const uint8_t* src = vol
                            + ((c * VX + (cx + x)) * VY + (cy + y)) * VZ
                            + cz;
                        uint8_t* dst =
                            out + ((x * py + y) * pz) * Cout + Chm + c;
                        for (int64_t z = 0; z < pz; ++z)
                            dst[z * Cout] = src[z];
                    }
        }
    }
}

}  // extern "C"
