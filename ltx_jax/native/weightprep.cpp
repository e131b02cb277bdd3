// Native host-side weight preparation for ltx-jax.
//
// Why this exists: loading a real checkpoint runs every linear weight
// through (out,in)->(in,out) transpose + quantization on the HOST (the
// unquantized bf16 tree is never staged through device memory — see
// weights/keymaps.py). numpy's ml_dtypes bfloat16 ufuncs take scalar-loop
// paths (tens of seconds per large layer, about an hour for the full
// DiT). These fused single-pass kernels do the same work at memory
// bandwidth. Results are BIT-EXACT vs the numpy twins in
// kernels/quantization.py (same f32 expression forms, round-half-to-even
// via nearbyintf, fma contraction disabled at build: -ffp-contract=off);
// tests/test_native.py asserts exact equality.
//
// The reference performs the analogous load-time work natively too (MLX's
// C++ core under ModelDownloader.swift's sanitize/quantize passes); this
// is this framework's equivalent host runtime component.
//
// Layout contracts (must match kernels/quantization.py):
//   - weights are (d_in, d_out) row-major after transpose;
//   - group quantization groups along d_in (axis 0), stats per (group, out);
//   - int4 packing is BLOCK-PLANE (pack_int4, PACK_BLOCK=256): within each
//     block of `blk` rows, packed[b*half + r] = q[b*blk + r] | q[b*blk +
//     half + r] << 4, blk = pack_block if d_in % pack_block == 0 else d_in.

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

static inline float bf16_to_f32(uint16_t h) {
    uint32_t bits = (uint32_t)h << 16;
    float out;
    std::memcpy(&out, &bits, sizeof(out));
    return out;
}

// Read row `r` of an (d_in, d_out) source into an f32 scratch row.
static inline void load_row_f32(const void* src, int is_bf16, int64_t r,
                                int64_t d_out, float* row) {
    if (is_bf16) {
        const uint16_t* p = (const uint16_t*)src + r * d_out;
        for (int64_t c = 0; c < d_out; ++c) row[c] = bf16_to_f32(p[c]);
    } else {
        const float* p = (const float*)src + r * d_out;
        std::memcpy(row, p, (size_t)d_out * sizeof(float));
    }
}

// ---------------------------------------------------------------------------
// Cache-blocked 2D transpose for 2- and 4-byte elements (bf16/f16/u16, f32/
// u32). src is (rows, cols) row-major; dst is (cols, rows) row-major.
// ---------------------------------------------------------------------------

template <typename T>
static void transpose_impl(const T* src, T* dst, int64_t rows, int64_t cols) {
    const int64_t B = 64;  // 64x64 tiles: 8/16 KB — L1-resident
    for (int64_t i0 = 0; i0 < rows; i0 += B) {
        int64_t i1 = std::min(i0 + B, rows);
        for (int64_t j0 = 0; j0 < cols; j0 += B) {
            int64_t j1 = std::min(j0 + B, cols);
            for (int64_t i = i0; i < i1; ++i) {
                const T* s = src + i * cols;
                for (int64_t j = j0; j < j1; ++j) {
                    dst[j * rows + i] = s[j];
                }
            }
        }
    }
}

extern "C" void lt_transpose1(const void* src, void* dst, int64_t rows, int64_t cols) {
    transpose_impl((const uint8_t*)src, (uint8_t*)dst, rows, cols);
}

extern "C" void lt_transpose2(const void* src, void* dst, int64_t rows, int64_t cols) {
    transpose_impl((const uint16_t*)src, (uint16_t*)dst, rows, cols);
}

extern "C" void lt_transpose4(const void* src, void* dst, int64_t rows, int64_t cols) {
    transpose_impl((const uint32_t*)src, (uint32_t*)dst, rows, cols);
}

extern "C" void lt_bf16_to_f32(const uint16_t* src, float* dst, int64_t n) {
    for (int64_t i = 0; i < n; ++i) dst[i] = bf16_to_f32(src[i]);
}

extern "C" void lt_f32_to_bf16(const float* src, uint16_t* dst, int64_t n) {
    // Round-to-nearest-even, matching ml_dtypes / XLA f32->bf16 casts
    // (NaN payloads preserved via the quiet bit).
    for (int64_t i = 0; i < n; ++i) {
        uint32_t bits;
        std::memcpy(&bits, &src[i], sizeof(bits));
        if ((bits & 0x7fffffffu) > 0x7f800000u) {  // NaN: keep quiet
            dst[i] = (uint16_t)((bits >> 16) | 0x0040u);
        } else {
            uint32_t rounding = 0x7fffu + ((bits >> 16) & 1u);
            dst[i] = (uint16_t)((bits + rounding) >> 16);
        }
    }
}

// ---------------------------------------------------------------------------
// Asymmetric group quantization (quantize_weight / _quantize_weight_np):
//   wf (f32 from src) grouped as (d_in/group, group, d_out);
//   scale = (max - min) / (2^bits - 1), 0 -> 1;  q = clip(rint((wf-min)/s)).
// bits == 8 -> wq is (d_in, d_out) uint8; bits == 4 -> block-plane packed
// (d_in/2, d_out). scale/bias are (d_in/group, d_out) f32.
// ---------------------------------------------------------------------------

extern "C" void lt_quant_group(const void* src, int src_is_bf16, int64_t d_in,
                    int64_t d_out, int64_t group, int bits,
                    int64_t pack_block, uint8_t* wq, float* scale,
                    float* bias) {
    const float levels = (float)((1 << bits) - 1);
    std::vector<float> row((size_t)d_out);
    std::vector<float> wmin((size_t)d_out), wmax((size_t)d_out);
    // q8 staging only for the int4 pack (rows of a pack block span multiple
    // groups, so packing can't fuse into the per-group loop)
    std::vector<uint8_t> q8;
    if (bits == 4) q8.resize((size_t)d_in * (size_t)d_out);
    uint8_t* qdst = (bits == 4) ? q8.data() : wq;

    const int64_t n_groups = d_in / group;
    for (int64_t g = 0; g < n_groups; ++g) {
        // pass 1: per-column min/max over the group's rows
        load_row_f32(src, src_is_bf16, g * group, d_out, row.data());
        std::memcpy(wmin.data(), row.data(), (size_t)d_out * sizeof(float));
        std::memcpy(wmax.data(), row.data(), (size_t)d_out * sizeof(float));
        for (int64_t r = 1; r < group; ++r) {
            load_row_f32(src, src_is_bf16, g * group + r, d_out, row.data());
            for (int64_t c = 0; c < d_out; ++c) {
                float v = row[c];
                wmin[c] = v < wmin[c] ? v : wmin[c];
                wmax[c] = v > wmax[c] ? v : wmax[c];
            }
        }
        float* sg = scale + g * d_out;
        float* bg = bias + g * d_out;
        for (int64_t c = 0; c < d_out; ++c) {
            float s = (wmax[c] - wmin[c]) / levels;
            sg[c] = (s == 0.0f) ? 1.0f : s;
            bg[c] = wmin[c];
        }
        // pass 2: quantize
        for (int64_t r = 0; r < group; ++r) {
            load_row_f32(src, src_is_bf16, g * group + r, d_out, row.data());
            uint8_t* q = qdst + (g * group + r) * d_out;
            for (int64_t c = 0; c < d_out; ++c) {
                float v = nearbyintf((row[c] - bg[c]) / sg[c]);
                v = v < 0.0f ? 0.0f : (v > levels ? levels : v);
                q[c] = (uint8_t)v;
            }
        }
    }

    if (bits == 4) {
        const int64_t blk =
            (pack_block > 0 && d_in % pack_block == 0) ? pack_block : d_in;
        const int64_t half = blk / 2;
        for (int64_t b = 0; b < d_in / blk; ++b) {
            for (int64_t r = 0; r < half; ++r) {
                const uint8_t* lo = q8.data() + (b * blk + r) * d_out;
                const uint8_t* hi = q8.data() + (b * blk + half + r) * d_out;
                uint8_t* p = wq + (b * half + r) * d_out;
                for (int64_t c = 0; c < d_out; ++c)
                    p[c] = (uint8_t)(lo[c] | (hi[c] << 4));
            }
        }
    }
}

// ---------------------------------------------------------------------------
// Per-output-channel symmetric int8 (requant_int8_channel_np raw-weight
// case): sw = absmax(col)/127 (0 -> 1); w8 = clip(rint(w/sw), -127, 127).
// ---------------------------------------------------------------------------

extern "C" void lt_quant_int8_channel(const void* src, int src_is_bf16, int64_t d_in,
                           int64_t d_out, int8_t* w8, float* sw) {
    std::vector<float> row((size_t)d_out);
    std::vector<float> amax((size_t)d_out, 0.0f);
    for (int64_t r = 0; r < d_in; ++r) {
        load_row_f32(src, src_is_bf16, r, d_out, row.data());
        for (int64_t c = 0; c < d_out; ++c) {
            float a = std::fabs(row[c]);
            amax[c] = a > amax[c] ? a : amax[c];
        }
    }
    for (int64_t c = 0; c < d_out; ++c) {
        float s = amax[c] / 127.0f;
        sw[c] = (s == 0.0f) ? 1.0f : s;
    }
    for (int64_t r = 0; r < d_in; ++r) {
        load_row_f32(src, src_is_bf16, r, d_out, row.data());
        int8_t* o = w8 + r * d_out;
        for (int64_t c = 0; c < d_out; ++c) {
            float v = nearbyintf(row[c] / sw[c]);
            v = v < -127.0f ? -127.0f : (v > 127.0f ? 127.0f : v);
            o[c] = (int8_t)v;
        }
    }
}

// ---------------------------------------------------------------------------
// Fused int4-group -> per-channel int8 requant (requant_int8_channel_np on a
// quantized dict): dequantizes block-plane-packed int4 on the fly
// (v = q*scale + bias, MUL-then-ADD exactly like dequantize_weight_np —
// build disables fp contraction) and runs the absmax/quantize passes without
// materializing the (d_in, d_out) f32 tree (268 MB+/layer saved).
// ---------------------------------------------------------------------------

// Dequantize row r of the packed tensor into `row`.
static inline void dequant_row_int4(const uint8_t* packed, const float* scale,
                                    const float* bias, int64_t r,
                                    int64_t d_out, int64_t group, int64_t blk,
                                    float* row) {
    const int64_t half = blk / 2;
    const int64_t b = r / blk, i = r % blk;
    const uint8_t* p = packed + (b * half + (i % half)) * d_out;
    const int hi = i >= half;
    const float* sg = scale + (r / group) * d_out;
    const float* bg = bias + (r / group) * d_out;
    for (int64_t c = 0; c < d_out; ++c) {
        float q = (float)(hi ? (p[c] >> 4) : (p[c] & 0x0F));
        float v = q * sg[c];  // separate mul/add: matches numpy (no fma)
        row[c] = v + bg[c];
    }
}

extern "C" void lt_requant_int8_from_int4(const uint8_t* packed, const float* scale,
                               const float* bias, int64_t d_in, int64_t d_out,
                               int64_t group, int64_t pack_block, int8_t* w8,
                               float* sw) {
    const int64_t blk =
        (pack_block > 0 && d_in % pack_block == 0) ? pack_block : d_in;
    std::vector<float> row((size_t)d_out);
    std::vector<float> amax((size_t)d_out, 0.0f);
    for (int64_t r = 0; r < d_in; ++r) {
        dequant_row_int4(packed, scale, bias, r, d_out, group, blk,
                         row.data());
        for (int64_t c = 0; c < d_out; ++c) {
            float a = std::fabs(row[c]);
            amax[c] = a > amax[c] ? a : amax[c];
        }
    }
    for (int64_t c = 0; c < d_out; ++c) {
        float s = amax[c] / 127.0f;
        sw[c] = (s == 0.0f) ? 1.0f : s;
    }
    for (int64_t r = 0; r < d_in; ++r) {
        dequant_row_int4(packed, scale, bias, r, d_out, group, blk,
                         row.data());
        int8_t* o = w8 + r * d_out;
        for (int64_t c = 0; c < d_out; ++c) {
            float v = nearbyintf(row[c] / sw[c]);
            v = v < -127.0f ? -127.0f : (v > 127.0f ? 127.0f : v);
            o[c] = (int8_t)v;
        }
    }
}

