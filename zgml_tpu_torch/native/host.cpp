// The port's native host library: the GGUF Q4_0 / Q8_0 block codecs in C++
// with OpenMP, bit-equal to quant/blocks.py's numpy codecs.
//
// Counterpart of zgml_tpu/native/host.cpp (its quantize_q8_0, quantize_q4_0,
// dequant_q8_0 and dequant_q4_0, host.cpp:136-214, with its f16
// conversions but one: its f16_to_f32 gives a subnormal f16 the exponent
// 127 - 15 - shift, half its value, so a block whose scale is subnormal
// (Q8_0 blocks of absmax under 127 * 2^-14) quantizes and dequantizes
// against half the scale numpy uses; here the exponent is 127 - 14 - shift). The JAX file also repacks GGUF blocks into the TPU's planar
// K-major layout (q4_repack / q8_repack); the port keeps the GGUF block order
// (quant/packed.py), so it has no repack.
//
// Layouts:
//   Q8_0 block: [f16 scale][32 int8]            (34 bytes / 32 elements)
//   Q4_0 block: [f16 scale][16 nibble bytes]    (18 bytes / 32 elements),
//               byte j holds element j (low nibble) and j + 16 (high)
//
// Build (native/__init__.py, at first use, into config.build_dir()):
//   g++ -O3 -march=native -ffp-contract=off -fopenmp -shared -fPIC host.cpp
// -ffp-contract=off: with -march=native GCC may fuse `x * inv + 8.5f` into an
// FMA, which rounds once where numpy rounds twice; the codecs must give
// numpy's bytes on any host.

#include <cstdint>
#include <cstring>
#include <cmath>

namespace {

// f16 -> f32 (scalar; scales only, not hot)
float f16_to_f32(uint16_t h) {
    uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
    uint32_t exp = (h >> 10) & 0x1F;
    uint32_t mant = h & 0x3FF;
    uint32_t bits;
    if (exp == 0) {
        if (mant == 0) {
            bits = sign;
        } else {  // subnormal: mant * 2^-24 = 1.f * 2^(-14 - shift)
            int shift = 0;
            while (!(mant & 0x400)) { mant <<= 1; ++shift; }
            mant &= 0x3FF;
            bits = sign | ((127 - 14 - shift) << 23) | (mant << 13);
        }
    } else if (exp == 31) {
        bits = sign | 0x7F800000u | (mant << 13);
    } else {
        bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
    }
    float out;
    std::memcpy(&out, &bits, 4);
    return out;
}

uint16_t f32_to_f16(float f) {
    uint32_t bits;
    std::memcpy(&bits, &f, 4);
    uint32_t sign = (bits >> 16) & 0x8000u;
    int32_t exp = (int32_t)((bits >> 23) & 0xFF) - 127 + 15;
    uint32_t mant = bits & 0x7FFFFF;
    if (exp <= 0) {
        if (exp < -10) return (uint16_t)sign;
        mant |= 0x800000;
        uint32_t shifted = mant >> (1 - exp + 13);
        // round to nearest even
        uint32_t rem = mant & ((1u << (1 - exp + 13)) - 1);
        uint32_t half = 1u << (1 - exp + 12);
        if (rem > half || (rem == half && (shifted & 1))) shifted++;
        return (uint16_t)(sign | shifted);
    }
    if (exp >= 31) return (uint16_t)(sign | 0x7C00u);
    uint32_t out = sign | ((uint32_t)exp << 10) | (mant >> 13);
    uint32_t rem = mant & 0x1FFF;
    if (rem > 0x1000 || (rem == 0x1000 && (out & 1))) out++;
    return (uint16_t)out;
}

constexpr int QK = 32;
constexpr int Q8_BYTES = 34;
constexpr int Q4_BYTES = 18;

}  // namespace

extern "C" {

// f32 [nblocks*32] -> raw Q8_0 bytes (ggml semantics: d = absmax/127)
void quantize_q8_0(const float* x, int64_t nblocks, uint8_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const float* src = x + b * QK;
        uint8_t* dst = out + b * Q8_BYTES;
        float amax = 0.f;
        for (int i = 0; i < QK; ++i) {
            float a = std::fabs(src[i]);
            if (a > amax) amax = a;
        }
        uint16_t h = f32_to_f16(amax / 127.0f);
        float d = f16_to_f32(h);
        float inv = d > 0.f ? 1.0f / d : 0.0f;
        std::memcpy(dst, &h, 2);
        int8_t* q = (int8_t*)(dst + 2);
        for (int i = 0; i < QK; ++i) {
            float v = std::nearbyint(src[i] * inv);
            if (v > 127.f) v = 127.f;
            if (v < -128.f) v = -128.f;
            q[i] = (int8_t)v;
        }
    }
}

// f32 -> raw Q4_0 (ggml: d = signed-absmax/-8, q = floor(x*inv + 8.5))
void quantize_q4_0(const float* x, int64_t nblocks, uint8_t* out) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const float* src = x + b * QK;
        uint8_t* dst = out + b * Q4_BYTES;
        float amax = 0.f, maxv = 0.f;
        for (int i = 0; i < QK; ++i) {
            float a = std::fabs(src[i]);
            if (a > amax) { amax = a; maxv = src[i]; }
        }
        uint16_t h = f32_to_f16(maxv / -8.0f);
        float d = f16_to_f32(h);
        float inv = d != 0.f ? 1.0f / d : 0.0f;
        std::memcpy(dst, &h, 2);
        uint8_t* nib = dst + 2;
        for (int i = 0; i < 16; ++i) {
            int lo = (int)(src[i] * inv + 8.5f);
            int hi = (int)(src[i + 16] * inv + 8.5f);
            if (lo < 0) lo = 0; if (lo > 15) lo = 15;
            if (hi < 0) hi = 0; if (hi > 15) hi = 15;
            nib[i] = (uint8_t)(lo | (hi << 4));
        }
    }
}

void dequant_q8_0(const uint8_t* raw, int64_t nblocks, float* out) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* src = raw + b * Q8_BYTES;
        uint16_t h;
        std::memcpy(&h, src, 2);
        float d = f16_to_f32(h);
        const int8_t* q = (const int8_t*)(src + 2);
        float* dst = out + b * QK;
        for (int i = 0; i < QK; ++i) dst[i] = q[i] * d;
    }
}

void dequant_q4_0(const uint8_t* raw, int64_t nblocks, float* out) {
#pragma omp parallel for schedule(static)
    for (int64_t b = 0; b < nblocks; ++b) {
        const uint8_t* src = raw + b * Q4_BYTES;
        uint16_t h;
        std::memcpy(&h, src, 2);
        float d = f16_to_f32(h);
        const uint8_t* nib = src + 2;
        float* dst = out + b * QK;
        for (int i = 0; i < 16; ++i) {
            dst[i] = (float)((int)(nib[i] & 0x0F) - 8) * d;
            dst[i + 16] = (float)((int)(nib[i] >> 4) - 8) * d;
        }
    }
}

}  // extern "C"
