// Shared helpers for the port's CUDA kernels (built for sm_90a by
// zgml_tpu_torch/ops/build.py into one shared library with a plain C
// interface, loaded with ctypes).
//
// Every exported launcher returns 0 on success, a cudaError_t value when the
// launch was refused, or one of the negative codes below when the arguments
// are outside what the kernel takes. The Python wrapper raises on any
// non-zero value (zgml_error_string gives the text).
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <type_traits>

#define ZGML_EXPORT extern "C" __attribute__((visibility("default")))

enum ZgmlStatus : int {
  ZGML_ERR_SHAPE = -1,      // a dimension is zero, negative or not a multiple the kernel needs
  ZGML_ERR_HEAD_DIM = -2,   // head_dim without a compiled instantiation
  ZGML_ERR_SMEM = -3,       // the tile does not fit the card's shared memory
  ZGML_ERR_KIND = -4,       // weight kind without a compiled instantiation
};

// bf16 pair packed in one 32-bit word -> two floats (exact: bf16 is the top
// half of an f32)
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xFFFF0000u); }

// The barrier of a whole block (decode_split.cuh takes another for a part of one).
struct BlockSync {
  __device__ __forceinline__ static void sync() { __syncthreads(); }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, off);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, off));
  return v;
}

// Allow `bytes` of dynamic shared memory for `kernel` (above 48 KB it must be
// asked for); returns a status like the launchers.
template <typename K>
inline int allow_dynamic_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (bytes > (size_t)optin) return ZGML_ERR_SMEM;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)bytes);
}

// ---- block formats of the port's N-major GGUF-order weights ----------------
//
// (zgml_tpu_torch/quant/packed.py.) A weight row of K values is K/32 blocks;
// block b of a row is BYTES bytes of qs at row + b * BYTES (16-byte aligned,
// read as BYTES/16 uint4 loads into WORDS words) and one fp16 scale d[b].
// elem(t) is the element the t-th step of a block's f32 dot takes (Q4_0 pairs
// the two nibbles of a byte, j and j + 16; Q8_0 goes in order).
// level(w, j) is element j's integer level (natural order) as a float, which
// the caller scales by d; with j a constant after unrolling it compiles to a
// shift and a mask. KIND is the code the launchers take (0 = q4_0, 1 = q8_0;
// ops/qmatmul.py KIND_CODE).

struct FmtQ4_0 {   // byte j: element j in the low nibble, j + 16 in the high one
  static constexpr int KIND = 0, BYTES = 16, WORDS = 4;
  __host__ __device__ static constexpr int elem(int t) { return (t & 1) ? 16 + (t >> 1) : t >> 1; }
  __device__ __forceinline__ static float level(const uint32_t (&w)[WORDS], int j) {
    const uint32_t byte = (w[(j & 15) >> 2] >> (8 * (j & 3))) & 0xFFu;
    return (float)((int)(j < 16 ? (byte & 15u) : (byte >> 4)) - 8);
  }
};

struct FmtQ8_0 {   // byte j: element j as int8
  static constexpr int KIND = 1, BYTES = 32, WORDS = 8;
  __host__ __device__ static constexpr int elem(int t) { return t; }
  __device__ __forceinline__ static float level(const uint32_t (&w)[WORDS], int j) {
    return (float)((int)(w[j >> 2] << (24 - 8 * (j & 3))) >> 24);
  }
};

// Run `body` with F = the format of kind code `kind`; ZGML_ERR_KIND otherwise.
#define ZGML_DISPATCH_KIND(kind, ...)                  \
  switch (kind) {                                      \
    case 0: { using F = FmtQ4_0; __VA_ARGS__; }        \
    case 1: { using F = FmtQ8_0; __VA_ARGS__; }        \
    default: return ZGML_ERR_KIND;                     \
  }

template <class F>
__device__ __forceinline__ void load_block(const uint8_t* row, int b, uint32_t (&w)[F::WORDS]) {
  const uint4* p = reinterpret_cast<const uint4*>(row) + (size_t)b * (F::BYTES / 16);
#pragma unroll
  for (int i = 0; i < F::BYTES / 16; ++i) {
    const uint4 v = __ldg(p + i);
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
}

// Sum over one 32-block of level_j * x_j in F::elem order, x the block's 32
// floats in shared memory (the caller scales it by the block's d).
template <class F>
__device__ __forceinline__ float block_dot_f32(const uint32_t (&w)[F::WORDS], const float* xb) {
  float sum = 0.f;
#pragma unroll
  for (int t = 0; t < 32; ++t) sum = fmaf(F::level(w, F::elem(t)), xb[F::elem(t)], sum);
  return sum;
}

// R output rows of a warp-per-row GEMV against x staged in shared memory as
// [K/32][33] floats (one padding word per block, so the 32 lanes, each on its
// own block, hit 32 banks). Lane l takes blocks l, l+32, ...; returns each
// row's lane partial in acc (the caller reduces over the warp).
template <class F, int R>
__device__ __forceinline__ void rows_f32(const uint8_t* const (&qs)[R],
                                         const __half* const (&d)[R], const float* xs,
                                         int nblk, int lane, float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int b = lane; b < nblk; b += 32) {
    uint32_t w[R][F::WORDS];
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      load_block<F>(qs[r], b, w[r]);
      s[r] = __half2float(d[r][b]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(block_dot_f32<F>(w[r], xs + b * 33), s[r], acc[r]);
  }
}

// Sum of v over the block (all threads call it; red holds >= 32 floats).
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  v = warp_sum(v);
  __syncthreads();                        // red may still be read by a previous call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  return t;
}

// ---- the int8 activation tier (K1's pre-pass and the i8a modes of K6 and K7;
// K1 and K5 quantize in their launch by qmatmul_i8.cu quantize_thread) ----

// The JAX `_quantize_act` (zgml_tpu/ops/qmatmul.py:181-190) of one 32-block
// held one element per lane of a warp: s = amax / 127, inv = 1 / s (0 when
// s == 0), q = clip(rint(v * inv), -127, 127), rounding half to even. True
// division and no fast math (ops/build.py), so q and s are bit-equal to the
// JAX package's. Returns q; every lane gets s.
__device__ __forceinline__ int quantize_lane(float v, float& s) {
  const float amax = warp_max(fabsf(v));
  s = amax / 127.0f;
  const float inv = s > 0.f ? 1.0f / s : 0.f;
  return (int)fminf(fmaxf(rintf(v * inv), -127.f), 127.f);
}

