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
// shift and a mask. to_i8(w, wi) gives the block as 8 words of signed bytes,
// elements 4q..4q+3 in word q, for dot_i8 (once per block, however many
// activation rows it meets). KIND is the code the launchers take (0 = q4_0,
// 1 = q8_0; ops/qmatmul.py KIND_CODE).

struct FmtQ4_0 {   // byte j: element j in the low nibble, j + 16 in the high one
  static constexpr int KIND = 0, BYTES = 16, WORDS = 4;
  __host__ __device__ static constexpr int elem(int t) { return (t & 1) ? 16 + (t >> 1) : t >> 1; }
  __device__ __forceinline__ static float level(const uint32_t (&w)[WORDS], int j) {
    const uint32_t byte = (w[(j & 15) >> 2] >> (8 * (j & 3))) & 0xFFu;
    return (float)((int)(j < 16 ? (byte & 15u) : (byte >> 4)) - 8);
  }
  __device__ __forceinline__ static void to_i8(const uint32_t (&w)[WORDS], int (&wi)[8]) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {   // nibbles to signed bytes: (n & 15) - 8, four at a time
      wi[q] = (int)__vsubss4(w[q] & 0x0F0F0F0Fu, 0x08080808u);
      wi[4 + q] = (int)__vsubss4((w[q] >> 4) & 0x0F0F0F0Fu, 0x08080808u);
    }
  }
};

struct FmtQ8_0 {   // byte j: element j as int8
  static constexpr int KIND = 1, BYTES = 32, WORDS = 8;
  __host__ __device__ static constexpr int elem(int t) { return t; }
  __device__ __forceinline__ static float level(const uint32_t (&w)[WORDS], int j) {
    return (float)((int)(w[j >> 2] << (24 - 8 * (j & 3))) >> 24);
  }
  __device__ __forceinline__ static void to_i8(const uint32_t (&w)[WORDS], int (&wi)[8]) {
#pragma unroll
    for (int q = 0; q < 8; ++q) wi[q] = (int)w[q];
  }
};

// Exact int8 dot of a block (to_i8 words) with 8 words of int8 activations.
__device__ __forceinline__ int dot_i8(const int (&wi)[8], const int* xb) {
  int isum = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) isum = __dp4a(wi[q], xb[q], isum);
  return isum;
}

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

// Stage n floats (n % 32 == 0) from global memory into shared memory as
// [n/32][33]. Loads with __ldcg (L2), so data written earlier in the same
// kernel by other blocks is seen after a grid barrier.
__device__ __forceinline__ void stage_padded(const float* src, int n, float* dst) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[(i >> 5) * 33 + (i & 31)] = __ldcg(src + i);
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

// 1 / rms of x over d values (all threads call it; red holds >= 32 floats).
__device__ __forceinline__ float rms_inv(const float* x, int d, float eps, float* red) {
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) ss = fmaf(x[i], x[i], ss);
  return 1.0f / sqrtf(block_sum(ss, red) / (float)d + eps);
}

// The fused kernels' rmsnorm prologue: dst = x * rsqrt(mean(x^2) + eps) * g,
// staged as [d/32][33] floats; red is a separate 32-float area.
__device__ __forceinline__ void stage_rmsnorm(const float* x, const float* g, int d, float eps,
                                              float* dst, float* red) {
  const float inv = rms_inv(x, d, eps, red);
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    dst[(i >> 5) * 33 + (i & 31)] = x[i] * inv * g[i];
  __syncthreads();
}

// ---- the int8 activation tier (K1, K5, and the i8a modes of K6 and K7) ----

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

// Words per 32-block of int8 activations in shared memory: the block's 8
// words and one of padding, so 32 lanes on consecutive blocks hit 32 banks.
constexpr int XQ_WORDS = 9;

// The int8 tier's prologue inside a fused kernel, with the norm folded in:
// n = x * rsqrt(mean(x^2) + eps) * g as stage_rmsnorm computes it, each
// 32-block of n quantized as quantize_lane does into xq ([d/32][XQ_WORDS]
// words) and xsc ([d/32] scales). Block 0 also writes the int8 row and its
// scales to xq_out / xs_out where those are not null (a check's view of the
// kernel's own activations). All threads call it; it ends with a barrier.
__device__ __forceinline__ void stage_rmsnorm_i8(const float* x, const float* g, int d,
                                                 float eps, int* xq, float* xsc, float* red,
                                                 int8_t* xq_out, float* xs_out) {
  const float inv = rms_inv(x, d, eps, red);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int8_t* xq8 = reinterpret_cast<int8_t*>(xq);
  for (int b = warp; b < d / 32; b += blockDim.x >> 5) {
    const int i = b * 32 + lane;
    float s;
    const int q = quantize_lane(x[i] * inv * g[i], s);
    xq8[b * XQ_WORDS * 4 + lane] = (int8_t)q;
    if (lane == 0) xsc[b] = s;
    if (xq_out != nullptr && blockIdx.x == 0) {
      xq_out[i] = (int8_t)q;
      if (lane == 0) xs_out[b] = s;
    }
  }
  __syncthreads();
}

// R weight rows against MR int8 activation rows in shared memory (row m's
// words at xq + m * xq_row, its scales at xsc + m * xs_row): lane l takes
// blocks l, l+32, ...; each block is loaded and unpacked (to_i8) once and
// dotted exactly with every row, then acc[r][m] += float(isum) * (xs * d), as
// K1 sums. Returns each row's lane partial (the caller reduces over the warp).
template <class F, int R, int MR>
__device__ __forceinline__ void rows_i8(const uint8_t* const (&qs)[R],
                                        const __half* const (&d)[R], const int* xq, int xq_row,
                                        const float* xsc, int xs_row, int nblk, int lane,
                                        float (&acc)[R][MR]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MR; ++m) acc[r][m] = 0.f;
  for (int b = lane; b < nblk; b += 32) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      uint32_t w[F::WORDS];
      load_block<F>(qs[r], b, w);
      int wi[8];
      F::to_i8(w, wi);
      const float sw = __half2float(d[r][b]);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const int isum = dot_i8(wi, xq + m * xq_row + b * XQ_WORDS);
        acc[r][m] = fmaf((float)isum, __fmul_rn(xsc[m * xs_row + b], sw), acc[r][m]);
      }
    }
  }
}

// ---- cooperative launches ----

// Grid-wide barrier of a cooperative launch (cudaLaunchCooperativeKernel
// guarantees that every block is resident, so spinning cannot deadlock).
// `bar` is two words of a workspace that start at 0 and are left at
// (0, generation): bar[0] counts arrivals and is reset by the last block to
// arrive, bar[1] is bumped to release the others. The fences make every write
// issued before the barrier visible to all blocks after it; data written in
// the kernel is read back with __ldcg, never through the read-only path.
__device__ __forceinline__ void grid_barrier(unsigned int* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    volatile unsigned int* gen = bar + 1;
    const unsigned int g = *gen;
    __threadfence();
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (*gen == g) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

constexpr int COOP_BLOCKS_PER_SM = 2;

// Launch kernel(params) cooperatively with as many blocks as the occupancy
// query allows to be resident at once (at most COOP_BLOCKS_PER_SM per SM and
// `max_blocks` in all), so that grid_barrier never waits on a block that
// cannot run.
template <typename P>
inline int launch_cooperative(void (*kernel)(P), int threads, size_t smem, int max_blocks,
                              P params, cudaStream_t st) {
  int rc = allow_dynamic_smem(kernel, smem);
  if (rc != 0) return rc;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (!coop) return (int)cudaErrorNotSupported;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  if (rc != 0) return rc;
  if (per_sm < 1) return ZGML_ERR_SMEM;
  const int per = per_sm < COOP_BLOCKS_PER_SM ? per_sm : COOP_BLOCKS_PER_SM;
  int blocks = sms * per;
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  void* args[] = {&params};
  rc = (int)cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks), dim3(threads), args,
                                        smem, st);
  return rc != 0 ? rc : (int)cudaGetLastError();
}
