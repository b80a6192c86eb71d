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

// ---- f32-dequant Q4_0 GEMV pieces (the port's N-major GGUF-order weight) ----

// Sum over one 32-block of (nibble - 8) * x, x the block's 32 floats in
// shared memory (the caller scales it by the block's d, as K2's GEMV does).
__device__ __forceinline__ float q4_block_dot_f32(uint4 p, const float* xb) {
  const uint32_t w[4] = {p.x, p.y, p.z, p.w};
  float sum = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = q * 4 + i;
      const int byte = (w[q] >> (8 * i)) & 0xFF;
      sum = fmaf((float)((byte & 15) - 8), xb[j], sum);
      sum = fmaf((float)((byte >> 4) - 8), xb[j + 16], sum);
    }
  }
  return sum;
}

// R output rows of a warp-per-row GEMV against x staged in shared memory as
// [K/32][33] floats (one padding word per block, so the 32 lanes, each on its
// own block, hit 32 banks). Lane l takes blocks l, l+32, ...; returns each
// row's lane partial in acc (the caller reduces over the warp).
template <int R>
__device__ __forceinline__ void q4_rows_f32(const uint8_t* const (&qs)[R],
                                            const __half* const (&d)[R], const float* xs,
                                            int nblk, int lane, float (&acc)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int b = lane; b < nblk; b += 32) {
    uint4 p[R];
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[r] = __ldg(reinterpret_cast<const uint4*>(qs[r]) + b);
      s[r] = __half2float(d[r][b]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(q4_block_dot_f32(p[r], xs + b * 33), s[r], acc[r]);
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

// The fused kernels' rmsnorm prologue: dst = x * rsqrt(mean(x^2) + eps) * g,
// staged as [d/32][33] floats; red is a separate 32-float area.
__device__ __forceinline__ void stage_rmsnorm(const float* x, const float* g, int d, float eps,
                                              float* dst, float* red) {
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) ss = fmaf(x[i], x[i], ss);
  const float inv = 1.0f / sqrtf(block_sum(ss, red) / (float)d + eps);
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    dst[(i >> 5) * 33 + (i & 31)] = x[i] * inv * g[i];
  __syncthreads();
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
