// TF32 and bf16 tensor-core, ldmatrix and cp.async helpers for the tiled
// kernels K2 (qmatmul.cu), K11 (qmatmul_bwd.cu) and K10dq / K10dkv
// (flash_bwd.cu): the same instructions the prefill flash kernel uses
// (flash_attn.cu keeps its own copy); and the fixed-order sum of the split
// GEMMs' partials (K2, K11).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tf32 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes where !live (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(live ? 16 : 0));
}

// 4 bytes global -> shared, or 4 zero bytes where !live
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x rounded to TF32 (10 stored mantissa bits, to nearest, ties away from
// zero), as f32 bits: the rounding of cvt.rna.tf32.f32, in two integer
// operations
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

// g * d = hi + lo: hi = fl32(g * d) rounded to TF32, lo = the rest of the
// exact product in f32 (one fma), which the tensor cores read truncated to
// TF32; together they leave at most 2^-21 |g * d| behind, unbiased
__device__ __forceinline__ void split_product(float g, float d, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(__fmul_rn(g, d));
  lo = __float_as_uint(__fmaf_rn(g, d, -__uint_as_float(hi)));
}

// c += a . b on a 16x8x8 TF32 tile, f32 accumulators (the tensor cores round
// the sum toward zero)
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, both TF32 (rounded to nearest, ties away): x - hi is exact in
// f32, and x - hi - lo is at most 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(__fsub_rn(x, __uint_as_float(hi)));
}

// c += a . b on a 16x8x16 bf16 tile, f32 accumulators: the products of two
// bf16 values are exact in f32
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// lo, hi rounded to bf16 (nearest even) and packed: lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
// (.trans: each lane gets its pair from a column)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

namespace {

// y = part[0] + part[1] + ... + part[n_split - 1] (n values each), added in
// that order: no atomics, so y has the same bits on every run
template <int = 0>
__global__ void sum_parts_kernel(const float* __restrict__ part, float* __restrict__ y,
                                 long long n, int n_split) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  if ((n & 3) == 0) {
    const float4* p4 = reinterpret_cast<const float4*>(part);
    const long long n4 = n >> 2;
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4; i += stride) {
      float4 s = p4[i];
      for (int z = 1; z < n_split; ++z) {
        const float4 v = p4[z * n4 + i];
        s = make_float4(__fadd_rn(s.x, v.x), __fadd_rn(s.y, v.y), __fadd_rn(s.z, v.z),
                        __fadd_rn(s.w, v.w));
      }
      reinterpret_cast<float4*>(y)[i] = s;
    }
  } else {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n; i += stride) {
      float s = part[i];
      for (int z = 1; z < n_split; ++z) s = __fadd_rn(s, part[z * n + i]);
      y[i] = s;
    }
  }
}

// launch sum_parts_kernel on `st` (part and y 16-byte aligned); returns a
// status. A template, like the kernel, so a source that includes this header
// and never sums gets no copy of the kernel.
template <int = 0>
inline int sum_parts(const float* part, float* y, long long n, int n_split, cudaStream_t st) {
  const long long blocks = ((n & 3) == 0 ? n / 4 : n) / 256 + 1;
  sum_parts_kernel<><<<(int)(blocks < 4096 ? blocks : 4096), 256, 0, st>>>(part, y, n, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace tf32
