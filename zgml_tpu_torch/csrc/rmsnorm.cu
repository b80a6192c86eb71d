// K12 rmsnorm: out[m, :] = x[m, :] * rsqrt(mean(x[m, :]^2) + eps) * gamma,
// over rows of d values, x f32 or bf16, gamma f32, f32 math, out in x's dtype.
//
// Replaces: zgml_tpu/ops/rmsnorm.py `_rmsnorm_kernel` (pallas_call in
// `_rmsnorm2d`, line 37), reached through `rmsnorm_pallas` when
// ZGML_TPU_KERNELS_FORCE=rmsnorm (zgml_tpu/ops/dispatch.py:144-155). The JAX
// kernel pads rows to 8 and d to 128 lanes and divides by the logical d; the
// port pads nothing, so d is the logical width.
//
// What bounds it on the H100: bytes. It reads x and gamma once and writes
// out once (M = 2048 rows at d 2048: 33.6 MB, ~10 us at 3.35 TB/s); the
// arithmetic is 4 operations per element.
//
// What the design does about it: one block per row; each thread takes
// elements tid, tid + blockDim, ... (neighbouring threads on neighbouring
// addresses), sums their squares, the block reduces the sum through warp
// shuffles (common.cuh block_sum), and the row is read a second time (from
// L1 / L2) to write the output. In the order of the plain version
// (refs.rmsnorm): ms = sum / d, ms + eps, rsqrtf (what torch.rsqrt computes
// on the card), then x * inv, then * gamma, each product rounded on its own
// (__fmul_rn: no contraction into an FMA).
#include "common.cuh"

namespace {

constexpr int MAX_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS)
rmsnorm_kernel(const T* __restrict__ x, const float* __restrict__ g, T* __restrict__ out, int d,
               float eps) {
  __shared__ float red[32];
  const T* row = x + (size_t)blockIdx.x * d;
  T* orow = out + (size_t)blockIdx.x * d;
  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += blockDim.x) {
    const float v = to_f32(row[i]);
    ss = __fadd_rn(ss, __fmul_rn(v, v));
  }
  const float ms = __fdiv_rn(block_sum(ss, red), (float)d);
  const float inv = rsqrtf(__fadd_rn(ms, eps));
  for (int i = threadIdx.x; i < d; i += blockDim.x)
    store(orow + i, __fmul_rn(__fmul_rn(to_f32(row[i]), inv), __ldg(g + i)));
}

}  // namespace

// dtype 0 = f32, 1 = bf16 (x and out); x [m, d], gamma f32 [d], out [m, d],
// all contiguous, on `stream`.
ZGML_EXPORT int zgml_rmsnorm(int dtype, const void* x, const float* g, void* out, int m, int d,
                             float eps, void* stream) {
  if (m <= 0 || d <= 0) return ZGML_ERR_SHAPE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = d >= MAX_THREADS ? MAX_THREADS : (d + 31) / 32 * 32;
  switch (dtype) {
    case 0:
      rmsnorm_kernel<float><<<m, threads, 0, st>>>(static_cast<const float*>(x), g,
                                                    static_cast<float*>(out), d, eps);
      break;
    case 1:
      rmsnorm_kernel<__nv_bfloat16><<<m, threads, 0, st>>>(
          static_cast<const __nv_bfloat16*>(x), g, static_cast<__nv_bfloat16*>(out), d, eps);
      break;
    default:
      return ZGML_ERR_SHAPE;
  }
  return (int)cudaGetLastError();
}
