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
// arithmetic is 4 operations per element. At a few rows it is one row's
// chain of latencies: load, reduce, store.
//
// What the design does about it (the vector path): one pass over the row.
// Each thread holds its whole share of the row in registers, VPT (1-4)
// 16-byte vectors of x (4 f32 or 8 bf16 values), vector r * T + t of the
// row's T threads' t-th thread, and the matching gamma vectors; every load
// is issued before any arithmetic, and the output is written from the
// registers with 16-byte stores. The sum of squares is reduced once: each
// thread over its vectors in order, then a warp's xor shuffle tree, then
// one exchange of the warps' sums through shared memory behind a single
// barrier, which every thread adds up in warp order (a fixed order: two
// launches give the same bits; tests/test_torch_rmsnorm.py emulates it).
// Rows of at most 32 * VPT_MAX vectors (d <= 512 f32, <= 1024 bf16) take one
// warp each, several to a block, and no barrier. (A row split over a
// thread-block cluster, its sums joined through distributed shared memory,
// was slower than one block at M = 1 on the H100: PERF.md, K12.)
// Where d is not a multiple of the vector width or x / gamma / out is not
// 16-byte aligned, the scalar loop runs: one block a row, elements tid, tid
// + blockDim, ..., the row read a second time to write it. Both paths keep
// the plain version's order (refs.rmsnorm): ms = sum / d, ms + eps, rsqrtf
// (what torch.rsqrt computes on the card), then x * inv, then * gamma, each
// product rounded on its own (__fmul_rn: no contraction into an FMA).
#include "common.cuh"

namespace {

constexpr int SCALAR_THREADS = 256, VPT_MAX = 4, THREADS_MAX = 1024;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// one 16-byte vector of x or out as W floats, in address order
template <typename T> struct Vec;
template <> struct Vec<float> {
  static constexpr int W = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&v)[W]) {
    v[0] = __uint_as_float(u.x); v[1] = __uint_as_float(u.y);
    v[2] = __uint_as_float(u.z); v[3] = __uint_as_float(u.w);
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[W]) {
    return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                      __float_as_uint(v[3]));
  }
};
template <> struct Vec<__nv_bfloat16> {
  static constexpr int W = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float (&v)[W]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) { v[2 * k] = bf16_lo(w[k]); v[2 * k + 1] = bf16_hi(w[k]); }
  }
  __device__ __forceinline__ static uint32_t pair(float lo, float hi) {
    const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);   // .x (lo) at the lower address
    return *reinterpret_cast<const uint32_t*>(&p);
  }
  __device__ __forceinline__ static uint4 pack(const float (&v)[W]) {
    return make_uint4(pair(v[0], v[1]), pair(v[2], v[3]), pair(v[4], v[5]), pair(v[6], v[7]));
  }
};

// The vector path. WARP_ROW: a block of rows, one warp each (blockDim.x /
// 32 rows, vector r * 32 + lane). Else one row a block, vector
// r * blockDim.x + threadIdx.x.
template <typename T, int VPT, bool WARP_ROW>
__global__ void __launch_bounds__(THREADS_MAX)
rmsnorm_vec_kernel(const T* __restrict__ x, const float* __restrict__ g, T* __restrict__ out,
                   int m, int d, float eps) {
  using V = Vec<T>;
  constexpr int W = V::W;
  __shared__ float red[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nvec = d / W;
  int row, step, t;
  if (WARP_ROW) {
    row = blockIdx.x * (blockDim.x >> 5) + warp;
    if (row >= m) return;                      // the whole warp: no barrier below
    step = 32, t = lane;
  } else {
    row = blockIdx.x, step = blockDim.x, t = threadIdx.x;
  }
  const uint4* xrow = reinterpret_cast<const uint4*>(x + (size_t)row * d);
  const float4* g4 = reinterpret_cast<const float4*>(g);
  uint4 xv[VPT];
  float4 gv[VPT][W / 4];
#pragma unroll
  for (int r = 0; r < VPT; ++r) {              // every load before any arithmetic
    const int i = r * step + t;
    if (i < nvec) {
      xv[r] = __ldg(xrow + i);
#pragma unroll
      for (int h = 0; h < W / 4; ++h) gv[r][h] = __ldg(g4 + i * (W / 4) + h);
    } else {
      xv[r] = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  float ss = 0.f;
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    float v[W];
    V::unpack(xv[r], v);
#pragma unroll
    for (int e = 0; e < W; ++e) ss = __fadd_rn(ss, __fmul_rn(v[e], v[e]));
  }
  float total = warp_sum(ss);
  if (!WARP_ROW) {
    const int nw = blockDim.x >> 5;
    if (lane == 0) red[warp] = total;
    __syncthreads();
    total = 0.f;
    for (int w = 0; w < nw; ++w) total += red[w];
  }
  const float ms = __fdiv_rn(total, (float)d);
  const float inv = rsqrtf(__fadd_rn(ms, eps));
  uint4* orow = reinterpret_cast<uint4*>(out + (size_t)row * d);
#pragma unroll
  for (int r = 0; r < VPT; ++r) {
    const int i = r * step + t;
    if (i >= nvec) continue;
    float v[W], gf[W];
    V::unpack(xv[r], v);
#pragma unroll
    for (int h = 0; h < W / 4; ++h) {
      gf[4 * h] = gv[r][h].x, gf[4 * h + 1] = gv[r][h].y;
      gf[4 * h + 2] = gv[r][h].z, gf[4 * h + 3] = gv[r][h].w;
    }
#pragma unroll
    for (int e = 0; e < W; ++e) v[e] = __fmul_rn(__fmul_rn(v[e], inv), gf[e]);
    orow[i] = V::pack(v);
  }
}

// The scalar path: one block per row, the row read twice.
template <typename T>
__global__ void __launch_bounds__(SCALAR_THREADS)
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

template <typename T>
int launch(const void* x, const float* g, void* out, int m, int d, float eps, int vpt,
           int threads, int rows, cudaStream_t st) {
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  if (vpt == 0) {
    rmsnorm_kernel<T><<<m, threads, 0, st>>>(xt, g, ot, d, eps);
    return 0;
  }
  const int nvec = d / Vec<T>::W;
  if (rows > 1 || threads == 32) {             // one warp a row
    if (threads != 32 || nvec > 32 * vpt) return ZGML_ERR_SHAPE;
    const int blocks = (m + rows - 1) / rows, bt = 32 * rows;
    switch (vpt) {
      case 1: rmsnorm_vec_kernel<T, 1, true><<<blocks, bt, 0, st>>>(xt, g, ot, m, d, eps); break;
      case 2: rmsnorm_vec_kernel<T, 2, true><<<blocks, bt, 0, st>>>(xt, g, ot, m, d, eps); break;
      case 3: rmsnorm_vec_kernel<T, 3, true><<<blocks, bt, 0, st>>>(xt, g, ot, m, d, eps); break;
      default: rmsnorm_vec_kernel<T, 4, true><<<blocks, bt, 0, st>>>(xt, g, ot, m, d, eps);
    }
    return 0;
  }
  if ((long long)vpt * threads < nvec) return ZGML_ERR_SHAPE;   // a block holds the row
  switch (vpt) {
    case 1: rmsnorm_vec_kernel<T, 1, false><<<m, threads, 0, st>>>(xt, g, ot, m, d, eps); break;
    case 2: rmsnorm_vec_kernel<T, 2, false><<<m, threads, 0, st>>>(xt, g, ot, m, d, eps); break;
    case 3: rmsnorm_vec_kernel<T, 3, false><<<m, threads, 0, st>>>(xt, g, ot, m, d, eps); break;
    default: rmsnorm_vec_kernel<T, 4, false><<<m, threads, 0, st>>>(xt, g, ot, m, d, eps);
  }
  return 0;
}

}  // namespace

// dtype 0 = f32, 1 = bf16 (x and out); x [m, d], gamma f32 [d], out [m, d],
// all contiguous, on `stream`. The plan comes from ops/rmsnorm.rmsnorm_plan:
// vpt 0 takes the scalar path (threads a block, one block a row); vpt 1-4
// the vector path (x, gamma, out 16-byte aligned, d a multiple of the
// vector width), `threads` a row and `rows` rows a block (> 1, or threads
// 32: one warp a row).
ZGML_EXPORT int zgml_rmsnorm(int dtype, const void* x, const float* g, void* out, int m, int d,
                             float eps, int vpt, int threads, int rows, void* stream) {
  if (m <= 0 || d <= 0 || vpt < 0 || vpt > VPT_MAX || threads <= 0 || threads % 32 ||
      threads > (vpt ? THREADS_MAX : SCALAR_THREADS) || rows < 1 || rows * threads > THREADS_MAX)
    return ZGML_ERR_SHAPE;
  if (vpt) {
    const int width = dtype == 0 ? 4 : 8;
    const auto aligned = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
    if (d % width || !aligned(x) || !aligned(g) || !aligned(out)) return ZGML_ERR_SHAPE;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int status;
  switch (dtype) {
    case 0:
      status = launch<float>(x, g, out, m, d, eps, vpt, threads, rows, st);
      break;
    case 1:
      status = launch<__nv_bfloat16>(x, g, out, m, d, eps, vpt, threads, rows, st);
      break;
    default:
      return ZGML_ERR_SHAPE;
  }
  return status ? status : (int)cudaGetLastError();
}
