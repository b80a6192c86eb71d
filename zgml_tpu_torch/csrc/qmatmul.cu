// K2 qmatmul: y[M, N] = x[M, K] @ dequant(W)^T, W in Q4_0 (K2q4) or Q8_0
// (K2q8), f32 in and out.
//
// Replaces: zgml_tpu/ops/qmatmul.py `_q4_kernel` (pallas_call at line 141)
// and `_q8_kernel` (pallas_call at line 81), reached through `_q4_matmul` /
// `_q8_matmul` from `qmatmul_pallas`; on the TPU they serve every M when the
// int8-activation tier is off (ZGML_TPU_I8DOT=0) and M > 32 when it is on
// (prefill chunks).
//
// Weight layout (zgml_tpu_torch/quant/packed.py; the block formats are the
// FmtQ4_0 / FmtQ8_0 traits of common.cuh): N-major, GGUF block order, qs
// [N, K/32 * BYTES] (16 bytes of nibbles or 32 int8 per block) and d fp16
// [N, K/32]; value = level * d.
//
// What bounds it on the H100:
//   * M <= 4 (decode, the greedy head): a GEMV. Every weight byte is read once
//     per row of x, so it is bound by HBM bandwidth (0.5625 bytes per weight
//     at Q4_0, 1.0625 at Q8_0, at 3.35 TB/s).
//   * M = a prefill chunk (128): 2*M*N*K flops over the same bytes, bound by
//     the f32 FMA rate of the CUDA cores here (67 TFLOP/s; tensor cores are a
//     later PR). Q8_0 and Q4_0 do the same flops.
//
// What the design does about it:
//   * GEMV: one warp per output row; lane l reads whole blocks l, l+32, ...
//     (16 or 32 bytes, as one or two 16-byte loads) so a warp's load is 512 or
//     1024 contiguous bytes; x is staged once per block in shared memory with
//     one padding word per 32 floats, so the 32 lanes (each in its own block)
//     hit 32 distinct banks. The level sum of a block is taken in f32, then
//     scaled once by d.
//   * Tiled: 64x32 output tile per 128-thread block, K stepped one block (32)
//     at a time; the x tile and the dequantized weight tile go to shared
//     memory k-major, each thread keeps a 4x4 f32 accumulator in registers.
//     Dequantized values level * d are exact in f32 (an int of at most 8 bits
//     times an fp16), so the weight the FMAs see equals the plain version's.
// Operands are f32 with f32 accumulation in both paths.
#include "common.cuh"

namespace {

constexpr int GEMV_WARPS = 8;   // output rows per GEMV block
constexpr int GEMV_MAX_M = 4;   // M above this runs the tiled kernel
constexpr int TM = 64, TN = 32, TK = 32, TILE_THREADS = 128;

template <class F>
__global__ void __launch_bounds__(GEMV_WARPS * 32)
qgemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
             const __half* __restrict__ d, float* __restrict__ y, int N, int K) {
  extern __shared__ float xs[];   // [K/32][33]
  const int m = blockIdx.y;
  const int nblk = K / 32;
  const float* xm = x + (size_t)m * K;
  for (int i = threadIdx.x; i < K; i += blockDim.x) xs[(i >> 5) * 33 + (i & 31)] = xm[i];
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * GEMV_WARPS + warp;
  if (n >= N) return;
  const uint8_t* row[1] = {qs + (size_t)n * nblk * F::BYTES};
  const __half* drow[1] = {d + (size_t)n * nblk};
  float acc[1];
  rows_f32<F, 1>(row, drow, xs, nblk, lane, acc);
  const float s = warp_sum(acc[0]);
  if (lane == 0) y[(size_t)m * N + n] = s;
}

// Part g (0..3) of the weight block at blk (scale *dp), dequantized into the
// k-major tile column Bs[.][r]: Q4_0 takes bytes 4g..4g+3 (elements 4g..4g+3
// and 16+4g..16+4g+3), Q8_0 bytes 8g..8g+7 (elements 8g..8g+7). A row past N
// (valid false) gives zeros.
template <class F>
__device__ __forceinline__ void dequant_part(const uint8_t* __restrict__ blk,
                                             const __half* __restrict__ dp, bool valid, int g,
                                             float (*Bs)[TN + 4], int r) {
  float s = 0.f;
  if constexpr (F::KIND == 0) {
    uint32_t p = 0x88888888u;       // nibble 8 == 0.0
    if (valid) {
      p = __ldg(reinterpret_cast<const uint32_t*>(blk) + g);
      s = __half2float(*dp);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int byte = (p >> (8 * i)) & 0xFF;
      Bs[g * 4 + i][r] = (float)((byte & 15) - 8) * s;
      Bs[16 + g * 4 + i][r] = (float)((byte >> 4) - 8) * s;
    }
  } else {
    uint2 p = make_uint2(0u, 0u);
    if (valid) {
      p = __ldg(reinterpret_cast<const uint2*>(blk) + g);
      s = __half2float(*dp);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t word = i < 4 ? p.x : p.y;
      Bs[g * 8 + i][r] = (float)((int)(word << (24 - 8 * (i & 3))) >> 24) * s;
    }
  }
}

template <class F>
__global__ void __launch_bounds__(TILE_THREADS)
qgemm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
             const __half* __restrict__ d, float* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(16) float As[TK][TM + 4];   // x tile, k-major
  __shared__ __align__(16) float Bs[TK][TN + 4];   // dequantized weight tile, k-major
  const int tid = threadIdx.x;
  const int tm = tid >> 3, tn = tid & 7;           // 16 x 8 threads, 4x4 outputs each
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int nblk = K / 32;
  float acc[4][4] = {};
  // this thread's weight row of the tile (4 threads per row)
  const int nr = n0 + (tid >> 2);
  const bool valid = nr < N;
  const uint8_t* wrow = qs + (size_t)(valid ? nr : 0) * nblk * F::BYTES;
  const __half* drow = d + (size_t)(valid ? nr : 0) * nblk;

  for (int kb = 0; kb < nblk; ++kb) {
    // x tile: 64 rows x 32 floats = 512 float4, 4 per thread
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int f = tid + i * TILE_THREADS;
      const int r = f >> 3, c = (f & 7) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m0 + r < M)
        v = __ldg(reinterpret_cast<const float4*>(x + (size_t)(m0 + r) * K + kb * 32 + c));
      As[c + 0][r] = v.x;
      As[c + 1][r] = v.y;
      As[c + 2][r] = v.z;
      As[c + 3][r] = v.w;
    }
    // weight tile: 32 rows x one block
    dequant_part<F>(wrow + kb * F::BYTES, drow + kb, valid, tid & 3, Bs, tid >> 2);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][tm * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tn * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tm * 4 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tn * 4 + j;
      if (n < N) y[(size_t)m * N + n] = acc[i][j];
    }
  }
}

template <class F>
int launch(const float* x, const uint8_t* qs, const __half* d, float* y, int M, int N, int K,
           cudaStream_t st) {
  if (M <= GEMV_MAX_M) {
    const size_t smem = (size_t)(K / 32) * 33 * sizeof(float);
    const int rc = allow_dynamic_smem(qgemv_kernel<F>, smem);
    if (rc != 0) return rc;
    const dim3 grid((N + GEMV_WARPS - 1) / GEMV_WARPS, M);
    qgemv_kernel<F><<<grid, GEMV_WARPS * 32, smem, st>>>(x, qs, d, y, N, K);
  } else {
    const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    qgemm_kernel<F><<<grid, TILE_THREADS, 0, st>>>(x, qs, d, y, M, N, K);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// kind 0 (q4_0) or 1 (q8_0); x f32 [M, K], qs uint8/int8 [N, K/32 * BYTES], d
// fp16 [N, K/32] -> y f32 [M, N], all contiguous and 16-byte aligned, on
// `stream`.
ZGML_EXPORT int zgml_qmatmul(int kind, const float* x, const uint8_t* qs, const void* d,
                             float* y, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0) return ZGML_ERR_SHAPE;
  const __half* dh = static_cast<const __half*>(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ZGML_DISPATCH_KIND(kind, return launch<F>(x, qs, dh, y, M, N, K, st))
}
