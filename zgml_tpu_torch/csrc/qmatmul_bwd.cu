// K11 qmatmul_bwd: dx[M, K] = g[M, N] @ dequant(W)[N, K], W in Q4_0 (K11q4)
// or Q8_0 (K11q8), f32 in and out: the input gradient of a projection whose
// quantized weight is frozen.
//
// Replaces: zgml_tpu/ops/qmatmul.py `_q8_bwd_kernel` (pallas_call at line
// 541) and `_q4_bwd_kernel` (pallas_call at line 593), reached through
// `_qmm_diff_bwd` when jax.grad differentiates `qmatmul_pallas`; the weight
// planes get no gradient. The JAX Q4_0 kernel writes dx as two half-K planes
// (lo | hi, the planar half-split); this one writes dx in logical k order.
//
// Weight layout: the port's N-major GGUF-order PackedWeight (quant/packed.py;
// block formats FmtQ4_0 / FmtQ8_0 of common.cuh): row n of W is contiguous
// along K, so a tile of W [BN rows x 32 k] is one quant block of each of BN
// rows.
//
// What bounds it on the H100: 2*M*N*K f32 FMAs, as K2's tiled GEMM (at the
// training shape, M = 512 rows, ~45 GFLOP over one TinyLlama layer's four
// projections, ~0.67 ms at 67 TFLOP/s); the weight bytes are read once per
// 64-row tile of g.
//
// What the design does about it: K2's tiled GEMM with the reduction over N
// in place of K. A 64 x 32 output tile of dx per 128-thread block (32 = one
// quant block of k), N stepped 32 rows at a time: the g tile goes to shared
// memory n-major, the 32 rows' blocks are dequantized (level * d, exact in
// f32) into a [32 n][32 k] tile, and each thread keeps a 4x4 f32 accumulator.
#include "common.cuh"

namespace {

constexpr int TM = 64, TKO = 32, BN = 32, THREADS = 128;

// Part p (0..3) of row r's weight block at `blk` (scale *dp) into the tile
// row Bs[r][.]: Q4_0 bytes 4p..4p+3 (elements 4p..4p+3 and 16+4p..16+4p+3),
// Q8_0 bytes 8p..8p+7 (elements 8p..8p+7). A row past N gives zeros.
template <class F>
__device__ __forceinline__ void dequant_row_part(const uint8_t* __restrict__ blk,
                                                 const __half* __restrict__ dp, bool valid, int p,
                                                 float* row) {
  float s = 0.f;
  if constexpr (F::KIND == 0) {
    uint32_t w = 0x88888888u;       // nibble 8 == 0.0
    if (valid) {
      w = __ldg(reinterpret_cast<const uint32_t*>(blk) + p);
      s = __half2float(*dp);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int byte = (w >> (8 * i)) & 0xFF;
      row[4 * p + i] = (float)((byte & 15) - 8) * s;
      row[16 + 4 * p + i] = (float)((byte >> 4) - 8) * s;
    }
  } else {
    uint2 w = make_uint2(0u, 0u);
    if (valid) {
      w = __ldg(reinterpret_cast<const uint2*>(blk) + p);
      s = __half2float(*dp);
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const uint32_t word = i < 4 ? w.x : w.y;
      row[8 * p + i] = (float)((int)(word << (24 - 8 * (i & 3))) >> 24) * s;
    }
  }
}

template <class F>
__global__ void __launch_bounds__(THREADS)
qgemm_bwd_kernel(const float* __restrict__ g, const uint8_t* __restrict__ qs,
                 const __half* __restrict__ d, float* __restrict__ dx, int M, int N, int K) {
  __shared__ __align__(16) float As[BN][TM + 4];    // g tile, n-major
  __shared__ __align__(16) float Bs[BN][TKO + 4];   // dequantized W tile [n][k]
  const int tid = threadIdx.x;
  const int tm = tid >> 3, tk = tid & 7;            // 16 x 8 threads, 4x4 outputs each
  const int kb = blockIdx.x, m0 = blockIdx.y * TM;
  const int nblk = K / 32;
  float acc[4][4] = {};
  for (int n0 = 0; n0 < N; n0 += BN) {
    // g tile: 64 rows x 32 n, 16 per thread, consecutive threads on consecutive n
#pragma unroll 4
    for (int i = 0; i < TM * BN / THREADS; ++i) {
      const int f = tid + i * THREADS;
      const int r = f >> 5, c = f & 31;
      As[c][r] = (m0 + r < M && n0 + c < N) ? __ldg(g + (size_t)(m0 + r) * N + n0 + c) : 0.f;
    }
    // weight tile: 32 rows, 4 threads per row, one block each
    const int nr = n0 + (tid >> 2);
    const bool valid = nr < N;
    const size_t row = (size_t)(valid ? nr : 0) * nblk;
    dequant_row_part<F>(qs + (row + kb) * F::BYTES, d + row + kb, valid, tid & 3, Bs[tid >> 2]);
    __syncthreads();
#pragma unroll
    for (int nn = 0; nn < BN; ++nn) {
      const float4 a = *reinterpret_cast<const float4*>(&As[nn][tm * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[nn][tk * 4]);
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
    float4 o = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(dx + (size_t)m * K + kb * 32 + tk * 4) = o;
  }
}

}  // namespace

// kind 0 (q4_0) or 1 (q8_0); g f32 [M, N], qs [N, K/32 * BYTES], d fp16
// [N, K/32] -> dx f32 [M, K], all contiguous, dx 16-byte aligned, on `stream`.
ZGML_EXPORT int zgml_qmatmul_bwd(int kind, const float* g, const uint8_t* qs, const void* d,
                                 float* dx, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0) return ZGML_ERR_SHAPE;
  const __half* dh = static_cast<const __half*>(d);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(K / 32, (M + TM - 1) / TM);
  ZGML_DISPATCH_KIND(kind, {
    qgemm_bwd_kernel<F><<<grid, THREADS, 0, st>>>(g, qs, dh, dx, M, N, K);
    return (int)cudaGetLastError();
  })
}
