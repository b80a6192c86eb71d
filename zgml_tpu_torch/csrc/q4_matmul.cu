// K2 q4_matmul: y[M, N] = x[M, K] @ dequant(W)^T, W in Q4_0, f32 in and out.
//
// Replaces: zgml_tpu/ops/qmatmul.py `_q4_kernel` (line 103), reached through
// `_q4_matmul` / `qmatmul_pallas`; on the TPU it serves every M when the
// int8-activation tier is off (ZGML_TPU_I8DOT=0), as in this port.
//
// Weight layout (zgml_tpu_torch/quant/packed.py): N-major, GGUF block order,
// qs uint8 [N, K/2] (byte j of a 32-block holds element j in the low nibble
// and j+16 in the high one) and d fp16 [N, K/32]; value = (nibble - 8) * d.
//
// What bounds it on the H100:
//   * M <= 4 (decode, the greedy head): a GEMV. Every weight byte is read once
//     per call and used M times, so it is bound by HBM bandwidth (0.5625 bytes
//     per weight at 3.35 TB/s).
//   * M = a prefill chunk (128): 2*M*N*K flops over the same bytes, bound by
//     the f32 FMA rate of the CUDA cores here (tensor cores are a later PR).
//
// What the design does about it:
//   * GEMV: one warp per output row; lane l reads whole 16-byte blocks
//     l, l+32, ... so a warp's load is 512 contiguous bytes; x is staged once
//     per block in shared memory with one padding word per 32 floats, so the
//     32 lanes (each in its own block) hit 32 distinct banks. The nibble sum
//     of a block is taken in f32, then scaled once by d.
//   * Tiled: 64x32 output tile per 128-thread block, K stepped one Q4 block
//     (32) at a time; the x tile and the dequantized weight tile go to shared
//     memory k-major, each thread keeps a 4x4 f32 accumulator in registers.
//     Dequantized values (nibble - 8) * d are exact in f32, so the weight the
//     FMAs see equals the plain version's.
// Operands are f32 with f32 accumulation in both paths.
#include "common.cuh"

namespace {

constexpr int GEMV_WARPS = 8;   // output rows per GEMV block
constexpr int GEMV_MAX_M = 4;   // M above this runs the tiled kernel
constexpr int TM = 64, TN = 32, TK = 32, TILE_THREADS = 128;

__global__ void __launch_bounds__(GEMV_WARPS * 32)
q4_gemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
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
  const uint4* row = reinterpret_cast<const uint4*>(qs + (size_t)n * (K / 2));
  const __half* drow = d + (size_t)n * nblk;
  float acc = 0.f;
  for (int b = lane; b < nblk; b += 32)
    acc = fmaf(q4_block_dot_f32(__ldg(row + b), xs + b * 33), __half2float(drow[b]), acc);
  acc = warp_sum(acc);
  if (lane == 0) y[(size_t)m * N + n] = acc;
}

__global__ void __launch_bounds__(TILE_THREADS)
q4_gemm_kernel(const float* __restrict__ x, const uint8_t* __restrict__ qs,
               const __half* __restrict__ d, float* __restrict__ y, int M, int N, int K) {
  __shared__ __align__(16) float As[TK][TM + 4];   // x tile, k-major
  __shared__ __align__(16) float Bs[TK][TN + 4];   // dequantized weight tile, k-major
  const int tid = threadIdx.x;
  const int tm = tid >> 3, tn = tid & 7;           // 16 x 8 threads, 4x4 outputs each
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int nblk = K / 32;
  float acc[4][4] = {};

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
    // weight tile: 32 rows x one block; thread = row tid/4, bytes 4*(tid%4)..+3
    {
      const int r = tid >> 2, g = tid & 3;
      const int n = n0 + r;
      uint32_t p = 0x88888888u;   // nibble 8 == 0.0
      float s = 0.f;
      if (n < N) {
        p = __ldg(reinterpret_cast<const uint32_t*>(qs + (size_t)n * (K / 2) + kb * 16) + g);
        s = __half2float(d[(size_t)n * nblk + kb]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int byte = (p >> (8 * i)) & 0xFF;
        Bs[g * 4 + i][r] = (float)((byte & 15) - 8) * s;
        Bs[16 + g * 4 + i][r] = (float)((byte >> 4) - 8) * s;
      }
    }
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

}  // namespace

// x f32 [M, K], qs uint8 [N, K/2], d fp16 [N, K/32] -> y f32 [M, N], all
// contiguous and 16-byte aligned, on `stream`.
ZGML_EXPORT int zgml_q4_matmul(const float* x, const uint8_t* qs, const void* d, float* y,
                               int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0) return ZGML_ERR_SHAPE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const __half* dh = static_cast<const __half*>(d);
  if (M <= GEMV_MAX_M) {
    const size_t smem = (size_t)(K / 32) * 33 * sizeof(float);
    const int rc = allow_dynamic_smem(q4_gemv_kernel, smem);
    if (rc != 0) return rc;
    const dim3 grid((N + GEMV_WARPS - 1) / GEMV_WARPS, M);
    q4_gemv_kernel<<<grid, GEMV_WARPS * 32, smem, st>>>(x, qs, dh, y, N, K);
  } else {
    const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM);
    q4_gemm_kernel<<<grid, TILE_THREADS, 0, st>>>(x, qs, dh, y, M, N, K);
  }
  return (int)cudaGetLastError();
}
