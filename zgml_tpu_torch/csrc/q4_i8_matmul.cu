// K1 q4_matmul_i8 and K5 q4_greedy: the int8-activation Q4_0 GEMV tier.
//
// Replaces: zgml_tpu/ops/qmatmul.py `_q4_i8_kernel` (pallas_call at line 306,
// entry `_q4_matmul_i8`; `qmatmul_pallas` takes it for M <= 32 when
// ZGML_TPU_I8DOT is on, qmatmul.py:639,728) and `_q4_i8_argmax_kernel`
// (pallas_call at line 462, entry `qmatmul_greedy_pallas`: one live row, the
// argmax id with the first index on ties).
//
// Semantics (the plain versions are ops/qmatmul.py q4_matmul_i8_ref and
// q4_greedy_ref), as the JAX `_quantize_act` + `_block_dot`:
//   per row m and 32-block b of x: s = amax|x_b| / 127, inv = 1/s (0 when
//   s == 0), xq = clip(rint(x * inv), -127, 127) (round half to even, IEEE
//   division: this file must not be built with fast math, so xq and xs are
//   bit-equal to the JAX package's);
//   y[m, n] = sum_b float(sum_j xq_j * (nib_j - 8)) * (xs[m, b] * d[n, b]).
// The int8 x int4 block dots are exact; only the f32 sum over blocks is taken
// in another order than on the TPU.
//
// What bounds it on the H100: HBM bytes of the weight (0.5625 bytes per
// weight, read once per call), like K2's GEMV; the int8 path cuts the
// per-weight ALU work from two f32 FMAs to a quarter of a __dp4a.
//
// What the design does about it:
//   * A pre-pass launched from the same entry point quantizes x: one warp per
//     32-block, lane j holding element j (warp max for amax).
//   * GEMV: one warp per output row; lane l reads whole 16-byte weight blocks
//     l, l+32, ... (512 contiguous bytes per warp load), unpacks the 16 bytes
//     to 8 words of signed nibbles (mask, shift, __vsubss4 of 8 per byte) and
//     takes 8 __dp4a against the block's activation words. Up to 4 rows of x
//     share each weight load (blockIdx.y walks groups of 4 rows); the rows'
//     xq words sit in shared memory with 9 words per 8-word block, so the 32
//     lanes hit 32 banks.
//   * K5 runs the same per-row device function (q4_i8_row) with the same
//     template arguments, so its values equal K1's bit for bit, then reduces
//     the argmax deterministically: first index on ties within a block, a
//     64-bit atomicMax of (order-preserving float bits, ~index) across
//     blocks, and the last block to finish (a ticket counter) writes the id.
#include "common.cuh"

namespace {

constexpr int I8_WARPS = 8;    // output rows per GEMV block
constexpr int I8_ROWS = 4;     // rows of x per GEMV block
constexpr int XW = 9;          // shared-memory words per 32-block of xq (8 + 1 pad)

__global__ void quantize_act_kernel(const float* __restrict__ x, int8_t* __restrict__ xq,
                                    float* __restrict__ xs, int n_blocks,
                                    unsigned long long* __restrict__ argmax_ws) {
  if (argmax_ws != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    argmax_ws[0] = 0ull;     // running key (below every real key)
    argmax_ws[1] = 0ull;     // finished-block ticket
  }
  const int blk = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk >= n_blocks) return;
  const float v = x[(size_t)blk * 32 + lane];
  const float amax = warp_max(fabsf(v));
  const float s = amax / 127.0f;
  const float inv = s > 0.f ? 1.0f / s : 0.f;
  const float r = fminf(fmaxf(rintf(v * inv), -127.f), 127.f);
  xq[(size_t)blk * 32 + lane] = (int8_t)r;
  if (lane == 0) xs[blk] = s;
}

// Stage rows m0 .. m0+rg-1 of xq (as XW-word blocks) and xs into shared memory.
__device__ __forceinline__ void stage_rows(const int8_t* xq, const float* xs, int m0, int rg,
                                           int nblk, int* xq_s, float* xs_s) {
  const int* src = reinterpret_cast<const int*>(xq) + (size_t)m0 * nblk * 8;
  for (int i = threadIdx.x; i < rg * nblk * 8; i += blockDim.x)
    xq_s[(i >> 3) * XW + (i & 7)] = src[i];
  for (int i = threadIdx.x; i < rg * nblk; i += blockDim.x) xs_s[i] = xs[(size_t)m0 * nblk + i];
}

// One output row n for rg <= I8_ROWS rows of x: lane partials in acc.
__device__ __forceinline__ void q4_i8_row(const uint8_t* __restrict__ wq,
                                          const __half* __restrict__ wd, const int* xq_s,
                                          const float* xs_s, int rg, int nblk, int lane,
                                          float (&acc)[I8_ROWS]) {
#pragma unroll
  for (int r = 0; r < I8_ROWS; ++r) acc[r] = 0.f;
  const uint4* row = reinterpret_cast<const uint4*>(wq);
  for (int b = lane; b < nblk; b += 32) {
    const uint4 p = __ldg(row + b);
    const float sw = __half2float(wd[b]);
    const uint32_t w[4] = {p.x, p.y, p.z, p.w};
    int lo[4], hi[4];     // elements 4q..4q+3 and 16+4q..16+4q+3, as signed bytes
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lo[q] = __vsubss4((int)(w[q] & 0x0F0F0F0Fu), 0x08080808);
      hi[q] = __vsubss4((int)((w[q] >> 4) & 0x0F0F0F0Fu), 0x08080808);
    }
#pragma unroll
    for (int r = 0; r < I8_ROWS; ++r) {
      if (r < rg) {
        const int* xb = xq_s + (r * nblk + b) * XW;
        int isum = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          isum = __dp4a(lo[q], xb[q], isum);
          isum = __dp4a(hi[q], xb[4 + q], isum);
        }
        acc[r] = fmaf((float)isum, __fmul_rn(xs_s[r * nblk + b], sw), acc[r]);
      }
    }
  }
#pragma unroll
  for (int r = 0; r < I8_ROWS; ++r) acc[r] = warp_sum(acc[r]);
}

__device__ __forceinline__ unsigned int ordered_bits(float f) {
  const unsigned int u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <bool ARGMAX>
__global__ void __launch_bounds__(I8_WARPS * 32)
q4_i8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
                  const uint8_t* __restrict__ qs, const __half* __restrict__ d,
                  float* __restrict__ y, unsigned long long* __restrict__ ws,
                  long long* __restrict__ out_id, int M, int N, int K) {
  extern __shared__ __align__(16) int smem_i[];
  const int nblk = K / 32;
  const int m0 = blockIdx.y * I8_ROWS;
  const int rg = min(I8_ROWS, M - m0);
  int* xq_s = smem_i;                                          // [rg * nblk][XW]
  float* xs_s = reinterpret_cast<float*>(xq_s + rg * nblk * XW);   // [rg][nblk]
  stage_rows(xq, xs, m0, rg, nblk, xq_s, xs_s);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * I8_WARPS + warp;
  float acc[I8_ROWS];
  if (n < N) q4_i8_row(qs + (size_t)n * (K / 2), d + (size_t)n * nblk, xq_s, xs_s, rg, nblk,
                       lane, acc);
  if constexpr (!ARGMAX) {
    if (n < N && lane == 0)
      for (int r = 0; r < rg; ++r) y[(size_t)(m0 + r) * N + n] = acc[r];
  } else {
    __shared__ float best_v[I8_WARPS];
    __shared__ int best_i[I8_WARPS];
    if (lane == 0) {
      best_v[warp] = n < N ? acc[0] : -INFINITY;
      best_i[warp] = n;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float bv = best_v[0];
      int bi = best_i[0];                  // warps hold increasing n: strict > keeps the first
      for (int w = 1; w < I8_WARPS; ++w)
        if (best_i[w] < N && best_v[w] > bv) {
          bv = best_v[w];
          bi = best_i[w];
        }
      atomicMax(ws, ((unsigned long long)ordered_bits(bv) << 32) |
                        (unsigned long long)(0xFFFFFFFFu - (unsigned int)bi));
      __threadfence();
      const unsigned int ticket = atomicAdd(reinterpret_cast<unsigned int*>(ws + 1), 1u);
      if (ticket == gridDim.x - 1) {       // every block's atomicMax is done
        const unsigned long long key = atomicAdd(ws, 0ull);
        *out_id = (long long)(0xFFFFFFFFu - (unsigned int)(key & 0xFFFFFFFFull));
      }
    }
  }
}

int quantize(const float* x, int8_t* xq, float* xs, int M, int K, unsigned long long* ws,
             cudaStream_t st) {
  const int n_blocks = M * (K / 32);
  quantize_act_kernel<<<(n_blocks + 7) / 8, 256, 0, st>>>(x, xq, xs, n_blocks, ws);
  return (int)cudaGetLastError();
}

size_t gemv_smem(int rows, int K) {
  return (size_t)rows * (K / 32) * (XW * sizeof(int) + sizeof(float));
}

}  // namespace

// The pre-pass alone: x f32 [M, K] -> xq int8 [M, K], xs f32 [M, K/32].
ZGML_EXPORT int zgml_q4_i8_quantize(const float* x, int8_t* xq, float* xs, int M, int K,
                                    void* stream) {
  if (M <= 0 || K <= 0 || K % 32 != 0) return ZGML_ERR_SHAPE;
  return quantize(x, xq, xs, M, K, nullptr, static_cast<cudaStream_t>(stream));
}

// K1: x f32 [M, K] -> y f32 [M, N]; xq int8 [M, K] and xs f32 [M, K/32] are
// the wrapper's scratch (filled by the pre-pass); qs uint8 [N, K/2], d fp16
// [N, K/32]. All contiguous, on `stream`.
ZGML_EXPORT int zgml_q4_matmul_i8(const float* x, int8_t* xq, float* xs, const uint8_t* qs,
                                  const void* d, float* y, int M, int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0) return ZGML_ERR_SHAPE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = quantize(x, xq, xs, M, K, nullptr, st);
  if (rc != 0) return rc;
  const size_t smem = gemv_smem(min(M, I8_ROWS), K);
  rc = allow_dynamic_smem(q4_i8_gemv_kernel<false>, smem);
  if (rc != 0) return rc;
  const dim3 grid((N + I8_WARPS - 1) / I8_WARPS, (M + I8_ROWS - 1) / I8_ROWS);
  q4_i8_gemv_kernel<false><<<grid, I8_WARPS * 32, smem, st>>>(
      xq, xs, qs, static_cast<const __half*>(d), y, nullptr, nullptr, M, N, K);
  return (int)cudaGetLastError();
}

// K5: one row x f32 [K] -> out_id int64 [1] = argmax_n of K1's y (first index
// on ties); ws is 16 bytes of scratch, zeroed by the pre-pass.
ZGML_EXPORT int zgml_q4_greedy(const float* x, int8_t* xq, float* xs, const uint8_t* qs,
                               const void* d, void* ws, long long* out_id, int N, int K,
                               void* stream) {
  if (N <= 0 || K <= 0 || K % 32 != 0) return ZGML_ERR_SHAPE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<unsigned long long*>(ws);
  int rc = quantize(x, xq, xs, 1, K, w, st);
  if (rc != 0) return rc;
  const size_t smem = gemv_smem(1, K);
  rc = allow_dynamic_smem(q4_i8_gemv_kernel<true>, smem);
  if (rc != 0) return rc;
  q4_i8_gemv_kernel<true><<<(N + I8_WARPS - 1) / I8_WARPS, I8_WARPS * 32, smem, st>>>(
      xq, xs, qs, static_cast<const __half*>(d), nullptr, w, out_id, 1, N, K);
  return (int)cudaGetLastError();
}
