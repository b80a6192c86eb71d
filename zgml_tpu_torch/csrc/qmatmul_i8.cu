// K1 qmatmul_i8 and K5 greedy: the int8-activation GEMV tier, Q4_0 (K1q4,
// K5q4) and Q8_0 (K1q8, K5q8).
//
// Replaces: zgml_tpu/ops/qmatmul.py `_q4_i8_kernel` (pallas_call at line 306,
// entry `_q4_matmul_i8`) and `_q8_i8_kernel` (pallas_call at line 233, entry
// `_q8_matmul_i8`), which `qmatmul_pallas` takes for M <= 32 when
// ZGML_TPU_I8DOT is on (qmatmul.py:639,728), and `_q4_i8_argmax_kernel` /
// `_q8_i8_argmax_kernel` (pallas_calls at lines 462 / 444, entry
// `qmatmul_greedy_pallas`: one live row, the argmax id with the first index
// on ties).
//
// Semantics (the plain versions are ops/qmatmul.py qmatmul_i8_ref and
// greedy_ref), as the JAX `_quantize_act` + `_block_dot`:
//   per row m and 32-block b of x: s = amax|x_b| / 127, inv = 1/s (0 when
//   s == 0), xq = clip(rint(x * inv), -127, 127) (round half to even, IEEE
//   division: this file must not be built with fast math, so xq and xs are
//   bit-equal to the JAX package's);
//   y[m, n] = sum_b float(sum_j xq_j * level_j) * (xs[m, b] * d[n, b]),
//   level = nibble - 8 (Q4_0; the JAX kernel folds the -8 out, the sum is
//   the same integer) or the int8 q (Q8_0).
// The int8 block dots are exact; only the f32 sum over blocks is taken in
// another order than on the TPU.
//
// What bounds it on the H100: HBM bytes of the weight (0.5625 bytes per
// weight at Q4_0, 1.0625 at Q8_0, read once per group of 4 rows), like K2's
// GEMV: the __dp4a work per weight byte is far below the card's integer
// rate, so the bound counted for it is the bytes one. The int8 path cuts the
// per-weight ALU work from one f32 FMA plus an unpack to a quarter of a
// __dp4a.
//
// What the design does about it:
//   * A pre-pass launched from the same entry point quantizes x: one warp per
//     32-block, lane j holding element j (warp max for amax).
//   * GEMV: one warp per output row; lane l reads whole weight blocks l,
//     l+32, ... (one or two 16-byte loads: 512 or 1024 contiguous bytes per
//     warp) and takes 8 __dp4a against the block's activation words (Q4_0
//     first turns its nibbles into 8 words of signed bytes: mask, shift,
//     __vsubss4 of 8 per byte). Up to 4 rows of x share each weight load
//     (blockIdx.y walks groups of 4 rows); the rows' xq words sit in shared
//     memory with 9 words per 8-word block, so the 32 lanes hit 32 banks.
//   * K5 runs the same per-row device function (qi8_row) with the same
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
template <class F>
__device__ __forceinline__ void qi8_row(const uint8_t* __restrict__ wq,
                                        const __half* __restrict__ wd, const int* xq_s,
                                        const float* xs_s, int rg, int nblk, int lane,
                                        float (&acc)[I8_ROWS]) {
#pragma unroll
  for (int r = 0; r < I8_ROWS; ++r) acc[r] = 0.f;
  for (int b = lane; b < nblk; b += 32) {
    uint32_t w[F::WORDS];
    load_block<F>(wq, b, w);
    int wi[8];
    F::to_i8(w, wi);                       // unpacked once for every row of x
    const float sw = __half2float(wd[b]);
#pragma unroll
    for (int r = 0; r < I8_ROWS; ++r) {
      if (r < rg) {
        const int isum = dot_i8(wi, xq_s + (r * nblk + b) * XW);
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

template <class F, bool ARGMAX>
__global__ void __launch_bounds__(I8_WARPS * 32)
qi8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ xs,
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
  if (n < N) qi8_row<F>(qs + (size_t)n * nblk * F::BYTES, d + (size_t)n * nblk, xq_s, xs_s, rg,
                        nblk, lane, acc);
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

template <class F>
int launch_gemv(const int8_t* xq, const float* xs, const uint8_t* qs, const __half* d, float* y,
                int M, int N, int K, cudaStream_t st) {
  const size_t smem = gemv_smem(min(M, I8_ROWS), K);
  const int rc = allow_dynamic_smem(qi8_gemv_kernel<F, false>, smem);
  if (rc != 0) return rc;
  const dim3 grid((N + I8_WARPS - 1) / I8_WARPS, (M + I8_ROWS - 1) / I8_ROWS);
  qi8_gemv_kernel<F, false><<<grid, I8_WARPS * 32, smem, st>>>(xq, xs, qs, d, y, nullptr,
                                                               nullptr, M, N, K);
  return (int)cudaGetLastError();
}

template <class F>
int launch_greedy(const int8_t* xq, const float* xs, const uint8_t* qs, const __half* d,
                  unsigned long long* ws, long long* out_id, int N, int K, cudaStream_t st) {
  const size_t smem = gemv_smem(1, K);
  const int rc = allow_dynamic_smem(qi8_gemv_kernel<F, true>, smem);
  if (rc != 0) return rc;
  qi8_gemv_kernel<F, true><<<(N + I8_WARPS - 1) / I8_WARPS, I8_WARPS * 32, smem, st>>>(
      xq, xs, qs, d, nullptr, ws, out_id, 1, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// The pre-pass alone: x f32 [M, K] -> xq int8 [M, K], xs f32 [M, K/32].
ZGML_EXPORT int zgml_i8_quantize(const float* x, int8_t* xq, float* xs, int M, int K,
                                 void* stream) {
  if (M <= 0 || K <= 0 || K % 32 != 0) return ZGML_ERR_SHAPE;
  return quantize(x, xq, xs, M, K, nullptr, static_cast<cudaStream_t>(stream));
}

// K1, kind 0 (q4_0) or 1 (q8_0): x f32 [M, K] -> y f32 [M, N]; xq int8 [M, K]
// and xs f32 [M, K/32] are the wrapper's scratch (filled by the pre-pass); qs
// [N, K/32 * BYTES], d fp16 [N, K/32]. All contiguous, on `stream`.
ZGML_EXPORT int zgml_qmatmul_i8(int kind, const float* x, int8_t* xq, float* xs,
                                const uint8_t* qs, const void* d, float* y, int M, int N, int K,
                                void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 32 != 0) return ZGML_ERR_SHAPE;
  if (kind != 0 && kind != 1) return ZGML_ERR_KIND;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rc = quantize(x, xq, xs, M, K, nullptr, st);
  if (rc != 0) return rc;
  const __half* dh = static_cast<const __half*>(d);
  ZGML_DISPATCH_KIND(kind, return launch_gemv<F>(xq, xs, qs, dh, y, M, N, K, st))
}

// K5, kind 0 (q4_0) or 1 (q8_0): one row x f32 [K] -> out_id int64 [1] =
// argmax_n of K1's y (first index on ties); ws is 16 bytes of scratch, zeroed
// by the pre-pass.
ZGML_EXPORT int zgml_greedy(int kind, const float* x, int8_t* xq, float* xs, const uint8_t* qs,
                            const void* d, void* ws, long long* out_id, int N, int K,
                            void* stream) {
  if (N <= 0 || K <= 0 || K % 32 != 0) return ZGML_ERR_SHAPE;
  if (kind != 0 && kind != 1) return ZGML_ERR_KIND;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* w = static_cast<unsigned long long*>(ws);
  const int rc = quantize(x, xq, xs, 1, K, w, st);
  if (rc != 0) return rc;
  const __half* dh = static_cast<const __half*>(d);
  ZGML_DISPATCH_KIND(kind, return launch_greedy<F>(xq, xs, qs, dh, w, out_id, N, K, st))
}
