// K6 fused_ffn_norm: y = x + down(silu(gate(n)) * up(n)), n = rmsnorm(x) * g,
// for M <= 32 rows, in one launch: f32 dequant at Q4_0 (K6d) or Q8_0 (K6a),
// or at Q4_0 with int8 gate|up (K6c).
//
// Replaces: zgml_tpu/ops/ffn.py `_ffn_q4n_kernel` (pallas_call at line 459,
// entry `fused_ffn_norm_q4n`), which the JAX package's fused decode runs
// after the layer kernel at Q4_0 (models/llama.py `_ffn_after_attn`), and
// `_ffn_kernel` (pallas_call at line 100, entries `fused_ffn_norm_pallas` /
// `fused_ffn_pallas`), which it runs there at Q8_0 and for the FFN of
// `_layer_step` calls of <= 32 rows (models/llama.py:326-340, 498-500). The
// JAX kernels read a planar (Q8_0) or N-packed (Q4_0) copy of the FFN
// weights; the port reads its one resident copy: w_gate_up [2F, D] (gate
// rows, then up rows) and w_down [D, F], N-major GGUF blocks
// (quant/packed.py; the block formats are common.cuh's FmtQ4_0 / FmtQ8_0).
// K6c replaces `_ffn_q4n_i8_kernel` (pallas_call at line 416, reached from
// fused_ffn_norm_q4n, ffn.py:524-542), which the JAX package runs in K6d's
// place where ZGML_TPU_FFN_I8A holds (by default at padded d >= 4096): the
// rmsnorm and the per-32-block quantization of n, which JAX runs outside its
// kernel, run here in the kernel's prologue (common.cuh stage_rmsnorm_i8,
// bit-equal to the JAX pre-pass on the same normed row), gate and up are K1's
// exact `__dp4a` block dots, and the down projection stays f32 dequant.
//
// Semantics (the plain version is ops/ffn.py fused_ffn_norm_ref): per row,
// n = x * rsqrt(mean(x^2) + eps) * g; act[f] = (gate_f * sigmoid(gate_f)) * up_f;
// y[j] = x[j] + sum_f act[f] * w_down[j, f]; f32 throughout, except K6c's
// gate_f / up_f = sum_b xs_b d_b(f) sum_j xq_bj level_bj(f) on the quantized n.
//
// What bounds it on the H100: HBM bytes of the two weights (3 * D * F bytes
// per weight times 0.5625 at Q4_0 or 1.0625 at Q8_0: 19.5 / 36.8 MB at
// TinyLlama-1.1B) read once per group of rows; the work between them (SwiGLU
// on F values) is tiny, but the down projection needs all of act.
//
// What the design does about it: one cooperative launch (every block
// resident, grid sized by the occupancy query) that takes the rows in groups
// of up to MR (MR = 1 for one row, up to 4 when shared memory allows), two
// phases per group:
//   1. every block stages n of the group's rows in shared memory (its own
//      rmsnorm; K6c quantizes it there), then each warp owns rows f and F + f
//      of w_gate_up, so gate and up meet in one warp's registers; each weight
//      block is loaded once and dotted with every row of the group, and the
//      warp writes act[m][f] = silu(gate) * up to a global scratch row;
//   2. after a grid barrier each block stages the group's act rows in shared
//      memory and runs a warp-per-row GEMV over w_down, again one load per
//      weight block for all rows of the group, plus the residual.
// So the weights are read ceil(M / MR) times, not M times. Rows, warps and
// the order of every sum are fixed: no float atomics, the result does not
// change from run to run, and a row's sums run in the same order whatever MR.
#include "common.cuh"

namespace {

constexpr int FFN_THREADS = 512;
constexpr int FFN_WARPS = FFN_THREADS / 32;

struct FfnParams {
  const float* x;          // [M, D]
  const float* g;          // [D]
  const uint8_t* gu_qs;    // [2F, D/32 * BYTES]
  const __half* gu_d;      // [2F, D/32]
  const uint8_t* dn_qs;    // [D, F/32 * BYTES]
  const __half* dn_d;      // [D, F/32]
  float* y;                // [M, D]
  float* act;              // [M, F] scratch
  unsigned int* bar;       // grid-barrier words
  int8_t* xq_out;          // [M, D] or null: K6c's activations, for checks
  float* xs_out;           // [M, D/32] or null: their scales
  int M, D, F;
  float eps;
};

// Shared floats per staged row: [max(D, F)/32][33].
__host__ __device__ inline size_t ffn_row_floats(int D, int F) {
  return (size_t)(D > F ? D : F) / 32 * 33;
}

// R weight rows against the MR x rows staged at xs + m * stride ([K/32][33]
// each): lane l takes blocks l, l+32, ...; each block is loaded and each of
// its levels converted once, and dotted with every x row in block_dot_f32's
// order.
template <class F, int R, int MR>
__device__ __forceinline__ void rows_f32_mr(const uint8_t* const (&qs)[R],
                                            const __half* const (&d)[R], const float* xs,
                                            int stride, int nblk, int lane,
                                            float (&acc)[R][MR]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MR; ++m) acc[r][m] = 0.f;
  for (int b = lane; b < nblk; b += 32) {
    uint32_t w[R][F::WORDS];
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      load_block<F>(qs[r], b, w[r]);
      s[r] = __half2float(d[r][b]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float sum[MR];
#pragma unroll
      for (int m = 0; m < MR; ++m) sum[m] = 0.f;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int j = F::elem(t);
        const float v = F::level(w[r], j);
#pragma unroll
        for (int m = 0; m < MR; ++m) sum[m] = fmaf(v, xs[(size_t)m * stride + b * 33 + j], sum[m]);
      }
#pragma unroll
      for (int m = 0; m < MR; ++m) acc[r][m] = fmaf(sum[m], s[r], acc[r][m]);
    }
  }
}

template <class F, int MR, bool I8>
__global__ void __launch_bounds__(FFN_THREADS) ffn_norm_kernel(FfnParams p) {
  extern __shared__ __align__(16) float smem[];
  float* red = smem;                       // 32 floats
  float* xs = smem + 32;                   // MR rows of [max(D, F)/32][33]
  const int stride = (int)ffn_row_floats(p.D, p.F);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * FFN_WARPS + warp;
  const int nwarps = gridDim.x * FFN_WARPS;
  const int nbD = p.D / 32, nbF = p.F / 32;
  int* xq = reinterpret_cast<int*>(xs);    // K6c: MR rows of [D/32][XQ_WORDS] words,
  float* xsc = xs + MR * nbD * XQ_WORDS;   // then MR rows of [D/32] scales

  for (int m0 = 0; m0 < p.M; m0 += MR) {
    const int rows = p.M - m0 < MR ? p.M - m0 : MR;
    for (int m = 0; m < MR; ++m) {         // rows past the group's end stay 0
      const size_t row = (size_t)(m0 + m);
      if constexpr (I8) {
        if (m < rows) {
          stage_rmsnorm_i8(p.x + row * p.D, p.g, p.D, p.eps, xq + m * nbD * XQ_WORDS,
                           xsc + m * nbD, red, p.xq_out ? p.xq_out + row * p.D : nullptr,
                           p.xs_out ? p.xs_out + row * nbD : nullptr);
        } else {
          for (int i = threadIdx.x; i < nbD * XQ_WORDS; i += blockDim.x)
            xq[m * nbD * XQ_WORDS + i] = 0;
          for (int i = threadIdx.x; i < nbD; i += blockDim.x) xsc[m * nbD + i] = 0.f;
        }
      } else if (m < rows) {
        stage_rmsnorm(p.x + row * p.D, p.g, p.D, p.eps, xs + (size_t)m * stride, red);
      } else {
        for (int i = threadIdx.x; i < nbD * 33; i += blockDim.x)
          xs[(size_t)m * stride + i] = 0.f;
      }
    }
    __syncthreads();
    for (int f = gwarp; f < p.F; f += nwarps) {
      const uint8_t* qs[2] = {p.gu_qs + (size_t)f * nbD * F::BYTES,
                              p.gu_qs + (size_t)(p.F + f) * nbD * F::BYTES};
      const __half* dd[2] = {p.gu_d + (size_t)f * nbD, p.gu_d + (size_t)(p.F + f) * nbD};
      float acc[2][MR];
      if constexpr (I8) {
        rows_i8<F, 2, MR>(qs, dd, xq, nbD * XQ_WORDS, xsc, nbD, nbD, lane, acc);
      } else {
        rows_f32_mr<F, 2, MR>(qs, dd, xs, stride, nbD, lane, acc);
      }
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float gate = warp_sum(acc[0][m]);
        const float up = warp_sum(acc[1][m]);
        if (lane == 0 && m < rows) {
          const float sig = 1.0f / (1.0f + expf(-gate));
          p.act[(size_t)(m0 + m) * p.F + f] = (gate * sig) * up;
        }
      }
    }
    grid_barrier(p.bar);

    for (int m = 0; m < MR; ++m) {
      if (m < rows) {
        stage_padded(p.act + (size_t)(m0 + m) * p.F, p.F, xs + (size_t)m * stride);
      } else {
        for (int i = threadIdx.x; i < nbF * 33; i += blockDim.x)
          xs[(size_t)m * stride + i] = 0.f;
      }
    }
    __syncthreads();
    for (int j = gwarp; j < p.D; j += nwarps) {
      const uint8_t* qs[1] = {p.dn_qs + (size_t)j * nbF * F::BYTES};
      const __half* dd[1] = {p.dn_d + (size_t)j * nbF};
      float acc[1][MR];
      rows_f32_mr<F, 1, MR>(qs, dd, xs, stride, nbF, lane, acc);
#pragma unroll
      for (int m = 0; m < MR; ++m) {
        const float s = warp_sum(acc[0][m]);
        if (lane == 0 && m < rows) {
          const size_t o = (size_t)(m0 + m) * p.D + j;
          p.y[o] = p.x[o] + s;
        }
      }
    }
    __syncthreads();                       // xs is restaged for the next group
  }
}

template <class F, int MR, bool I8>
int launch(const FfnParams& p, cudaStream_t st) {
  // phase 2's f32 act rows fill the area; K6c's int8 rows (10 words per
  // 32 values) fit inside it
  const size_t smem = sizeof(float) * (32 + MR * ffn_row_floats(p.D, p.F));
  const int max_blocks = (p.F + FFN_WARPS - 1) / FFN_WARPS;
  return launch_cooperative(ffn_norm_kernel<F, MR, I8>, FFN_THREADS, smem, max_blocks, p, st);
}

// The widest row group whose staging fits the card's shared memory.
template <class F, bool I8>
int launch_rows(const FfnParams& p, cudaStream_t st) {
  if (p.M == 1) return launch<F, 1, I8>(p, st);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t row_bytes = sizeof(float) * ffn_row_floats(p.D, p.F);
  if (sizeof(float) * 32 + 4 * row_bytes <= (size_t)optin) return launch<F, 4, I8>(p, st);
  if (sizeof(float) * 32 + 2 * row_bytes <= (size_t)optin) return launch<F, 2, I8>(p, st);
  return launch<F, 1, I8>(p, st);
}

}  // namespace

// kind 0 (q4_0) or 1 (q8_0); a_i8 1 for K6c (q4_0 only: then xq_out int8
// [M, D] and xs_out f32 [M, D/32] receive its activations unless null), 0 for
// the f32 K6d / K6a; x f32 [M, D], g f32 [D], w_gate_up (qs [2F, D/32 *
// BYTES], d fp16 [2F, D/32]), w_down (qs [D, F/32 * BYTES], d fp16 [D, F/32])
// -> y f32 [M, D]; act f32 [M, F] scratch; bar: two uint32 words of a zeroed
// workspace. All contiguous.
ZGML_EXPORT int zgml_ffn_norm(int kind, int a_i8, const float* x, const float* g,
                              const uint8_t* gu_qs, const void* gu_d, const uint8_t* dn_qs,
                              const void* dn_d, float* y, float* act, unsigned int* bar,
                              int8_t* xq_out, float* xs_out, int M, int D, int F, float eps,
                              void* stream) {
  if (M <= 0 || M > 32 || D <= 0 || F <= 0 || D % 32 != 0 || F % 32 != 0)
    return ZGML_ERR_SHAPE;
  const FfnParams p{x, g, gu_qs, static_cast<const __half*>(gu_d), dn_qs,
                    static_cast<const __half*>(dn_d), y, act, bar, xq_out, xs_out, M, D, F, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_i8) {    // the JAX package has no int8 FFN at Q8_0
    return kind == 0 ? launch_rows<FmtQ4_0, true>(p, st) : (int)ZGML_ERR_KIND;
  }
  ZGML_DISPATCH_KIND(kind, return launch_rows<F, false>(p, st))
}
