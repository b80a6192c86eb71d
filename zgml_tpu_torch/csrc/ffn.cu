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
// The two phases are layer_phases.cuh's, which the whole-stack kernels
// (stack_decode.cu) run for every layer.
#include "layer_phases.cuh"

namespace {

template <class F, int MR, bool I8>
__global__ void __launch_bounds__(FFN_THREADS) ffn_norm_kernel(FfnParams p) {
  extern __shared__ __align__(16) float smem[];
  for (int m0 = 0; m0 < p.M; m0 += MR) {
    const int rows = p.M - m0 < MR ? p.M - m0 : MR;
    ffn_phase_gu<F, MR, I8, false>(p, m0, rows, smem);
    grid_barrier(p.bar);
    ffn_phase_down<F, MR, false>(p, m0, rows, smem);
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
