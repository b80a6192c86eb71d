// K6 fused_ffn_norm: y = x + down(silu(gate(n)) * up(n)), n = rmsnorm(x) * g,
// for M <= 32 rows, in one launch: f32 dequant at Q4_0 (K6d) or Q8_0 (K6a),
// or at Q4_0 with int8 gate|up (K6c). K6a's no-norm form (g null): y =
// down(silu(gate(x)) * up(x)), no norm and no residual, the JAX kernel's
// form behind `fused_ffn_pallas` (`_ffn_impl` with g zeros and norm_eps None,
// ffn.py:644-650), which the JAX package runs for a Q8_0 FFN call of <= 32
// rows in `_layer_step`; the port runs it there under autograd (the fused
// FFN's forward, ops/ffn.FusedFFN).
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
// kernel, run here in the kernel's prologue (weight_stream.cuh stage_norm_i8,
// bit-equal to the JAX pre-pass on the same normed row), gate and up are
// exact `__dp4a` int8 block dots (ws::dot_i8), and the down projection stays
// f32 dequant.
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
// What the design does about it (weight_stream.cuh): one persistent block an
// SM (the grid of ops/decode_plan.py ffn_plan, launched cooperatively with no
// occupancy query), 16 consumer warps and a producer warp. The rows go in
// groups of MR (1, 2 or 4: the plan's, as many as its staging leaves a ring
// for); for each group the producer streams the block's w_gate_up rows, then
// its w_down rows, with 1D bulk copies (TMA) through a ring of shared-memory
// slots, from kernel entry on and across the grid barriers, which only the
// consumers pass (a warp-per-row GEMV that loads as it dots holds too few
// bytes in flight to reach HBM's rate, and can ask for no w_down byte before
// its barrier). Per group:
//   1. the consumers stage n of the group's rows (their own rmsnorm; K6c
//      quantizes it there) while the first slots land; a unit is a run of
//      rows f and the same rows F + f of w_gate_up, so gate and up meet in
//      one warp, which dots each landed weight block once with every row of
//      the group and writes act[m][f] = silu(gate) * up to a global scratch
//      row;
//   2. after a grid barrier the consumers stage the group's act rows and dot
//      the landed w_down rows (a warp two rows), plus the residual.
// So the weights are read ceil(M / MR) times, not M times. Rows, warps and
// the order of every sum are fixed: no float atomics, the result does not
// change from run to run, and a row's sums run in the same order whatever MR.
#include "layer_phases.cuh"

namespace {

// Bytes of one staged row for gate|up: the normed x, f32 or int8.
template <bool I8>
__host__ __device__ size_t staged_row_bytes(int D) {
  return I8 ? (size_t)ws::xq_words(D) * 4 : (size_t)D / 32 * ws::XPAD * 4;
}

// Bytes of the activation area (ops/decode_plan.py ffn_act_bytes): MR staged
// rows and, behind them, the first group's x rows and g as copied; then MR
// SwiGLU rows for down.
template <int MR, bool I8>
size_t ffn_act_bytes(int D, int F) {
  const size_t gu = MR * staged_row_bytes<I8>(D) + (size_t)(MR + 1) * D * 4;
  const size_t dn = (size_t)MR * F / 32 * ws::XPAD * 4;
  return gu > dn ? gu : dn;
}

template <class F, int MR, bool I8>
__global__ void __launch_bounds__(ws::THREADS, 1) ffn_norm_kernel(FfnParams p, ws::Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  ws::ring_init(smem, a.ring);
  const int groups = (p.M + MR - 1) / MR;
  // the first group's x rows and g, copied ahead of the weights where both
  // are 16-byte aligned (the later groups' rows, and every row of the
  // no-norm form, are read as they are)
  float* xin = reinterpret_cast<float*>(smem + a.ring.act_off + MR * staged_row_bytes<I8>(p.D));
  const int rows0 = p.M < MR ? p.M : MR;
  const bool norm = p.g != nullptr;
  const bool copy_x = norm && ws::aligned16(p.x) && ws::aligned16(p.g);
  if (threadIdx.x >= ws::CONSUMERS) {      // the producer warp: one thread copies
    if (threadIdx.x == ws::CONSUMERS) {
      if (copy_x) ws::produce_x(smem, xin, p.x, rows0 * p.D * 4, p.g, p.D * 4);
      int range[4], n = 0;
      ws::block_ranges<2>(a.ph, range);
      ws::Gate<2> gate;                    // w_down: `ahead` stages until act is staged
      for (int gi = 0; gi < groups; ++gi) {
        ws::produce<F>(smem, a.ring, a.ph[0], range[0], range[1], n, gate, gi > 0);
        if (gi == 0) gate.start(a.ph, range, a.ring.ahead);
        ws::produce<F>(smem, a.ring, a.ph[1], range[2], range[3], n, gate, true);
      }
      ws::produce_tail(smem, a.ring, n);
    }
    return;
  }
  ws::CountBarrier gb;
  gb.start(p.bar + 2);
  float* red = ws::red_area(smem);
  float* act = reinterpret_cast<float*>(smem + a.ring.act_off);
  const int lane = threadIdx.x & 31;
  const int nbD = p.D / 32, nbF = p.F / 32;
  const int xs_row = nbD * ws::XPAD, xa_row = nbF * ws::XPAD, xq_row = ws::xq_words(p.D);
  constexpr int R = ws::ITEM_ROWS;
  int n = 0;
  for (int gi = 0; gi < groups; ++gi) {
    const int m0 = gi * MR, rows = p.M - m0 < MR ? p.M - m0 : MR;
    // 1. gate|up + SwiGLU
    const float* xr = p.x + (size_t)m0 * p.D;
    const float* gr = p.g;
    if (gi == 0 && copy_x) {
      ws::mbar_wait(ws::x_bar(smem), 0);
      xr = xin;
      gr = xin + rows0 * p.D;
    }
    for (int m = 0; m < MR; ++m) {         // rows past the group's end stay 0
      const size_t row = (size_t)(m0 + m);
      if constexpr (I8) {
        int* xq = reinterpret_cast<int*>(act) + m * xq_row;
        if (m < rows) {
          ws::stage_norm_i8(xr + (size_t)m * p.D, gr, p.D, p.eps, xq, red,
                            p.xq_out ? p.xq_out + row * p.D : nullptr,
                            p.xs_out ? p.xs_out + row * nbD : nullptr);
        } else {
          ws::zero_words(reinterpret_cast<uint32_t*>(xq), xq_row);
        }
      } else if (m < rows && norm) {
        ws::stage_norm(xr + (size_t)m * p.D, gr, p.D, p.eps, act + m * xs_row, red);
      } else if (m < rows) {               // the no-norm form: the row as it is
        const float* src = xr + (size_t)m * p.D;
        float* dst = act + m * xs_row;
        for (int i = threadIdx.x; i < p.D; i += ws::CONSUMERS)
          dst[(i >> 5) * ws::XPAD + (i & 31)] = src[i];
      } else {
        ws::zero_words(reinterpret_cast<uint32_t*>(act + m * xs_row), xs_row);
      }
    }
    ws::sync();
    ws::consume<F, R>(smem, a.ring, a.ph[0], n, [&](const ws::StageView<F>& v, int i, int row) {
      int j[R], at[R];
      ws::item_rows<R>(v, i, j, at);
      float acc[R][MR];
      if constexpr (I8) {
        ws::dot_i8<F, R, MR>(v, j, reinterpret_cast<const int*>(act), xq_row, lane, acc);
      } else {
        ws::dot_f32<F, R, MR>(v, j, act, xs_row, lane, acc);
      }
#pragma unroll
      for (int r = 0; r < R; r += 2)       // (gate f, up f)
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const float gate = warp_sum(acc[r][m]);
          const float up = warp_sum(acc[r + 1][m]);
          if (lane == 0 && m < rows) {
            const float sig = 1.0f / (1.0f + expf(-gate));
            p.act[(size_t)(m0 + m) * p.F + row + at[r]] = (gate * sig) * up;
          }
        }
    });
    gb.wait();
    // 2. down + residual
    for (int m = 0; m < MR; ++m) {
      if (m < rows) {
        ws::stage_rows(p.act + (size_t)(m0 + m) * p.F, p.F, act + m * xa_row);
      } else {
        ws::zero_words(reinterpret_cast<uint32_t*>(act + m * xa_row), xa_row);
      }
    }
    // w_down and the next group's gate|up may stream in full (the next
    // group's gate|up held at `ahead` stages until its rows are staged was
    // slower at M 8: PERF.md)
    ws::release(smem, 2 * gi + 2);
    ws::consume<F, R>(smem, a.ring, a.ph[1], n, [&](const ws::StageView<F>& v, int i, int row) {
      int j[R], at[R];
      ws::item_rows<R>(v, i, j, at);
      float acc[R][MR];
      ws::dot_f32<F, R, MR>(v, j, act, xa_row, lane, acc);
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          const float s = warp_sum(acc[r][m]);
          if (lane == 0 && m < rows) {
            const size_t o = (size_t)(m0 + m) * p.D + row + at[r];
            p.y[o] = norm ? __ldcg(p.x + o) + s : s;
          }
        }
    });
    ws::sync();                            // the area is restaged for the next group
  }
}

template <class F, int MR, bool I8>
int launch(const FfnParams& p, const int* plan, const int* bounds, int device, cudaStream_t st) {
  static std::atomic<unsigned> ready{0};
  ws::Args a{{ws::plan_phase(plan, 0, p.gu_qs, p.gu_d, bounds, p.D),
              ws::plan_phase(plan, 1, p.dn_qs, p.dn_d, bounds, p.F)},
             {plan[1], plan[2], ws::HEADER_BYTES + plan[1] * plan[2], plan[7]}, nullptr};
  // the plan's phases: gate|up over F (gate row, up row) pairs, down over D rows
  if (plan[5] != MR || plan[6] != 2 || a.ph[0].segs != 2 || a.ph[0].seg_off != p.F || a.ph[1].segs != 1 ||
      !ws::plan_fits<F>(plan, a.ph, 2, ffn_act_bytes<MR, I8>(p.D, p.F)))
    return ZGML_ERR_SMEM;
  return ws::launch(ffn_norm_kernel<F, MR, I8>, p, a, plan[0], plan[4], device, ready, st);
}

// The plan's row group (plan[5]).
template <class F, bool I8>
int launch_rows(const FfnParams& p, const int* plan, const int* bounds, int device,
                cudaStream_t st) {
  switch (plan[5]) {
    case 1: return launch<F, 1, I8>(p, plan, bounds, device, st);
    case 2: return launch<F, 2, I8>(p, plan, bounds, device, st);
    case 4: return launch<F, 4, I8>(p, plan, bounds, device, st);
    default: return ZGML_ERR_SHAPE;
  }
}

}  // namespace

// kind 0 (q4_0) or 1 (q8_0); a_i8 1 for K6c (q4_0 only: then xq_out int8
// [M, D] and xs_out f32 [M, D/32] receive its activations unless null), 0 for
// the f32 K6d / K6a; x f32 [M, D], g f32 [D] (null: the no-norm form, no norm
// and no residual; f32 only), w_gate_up (qs [2F, D/32 *
// BYTES], d fp16 [2F, D/32]), w_down (qs [D, F/32 * BYTES], d fp16 [D, F/32]),
// the planes 16-byte aligned -> y f32 [M, D]; act f32 [M, F] scratch; bar:
// two uint32 words of a zeroed workspace; plan: the host ints of
// ops/decode_plan.py ffn_plan (host_ints), bounds: its int32 [2, grid + 1]
// range bounds on the card; device: the card's index. All contiguous.
ZGML_EXPORT int zgml_ffn_norm(int kind, int a_i8, const float* x, const float* g,
                              const uint8_t* gu_qs, const void* gu_d, const uint8_t* dn_qs,
                              const void* dn_d, float* y, float* act, unsigned int* bar,
                              int8_t* xq_out, float* xs_out, int M, int D, int F, float eps,
                              const int* plan, const int* bounds, int device, void* stream) {
  if (M <= 0 || M > 32 || D <= 0 || F <= 0 || D % 32 != 0 || F % 32 != 0 || plan == nullptr ||
      bounds == nullptr || (a_i8 && g == nullptr))
    return ZGML_ERR_SHAPE;
  const FfnParams p{x, g, gu_qs, static_cast<const __half*>(gu_d), dn_qs,
                    static_cast<const __half*>(dn_d), y, act, bar, xq_out, xs_out, M, D, F, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_i8) {    // the JAX package has no int8 FFN at Q8_0
    return kind == 0 ? launch_rows<FmtQ4_0, true>(p, plan, bounds, device, st)
                     : (int)ZGML_ERR_KIND;
  }
  ZGML_DISPATCH_KIND(kind, return launch_rows<F, false>(p, plan, bounds, device, st))
}
