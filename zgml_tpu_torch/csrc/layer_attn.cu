// K7 attn_block: one decode token's attention half-layer in one launch.
//
// Replaces: zgml_tpu/ops/layerkernel.py `_layer_kernel` (pallas_call at line
// 685, entry `_layer_call` / `attn_block_step(..., kv_layer=li)`), which the
// JAX package's default batch-1 decode runs for every layer over the stacked
// cache (models/llama.py:773-811), with `kind` q4_0 or q8_0 (its `_dequant`,
// layerkernel.py:76-88; here common.cuh's FmtQ4_0 / FmtQ8_0 block formats).
// Ported: both A phases (f32, and the int8 `a_i8` one, layerkernel.py:148-190,
// which the JAX package turns on where the padded width is >= 4096), phases B
// and C, both caches (bf16, and the int8 `kv_i8` one, layerkernel.py:223-267,
// which the JAX package runs for every layer of a batch-1 decode with
// `--kv int8`). Not ported: phase E (the FFN merge, off by default).
//
// Semantics (the plain version is ops/layerkernel.py attn_block_ref), for x
// f32 [d] at position pos (an int32 on the device, so a step needs no host
// value):
//   h = x * rsqrt(mean(x^2) + eps) * g;  qkv = h @ dequant(Wqkv)^T, or with
//   a_i8 the int8 block dots of K1 on h quantized per 32-block
//   (sum_b xs_b d_b(n) sum_j xq_bj level_bj(n); the JAX kernel folds the Q4_0
//   -8 out through activation block sums, the signed levels give the same
//   integers);
//   q, k rotated by half-split RoPE (pairs (i, i + hd/2));
//   each query head attends layer li's cache rows j < pos (bf16 -> f32) plus
//   the current token's own f32 k, v as the last column;
//   x_out = x + att @ dequant(Wo)^T.
// The current k, v are also written, rounded to bf16, into cache row pos
// (the JAX package writes all layers' rows after the layer loop; the cache
// contents are the same, and phase B never reads row pos).
// With the int8 cache (kv8; the position-major levels and per-position f32
// scales of quant/kv_cache.py) the rows j < pos are attended as K8 attends
// them (decode_split.cuh: q quantized per head after RoPE, exact `__dp4a`
// scores times q_scale * k_scale * scale, the V scales folded into p), the
// self column stays f32 from the unquantized q and k_cur (layerkernel.py:
// 274-289), and row pos is written as k_cur, v_cur quantized per KV head
// (quantize_vec, bit-equal to the plain quantize_columns on the same values;
// llama.py:377-385). qq_out / qs_out, where not null, receive the quantized
// q, so a check can feed the plain version the kernel's own levels.
//
// What bounds it on the H100: at short context the weight bytes (wqkv 2.95 MB
// + wo 2.36 MB at TinyLlama-1.1B at Q4_0, 5.57 + 4.46 MB at Q8_0; 28.3 + 9.4
// MB at Llama-2-7B at Q4_0); at pos 2047 the layer's cache slab (1 KB per
// position at TinyLlama, 16 KB at Llama-2-7B) adds ~2 / 33.6 MB. Both are
// read once, so the kernel is bound by HBM bandwidth, and by the grid
// barriers between its phases.
//
// What the design does about it (weight_stream.cuh): one persistent
// block an SM (the grid of ops/decode_plan.py attn_plan, launched
// cooperatively with no occupancy query), 16 consumer warps and a producer
// warp. From kernel entry the producer keeps 1D bulk copies (TMA) of the
// block's wqkv rows, then of its wo rows, in flight through a ring of
// shared-memory slots; it runs ahead across the grid barriers, which only
// the consumers pass, so wo is already streaming while phase B runs (a
// warp-per-row GEMV that loads as it dots holds too few bytes in flight to
// reach HBM's rate, and can ask for no wo byte before the last barrier).
// Phases:
//   A. the consumers norm x into shared memory (with a_i8: quantized there
//      per 32-block, weight_stream.cuh stage_norm_i8, bit-equal to the JAX
//      pre-pass on the same normed row; the JAX package runs that pre-pass
//      outside its kernel) while the first slots land; a unit is a run of
//      RoPE pairs (rows h*hd + i and h*hd + hd/2 + i) of one head, so the
//      rotation stays in one warp: a warp dots both rows of a pair (f32
//      dequant, or with a_i8 exact `__dp4a` block dots), rotates, and writes
//      q (scratch), k and v (f32 outputs, and bf16 into the cache);
//   B. K8's split-KV design (decode_split.cuh, in bf16 or int8): items (KV
//      head, 128-key chunk below pos), looped over the blocks; each block
//      serves the n_rep query heads of its group and writes their partials
//      (o, max, sum) from the activation area, beside the ring; the block
//      that writes a KV head's last item (an arrival count a head) merges
//      its query heads' live chunks and self column (score q . k_cur, value
//      v_cur) into att, so the combine takes no grid barrier of its own;
//      with kv8 the consumers also quantize k_cur, v_cur into row pos (phase
//      B reads the rows below pos only);
//   C. the consumers stage att and dot the landed wo rows (a warp two rows),
//      plus the residual.
// With pos = 0 phase B is empty and att = v_cur. No float atomics: the
// merge takes the chunks in their fixed order, whichever block runs it.
#include "layer_phases.cuh"

namespace {

// Bytes of phase A's staged activations: the normed x, f32 or int8.
template <bool AI8>
__host__ __device__ size_t staged_a_bytes(int d) {
  return AI8 ? (size_t)ws::xq_words(d) * 4 : (size_t)d / 32 * ws::XPAD * 4;
}

// Bytes of the activation area the phases use (ops/decode_plan.py
// attn_act_bytes): phase A's staged row and, behind it, x and g as copied;
// phase B's chunk and an int for each of a block's `items`; phase C's
// staged attention.
template <int D, bool AI8, bool KV8>
size_t attn_act_bytes(int d, int hq, int hkv, int items) {
  const size_t a = staged_a_bytes<AI8>(d) + (size_t)2 * d * 4;
  const size_t b = decode_chunk_smem_bytes<D, KV8>(hq / hkv) + (size_t)4 * items;
  const size_t c = (size_t)hq * D / 32 * ws::XPAD * 4;
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

template <class F, int D, bool AI8, bool KV8>
__global__ void __launch_bounds__(ws::THREADS, 1) layer_attn_kernel(LayerParams p, ws::Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  ws::ring_init(smem, a.ring);
  // x and g, copied ahead of the weights where both are 16-byte aligned
  float* xin = reinterpret_cast<float*>(smem + a.ring.act_off + staged_a_bytes<AI8>(p.d));
  const bool copy_x = ws::aligned16(p.x) && ws::aligned16(p.g);
  if (threadIdx.x >= ws::CONSUMERS) {      // the producer warp: one thread copies
    if (threadIdx.x == ws::CONSUMERS) {
      if (copy_x) ws::produce_x(smem, xin, p.x, p.d * 4, p.g, p.d * 4);
      int range[4], n = 0;
      ws::block_ranges<2>(a.ph, range);
      ws::Gate<2> gate;                    // wo: `ahead` stages until att is staged
      ws::produce<F>(smem, a.ring, a.ph[0], range[0], range[1], n, gate, false);
      gate.start(a.ph, range, a.ring.ahead);
      ws::produce<F>(smem, a.ring, a.ph[1], range[2], range[3], n, gate, true);
      ws::produce_tail(smem, a.ring, n);
    }
    return;
  }
  ws::CountBarrier gb;
  gb.start(p.bar + 2);
  float* red = ws::red_area(smem);
  float* act = reinterpret_cast<float*>(smem + a.ring.act_off);
  const int lane = threadIdx.x & 31;
  const int pos = __ldg(p.pos);
  constexpr int HALF = D / 2;
  constexpr int R = ws::ITEM_ROWS;         // a RoPE pair an item
  int n = 0;

  // A: norm (and quantize) x, then QKV in RoPE pairs, rotate, emit
  const float* xr = p.x;
  const float* gr = p.g;
  if (copy_x) {
    ws::mbar_wait(ws::x_bar(smem), 0);
    xr = xin;
    gr = xin + p.d;
  }
  if constexpr (AI8) {
    ws::stage_norm_i8(xr, gr, p.d, p.eps, reinterpret_cast<int*>(act), red, p.xq_out,
                      p.xs_out);
  } else {
    ws::stage_norm(xr, gr, p.d, p.eps, act, red);
  }
  ws::sync();
  ws::consume<F, R>(smem, a.ring, a.ph[0], n, [&](const ws::StageView<F>& v, int i, int row) {
    int j[R], at[R];
    ws::item_rows<R>(v, i, j, at);
    float acc[R][1];
    if constexpr (AI8) {
      ws::dot_i8<F, R, 1>(v, j, reinterpret_cast<const int*>(act), 0, lane, acc);
    } else {
      ws::dot_f32<F, R, 1>(v, j, act, 0, lane, acc);
    }
    float o[R];
#pragma unroll
    for (int r = 0; r < R; ++r) o[r] = warp_sum(acc[r][0]);
#pragma unroll
    for (int r = 0; r < R; r += 2) {       // the pair (row, row + hd/2) of RoPE
      if (lane != 0) continue;
      float o1 = o[r], o2 = o[r + 1];
      const int r1 = row + at[r], h = r1 / D, ii = r1 % D;
      if (h < p.hq + p.hkv) {              // q and k heads: x*[c,c] + rot(x)*[-s,s]
        const float c = p.cos[ii], s = p.sin[ii];
        const float y1 = o1, y2 = o2;
        o1 = __fsub_rn(__fmul_rn(y1, c), __fmul_rn(y2, s));
        o2 = __fadd_rn(__fmul_rn(y2, c), __fmul_rn(y1, s));
      }
      if (h < p.hq) {
        p.q[h * D + ii] = o1;
        p.q[h * D + ii + HALF] = o2;
      } else {
        const int kvh = h - p.hq;          // 0..hkv-1: k heads, hkv..2hkv-1: v heads
        p.kv_cur[kvh * D + ii] = o1;
        p.kv_cur[kvh * D + ii + HALF] = o2;
        if constexpr (!KV8) {              // kv8: quantized after the combine
          __nv_bfloat16* cache = static_cast<__nv_bfloat16*>(kvh < p.hkv ? p.ck : p.cv);
          const size_t c0 = ((size_t)(kvh % p.hkv) * p.S + pos) * D;
          cache[c0 + ii] = __float2bfloat16_rn(o1);
          cache[c0 + ii + HALF] = __float2bfloat16_rn(o2);
        }
      }
    }
  });
  gb.wait();
  phase_b_merged<D, KV8>(p, act, a.counters);
  gb.wait();

  // C: x_out = x + att @ Wo^T
  ws::stage_rows(p.att, p.hq * D, act);
  ws::release(smem, 1);                    // wo may stream in full
  ws::consume<F, R>(smem, a.ring, a.ph[1], n, [&](const ws::StageView<F>& v, int i, int row) {
    int j[R], at[R];
    ws::item_rows<R>(v, i, j, at);
    float acc[R][1];
    ws::dot_f32<F, R, 1>(v, j, act, 0, lane, acc);
    float o[R];
#pragma unroll
    for (int r = 0; r < R; ++r) o[r] = warp_sum(acc[r][0]);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) p.x_out[row + at[r]] = __ldcg(p.x + row + at[r]) + o[r];
    }
  });
}

template <class F, int D, bool AI8, bool KV8>
int launch(const LayerParams& p, unsigned int* heads, const int* plan, const int* bounds,
           int device, cudaStream_t st) {
  static std::atomic<unsigned> ready{0};
  const int nq = p.hq * D;
  ws::Args a{{ws::plan_phase(plan, 0, p.wqkv_qs, p.wqkv_d, bounds, p.d),
              ws::plan_phase(plan, 1, p.wo_qs, p.wo_d, bounds, nq)},
             {plan[1], plan[2], ws::HEADER_BYTES + plan[1] * plan[2], plan[7]}, heads};
  // the plan's phases: A over the (hq + 2 hkv) hd rows of wqkv in RoPE-pair
  // runs of one head, C over the d rows of wo
  const ws::Phase& pa = a.ph[0];
  const ws::Phase& pc = a.ph[1];
  if (plan[5] != 1 || plan[6] != 2 || pa.segs != 2 || pa.seg_off != D / 2 || pa.group_rows != D ||
      pa.group_units * pa.unit_rows != D / 2 || pc.segs != 1 ||
      !ws::plan_fits<F>(plan, a.ph, 2,
                        attn_act_bytes<D, AI8, KV8>(p.d, p.hq, p.hkv,
                                                    (p.hkv * p.n_split + plan[0] - 1) / plan[0])))
    return ZGML_ERR_SMEM;
  return ws::launch(layer_attn_kernel<F, D, AI8, KV8>, p, a, plan[0], plan[4], device, ready,
                    st);
}

template <class F, bool AI8, bool KV8>
int launch_hd(const LayerParams& p, unsigned int* heads, int hd, const int* plan,
              const int* bounds, int device, cudaStream_t st) {
  switch (hd) {      // the JAX rule's head dims (multiples of 32) up to 256
    case 32: return launch<F, 32, AI8, KV8>(p, heads, plan, bounds, device, st);
    case 64: return launch<F, 64, AI8, KV8>(p, heads, plan, bounds, device, st);
    case 96: return launch<F, 96, AI8, KV8>(p, heads, plan, bounds, device, st);
    case 128: return launch<F, 128, AI8, KV8>(p, heads, plan, bounds, device, st);
    case 160: return launch<F, 160, AI8, KV8>(p, heads, plan, bounds, device, st);
    case 192: return launch<F, 192, AI8, KV8>(p, heads, plan, bounds, device, st);
    case 224: return launch<F, 224, AI8, KV8>(p, heads, plan, bounds, device, st);
    case 256: return launch<F, 256, AI8, KV8>(p, heads, plan, bounds, device, st);
    default: return ZGML_ERR_HEAD_DIM;
  }
}

}  // namespace

// kind 0 (q4_0) or 1 (q8_0), the kind of both weights; a_i8 1 for the int8 A
// phase (then xq_out int8 [d] and xs_out f32 [d/32] receive its activations
// unless null), 0 for the f32 one; kv8 1 for the int8 cache (ck/cv int8
// levels and cks/cvs f32 scales [hkv, S]; qq_out int8 [hq, hd] and qs_out f32
// [hq] receive the quantized q unless null), 0 for the bf16 one (cks, cvs,
// qq_out, qs_out null); x f32 [d], g f32 [d], wqkv (qs [(hq+2hkv)hd, d/32 *
// BYTES], d fp16), wo (qs [d, hq hd/32 * BYTES], d fp16), both planes 16-byte
// aligned, cos/sin f32 [hd/2], ck/cv layer slabs [hkv, S, hd] (written at row
// *pos), pos int32 [1] on the device; outputs x_out f32 [d] and kv_cur f32
// [2, hkv, hd]; scratch f32 q [hq hd], att [hq hd], part [hq, n_split, hd + 2]
// with n_split = zgml_decode_split_count(S) (K8's chunking); bar: two uint32
// words of a zeroed workspace; heads: hkv uint32 words of a zeroed workspace
// (left zeroed). plan: the host ints of ops/decode_plan.py
// attn_plan (host_ints), bounds: its int32 [2, grid + 1] range bounds on the
// card; device: the card's index. All contiguous.
ZGML_EXPORT int zgml_attn_block(int kind, int a_i8, int kv8, const float* x, const float* g,
                                const uint8_t* wqkv_qs, const void* wqkv_d, const uint8_t* wo_qs,
                                const void* wo_d, const float* cos, const float* sin, void* ck,
                                void* cv, float* cks, float* cvs, const int* pos, float* x_out,
                                float* kv_cur, float* q, float* att, float* part,
                                unsigned int* bar, int8_t* xq_out, float* xs_out, int8_t* qq_out,
                                float* qs_out, int d, int hq, int hkv, int hd, int S, float eps,
                                float scale, unsigned int* heads, const int* plan,
                                const int* bounds, int device, void* stream) {
  if (d <= 0 || d % 32 != 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || S <= 0 ||
      (kv8 != 0) != (cks != nullptr && cvs != nullptr) || heads == nullptr || plan == nullptr ||
      bounds == nullptr)
    return ZGML_ERR_SHAPE;
  const LayerParams p{x, g, wqkv_qs, static_cast<const __half*>(wqkv_d), wo_qs,
                      static_cast<const __half*>(wo_d), cos, sin, ck, cv, cks, cvs, pos,
                      x_out, kv_cur, q, att, part, bar, xq_out, xs_out, qq_out, qs_out, d, hq,
                      hkv, S, (S + DA_CHUNK - 1) / DA_CHUNK, eps, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_i8 && kv8) {
    ZGML_DISPATCH_KIND(kind, return launch_hd<F, true, true>(p, heads, hd, plan, bounds, device, st))
  }
  if (a_i8) {
    ZGML_DISPATCH_KIND(kind, return launch_hd<F, true, false>(p, heads, hd, plan, bounds, device, st))
  }
  if (kv8) {
    ZGML_DISPATCH_KIND(kind, return launch_hd<F, false, true>(p, heads, hd, plan, bounds, device, st))
  }
  ZGML_DISPATCH_KIND(kind, return launch_hd<F, false, false>(p, heads, hd, plan, bounds, device, st))
}
