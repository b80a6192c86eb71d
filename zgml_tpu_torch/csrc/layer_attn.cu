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
// `--kv int8`), and phase E (`has_ffn`, layerkernel.py:91-123, 343, 392,
// gated at :758-765 by ZGML_TPU_LAYER_FFN=1, off by default: the layer's
// Q4_0 FFN in the same launch, the f32 function whatever the A phase).
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
// With the f32 cache (the JAX package's init_cache(batch, float32);
// instantiated in layer_attn_f32.cu) the rows j < pos are read in f32 and
// row pos receives k_cur, v_cur as they are (layerkernel.py:311-314).
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
//
// Phase E (template flag E, Q4_0 only, as JAX's has_ffn): after C a grid
// barrier, then K6d's function at one row on x2 = x_out, streamed through
// the same ring as K14 streams a layer (stack_decode.cu): the producer runs
// on from wo into w_gate_up (in (gate row, up row) runs) and w_down, held by
// the Gate (`ahead` stages past the last phase whose rows the consumers
// staged, so gate|up's first slots are in flight while B and C run); the
// consumers copy x2 into shared memory as a raw row (K14's staging of x2:
// read back with __ldcg after the barrier, behind at most `ahead` stages of
// copies), norm it with ffn_norm, dot gate|up into act = silu(gate) * up
// (a global scratch row), and after one more grid barrier dot w_down plus
// the raw row's residual into x_out. The dots, the norm and the SwiGLU are
// K6d's at M 1 in its order, so x_out is bit-equal to the chain K7 + K6d.
#include "layer_attn.cuh"

namespace {

// The modes of one weight format without phase E over the bf16 or the int8
// cache: the A phase and the cache.
template <class F>
int launch_modes(const LayerParams& p, int a_i8, int kv8, unsigned int* heads, int hd,
                 const int* plan, const int* bounds, int device, cudaStream_t st) {
  using B = __nv_bfloat16;
  using I8 = int8_t;
  if (a_i8 && kv8) return launch_hd<F, true, I8, false>(p, heads, hd, plan, bounds, device, st);
  if (a_i8) return launch_hd<F, true, B, false>(p, heads, hd, plan, bounds, device, st);
  if (kv8) return launch_hd<F, false, I8, false>(p, heads, hd, plan, bounds, device, st);
  return launch_hd<F, false, B, false>(p, heads, hd, plan, bounds, device, st);
}

}  // namespace

// kind 0 (q4_0) or 1 (q8_0), the kind of both weights; a_i8 1 for the int8 A
// phase (then xq_out int8 [d] and xs_out f32 [d/32] receive its activations
// unless null), 0 for the f32 one; kv the cache: 1 the int8 one (ck/cv int8
// levels and cks/cvs f32 scales [hkv, S]; qq_out int8 [hq, hd] and qs_out f32
// [hq] receive the quantized q unless null), 0 the bf16 one, 2 the f32 one
// (for both, cks, cvs, qq_out, qs_out null); g2 non-null for phase E (kind 0 only: g2 f32 [d]
// ffn_norm, w_gate_up gu_qs / gu_d [2F, d], w_down dn_qs / dn_d [d, F], the
// planes 16-byte aligned, act f32 [F] scratch; x_out 16-byte aligned), else
// those null and F 0; x f32 [d], g f32 [d], wqkv (qs [(hq+2hkv)hd, d/32 *
// BYTES], d fp16), wo (qs [d, hq hd/32 * BYTES], d fp16), both planes 16-byte
// aligned, cos/sin f32 [hd/2], ck/cv layer slabs [hkv, S, hd] (written at row
// *pos), pos int32 [1] on the device; outputs x_out f32 [d] and kv_cur f32
// [2, hkv, hd]; scratch f32 q [hq hd], att [hq hd], part [hq, n_split, hd + 2]
// with n_split = zgml_decode_split_count(S) (K8's chunking); bar: two uint32
// words of a zeroed workspace; heads: hkv uint32 words of a zeroed workspace
// (left zeroed). plan: the host ints of ops/decode_plan.py
// attn_plan (host_ints), bounds: its int32 [2, grid + 1] range bounds on the
// card; device: the card's index. All contiguous.
ZGML_EXPORT int zgml_attn_block(int kind, int a_i8, int kv, const float* x, const float* g,
                                const uint8_t* wqkv_qs, const void* wqkv_d, const uint8_t* wo_qs,
                                const void* wo_d, const float* cos, const float* sin, void* ck,
                                void* cv, float* cks, float* cvs, const int* pos, float* x_out,
                                float* kv_cur, float* q, float* att, float* part,
                                unsigned int* bar, int8_t* xq_out, float* xs_out, int8_t* qq_out,
                                float* qs_out, int d, int hq, int hkv, int hd, int S, float eps,
                                float scale, unsigned int* heads, const float* g2,
                                const uint8_t* gu_qs, const void* gu_d, const uint8_t* dn_qs,
                                const void* dn_d, float* act, int F, const int* plan,
                                const int* bounds, int device, void* stream) {
  const int e = g2 != nullptr;
  const int kv8 = kv == 1;
  if (d <= 0 || d % 32 != 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || S <= 0 || kv < 0 ||
      kv > 2 || (kv8 != 0) != (cks != nullptr && cvs != nullptr) ||
      (kv != 1 && (qq_out != nullptr || qs_out != nullptr)) || heads == nullptr ||
      plan == nullptr || bounds == nullptr ||
      (e && (F <= 0 || F % 32 != 0 || !gu_qs || !gu_d || !dn_qs || !dn_d || !act ||
             !ws::aligned16(x_out))))
    return ZGML_ERR_SHAPE;
  const LayerParams p{x, g, wqkv_qs, static_cast<const __half*>(wqkv_d), wo_qs,
                      static_cast<const __half*>(wo_d), cos, sin, ck, cv, cks, cvs, pos,
                      x_out, kv_cur, q, att, part, bar, xq_out, xs_out, qq_out, qs_out, d, hq,
                      hkv, S, (S + DA_CHUNK - 1) / DA_CHUNK, eps, scale, g2, gu_qs,
                      static_cast<const __half*>(gu_d), dn_qs, static_cast<const __half*>(dn_d),
                      act, e ? F : 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kv == 2) return launch_attn_f32kv(p, kind, a_i8, e, heads, hd, plan, bounds, device, st);
  if (e)             // JAX's has_ffn: Q4_0 only
    return kind == 0 ? launch_attn_ffn(p, a_i8, kv8, heads, hd, plan, bounds, device, st)
                     : (int)ZGML_ERR_KIND;
  ZGML_DISPATCH_KIND(kind, return launch_modes<F>(p, a_i8, kv8, heads, hd, plan, bounds,
                                                  device, st))
}
