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
// read once, so the kernel is bound by HBM bandwidth and by the three grid
// barriers between its phases.
//
// What the design does about it: one cooperative launch (every block
// resident, grid sized by the occupancy query), phases separated by a grid
// barrier:
//   A. every block computes the rmsnorm of x into shared memory (with a_i8:
//      quantized there per 32-block, common.cuh stage_rmsnorm_i8, bit-equal
//      to the JAX pre-pass on the same normed row; the JAX package runs that
//      pre-pass outside its kernel, here it costs no third launch); each warp
//      owns one RoPE pair of QKV rows (i, i + hd/2) of one head, so the
//      rotation stays in the warp: f32-dequant GEMV of both rows (with a_i8
//      `__dp4a` block dots, common.cuh rows_i8), rotate, and write q
//      (scratch), k and v (f32 outputs, and bf16 into the cache);
//   B. K4's split-KV design (decode_split.cuh, K8's with kv8): items (KV
//      head, 128-key chunk below pos), looped over the blocks; each block
//      serves the n_rep query heads of its group and writes their partials
//      (o, max, sum);
//   combine: one warp per query head merges the live chunks and the self
//      column (score q . k_cur, value v_cur) and writes att; with kv8 one
//      warp per KV head and tensor then quantizes k_cur, v_cur into row pos
//      (no grid barrier more: phase B has read every row below pos);
//   C. a warp-per-row GEMV over Wo against att in shared memory, plus the
//      residual.
// With pos = 0 phase B is empty and att = v_cur. No float atomics. The phases
// are layer_phases.cuh's, which the whole-stack kernels (stack_decode.cu) run
// for every layer.
#include "layer_phases.cuh"

namespace {

template <class F, int D, bool AI8, bool KV8>
__global__ void __launch_bounds__(LK_THREADS) layer_attn_kernel(LayerParams p) {
  extern __shared__ __align__(16) float smem[];
  attn_phase_a<F, D, AI8, KV8, false>(p, smem);
  grid_barrier(p.bar);
  attn_phase_b<D, KV8>(p, smem);
  grid_barrier(p.bar);
  attn_combine<D, KV8>(p);
  grid_barrier(p.bar);
  attn_phase_c<F, D, false>(p, smem);
}

template <class F, int D, bool AI8, bool KV8>
int launch(const LayerParams& p, cudaStream_t st) {
  const size_t smem = attn_smem_bytes<D, KV8>(p.d, p.hq, p.hkv);
  // enough warps for the widest warp-per-row phase (A's pairs or C's rows)
  const int max_blocks = (attn_max_warps<D>(p.d, p.hq, p.hkv) + LK_WARPS - 1) / LK_WARPS;
  return launch_cooperative(layer_attn_kernel<F, D, AI8, KV8>, LK_THREADS, smem, max_blocks, p,
                            st);
}

template <class F, bool AI8, bool KV8>
int launch_hd(const LayerParams& p, int hd, cudaStream_t st) {
  switch (hd) {      // the JAX rule's head dims (multiples of 32) up to 256
    case 32: return launch<F, 32, AI8, KV8>(p, st);
    case 64: return launch<F, 64, AI8, KV8>(p, st);
    case 96: return launch<F, 96, AI8, KV8>(p, st);
    case 128: return launch<F, 128, AI8, KV8>(p, st);
    case 160: return launch<F, 160, AI8, KV8>(p, st);
    case 192: return launch<F, 192, AI8, KV8>(p, st);
    case 224: return launch<F, 224, AI8, KV8>(p, st);
    case 256: return launch<F, 256, AI8, KV8>(p, st);
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
// BYTES], d fp16), wo (qs [d, hq hd/32 * BYTES], d fp16), cos/sin f32
// [hd/2], ck/cv layer slabs [hkv, S, hd] (written at row *pos), pos int32 [1]
// on the device; outputs x_out f32 [d] and kv_cur f32 [2, hkv, hd]; scratch
// f32 q [hq hd], att [hq hd], part [hq, n_split, hd + 2] with n_split =
// zgml_decode_split_count(S) (K4's chunking); bar: two uint32 words of a
// zeroed workspace. All contiguous.
ZGML_EXPORT int zgml_attn_block(int kind, int a_i8, int kv8, const float* x, const float* g,
                                const uint8_t* wqkv_qs, const void* wqkv_d, const uint8_t* wo_qs,
                                const void* wo_d, const float* cos, const float* sin, void* ck,
                                void* cv, float* cks, float* cvs, const int* pos, float* x_out,
                                float* kv_cur, float* q, float* att, float* part,
                                unsigned int* bar, int8_t* xq_out, float* xs_out, int8_t* qq_out,
                                float* qs_out, int d, int hq, int hkv, int hd, int S, float eps,
                                float scale, void* stream) {
  if (d <= 0 || d % 32 != 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || S <= 0 ||
      (kv8 != 0) != (cks != nullptr && cvs != nullptr))
    return ZGML_ERR_SHAPE;
  const LayerParams p{x, g, wqkv_qs, static_cast<const __half*>(wqkv_d), wo_qs,
                      static_cast<const __half*>(wo_d), cos, sin, ck, cv, cks, cvs, pos,
                      x_out, kv_cur, q, att, part, bar, xq_out, xs_out, qq_out, qs_out, d, hq,
                      hkv, S, (S + DA_CHUNK - 1) / DA_CHUNK, eps, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_i8 && kv8) {
    ZGML_DISPATCH_KIND(kind, return launch_hd<F, true, true>(p, hd, st))
  }
  if (a_i8) {
    ZGML_DISPATCH_KIND(kind, return launch_hd<F, true, false>(p, hd, st))
  }
  if (kv8) {
    ZGML_DISPATCH_KIND(kind, return launch_hd<F, false, true>(p, hd, st))
  }
  ZGML_DISPATCH_KIND(kind, return launch_hd<F, false, false>(p, hd, st))
}
