// K7 attn_block: one decode token's attention half-layer in one launch.
//
// Replaces: zgml_tpu/ops/layerkernel.py `_layer_kernel` (pallas_call at line
// 685, entry `_layer_call` / `attn_block_step(..., kv_layer=li)`), which the
// JAX package's default batch-1 decode runs for every layer over the stacked
// cache (models/llama.py:773-811), with `kind` q4_0 or q8_0 (its `_dequant`,
// layerkernel.py:76-88; here common.cuh's FmtQ4_0 / FmtQ8_0 block formats).
// Ported: both A phases (f32, and the int8 `a_i8` one, layerkernel.py:148-190,
// which the JAX package turns on where the padded width is >= 4096), phases B
// and C, the bf16 cache. Not ported: phase E (the FFN merge, off by default)
// and the int8 cache.
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
//   B. K4's split-KV design (decode_split.cuh): items (KV head, 128-key chunk
//      below pos), looped over the blocks; each block serves the n_rep query
//      heads of its group and writes their partials (o, max, sum);
//   combine: one warp per query head merges the live chunks and the self
//      column (score q . k_cur, value v_cur) and writes att;
//   C. a warp-per-row GEMV over Wo against att in shared memory, plus the
//      residual.
// With pos = 0 phase B is empty and att = v_cur. No float atomics.
#include "decode_split.cuh"

namespace {

constexpr int LK_THREADS = 512;
constexpr int LK_WARPS = LK_THREADS / 32;

struct LayerParams {
  const float* x;            // [d]
  const float* g;            // [d] attn_norm
  const uint8_t* wqkv_qs;    // [(hq + 2 hkv) hd, d/32 * BYTES]
  const __half* wqkv_d;      // [(hq + 2 hkv) hd, d/32]
  const uint8_t* wo_qs;      // [d, hq hd / 32 * BYTES]
  const __half* wo_d;        // [d, hq hd / 32]
  const float* cos;          // [hd/2] at pos
  const float* sin;          // [hd/2]
  __nv_bfloat16* ck;         // layer li's slab [hkv, S, hd]
  __nv_bfloat16* cv;
  const int* pos;            // [1], device
  float* x_out;              // [d]
  float* kv_cur;             // [2, hkv, hd]: rotated k, then v
  float* q;                  // [hq, hd] scratch
  float* att;                // [hq, hd] scratch
  float* part;               // [hq, n_split, hd + 2] scratch
  unsigned int* bar;         // grid-barrier words
  int8_t* xq_out;            // [d] or null: a_i8's activations, for checks
  float* xs_out;             // [d/32] or null: their scales
  int d, hq, hkv, S, n_split;
  float eps, scale;
};

template <class F, int D, bool AI8>
__global__ void __launch_bounds__(LK_THREADS) layer_attn_kernel(LayerParams p) {
  extern __shared__ __align__(16) float smem[];
  constexpr int HALF = D / 2;
  float* red = smem;                       // 32 floats
  float* xs = smem + 32;                   // phases A and C: [K/32][33]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * LK_WARPS + warp;
  const int nwarps = gridDim.x * LK_WARPS;
  const int pos = __ldg(p.pos);
  const int n_rep = p.hq / p.hkv;
  const int nq = p.hq * D;

  // -- A: rmsnorm, QKV in RoPE pairs, rotate, emit q / k_cur / v_cur ---------
  const int nbd = p.d / 32;
  int* xq = reinterpret_cast<int*>(xs);    // a_i8: [d/32][XQ_WORDS] words, then
  float* xsc = xs + nbd * XQ_WORDS;        // [d/32] scales, inside xs's area
  if constexpr (AI8) {
    stage_rmsnorm_i8(p.x, p.g, p.d, p.eps, xq, xsc, red, p.xq_out, p.xs_out);
  } else {
    stage_rmsnorm(p.x, p.g, p.d, p.eps, xs, red);
  }
  const int n_pairs = (p.hq + 2 * p.hkv) * HALF;
  for (int t = gwarp; t < n_pairs; t += nwarps) {
    const int h = t / HALF, i = t % HALF;
    const int r1 = h * D + i, r2 = r1 + HALF;
    const uint8_t* qs[2] = {p.wqkv_qs + (size_t)r1 * nbd * F::BYTES,
                            p.wqkv_qs + (size_t)r2 * nbd * F::BYTES};
    const __half* dd[2] = {p.wqkv_d + (size_t)r1 * nbd, p.wqkv_d + (size_t)r2 * nbd};
    float acc[2];
    if constexpr (AI8) {
      float a[2][1];
      rows_i8<F, 2, 1>(qs, dd, xq, 0, xsc, 0, nbd, lane, a);
      acc[0] = a[0][0];
      acc[1] = a[1][0];
    } else {
      rows_f32<F, 2>(qs, dd, xs, nbd, lane, acc);
    }
    float o1 = warp_sum(acc[0]), o2 = warp_sum(acc[1]);
    if (lane == 0) {
      if (h < p.hq + p.hkv) {              // q and k heads: x*[c,c] + rot(x)*[-s,s]
        const float c = p.cos[i], s = p.sin[i];
        const float y1 = o1, y2 = o2;
        o1 = __fsub_rn(__fmul_rn(y1, c), __fmul_rn(y2, s));
        o2 = __fadd_rn(__fmul_rn(y2, c), __fmul_rn(y1, s));
      }
      if (h < p.hq) {
        p.q[h * D + i] = o1;
        p.q[h * D + i + HALF] = o2;
      } else {
        const int kvh = h - p.hq;          // 0..hkv-1: k heads, hkv..2hkv-1: v heads
        p.kv_cur[kvh * D + i] = o1;
        p.kv_cur[kvh * D + i + HALF] = o2;
        __nv_bfloat16* cache = kvh < p.hkv ? p.ck : p.cv;
        const size_t row = ((size_t)(kvh % p.hkv) * p.S + pos) * D;
        cache[row + i] = __float2bfloat16_rn(o1);
        cache[row + i + HALF] = __float2bfloat16_rn(o2);
      }
    }
  }
  grid_barrier(p.bar);

  // -- B: split-KV partials over the cache rows below pos --------------------
  const int n_live = (pos + DA_CHUNK - 1) / DA_CHUNK;
  const size_t head_stride = (size_t)p.n_split * (D + 2);
  for (int item = blockIdx.x; item < p.hkv * n_live; item += gridDim.x) {
    const int hk = item / n_live, split = item % n_live;
    const int c0 = split * DA_CHUNK;
    const size_t base = ((size_t)hk * p.S + c0) * D;
    decode_chunk_partial<D, LK_THREADS>(
        p.q + (size_t)hk * n_rep * D, p.ck + base, p.cv + base, min(DA_CHUNK, pos - c0), n_rep,
        p.scale, p.part + ((size_t)hk * n_rep * p.n_split + split) * (D + 2), head_stride,
        smem);
  }
  grid_barrier(p.bar);

  // -- combine the chunks with the self column -------------------------------
  for (int h = gwarp; h < p.hq; h += nwarps) {
    const int hk = h / n_rep;
    const float* qh = p.q + (size_t)h * D;
    const float* kc = p.kv_cur + (size_t)hk * D;
    const float* vc = p.kv_cur + (size_t)(p.hkv + hk) * D;
    float dot = 0.f;
    for (int c = lane; c < D; c += 32) dot = fmaf(__ldcg(qh + c), __ldcg(kc + c), dot);
    const float s_self = warp_sum(dot) * p.scale;
    const float* ph = p.part + (size_t)h * head_stride;
    float mx = s_self;
    for (int s = 0; s < n_live; ++s) mx = fmaxf(mx, __ldcg(ph + s * (D + 2) + D));
    float num[D / 32], den = 0.f;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) num[j] = 0.f;
    for (int s = 0; s < n_live; ++s) {
      const float* ps = ph + s * (D + 2);
      const float w = expf(__ldcg(ps + D) - mx);
      den = fmaf(w, __ldcg(ps + D + 1), den);
#pragma unroll
      for (int j = 0; j < D / 32; ++j) num[j] = fmaf(w, __ldcg(ps + lane + 32 * j), num[j]);
    }
    const float w = expf(s_self - mx);
    den += w;
#pragma unroll
    for (int j = 0; j < D / 32; ++j) {
      const float o = fmaf(w, __ldcg(vc + lane + 32 * j), num[j]);
      p.att[(size_t)h * D + lane + 32 * j] = o / den;
    }
  }
  grid_barrier(p.bar);

  // -- C: x_out = x + att @ Wo^T ----------------------------------------------
  stage_padded(p.att, nq, xs);
  __syncthreads();
  const int nbq = nq / 32;
  for (int n = gwarp; n < p.d; n += nwarps) {
    const uint8_t* qs[1] = {p.wo_qs + (size_t)n * nbq * F::BYTES};
    const __half* dd[1] = {p.wo_d + (size_t)n * nbq};
    float acc[1];
    rows_f32<F, 1>(qs, dd, xs, nbq, lane, acc);
    const float s = warp_sum(acc[0]);
    if (lane == 0) p.x_out[n] = p.x[n] + s;
  }
}

template <class F, int D, bool AI8>
int launch(const LayerParams& p, cudaStream_t st) {
  const int n_rep = p.hq / p.hkv;
  const int k_max = p.d > p.hq * D ? p.d : p.hq * D;
  size_t smem = sizeof(float) * (32 + (size_t)k_max / 32 * 33);
  const size_t smem_b = decode_chunk_smem_bytes<D>(n_rep);
  if (smem_b > smem) smem = smem_b;
  // enough warps for the widest warp-per-row phase (A's pairs or C's rows)
  const int n_pairs = (p.hq + 2 * p.hkv) * (D / 2);
  const int max_blocks = ((n_pairs > p.d ? n_pairs : p.d) + LK_WARPS - 1) / LK_WARPS;
  return launch_cooperative(layer_attn_kernel<F, D, AI8>, LK_THREADS, smem, max_blocks, p, st);
}

template <class F, bool AI8>
int launch_hd(const LayerParams& p, int hd, cudaStream_t st) {
  switch (hd) {      // the JAX rule's head dims (multiples of 32) up to 256
    case 32: return launch<F, 32, AI8>(p, st);
    case 64: return launch<F, 64, AI8>(p, st);
    case 96: return launch<F, 96, AI8>(p, st);
    case 128: return launch<F, 128, AI8>(p, st);
    case 160: return launch<F, 160, AI8>(p, st);
    case 192: return launch<F, 192, AI8>(p, st);
    case 224: return launch<F, 224, AI8>(p, st);
    case 256: return launch<F, 256, AI8>(p, st);
    default: return ZGML_ERR_HEAD_DIM;
  }
}

}  // namespace

// kind 0 (q4_0) or 1 (q8_0), the kind of both weights; a_i8 1 for the int8 A
// phase (then xq_out int8 [d] and xs_out f32 [d/32] receive its activations
// unless null), 0 for the f32 one; x f32 [d], g f32 [d],
// wqkv (qs [(hq+2hkv)hd, d/32 * BYTES], d fp16), wo (qs [d, hq hd/32 *
// BYTES], d fp16), cos/sin f32 [hd/2], ck/cv bf16 layer slabs [hkv, S, hd]
// (written at row *pos), pos int32 [1] on the device; outputs x_out f32 [d]
// and kv_cur f32 [2, hkv, hd]; scratch f32 q [hq hd], att [hq hd], part [hq,
// n_split, hd + 2] with n_split = zgml_decode_split_count(S) (K4's chunking);
// bar: two uint32 words of a zeroed workspace. All contiguous.
ZGML_EXPORT int zgml_attn_block(int kind, int a_i8, const float* x, const float* g,
                                const uint8_t* wqkv_qs, const void* wqkv_d, const uint8_t* wo_qs,
                                const void* wo_d, const float* cos, const float* sin, void* ck,
                                void* cv, const int* pos, float* x_out, float* kv_cur, float* q,
                                float* att, float* part, unsigned int* bar, int8_t* xq_out,
                                float* xs_out, int d, int hq, int hkv, int hd, int S, float eps,
                                float scale, void* stream) {
  if (d <= 0 || d % 32 != 0 || hq <= 0 || hkv <= 0 || hq % hkv != 0 || S <= 0)
    return ZGML_ERR_SHAPE;
  const LayerParams p{x, g, wqkv_qs, static_cast<const __half*>(wqkv_d), wo_qs,
                      static_cast<const __half*>(wo_d), cos, sin,
                      static_cast<__nv_bfloat16*>(ck), static_cast<__nv_bfloat16*>(cv), pos,
                      x_out, kv_cur, q, att, part, bar, xq_out, xs_out, d, hq, hkv, S,
                      (S + DA_CHUNK - 1) / DA_CHUNK, eps, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_i8) {
    ZGML_DISPATCH_KIND(kind, return launch_hd<F, true>(p, hd, st))
  }
  ZGML_DISPATCH_KIND(kind, return launch_hd<F, false>(p, hd, st))
}
