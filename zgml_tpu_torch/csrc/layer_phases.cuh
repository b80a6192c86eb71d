// The parameters and the attention phase B the batch-1 decode kernels share:
// K7 (layer_attn.cu), K6 (ffn.cu) and the whole-stack megacalls K14 / K15
// (stack_decode.cu), which run K7's phases and K6d's for every layer of a
// stack in one launch. All of them stream their weights (weight_stream.cuh).
//
// Phase B runs on the consumer warps of a block, reads what other blocks
// wrote in the same launch with __ldcg after a grid barrier, and needs the
// caller's grid barrier before anything reads what it wrote.
#pragma once

#include "weight_stream.cuh"

// ---- the attention half-layer (K7) ------------------------------------------

struct LayerParams {
  const float* x;            // [d]
  const float* g;            // [d] attn_norm
  const uint8_t* wqkv_qs;    // [(hq + 2 hkv) hd, d/32 * BYTES]
  const __half* wqkv_d;      // [(hq + 2 hkv) hd, d/32]
  const uint8_t* wo_qs;      // [d, hq hd / 32 * BYTES]
  const __half* wo_d;        // [d, hq hd / 32]
  const float* cos;          // [hd/2] at pos
  const float* sin;          // [hd/2]
  void* ck;                  // layer li's slab [hkv, S, hd]: bf16, f32, or int8 levels (kv8)
  void* cv;
  float* cks;                // kv8: layer li's scales [hkv, S]
  float* cvs;
  const int* pos;            // [1], device
  float* x_out;              // [d]
  float* kv_cur;             // [2, hkv, hd]: rotated k, then v
  float* q;                  // [hq, hd] scratch
  float* att;                // [hq, hd] scratch
  float* part;               // [hq, n_split, hd + 2] scratch
  unsigned int* bar;         // coop.barrier_words: [2..4] the CountBarrier's
  int8_t* xq_out;            // [d] or null: a_i8's activations, for checks
  float* xs_out;             // [d/32] or null: their scales
  int8_t* qq_out;            // kv8: [hq, hd] or null: the quantized q, for checks
  float* qs_out;             // [hq] or null: its scales
  int d, hq, hkv, S, n_split;
  float eps, scale;
  // K7's phase E (layer_attn.cu, E true; K14 leaves these null): the layer's
  // FFN on x2 = the attention half's output
  const float* g2;           // [d] ffn_norm
  const uint8_t* gu_qs;      // w_gate_up [2F, d/32 * BYTES]: gate rows, then up rows
  const __half* gu_d;        // [2F, d/32]
  const uint8_t* dn_qs;      // w_down [d, F/32 * BYTES]
  const __half* dn_d;        // [d, F/32]
  float* act;                // [F] scratch: the SwiGLU row
  int F;
};

// The merge of query head h (one warp): the n_live chunks' partials, in
// chunk order, and the self column (score q . k_cur, value v_cur) into att.
template <int D>
__device__ __forceinline__ void merge_head(const LayerParams& p, int h, int n_live, int lane) {
  const int hk = h / (p.hq / p.hkv);
  const size_t head_stride = (size_t)p.n_split * (D + 2);
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

// Phase B and the combine between one pair of grid barriers: the split-KV
// items (KV head, 128-key chunk below pos; decode_split.cuh, K8's design)
// over the blocks, each writing its query heads' partials; a block that
// wrote its items' partials counts each on its head's word of `heads` (all
// at once, one round trip), and the block that completes a head's count
// merges its n_rep query heads (one warp each, merge_head, the chunks in
// their fixed order) and sets the word back to 0. With no live chunk (pos 0)
// block hk % grid merges head hk. C is the cache element (bf16, f32, or
// int8 levels: kv8). With kv8 the consumers also quantize k_cur, v_cur into
// cache row pos (phase B reads rows below pos only) and, where asked, q into
// qq_out. smem: the phase's area, then `last`'s ints.
template <int D, class C>
__device__ __forceinline__ void phase_b_merged(const LayerParams& p, float* smem,
                                               unsigned int* heads) {
  using T = C;
  constexpr bool KV8 = std::is_same_v<C, int8_t>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int pos = __ldg(p.pos);
  const int n_rep = p.hq / p.hkv;
  const int n_live = (pos + DA_CHUNK - 1) / DA_CHUNK;
  const size_t head_stride = (size_t)p.n_split * (D + 2);
  if constexpr (KV8) {
    const int gwarp = blockIdx.x * ws::WARPS + warp, nwarps = gridDim.x * ws::WARPS;
    for (int t = gwarp; t < 2 * p.hkv; t += nwarps) {
      const size_t at = (size_t)(t % p.hkv) * p.S + pos;
      quantize_vec<D>(p.kv_cur + (size_t)t * D, static_cast<int8_t*>(t < p.hkv ? p.ck : p.cv) +
                      at * D, (t < p.hkv ? p.cks : p.cvs) + at, lane);
    }
    if (p.qq_out != nullptr)
      for (int h = gwarp; h < p.hq; h += nwarps)
        quantize_vec<D>(p.q + (size_t)h * D, p.qq_out + (size_t)h * D, p.qs_out + h, lane);
  }
  if (n_live == 0) {
    for (int hk = blockIdx.x; hk < p.hkv; hk += gridDim.x)
      for (int r = warp; r < n_rep; r += ws::WARPS) merge_head<D>(p, hk * n_rep + r, 0, lane);
    return;
  }
  int* last = reinterpret_cast<int*>(smem + decode_chunk_smem_bytes<D, KV8>(n_rep) / 4);
  const int n_items = p.hkv * n_live;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int hk = item / n_live, split = item % n_live;
    const int c0 = split * DA_CHUNK;
    const size_t pos0 = (size_t)hk * p.S + c0;
    decode_chunk_partial<D, ws::CONSUMERS, T, ws::Sync>(
        p.q + (size_t)hk * n_rep * D, static_cast<const T*>(p.ck) + pos0 * D,
        KV8 ? p.cks + pos0 : nullptr, static_cast<const T*>(p.cv) + pos0 * D,
        KV8 ? p.cvs + pos0 : nullptr, min(DA_CHUNK, pos - c0), n_rep, p.scale,
        p.part + ((size_t)hk * n_rep * p.n_split + split) * (D + 2), head_stride, smem);
  }
  // count this block's items on their heads, one thread an item (the
  // partials above are the block's, joined by the Sync that ended each);
  // last[k]: the head of the block's item k where this block completed its
  // count, else -1
  const int mine = blockIdx.x < n_items ? (n_items - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  for (int k = threadIdx.x; k < mine; k += ws::CONSUMERS) {
    const int hk = (blockIdx.x + k * gridDim.x) / n_live;
    ws::fence_acq_rel();
    const bool done = atomicAdd(heads + hk, 1u) == (unsigned)n_live - 1;
    if (done) {
      heads[hk] = 0u;
      ws::fence_acq_rel();
    }
    last[k] = done ? hk : -1;
  }
  ws::sync();
  for (int t = warp; t < mine * n_rep; t += ws::WARPS) {
    const int hk = last[t / n_rep];
    if (hk >= 0) merge_head<D>(p, hk * n_rep + t % n_rep, n_live, lane);
  }
}

// ---- the FFN half-layer (K6) --------------------------------------------------

struct FfnParams {
  const float* x;          // [M, D]
  const float* g;          // [D]
  const uint8_t* gu_qs;    // [2F, D/32 * BYTES]
  const __half* gu_d;      // [2F, D/32]
  const uint8_t* dn_qs;    // [D, F/32 * BYTES]
  const __half* dn_d;      // [D, F/32]
  float* y;                // [M, D]
  float* act;              // [M, F] scratch
  unsigned int* bar;       // coop.barrier_words: [2..4] the CountBarrier's
  int8_t* xq_out;          // [M, D] or null: K6c's activations, for checks
  float* xs_out;           // [M, D/32] or null: their scales
  int M, D, F;
  float eps;
};
