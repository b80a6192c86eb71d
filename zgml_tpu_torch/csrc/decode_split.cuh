// Split-KV decode attention over one 128-key chunk of one KV head: the device
// code K4 (decode_attn.cu) runs once per block and K7's phase B
// (layer_attn.cu) runs in a loop over (KV head, chunk) items.
//
// The n_rep query heads of one GQA group attend keys 0..nk-1 of the chunk
// (nk in 1..DA_CHUNK) from one shared-memory copy of its K and V, and write
// per query head r the partial (unnormalised o[D], max, sum of exp) at
// part + r * head_stride. Scores are f32, scaled by `scale`; the caller merges
// the chunks with the usual rescaling. K rows in shared memory are padded by
// one word so the per-key dot products of a warp hit distinct banks.
#pragma once

#include "common.cuh"

constexpr int DA_CHUNK = 128;     // keys per chunk

// Dynamic shared memory of decode_chunk_partial<D>, in bytes.
template <int D>
inline size_t decode_chunk_smem_bytes(int n_rep) {
  return sizeof(float) * ((size_t)n_rep * D + (size_t)n_rep * DA_CHUNK) +
         sizeof(uint32_t) * ((size_t)DA_CHUNK * (D / 2 + 1) + (size_t)DA_CHUNK * (D / 2));
}

// q: the group's n_rep query rows [n_rep][D] (read with __ldcg: K7 writes them
// in the same kernel); k, v: the chunk's first key row of this head, rows of
// D bf16 values. All THREADS threads of the block call it; it ends with a
// barrier, so the caller may reuse smem at once.
template <int D, int THREADS>
__device__ void decode_chunk_partial(const float* q, const __nv_bfloat16* k,
                                     const __nv_bfloat16* v, int nk, int n_rep, float scale,
                                     float* part, size_t head_stride, float* smem) {
  constexpr int W = D / 2;               // 32-bit words (bf16 pairs) per row
  float* qs = smem;                                    // [n_rep][D]
  float* sc = qs + n_rep * D;                          // [n_rep][DA_CHUNK]
  uint32_t* ks = reinterpret_cast<uint32_t*>(sc + n_rep * DA_CHUNK);   // [DA_CHUNK][W + 1]
  uint32_t* vs = ks + DA_CHUNK * (W + 1);                              // [DA_CHUNK][W]
  const int tid = threadIdx.x;

  for (int i = tid; i < n_rep * D; i += THREADS) qs[i] = __ldcg(q + i);
  const uint32_t* kg = reinterpret_cast<const uint32_t*>(k);
  const uint32_t* vg = reinterpret_cast<const uint32_t*>(v);
  for (int i = tid; i < nk * W; i += THREADS) {
    const int j = i / W, w = i % W;
    ks[j * (W + 1) + w] = __ldg(kg + i);
    vs[j * W + w] = __ldg(vg + i);
  }
  __syncthreads();

  // scores: thread -> (query head r, key j)
  for (int i = tid; i < n_rep * DA_CHUNK; i += THREADS) {
    const int r = i / DA_CHUNK, j = i % DA_CHUNK;
    float sj = -INFINITY;
    if (j < nk) {
      const uint32_t* kr = ks + j * (W + 1);
      const float* qr = qs + r * D;
      float dot = 0.f;
#pragma unroll 8
      for (int w = 0; w < W; ++w) {
        const uint32_t u = kr[w];
        dot = fmaf(qr[2 * w], bf16_lo(u), dot);
        dot = fmaf(qr[2 * w + 1], bf16_hi(u), dot);
      }
      sj = dot * scale;
    }
    sc[i] = sj;
  }
  __syncthreads();

  // per query head: max and sum of exp over the chunk (one warp per head)
  const int warp = tid >> 5, lane = tid & 31;
  for (int r = warp; r < n_rep; r += THREADS / 32) {
    float* sr = sc + r * DA_CHUNK;
    float mx = -INFINITY;
    for (int j = lane; j < DA_CHUNK; j += 32) mx = fmaxf(mx, sr[j]);
    mx = warp_max(mx);                 // finite: key 0 of the chunk is live
    float sum = 0.f;
    for (int j = lane; j < DA_CHUNK; j += 32) {
      const float p = expf(sr[j] - mx);   // masked -> exp(-inf) = 0
      sr[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part[r * head_stride + D] = mx;
      part[r * head_stride + D + 1] = sum;
    }
  }
  __syncthreads();

  // unnormalised p @ V: thread -> (query head r, dim c)
  for (int i = tid; i < n_rep * D; i += THREADS) {
    const int r = i / D, c = i % D;
    const float* pr = sc + r * DA_CHUNK;
    const uint32_t* vc = vs + (c >> 1);
    float acc = 0.f;
    for (int j = 0; j < nk; ++j) {
      const uint32_t u = vc[j * W];
      acc = fmaf(pr[j], (c & 1) ? bf16_hi(u) : bf16_lo(u), acc);
    }
    part[r * head_stride + c] = acc;
  }
  __syncthreads();
}
