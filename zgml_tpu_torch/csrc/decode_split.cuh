// Split-KV decode attention over one 128-key chunk of one KV head: the device
// code K7's phase B (layer_attn.cu, and the megacalls through
// layer_phases.cuh) runs in a loop over (KV head, chunk) items; the first
// port's K8 ran it once per block (K8 has its own kernel in decode_attn.cu,
// which takes quantize_vec from here).
//
// The n_rep query heads of one GQA group attend keys 0..nk-1 of the chunk
// (nk in 1..DA_CHUNK) from one shared-memory copy of its K and V, and write
// per query head r the partial (unnormalised o[D], max, sum of exp) at
// part + r * head_stride. The caller merges the chunks with the usual
// rescaling. Sync is the barrier of the THREADS threads that run it (the
// whole block, or K7's consumer warps beside its weight producer). K rows in shared memory are padded by one word so the per-key
// dot products of a warp hit distinct banks.
//
// Three cache elements, one template parameter T:
//   bf16 (K7, K14):    f32 scores q . k * scale, p @ V in f32;
//   f32 (K7 over the f32 cache): the same function on f32 K and V. Its rows
//     are twice as wide, so the chunk's K is staged, scored, and V is then
//     staged into the same buffer: the area is the bf16 form's (K7's plans
//     do not change with the cache) at the cost of V's load no longer
//     overlapping K's;
//   int8 (K7-kv8):     the position-major int8 cache with one f32 scale per
//     position (zgml_tpu_torch/quant/kv_cache.py). The block quantizes the
//     group's f32 q rows itself (quantize_vec: absmax/127 per query head,
//     as zgml_tpu/ops/attention.py:529-533 and layerkernel.py:223-232), takes
//     exact `__dp4a` q . k dots, scores float(dot) * ((q_scale * k_scale) *
//     scale), and accumulates (p * v_scale) * float(v) in f32 (the V scales
//     folded into p, attention.py:439).
#pragma once

#include "common.cuh"

constexpr int DA_CHUNK = 128;     // keys per chunk

// A warp quantizes one D-vector of f32 at src (read with __ldcg: K7 writes it
// in the same kernel) as quantize_columns does: s = absmax / 127, inv = 1 / s
// (0 when s == 0), q = clip(rint(v * inv), -127, 127), rounding half to even,
// IEEE division (no fast math, ops/build.py), so bit-equal to the plain
// version on the same values. Writes the D levels to dst and s to *scale.
template <int D>
__device__ __forceinline__ void quantize_vec(const float* src, int8_t* dst, float* scale,
                                             int lane) {
  constexpr int PER = (D + 31) / 32;
  float v[PER];
  float amax = 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < D ? __ldcg(src + c) : 0.f;
    amax = fmaxf(amax, fabsf(v[j]));
  }
  const float s = warp_max(amax) / 127.0f;
  const float inv = s > 0.f ? 1.0f / s : 0.f;
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int c = lane + 32 * j;
    if (c < D) dst[c] = (int8_t)fminf(fmaxf(rintf(v[j] * inv), -127.f), 127.f);
  }
  if (lane == 0) *scale = s;
}

// Dynamic shared memory of decode_chunk_partial<D, THREADS, T>, in bytes
// (KV8: T is int8_t; the bf16 and the f32 element take the same area).
template <int D, bool KV8>
__host__ __device__ inline size_t decode_chunk_smem_bytes(int n_rep) {
  if (KV8)   // q levels, q scales, scores, K words (padded), V words, K and V scales
    return sizeof(float) * ((size_t)n_rep * D / 4 + n_rep + (size_t)n_rep * DA_CHUNK +
                            (size_t)DA_CHUNK * (D / 4 + 1) + (size_t)DA_CHUNK * (D / 4) +
                            2 * DA_CHUNK);
  return sizeof(float) * ((size_t)n_rep * D + (size_t)n_rep * DA_CHUNK) +
         sizeof(uint32_t) * ((size_t)DA_CHUNK * (D / 2 + 1) + (size_t)DA_CHUNK * (D / 2));
}

// Per query head (one warp each): the max and the sum of exp of its chunk
// scores sc[r][0..DA_CHUNK), written to its partial at D and D + 1, and p =
// exp(s - max) in place (masked keys: exp(-inf) = 0). Ends with a barrier.
template <int THREADS, class Sync = BlockSync>
__device__ __forceinline__ void chunk_softmax(float* sc, int n_rep, int D, float* part,
                                              size_t head_stride) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < n_rep; r += THREADS / 32) {
    float* sr = sc + r * DA_CHUNK;
    float mx = -INFINITY;
    for (int j = lane; j < DA_CHUNK; j += 32) mx = fmaxf(mx, sr[j]);
    mx = warp_max(mx);                 // finite: key 0 of the chunk is live
    float sum = 0.f;
    for (int j = lane; j < DA_CHUNK; j += 32) {
      const float p = expf(sr[j] - mx);
      sr[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      part[r * head_stride + D] = mx;
      part[r * head_stride + D + 1] = sum;
    }
  }
  Sync::sync();
}

// q: the group's n_rep f32 query rows [n_rep][D] (read with __ldcg: K7 writes
// them in the same kernel); k, v: the chunk's first key row of this head,
// rows of D elements T, bf16, f32 or (int8_t) levels; ksc, vsc (int8 only, else
// null): the chunk's first position scale. All THREADS threads (threads
// 0 .. THREADS - 1 of the block, joined by Sync) call it; it ends with a
// barrier, so the caller may reuse smem at once.
template <int D, int THREADS, class T, class Sync = BlockSync>
__device__ void decode_chunk_partial(const float* q, const T* k, const float* ksc, const T* v,
                                     const float* vsc, int nk, int n_rep, float scale,
                                     float* part, size_t head_stride, float* smem) {
  constexpr bool KV8 = std::is_same_v<T, int8_t>;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  float* sc;                                           // [n_rep][DA_CHUNK] scores, then p
  if constexpr (KV8) {
    constexpr int W = D / 4;                           // 32-bit words (4 levels) per row
    int* qw = reinterpret_cast<int*>(smem);            // [n_rep][W] q levels
    float* qsc = smem + n_rep * W;                     // [n_rep] q scales
    sc = qsc + n_rep;
    int* ks = reinterpret_cast<int*>(sc + n_rep * DA_CHUNK);   // [DA_CHUNK][W + 1]
    int* vs = ks + DA_CHUNK * (W + 1);                         // [DA_CHUNK][W]
    float* kss = reinterpret_cast<float*>(vs + DA_CHUNK * W);  // [DA_CHUNK] K scales
    float* vss = kss + DA_CHUNK;                               // [DA_CHUNK] V scales

    for (int r = warp; r < n_rep; r += THREADS / 32)
      quantize_vec<D>(q + r * D, reinterpret_cast<int8_t*>(qw + r * W), qsc + r, lane);
    const int* kg = reinterpret_cast<const int*>(k);
    const int* vg = reinterpret_cast<const int*>(v);
    for (int i = tid; i < nk * W; i += THREADS) {
      const int j = i / W, w = i % W;
      ks[j * (W + 1) + w] = __ldg(kg + i);
      vs[j * W + w] = __ldg(vg + i);
    }
    for (int j = tid; j < nk; j += THREADS) {
      kss[j] = __ldg(ksc + j);
      vss[j] = __ldg(vsc + j);
    }
    Sync::sync();

    // scores: thread -> (query head r, key j); the integer dot is exact
    for (int i = tid; i < n_rep * DA_CHUNK; i += THREADS) {
      const int r = i / DA_CHUNK, j = i % DA_CHUNK;
      float sj = -INFINITY;
      if (j < nk) {
        const int* kr = ks + j * (W + 1);
        const int* qr = qw + r * W;
        int dot = 0;
#pragma unroll
        for (int w = 0; w < W; ++w) dot = __dp4a(qr[w], kr[w], dot);
        sj = (float)dot * ((qsc[r] * kss[j]) * scale);
      }
      sc[i] = sj;
    }
    Sync::sync();
    chunk_softmax<THREADS, Sync>(sc, n_rep, D, part, head_stride);

    // unnormalised (p * v_scale) @ V: thread -> (query head r, dim c)
    const int8_t* v8 = reinterpret_cast<const int8_t*>(vs);
    for (int i = tid; i < n_rep * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const float* pr = sc + r * DA_CHUNK;
      float acc = 0.f;
      for (int j = 0; j < nk; ++j) acc = fmaf(pr[j] * vss[j], (float)v8[j * D + c], acc);
      part[r * head_stride + c] = acc;
    }
  } else if constexpr (std::is_same_v<T, float>) {
    float* qs = smem;                                  // [n_rep][D]
    sc = qs + n_rep * D;
    float* kv = sc + n_rep * DA_CHUNK;                 // K [DA_CHUNK][D + 1], then V [DA_CHUNK][D]

    for (int i = tid; i < n_rep * D; i += THREADS) qs[i] = __ldcg(q + i);
    for (int i = tid; i < nk * D; i += THREADS) kv[(i / D) * (D + 1) + i % D] = __ldg(k + i);
    Sync::sync();

    // scores: thread -> (query head r, key j)
    for (int i = tid; i < n_rep * DA_CHUNK; i += THREADS) {
      const int r = i / DA_CHUNK, j = i % DA_CHUNK;
      float sj = -INFINITY;
      if (j < nk) {
        const float* kr = kv + j * (D + 1);
        const float* qr = qs + r * D;
        float dot = 0.f;
#pragma unroll 8
        for (int c = 0; c < D; ++c) dot = fmaf(qr[c], kr[c], dot);
        sj = dot * scale;
      }
      sc[i] = sj;
    }
    Sync::sync();
    chunk_softmax<THREADS, Sync>(sc, n_rep, D, part, head_stride);   // K no longer read
    for (int i = tid; i < nk * D; i += THREADS) kv[i] = __ldg(v + i);
    Sync::sync();

    // unnormalised p @ V: thread -> (query head r, dim c)
    for (int i = tid; i < n_rep * D; i += THREADS) {
      const int r = i / D, c = i % D;
      const float* pr = sc + r * DA_CHUNK;
      float acc = 0.f;
      for (int j = 0; j < nk; ++j) acc = fmaf(pr[j], kv[j * D + c], acc);
      part[r * head_stride + c] = acc;
    }
  } else {
    constexpr int W = D / 2;                           // 32-bit words (bf16 pairs) per row
    float* qs = smem;                                  // [n_rep][D]
    sc = qs + n_rep * D;
    uint32_t* ks = reinterpret_cast<uint32_t*>(sc + n_rep * DA_CHUNK);   // [DA_CHUNK][W + 1]
    uint32_t* vs = ks + DA_CHUNK * (W + 1);                              // [DA_CHUNK][W]

    for (int i = tid; i < n_rep * D; i += THREADS) qs[i] = __ldcg(q + i);
    const uint32_t* kg = reinterpret_cast<const uint32_t*>(k);
    const uint32_t* vg = reinterpret_cast<const uint32_t*>(v);
    for (int i = tid; i < nk * W; i += THREADS) {
      const int j = i / W, w = i % W;
      ks[j * (W + 1) + w] = __ldg(kg + i);
      vs[j * W + w] = __ldg(vg + i);
    }
    Sync::sync();

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
    Sync::sync();
    chunk_softmax<THREADS, Sync>(sc, n_rep, D, part, head_stride);

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
  }
  Sync::sync();
}
