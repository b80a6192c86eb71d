// K3 flash_attention: causal GQA prefill attention over the bf16 KV cache;
// its int8-cache mode, K9 flash_attention_q8; and its LSE mode, K10f
// flash_fwd, the forward of training's flash attention.
//
// Replaces: zgml_tpu/ops/attention.py `_flash_kernel` (line 44), reached
// through `_flash` / `flash_attention_pallas` via flash_vjp.make_flash_vjp
// (K3), and `_flash_q8_kernel` (line 599, pallas_call at 702), reached
// through `_flash_q8` / `flash_attention_q8_pallas` (K9); and
// zgml_tpu/ops/flash_vjp.py `_fwd_kernel` (pallas_call at line 140, K10f),
// which `make_flash_vjp` runs under jax.grad.
//
// K10f (the plain version is ops/flash_vjp.py flash_fwd_lse_ref) is K3 with
// one more output: lse f32 [B, Hq, Tq], m + log(l) of each row's online
// softmax, +inf for a row with no live key (flash_vjp.py:89-92), which the
// backward kernels (flash_bwd.cu) turn into p = exp(s - lse). It is the same
// kernel with a non-null lse pointer, so its O is K3's O bit for bit; the
// JAX kernel's 128-lane LSE sidecar is TPU layout and is not kept.
//
// K9 (the plain version is ops/attention.py flash_attention_q8_ref): k, v
// are the position-major int8 cache [R, Hkv, S, D] with f32 scales ks, vs
// [R, Hkv, S]. q stays f32 (the JAX kernel's ZGML_TPU_PREFILL_BF16=0, the
// port's standing prefill): each tile's levels are converted to f32 in
// shared memory, the scores are (q . k_levels) * (k_scale * scale) as
// attention.py:629-631, and p is multiplied by v_scale before P.V (642). The
// tile holds 16 levels per 16-byte load, half the bf16 tile's bytes; the
// rest of the design, and the register pressure at D = 128, are K3's.
//
// Semantics (the plain version is ops/attention.py flash_attention_ref):
//   q f32 [B, Hq, Tq, D]; k, v bf16 [R, Hkv, S, D], the cache slab read in
//   place at batch rows kv_row + b (the stacked [L, B, Hkv, S, D] cache viewed
//   as [L*B, ...], kv_row = layer * B); query row i sits at absolute position
//   q_offset + i and attends keys j < kv_len with j <= q_offset + i. Query
//   head h reads KV head h / (Hq / Hkv). Output f32 [B, Hq, Tq, D]; a row
//   with no live key gives 0.
//
// What bounds it on the H100: at a prefill chunk (Tq = 128, kv_len <= a few
// hundred at the slice's prompts) the work is small (~2*2*Tq*kv*D flops per
// head); the kernel is bound by latency and by the f32 FMA issue rate of the
// few blocks it runs, not by HBM (one layer's live K/V is < 1 MB).
//
// What the design does about it: one warp per 32 query rows of one head,
// one query row per thread with q and the output accumulator in registers;
// K/V tiles of 32 keys are converted bf16 -> f32 once into shared memory
// and read back as broadcasts. Online softmax in f32 per tile (one rescale
// per tile, not per key). The KV loop stops at min(kv_len, q_offset + last
// row of the tile + 1), so work scales with the live prefix, not with S.
#include "common.cuh"

namespace {

constexpr int FA_BQ = 32;   // query rows per block (one warp)
constexpr int FA_BK = 32;   // keys per shared-memory tile

// the four int8 levels of a 32-bit word -> 4 floats
__device__ __forceinline__ void i8x4_to_f32(uint32_t w, float* dst) {
#pragma unroll
  for (int b = 0; b < 4; ++b) dst[b] = (float)((int)(w << (24 - 8 * b)) >> 24);
}

template <int D, bool KV8>
__global__ void __launch_bounds__(FA_BQ)
flash_attn_kernel(const float* __restrict__ q, const void* __restrict__ k,
                  const float* __restrict__ ks, const void* __restrict__ v,
                  const float* __restrict__ vs, float* __restrict__ o, float* __restrict__ lse,
                  int Hq, int Hkv, int Tq, int S, int kv_len, int q_offset, int kv_row,
                  float scale) {
  __shared__ __align__(16) float Ks[FA_BK][D];
  __shared__ __align__(16) float Vs[FA_BK][D];
  __shared__ float Kscale[KV8 ? FA_BK : 1];      // KV8: k_scale * scale per key of the tile
  __shared__ float Vscale[KV8 ? FA_BK : 1];      // KV8: v_scale per key
  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const int hk = h / (Hq / Hkv);
  const int row = blockIdx.x * FA_BQ + threadIdx.x;
  const bool live_row = row < Tq;
  const int q_abs = q_offset + row;

  float qr[D], acc[D];
  const float* qp = q + ((size_t)bh * Tq + (live_row ? row : 0)) * D;
#pragma unroll
  for (int i = 0; i < D; ++i) {
    qr[i] = live_row ? qp[i] : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  const int tile_last = min(Tq, (int)(blockIdx.x + 1) * FA_BQ) - 1;
  const int kv_end = min(min(kv_len, q_offset + tile_last + 1), S);
  const size_t pos0 = ((size_t)(kv_row + b) * Hkv + hk) * S;   // the head's first position
  constexpr int PER = KV8 ? 16 : 8;                 // elements per 16-byte load
  using T = std::conditional_t<KV8, int8_t, __nv_bfloat16>;
  const uint4* kg = reinterpret_cast<const uint4*>(static_cast<const T*>(k) + pos0 * D);
  const uint4* vg = reinterpret_cast<const uint4*>(static_cast<const T*>(v) + pos0 * D);

  for (int t0 = 0; t0 < kv_end; t0 += FA_BK) {
    const int nk = min(FA_BK, kv_end - t0);
    // tile rows are contiguous in the cache
    for (int e = threadIdx.x; e < nk * D / PER; e += FA_BQ) {
      const int j = (e * PER) / D, c = (e * PER) % D;
      const uint4 kw = __ldg(kg + (size_t)t0 * D / PER + e);
      const uint4 vw = __ldg(vg + (size_t)t0 * D / PER + e);
      const uint32_t kk[4] = {kw.x, kw.y, kw.z, kw.w};
      const uint32_t vv[4] = {vw.x, vw.y, vw.z, vw.w};
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if constexpr (KV8) {
          i8x4_to_f32(kk[u], &Ks[j][c + 4 * u]);
          i8x4_to_f32(vv[u], &Vs[j][c + 4 * u]);
        } else {
          Ks[j][c + 2 * u] = bf16_lo(kk[u]);
          Ks[j][c + 2 * u + 1] = bf16_hi(kk[u]);
          Vs[j][c + 2 * u] = bf16_lo(vv[u]);
          Vs[j][c + 2 * u + 1] = bf16_hi(vv[u]);
        }
      }
    }
    if constexpr (KV8) {
      for (int j = threadIdx.x; j < nk; j += FA_BQ) {
        Kscale[j] = __ldg(ks + pos0 + t0 + j) * scale;
        Vscale[j] = __ldg(vs + pos0 + t0 + j);
      }
    }
    __syncthreads();
    if (live_row) {
      float s[FA_BK];
      float tmax = -INFINITY;
#pragma unroll
      for (int j = 0; j < FA_BK; ++j) {
        float sj = -INFINITY;
        if (j < nk && t0 + j <= q_abs) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < D; i += 4) {
            const float4 kv4 = *reinterpret_cast<const float4*>(&Ks[j][i]);
            dot = fmaf(qr[i], kv4.x, dot);
            dot = fmaf(qr[i + 1], kv4.y, dot);
            dot = fmaf(qr[i + 2], kv4.z, dot);
            dot = fmaf(qr[i + 3], kv4.w, dot);
          }
          sj = dot * (KV8 ? Kscale[j] : scale);
        }
        s[j] = sj;
        tmax = fmaxf(tmax, sj);
      }
      if (tmax > -INFINITY) {
        const float m_new = fmaxf(m, tmax);
        const float alpha = expf(m - m_new);   // 0 on the first live tile
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < D; ++i) acc[i] *= alpha;
#pragma unroll
        for (int j = 0; j < FA_BK; ++j) {
          if (s[j] == -INFINITY) continue;     // masked, or past the tile's keys
          const float p = expf(s[j] - m_new);
          psum += p;
          const float pv = KV8 ? p * Vscale[j] : p;     // the V scale folded into p
#pragma unroll
          for (int i = 0; i < D; i += 4) {
            const float4 v4 = *reinterpret_cast<const float4*>(&Vs[j][i]);
            acc[i] = fmaf(pv, v4.x, acc[i]);
            acc[i + 1] = fmaf(pv, v4.y, acc[i + 1]);
            acc[i + 2] = fmaf(pv, v4.z, acc[i + 2]);
            acc[i + 3] = fmaf(pv, v4.w, acc[i + 3]);
          }
        }
        l = l * alpha + psum;
        m = m_new;
      }
    }
    __syncthreads();
  }
  if (live_row) {
    float* op = o + ((size_t)bh * Tq + row) * D;
    const float inv = l > 0.f ? 1.f / l : 0.f;
#pragma unroll
    for (int i = 0; i < D; ++i) op[i] = acc[i] * inv;
    if (lse != nullptr) lse[(size_t)bh * Tq + row] = l > 0.f ? m + logf(l) : INFINITY;
  }
}

template <bool KV8>
int launch(const float* q, const void* k, const float* ks, const void* v, const float* vs,
           float* o, float* lse, int B, int Hq, int Hkv, int Tq, int S, int D, int kv_len,
           int q_offset, int kv_row, float scale, cudaStream_t st) {
  const dim3 grid((Tq + FA_BQ - 1) / FA_BQ, B * Hq);
#define ZGML_FLASH(DD)                                                                      \
  case DD:                                                                                  \
    flash_attn_kernel<DD, KV8><<<grid, FA_BQ, 0, st>>>(q, k, ks, v, vs, o, lse, Hq, Hkv, Tq, \
                                                       S, kv_len, q_offset, kv_row, scale); \
    break;
  switch (D) {
    ZGML_FLASH(16)
    ZGML_FLASH(32)
    ZGML_FLASH(64)
    ZGML_FLASH(128)
    default: return ZGML_ERR_HEAD_DIM;
  }
#undef ZGML_FLASH
  return (int)cudaGetLastError();
}

}  // namespace

// q f32 [B, Hq, Tq, D], k/v [R, Hkv, S, D] with R >= kv_row + B: bf16 (K3, ks
// and vs null) or int8 levels with f32 scales ks/vs [R, Hkv, S] (K9); o f32
// [B, Hq, Tq, D]; lse f32 [B, Hq, Tq] or null (K10f writes it; bf16 cache
// only); all contiguous, 16-byte aligned.
ZGML_EXPORT int zgml_flash_attention(const float* q, const void* k, const float* ks,
                                     const void* v, const float* vs, float* o, float* lse,
                                     int B, int Hq, int Hkv, int Tq, int S, int D, int kv_len,
                                     int q_offset, int kv_row, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Tq <= 0 || S <= 0 || kv_row < 0 ||
      q_offset < 0 || (ks == nullptr) != (vs == nullptr) || (ks != nullptr && lse != nullptr))
    return ZGML_ERR_SHAPE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ks != nullptr)
    return launch<true>(q, k, ks, v, vs, o, lse, B, Hq, Hkv, Tq, S, D, kv_len, q_offset, kv_row,
                        scale, st);
  return launch<false>(q, k, ks, v, vs, o, lse, B, Hq, Hkv, Tq, S, D, kv_len, q_offset, kv_row,
                       scale, st);
}
