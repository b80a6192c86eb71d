// K4 decode_attention: one query token per row, GQA, over the bf16 KV cache;
// and its int8-cache mode, K8 decode_attention_q8.
//
// Replaces: zgml_tpu/ops/attention.py `_decode_kernel` (line 282), reached
// through `_decode` / `decode_attention_pallas` (K4), and `_decode_q8_kernel`
// (line 395, pallas_call at 506), reached through `_decode_q8` /
// `decode_attention_q8_pallas` (K8; its ZGML_TPU_ATTN_I8PV mode, p quantized
// per block, is not ported and the wrapper's caller refuses it).
//
// K8 (the plain version is ops/attention.py decode_attention_q8_ref): k, v
// are the position-major int8 cache [R, Hkv, S, D] with f32 scales ks, vs
// [R, Hkv, S]; each block quantizes the f32 q rows of its group per query
// head, scores are exact int8 dots times q_scale * k_scale * scale, and P.V
// runs in f32 on the levels with the V scales folded into p
// (decode_split.cuh). It moves half the bf16 cache's bytes (plus 4 bytes of
// scales per position and head); the rest of the design is K4's.
//
// K4's semantics (the plain version is ops/attention.py decode_attention_ref):
//   q f32 [B, Hq, 1, D]; k, v bf16 [R, Hkv, S, D] read in place at batch rows
//   kv_row + b; row b attends keys j < kv_len[b] (int32 on the device, so a
//   decode step needs no host sync). Output f32 [B, Hq, 1, D]; a row with
//   kv_len 0 gives 0.
//
// What bounds it on the H100: HBM bytes. Each step reads the live K and V of
// every KV head once (2 * kv_len * D * 2 bytes per head per layer) for only
// ~4 flops per byte; at batch 1 there are just B*Hkv = 4 heads, far too few
// blocks to pull bandwidth from 132 SMs if one block walked a whole head.
//
// What the design does about it: split-KV (flash-decoding). The grid is
// (S/128 chunks, B*Hkv): each block takes one KV head over one 128-key chunk
// and serves all n_rep query heads of that group from one shared-memory copy
// of the chunk, so K/V are read from HBM once per group. Blocks past kv_len
// exit at once (the grid covers S, so the host never needs kv_len). Each
// block writes its partial (unnormalised o, max, sum) per query head; a
// second small kernel merges the chunks with the usual rescaling. K rows in
// shared memory are padded by one word so the per-key dot products of a warp
// hit distinct banks. Softmax math is f32. The per-chunk device code is
// decode_split.cuh, shared with K7's phase B (layer_attn.cu).
#include "decode_split.cuh"

namespace {

constexpr int DA_THREADS = 128;

// One block: KV head hk of batch row b over one chunk of keys. T is the cache
// element: __nv_bfloat16 (K4), or int8_t levels with the position scales ks,
// vs (K8; null for bf16). The pointers keep their element type down to the
// shared chunk code: passed as void*, the same code came out of ptxas in
// another instruction order and K4 ran measurably slower (PERF.md).
template <int D, class T>
__global__ void __launch_bounds__(DA_THREADS)
decode_partial_kernel(const float* __restrict__ q, const T* __restrict__ k,
                      const float* __restrict__ ks, const T* __restrict__ v,
                      const float* __restrict__ vs, const int* __restrict__ kv_len,
                      float* __restrict__ part, int Hq, int Hkv, int S, int kv_row,
                      float scale, int n_split) {
  constexpr bool KV8 = std::is_same_v<T, int8_t>;
  extern __shared__ __align__(16) float smem[];
  const int n_rep = Hq / Hkv;
  const int b = blockIdx.y / Hkv, hk = blockIdx.y % Hkv;
  const int split = blockIdx.x;
  const int len = min(kv_len[b], S);
  const int c0 = split * DA_CHUNK;
  const int nk = min(DA_CHUNK, len - c0);
  const int h0 = b * Hq + hk * n_rep;                  // first query head of the group
  const size_t head_stride = (size_t)n_split * (D + 2);
  float* part0 = part + ((size_t)h0 * n_split + split) * (D + 2);

  if (nk <= 0) {                                       // chunk past kv_len
    for (int r = threadIdx.x; r < n_rep; r += DA_THREADS) {
      part0[r * head_stride + D] = -INFINITY;
      part0[r * head_stride + D + 1] = 0.f;
    }
    return;
  }
  const size_t pos0 = ((size_t)(kv_row + b) * Hkv + hk) * S + c0;   // the chunk's first position
  const size_t base = pos0 * D;
  decode_chunk_partial<D, DA_THREADS, T>(q + (size_t)h0 * D, k + base,
                                         KV8 ? ks + pos0 : nullptr, v + base,
                                         KV8 ? vs + pos0 : nullptr, nk, n_rep, scale, part0,
                                         head_stride, smem);
}

template <int D>
__global__ void decode_combine_kernel(const float* __restrict__ part, float* __restrict__ o,
                                      int n_split) {
  const int bh = blockIdx.x, c = threadIdx.x;
  const float* pp = part + (size_t)bh * n_split * (D + 2);
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s)
    if (pp[s * (D + 2) + D + 1] > 0.f) mx = fmaxf(mx, pp[s * (D + 2) + D]);
  float num = 0.f, den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float l = pp[s * (D + 2) + D + 1];
    if (l > 0.f) {                       // dead chunks leave o unwritten
      const float w = expf(pp[s * (D + 2) + D] - mx);
      num = fmaf(w, pp[s * (D + 2) + c], num);
      den = fmaf(w, l, den);
    }
  }
  o[(size_t)bh * D + c] = den > 0.f ? num / den : 0.f;
}

template <int D, bool KV8>
int launch(const float* q, const void* k, const float* ks, const void* v, const float* vs,
           const int* kv_len, float* o, float* part, int B, int Hq, int Hkv, int S, int kv_row,
           float scale, cudaStream_t st) {
  using T = std::conditional_t<KV8, int8_t, __nv_bfloat16>;
  const int n_split = (S + DA_CHUNK - 1) / DA_CHUNK;
  const size_t smem = decode_chunk_smem_bytes<D, KV8>(Hq / Hkv);
  int rc = allow_dynamic_smem(decode_partial_kernel<D, T>, smem);
  if (rc != 0) return rc;
  decode_partial_kernel<D, T><<<dim3(n_split, B * Hkv), DA_THREADS, smem, st>>>(
      q, static_cast<const T*>(k), ks, static_cast<const T*>(v), vs, kv_len, part, Hq, Hkv, S,
      kv_row, scale, n_split);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  decode_combine_kernel<D><<<B * Hq, D, 0, st>>>(part, o, n_split);
  return (int)cudaGetLastError();
}

template <bool KV8>
int launch_hd(const float* q, const void* k, const float* ks, const void* v, const float* vs,
              const int* kv_len, float* o, float* part, int B, int Hq, int Hkv, int S, int D,
              int kv_row, float scale, cudaStream_t st) {
#define ZGML_DECODE(DD)                                                                    \
  case DD:                                                                                 \
    return launch<DD, KV8>(q, k, ks, v, vs, kv_len, o, part, B, Hq, Hkv, S, kv_row, scale, st);
  switch (D) {
    ZGML_DECODE(16)
    ZGML_DECODE(32)
    ZGML_DECODE(64)
    ZGML_DECODE(128)
    default: return ZGML_ERR_HEAD_DIM;
  }
#undef ZGML_DECODE
}

}  // namespace

// q f32 [B, Hq, D], k/v [R, Hkv, S, D] with R >= kv_row + B: bf16 (K4, ks and
// vs null) or int8 levels with f32 scales ks/vs [R, Hkv, S] (K8); kv_len
// int32 [B], o f32 [B, Hq, D], part f32 [B*Hq, n_split, D + 2]; all contiguous.
ZGML_EXPORT int zgml_decode_attention(const float* q, const void* k, const float* ks,
                                      const void* v, const float* vs, const int* kv_len,
                                      float* o, float* part, int B, int Hq, int Hkv, int S, int D,
                                      int kv_row, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || kv_row < 0 ||
      (ks == nullptr) != (vs == nullptr))
    return ZGML_ERR_SHAPE;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ks != nullptr)
    return launch_hd<true>(q, k, ks, v, vs, kv_len, o, part, B, Hq, Hkv, S, D, kv_row, scale, st);
  return launch_hd<false>(q, k, ks, v, vs, kv_len, o, part, B, Hq, Hkv, S, D, kv_row, scale, st);
}

// Scratch rows per query head for `part` (floats): n_split * (D + 2).
ZGML_EXPORT int zgml_decode_split_count(int S) { return (S + DA_CHUNK - 1) / DA_CHUNK; }
