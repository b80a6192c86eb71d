// K4 decode_attention: one query token per row, GQA, over the bf16 KV cache.
//
// Replaces: zgml_tpu/ops/attention.py `_decode_kernel` (line 282), reached
// through `_decode` / `decode_attention_pallas`.
//
// Semantics (the plain version is ops/attention.py decode_attention_ref):
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

template <int D>
__global__ void __launch_bounds__(DA_THREADS)
decode_partial_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, const int* __restrict__ kv_len,
                      float* __restrict__ part, int Hq, int Hkv, int S, int kv_row,
                      float scale, int n_split) {
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
  const size_t base = ((size_t)(kv_row + b) * Hkv + hk) * S * D + (size_t)c0 * D;
  decode_chunk_partial<D, DA_THREADS>(q + (size_t)h0 * D, k + base, v + base, nk, n_rep,
                                      scale, part0, head_stride, smem);
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

template <int D>
int launch(const float* q, const __nv_bfloat16* k, const __nv_bfloat16* v, const int* kv_len,
           float* o, float* part, int B, int Hq, int Hkv, int S, int kv_row, float scale,
           cudaStream_t st) {
  const int n_split = (S + DA_CHUNK - 1) / DA_CHUNK;
  const size_t smem = decode_chunk_smem_bytes<D>(Hq / Hkv);
  int rc = allow_dynamic_smem(decode_partial_kernel<D>, smem);
  if (rc != 0) return rc;
  decode_partial_kernel<D><<<dim3(n_split, B * Hkv), DA_THREADS, smem, st>>>(
      q, k, v, kv_len, part, Hq, Hkv, S, kv_row, scale, n_split);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  decode_combine_kernel<D><<<B * Hq, D, 0, st>>>(part, o, n_split);
  return (int)cudaGetLastError();
}

}  // namespace

// Scratch rows per query head for `part` (floats): n_split * (D + 2).
ZGML_EXPORT int zgml_decode_split_count(int S) { return (S + DA_CHUNK - 1) / DA_CHUNK; }

// q f32 [B, Hq, D], k/v bf16 [R, Hkv, S, D] with R >= kv_row + B, kv_len int32
// [B], o f32 [B, Hq, D], part f32 [B*Hq, n_split, D + 2]; all contiguous.
ZGML_EXPORT int zgml_decode_attention(const float* q, const void* k, const void* v,
                                      const int* kv_len, float* o, float* part, int B, int Hq,
                                      int Hkv, int S, int D, int kv_row, float scale,
                                      void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0 || kv_row < 0)
    return ZGML_ERR_SHAPE;
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch<16>(q, kb, vb, kv_len, o, part, B, Hq, Hkv, S, kv_row, scale, st);
    case 32: return launch<32>(q, kb, vb, kv_len, o, part, B, Hq, Hkv, S, kv_row, scale, st);
    case 64: return launch<64>(q, kb, vb, kv_len, o, part, B, Hq, Hkv, S, kv_row, scale, st);
    case 128: return launch<128>(q, kb, vb, kv_len, o, part, B, Hq, Hkv, S, kv_row, scale, st);
    default: return ZGML_ERR_HEAD_DIM;
  }
}
