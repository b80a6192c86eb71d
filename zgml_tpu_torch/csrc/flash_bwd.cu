// K10dq flash_dq and K10dkv flash_dkv: the FlashAttention-2 backward of
// training's causal GQA flash attention over bf16 K/V.
//
// Replaces: zgml_tpu/ops/flash_vjp.py `_dq_kernel` (pallas_call at line 230)
// and `_dkv_kernel` (pallas_call at line 327), which the backward of
// `make_flash_vjp` runs under jax.grad, at ZGML_TPU_PREFILL_BF16=0 (f32
// operands: the port's standing prefill function).
//
// Semantics (plain versions: ops/flash_vjp.py flash_dq_ref, flash_dkv_ref):
//   q, dO, O f32 [B, Hq, Tq, D]; k, v bf16 [B, Hkv, S, D]; lse f32 [B, Hq, Tq]
//   from K10f. Query row i (absolute q_offset + i) sees keys j < kv_len with
//   j <= q_offset + i. s = (q . k) * scale is summed here in f32, in another
//   order than K10f's split-TF32 tensor-core sums, so p = exp(s - lse)
//   differs from the forward's softmax by f32 rounding of s (~1e-7
//   relative); delta = rowsum(dO O).
//     dQ_i  = sum_j dS_ij k_j,   dS  = p * (dO . v - delta) * scale    (f32 dO)
//     dV_j  = sum_i p_ij dO_i
//     dK_j  = sum_i dS'_ij q_i,  dS' = p * (bf16(dO) . v - delta) * scale
//   dK's dP takes dO rounded to bf16, as flash_vjp.py:275 does whatever the
//   operand dtype; dQ's takes the f32 dO (:182-185). dK and dV are per QUERY
//   head, [B, Hq, S, D] bf16 (k's dtype), rounded to nearest even; the caller
//   sums each GQA group (ops/flash_vjp.py group_sum).
//
// What bounds it on the H100: f32 FMAs. Per head the causal half of the
// T x T pairs, each a D-long dot: dQ takes 3 such products (s, dP, dS k),
// dK/dV 4 (s, dP, P^T dO, dS^T q). At the TinyLlama training shape (B 4,
// T 512, 32 query heads, D 64) that is ~6.4 and ~8.6 GFLOP, ~96 and ~128 us
// at 67 TFLOP/s; the bytes (q, dO, O, lse, K, V read once, the outputs
// written once) take ~10 us.
//
// What the design does about it: 32 x 32 tiles in shared memory and 256
// threads per block. In phase 1 each thread takes one query row and 4 keys of
// the tile (s and dP, reusing its q / dO element across the 4 dots); in phase
// 2 each thread owns D/8 (dQ) or 2 x D/8 (dK, dV) output sums in registers:
// at most 32 floats at D = 128, where one query row per thread (256
// accumulator floats) would spill. No atomics: dQ has one block per (query
// head, 32 query rows) that walks the live key tiles; dK/dV one block per
// (query head, 32 keys) that walks the query tiles whose causal window
// reaches it. Rows are padded to D + 1 floats, so the threads of a warp read
// distinct banks.
#include "common.cuh"

namespace {

constexpr int BT = 32;            // query rows and keys per tile
constexpr int BW_THREADS = 256;
constexpr int PAIRS = BT * BT / BW_THREADS;   // (row, key) pairs per thread in phase 1

// rows [r0, r0 + BT) of a [rows, D] f32 matrix into smem [BT][D + 1]; rows
// at or past `rows` read as 0
template <int D>
__device__ __forceinline__ void load_f32_rows(const float* __restrict__ src, int r0, int rows,
                                              float* dst) {
  for (int e = threadIdx.x; e < BT * D; e += BW_THREADS) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r0 + r < rows ? src[(size_t)(r0 + r) * D + c] : 0.f;
  }
}

// the same for bf16 rows (exact in f32)
template <int D>
__device__ __forceinline__ void load_bf16_rows(const __nv_bfloat16* __restrict__ src, int r0,
                                               int rows, float* dst) {
  for (int e = threadIdx.x; e < BT * D; e += BW_THREADS) {
    const int r = e / D, c = e % D;
    dst[r * (D + 1) + c] = r0 + r < rows ? __bfloat162float(src[(size_t)(r0 + r) * D + c]) : 0.f;
  }
}

// Phase 1 of both kernels: for this thread's query row r (of the tile at
// query i0) and keys j = (tid & 7) + 8u of the tile at key j0, the scores
// s = (q . k) * scale in f32 (in this kernel's order, not K10f's), p =
// exp(s - lse) (0 where masked), and the dots dO . v (on `dOs`). Returns p
// and dp per key.
template <int D>
__device__ __forceinline__ void scores(const float* Qs, const float* dOs, const float* Ks,
                                       const float* Vs, int r, int i0, int j0, int Tq,
                                       int kv_end, int q_offset, float scale, float lse,
                                       float (&p)[PAIRS], float (&dp)[PAIRS]) {
  constexpr int LD = D + 1;
  const int jl = threadIdx.x & 7;
  float dot[PAIRS], dpa[PAIRS];
#pragma unroll
  for (int u = 0; u < PAIRS; ++u) dot[u] = dpa[u] = 0.f;
#pragma unroll 8
  for (int i = 0; i < D; ++i) {
    const float qv = Qs[r * LD + i], dv = dOs[r * LD + i];
#pragma unroll
    for (int u = 0; u < PAIRS; ++u) {
      dot[u] = fmaf(qv, Ks[(jl + 8 * u) * LD + i], dot[u]);
      dpa[u] = fmaf(dv, Vs[(jl + 8 * u) * LD + i], dpa[u]);
    }
  }
  const int ia = i0 + r;
#pragma unroll
  for (int u = 0; u < PAIRS; ++u) {
    const int ja = j0 + jl + 8 * u;
    const bool live = ia < Tq && ja < kv_end && ja <= q_offset + ia;
    // __fmul_rn / __fsub_rn: s is rounded as K10f rounds it, never contracted
    p[u] = live ? expf(__fsub_rn(__fmul_rn(dot[u], scale), lse)) : 0.f;
    dp[u] = dpa[u];
  }
}

template <int D>
__global__ void __launch_bounds__(BW_THREADS)
flash_dq_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, const float* __restrict__ dO,
                const float* __restrict__ O, const float* __restrict__ lse,
                float* __restrict__ dq, int Hq, int Hkv, int Tq, int S, int kv_len, int q_offset,
                float scale) {
  constexpr int LD = D + 1, NC = D / 8;
  extern __shared__ float sm[];
  float* Qs = sm;                    // [BT][LD] each
  float* dOs = Qs + BT * LD;
  float* Ks = dOs + BT * LD;
  float* Vs = Ks + BT * LD;
  float* dS = Vs + BT * LD;          // [BT][BT + 1]
  float* rowL = dS + BT * (BT + 1);  // lse of the tile's rows
  float* rowD = rowL + BT;           // delta of the tile's rows
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int i0 = blockIdx.x * BT, tid = threadIdx.x;
  const size_t qb = (size_t)bh * Tq * D;
  const size_t kvb = ((size_t)b * Hkv + hk) * S * D;

  load_f32_rows<D>(q + qb, i0, Tq, Qs);
  load_f32_rows<D>(dO + qb, i0, Tq, dOs);
  __syncthreads();
  if (tid < BT) {
    const int i = i0 + tid;
    float dl = 0.f;
    if (i < Tq)
      for (int c = 0; c < D; ++c) dl = fmaf(dOs[tid * LD + c], O[qb + (size_t)i * D + c], dl);
    rowD[tid] = dl;
    rowL[tid] = i < Tq ? lse[(size_t)bh * Tq + i] : INFINITY;
  }

  const int r = tid >> 3, cl = tid & 7;
  float acc[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u) acc[u] = 0.f;
  const int tile_last = min(Tq, i0 + BT) - 1;
  const int kv_end = min(min(kv_len, q_offset + tile_last + 1), S);
  for (int j0 = 0; j0 < kv_end; j0 += BT) {
    __syncthreads();                 // the previous tile's Ks and dS are read
    load_bf16_rows<D>(k + kvb, j0, kv_end, Ks);
    load_bf16_rows<D>(v + kvb, j0, kv_end, Vs);
    __syncthreads();
    float p[PAIRS], dp[PAIRS];
    scores<D>(Qs, dOs, Ks, Vs, r, i0, j0, Tq, kv_end, q_offset, scale, rowL[r], p, dp);
#pragma unroll
    for (int u = 0; u < PAIRS; ++u)
      dS[r * (BT + 1) + cl + 8 * u] = p[u] * (dp[u] - rowD[r]) * scale;
    __syncthreads();
#pragma unroll 4
    for (int j = 0; j < BT; ++j) {
      const float d = dS[r * (BT + 1) + j];
#pragma unroll
      for (int u = 0; u < NC; ++u) acc[u] = fmaf(d, Ks[j * LD + cl + 8 * u], acc[u]);
    }
  }
  if (i0 + r < Tq) {
    float* out = dq + qb + (size_t)(i0 + r) * D;
#pragma unroll
    for (int u = 0; u < NC; ++u) out[cl + 8 * u] = acc[u];
  }
}

template <int D>
__global__ void __launch_bounds__(BW_THREADS)
flash_dkv_kernel(const float* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const float* __restrict__ dO,
                 const float* __restrict__ O, const float* __restrict__ lse,
                 __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Hq, int Hkv,
                 int Tq, int S, int kv_len, int q_offset, float scale) {
  constexpr int LD = D + 1, NC = D / 8;
  extern __shared__ float sm[];
  float* Ks = sm;                    // [BT][LD] each
  float* Vs = Ks + BT * LD;
  float* Qs = Vs + BT * LD;
  float* dOs = Qs + BT * LD;         // f32 dO, for dV
  float* dOb = dOs + BT * LD;        // dO rounded to bf16, for dK's dP
  float* P = dOb + BT * LD;          // [BT][BT + 1]
  float* dS = P + BT * (BT + 1);
  float* rowL = dS + BT * (BT + 1);
  float* rowD = rowL + BT;
  const int bh = blockIdx.y, b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int j0 = blockIdx.x * BT, tid = threadIdx.x;
  const size_t qb = (size_t)bh * Tq * D;
  const size_t kvb = ((size_t)b * Hkv + hk) * S * D;
  const int kv_end = min(kv_len, S);

  // phase 2 ownership: key jr of the tile, columns cl + 8u
  const int jr = tid >> 3, cl = tid & 7;
  float acck[NC], accv[NC];
#pragma unroll
  for (int u = 0; u < NC; ++u) acck[u] = accv[u] = 0.f;
  if (j0 < kv_end) {
    load_bf16_rows<D>(k + kvb, j0, kv_end, Ks);
    load_bf16_rows<D>(v + kvb, j0, kv_end, Vs);
    // the first query tile whose causal window reaches key j0
    const int first = max(0, j0 - q_offset) / BT * BT;
    const int r = tid >> 3;
    for (int i0 = first; i0 < Tq; i0 += BT) {
      __syncthreads();               // the previous tile's Qs, dOs, P and dS are read
      load_f32_rows<D>(q + qb, i0, Tq, Qs);
      load_f32_rows<D>(dO + qb, i0, Tq, dOs);
      __syncthreads();
      for (int e = tid; e < BT * D; e += BW_THREADS) {
        const int rr = e / D, c = e % D;
        dOb[rr * LD + c] = __bfloat162float(__float2bfloat16_rn(dOs[rr * LD + c]));
      }
      if (tid < BT) {
        const int i = i0 + tid;
        float dl = 0.f;
        if (i < Tq)
          for (int c = 0; c < D; ++c) dl = fmaf(dOs[tid * LD + c], O[qb + (size_t)i * D + c], dl);
        rowD[tid] = dl;
        rowL[tid] = i < Tq ? lse[(size_t)bh * Tq + i] : INFINITY;
      }
      __syncthreads();
      float p[PAIRS], dp[PAIRS];
      scores<D>(Qs, dOb, Ks, Vs, r, i0, j0, Tq, kv_end, q_offset, scale, rowL[r], p, dp);
#pragma unroll
      for (int u = 0; u < PAIRS; ++u) {
        P[r * (BT + 1) + cl + 8 * u] = p[u];
        dS[r * (BT + 1) + cl + 8 * u] = p[u] * (dp[u] - rowD[r]) * scale;
      }
      __syncthreads();
#pragma unroll 4
      for (int i = 0; i < BT; ++i) {
        const float pv = P[i * (BT + 1) + jr], ds = dS[i * (BT + 1) + jr];
#pragma unroll
        for (int u = 0; u < NC; ++u) {
          accv[u] = fmaf(pv, dOs[i * LD + cl + 8 * u], accv[u]);
          acck[u] = fmaf(ds, Qs[i * LD + cl + 8 * u], acck[u]);
        }
      }
    }
  }
  if (j0 + jr < S) {
    const size_t o = ((size_t)bh * S + j0 + jr) * D;
#pragma unroll
    for (int u = 0; u < NC; ++u) {
      dk[o + cl + 8 * u] = __float2bfloat16_rn(acck[u]);
      dv[o + cl + 8 * u] = __float2bfloat16_rn(accv[u]);
    }
  }
}

template <int D>
int launch_dq(const float* q, const __nv_bfloat16* k, const __nv_bfloat16* v, const float* dO,
              const float* O, const float* lse, float* dq, int B, int Hq, int Hkv, int Tq, int S,
              int kv_len, int q_offset, float scale, cudaStream_t st) {
  const size_t smem = (size_t)(4 * BT * (D + 1) + BT * (BT + 1) + 2 * BT) * sizeof(float);
  const int rc = allow_dynamic_smem(flash_dq_kernel<D>, smem);
  if (rc != 0) return rc;
  const dim3 grid((Tq + BT - 1) / BT, B * Hq);
  flash_dq_kernel<D><<<grid, BW_THREADS, smem, st>>>(q, k, v, dO, O, lse, dq, Hq, Hkv, Tq, S,
                                                     kv_len, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const float* q, const __nv_bfloat16* k, const __nv_bfloat16* v, const float* dO,
               const float* O, const float* lse, __nv_bfloat16* dk, __nv_bfloat16* dv, int B,
               int Hq, int Hkv, int Tq, int S, int kv_len, int q_offset, float scale,
               cudaStream_t st) {
  const size_t smem = (size_t)(5 * BT * (D + 1) + 2 * BT * (BT + 1) + 2 * BT) * sizeof(float);
  const int rc = allow_dynamic_smem(flash_dkv_kernel<D>, smem);
  if (rc != 0) return rc;
  const dim3 grid((S + BT - 1) / BT, B * Hq);
  flash_dkv_kernel<D><<<grid, BW_THREADS, smem, st>>>(q, k, v, dO, O, lse, dk, dv, Hq, Hkv, Tq,
                                                      S, kv_len, q_offset, scale);
  return (int)cudaGetLastError();
}

bool bad_shape(int B, int Hq, int Hkv, int Tq, int S, int q_offset) {
  return B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Tq <= 0 || S <= 0 || q_offset < 0;
}

}  // namespace

// q, dO, O f32 [B, Hq, Tq, D]; k, v bf16 [B, Hkv, S, D]; lse f32 [B, Hq, Tq]
// -> dq f32 [B, Hq, Tq, D]; all contiguous.
ZGML_EXPORT int zgml_flash_dq(const float* q, const void* k, const void* v, const float* dO,
                              const float* O, const float* lse, float* dq, int B, int Hq, int Hkv,
                              int Tq, int S, int D, int kv_len, int q_offset, float scale,
                              void* stream) {
  if (bad_shape(B, Hq, Hkv, Tq, S, q_offset)) return ZGML_ERR_SHAPE;
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZGML_DQ(DD)                                                                    \
  case DD:                                                                             \
    return launch_dq<DD>(q, kb, vb, dO, O, lse, dq, B, Hq, Hkv, Tq, S, kv_len, q_offset, \
                         scale, st);
  switch (D) {
    ZGML_DQ(16)
    ZGML_DQ(32)
    ZGML_DQ(64)
    ZGML_DQ(128)
    default: return ZGML_ERR_HEAD_DIM;
  }
#undef ZGML_DQ
}

// The same inputs -> dk, dv bf16 [B, Hq, S, D] per query head; contiguous.
ZGML_EXPORT int zgml_flash_dkv(const float* q, const void* k, const void* v, const float* dO,
                               const float* O, const float* lse, void* dk, void* dv, int B,
                               int Hq, int Hkv, int Tq, int S, int D, int kv_len, int q_offset,
                               float scale, void* stream) {
  if (bad_shape(B, Hq, Hkv, Tq, S, q_offset)) return ZGML_ERR_SHAPE;
  const auto* kb = static_cast<const __nv_bfloat16*>(k);
  const auto* vb = static_cast<const __nv_bfloat16*>(v);
  auto* dkb = static_cast<__nv_bfloat16*>(dk);
  auto* dvb = static_cast<__nv_bfloat16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZGML_DKV(DD)                                                                         \
  case DD:                                                                                   \
    return launch_dkv<DD>(q, kb, vb, dO, O, lse, dkb, dvb, B, Hq, Hkv, Tq, S, kv_len, q_offset, \
                          scale, st);
  switch (D) {
    ZGML_DKV(16)
    ZGML_DKV(32)
    ZGML_DKV(64)
    ZGML_DKV(128)
    default: return ZGML_ERR_HEAD_DIM;
  }
#undef ZGML_DKV
}
