// The phases of the batch-1 decode layer as device functions, as the
// whole-stack megacalls K14 / K15 run them (stack_decode.cu: all six for
// every layer in one launch): warp-per-row GEMVs that load as they dot. K7
// (layer_attn.cu) and K6 (ffn.cu) stream their weights instead
// (weight_stream.cuh) and share LayerParams / FfnParams and merge_head.
//
// Every phase is called by all threads of every block of a cooperative
// launch, reads what earlier phases wrote (in this launch, by other blocks)
// with __ldcg after a grid barrier, and needs the caller's barrier before the
// next phase reads what it wrote. The BF16 parameter is K15's numerics: each
// staged operand row (the normed x, the attention output, the second normed
// x, the SwiGLU activation) rounded to bf16 once, and every weight element
// bf16_rn(level * bf16_rn(scale)) (common.cuh rows_bf16); false is K7's and
// K6d's f32.
#pragma once

#include "decode_split.cuh"

constexpr int LK_THREADS = 512;            // K7's block, and the megacalls'
constexpr int LK_WARPS = LK_THREADS / 32;
constexpr int FFN_THREADS = 512;           // K6's block, and the megacalls'
constexpr int FFN_WARPS = FFN_THREADS / 32;

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
  void* ck;                  // layer li's slab [hkv, S, hd]: bf16, or int8 levels (kv8)
  void* cv;
  float* cks;                // kv8: layer li's scales [hkv, S]
  float* cvs;
  const int* pos;            // [1], device
  float* x_out;              // [d]
  float* kv_cur;             // [2, hkv, hd]: rotated k, then v
  float* q;                  // [hq, hd] scratch
  float* att;                // [hq, hd] scratch
  float* part;               // [hq, n_split, hd + 2] scratch
  unsigned int* bar;         // grid-barrier words
  int8_t* xq_out;            // [d] or null: a_i8's activations, for checks
  float* xs_out;             // [d/32] or null: their scales
  int8_t* qq_out;            // kv8: [hq, hd] or null: the quantized q, for checks
  float* qs_out;             // [hq] or null: its scales
  int d, hq, hkv, S, n_split;
  float eps, scale;
};

// Dynamic shared memory of the attention phases, in bytes.
template <int D>
inline size_t attn_smem_bytes(int d, int hq, int hkv) {
  const int k_max = d > hq * D ? d : hq * D;
  const size_t smem = sizeof(float) * (32 + (size_t)k_max / 32 * 33);
  const size_t smem_b = decode_chunk_smem_bytes<D, false>(hq / hkv);
  return smem_b > smem ? smem_b : smem;
}

// Warps the widest warp-per-row attention phase can use (A's RoPE pairs, C's rows).
template <int D>
inline int attn_max_warps(int d, int hq, int hkv) {
  const int n_pairs = (hq + 2 * hkv) * (D / 2);
  return n_pairs > d ? n_pairs : d;
}

// A: rmsnorm, QKV in RoPE pairs, rotate, emit q / k_cur / v_cur (and, with
// the bf16 cache, k_cur / v_cur rounded into cache row pos).
template <class F, int D, bool BF16>
__device__ __forceinline__ void attn_phase_a(const LayerParams& p, float* smem) {
  float* red = smem;                       // 32 floats
  float* xs = smem + 32;                   // [K/32][33]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * LK_WARPS + warp;
  const int nwarps = gridDim.x * LK_WARPS;
  const int pos = __ldg(p.pos);
  constexpr int HALF = D / 2;
  const int nbd = p.d / 32;
  stage_rmsnorm<BF16>(p.x, p.g, p.d, p.eps, xs, red);
  const int n_pairs = (p.hq + 2 * p.hkv) * HALF;
  for (int t = gwarp; t < n_pairs; t += nwarps) {
    const int h = t / HALF, i = t % HALF;
    const int r1 = h * D + i, r2 = r1 + HALF;
    const uint8_t* qs[2] = {p.wqkv_qs + (size_t)r1 * nbd * F::BYTES,
                            p.wqkv_qs + (size_t)r2 * nbd * F::BYTES};
    const __half* dd[2] = {p.wqkv_d + (size_t)r1 * nbd, p.wqkv_d + (size_t)r2 * nbd};
    float acc[2];
    if constexpr (BF16) {
      float a[2][1];
      rows_bf16<F, 2, 1>(qs, dd, xs, 0, nbd, lane, a);
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
        __nv_bfloat16* cache = static_cast<__nv_bfloat16*>(kvh < p.hkv ? p.ck : p.cv);
        const size_t row = ((size_t)(kvh % p.hkv) * p.S + pos) * D;
        cache[row + i] = __float2bfloat16_rn(o1);
        cache[row + i + HALF] = __float2bfloat16_rn(o2);
      }
    }
  }
}

// B: split-KV partials over the cache rows below pos.
template <int D>
__device__ __forceinline__ void attn_phase_b(const LayerParams& p, float* smem) {
  using T = __nv_bfloat16;
  const int pos = __ldg(p.pos);
  const int n_rep = p.hq / p.hkv;
  const int n_live = (pos + DA_CHUNK - 1) / DA_CHUNK;
  const size_t head_stride = (size_t)p.n_split * (D + 2);
  for (int item = blockIdx.x; item < p.hkv * n_live; item += gridDim.x) {
    const int hk = item / n_live, split = item % n_live;
    const int c0 = split * DA_CHUNK;
    const size_t pos0 = (size_t)hk * p.S + c0;
    decode_chunk_partial<D, LK_THREADS, T>(
        p.q + (size_t)hk * n_rep * D, static_cast<const T*>(p.ck) + pos0 * D,
        nullptr, static_cast<const T*>(p.cv) + pos0 * D, nullptr, min(DA_CHUNK, pos - c0),
        n_rep, p.scale, p.part + ((size_t)hk * n_rep * p.n_split + split) * (D + 2),
        head_stride, smem);
  }
}

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

// Combine the chunks with the self column into att.
template <int D>
__device__ __forceinline__ void attn_combine(const LayerParams& p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * LK_WARPS + warp;
  const int nwarps = gridDim.x * LK_WARPS;
  const int pos = __ldg(p.pos);
  const int n_live = (pos + DA_CHUNK - 1) / DA_CHUNK;
  for (int h = gwarp; h < p.hq; h += nwarps) merge_head<D>(p, h, n_live, lane);
}

// C: x_out = x + att @ Wo^T.
template <class F, int D, bool BF16>
__device__ __forceinline__ void attn_phase_c(const LayerParams& p, float* smem) {
  float* xs = smem + 32;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * LK_WARPS + warp;
  const int nwarps = gridDim.x * LK_WARPS;
  const int nq = p.hq * D;
  stage_padded<BF16>(p.att, nq, xs);
  __syncthreads();
  const int nbq = nq / 32;
  for (int n = gwarp; n < p.d; n += nwarps) {
    const uint8_t* qs[1] = {p.wo_qs + (size_t)n * nbq * F::BYTES};
    const __half* dd[1] = {p.wo_d + (size_t)n * nbq};
    float acc[1];
    if constexpr (BF16) {
      float a[1][1];
      rows_bf16<F, 1, 1>(qs, dd, xs, 0, nbq, lane, a);
      acc[0] = a[0][0];
    } else {
      rows_f32<F, 1>(qs, dd, xs, nbq, lane, acc);
    }
    const float s = warp_sum(acc[0]);
    if (lane == 0) p.x_out[n] = __ldcg(p.x + n) + s;
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
  unsigned int* bar;       // grid-barrier words
  int8_t* xq_out;          // [M, D] or null: K6c's activations, for checks
  float* xs_out;           // [M, D/32] or null: their scales
  int M, D, F;
  float eps;
};

// Shared floats per staged row: [max(D, F)/32][33].
__host__ __device__ inline size_t ffn_row_floats(int D, int F) {
  return (size_t)(D > F ? D : F) / 32 * 33;
}

// R weight rows against the MR x rows staged at xs + m * stride ([K/32][33]
// each): lane l takes blocks l, l+32, ...; each block is loaded and each of
// its levels converted once, and dotted with every x row in block_dot_f32's
// order.
template <class F, int R, int MR>
__device__ __forceinline__ void rows_f32_mr(const uint8_t* const (&qs)[R],
                                            const __half* const (&d)[R], const float* xs,
                                            int stride, int nblk, int lane,
                                            float (&acc)[R][MR]) {
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int m = 0; m < MR; ++m) acc[r][m] = 0.f;
  for (int b = lane; b < nblk; b += 32) {
    uint32_t w[R][F::WORDS];
    float s[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      load_block<F>(qs[r], b, w[r]);
      s[r] = __half2float(d[r][b]);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float sum[MR];
#pragma unroll
      for (int m = 0; m < MR; ++m) sum[m] = 0.f;
#pragma unroll
      for (int t = 0; t < 32; ++t) {
        const int j = F::elem(t);
        const float v = F::level(w[r], j);
#pragma unroll
        for (int m = 0; m < MR; ++m) sum[m] = fmaf(v, xs[(size_t)m * stride + b * 33 + j], sum[m]);
      }
#pragma unroll
      for (int m = 0; m < MR; ++m) acc[r][m] = fmaf(sum[m], s[r], acc[r][m]);
    }
  }
}

// Gate|up of the row group m0 .. m0 + rows - 1 (MR staged, rows past the
// group's end 0): every block stages n = rmsnorm(x) * g, each warp owns rows
// f and F + f of w_gate_up and writes act[m][f] = silu(gate) * up.
template <class F, int MR, bool BF16>
__device__ __forceinline__ void ffn_phase_gu(const FfnParams& p, int m0, int rows, float* smem) {
  float* red = smem;                       // 32 floats
  float* xs = smem + 32;                   // MR rows of [max(D, F)/32][33]
  const int stride = (int)ffn_row_floats(p.D, p.F);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * FFN_WARPS + warp;
  const int nwarps = gridDim.x * FFN_WARPS;
  const int nbD = p.D / 32;
  for (int m = 0; m < MR; ++m) {           // rows past the group's end stay 0
    const size_t row = (size_t)(m0 + m);
    if (m < rows) {
      stage_rmsnorm<BF16>(p.x + row * p.D, p.g, p.D, p.eps, xs + (size_t)m * stride, red);
    } else {
      for (int i = threadIdx.x; i < nbD * 33; i += blockDim.x)
        xs[(size_t)m * stride + i] = 0.f;
    }
  }
  __syncthreads();
  for (int f = gwarp; f < p.F; f += nwarps) {
    const uint8_t* qs[2] = {p.gu_qs + (size_t)f * nbD * F::BYTES,
                            p.gu_qs + (size_t)(p.F + f) * nbD * F::BYTES};
    const __half* dd[2] = {p.gu_d + (size_t)f * nbD, p.gu_d + (size_t)(p.F + f) * nbD};
    float acc[2][MR];
    if constexpr (BF16) {
      rows_bf16<F, 2, MR>(qs, dd, xs, stride, nbD, lane, acc);
    } else {
      rows_f32_mr<F, 2, MR>(qs, dd, xs, stride, nbD, lane, acc);
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const float gate = warp_sum(acc[0][m]);
      const float up = warp_sum(acc[1][m]);
      if (lane == 0 && m < rows) {
        const float sig = 1.0f / (1.0f + expf(-gate));
        p.act[(size_t)(m0 + m) * p.F + f] = (gate * sig) * up;
      }
    }
  }
}

// Down + residual of the row group: every block stages the group's act rows,
// then a warp-per-row GEMV over w_down, y = x + act @ w_down^T.
template <class F, int MR, bool BF16>
__device__ __forceinline__ void ffn_phase_down(const FfnParams& p, int m0, int rows,
                                               float* smem) {
  float* xs = smem + 32;
  const int stride = (int)ffn_row_floats(p.D, p.F);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gwarp = blockIdx.x * FFN_WARPS + warp;
  const int nwarps = gridDim.x * FFN_WARPS;
  const int nbF = p.F / 32;
  for (int m = 0; m < MR; ++m) {
    if (m < rows) {
      stage_padded<BF16>(p.act + (size_t)(m0 + m) * p.F, p.F, xs + (size_t)m * stride);
    } else {
      for (int i = threadIdx.x; i < nbF * 33; i += blockDim.x)
        xs[(size_t)m * stride + i] = 0.f;
    }
  }
  __syncthreads();
  for (int j = gwarp; j < p.D; j += nwarps) {
    const uint8_t* qs[1] = {p.dn_qs + (size_t)j * nbF * F::BYTES};
    const __half* dd[1] = {p.dn_d + (size_t)j * nbF};
    float acc[1][MR];
    if constexpr (BF16) {
      rows_bf16<F, 1, MR>(qs, dd, xs, stride, nbF, lane, acc);
    } else {
      rows_f32_mr<F, 1, MR>(qs, dd, xs, stride, nbF, lane, acc);
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      const float s = warp_sum(acc[0][m]);
      if (lane == 0 && m < rows) {
        const size_t o = (size_t)(m0 + m) * p.D + j;
        p.y[o] = __ldcg(p.x + o) + s;
      }
    }
  }
}
