// K10dq flash_dq and K10dkv flash_dkv: the FlashAttention-2 backward of
// training's causal GQA flash attention over bf16 K/V, on TF32 and bf16
// tensor cores.
//
// Replaces: zgml_tpu/ops/flash_vjp.py `_dq_kernel` (pallas_call at line 230)
// and `_dkv_kernel` (pallas_call at line 327), which the backward of
// `make_flash_vjp` runs under jax.grad: at ZGML_TPU_PREFILL_BF16=0 (f32
// operands) here, at the default 1 in the bf16 forms (below).
//
// Semantics (plain versions: ops/flash_vjp.py flash_dq_ref, flash_dkv_ref):
//   q, dO, O f32 [B, Hq, Tq, D]; k, v bf16 [B, Hkv, S, D]; lse f32 [B, Hq, Tq]
//   from K10f. Query row i (absolute q_offset + i) sees keys j < kv_len with
//   j <= q_offset + i; query head h reads KV head h / (Hq / Hkv).
//   s = (q . k) * scale, p = exp(s - lse), delta = rowsum(dO O);
//     dQ_i  = sum_j dS_ij k_j,   dS  = p * (dO . v - delta) * scale    (f32 dO)
//     dV_j  = sum_i p_ij dO_i
//     dK_j  = sum_i dS'_ij q_i,  dS' = p * (bf16(dO) . v - delta) * scale
//   dK's dP takes dO rounded to bf16, as flash_vjp.py:275 does whatever the
//   operand dtype; dQ's takes the f32 dO (:182-185). dK and dV are per QUERY
//   head, [B, Hq, S, D] bf16 (k's dtype), rounded to nearest even; the caller
//   sums each GQA group (ops/flash_vjp.py group_sum).
//
// What bounds it on the H100: the products. Per head the live (query, key)
// pairs, each a D-long dot per product: dQ takes 3 (s, dP, dS k), dK / dV 4
// (s, dP', P^T dO, dS'^T q). Every product but dP' has one f32 operand, which
// runs as two TF32 parts (below), so dQ is 2 + 2 + 2 TF32 products per pair,
// 12 * heads * live * D TF32 operations, and dK / dV 2 + 1 + 3 + 3 = 9 (dP'
// on bf16 tensor cores, both operands exact), 16 TF32 and 2 bf16: at the
// TinyLlama training shape (B 4, T 512, 32 query heads, D 64) 26 and 38 us
// at 495 / 989 TFLOP/s. The bytes (q, dO, lse, delta, K, V read once, the
// outputs written once) take ~10-15 us.
//
// What the design does about it:
//  * delta is a pre-pass (flash_delta_kernel): one warp per row reads dO and
//    O coalesced, once, into f32 [B, Hq, Tq]; both kernels read it beside the
//    lse, so no tile sums it again.
//  * Split TF32 as in K3 (flash_attn.cu) and K11: mma.sync m16n8k8 TF32 with
//    f32 accumulators. K and V are bf16, exact in TF32, and go in as they
//    are (through ldmatrix where the pairs it gives fit the fragment). An
//    f32 operand x (q, dO, p, dS) goes in as hi = tf32_rna(x) and lo =
//    tf32_rna(x - hi), leaving at most 2^-22 |x|. A
//    product of an f32 operand and an exact one takes two MMAs (S = q K^T,
//    dP = dO V^T, dQ = dS K), a product of two f32 operands three (hi hi +
//    hi lo + lo hi: dV = P^T dO, dK = dS'^T q; the lo lo term is below
//    2^-22). dP' = bf16(dO) V^T has two exact operands: one bf16 m16n8k16
//    MMA, whose products are exact in f32. No TF32-only product: the error
//    stays in the class of f32 rounding, the f32 form's function.
//  * Short chains. The tensor cores round each MMA's sum toward zero (in
//    K10f one long chain moved training's gradients past their bound). A
//    tile's S and dP are summed in three chains each, as K3's S (hi products
//    of even and of odd k-steps, lo products), and the tile's dQ, dK or dV in
//    fresh accumulators per 8-column block (hi products, and the small terms)
//    that join the running sum in one f32 add: no chain is longer than 16
//    MMAs. K10dkv goes further where its bias showed: a round toward zero in
//    every MMA of a chain leans the sum toward zero, and dK's error, coherent
//    over the positions, moved train_dense's wk gradient 1.09x past its
//    bound on the card (PERF.md). So dK's dP' and dK / dV's hi products take
//    each MMA alone in a fresh accumulator, added round-to-nearest.
//    tests/test_torch_flash_bwd_split.py emulates it. The fresh accumulators
//    of DQ_NB (dQ) or DKV_NB (dK / dV) column blocks build side by side, so
//    a warp has that many independent chains in flight; one block at a time
//    left each warp waiting on one chain's MMA latency.
//  * K10dq is K3's structure: one block of 4 warps per (b, KV head, 64
//    packed query rows), the n_rep query heads of the KV head packed into
//    the rows position-major (row r = position r / n_rep of head hk * n_rep
//    + r % n_rep), so one staged K/V tile serves n_rep heads. Each warp owns
//    16 rows. K/V tiles of 64 keys (at every head dim: K3's 32 at D = 128
//    ran slower here) are staged bf16 by 16-byte cp.async, double-buffered.
//    q and dO are staged f32 once and split where a fragment is loaded (each
//    value by the one thread whose fragment holds it). P and dS go from the
//    S accumulators into A fragments with no shuffle, by the key permutation
//    K3 uses for P V (thread t holds keys 2t, 2t + 1 of an 8-key block;
//    ldmatrix.trans gives it the same keys of K). dQ lives in shared memory,
//    one thread's slots read and written by that thread only, as K3 keeps O:
//    held in registers beside the S and dP chains it spilled at D = 64 and
//    128 in every loop form tried.
//  * K10dkv works on transposed tiles: S^T = K q^T, K the exact A operand
//    (rows = 16 keys a warp, 64 keys a block) and q the split B operand. The
//    block stages its K and V once and streams 32-row query tiles (q and dO
//    f32, lse, delta) through a double-buffered cp.async ring, from the first
//    tile whose causal window reaches its keys. The B operands (q, dO) are
//    shared by the four warps, so each landed stage is split once, by the
//    whole block: the hi parts in place, the lo parts and bf16(dO) beside
//    them; the warps then load TF32 parts and bf16 pairs and split nothing
//    but their own P and dS. P^T and dS'^T feed dV and dK as A fragments
//    from the accumulators with no shuffle, the queries permuted as K3's
//    keys. dK and dV live in shared memory (thread-owned slots). One block
//    per (b, query head, key tile): the n_rep heads of a KV head re-read its
//    K / V tile from L2 (the other form, one block per KV head walking its
//    n_rep heads and folding group_sum, is not built: see PERF.md). Key
//    tiles go out in causal order, the longest (lowest keys) first: the
//    tile is the grid's slowest dimension.
//  * Filling the card: where the grid falls short of the blocks the card
//    holds at once (the kv_len < S case), ops/flash_vjp.py splits each
//    tile's key range (dQ) or query range (dK / dV) across blocks (grid z)
//    by a plan read from the SM count and the occupancy; each split writes
//    an f32 partial and flash_bwd_sum_kernel adds them in split order (and
//    rounds dK / dV to bf16 once). No atomics: the same bits on every run.
//  * What holds them back (tried on the H100, not kept): in K10dkv the four
//    warps each load the same B fragments (q, dO) from shared memory, and
//    8 warps a block at D = 128 (two warps sharing a key group, each with
//    half of dK / dV's columns) ran slower, as did K's A fragments through
//    ldmatrix with 64-bit q loads (bank conflicts); shared-memory traffic
//    and mma.sync issue, not latency, look like the limit. wgmma, whose
//    B is read from shared memory once per warpgroup, is the next step.
//  * Masks: only tiles that cross a row's causal limit, kv_len or Tq are
//    masked; a warp skips a tile none of its pairs reaches. Keys past
//    kv_len and queries past Tq are zero-filled in shared memory, so no
//    stale value meets an MMA.
//
// The bf16 forms (template flag BF16; ZGML_TPU_PREFILL_BF16, on by default):
// JAX's operand dtypes at bf16=True (flash_vjp.py:168-187, 258-284). s from
// bf16(q) and k on bf16 mma.sync m16n8k16 in the order flash_attn.cu's bf16
// form takes it (one chain of D / 16 MMAs; bf16_scores), so p = exp(s * scale
// - lse) meets the LSE of the same bits; dP = bf16(dO) . v in K10dq (dK's dP'
// already is); dV += bf16(p)^T bf16(dO) on bf16 MMAs, each MMA alone in a
// fresh accumulator added round-to-nearest (dkv_accumulate_bf16); dQ = dS k
// and dK = dS'^T bf16(q) keep the f32 dS, split into two TF32 parts against
// k and bf16(q), which are exact in TF32: two products, not three
// (dkv_accumulate<D, true>). bf16(q) is packed and rounded in place once per
// landed stage, in the room of the lo parts the form does not use. The
// delta pre-pass and the split plans are the f32 form's.
#include "common.cuh"
#include "tf32_mma.cuh"

#include <climits>

namespace {

using tf32::cp_async16;
using tf32::cp_async4;
using tf32::cp_async_commit;
using tf32::cp_async_wait;
using tf32::ldsm_x4;
using tf32::ldsm_x4_trans;
using tf32::mma_bf16;
using tf32::mma_tf32;
using tf32::pack_bf16x2;
using tf32::split_tf32;

constexpr int BW_THREADS = 128;      // 4 warps
constexpr unsigned BW_FULL = 0xFFFFFFFFu;
constexpr int DQ_BM = 64;            // packed query rows of a K10dq tile: 4 warps x 16
constexpr int DKV_BK = 64;           // keys of a K10dkv block: 4 warps x 16
constexpr int DKV_BQ = 32;           // query rows of a K10dkv stage

constexpr int DQ_BN = 64;            // keys of a K10dq K/V stage, at every head dim
constexpr int DQ_NB = 4;             // 8-column blocks of dQ built side by side
constexpr int DKV_NB = 8;            // the same for dK / dV

struct BwParams {
  const float* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const float* dO;
  const float* lse;
  const float* delta;
  float* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  float* part;        // n_split > 1: the splits' f32 partials
  int Hq, Hkv, Tq, S, kv_len, q_offset, n_split;
  float scale;
};

template <int D>
struct DqShape {
  static constexpr int BN = DQ_BN;                // keys per K/V stage
  static constexpr int NT = BN / 8;               // 8-key blocks of a stage
  static constexpr int NO = D / 8;                // 8-column blocks of dQ
  static constexpr int NB = DQ_NB < NO ? DQ_NB : NO;
  static constexpr int LDQ = D + 8;               // floats per q / dO / dQ row in smem
  static constexpr int LDK = D + 8;               // bf16 per staged K / V row
  static_assert(NT % 4 == 0 && D % 16 == 0 && NO % NB == 0, "tile shape");
};

// q, dO, dQ [DQ_BM][LDQ] f32; K and V stages [BN][LDK] bf16, two stages
template <int D>
constexpr size_t dq_smem_bytes() {
  using Sh = DqShape<D>;
  return 3ull * DQ_BM * Sh::LDQ * sizeof(float) + 2ull * 2 * Sh::BN * Sh::LDK * 2;
}

template <int D>
struct DkvShape {
  static constexpr int NQ = DKV_BQ / 8;           // 8-query blocks of a stage
  static constexpr int NO = D / 8;                // 8-column blocks of dK / dV
  static constexpr int NB = DKV_NB < NO ? DKV_NB : NO;
  static constexpr int LDQ = D + 4;               // floats per staged q / dO row: the
                                                  // fragment loads (row g, col t) and
                                                  // (rows 2t, 2t + 1, col g) hit
                                                  // distinct banks
  static constexpr int LDB = D + 8;               // bf16 per bf16(dO) row
  static constexpr int LDK = D + 8;               // bf16 per K / V row
  static constexpr int LDA = D + 8;               // floats per dK / dV row
  static_assert(D % 16 == 0 && NO % NB == 0, "tile shape");
};

// K, V [DKV_BK][LDK] bf16; the q and dO stages [DKV_BQ][LDQ] f32 and the lse,
// delta stages [DKV_BQ] f32, two each; dK, dV [DKV_BK][LDA] f32; the lo parts
// of the stage's q and dO [DKV_BQ][LDQ] f32 and its bf16(dO) [DKV_BQ][LDB]
template <int D>
constexpr size_t dkv_smem_bytes() {
  using Sh = DkvShape<D>;
  return 2ull * DKV_BK * Sh::LDK * 2 + 2ull * 2 * DKV_BQ * Sh::LDQ * sizeof(float) +
         2ull * 2 * DKV_BQ * sizeof(float) + 2ull * DKV_BK * Sh::LDA * sizeof(float) +
         2ull * DKV_BQ * Sh::LDQ * sizeof(float) + 1ull * DKV_BQ * Sh::LDB * 2;
}

// delta[row] = sum_c dO[row, c] * O[row, c]: one warp per row, coalesced
__global__ void flash_delta_kernel(const float* __restrict__ dO, const float* __restrict__ O,
                                   float* __restrict__ delta, int rows, int D) {
  const int row = (int)((blockIdx.x * (size_t)blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const float4* a = reinterpret_cast<const float4*>(dO + (size_t)row * D);
  const float4* b = reinterpret_cast<const float4*>(O + (size_t)row * D);
  float s = 0.f;
  for (int c = lane; c < D / 4; c += 32) {
    const float4 x = __ldg(a + c), y = __ldg(b + c);
    s = fmaf(x.x, y.x, s);
    s = fmaf(x.y, y.y, s);
    s = fmaf(x.z, y.z, s);
    s = fmaf(x.w, y.w, s);
  }
  s = warp_sum(s);
  if (lane == 0) delta[row] = s;
}

// out[i] = the sum of the n_split partials part[z * total + i], in split order;
// f32 out (dQ) or, with bf16 outputs, out_b (the first n elements) and out_b2
// (the next n: dV after dK), rounded once
__global__ void flash_bwd_sum_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     __nv_bfloat16* __restrict__ out_b,
                                     __nv_bfloat16* __restrict__ out_b2, size_t n, int n_split,
                                     size_t total) {
  const size_t i = (blockIdx.x * (size_t)blockDim.x + threadIdx.x) * 4;
  if (i >= total) return;
  float4 acc = *reinterpret_cast<const float4*>(part + i);
  for (int z = 1; z < n_split; ++z) {
    const float4 x = *reinterpret_cast<const float4*>(part + (size_t)z * total + i);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  if (out != nullptr) {
    *reinterpret_cast<float4*>(out + i) = acc;
    return;
  }
  __nv_bfloat16* dst = i < n ? out_b + i : out_b2 + (i - n);
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16x2(acc.x, acc.y), pack_bf16x2(acc.z, acc.w));
}

// The key end of packed row tile m: one past the last key any of its rows sees
// (flash_attn.cu tile_key_end; ops/attention.py FlashPlan.tile_key_end).
__device__ __forceinline__ int dq_tile_key_end(int n_rows, int kv_len, int q_offset, int m,
                                               int n_rep) {
  const int last = min(n_rows, (m + 1) * DQ_BM) - 1;
  return max(0, min(kv_len, q_offset + last / n_rep + 1));
}

// Copy rows [j0, j0 + nk) of the [S, D] bf16 head at kg / vg into K / V
// stage buffers kd / vd of `rows` rows of LDK; rows past nk are zero-filled.
template <int D, int LDK>
__device__ __forceinline__ void stage_kv(const __nv_bfloat16* kg, const __nv_bfloat16* vg,
                                         int j0, int nk, int rows, __nv_bfloat16* kd,
                                         __nv_bfloat16* vd) {
  constexpr int CH = D / 8;                      // 16-byte chunks of a bf16 row
  for (int e = threadIdx.x; e < rows * CH; e += BW_THREADS) {
    const int r = e / CH, c = e % CH;
    const bool live = r < nk;
    const size_t off = (size_t)(j0 + (live ? r : 0)) * D + c * 8;
    cp_async16(kd + r * LDK + c * 8, kg + off, live);
    cp_async16(vd + r * LDK + c * 8, vg + off, live);
  }
}

// s[j] = bf16(a) . B^T for the warp's 16 rows and NT 8-key blocks: a the
// rows' f32 values in shared memory at af (this thread's row g, column 2t;
// row g + 8 at 8 LDA further), rounded to bf16 (nearest even) into the A
// fragments; B the staged bf16 rows [NT * 8][LDK] (K or V), through
// ldmatrix. One bf16 m16n8k16 MMA per 16 d, one chain from zero, in d order:
// the order flash_attn.cu's bf16 form takes its scores in.
template <int D, int NT, int LDA, int LDK>
__device__ __forceinline__ void bf16_scores(const float* af, const __nv_bfloat16* Bs,
                                            float (&s)[NT][4]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    uint32_t a[4];
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float2 x = *reinterpret_cast<const float2*>(af + 8 * LDA * e + 16 * ks + 8 * hf);
        a[2 * hf + e] = pack_bf16x2(x.x, x.y);
      }
#pragma unroll
    for (int j2 = 0; j2 < NT / 2; ++j2) {
      uint32_t kb[4];      // key blocks 2 j2, 2 j2 + 1: (d 16ks + 2t.., key g), (+8 ..)
      ldsm_x4(kb, Bs + (16 * j2 + (lane & 7) + 8 * (lane >> 4)) * LDK + 16 * ks +
                      8 * ((lane >> 3) & 1));
      mma_bf16(s[2 * j2], a, kb[0], kb[1]);
      mma_bf16(s[2 * j2 + 1], a, kb[2], kb[3]);
    }
  }
}

// ---- K10dq ------------------------------------------------------------------

// BF16: the bf16 form (s from bf16(q), dP from bf16(dO), one bf16 MMA per
// 16 d in one chain, as flash_attn.cu's bf16 form takes s); dS K as in the
// f32 form
template <int D, bool BF16>
__global__ void __launch_bounds__(BW_THREADS, 1) flash_dq_kernel(const BwParams p) {
  using Sh = DqShape<D>;
  constexpr int BN = Sh::BN, NT = Sh::NT, NO = Sh::NO, NB = Sh::NB, LDQ = Sh::LDQ;
  constexpr int LDK = Sh::LDK;
  extern __shared__ __align__(16) unsigned char dq_smem[];
  float* q_s = reinterpret_cast<float*>(dq_smem);
  float* do_s = q_s + DQ_BM * LDQ;
  float* dq_s = do_s + DQ_BM * LDQ;
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(dq_s + DQ_BM * LDQ);

  const int n_rep = p.Hq / p.Hkv;
  const int n_rows = n_rep * p.Tq;
  const int n_m = (n_rows + DQ_BM - 1) / DQ_BM;
  const int m = n_m - 1 - (int)blockIdx.y;          // the longest tiles first
  const int b = blockIdx.x / p.Hkv, hk = blockIdx.x % p.Hkv;
  const int split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  const int key_end = dq_tile_key_end(n_rows, p.kv_len, p.q_offset, m, n_rep);
  const int n_kt = (key_end + BN - 1) / BN;
  const int kt0 = (int)((long long)split * n_kt / p.n_split);
  const int kt1 = (int)((long long)(split + 1) * n_kt / p.n_split);

  // this thread's rows: warp * 16 + g and + 8 of the tile
  bool valid[2];
  int lim[2];             // keys [0, lim) are live for the row
  size_t qrow[2];         // its row of q, dO, dQ, lse and delta
  float lse_r[2], dl_r[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = m * DQ_BM + warp * 16 + g + 8 * e;
    valid[e] = r < n_rows;
    const int i = r / n_rep, h = hk * n_rep + r % n_rep;
    qrow[e] = ((size_t)b * p.Hq + h) * p.Tq + i;
    lim[e] = valid[e] ? min(p.kv_len, p.q_offset + i + 1) : 0;
    lse_r[e] = valid[e] ? p.lse[qrow[e]] : INFINITY;
    dl_r[e] = valid[e] ? p.delta[qrow[e]] : 0.f;
  }
  const int warp_hi = __reduce_max_sync(BW_FULL, max(lim[0], lim[1]));
  const int warp_lo = __reduce_min_sync(BW_FULL, min(valid[0] ? lim[0] : INT_MAX,
                                                     valid[1] ? lim[1] : INT_MAX));

  // dQ in shared memory: this thread's fragment slots (its two rows, columns
  // 8n + 2t and 2t + 1), which only this thread reads and writes
  float* const dq_row[2] = {dq_s + (warp * 16 + g) * LDQ + 2 * t,
                            dq_s + (warp * 16 + g + 8) * LDQ + 2 * t};
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<float2*>(dq_row[0] + 8 * n) = make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(dq_row[1] + 8 * n) = make_float2(0.f, 0.f);
  }

  const size_t pos0 = ((size_t)b * p.Hkv + hk) * p.S;   // the KV head's position 0
  const __nv_bfloat16* kg = p.k + pos0 * D;
  const __nv_bfloat16* vg = p.v + pos0 * D;

  if (kt0 < kt1) {
    stage_kv<D, LDK>(kg, vg, kt0 * BN, min(BN, key_end - kt0 * BN), BN, kv_s, kv_s + BN * LDK);
    cp_async_commit();
    // q and dO of the tile's rows (split into TF32 parts where a fragment is
    // loaded); rows past n_rows are 0
#pragma unroll 4
    for (int e = tid; e < DQ_BM * D / 4; e += BW_THREADS) {
      const int r = e / (D / 4), c = 4 * (e % (D / 4));
      const int pr = m * DQ_BM + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f), y = x;
      if (pr < n_rows) {
        const int h = hk * n_rep + pr % n_rep;
        const size_t off = (((size_t)b * p.Hq + h) * p.Tq + pr / n_rep) * D + c;
        x = __ldg(reinterpret_cast<const float4*>(p.q + off));
        y = __ldg(reinterpret_cast<const float4*>(p.dO + off));
      }
      *reinterpret_cast<float4*>(q_s + r * LDQ + c) = x;
      *reinterpret_cast<float4*>(do_s + r * LDQ + c) = y;
    }

    const float* qf = q_s + (warp * 16 + g) * LDQ + 2 * t;
    const float* df = do_s + (warp * 16 + g) * LDQ + 2 * t;
    for (int kt = kt0; kt < kt1; ++kt) {
      const int st = (kt - kt0) & 1;
      if (kt + 1 < kt1) {
        __nv_bfloat16* nxt = kv_s + (st ^ 1) * 2 * BN * LDK;
        stage_kv<D, LDK>(kg, vg, (kt + 1) * BN, min(BN, key_end - (kt + 1) * BN), BN, nxt,
                         nxt + BN * LDK);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const __nv_bfloat16* Ks = kv_s + st * 2 * BN * LDK;
      const __nv_bfloat16* Vs = Ks + BN * LDK;
      const int k0 = kt * BN;
      if (k0 < warp_hi) {
        const bool mask = k0 + BN > warp_lo;
        // p = exp(s * scale - lse) over the warp's 16 rows and the BN keys; S
        // in three chains (hi products of even and of odd k-steps, lo ones)
        float pr[NT][4];
        if constexpr (BF16) {
          float s0[NT][4];
          bf16_scores<D, NT, LDQ, LDK>(qf, Ks, s0);
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + 8 * j + 2 * t + (e & 1);
              const float x = __fmul_rn(s0[j][e], p.scale);
              pr[j][e] = mask && key >= lim[e >> 1] ? 0.f
                                                    : expf(__fsub_rn(x, lse_r[e >> 1]));
            }
          }
        } else {
          float s0[NT][4], s1[NT][4], sl[NT][4];
#pragma unroll
          for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s0[j][e] = s1[j][e] = sl[j][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < D / 8; ++kk) {
            const float2 x0 = *reinterpret_cast<const float2*>(qf + kk * 8);
            const float2 x1 = *reinterpret_cast<const float2*>(qf + 8 * LDQ + kk * 8);
            // A: (row g, d 2t), (g + 8, 2t), (g, 2t + 1), (g + 8, 2t + 1)
            uint32_t ah[4], al[4];
            split_tf32(x0.x, ah[0], al[0]);
            split_tf32(x1.x, ah[1], al[1]);
            split_tf32(x0.y, ah[2], al[2]);
            split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
            for (int j4 = 0; j4 < NT / 4; ++j4) {
              uint32_t kb[4];      // B of key blocks 4 j4 .. 4 j4 + 3: (d 2t, 2t + 1) of key g
              ldsm_x4(kb, Ks + (32 * j4 + lane) * LDK + kk * 8);
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const uint32_t b0 = kb[u] << 16, b1 = kb[u] & 0xFFFF0000u;
                mma_tf32(kk & 1 ? s1[4 * j4 + u] : s0[4 * j4 + u], ah, b0, b1);
                mma_tf32(sl[4 * j4 + u], al, b0, b1);
              }
            }
          }
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = k0 + 8 * j + 2 * t + (e & 1);
              const float x = __fmul_rn((s0[j][e] + s1[j][e]) + sl[j][e], p.scale);
              pr[j][e] = mask && key >= lim[e >> 1] ? 0.f
                                                    : expf(__fsub_rn(x, lse_r[e >> 1]));
            }
          }
        }
        // dS = p * (dO . v - delta) * scale, dP in three chains as S (bf16:
        // bf16(dO) . v, one chain)
        uint32_t dah[NT][4], dal[NT][4];
        {
          float d0[NT][4], d1[NT][4], dl[NT][4];
          if constexpr (BF16) {
            bf16_scores<D, NT, LDQ, LDK>(df, Vs, d0);
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) d1[j][e] = dl[j][e] = 0.f;
          } else {
#pragma unroll
            for (int j = 0; j < NT; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) d0[j][e] = d1[j][e] = dl[j][e] = 0.f;
#pragma unroll
            for (int kk = 0; kk < D / 8; ++kk) {
              const float2 x0 = *reinterpret_cast<const float2*>(df + kk * 8);
              const float2 x1 = *reinterpret_cast<const float2*>(df + 8 * LDQ + kk * 8);
              uint32_t ah[4], al[4];
              split_tf32(x0.x, ah[0], al[0]);
              split_tf32(x1.x, ah[1], al[1]);
              split_tf32(x0.y, ah[2], al[2]);
              split_tf32(x1.y, ah[3], al[3]);
#pragma unroll
              for (int j4 = 0; j4 < NT / 4; ++j4) {
                uint32_t vb[4];
                ldsm_x4(vb, Vs + (32 * j4 + lane) * LDK + kk * 8);
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                  const uint32_t b0 = vb[u] << 16, b1 = vb[u] & 0xFFFF0000u;
                  mma_tf32(kk & 1 ? d1[4 * j4 + u] : d0[4 * j4 + u], ah, b0, b1);
                  mma_tf32(dl[4 * j4 + u], al, b0, b1);
                }
              }
            }
          }
          // dS's A fragments, split once: the fragment of key block j is the A
          // fragment of k-step j of dS K (k t <-> key 2t, k t + 4 <-> key 2t + 1)
#pragma unroll
          for (int j = 0; j < NT; ++j) {
            float ds[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const float dp = (d0[j][e] + d1[j][e]) + dl[j][e];
              ds[e] = pr[j][e] * (dp - dl_r[e >> 1]) * p.scale;
            }
            split_tf32(ds[0], dah[j][0], dal[j][0]);
            split_tf32(ds[2], dah[j][1], dal[j][1]);
            split_tf32(ds[1], dah[j][2], dal[j][2]);
            split_tf32(ds[3], dah[j][3], dal[j][3]);
          }
        }
        // dQ += dS K, NB 8-column blocks side by side: the tile's products
        // in fresh hi and lo accumulators, joined in one f32 add; K's B pairs
        // from ldmatrix.trans
#pragma unroll
        for (int n0 = 0; n0 < NO; n0 += NB) {
          float hh[NB][4], ll[NB][4];
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 4; ++e) hh[nb][e] = ll[nb][e] = 0.f;
#pragma unroll
          for (int j4 = 0; j4 < NT / 4; ++j4) {
            uint32_t kb[NB][4];    // key blocks 4 j4 .. 4 j4 + 3: keys 2t, 2t + 1 at column g
#pragma unroll
            for (int nb = 0; nb < NB; ++nb)
              ldsm_x4_trans(kb[nb], Ks + (32 * j4 + lane) * LDK + 8 * (n0 + nb));
#pragma unroll
            for (int u = 0; u < 4; ++u)
#pragma unroll
              for (int nb = 0; nb < NB; ++nb) {
                const uint32_t b0 = kb[nb][u] << 16, b1 = kb[nb][u] & 0xFFFF0000u;
                mma_tf32(hh[nb], dah[4 * j4 + u], b0, b1);
                mma_tf32(ll[nb], dal[4 * j4 + u], b0, b1);
              }
          }
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float2* o = reinterpret_cast<float2*>(dq_row[e] + 8 * (n0 + nb));
              float2 x = *o;
              x.x += hh[nb][2 * e] + ll[nb][2 * e];
              x.y += hh[nb][2 * e + 1] + ll[nb][2 * e + 1];
              *o = x;
            }
        }
      }
      __syncthreads();
    }
  }

  // the rows' dQ, or this split's partial of it
  const size_t total_rows = (size_t)gridDim.x / p.Hkv * p.Hq * p.Tq;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (!valid[e]) continue;
    float* out = p.n_split == 1 ? p.dq + qrow[e] * D
                                : p.part + ((size_t)split * total_rows + qrow[e]) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      *reinterpret_cast<float2*>(out + 8 * n + 2 * t) =
          *reinterpret_cast<const float2*>(dq_row[e] + 8 * n);
  }
}

// ---- K10dkv -----------------------------------------------------------------

// Copy query rows [i0, i0 + DKV_BQ) of q, dO (f32 [Tq, D] at qg / dg), lse
// and delta (f32 [Tq] at lg / deg) into stage buffers; rows past Tq are 0.
template <int D>
__device__ __forceinline__ void stage_q(const float* qg, const float* dg, const float* lg,
                                        const float* deg, int i0, int Tq, float* qd, float* dd,
                                        float* ld) {
  constexpr int LDQ = DkvShape<D>::LDQ, CH = D / 4;   // 16-byte chunks of an f32 row
  for (int e = threadIdx.x; e < DKV_BQ * CH; e += BW_THREADS) {
    const int r = e / CH, c = e % CH;
    const bool live = i0 + r < Tq;
    const size_t off = (size_t)(live ? i0 + r : 0) * D + c * 4;
    cp_async16(qd + r * LDQ + c * 4, qg + off, live);
    cp_async16(dd + r * LDQ + c * 4, dg + off, live);
  }
  if (threadIdx.x < 2 * DKV_BQ) {
    const int r = threadIdx.x % DKV_BQ;
    const bool live = i0 + r < Tq;
    const int off = live ? i0 + r : 0;
    cp_async4(ld + threadIdx.x, (threadIdx.x < DKV_BQ ? lg : deg) + off, live);
  }
  cp_async_commit();
}

// acc += a^T b over one query stage, for the warp's 16 keys: a (P^T or
// dS'^T) in its accumulator fragments [NQ][4] is the A operand (the A
// fragment of query block jq is its accumulator fragment, k t <-> query 2t,
// k t + 4 <-> query 2t + 1), split once; b (dO or q) the B operand, rows 2t
// and 2t + 1 at column g, its TF32 parts bh / bl ([DKV_BQ][LDQ]) as the
// stage's pre-split left them. Three MMAs per product: each hi hi MMA alone
// in a fresh accumulator added round-to-nearest into the stage's hi sum, the
// two small terms in one chain; NB 8-column blocks side by side (the loop
// over the groups is not unrolled: at D = 128 unrolled it takes 255
// registers); the stage's sums join the thread's slots of acc (rows g and
// g + 8) in one f32 add.
// EXACT_B: b has no low part (bf16(q) in the bf16 form), so the a_hi . b_lo
// product is not taken: two MMAs per product.
template <int D, bool EXACT_B>
__device__ __forceinline__ void dkv_accumulate(const float (&a)[DkvShape<D>::NQ][4],
                                               const float* bh, const float* bl,
                                               float* const (&acc)[2]) {
  using Sh = DkvShape<D>;
  constexpr int NQ = Sh::NQ, LDQ = Sh::LDQ, NB = Sh::NB;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[NQ][4], al[NQ][4];
#pragma unroll
  for (int jq = 0; jq < NQ; ++jq) {
    split_tf32(a[jq][0], ah[jq][0], al[jq][0]);
    split_tf32(a[jq][2], ah[jq][1], al[jq][1]);
    split_tf32(a[jq][1], ah[jq][2], al[jq][2]);
    split_tf32(a[jq][3], ah[jq][3], al[jq][3]);
  }
#pragma unroll 1
  for (int n0 = 0; n0 < D / 8; n0 += NB) {
    float hh[NB][4], sm[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) hh[nb][e] = sm[nb][e] = 0.f;
#pragma unroll
    for (int jq = 0; jq < NQ; ++jq) {
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int o = (8 * jq + 2 * t) * LDQ + 8 * (n0 + nb) + g;
        const uint32_t bh0 = __float_as_uint(bh[o]), bh1 = __float_as_uint(bh[o + LDQ]);
        float h1[4] = {0.f, 0.f, 0.f, 0.f};       // the hi products alone, joined round-to-nearest
        mma_tf32(h1, ah[jq], bh0, bh1);
#pragma unroll
        for (int e = 0; e < 4; ++e) hh[nb][e] += h1[e];
        if constexpr (!EXACT_B) {
          const uint32_t bl0 = __float_as_uint(bl[o]), bl1 = __float_as_uint(bl[o + LDQ]);
          mma_tf32(sm[nb], ah[jq], bl0, bl1);
        }
        mma_tf32(sm[nb], al[jq], bh0, bh1);
      }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float2* o = reinterpret_cast<float2*>(acc[e] + 8 * (n0 + nb));
        float2 x = *o;
        x.x += hh[nb][2 * e] + sm[nb][2 * e];
        x.y += hh[nb][2 * e + 1] + sm[nb][2 * e + 1];
        *o = x;
      }
  }
}

// dV's stage sum in the bf16 form: acc += bf16(p^T) bf16(dO) for the warp's
// 16 keys, p^T in its accumulator fragments [NQ][4] packed to bf16 A
// fragments (k-step js takes query blocks 2 js and 2 js + 1), bf16(dO) the B
// operand from the stage's [DKV_BQ][LDB] through ldmatrix.trans; each MMA
// alone in a fresh accumulator added round-to-nearest, NB 8-column blocks
// side by side (pairs), joined into acc's thread slots in one f32 add.
template <int D>
__device__ __forceinline__ void dkv_accumulate_bf16(const float (&a)[DkvShape<D>::NQ][4],
                                                    const __nv_bfloat16* b,
                                                    float* const (&acc)[2]) {
  using Sh = DkvShape<D>;
  constexpr int NQ = Sh::NQ, LDB = Sh::LDB, NB = Sh::NB;
  const int lane = threadIdx.x & 31;
  uint32_t pa[NQ / 2][4];
#pragma unroll
  for (int js = 0; js < NQ / 2; ++js)
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      pa[js][2 * hf] = pack_bf16x2(a[2 * js + hf][0], a[2 * js + hf][1]);
      pa[js][2 * hf + 1] = pack_bf16x2(a[2 * js + hf][2], a[2 * js + hf][3]);
    }
#pragma unroll 1
  for (int n0 = 0; n0 < D / 8; n0 += NB) {
    float hh[NB][4];
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) hh[nb][e] = 0.f;
#pragma unroll
    for (int js = 0; js < NQ / 2; ++js) {
#pragma unroll
      for (int nb = 0; nb < NB; nb += 2) {
        uint32_t vb[4];          // (queries 16 js + 2t.., col g), (+8 ..) of blocks n, n + 1
        ldsm_x4_trans(vb, b + (16 * js + 8 * ((lane >> 3) & 1) + (lane & 7)) * LDB +
                              8 * (n0 + nb + (lane >> 4)));
        float f0[4] = {0.f, 0.f, 0.f, 0.f}, f1[4] = {0.f, 0.f, 0.f, 0.f};
        mma_bf16(f0, pa[js], vb[0], vb[1]);
        mma_bf16(f1, pa[js], vb[2], vb[3]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hh[nb][e] += f0[e];
          hh[nb + 1][e] += f1[e];
        }
      }
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float2* o = reinterpret_cast<float2*>(acc[e] + 8 * (n0 + nb));
        float2 x = *o;
        x.x += hh[nb][2 * e];
        x.y += hh[nb][2 * e + 1];
        *o = x;
      }
  }
}

// BF16: the bf16 form (S^T from bf16(q), dV = bf16(p)^T bf16(dO) on bf16
// MMAs, dK against bf16(q), which is exact in TF32: two products, not three)
template <int D, bool BF16>
__global__ void __launch_bounds__(BW_THREADS, 1) flash_dkv_kernel(const BwParams p) {
  using Sh = DkvShape<D>;
  constexpr int NQ = Sh::NQ, NO = Sh::NO, LDQ = Sh::LDQ, LDB = Sh::LDB, LDK = Sh::LDK;
  constexpr int LDA = Sh::LDA;
  extern __shared__ __align__(16) unsigned char dkv_smem[];
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(dkv_smem);
  __nv_bfloat16* v_s = k_s + DKV_BK * LDK;
  float* q_ring = reinterpret_cast<float*>(v_s + DKV_BK * LDK);   // [2][BQ][LDQ]
  float* do_ring = q_ring + 2 * DKV_BQ * LDQ;                       // [2][BQ][LDQ]
  float* ld_ring = do_ring + 2 * DKV_BQ * LDQ;                      // [2][lse BQ, delta BQ]
  float* dk_s = ld_ring + 2 * 2 * DKV_BQ;                          // [BK][LDA]
  float* dv_s = dk_s + DKV_BK * LDA;
  float* q_lo = dv_s + DKV_BK * LDA;                               // [BQ][LDQ]
  float* do_lo = q_lo + DKV_BQ * LDQ;                              // [BQ][LDQ]
  __nv_bfloat16* do_b = reinterpret_cast<__nv_bfloat16*>(do_lo + DKV_BQ * LDQ);  // [BQ][LDB]
  // the bf16 form's bf16(q) [BQ][LDB], in the room of the lo parts it does not use
  __nv_bfloat16* q_b = reinterpret_cast<__nv_bfloat16*>(q_lo);

  const int bh = blockIdx.x, b = bh / p.Hq, h = bh % p.Hq;
  const int hk = h / (p.Hq / p.Hkv);
  const int j0 = blockIdx.y * DKV_BK;               // the lowest keys (the longest) first
  const int split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int kv_end = min(p.kv_len, p.S);
  const int kw0 = j0 + warp * 16;                   // the warp's keys kw0 .. kw0 + 15

  // query tiles [qt0, qt1) of this split: from the first whose causal window
  // reaches key j0 (FlashDkvPlan.split_queries in ops/flash_vjp.py)
  const int n_qt_all = (p.Tq + DKV_BQ - 1) / DKV_BQ;
  const int qt_first = max(0, j0 - p.q_offset) / DKV_BQ;
  const int n_qt = j0 < kv_end ? max(0, n_qt_all - qt_first) : 0;
  const int qt0 = qt_first + (int)((long long)split * n_qt / p.n_split);
  const int qt1 = qt_first + (int)((long long)(split + 1) * n_qt / p.n_split);

  // dK and dV in shared memory: this thread's slots (keys g and g + 8 of the
  // warp, columns 8n + 2t and 2t + 1), read and written by this thread only
  float* const dk_row[2] = {dk_s + (warp * 16 + g) * LDA + 2 * t,
                            dk_s + (warp * 16 + g + 8) * LDA + 2 * t};
  float* const dv_row[2] = {dv_s + (warp * 16 + g) * LDA + 2 * t,
                            dv_s + (warp * 16 + g + 8) * LDA + 2 * t};
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      *reinterpret_cast<float2*>(dk_row[e] + 8 * n) = make_float2(0.f, 0.f);
      *reinterpret_cast<float2*>(dv_row[e] + 8 * n) = make_float2(0.f, 0.f);
    }

  if (qt0 < qt1) {
    const size_t pos0 = ((size_t)b * p.Hkv + hk) * p.S;
    stage_kv<D, LDK>(p.k + pos0 * D, p.v + pos0 * D, j0, min(DKV_BK, kv_end - j0), DKV_BK, k_s,
                     v_s);
    cp_async_commit();
    const size_t qb = (size_t)bh * p.Tq;
    const float* qg = p.q + qb * D;
    const float* dg = p.dO + qb * D;
    const float* lg = p.lse + qb;
    const float* deg = p.delta + qb;
    stage_q<D>(qg, dg, lg, deg, qt0 * DKV_BQ, p.Tq, q_ring, do_ring, ld_ring);

    const __nv_bfloat16* kr = k_s + (warp * 16 + g) * LDK + t;   // A: keys g, g + 8
    for (int qt = qt0; qt < qt1; ++qt) {
      const int st = (qt - qt0) & 1;
      if (qt + 1 < qt1) {
        stage_q<D>(qg, dg, lg, deg, (qt + 1) * DKV_BQ, p.Tq, q_ring + (st ^ 1) * DKV_BQ * LDQ,
                   do_ring + (st ^ 1) * DKV_BQ * LDQ, ld_ring + (st ^ 1) * 2 * DKV_BQ);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      float* qs = q_ring + st * DKV_BQ * LDQ;
      float* ds_ = do_ring + st * DKV_BQ * LDQ;
      const float* ls = ld_ring + st * 2 * DKV_BQ;
      const float* dls = ls + DKV_BQ;
      // each value of the stage split once for all four warps: the hi parts
      // in place, the lo parts and bf16(dO) beside them
      for (int e = tid; e < DKV_BQ * D / 4; e += BW_THREADS) {
        const int r = e / (D / 4), c = 4 * (e % (D / 4));
        float4* qp = reinterpret_cast<float4*>(qs + r * LDQ + c);
        float4* dp = reinterpret_cast<float4*>(ds_ + r * LDQ + c);
        const float4 x = *qp, y = *dp;
        if constexpr (BF16) {      // bf16(q) packed and in place (as f32), bf16(dO) packed
          const uint32_t q0 = pack_bf16x2(x.x, x.y), q1 = pack_bf16x2(x.z, x.w);
          *reinterpret_cast<uint2*>(q_b + r * LDB + c) = make_uint2(q0, q1);
          *reinterpret_cast<uint2*>(do_b + r * LDB + c) =
              make_uint2(pack_bf16x2(y.x, y.y), pack_bf16x2(y.z, y.w));
          *qp = make_float4(bf16_lo(q0), bf16_hi(q0), bf16_lo(q1), bf16_hi(q1));
          continue;
        }
        uint32_t qh[4], ql[4], dh[4], dl[4];
        split_tf32(x.x, qh[0], ql[0]);
        split_tf32(x.y, qh[1], ql[1]);
        split_tf32(x.z, qh[2], ql[2]);
        split_tf32(x.w, qh[3], ql[3]);
        split_tf32(y.x, dh[0], dl[0]);
        split_tf32(y.y, dh[1], dl[1]);
        split_tf32(y.z, dh[2], dl[2]);
        split_tf32(y.w, dh[3], dl[3]);
        *reinterpret_cast<uint2*>(do_b + r * LDB + c) =
            make_uint2(pack_bf16x2(y.x, y.y), pack_bf16x2(y.z, y.w));
        *qp = make_float4(__uint_as_float(qh[0]), __uint_as_float(qh[1]),
                          __uint_as_float(qh[2]), __uint_as_float(qh[3]));
        *dp = make_float4(__uint_as_float(dh[0]), __uint_as_float(dh[1]),
                          __uint_as_float(dh[2]), __uint_as_float(dh[3]));
        *reinterpret_cast<float4*>(q_lo + r * LDQ + c) =
            make_float4(__uint_as_float(ql[0]), __uint_as_float(ql[1]),
                        __uint_as_float(ql[2]), __uint_as_float(ql[3]));
        *reinterpret_cast<float4*>(do_lo + r * LDQ + c) =
            make_float4(__uint_as_float(dl[0]), __uint_as_float(dl[1]),
                        __uint_as_float(dl[2]), __uint_as_float(dl[3]));
      }
      __syncthreads();
      const int i0 = qt * DKV_BQ;
      const int i_last = min(p.Tq, i0 + DKV_BQ) - 1;
      if (kw0 < kv_end && kw0 <= p.q_offset + i_last) {
        // some (key, query) pair of the warp's 16 keys and this tile is dead
        const bool mask = !(kw0 + 15 < kv_end && kw0 + 15 <= p.q_offset + i0 &&
                            i0 + DKV_BQ <= p.Tq);
        // P^T = exp(S^T * scale - lse), S^T = K q^T: K the exact A operand
        // (d in order: k t <-> d t), q's TF32 parts the B operand; three
        // chains (hi products of even and of odd k-steps, lo products)
        float pr[NQ][4];
        {
          float s0[NQ][4], s1[NQ][4], sl[NQ][4];
#pragma unroll
          for (int j = 0; j < NQ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) s0[j][e] = s1[j][e] = sl[j][e] = 0.f;
          if constexpr (BF16) {
            // S^T = K bf16(q)^T: K's A fragments by ldmatrix, bf16(q) pairs as
            // B; one MMA per 16 d, one chain
#pragma unroll
            for (int ks = 0; ks < D / 16; ++ks) {
              uint32_t ka[4];
              ldsm_x4(ka, k_s + (warp * 16 + (lane & 15)) * LDK + 16 * ks + 8 * (lane >> 4));
#pragma unroll
              for (int jq = 0; jq < NQ; ++jq) {
                const __nv_bfloat16* br = q_b + (8 * jq + g) * LDB + 16 * ks + 2 * t;
                mma_bf16(s0[jq], ka, *reinterpret_cast<const uint32_t*>(br),
                         *reinterpret_cast<const uint32_t*>(br + 8));
              }
            }
          } else {
#pragma unroll
            for (int kk = 0; kk < D / 8; ++kk) {
              const uint16_t* k16 = reinterpret_cast<const uint16_t*>(kr + kk * 8);
              // A: (key g, d t), (g + 8, t), (g, t + 4), (g + 8, t + 4), bf16 -> f32 bits
              const uint32_t a[4] = {(uint32_t)k16[0] << 16, (uint32_t)k16[8 * LDK] << 16,
                                     (uint32_t)k16[4] << 16, (uint32_t)k16[8 * LDK + 4] << 16};
#pragma unroll
              for (int jq = 0; jq < NQ; ++jq) {
                const int o = (8 * jq + g) * LDQ + kk * 8 + t;       // B: (d t, query g)
                const uint32_t bh0 = __float_as_uint(qs[o]), bh1 = __float_as_uint(qs[o + 4]);
                const uint32_t bl0 = __float_as_uint(q_lo[o]), bl1 = __float_as_uint(q_lo[o + 4]);
                mma_tf32(kk & 1 ? s1[jq] : s0[jq], a, bh0, bh1);
                mma_tf32(sl[jq], a, bl0, bl1);
              }
            }
          }
#pragma unroll
          for (int jq = 0; jq < NQ; ++jq) {
            const float2 lq = *reinterpret_cast<const float2*>(ls + 8 * jq + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int key = kw0 + g + 8 * (e >> 1), iq = i0 + 8 * jq + 2 * t + (e & 1);
              const float x = __fmul_rn((s0[jq][e] + s1[jq][e]) + sl[jq][e], p.scale);
              const bool dead = mask && (key >= kv_end || key > p.q_offset + iq || iq >= p.Tq);
              pr[jq][e] = dead ? 0.f : expf(__fsub_rn(x, e & 1 ? lq.y : lq.x));
            }
          }
        }
        // dP'^T = V bf16(dO)^T: exact operands, one bf16 m16n8k16 MMA per
        // 16 d; A = V's keys through ldmatrix, B = the stage's bf16(dO)
        float dsv[NQ][4];
        {
          float dp[NQ][4];
#pragma unroll
          for (int j = 0; j < NQ; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
          for (int ks = 0; ks < D / 16; ++ks) {
            uint32_t va[4];        // (key g, d 2t..), (g + 8, 2t..), (g, 2t + 8..), (g + 8, 2t + 8..)
            ldsm_x4(va, v_s + (warp * 16 + (lane & 15)) * LDK + 16 * ks + 8 * (lane >> 4));
#pragma unroll
            for (int jq = 0; jq < NQ; ++jq) {
              const __nv_bfloat16* br = do_b + (8 * jq + g) * LDB + 16 * ks + 2 * t;
              float f[4] = {0.f, 0.f, 0.f, 0.f};      // each MMA alone, joined round-to-nearest
              mma_bf16(f, va, *reinterpret_cast<const uint32_t*>(br),
                       *reinterpret_cast<const uint32_t*>(br + 8));
#pragma unroll
              for (int e = 0; e < 4; ++e) dp[jq][e] += f[e];
            }
          }
#pragma unroll
          for (int jq = 0; jq < NQ; ++jq) {
            const float2 dq2 = *reinterpret_cast<const float2*>(dls + 8 * jq + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dsv[jq][e] = pr[jq][e] * (dp[jq][e] - (e & 1 ? dq2.y : dq2.x)) * p.scale;
          }
        }
        // dV += P^T dO, then dK += dS'^T q
        if constexpr (BF16) {
          dkv_accumulate_bf16<D>(pr, do_b, dv_row);
          dkv_accumulate<D, true>(dsv, qs, nullptr, dk_row);
        } else {
          dkv_accumulate<D, false>(pr, ds_, do_lo, dv_row);
          dkv_accumulate<D, false>(dsv, qs, q_lo, dk_row);
        }
      }
      __syncthreads();
    }
  }

  // the keys' dK and dV per query head (bf16), or this split's f32 partials
  const size_t total = (size_t)gridDim.x * p.S * D;      // elements of dk (and of dv)
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = kw0 + g + 8 * e;
    if (key >= p.S) continue;
    const size_t o = ((size_t)bh * p.S + key) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const float2 xk = *reinterpret_cast<const float2*>(dk_row[e] + 8 * n);
      const float2 xv = *reinterpret_cast<const float2*>(dv_row[e] + 8 * n);
      if (p.n_split == 1) {
        *reinterpret_cast<uint32_t*>(p.dk + o + 8 * n) = pack_bf16x2(xk.x, xk.y);
        *reinterpret_cast<uint32_t*>(p.dv + o + 8 * n) = pack_bf16x2(xv.x, xv.y);
      } else {
        float* pk = p.part + (size_t)split * 2 * total;
        *reinterpret_cast<float2*>(pk + o + 8 * n) = xk;
        *reinterpret_cast<float2*>(pk + total + o + 8 * n) = xv;
      }
    }
  }
}

// ---- launchers ----------------------------------------------------------------

int launch_delta(const float* dO, const float* O, float* delta, int rows, int D,
                 cudaStream_t st) {
  const int threads = 256, per = threads / 32;
  flash_delta_kernel<<<(rows + per - 1) / per, threads, 0, st>>>(dO, O, delta, rows, D);
  return (int)cudaGetLastError();
}

int launch_sum(const float* part, float* out, __nv_bfloat16* out_b, __nv_bfloat16* out_b2,
               size_t n, int n_split, size_t total, cudaStream_t st) {
  const int threads = 256;
  const size_t blocks = (total / 4 + threads - 1) / threads;
  flash_bwd_sum_kernel<<<(unsigned)blocks, threads, 0, st>>>(part, out, out_b, out_b2, n,
                                                            n_split, total);
  return (int)cudaGetLastError();
}

template <int D, bool BF16>
int launch_dq(const BwParams& p, int B, int bn, cudaStream_t st) {
  if (bn != DqShape<D>::BN) return ZGML_ERR_SHAPE;      // the host plan's tile must be ours
  constexpr size_t smem = dq_smem_bytes<D>();
  int rc = allow_dynamic_smem(flash_dq_kernel<D, BF16>, smem);
  if (rc != 0) return rc;
  const int n_m = ((p.Hq / p.Hkv) * p.Tq + DQ_BM - 1) / DQ_BM;
  const dim3 grid(B * p.Hkv, n_m, p.n_split);
  flash_dq_kernel<D, BF16><<<grid, BW_THREADS, smem, st>>>(p);
  rc = (int)cudaGetLastError();
  if (rc != 0 || p.n_split == 1) return rc;
  const size_t total = (size_t)B * p.Hq * p.Tq * D;
  return launch_sum(p.part, p.dq, nullptr, nullptr, total, p.n_split, total, st);
}

template <int D, bool BF16>
int launch_dkv(const BwParams& p, int B, cudaStream_t st) {
  constexpr size_t smem = dkv_smem_bytes<D>();
  int rc = allow_dynamic_smem(flash_dkv_kernel<D, BF16>, smem);
  if (rc != 0) return rc;
  const dim3 grid(B * p.Hq, (p.S + DKV_BK - 1) / DKV_BK, p.n_split);
  flash_dkv_kernel<D, BF16><<<grid, BW_THREADS, smem, st>>>(p);
  rc = (int)cudaGetLastError();
  if (rc != 0 || p.n_split == 1) return rc;
  const size_t n = (size_t)B * p.Hq * p.S * D;
  return launch_sum(p.part, nullptr, p.dk, p.dv, n, p.n_split, 2 * n, st);
}

template <class K>
int occupancy(K kernel, size_t smem, int* n) {
  const int rc = allow_dynamic_smem(kernel, smem);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, BW_THREADS, smem);
}

template <int D, bool BF16>
int blocks_per_sm(int which, int* n) {
  return which == 0 ? occupancy(flash_dq_kernel<D, BF16>, dq_smem_bytes<D>(), n)
                    : occupancy(flash_dkv_kernel<D, BF16>, dkv_smem_bytes<D>(), n);
}

// Run launcher L<D, bf16> for the head dim D; ZGML_ERR_HEAD_DIM otherwise.
#define ZGML_BWD_DISPATCH(D, bf16, CALL)                                           \
  switch (D) {                                                                     \
    case 16: return bf16 ? CALL(16, true) : CALL(16, false);                       \
    case 32: return bf16 ? CALL(32, true) : CALL(32, false);                       \
    case 64: return bf16 ? CALL(64, true) : CALL(64, false);                       \
    case 128: return bf16 ? CALL(128, true) : CALL(128, false);                    \
    default: return ZGML_ERR_HEAD_DIM;                                             \
  }

bool bad_shape(int B, int Hq, int Hkv, int Tq, int S, int q_offset, int n_split,
               const float* part) {
  return B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Tq <= 0 || S <= 0 || q_offset < 0 ||
         n_split < 1 || n_split > 65535 || (n_split > 1 && part == nullptr);
}

}  // namespace

// delta f32 [rows] = rowsum(dO * O) of f32 [rows, D] rows; contiguous,
// 16-byte aligned.
ZGML_EXPORT int zgml_flash_delta(const float* dO, const float* O, float* delta, int rows, int D,
                                 void* stream) {
  if (rows <= 0 || D <= 0 || D % 4 != 0) return ZGML_ERR_SHAPE;
  return launch_delta(dO, O, delta, rows, D, static_cast<cudaStream_t>(stream));
}

// *n = the blocks of K10dq (which 0) or K10dkv (which 1) at head_dim D (bf16:
// its bf16 form) one SM holds at once (the occupancy the host plan fills);
// returns a status.
ZGML_EXPORT int zgml_flash_bwd_blocks_per_sm(int D, int which, int bf16, int* n) {
#define ZGML_OCC(DD, B16) blocks_per_sm<DD, B16>(which, n)
  ZGML_BWD_DISPATCH(D, bf16 != 0, ZGML_OCC)
#undef ZGML_OCC
}

// q, dO f32 [B, Hq, Tq, D]; k, v bf16 [B, Hkv, S, D]; lse, delta f32
// [B, Hq, Tq] -> dq f32 [B, Hq, Tq, D]; all contiguous, 16-byte aligned.
// n_split and bn come from ops/flash_vjp.py (the split plan of
// ops/attention.py flash_split_plan; bn must be this build's tile for D);
// with n_split > 1, part is f32 scratch of n_split * B * Hq * Tq * D.
ZGML_EXPORT int zgml_flash_dq(const float* q, const void* k, const void* v, const float* dO,
                              const float* lse, const float* delta, float* dq, float* part, int B,
                              int Hq, int Hkv, int Tq, int S, int D, int kv_len, int q_offset,
                              int n_split, int bn, int bf16, float scale, void* stream) {
  if (bad_shape(B, Hq, Hkv, Tq, S, q_offset, n_split, part)) return ZGML_ERR_SHAPE;
  BwParams p{q, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), dO,
             lse, delta, dq, nullptr, nullptr, part, Hq, Hkv, Tq, S, max(0, min(kv_len, S)),
             q_offset, n_split, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZGML_DQ(DD, B16) launch_dq<DD, B16>(p, B, bn, st)
  ZGML_BWD_DISPATCH(D, bf16 != 0, ZGML_DQ)
#undef ZGML_DQ
}

// The same inputs -> dk, dv bf16 [B, Hq, S, D] per query head; contiguous.
// n_split from ops/flash_vjp.py flash_dkv_split_plan; with n_split > 1, part
// is f32 scratch of n_split * 2 * B * Hq * S * D.
ZGML_EXPORT int zgml_flash_dkv(const float* q, const void* k, const void* v, const float* dO,
                               const float* lse, const float* delta, void* dk, void* dv,
                               float* part, int B, int Hq, int Hkv, int Tq, int S, int D,
                               int kv_len, int q_offset, int n_split, int bf16, float scale,
                               void* stream) {
  if (bad_shape(B, Hq, Hkv, Tq, S, q_offset, n_split, part)) return ZGML_ERR_SHAPE;
  BwParams p{q, static_cast<const __nv_bfloat16*>(k), static_cast<const __nv_bfloat16*>(v), dO,
             lse, delta, nullptr, static_cast<__nv_bfloat16*>(dk),
             static_cast<__nv_bfloat16*>(dv), part, Hq, Hkv, Tq, S, max(0, min(kv_len, S)),
             q_offset, n_split, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ZGML_DKV(DD, B16) launch_dkv<DD, B16>(p, B, st)
  ZGML_BWD_DISPATCH(D, bf16 != 0, ZGML_DKV)
#undef ZGML_DKV
}
