// K3 flash_attention: causal GQA prefill attention over the bf16 KV cache,
// and over the f32 one in both forms (attention_f32kv, attention_bf16_f32kv);
// its int8-cache mode, K9 flash_attention_q8; and its LSE mode, K10f
// flash_fwd, the forward of training's flash attention and of a ring
// attention hop, whose f32 form also reads f32 K/V (flash_fwd_f32kv). Two
// kernel templates, flash_attn_kernel<D, KV8, F32KV> and
// flash_bf16_kernel<D, KV8, F32KV>, serve all of them.
//
// Replaces: zgml_tpu/ops/attention.py `_flash_kernel` (line 44, its grid at
// 120-200, pallas_call at 194), reached through `_flash` /
// `flash_attention_pallas` via flash_vjp.make_flash_vjp (K3), and
// `_flash_q8_kernel` (line 599, pallas_call at 702), reached through
// `_flash_q8` / `flash_attention_q8_pallas` (K9); and
// zgml_tpu/ops/flash_vjp.py `_fwd_kernel` (line 41, pallas_call at 140,
// K10f), which `make_flash_vjp` runs under jax.grad.
//
// Semantics (the plain versions are ops/attention.py flash_attention_ref and
// flash_attention_q8_ref, and ops/flash_vjp.py flash_fwd_lse_ref):
//   q f32 [B, Hq, Tq, D]; k, v bf16 [R, Hkv, S, D] (K3, K10f), or int8 levels
//   [R, Hkv, S, D] with f32 scales ks, vs [R, Hkv, S] (K9): the cache slab
//   read in place at batch rows kv_row + b (the stacked [L, B, Hkv, S, D]
//   cache viewed as [L*B, ...], kv_row = layer * B). Query row i sits at
//   absolute position q_offset + i and attends keys j < kv_len with
//   j <= q_offset + i; query head h reads KV head h / (Hq / Hkv). Scores are
//   (q . k) * scale, or for K9 (q . k_levels) * (k_scale * scale)
//   (attention.py:629-631), and K9 folds v_scale into p before P.V (642).
//   Output o f32 [B, Hq, Tq, D]; a row with no live key gives 0. K10f also
//   writes lse f32 [B, Hq, Tq] = m + log(l), +inf for a row with no live key
//   (flash_vjp.py:89-92); it is the same launch with a non-null lse, so its O
//   is K3's bit for bit (the JAX 128-lane LSE sidecar is TPU layout).
//
// What bounds it on the H100: at a prefill chunk (Tq = 128) the work is
// 4 * Hq * live_pairs * D f32 operations (q.k and p.v), 2-46 us at the f32
// rate and a quarter of that on TF32 tensor cores, while the bytes (q, o
// and the live K/V once) take 1-5 us. The chunk gives few tiles: 64 at the
// TinyLlama-1.1B and the Llama-2-7B chunk, for 132 SMs. So occupancy and
// latency decide first, then the tensor-core rate.
//
// What the design does about it:
//  * A block is 4 warps over a tile of 64 packed query rows x one KV head;
//    each warp owns 16 rows (one m16 fragment). The n_rep query heads that
//    share the KV head are packed into the rows, position-major: packed row
//    r is position r / n_rep of head hk * n_rep + r % n_rep (as the JAX
//    kernel folds them into one batched dot, attention.py:48-55). So one
//    staged K/V tile serves n_rep heads, and a tile spans few positions,
//    which keeps its causal edge narrow.
//  * The live prefix is split across blocks (grid z) when the tiles alone do
//    not fill the card: ops/attention.py flash_split_plan picks n_split from
//    the shapes, the live prefix and the SM count, and block z takes key
//    tiles [z * n / n_split, (z + 1) * n / n_split) of its tile's n. With
//    n_split > 1 each block writes its unnormalised o, m and l to scratch and
//    flash_combine_kernel merges them (skipping splits with l = 0, so a split
//    with no live key for a row merges without NaN) and writes o and lse;
//    with n_split == 1 the block writes o and lse itself. The plan depends
//    only on shapes and the SM count, so K3 and K10f take the same one.
//  * K/V tiles of BN keys (64; 32 at D = 128, for two blocks per SM) are
//    staged in their storage type with 16-byte cp.async, double-buffered so
//    the next tile's copy overlaps this tile's MMAs; keys past the tile's end
//    are zero-filled, so P.V never meets a stale value. K9's int8 levels and
//    scales land in a raw buffer and are widened to bf16 (exact: |level| <=
//    127) in one pass. Rows are padded by 8 elements (16 bytes), so the
//    ldmatrix row addresses of a warp fall in distinct banks.
//  * Dots on tensor cores: mma.sync m16n8k8 TF32 with f32 accumulators (the
//    legacy mma.sync, not wgmma: a 16-row warp fragment keeps the per-row
//    softmax in one warp's registers and the 64-row tile small; at these
//    work sizes the issue rate of mma.sync is not what bounds). K and V go
//    to the B fragments through ldmatrix (.trans for V) straight from bf16,
//    which is exact in TF32 (8-bit significand; TF32 keeps 11), as are int8
//    levels (7 bits). Only q and p need splitting: x = hi + lo with hi =
//    tf32_rna(x), lo = tf32_rna(x - hi), and every product runs twice,
//    hi . K + lo . K; K and V have no low part, so there is no third term.
//    x - hi - lo is <= 2^-22 |x| (x - hi is exact in f32 and lo rounds it to
//    11 bits), so each operand carries a relative error of the class of f32
//    rounding itself; what is left is the order of the f32 accumulation
//    (tests/test_torch_flash_split.py bounds the operand rounding against
//    float64). This is the 3xTF32 idea with the third term exactly zero.
//    Dimension d and key order inside an 8-wide MMA step are permuted
//    consistently on both operands (thread t holds d 2t and 2t + 1 of q, the
//    pair ldmatrix gives it of K; and the keys 2t, 2t + 1 of p that the S
//    accumulator gives it, the pair ldmatrix.trans gives it of V), so S
//    feeds P.V from registers with no shuffle.
//  * Accumulation. The tensor cores add an MMA's products into its f32
//    accumulator and round toward zero, so a long chain of MMAs into one
//    accumulator drifts toward zero: in a CPU emulation at the TinyLlama
//    training shape (T 512, D 64), one chain for S and one for O over the
//    whole prefix gave 4x the rms error of an f32 FMA loop, with a bias,
//    and moved training's gradients past their end-to-end bound on the
//    card. So S is summed in three chains (hi products of even and of odd
//    k-steps, lo products) added in f32, and each tile's P V builds, one
//    8-column block at a time, in fresh hi and lo accumulators that join O
//    in one IEEE fma (O * alpha + PV): no chain is longer than D/16 or BN/8
//    MMAs, and the emulation puts the result below the f32 loop's error (rms
//    0.65-0.73x of it at D 64 and 128; tests/test_torch_flash_split.py
//    emulates both). O in place instead costs 3x (T 512) to 6.5x (T 1536)
//    the f32 loop's error at D 128.
//  * O lives in shared memory, not registers: each thread owns its
//    fragment's slots (two rows, columns 8n + 2t and 2t + 1) and alone reads
//    and writes them, so they need no barrier. With O's 64 floats a thread
//    at D = 128 in registers, the fresh accumulators overran 255 registers
//    and spilled (every grouping tried). q is staged once per block as f32
//    beside O and split into its TF32 parts where a fragment is loaded;
//    registers hold the tile's scores and P's split fragments.
//  * The online softmax runs in f32 on the accumulator fragments: row max by
//    quad shuffles, expf (no fast math in this build), one rescale per tile;
//    each thread keeps its share of l and the quad sums it once at the end.
//    Only tiles that cross a row's causal limit or kv_len are masked, and a
//    warp skips a tile that none of its rows reaches.
//
// The f32-K/V form, flash_attn_kernel<D, false, true> (zgml_flash_attention_f32;
// K3 over the f32 KV cache under ZGML_TPU_PREFILL_BF16=0, and the JAX ring's
// hop there, parallel/ring.py, which attends over the f32 K/V of the cp
// body; JAX's kernel casts K and V to f32, attention.py:81-84): K and V staged in f32 (16-byte
// cp.async, rows padded by 8 floats for K's float2 reads and by 4 for V's
// column reads, so neither meets a bank conflict), their B operands split
// into TF32 parts as q's and p's are, and every dot the three products
// hi . hi + lo . hi + hi . lo (3xTF32: lo . lo, below 2^-22 of the product,
// is dropped). The lo products join the "lo" chains, so S keeps its three
// chains and each P V block its fresh hi and lo accumulators.
//  * What bounds it: the same bytes with K/V at 4 bytes, and three TF32
//    products a dot (the bf16-K/V form takes two).
//
// The bf16 form, flash_bf16_kernel<D, KV8> (bf16 != 0; ZGML_TPU_PREFILL_BF16,
// on by default): the JAX kernels' function at bf16=True (attention.py:77-104,
// 625-644; flash_vjp.py:60-84). Scores bf16(q) . K (K9: . levels) with f32
// sums, times scale (K9: k_scale * scale, rounded as flash_bwd.cu recomputes
// them); an f32 online softmax whose running max steps once per JAX key tile
// of `group` keys (flash_group: 128, or K9's 256, counted from key 0); p (K9:
// p * v_scale) rounded to bf16 against bf16 V (K9: levels); l sums the
// unrounded p.
//  * What bounds it: 4 * Hq * live_pairs * D operations on bf16 tensor cores
//    at 989 TFLOP/s, one product per dot (the f32 form takes two TF32 ones
//    at half that rate), and the same bytes.
//  * Dots on mma.sync m16n8k16 bf16: q's A fragments rounded once per block
//    and held in registers; K's B fragments by ldmatrix; each S accumulator
//    chain is D / 16 MMAs long. P's A fragments are packed to bf16 straight
//    from the S accumulators (key blocks 2j and 2j + 1 make k-step j), V's B
//    fragments by ldmatrix.trans; each sub-tile's P V builds in fresh
//    accumulators and joins O (shared memory, as the f32 form's) in one fma.
//  * The running max steps per group, not per staged sub-tile (BN keys: 128
//    at D <= 64, 64 at D 128): p's bf16 rounding depends on the max it is
//    taken against. A group of one sub-tile takes its max from its own S; a
//    longer one (K3 at D 128, K9's 256-key groups) first runs a max pass
//    over its sub-tiles' K alone, then the main pass recomputes the same S
//    (the same MMAs, the same bits) against the group's max. The walk over a
//    split is a sequence of items (group, sub-tile, pass), double-buffered
//    by cp.async as the f32 form's tiles.
//  * Over f32 K/V (flash_bf16_kernel<D, false, true>: the f32 cache under
//    ZGML_TPU_PREFILL_BF16=1, where JAX casts K and V to bf16) the function
//    is this form's over bf16(K), bf16(V). cp.async cannot convert, so an
//    item's f32 rows land by cp.async in a raw buffer (two stages, [2][BN][D]
//    f32 each) and are rounded to nearest even into one bf16 sub-tile in one
//    pass (cvt.rn.bf16x2), as K9 widens its levels; the rest is the bf16
//    cache's code, so the output is bit-equal to this form on the rounded
//    K/V. At D 128 that is 200,704 bytes of shared memory, one block an SM
//    (the bf16 cache's form takes 104,448, two). The launch takes the bf16
//    cache's plan (ops/attention.flash_plan), since a split moves where p
//    rounds: so the f32 cache's output is the bf16 cache's on the rounded
//    K/V bit for bit, at the cost of a second wave where that plan counted
//    on more blocks an SM than fit.
//  * A split of the prefix (flash_split_plan, at `group` keys a tile) starts
//    its running max at its first key: where the plan splits, p rounds
//    against another max than JAX's for keys whose group lies past a larger
//    score of an earlier split. ops/attention.flash_partials_ref(bf16=True)
//    is this function for a given plan; unsplit it is JAX's.
#include "common.cuh"
#include "tf32_mma.cuh"

#include <climits>

namespace {

constexpr int FA_BM = 64;            // packed query rows of a tile: 4 warps x 16
constexpr int FA_THREADS = 128;
constexpr unsigned FA_FULL = 0xFFFFFFFFu;

template <int D>
struct FaShape {
  static constexpr int BN = D == 128 ? 32 : 64;   // keys per K/V stage
  static constexpr int NT = BN / 8;               // 8-key blocks of a stage
  static constexpr int LDQ = D + 8;               // floats per q / O row in smem
  static constexpr int LDK = D + 8;               // bf16 per staged K / V row
  static constexpr int LDKF = D + 8;              // the f32-K/V form: floats per K row
  static constexpr int LDVF = D + 4;              // and per V row
  static_assert(NT % 4 == 0 && D % 16 == 0, "tile shape");
};

// Dynamic shared memory: q and O [FA_BM][LDQ] f32; the bf16 K and V stages
// [BN][LDK] (two stages; K9 widens into one); K9 only: the raw int8 K and V
// stages [BN][D] and their scales [BN], two stages each; the f32-K/V form:
// the f32 K [BN][LDKF] and V [BN][LDVF] stages in the bf16 stages' place.
template <int D, bool KV8, bool F32KV = false>
constexpr size_t fa_smem_bytes() {
  using Sh = FaShape<D>;
  if constexpr (F32KV)
    return 2ull * FA_BM * Sh::LDQ * sizeof(float) +
           2ull * Sh::BN * (Sh::LDKF + Sh::LDVF) * sizeof(float);
  return 2ull * FA_BM * Sh::LDQ * sizeof(float) + (KV8 ? 1ull : 2ull) * 2 * Sh::BN * Sh::LDK * 2 +
         (KV8 ? 2ull * 2 * Sh::BN * D + 2ull * 2 * Sh::BN * sizeof(float) : 0ull);
}

struct FaParams {
  const float* q;
  const void* k;
  const float* ks;
  const void* v;
  const float* vs;
  float* o;
  float* lse;
  float* part;        // n_split > 1: [n_split][rows][D] o, then [n_split][rows][2] (m, l)
  int Hq, Hkv, Tq, S, kv_len, q_offset, kv_row, n_split;
  int n_rows;         // packed rows per (b, KV head): n_rep * Tq
  int total_rows;     // B * Hq * Tq
  float scale;
  int group;          // the bf16 form's keys a running-max step (JAX's key tile)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared, or 16 zero bytes where !live (src is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(live ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(live ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8
// (.trans: each lane gets its pair from a column)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// x rounded to TF32 (10 stored mantissa bits, nearest, ties away), as f32 bits
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r & 0xFFFFE000u;
}

// x = hi + lo, both TF32; x - hi is exact in f32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// c += a . b on a 16x8x8 TF32 tile, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
      "{%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// int8 level i of a word as bf16 bits (exact)
__device__ __forceinline__ uint32_t level_bf16(uint32_t w, int i) {
  return __float_as_uint((float)(int8_t)(w >> (8 * i))) >> 16;
}

// The key end of packed row tile m: one past the last key any of its rows sees.
__device__ __forceinline__ int tile_key_end(int n_rows, int kv_len, int q_offset, int m,
                                            int n_rep) {
  const int last = min(n_rows, (m + 1) * FA_BM) - 1;
  return max(0, min(kv_len, q_offset + last / n_rep + 1));
}

// Issue the copies of the nk live keys of a key tile (rows j0.. of the head
// at kg / vg, scales at ksg / vsg for K9) into stage st; rows past nk are
// zero-filled. One commit group.
template <int D, bool KV8, class T>
__device__ __forceinline__ void stage_tile(const T* kg, const T* vg, const float* ksg,
                                           const float* vsg, int j0, int nk, int st,
                                           __nv_bfloat16* kv_s, int8_t* raw, float* scl) {
  using Sh = FaShape<D>;
  constexpr int BN = Sh::BN, LDK = Sh::LDK;
  const int tid = threadIdx.x;
  if constexpr (KV8) {
    constexpr int CH = D / 16;                     // 16-byte chunks of a row of levels
    int8_t* kd = raw + st * 2 * BN * D;
    int8_t* vd = kd + BN * D;
#pragma unroll
    for (int e = tid; e < BN * CH; e += FA_THREADS) {
      const int r = e / CH, c = e % CH;
      const bool live = r < nk;
      const size_t off = (size_t)(j0 + (live ? r : 0)) * D + c * 16;
      cp_async16(kd + r * D + c * 16, kg + off, live);
      cp_async16(vd + r * D + c * 16, vg + off, live);
    }
    if (tid < BN) {
      const bool live = tid < nk;
      const int off = j0 + (live ? tid : 0);
      cp_async4(scl + st * 2 * BN + tid, ksg + off, live);
      cp_async4(scl + st * 2 * BN + BN + tid, vsg + off, live);
    }
  } else {
    constexpr int CH = D / 8;                      // 16-byte chunks of a bf16 row
    __nv_bfloat16* kd = kv_s + st * 2 * BN * LDK;
    __nv_bfloat16* vd = kd + BN * LDK;
#pragma unroll
    for (int e = tid; e < BN * CH; e += FA_THREADS) {
      const int r = e / CH, c = e % CH;
      const bool live = r < nk;
      const size_t off = (size_t)(j0 + (live ? r : 0)) * D + c * 8;
      cp_async16(kd + r * LDK + c * 8, kg + off, live);
      cp_async16(vd + r * LDK + c * 8, vg + off, live);
    }
  }
  cp_async_commit();
}

// The f32-K/V form's stage st: the nk live f32 K and V rows of a key tile
// (rows j0..), zero-filled past nk. One commit group.
template <int D>
__device__ __forceinline__ void stage_tile_f32(const float* kg, const float* vg, int j0, int nk,
                                               int st, float* kvf_s) {
  using Sh = FaShape<D>;
  constexpr int BN = Sh::BN, CH = D / 4;           // 16-byte chunks of an f32 row
  float* kd = kvf_s + st * BN * (Sh::LDKF + Sh::LDVF);
  float* vd = kd + BN * Sh::LDKF;
#pragma unroll
  for (int e = threadIdx.x; e < BN * CH; e += FA_THREADS) {
    const int r = e / CH, c = e % CH;
    const bool live = r < nk;
    const size_t off = (size_t)(j0 + (live ? r : 0)) * D + c * 4;
    cp_async16(kd + r * Sh::LDKF + c * 4, kg + off, live);
    cp_async16(vd + r * Sh::LDVF + c * 4, vg + off, live);
  }
  cp_async_commit();
}

// The block's end: each thread held its share of l, summed over the quad
// (the same sum on all four); then o = O / l and the lse, or with a split
// prefix the unnormalised O and (m, l) into the partials.
template <int D>
__device__ __forceinline__ void fa_epilogue(const FaParams& p, float* const (&orow_s)[2],
                                            const size_t (&orow)[2], const bool (&valid)[2],
                                            const float (&mrow)[2], float (&lrow)[2], int split,
                                            int t) {
  constexpr int NO = D / 8;
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    lrow[e] += __shfl_xor_sync(FA_FULL, lrow[e], 1);
    lrow[e] += __shfl_xor_sync(FA_FULL, lrow[e], 2);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    if (!valid[e]) continue;
    const float l = lrow[e];
    if (p.n_split == 1) {
      float* op = p.o + orow[e] * D + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        const float2 x = *reinterpret_cast<const float2*>(orow_s[e] + 8 * n);
        *reinterpret_cast<float2*>(op + 8 * n) =
            l > 0.f ? make_float2(x.x / l, x.y / l) : make_float2(0.f, 0.f);
      }
      if (p.lse != nullptr && t == 0) p.lse[orow[e]] = l > 0.f ? mrow[e] + logf(l) : INFINITY;
    } else {
      const size_t slot = (size_t)split * p.total_rows + orow[e];
      float* op = p.part + slot * D + 2 * t;
#pragma unroll
      for (int n = 0; n < NO; ++n)
        *reinterpret_cast<float2*>(op + 8 * n) =
            *reinterpret_cast<const float2*>(orow_s[e] + 8 * n);
      if (t == 0)
        *reinterpret_cast<float2*>(p.part + (size_t)p.n_split * p.total_rows * D + 2 * slot) =
            make_float2(mrow[e], l);
    }
  }
}

// minBlocks 1: an explicit occupancy target, so ptxas does not trade
// spills for more blocks per SM on its own
template <int D, bool KV8, bool F32KV = false>
__global__ void __launch_bounds__(FA_THREADS, 1) flash_attn_kernel(const FaParams p) {
  static_assert(!(KV8 && F32KV), "one cache form");
  using Sh = FaShape<D>;
  constexpr int BN = Sh::BN, NT = Sh::NT, LDQ = Sh::LDQ, LDK = Sh::LDK;
  constexpr int LDKF = Sh::LDKF, LDVF = Sh::LDVF;
  constexpr int NO = D / 8;                         // 8-column blocks of the output
  using T = std::conditional_t<KV8, int8_t, std::conditional_t<F32KV, float, __nv_bfloat16>>;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* q_s = reinterpret_cast<float*>(fa_smem);
  float* o_s = q_s + FA_BM * LDQ;
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(o_s + FA_BM * LDQ);
  float* kvf_s = o_s + FA_BM * LDQ;                 // F32KV: the f32 K / V stages
  int8_t* raw = reinterpret_cast<int8_t*>(kv_s + (KV8 ? 1 : 2) * 2 * BN * LDK);
  float* scl = reinterpret_cast<float*>(raw + 2 * 2 * BN * D);

  const int n_rep = p.Hq / p.Hkv;
  const int n_m = (p.n_rows + FA_BM - 1) / FA_BM;
  const int m = n_m - 1 - (int)blockIdx.x;          // the longest tiles first
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;

  const int key_end = tile_key_end(p.n_rows, p.kv_len, p.q_offset, m, n_rep);
  const int n_kt = (key_end + BN - 1) / BN;
  const int kt0 = (int)((long long)split * n_kt / p.n_split);
  const int kt1 = (int)((long long)(split + 1) * n_kt / p.n_split);

  // this thread's rows: warp * 16 + g and + 8 of the tile
  bool valid[2];
  int lim[2];             // keys [0, lim) are live for the row
  size_t orow[2];         // its row of o, lse and the partials
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = m * FA_BM + warp * 16 + g + 8 * e;
    valid[e] = r < p.n_rows;
    const int i = r / n_rep, h = hk * n_rep + r % n_rep;
    orow[e] = ((size_t)b * p.Hq + h) * p.Tq + i;
    lim[e] = valid[e] ? min(p.kv_len, p.q_offset + i + 1) : 0;
  }
  const int warp_hi = __reduce_max_sync(FA_FULL, max(lim[0], lim[1]));
  const int warp_lo = __reduce_min_sync(FA_FULL, min(valid[0] ? lim[0] : INT_MAX,
                                                     valid[1] ? lim[1] : INT_MAX));

  // O in shared memory: this thread's fragment slots (its two rows, columns
  // 8n + 2t and 2t + 1), which only this thread reads and writes
  float* const orow_s[2] = {o_s + (warp * 16 + g) * LDQ + 2 * t,
                            o_s + (warp * 16 + g + 8) * LDQ + 2 * t};
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<float2*>(orow_s[0] + 8 * n) = make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(orow_s[1] + 8 * n) = make_float2(0.f, 0.f);
  }
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

  const size_t pos0 = ((size_t)(p.kv_row + b) * p.Hkv + hk) * p.S;   // the head's position 0
  const T* kg = static_cast<const T*>(p.k) + pos0 * D;
  const T* vg = static_cast<const T*>(p.v) + pos0 * D;
  const float* ksg = KV8 ? p.ks + pos0 : nullptr;
  const float* vsg = KV8 ? p.vs + pos0 : nullptr;

  auto stage = [&](int kt, int st) {
    if constexpr (F32KV)
      stage_tile_f32<D>(kg, vg, kt * BN, min(BN, key_end - kt * BN), st, kvf_s);
    else
      stage_tile<D, KV8>(kg, vg, ksg, vsg, kt * BN, min(BN, key_end - kt * BN), st, kv_s, raw,
                         scl);
  };
  if (kt0 < kt1) {
    stage(kt0, 0);
    // q of the tile's rows (split into TF32 parts where a fragment is loaded);
    // rows past n_rows are 0
#pragma unroll 4
    for (int e = tid; e < FA_BM * D / 4; e += FA_THREADS) {
      const int r = e / (D / 4), c = 4 * (e % (D / 4));
      const int pr = m * FA_BM + r;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (pr < p.n_rows) {
        const int h = hk * n_rep + pr % n_rep;
        x = __ldg(reinterpret_cast<const float4*>(
            p.q + (((size_t)b * p.Hq + h) * p.Tq + pr / n_rep) * D + c));
      }
      *reinterpret_cast<float4*>(q_s + r * LDQ + c) = x;
    }

    const float* qf = q_s + (warp * 16 + g) * LDQ + 2 * t;
    for (int kt = kt0; kt < kt1; ++kt) {
      const int st = (kt - kt0) & 1;
      if (kt + 1 < kt1) {
        stage(kt + 1, st ^ 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      if constexpr (KV8) {        // widen the stage's levels into the bf16 tile
        const uint32_t* src = reinterpret_cast<const uint32_t*>(raw + st * 2 * BN * D);
        constexpr int W = D / 4;
        for (int e = tid; e < 2 * BN * W; e += FA_THREADS) {
          const int kv = e / (BN * W), r = (e / W) % BN, c = e % W;
          const uint32_t w = src[e];
          *reinterpret_cast<uint2*>(kv_s + (kv * BN + r) * LDK + 4 * c) =
              make_uint2(level_bf16(w, 0) | (level_bf16(w, 1) << 16),
                         level_bf16(w, 2) | (level_bf16(w, 3) << 16));
        }
        __syncthreads();
      }
      const __nv_bfloat16* Ks = kv_s + (KV8 ? 0 : st * 2 * BN * LDK);
      const __nv_bfloat16* Vs = Ks + BN * LDK;
      const float* Kf = kvf_s + st * BN * (LDKF + LDVF);
      const float* Vf = Kf + BN * LDKF;
      const float* ksc = scl + st * 2 * BN;
      const float* vsc = ksc + BN;
      const int k0 = kt * BN;
      if (k0 < warp_hi) {
        // S = q K^T over the warp's 16 rows and the BN keys, in three
        // accumulator chains: the hi products of even and of odd k-steps, and
        // the lo products (see "Accumulation" in the note)
        float s[NT][4], s1[NT][4], sl[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = s1[j][e] = sl[j][e] = 0.f;
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
          if constexpr (F32KV) {
#pragma unroll
            for (int j = 0; j < NT; ++j) {   // B of key block j: (d 2t, 2t + 1) of key 8 j + g
              const float2 kx =
                  *reinterpret_cast<const float2*>(Kf + (8 * j + g) * LDKF + kk * 8 + 2 * t);
              uint32_t bh0, bl0, bh1, bl1;
              split_tf32(kx.x, bh0, bl0);
              split_tf32(kx.y, bh1, bl1);
              mma_tf32(kk & 1 ? s1[j] : s[j], ah, bh0, bh1);
              mma_tf32(sl[j], al, bh0, bh1);
              mma_tf32(sl[j], ah, bl0, bl1);
            }
          } else {
#pragma unroll
            for (int j4 = 0; j4 < NT / 4; ++j4) {
              uint32_t kb[4];      // B of key blocks 4 j4 .. 4 j4 + 3: (d 2t, 2t + 1) of key g
              ldsm_x4(kb, Ks + (32 * j4 + lane) * LDK + kk * 8);
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                const uint32_t b0 = kb[u] << 16, b1 = kb[u] & 0xFFFF0000u;
                mma_tf32(kk & 1 ? s1[4 * j4 + u] : s[4 * j4 + u], ah, b0, b1);
                mma_tf32(sl[4 * j4 + u], al, b0, b1);
              }
            }
          }
        }
        // scale, and mask where the tile crosses a row's limit
        const bool mask = k0 + BN > warp_lo;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = 8 * j + 2 * t + (e & 1);
            float x = (s[j][e] + s1[j][e]) + sl[j][e];
            x *= KV8 ? ksc[key] * p.scale : p.scale;
            if (mask && k0 + key >= lim[e >> 1]) x = -INFINITY;
            s[j][e] = x;
          }
        }
        // online softmax per row, one rescale per tile
        float alpha[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * e], s[j][2 * e + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(FA_FULL, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(FA_FULL, mx, 2));
          const float m_new = fmaxf(mrow[e], mx);
          const float m_use = m_new == -INFINITY ? 0.f : m_new;
          alpha[e] = expf(mrow[e] - m_use);                    // 0 before the first live key
          float ps = 0.f;
#pragma unroll
          for (int j = 0; j < NT; ++j) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const float pj = expf(s[j][2 * e + u] - m_use);  // masked: exp(-inf) = 0
              s[j][2 * e + u] = pj;
              ps += pj;
            }
          }
          lrow[e] = lrow[e] * alpha[e] + ps;
          mrow[e] = m_new;
        }
        // P's A fragments, split once: the S fragment of key block j is the A
        // fragment of k-step j of P V (k t <-> key 2t, k t + 4 <-> key 2t + 1)
        uint32_t pah[NT][4], pal[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          float pv[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
          if constexpr (KV8) {    // v_scale folded into p
            const float2 vv = *reinterpret_cast<const float2*>(vsc + 8 * j + 2 * t);
            pv[0] *= vv.x;
            pv[1] *= vv.x;
            pv[2] *= vv.y;
            pv[3] *= vv.y;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) split_tf32(pv[u], pah[j][u], pal[j][u]);
        }
        // O = O * alpha + P V, one 8-column block at a time: the block's P V
        // builds over the tile's keys in fresh hi and lo accumulators and joins
        // O in one IEEE fma; V's B pairs come from ldmatrix.trans
#pragma unroll
        for (int n = 0; n < NO; ++n) {
          float oh[4] = {0.f, 0.f, 0.f, 0.f}, ol[4] = {0.f, 0.f, 0.f, 0.f};
          if constexpr (F32KV) {
#pragma unroll
            for (int j = 0; j < NT; ++j) {   // key block j: keys 8 j + 2t, + 1 at column 8 n + g
              const float* vp = Vf + (8 * j + 2 * t) * LDVF + 8 * n + g;
              uint32_t vh0, vl0, vh1, vl1;
              split_tf32(vp[0], vh0, vl0);
              split_tf32(vp[LDVF], vh1, vl1);
              mma_tf32(oh, pah[j], vh0, vh1);
              mma_tf32(ol, pal[j], vh0, vh1);
              mma_tf32(ol, pah[j], vl0, vl1);
            }
          } else {
#pragma unroll
            for (int j4 = 0; j4 < NT / 4; ++j4) {
              uint32_t vb[4];     // key blocks 4 j4 .. 4 j4 + 3: keys 2t, 2t + 1 at column g
              ldsm_x4_trans(vb, Vs + (32 * j4 + lane) * LDK + 8 * n);
#pragma unroll
              for (int u = 0; u < 4; ++u) {
                mma_tf32(oh, pah[4 * j4 + u], vb[u] << 16, vb[u] & 0xFFFF0000u);
                mma_tf32(ol, pal[4 * j4 + u], vb[u] << 16, vb[u] & 0xFFFF0000u);
              }
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float2* o = reinterpret_cast<float2*>(orow_s[e] + 8 * n);
            float2 x = *o;
            x.x = fmaf(x.x, alpha[e], oh[2 * e] + ol[2 * e]);
            x.y = fmaf(x.y, alpha[e], oh[2 * e + 1] + ol[2 * e + 1]);
            *o = x;
          }
        }
      }
      __syncthreads();
    }
  }

  fa_epilogue<D>(p, orow_s, orow, valid, mrow, lrow, split, t);
}

// ---- the bf16 form ------------------------------------------------------------

template <int D>
struct FbShape {
  static constexpr int BN = D <= 64 ? 128 : 64;   // keys per K/V sub-tile
  static constexpr int NT = BN / 8;               // 8-key blocks of a sub-tile
  static constexpr int KS = D / 16;               // k16 steps of a score
  static constexpr int LDO = D + 8;               // floats per O row in smem
  static constexpr int LDK = D + 8;               // bf16 per staged K / V row
  static_assert(NT % 2 == 0 && D % 16 == 0 && (D / 8) % 2 == 0, "tile shape");
};

// O [FA_BM][LDO] f32; the bf16 K and V sub-tiles [BN][LDK] (two stages; K9
// and the f32-K/V form widen or round into one); K9 only: the raw int8 K and
// V [BN][D] and their scales [BN], two stages each; the f32-K/V form: the raw
// f32 K and V [BN][D], two stages (at D 128: 34,816 + 34,816 + 131,072 =
// 200,704 bytes, one block an SM).
template <int D, bool KV8, bool F32KV = false>
constexpr size_t fb_smem_bytes() {
  using Sh = FbShape<D>;
  return 1ull * FA_BM * Sh::LDO * sizeof(float) +
         (KV8 || F32KV ? 1ull : 2ull) * 2 * Sh::BN * Sh::LDK * 2 +
         (KV8 ? 2ull * 2 * Sh::BN * D + 2ull * 2 * Sh::BN * sizeof(float) : 0ull) +
         (F32KV ? 2ull * 2 * Sh::BN * D * sizeof(float) : 0ull);
}

// One step of the bf16 form's walk over a split: sub-tile `sub` of key group
// `grp`, in the max pass (pass 0, K only) or the main pass (pass 1, K and V).
// A group of one sub-tile has no max pass.
struct FbItem {
  int grp, sub, pass;
};

__device__ __forceinline__ int fb_nsub(int grp, int group, int key_end, int bn) {
  const int g0 = grp * group, g1 = min(g0 + group, key_end);
  return (g1 - g0 + bn - 1) / bn;
}

__device__ __forceinline__ FbItem fb_first(int grp, int group, int key_end, int bn) {
  return {grp, 0, fb_nsub(grp, group, key_end, bn) > 1 ? 0 : 1};
}

__device__ __forceinline__ FbItem fb_next(FbItem it, int group, int key_end, int bn) {
  if (it.sub + 1 < fb_nsub(it.grp, group, key_end, bn)) return {it.grp, it.sub + 1, it.pass};
  if (it.pass == 0) return {it.grp, 0, 1};
  return fb_first(it.grp + 1, group, key_end, bn);
}

// Issue the copies of an item's keys [j0, j0 + nk) (K, and V in the main
// pass) into stage st; rows past nk are zero-filled. One commit group.
template <int D, bool KV8, class T>
__device__ __forceinline__ void fb_stage(const T* kg, const T* vg, const float* ksg,
                                         const float* vsg, int j0, int nk, bool with_v, int st,
                                         __nv_bfloat16* kv_s, int8_t* raw, float* scl) {
  using Sh = FbShape<D>;
  constexpr int BN = Sh::BN, LDK = Sh::LDK;
  const int tid = threadIdx.x;
  if constexpr (std::is_same_v<T, float>) {       // the f32-K/V form: raw f32 rows
    constexpr int CH = D / 4;
    float* kd = reinterpret_cast<float*>(raw) + st * 2 * BN * D;
    float* vd = kd + BN * D;
    for (int e = tid; e < BN * CH; e += FA_THREADS) {
      const int r = e / CH, c = e % CH;
      const bool live = r < nk;
      const size_t off = (size_t)(j0 + (live ? r : 0)) * D + c * 4;
      cp_async16(kd + r * D + c * 4, kg + off, live);
      if (with_v) cp_async16(vd + r * D + c * 4, vg + off, live);
    }
  } else if constexpr (KV8) {
    constexpr int CH = D / 16;
    int8_t* kd = raw + st * 2 * BN * D;
    int8_t* vd = kd + BN * D;
    for (int e = tid; e < BN * CH; e += FA_THREADS) {
      const int r = e / CH, c = e % CH;
      const bool live = r < nk;
      const size_t off = (size_t)(j0 + (live ? r : 0)) * D + c * 16;
      cp_async16(kd + r * D + c * 16, kg + off, live);
      if (with_v) cp_async16(vd + r * D + c * 16, vg + off, live);
    }
    if (tid < BN) {
      const bool live = tid < nk;
      const int off = j0 + (live ? tid : 0);
      cp_async4(scl + st * 2 * BN + tid, ksg + off, live);
      if (with_v) cp_async4(scl + st * 2 * BN + BN + tid, vsg + off, live);
    }
  } else {
    constexpr int CH = D / 8;
    __nv_bfloat16* kd = kv_s + st * 2 * BN * LDK;
    __nv_bfloat16* vd = kd + BN * LDK;
    for (int e = tid; e < BN * CH; e += FA_THREADS) {
      const int r = e / CH, c = e % CH;
      const bool live = r < nk;
      const size_t off = (size_t)(j0 + (live ? r : 0)) * D + c * 8;
      cp_async16(kd + r * LDK + c * 8, kg + off, live);
      if (with_v) cp_async16(vd + r * LDK + c * 8, vg + off, live);
    }
  }
  cp_async_commit();
}

template <int D, bool KV8, bool F32KV = false>
__global__ void __launch_bounds__(FA_THREADS, 1) flash_bf16_kernel(const FaParams p) {
  static_assert(!(KV8 && F32KV), "one cache form");
  using Sh = FbShape<D>;
  constexpr int BN = Sh::BN, NT = Sh::NT, KS = Sh::KS, LDO = Sh::LDO, LDK = Sh::LDK;
  constexpr int NO = D / 8;
  constexpr bool RAW = KV8 || F32KV;                 // staged raw, then made bf16 in one pass
  using T = std::conditional_t<KV8, int8_t, std::conditional_t<F32KV, float, __nv_bfloat16>>;
  extern __shared__ __align__(16) unsigned char fa_smem[];
  float* o_s = reinterpret_cast<float*>(fa_smem);
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(o_s + FA_BM * LDO);
  int8_t* raw = reinterpret_cast<int8_t*>(kv_s + (RAW ? 1 : 2) * 2 * BN * LDK);
  float* scl = reinterpret_cast<float*>(raw + 2 * 2 * BN * D);

  const int n_rep = p.Hq / p.Hkv;
  const int n_m = (p.n_rows + FA_BM - 1) / FA_BM;
  const int m = n_m - 1 - (int)blockIdx.x;          // the longest tiles first
  const int b = blockIdx.y / p.Hkv, hk = blockIdx.y % p.Hkv;
  const int split = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int group = p.group;

  const int key_end = tile_key_end(p.n_rows, p.kv_len, p.q_offset, m, n_rep);
  const int n_kt = (key_end + group - 1) / group;   // key groups of the tile
  const int kt0 = (int)((long long)split * n_kt / p.n_split);
  const int kt1 = (int)((long long)(split + 1) * n_kt / p.n_split);

  bool valid[2];
  int lim[2];
  size_t orow[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = m * FA_BM + warp * 16 + g + 8 * e;
    valid[e] = r < p.n_rows;
    const int i = r / n_rep, h = hk * n_rep + r % n_rep;
    orow[e] = ((size_t)b * p.Hq + h) * p.Tq + i;
    lim[e] = valid[e] ? min(p.kv_len, p.q_offset + i + 1) : 0;
  }
  const int warp_hi = __reduce_max_sync(FA_FULL, max(lim[0], lim[1]));
  const int warp_lo = __reduce_min_sync(FA_FULL, min(valid[0] ? lim[0] : INT_MAX,
                                                     valid[1] ? lim[1] : INT_MAX));

  float* const orow_s[2] = {o_s + (warp * 16 + g) * LDO + 2 * t,
                            o_s + (warp * 16 + g + 8) * LDO + 2 * t};
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<float2*>(orow_s[0] + 8 * n) = make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(orow_s[1] + 8 * n) = make_float2(0.f, 0.f);
  }
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};
  float gmax[2] = {-INFINITY, -INFINITY};     // the group's max (its max pass)
  float muse[2] = {0.f, 0.f};                 // the max the group's p are taken against

  const size_t pos0 = ((size_t)(p.kv_row + b) * p.Hkv + hk) * p.S;
  const T* kg = static_cast<const T*>(p.k) + pos0 * D;
  const T* vg = static_cast<const T*>(p.v) + pos0 * D;
  const float* ksg = KV8 ? p.ks + pos0 : nullptr;
  const float* vsg = KV8 ? p.vs + pos0 : nullptr;

  if (kt0 < kt1) {
    FbItem it = fb_first(kt0, group, key_end, BN);
    {
      const int j0 = it.grp * group;
      fb_stage<D, KV8>(kg, vg, ksg, vsg, j0, min(BN, min(j0 + group, key_end) - j0), it.pass == 1,
                       0, kv_s, raw, scl);
    }
    // q's A fragments, bf16 (rounded to nearest even), held for the block:
    // qa[ks] = (row g, d 16ks + 2t..), (g + 8, ..), (g, 16ks + 8 + 2t..), (g + 8, ..)
    uint32_t qa[KS][4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int pr = m * FA_BM + warp * 16 + g + 8 * e;
      const float* qrow = nullptr;
      if (pr < p.n_rows) {
        const int h = hk * n_rep + pr % n_rep;
        qrow = p.q + (((size_t)b * p.Hq + h) * p.Tq + pr / n_rep) * D + 2 * t;
      }
#pragma unroll
      for (int ks = 0; ks < KS; ++ks)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float2 x = make_float2(0.f, 0.f);
          if (qrow != nullptr) x = __ldg(reinterpret_cast<const float2*>(qrow + 16 * ks + 8 * hf));
          qa[ks][2 * hf + e] = tf32::pack_bf16x2(x.x, x.y);
        }
    }

    int st = 0;
    while (it.grp < kt1) {
      const FbItem nx = fb_next(it, group, key_end, BN);
      if (nx.grp < kt1) {
        const int j0n = nx.grp * group + nx.sub * BN;
        fb_stage<D, KV8>(kg, vg, ksg, vsg, j0n,
                         min(BN, min(nx.grp * group + group, key_end) - j0n), nx.pass == 1,
                         st ^ 1, kv_s, raw, scl);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const bool main_pass = it.pass == 1;
      if constexpr (KV8) {        // widen the stage's levels (K; V in the main pass) to bf16
        const uint32_t* src = reinterpret_cast<const uint32_t*>(raw + st * 2 * BN * D);
        constexpr int W = D / 4;
        const int n_w = (main_pass ? 2 : 1) * BN * W;
        for (int e = tid; e < n_w; e += FA_THREADS) {
          const int kv = e / (BN * W), r = (e / W) % BN, c = e % W;
          const uint32_t w = src[e];
          *reinterpret_cast<uint2*>(kv_s + (kv * BN + r) * LDK + 4 * c) =
              make_uint2(level_bf16(w, 0) | (level_bf16(w, 1) << 16),
                         level_bf16(w, 2) | (level_bf16(w, 3) << 16));
        }
        __syncthreads();
      } else if constexpr (F32KV) {   // round the stage's f32 rows to bf16 (nearest even), once
        const float4* src = reinterpret_cast<const float4*>(raw) + st * 2 * BN * (D / 4);
        constexpr int W = D / 4;
        const int n_w = (main_pass ? 2 : 1) * BN * W;
        for (int e = tid; e < n_w; e += FA_THREADS) {
          const int kv = e / (BN * W), r = (e / W) % BN, c = e % W;
          const float4 x = src[e];
          *reinterpret_cast<uint2*>(kv_s + (kv * BN + r) * LDK + 4 * c) =
              make_uint2(tf32::pack_bf16x2(x.x, x.y), tf32::pack_bf16x2(x.z, x.w));
        }
        __syncthreads();
      }
      const __nv_bfloat16* Ks = kv_s + (RAW ? 0 : st * 2 * BN * LDK);
      const __nv_bfloat16* Vs = Ks + BN * LDK;
      const float* ksc = scl + st * 2 * BN;
      const float* vsc = ksc + BN;
      const int g0 = it.grp * group;
      const int g1 = min(g0 + group, key_end);
      const int j0 = g0 + it.sub * BN;
      const bool two = fb_nsub(it.grp, group, key_end, BN) > 1;
      if (it.sub == 0 && (!main_pass || !two)) gmax[0] = gmax[1] = -INFINITY;
      if (j0 < warp_hi) {
        // S = bf16(q) K^T over the warp's 16 rows and the sub-tile's keys:
        // one bf16 MMA per 16 d, exact products, f32 sums (one chain of KS)
        float s[NT][4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
          for (int j2 = 0; j2 < NT / 2; ++j2) {
            uint32_t kb[4];        // key blocks 2 j2, 2 j2 + 1: (d 16ks + 2t.., key g), (+8 ..)
            ldsm_x4(kb, Ks + (16 * j2 + (lane & 7) + 8 * (lane >> 4)) * LDK + 16 * ks +
                            8 * ((lane >> 3) & 1));
            tf32::mma_bf16(s[2 * j2], qa[ks], kb[0], kb[1]);
            tf32::mma_bf16(s[2 * j2 + 1], qa[ks], kb[2], kb[3]);
          }
        }
        // scale (K9: k_scale * scale, attention.py:631), and mask keys past a
        // row's limit or the group's end
        const bool mask = j0 + BN > warp_lo || j0 + BN > g1;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = j0 + 8 * j + 2 * t + (e & 1);
            // rounded as the backward (flash_bwd.cu) recomputes it
            float x = __fmul_rn(s[j][e], KV8 ? __fmul_rn(ksc[key - j0], p.scale) : p.scale);
            if (mask && (key >= lim[e >> 1] || key >= g1)) x = -INFINITY;
            s[j][e] = x;
          }
        }
        float tmax[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < NT; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * e], s[j][2 * e + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(FA_FULL, mx, 1));
          tmax[e] = fmaxf(mx, __shfl_xor_sync(FA_FULL, mx, 2));
        }
        if (!main_pass) {
          gmax[0] = fmaxf(gmax[0], tmax[0]);
          gmax[1] = fmaxf(gmax[1], tmax[1]);
        } else {
          // the group's first sub-tile moves the running max once (JAX's tile
          // step, attention.py:92-104); its later sub-tiles add at alpha 1
          float alpha[2] = {1.f, 1.f};
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            if (it.sub == 0) {
              const float gm = two ? gmax[e] : tmax[e];
              const float m_new = fmaxf(mrow[e], gm);
              muse[e] = m_new == -INFINITY ? 0.f : m_new;
              alpha[e] = expf(mrow[e] - muse[e]);             // 0 before the first live key
              lrow[e] *= alpha[e];
              mrow[e] = m_new;
            }
            float ps = 0.f;
#pragma unroll
            for (int j = 0; j < NT; ++j) {
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const float pj = expf(s[j][2 * e + u] - muse[e]);   // masked: exp(-inf) = 0
                s[j][2 * e + u] = pj;
                ps += pj;
              }
            }
            lrow[e] += ps;
          }
          // P's A fragments, bf16 (K9: p * v_scale, attention.py:642), from the
          // S accumulators: k-step j2 takes key blocks 2 j2 and 2 j2 + 1
          uint32_t pa[NT / 2][4];
#pragma unroll
          for (int j2 = 0; j2 < NT / 2; ++j2) {
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int j = 2 * j2 + hf;
              float v0 = s[j][0], v1 = s[j][1], v2 = s[j][2], v3 = s[j][3];
              if constexpr (KV8) {
                const float2 vv = *reinterpret_cast<const float2*>(vsc + 8 * j + 2 * t);
                v0 *= vv.x;
                v1 *= vv.y;
                v2 *= vv.x;
                v3 *= vv.y;
              }
              pa[j2][2 * hf] = tf32::pack_bf16x2(v0, v1);
              pa[j2][2 * hf + 1] = tf32::pack_bf16x2(v2, v3);
            }
          }
          // O = O * alpha + P V, two 8-column blocks at a time, each sub-tile's
          // P V in fresh accumulators joined by one IEEE fma
#pragma unroll
          for (int n = 0; n < NO; n += 2) {
            float o0[4] = {0.f, 0.f, 0.f, 0.f}, o1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
            for (int j2 = 0; j2 < NT / 2; ++j2) {
              uint32_t vb[4];     // (keys 16 j2 + 2t.., col g), (+8 ..) of blocks n, n + 1
              ldsm_x4_trans(vb, Vs + (16 * j2 + 8 * ((lane >> 3) & 1) + (lane & 7)) * LDK +
                                    8 * (n + (lane >> 4)));
              tf32::mma_bf16(o0, pa[j2], vb[0], vb[1]);
              tf32::mma_bf16(o1, pa[j2], vb[2], vb[3]);
            }
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float2* oa = reinterpret_cast<float2*>(orow_s[e] + 8 * n);
              float2* ob = reinterpret_cast<float2*>(orow_s[e] + 8 * (n + 1));
              float2 xa = *oa, xb = *ob;
              xa.x = fmaf(xa.x, alpha[e], o0[2 * e]);
              xa.y = fmaf(xa.y, alpha[e], o0[2 * e + 1]);
              xb.x = fmaf(xb.x, alpha[e], o1[2 * e]);
              xb.y = fmaf(xb.y, alpha[e], o1[2 * e + 1]);
              *oa = xa;
              *ob = xb;
            }
          }
        }
      }
      __syncthreads();
      it = nx;
      st ^= 1;
    }
  }
  fa_epilogue<D>(p, orow_s, orow, valid, mrow, lrow, split, t);
}

// Merge the n_split partials of every row: o = sum_s w_s o_s / sum_s w_s l_s
// with w_s = exp(m_s - max m) over the splits with l_s > 0; a row with none
// gives 0 and lse +inf. One thread per 4 columns of a row.
template <int D>
__global__ void flash_combine_kernel(const float* __restrict__ part, float* __restrict__ o,
                                     float* __restrict__ lse, int total_rows, int n_split) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total_rows * (D / 4)) return;
  const int row = e / (D / 4), c = 4 * (e % (D / 4));
  const float2* ml = reinterpret_cast<const float2*>(part + (size_t)n_split * total_rows * D);
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) {
    const float2 v = ml[(size_t)s * total_rows + row];
    if (v.y > 0.f) mx = fmaxf(mx, v.x);
  }
  float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
  float den = 0.f;
  for (int s = 0; s < n_split; ++s) {
    const float2 v = ml[(size_t)s * total_rows + row];
    if (v.y > 0.f) {                 // splits with no live key for the row add nothing
      const float w = expf(v.x - mx);
      const float4 x =
          *reinterpret_cast<const float4*>(part + ((size_t)s * total_rows + row) * D + c);
      num.x = fmaf(w, x.x, num.x);
      num.y = fmaf(w, x.y, num.y);
      num.z = fmaf(w, x.z, num.z);
      num.w = fmaf(w, x.w, num.w);
      den = fmaf(w, v.y, den);
    }
  }
  *reinterpret_cast<float4*>(o + (size_t)row * D + c) =
      den > 0.f ? make_float4(num.x / den, num.y / den, num.z / den, num.w / den)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  if (lse != nullptr && c == 0) lse[row] = den > 0.f ? mx + logf(den) : INFINITY;
}

template <int D, bool KV8, bool F32KV = false>
int launch(const FaParams& p, int B, int bn, bool bf16, cudaStream_t st) {
  const dim3 grid((p.n_rows + FA_BM - 1) / FA_BM, B * p.Hkv, p.n_split);
  int rc;
  if (bf16) {         // bn is the key group, any size
    if (bn < 1) return ZGML_ERR_SHAPE;
    FaParams q = p;
    q.group = bn;
    constexpr size_t smem = fb_smem_bytes<D, KV8, F32KV>();
    rc = allow_dynamic_smem(flash_bf16_kernel<D, KV8, F32KV>, smem);
    if (rc != 0) return rc;
    flash_bf16_kernel<D, KV8, F32KV><<<grid, FA_THREADS, smem, st>>>(q);
  } else {
    if (bn != FaShape<D>::BN) return ZGML_ERR_SHAPE;    // the host plan's tile must be ours
    constexpr size_t smem = fa_smem_bytes<D, KV8, F32KV>();
    rc = allow_dynamic_smem(flash_attn_kernel<D, KV8, F32KV>, smem);
    if (rc != 0) return rc;
    flash_attn_kernel<D, KV8, F32KV><<<grid, FA_THREADS, smem, st>>>(p);
  }
  rc = (int)cudaGetLastError();
  if (rc != 0 || p.n_split == 1) return rc;
  const int threads = 256, n = p.total_rows * (D / 4);
  flash_combine_kernel<D><<<(n + threads - 1) / threads, threads, 0, st>>>(
      p.part, p.o, p.lse, p.total_rows, p.n_split);
  return (int)cudaGetLastError();
}

template <class K>
int occupancy(K kernel, size_t smem, int* n) {
  const int rc = allow_dynamic_smem(kernel, smem);
  if (rc != 0) return rc;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, kernel, FA_THREADS, smem);
}

template <int D, bool KV8>
int blocks_per_sm(bool bf16, int* n) {
  return bf16 ? occupancy(flash_bf16_kernel<D, KV8>, fb_smem_bytes<D, KV8>(), n)
              : occupancy(flash_attn_kernel<D, KV8>, fa_smem_bytes<D, KV8>(), n);
}

template <int D>
int blocks_per_sm_f32kv(int* n) {
  return occupancy(flash_attn_kernel<D, false, true>, fa_smem_bytes<D, false, true>(), n);
}

template <bool KV8, bool F32KV = false>
int launch_hd(const FaParams& p, int B, int D, int bn, bool bf16, cudaStream_t st) {
  switch (D) {
    case 16: return launch<16, KV8, F32KV>(p, B, bn, bf16, st);
    case 32: return launch<32, KV8, F32KV>(p, B, bn, bf16, st);
    case 64: return launch<64, KV8, F32KV>(p, B, bn, bf16, st);
    case 128: return launch<128, KV8, F32KV>(p, B, bn, bf16, st);
    default: return ZGML_ERR_HEAD_DIM;
  }
}

}  // namespace

// *n = the blocks of flash_attn_kernel<D, kv == 1> (kv 2: its f32-K/V form;
// bf16: flash_bf16_kernel) one SM holds at once (the occupancy the host plan
// fills); returns a status. The bf16 form over f32 K/V takes the bf16
// cache's plan (ops/attention.flash_plan), so it has no entry here.
ZGML_EXPORT int zgml_flash_blocks_per_sm(int D, int kv, int bf16, int* n) {
  if (kv == 2 && bf16 != 0) return ZGML_ERR_SHAPE;
#define ZGML_FLASH_OCC(DD)                                 \
  case DD:                                                 \
    return kv == 2 ? blocks_per_sm_f32kv<DD>(n)            \
           : kv    ? blocks_per_sm<DD, true>(bf16 != 0, n) \
                   : blocks_per_sm<DD, false>(bf16 != 0, n);
  switch (D) {
    ZGML_FLASH_OCC(16)
    ZGML_FLASH_OCC(32)
    ZGML_FLASH_OCC(64)
    ZGML_FLASH_OCC(128)
    default: return ZGML_ERR_HEAD_DIM;
  }
#undef ZGML_FLASH_OCC
}

// q f32 [B, Hq, Tq, D], k/v [R, Hkv, S, D] with R >= kv_row + B: bf16 (K3, ks
// and vs null) or int8 levels with f32 scales ks/vs [R, Hkv, S] (K9); o f32
// [B, Hq, Tq, D]; lse f32 [B, Hq, Tq] or null (K10f writes it; bf16 cache
// only); all contiguous, 16-byte aligned. n_split and bn come from
// ops/attention.py flash_split_plan (bn must be this build's tile for D;
// with bf16 != 0, the bf16 form, it is the key group of its running max);
// with n_split > 1, part is f32 scratch of n_split * B * Hq * Tq * (D + 2).
ZGML_EXPORT int zgml_flash_attention(const float* q, const void* k, const float* ks,
                                     const void* v, const float* vs, float* o, float* lse,
                                     float* part, int B, int Hq, int Hkv, int Tq, int S, int D,
                                     int kv_len, int q_offset, int kv_row, int n_split, int bn,
                                     int bf16, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Tq <= 0 || S <= 0 || kv_row < 0 ||
      q_offset < 0 || n_split < 1 || n_split > 65535 || (n_split > 1 && part == nullptr) ||
      (ks == nullptr) != (vs == nullptr) || (ks != nullptr && lse != nullptr))
    return ZGML_ERR_SHAPE;
  FaParams p{q, k, ks, v, vs, o, lse, part, Hq, Hkv, Tq, S, max(0, min(kv_len, S)), q_offset,
             kv_row, n_split, (Hq / Hkv) * Tq, B * Hq * Tq, scale, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return ks != nullptr ? launch_hd<true>(p, B, D, bn, bf16 != 0, st)
                       : launch_hd<false>(p, B, D, bn, bf16 != 0, st);
}

// The f32-K/V forms over f32 k/v [R, Hkv, S, D] (the f32 KV cache's K3, and
// a ring hop's K10f under ZGML_TPU_PREFILL_BF16=0): q f32 [B, Hq, Tq, D], o
// and lse as zgml_flash_attention's (lse may be null; the bf16 form takes
// none); n_split, bn and part as there (bf16 == 0: bn this build's tile for
// D; bf16 != 0: the bf16 form over bf16(K), bf16(V), bn its key group).
ZGML_EXPORT int zgml_flash_attention_f32(const float* q, const float* k, const float* v, float* o,
                                         float* lse, float* part, int B, int Hq, int Hkv, int Tq,
                                         int S, int D, int kv_len, int q_offset, int kv_row,
                                         int n_split, int bn, int bf16, float scale,
                                         void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Tq <= 0 || S <= 0 || kv_row < 0 ||
      q_offset < 0 || n_split < 1 || n_split > 65535 || (n_split > 1 && part == nullptr) ||
      (bf16 != 0 && lse != nullptr))
    return ZGML_ERR_SHAPE;
  FaParams p{q, k, nullptr, v, nullptr, o, lse, part, Hq, Hkv, Tq, S, max(0, min(kv_len, S)),
             q_offset, kv_row, n_split, (Hq / Hkv) * Tq, B * Hq * Tq, scale, 0};
  return launch_hd<false, true>(p, B, D, bn, bf16 != 0, static_cast<cudaStream_t>(stream));
}
