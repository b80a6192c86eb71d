// K1 qmatmul_i8 and K5 greedy: the int8-activation GEMV tier, Q4_0 (K1q4,
// K5q4) and Q8_0 (K1q8, K5q8).
//
// Replaces: zgml_tpu/ops/qmatmul.py `_q4_i8_kernel` (pallas_call at line 306,
// entry `_q4_matmul_i8`) and `_q8_i8_kernel` (pallas_call at line 233, entry
// `_q8_matmul_i8`), which `qmatmul_pallas` takes for M <= 32 when
// ZGML_TPU_I8DOT is on (qmatmul.py:639,728), and `_q4_i8_argmax_kernel` /
// `_q8_i8_argmax_kernel` (pallas_calls at lines 462 / 444, entry
// `qmatmul_greedy_pallas`: one live row, the argmax id with the first index
// on ties).
//
// Semantics (the plain versions are ops/qmatmul.py qmatmul_i8_ref and
// greedy_ref), as the JAX `_quantize_act` + `_block_dot`:
//   per row m and 32-block b of x: s = amax|x_b| / 127, inv = 1/s (0 when
//   s == 0), xq = clip(rint(x * inv), -127, 127) (round half to even, IEEE
//   division: this file must not be built with fast math, so xq and xs are
//   bit-equal to the JAX package's);
//   y[m, n] = sum_b float(sum_j xq_j * level_j) * (xs[m, b] * d[n, b]),
//   level = nibble - 8 (Q4_0) or the int8 q (Q8_0).
// The int8 block dots are exact; only the f32 sum over blocks is taken in
// another order than on the TPU.
//
// What bounds it on the H100: the weight's HBM bytes (0.5625 bytes a weight
// at Q4_0, 1.0625 at Q8_0), read once for all M <= 32 rows; its 2 M N K int8
// operations are far below the tensor cores' rate.
//
// What the design does about it (one launch a call, K1 and K5 alike; the
// plan is ops/qmatmul.py i8_plan, which the launcher checks):
//   * One persistent block an SM on weight_stream.cuh's producer: the grid's
//     16-row tiles are split into contiguous ranges, one a block, and the
//     producer warp streams the block's tiles, S at a time (a stage: S * 16
//     whole rows, so one bulk copy of qs and one of the scales), from kernel
//     entry on into a ring of slots. Each weight byte is read once.
//   * Block dots on int8 tensor cores: mma.sync m16n8k32 s8 with the weight
//     as A (16 rows x one 32-block) and the int8 activations as B (8 rows of
//     x; up to 4 n8 tiles for 32 rows). Each MMA starts from a fresh
//     accumulator, so one quant block is one MMA and its int32 result is
//     `_block_dot`'s integer (plus the constant it starts from, the bits of
//     1.5 * 2^23: read as a float, less 1.5 * 2^23, it is the integer
//     exactly); then acc += float(c) * (xs * d) by one fma. A Q4_0 word
//     holds the fragment as it lies: byte j of a row's block has element j
//     in its low nibble and j + 16 in its high one, so the word at byte 4t of
//     row g gives a0 (columns 4t..4t+3) from its low nibbles and a2 (16 +
//     4t..) from its high ones, each nibble n turned into 16 (n - 8) (a shift
//     and one LOP3); the factor 16 is folded into the staged xs (xs / 16,
//     exact), so the fma sees the same product. Q8_0's levels are the
//     fragment.
//   * A stage's rows lie 16 * nb (or 32 * nb) bytes apart, a multiple of 128
//     at the model widths, so the 8 rows of a fragment load sit on the same
//     banks: each lane reads its words of a 128-byte segment rotated by its
//     row and puts them back in order with selects (item, below).
//   * Work split: a stage of s tiles gives each tile NH * P warps, P parts of
//     its 128-byte segments (contiguous ranges) times NH column groups of x's
//     rows (2 at 17-32 rows, so a warp keeps two n8 tiles' accumulators: 544
//     threads cap ptxas at 96 registers). The P partial sums of each output
//     are added in part order after the stage (no float atomics: two
//     launches give the same bits), in a part area of two buffers (one
//     barrier a stage) or, at 17-32 rows, in the slot just consumed.
//   * x: with M * K <= I8_SELF_MAX_MK the producer copies x into shared
//     memory ahead of the weights and every block quantizes it itself, a
//     thread a 32-block (no grid barrier). Above, the blocks quantize their
//     share into a global xq in fragment order, pass one ws::CountBarrier
//     and stage the int8 rows back with __ldcg; where that does not fit
//     beside two slots, the B fragments are read from L2 in the dot (the
//     plan's `xg`). The producer copies at most `ahead` stages before the
//     consumers have staged x (loads an SM issues queue behind its bulk
//     copies in flight).
//   * Rows too long for an 8-row tile of whole rows to leave a slot (Q8_0
//     from K 27,040, Q4_0 from 51,072; the JAX grid tiles K and takes any K)
//     run the K-split form (the plan's kc > 1): each tile's rows are cut in
//     kc pieces of consecutive quant blocks (bounds a multiple of 8 blocks
//     where K / 32 is, so each row's fp16 scales come as 16-byte copies), a
//     unit is (tile, piece) and a stage one unit, whose rows the producer
//     copies a row at a time; each unit's sums go to a global [kc, M, N]
//     area, and after one grid barrier each block adds its share of the
//     outputs' kc pieces in piece order (two launches give the same bits).
//     x is quantized as in the whole-row form, bit-equal to the pre-pass,
//     and read from L2 (XG). It has instantiations of its own (SPLIT), so
//     the whole-row ones carry none of a piece's state (ptxas caps 544
//     threads at 96 registers); M = 1 runs its n8 code (the one-row form
//     spills at that cap).
//   * K5 is the same code at M = 1 with the same plan (so its values are
//     K1's bit for bit) and an argmax in place of the store: each thread
//     keeps the best of the rows it sums (strictly greater: its rows ascend),
//     the block takes the largest value at its lowest row, each block's
//     (value, row) goes to a global slot, and the last block to finish
//     (ticket) reduces the slots the same way, all its threads at once, and
//     leaves the ticket at 0. On the K-split plan (the JAX kernel's grid
//     walks K in blocks, qmatmul.py:425-480, so it takes any K) the units'
//     piece sums go to the [kc, 1, N] area as K1's do, and after the grid
//     barrier each thread sums its outputs' pieces in piece order (K1's
//     order, so the values are K1's split outputs bit for bit) and keeps the
//     best of them, into the same block and grid reduction.
#include "weight_stream.cuh"

namespace {

constexpr int TILE = 16;          // weight rows an MMA tile (A of m16n8k32)
constexpr int SEG = 128;          // bytes of a row a warp's item covers

struct I8Params {
  const float* x;           // [M, K]
  const uint8_t* qs;        // [N, nb * BYTES]
  const __half* d;          // [N, nb]
  float* y;                 // [M, N] (K1)
  float* ypart;             // the K-split form: [kc, M, N] piece sums
  uint8_t* xg;              // global mode: xq in fragment order, [nb][M][32]
  float* xsg;               // global mode: [nb][MX] staged scales
  int8_t* xq_out;           // [M, K] or null: the kernel's own activations
  float* xs_out;            // [M, nb] or null
  unsigned int* bar;        // coop.barrier_words (the CountBarrier's from word 2)
  unsigned int* ticket;     // K5: a counter word, zero at entry, left zero
  float* best_v;            // K5: [grid] each block's best value
  int* best_i;              // K5: [grid] and its row
  long long* out_id;        // K5
  int M, N, K;
};

// The plan's ints (ops/qmatmul.py i8_ints): the ring, tiles a stage, and the
// areas after the ring.
struct I8Args {
  ws::Ring ring;            // stages, slot_bytes, act_off (x's f32 copy), ahead
  int S, tr, self_q;        // tiles a stage, rows a tile (16, or 8 where 16 leave no slot)
  int pis;                  // the partial sums go into the slot just consumed (no part area)
  int xf_off, xs_off, part_off, red_off;
  int kc;                   // K pieces a row (1: whole rows; above, the K-split form, S 1)
};

// Quant blocks a K-split piece's bounds are a multiple of (ops/qmatmul.py
// i8_piece_align): 8 where nb is, so its scales copy in 16-byte units.
__host__ __device__ __forceinline__ int piece_align(int nb) { return nb % 8 == 0 ? 8 : 1; }

// Piece j of kc of a row of nb quant blocks: its first block and its blocks
// (ops/qmatmul.py i8_piece).
__device__ __forceinline__ void piece(int nb, int kc, int j, int& b0, int& nbc) {
  const int g = piece_align(nb);
  b0 = j * (nb / g) / kc * g;
  nbc = (j + 1) * (nb / g) / kc * g - b0;
}

// Byte offset of elements 4c..4c+3 of a row's 32-block in its fragment-order
// 32 bytes: lane t's two words hold elements 4t..4t+3 and 16 + 4t..16 + 4t + 3.
__device__ __forceinline__ int frag_word(int c) { return (c & 3) * 8 + (c >> 2) * 4; }

// One quant block's int8 dot on the tensor cores, from a fresh accumulator
// holding the bits of 1.5 * 2^23: each result is that float plus the exact
// integer dot (|dot| < 2^22), so i2f takes the float less 1.5 * 2^23 (exact).
constexpr int I2F_BIAS = 0x4B400000;
__device__ __forceinline__ float i2f(int c) { return __int_as_float(c) - 12582912.0f; }

__device__ __forceinline__ void mma_s8(int (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                       uint32_t a3, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=r"(c[0]), "=r"(c[1]), "=r"(c[2]), "=r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1), "r"(I2F_BIAS));
}

// fp16 k (0: low, 1: high) of a pair as a float.
__device__ __forceinline__ float half_float(uint32_t pair, int k) {
  return __half2float(__ushort_as_half((unsigned short)(pair >> (16 * k))));
}

// The staged xs of a kind: Q4_0's fragments carry 16 (n - 8), so its xs is
// staged / 16 (exact) and the fma sees xs * d as the plain version does.
template <class F>
__device__ __forceinline__ float xs_stage(float s) {
  return F::KIND == 0 ? s * 0.0625f : s;
}

// One 32-block of x quantized by one thread, as common.cuh quantize_lane
// does it for a warp (the same divisions and rounding; amax is a max, so the
// order it is taken in does not matter): the 32 floats at src (16-byte
// aligned, read a float4 at a time from float4 `rot` on, so the lanes of a
// warp on consecutive blocks hit distinct banks), the levels to dst in
// fragment order and, where out is not null, in natural order. Returns s.
__device__ __forceinline__ float quantize_thread(const float* src, uint8_t* dst, int8_t* out,
                                                 int rot) {
  float4 v[8];
  float amax = 0.f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    v[k] = *reinterpret_cast<const float4*>(src + 4 * ((k + rot) & 7));
    amax = fmaxf(amax, fmaxf(fmaxf(fabsf(v[k].x), fabsf(v[k].y)),
                             fmaxf(fabsf(v[k].z), fabsf(v[k].w))));
  }
  const float s = amax / 127.0f;
  const float inv = s > 0.f ? 1.0f / s : 0.f;
  auto q8 = [inv](float e) {
    return (uint32_t)(uint8_t)(int8_t)(int)fminf(fmaxf(rintf(e * inv), -127.f), 127.f);
  };
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int c = (k + rot) & 7;
    const uint32_t w = q8(v[k].x) | (q8(v[k].y) << 8) | (q8(v[k].z) << 16) | (q8(v[k].w) << 24);
    *reinterpret_cast<uint32_t*>(dst + frag_word(c)) = w;
    if (out != nullptr) *reinterpret_cast<uint32_t*>(out + 4 * c) = w;
  }
  return s;
}

// One item of a warp: rows g and g + 8 of a tile (tq: its qs rows, rq bytes
// apart; its scale rows in dq (shared memory, nb apart) or, where the stage
// could not copy them, at dg in global memory, dgs apart), the quant blocks of
// segment sg of the row's nb (128 bytes of each row: 8 blocks at Q4_0, 4 at
// Q8_0), against the NT n8 tiles of x from row m0 (xf / xs: fragment-order
// rows and staged scales of MX columns, in shared memory or, XG, in global
// memory). rows: the tile's
// rows that exist; half: an 8-row tile (rows g + 8 are zero); ONE: M == 1
// (only column 0 of the C fragment counts).
//
// A slot's rows lie rq bytes apart, a multiple of 128 at the model widths, so
// the 8 rows of a fragment sit on the same banks. Lane (g, t) reads word t of
// 16-byte chunk (k + g) mod RW of a group of RW chunks of its rows as its word
// k (32 banks at RW 8; 2-way at RW 4), then rotates its words by g (selects),
// so word c holds chunk c. NT 4 takes the segment in two groups of 4 chunks,
// one after the other (registers: 544 threads cap ptxas at 96); XG, bound by
// L2, reads its words in the dot. Rows of a segment shorter than 128 bytes
// read past it into the slot or the areas after the ring, whose words no
// block uses.
template <class F, int NT, int MX, bool XG, bool ONE>
__device__ __forceinline__ void item(const uint8_t* tq, int rq, const __half* dq,
                                     const __half* dg, int dgs, int nb, int sg, bool half,
                                     int rows,
                                     const uint8_t* xf, const float* xs, int M, int m0, int lane,
                                     float (&acc)[NT][4]) {
  constexpr int BPS = SEG / F::BYTES;       // quant blocks a segment: 8 (Q4_0), 4 (Q8_0)
  constexpr int CPB = F::BYTES / 16;        // 16-byte chunks a quant block
  constexpr int RW = NT == 4 ? 4 : 8;       // chunks a group
  constexpr int BPG = RW / CPB;             // quant blocks a group
  const int g = lane >> 2, t = lane & 3;
  const int b0 = sg * BPS, nbk = min(BPS, nb - b0);
  const uint8_t* rg = tq + g * rq + sg * SEG;
  const uint8_t* rh = rg + 8 * rq;
  const bool dvec = dq != nullptr && nbk == BPS && nb % BPS == 0;
  const int bstride = M * 32;               // bytes of x's fragment rows a quant block
  const uint8_t* xb = xf + b0 * bstride + (m0 + g) * 32 + 8 * t;
  const float* xsb = xs + b0 * MX + m0 + 2 * t;

  // group q: its blocks c = q * BPG .. q * BPG + BPG - 1
  auto group = [&](int q) {
    uint32_t wl[RW], wh[RW];
    if constexpr (!XG) {
#pragma unroll
      for (int k = 0; k < RW; ++k) {
        const int off = (q * RW + ((k + g) & (RW - 1))) * 16 + 4 * t;
        wl[k] = *reinterpret_cast<const uint32_t*>(rg + off);
        wh[k] = half ? 0u : *reinterpret_cast<const uint32_t*>(rh + off);
      }
#pragma unroll
      for (int bit = 0; (1 << bit) < RW; ++bit) {   // word c <- word (c - g) mod RW
        const bool on = (g >> bit) & 1;
        uint32_t nl[RW], nh[RW];
#pragma unroll
        for (int c = 0; c < RW; ++c) {
          nl[c] = on ? wl[(c - (1 << bit)) & (RW - 1)] : wl[c];
          nh[c] = on ? wh[(c - (1 << bit)) & (RW - 1)] : wh[c];
        }
#pragma unroll
        for (int c = 0; c < RW; ++c) {
          wl[c] = nl[c];
          wh[c] = nh[c];
        }
      }
    }
    // the group's scales of rows g, g + 8, as fp16 pairs
    uint32_t dl[(BPG + 1) / 2], dh[(BPG + 1) / 2];
    if (dvec) {                             // a vector a row
      const __half* pl = dq + g * nb + b0 + q * BPG;
      const __half* ph = pl + 8 * nb;
      if constexpr (BPG == 8) {
        const uint4 u = *reinterpret_cast<const uint4*>(pl);
        const uint4 v = half ? make_uint4(0u, 0u, 0u, 0u) : *reinterpret_cast<const uint4*>(ph);
        dl[0] = u.x; dl[1] = u.y; dl[2] = u.z; dl[3] = u.w;
        dh[0] = v.x; dh[1] = v.y; dh[2] = v.z; dh[3] = v.w;
      } else if constexpr (BPG == 4) {
        const uint2 u = *reinterpret_cast<const uint2*>(pl);
        const uint2 v = half ? make_uint2(0u, 0u) : *reinterpret_cast<const uint2*>(ph);
        dl[0] = u.x; dl[1] = u.y;
        dh[0] = v.x; dh[1] = v.y;
      } else {
        dl[0] = *reinterpret_cast<const uint32_t*>(pl);
        dh[0] = half ? 0u : *reinterpret_cast<const uint32_t*>(ph);
      }
    } else {
#pragma unroll
      for (int c = 0; c < BPG; c += 2) {
        uint32_t lo = 0u, hi = 0u;
#pragma unroll
        for (int e = 0; e < 2 && c + e < BPG; ++e) {
          const int bl = q * BPG + c + e, b = b0 + bl;
          if (bl < nbk) {
            const __half* sl = dq != nullptr ? dq + g * nb + b : dg + (size_t)g * dgs + b;
            const __half* sh = sl + 8 * (dq != nullptr ? nb : dgs);
            if (g < rows) lo |= (uint32_t)__half_as_ushort(*sl) << (16 * e);
            if (!half && g + 8 < rows) hi |= (uint32_t)__half_as_ushort(*sh) << (16 * e);
          }
        }
        dl[c / 2] = lo;
        dh[c / 2] = hi;
      }
    }
    // block cl of the group: the A fragment, one fresh MMA per n8 tile of x,
    // then acc += float(c) * (xs * d)
    auto block = [&](int cl) {
      const int c = q * BPG + cl;
      uint32_t l0, l1 = 0u, h0, h1 = 0u;    // chunk words of rows g, g + 8
      if constexpr (XG) {
        l0 = *reinterpret_cast<const uint32_t*>(rg + c * F::BYTES + 4 * t);
        h0 = half ? 0u : *reinterpret_cast<const uint32_t*>(rh + c * F::BYTES + 4 * t);
        if constexpr (CPB == 2) {
          l1 = *reinterpret_cast<const uint32_t*>(rg + c * F::BYTES + 16 + 4 * t);
          h1 = half ? 0u : *reinterpret_cast<const uint32_t*>(rh + c * F::BYTES + 16 + 4 * t);
        }
      } else {
        l0 = wl[CPB * cl];
        h0 = wh[CPB * cl];
        if constexpr (CPB == 2) {
          l1 = wl[2 * cl + 1];
          h1 = wh[2 * cl + 1];
        }
      }
      uint32_t a0, a1, a2, a3;
      if constexpr (F::KIND == 0) {         // one 16-byte chunk a row: both nibble halves
        a0 = ((l0 << 4) & 0xF0F0F0F0u) ^ 0x80808080u;    // 16 (n - 8) as signed bytes
        a2 = (l0 & 0xF0F0F0F0u) ^ 0x80808080u;
        a1 = ((h0 << 4) & 0xF0F0F0F0u) ^ 0x80808080u;    // 0 rows give 16 (0 - 8): d is 0
        a3 = (h0 & 0xF0F0F0F0u) ^ 0x80808080u;
      } else {                              // two chunks a row: elements 0-15, 16-31
        a0 = l0;
        a2 = l1;
        a1 = h0;
        a3 = h1;
      }
      const float d0 = half_float(dl[cl / 2], cl & 1), d1 = half_float(dh[cl / 2], cl & 1);
      if constexpr (ONE) {
        uint2 bv = make_uint2(0u, 0u);
        if (g == 0)
          bv = XG ? __ldcg(reinterpret_cast<const uint2*>(xb + c * bstride))
                  : *reinterpret_cast<const uint2*>(xb + c * bstride);
        int cacc[4];
        mma_s8(cacc, a0, a1, a2, a3, bv.x, bv.y);
        const float s0 = XG ? __ldcg(xs + (b0 + c) * MX) : xs[(b0 + c) * MX];
        acc[0][0] = fmaf(i2f(cacc[0]), __fmul_rn(s0, d0), acc[0][0]);
        acc[0][2] = fmaf(i2f(cacc[2]), __fmul_rn(s0, d1), acc[0][2]);
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (m0 + 8 * j >= M) break;       // warp-uniform
          uint2 bv = make_uint2(0u, 0u);
          const uint8_t* bp = xb + c * bstride + j * 256;
          if (m0 + 8 * j + g < M)
            bv = XG ? __ldcg(reinterpret_cast<const uint2*>(bp))
                    : *reinterpret_cast<const uint2*>(bp);
          int cacc[4];
          mma_s8(cacc, a0, a1, a2, a3, bv.x, bv.y);
          const float* sp = xsb + c * MX + 8 * j;
          const float2 s2 = XG ? __ldcg(reinterpret_cast<const float2*>(sp))
                               : *reinterpret_cast<const float2*>(sp);
          acc[j][0] = fmaf(i2f(cacc[0]), __fmul_rn(s2.x, d0), acc[j][0]);
          acc[j][1] = fmaf(i2f(cacc[1]), __fmul_rn(s2.y, d0), acc[j][1]);
          acc[j][2] = fmaf(i2f(cacc[2]), __fmul_rn(s2.x, d1), acc[j][2]);
          acc[j][3] = fmaf(i2f(cacc[3]), __fmul_rn(s2.y, d1), acc[j][3]);
        }
      }
    };
    if (nbk == BPS) {                       // a whole segment: no guard between the blocks
#pragma unroll
      for (int cl = 0; cl < BPG; ++cl) block(cl);
    } else {
#pragma unroll
      for (int cl = 0; cl < BPG; ++cl)
        if (q * BPG + cl < nbk) block(cl);
    }
  };
  if constexpr (BPS / BPG == 1) {
    group(0);
  } else {
#pragma unroll 1
    for (int q = 0; q < BPS / BPG; ++q)
      if (q * BPG < nbk) group(q);
  }
}

// A warp's share of a stage of st tiles: each tile takes NH * P warps, NH
// column groups (the n8 tiles of x split in NH, 2 at NT 4: a warp's
// accumulators are then NT / NH tiles' worth) times P parts of K. Warp w takes
// tile tl = w / (NH P), column group hh = w % (NH P) % NH and the segments
// [sg0, sg1) of part w % (NH P) / NH (the plan's i8_parts / i8_part_segments).
template <int NH>
struct Split {
  int st, nseg, P, tl, hh, sg0, sg1;
  __device__ __forceinline__ Split(int st_, int nseg_, int warp) : st(st_), nseg(nseg_) {
    P = min(ws::WARPS / (NH * st), nseg);
    tl = warp / (NH * P);
    hh = warp % (NH * P) % NH;
    const int pt = warp % (NH * P) / NH;
    sg0 = pt * nseg / P;
    sg1 = (pt + 1) * nseg / P;
  }
};

// The block's units [t0, t1) of the grid's ceil(N / tr) * kc: tiles, or in
// the K-split form (tile, piece) units u = tile * kc + piece.
__device__ __forceinline__ void block_tiles(int N, int tr, int kc, int& t0, int& t1) {
  const unsigned T = (unsigned)(N + tr - 1) / tr * kc;     // 32-bit: T * grid < 2^32
  t0 = (int)(blockIdx.x * T / gridDim.x);
  t1 = (int)((blockIdx.x + 1) * T / gridDim.x);
}

template <class F, int NT, bool XG, bool ARGMAX, bool ONE, bool SPLIT>
__global__ void __launch_bounds__(ws::THREADS, 1) qi8_kernel(I8Params p, I8Args a) {
  static_assert(!SPLIT || (XG && !ONE), "the K-split form reads x from L2 on the n8 code");
  extern __shared__ __align__(128) uint8_t smem[];
  constexpr int MX = 8 * NT;
  constexpr int NH = NT == 4 ? 2 : 1;       // column groups a tile's warps split x's rows in
  constexpr int NTI = NT / NH;              // n8 tiles a warp
  const int nb = p.K / 32, rq = nb * F::BYTES;
  const int nseg = (rq + SEG - 1) / SEG;
  ws::ring_init(smem, a.ring);
  const int tr = a.tr, kc = SPLIT ? a.kc : 1;
  int t0, t1;
  block_tiles(p.N, tr, kc, t0, t1);
  float* xin = reinterpret_cast<float*>(smem + a.ring.act_off);

  if (threadIdx.x >= ws::CONSUMERS) {       // the producer warp: one thread copies
    if (threadIdx.x == ws::CONSUMERS) {
      if (a.self_q) {                       // x ahead of every weight byte
        ws::mbar_expect_tx(ws::x_bar(smem), (uint32_t)(p.M * p.K * 4));
        ws::bulk_copy(xin, p.x, (uint32_t)(p.M * p.K * 4), ws::x_bar(smem));
      }
      const volatile unsigned* go = ws::go_count(smem);
      int n = 0;
      for (int u = t0; u < t1; u += a.S, ++n) {
        if (!a.self_q && n >= a.ring.ahead)
          while (*go < 2u) __nanosleep(64);
        const int slot = n % a.ring.stages;
        ws::mbar_wait(ws::empty_bar(smem, slot), ((n / a.ring.stages) & 1) ^ 1);
        uint8_t* dst = smem + ws::HEADER_BYTES + (size_t)slot * a.ring.slot_bytes;
        if constexpr (SPLIT) {              // one piece of a tile's rows, a row at a time
          const int tile = u / kc;
          int b0, nbc;
          piece(nb, kc, u % kc, b0, nbc);
          const int rows = min(tr, p.N - tile * tr);
          const uint32_t rqc = (uint32_t)nbc * F::BYTES;
          const uint32_t dc = nb % 8 == 0 ? (uint32_t)nbc * 2 : 0u;
          ws::mbar_expect_tx(ws::full_bar(smem, slot), (uint32_t)rows * (rqc + dc));
          for (int r = 0; r < rows; ++r) {
            const size_t row = (size_t)tile * tr + r;
            ws::bulk_copy(dst + (size_t)r * rqc, p.qs + row * rq + (size_t)b0 * F::BYTES, rqc,
                          ws::full_bar(smem, slot));
            if (dc)
              ws::bulk_copy(dst + (size_t)tr * rqc + (size_t)r * dc,
                            reinterpret_cast<const uint8_t*>(p.d + row * nb + b0), dc,
                            ws::full_bar(smem, slot));
          }
          continue;
        }
        const int rows = min(min(a.S, t1 - u) * tr, p.N - u * tr);
        const uint32_t qb = (uint32_t)(rows * rq), db = (uint32_t)(rows * nb * 2);
        const bool dcopy = db % 16 == 0;
        ws::mbar_expect_tx(ws::full_bar(smem, slot), qb + (dcopy ? db : 0u));
        ws::bulk_copy(dst, p.qs + (size_t)u * tr * rq, qb, ws::full_bar(smem, slot));
        if (dcopy)
          ws::bulk_copy(dst + (size_t)a.S * tr * rq,
                        reinterpret_cast<const uint8_t*>(p.d) + (size_t)u * tr * nb * 2, db,
                        ws::full_bar(smem, slot));
      }
      ws::produce_tail(smem, a.ring, n);
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint8_t* xf_s = smem + a.xf_off;
  float* xs_s = reinterpret_cast<float*>(smem + a.xs_off);
  // 1. the int8 activations (the barrier: the global xq's, and the K-split
  // form's before the piece sums are added)
  ws::CountBarrier gb;
  if (SPLIT || !a.self_q) gb.start(p.bar + 2);
  if (a.self_q) {
    ws::mbar_wait(ws::x_bar(smem), 0);
    const bool out = p.xq_out != nullptr && blockIdx.x == 0;    // block 0 writes its own
    for (int q = threadIdx.x; q < p.M * nb; q += ws::CONSUMERS) {  // a thread a 32-block
      const int m = q / nb, b = q % nb;
      const float s = quantize_thread(xin + 32 * q, xf_s + (b * p.M + m) * 32,
                                      out ? p.xq_out + 32 * q : nullptr, q & 7);
      xs_s[b * MX + m] = xs_stage<F>(s);
      if (out) p.xs_out[q] = s;
    }
    for (int i = threadIdx.x; i < nb * (MX - p.M); i += ws::CONSUMERS)
      xs_s[(i / (MX - p.M)) * MX + p.M + i % (MX - p.M)] = 0.f;
    ws::sync();
  } else {
    const unsigned Q = (unsigned)(nb * MX);    // (b, m) with m < MX: rows past M give xs 0
    const int q0 = (int)(blockIdx.x * Q / gridDim.x);
    const int q1 = (int)((blockIdx.x + 1) * Q / gridDim.x);
    for (int q = q0 + threadIdx.x; q < q1; q += ws::CONSUMERS) {  // a thread a 32-block
      const int b = q / MX, m = q % MX;
      float s = 0.f;
      if (m < p.M) {
        const int qr = m * nb + b;          // the block in x's row order
        s = quantize_thread(p.x + 32 * (size_t)qr, p.xg + ((size_t)b * p.M + m) * 32,
                            p.xq_out != nullptr ? p.xq_out + 32 * (size_t)qr : nullptr, 0);
        if (p.xq_out != nullptr) p.xs_out[qr] = s;
      }
      p.xsg[q] = xs_stage<F>(s);
    }
    gb.wait();
    if constexpr (!XG) {                    // the int8 rows back into shared memory
      const int n16 = p.M * p.K / 16, s16 = nb * MX / 4;
      const int4* src = reinterpret_cast<const int4*>(p.xg);
      int4* dst = reinterpret_cast<int4*>(xf_s);
      for (int i = threadIdx.x; i < n16; i += 4 * ws::CONSUMERS) {
        int4 v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (i + k * ws::CONSUMERS < n16) v[k] = __ldcg(src + i + k * ws::CONSUMERS);
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (i + k * ws::CONSUMERS < n16) dst[i + k * ws::CONSUMERS] = v[k];
      }
      for (int i = threadIdx.x; i < s16; i += ws::CONSUMERS)
        reinterpret_cast<float4*>(xs_s)[i] = __ldcg(reinterpret_cast<const float4*>(p.xsg) + i);
    }
    ws::release(smem, 1);                   // the producer may run past `ahead`
  }
  const uint8_t* xf = XG ? p.xg : xf_s;
  const float* xs = XG ? p.xsg : xs_s;

  // 2. the stages
  const int g = lane >> 2, t = lane & 3;
  // the stage's partial sums, [warp][MX][16]: where the plan holds two
  // buffers, stage n takes buffer n & 1 and one barrier a stage suffices;
  // where it holds none (pis), they go into the slot once every warp is done
  // with its weights, and each warp releases the slot after its reads
  constexpr int PM = ONE ? 1 : MX;          // columns a warp's partial sums keep
  const int part_floats = ws::WARPS * PM * TILE;
  const bool dbl = !a.pis && a.red_off - a.part_off >= 2 * part_floats * 4;
  float bestv = -INFINITY;
  int besti = -1;
  Split<NH> split(a.S, nseg, warp);
  int n = 0;
  for (int u = t0; u < t1; u += a.S, ++n) {
    int tile = u, b0 = 0, nbc = nb;         // the stage's first tile, and its piece of K
    if constexpr (SPLIT) {
      tile = u / kc;
      piece(nb, kc, u % kc, b0, nbc);
    }
    const int rqc = nbc * F::BYTES;
    const int st = min(a.S, t1 - u);
    const int rows = min(st * tr, p.N - tile * tr);
    const int slot = n % a.ring.stages;
    ws::mbar_wait(ws::full_bar(smem, slot), (n / a.ring.stages) & 1);
    uint8_t* base = smem + ws::HEADER_BYTES + (size_t)slot * a.ring.slot_bytes;
    const bool dcopy = SPLIT ? nb % 8 == 0 : rows * nb * 2 % 16 == 0;
    const int nsegc = SPLIT ? (rqc + SEG - 1) / SEG : nseg;
    if (st != split.st || (SPLIT && nsegc != split.nseg))   // a last stage may be short
      split = Split<NH>(st, nsegc, warp);
    const int P = split.P, m0 = 8 * NTI * split.hh;
    const bool active = warp < st * NH * P;
    float acc[NTI][4];
#pragma unroll
    for (int j = 0; j < NTI; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    if (active) {
      const int r0 = split.tl * tr;
      const __half* dq =
          dcopy ? reinterpret_cast<const __half*>(base + (size_t)a.S * tr * rqc) + r0 * nbc
                : nullptr;
      const __half* dg = p.d + (size_t)(tile * tr + r0) * nb + b0;
      const int tile_rows = min(tr, rows - r0);
      for (int sg = split.sg0; sg < split.sg1; ++sg)
        item<F, NTI, MX, XG, ONE>(base + (size_t)r0 * rqc, rqc, dq, dg, nb, nbc, sg,
                                  tr < TILE, tile_rows, xf + (size_t)b0 * p.M * 32,
                                  xs + b0 * MX, p.M, m0, lane, acc);
    }
    float* part;
    if (a.pis) {
      ws::sync();
      part = reinterpret_cast<float*>(base);
    } else {
      __syncwarp();
      if (lane == 0) ws::mbar_arrive(ws::empty_bar(smem, slot));
      part = reinterpret_cast<float*>(smem + a.part_off) + (dbl ? (n & 1) * part_floats : 0);
    }
    if (active) {                           // C fragment: rows g, g + 8; columns 2t, 2t + 1
      float* pw = part + warp * PM * TILE;
      if constexpr (ONE) {                  // column 0: lanes t == 0
        if (t == 0) {
          pw[g] = acc[0][0];
          pw[g + 8] = acc[0][2];
        }
      } else {
#pragma unroll
        for (int j = 0; j < NTI; ++j) {
          if (m0 + 8 * j >= p.M) break;
          float* pm = pw + (m0 + 8 * j + 2 * t) * TILE + g;
          pm[0] = acc[j][0];
          pm[TILE] = acc[j][1];
          pm[8] = acc[j][2];
          pm[TILE + 8] = acc[j][3];
        }
      }
    }
    ws::sync();
    // each output: its tile's P partial sums in part order; a warp reads
    // consecutive rows (rows fastest, then m, then the tile)
    if constexpr (!ARGMAX || SPLIT) {
      float* yo = SPLIT ? p.ypart + (size_t)(u % kc) * p.M * p.N : p.y;
      for (int o = threadIdx.x; o < st * p.M * tr; o += ws::CONSUMERS) {
        const int r = o & (tr - 1), q = o >> (tr == TILE ? 4 : 3);
        const int m = ONE ? 0 : q % p.M, tq = ONE ? q : q / p.M;
        if (tq * tr + r >= rows) continue;
        const float* pp = part + (tq * NH * P + (NH == 2 ? m / 16 : 0)) * PM * TILE + m * TILE + r;
        float v = 0.f;
        for (int q = 0; q < P; ++q) v += pp[q * NH * PM * TILE];
        yo[(size_t)m * p.N + (tile + tq) * tr + r] = v;
      }
    } else {                                // M == 1: thread o keeps the best of its rows
      for (int o = threadIdx.x; o < rows; o += ws::CONSUMERS) {
        const float* pp = part + ((o / tr) * P) * PM * TILE + o % tr;
        float v = 0.f;
        for (int q = 0; q < P; ++q) v += pp[q * PM * TILE];
        if (besti < 0 || v > bestv) {       // its rows ascend: strictly greater keeps the first
          bestv = v;
          besti = u * tr + o;
        }
      }
    }
    if (a.pis) {
      __syncwarp();
      if (lane == 0) ws::mbar_arrive(ws::empty_bar(smem, slot));
    } else if (!dbl) {
      ws::sync();                           // part is rewritten by the next stage
    }
  }
  if constexpr (SPLIT) {                    // each output: its kc pieces in piece order
    gb.wait();
    const unsigned long long mn = (unsigned long long)p.M * p.N;
    const size_t o0 = blockIdx.x * mn / gridDim.x, o1 = (blockIdx.x + 1) * mn / gridDim.x;
    for (size_t o = o0 + threadIdx.x; o < o1; o += ws::CONSUMERS) {
      float v = 0.f;
      for (int j = 0; j < kc; ++j) v += __ldcg(p.ypart + j * mn + o);
      if constexpr (ARGMAX) {               // M == 1: o is the row; a thread's rows ascend
        if (besti < 0 || v > bestv) {
          bestv = v;
          besti = (int)o;
        }
      } else {
        p.y[o] = v;
      }
    }
  }
  if constexpr (ARGMAX) {                   // the block's best, then the grid's: the largest
    float* red = reinterpret_cast<float*>(smem + a.red_off);         // value at its lowest row
    auto better = [](float v2, int i2, float v, int i) {
      return i2 >= 0 && (i < 0 || v2 > v || (v2 == v && i2 < i));
    };
    // the best of the consumers' (value, row) pairs into thread 0
    auto block_best = [&](float& v, int& i) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float v2 = __shfl_xor_sync(0xFFFFFFFFu, v, off);
        const int i2 = __shfl_xor_sync(0xFFFFFFFFu, i, off);
        if (better(v2, i2, v, i)) {
          v = v2;
          i = i2;
        }
      }
      if (lane == 0) {
        red[2 * warp] = v;
        reinterpret_cast<int*>(red)[2 * warp + 1] = i;
      }
      ws::sync();
      if (threadIdx.x == 0)
        for (int w = 1; w < ws::WARPS; ++w) {
          const float v2 = red[2 * w];
          const int i2 = reinterpret_cast<const int*>(red)[2 * w + 1];
          if (better(v2, i2, v, i)) {
            v = v2;
            i = i2;
          }
        }
    };
    block_best(bestv, besti);
    int* last = reinterpret_cast<int*>(red) + 2 * ws::WARPS;
    if (threadIdx.x == 0) {
      p.best_v[blockIdx.x] = bestv;
      p.best_i[blockIdx.x] = besti;
      __threadfence();
      *last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;     // every block's slot is written
    }
    ws::sync();
    if (*last) {                            // the last block reduces the slots, all threads at once
      __threadfence();
      float v = -INFINITY;
      int i = -1;
      for (int b = threadIdx.x; b < (int)gridDim.x; b += ws::CONSUMERS) {
        const float v2 = __ldcg(p.best_v + b);
        const int i2 = __ldcg(p.best_i + b);
        if (better(v2, i2, v, i)) {
          v = v2;
          i = i2;
        }
      }
      ws::sync();                           // red is rewritten
      block_best(v, i);
      if (threadIdx.x == 0) {
        *p.out_id = (long long)i;
        *p.ticket = 0u;
      }
    }
  }
}

__global__ void quantize_act_kernel(const float* __restrict__ x, int8_t* __restrict__ xq,
                                    float* __restrict__ xs, int n_blocks) {
  const int blk = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk >= n_blocks) return;
  float s;
  const int q = quantize_lane(x[(size_t)blk * 32 + lane], s);
  xq[(size_t)blk * 32 + lane] = (int8_t)q;
  if (lane == 0) xs[blk] = s;
}

// The plan's ints, checked against what the kernel needs: plan[0..] = grid,
// stages, slot_bytes, S, ahead, self_q, xg, nt, xin_off, xf_off, xs_off,
// part_off, red_off, smem_bytes, tr, pis, kc (ops/qmatmul.py i8_ints).

template <class F>
int plan_args(const int* plan, int M, int K, I8Args& a) {
  const int grid = plan[0], stages = plan[1], slot = plan[2], S = plan[3], ahead = plan[4];
  const int self_q = plan[5], xg = plan[6], nt = plan[7];
  const int xin_off = plan[8], xf_off = plan[9], xs_off = plan[10], part_off = plan[11];
  const int red_off = plan[12], smem = plan[13], tr = plan[14], pis = plan[15], kc = plan[16];
  const int nb = K / 32, mx = 8 * nt, g = piece_align(nb);
  if (kc < 1 || kc > nb / g || (kc > 1 && (S != 1 || tr != TILE || !xg))) return ZGML_ERR_SMEM;
  const int nbc = kc > 1 ? (nb / g + kc - 1) / kc * g : nb;    // the longest piece
  const long long tile = (long long)tr * nbc * (F::BYTES + 2);
  if (grid < 1 || stages < 1 || stages > ws::MAX_STAGES || slot % 128 != 0 || S < 1 ||
      S > ws::WARPS || (long long)slot < S * tile || ahead < 0 || nt < 1 || nt > 4 ||
      nt != (M <= 8 ? 1 : M <= 16 ? 2 : 4) || (self_q && xg) || (tr != TILE && tr != TILE / 2))
    return ZGML_ERR_SMEM;
  const long long ring_end = ws::HEADER_BYTES + (long long)stages * slot;
  const long long xin = self_q ? (long long)M * K * 4 : 0;
  const long long xf = xg ? 0 : (long long)M * K, xs = xg ? 0 : (long long)nb * mx * 4;
  if (xin_off != ring_end || xf_off < xin_off + xin || xs_off < xf_off + xf ||
      part_off < xs_off + xs ||
      red_off < part_off + (pis ? 0 : (long long)ws::WARPS * TILE * (M == 1 && kc == 1 ? 1 : mx)
                                          * 4) ||
      (pis && slot < ws::WARPS * TILE * mx * 4) ||
      smem < red_off + ws::WARPS * 8 + 4 || smem > 232448 || xf_off % 16 || xs_off % 16 ||
      part_off % 16 || red_off % 16)
    return ZGML_ERR_SMEM;
  a = I8Args{{stages, slot, xin_off, ahead}, S, tr, self_q, pis, xf_off, xs_off, part_off,
             red_off, kc};
  return 0;
}

template <class F, int NT, bool XG, bool ARGMAX, bool ONE = false, bool SPLIT = false>
int launch_nt(const I8Params& p, const I8Args& a, int grid, int smem, int device,
              cudaStream_t st) {
  static std::atomic<unsigned> ready{0};
  return ws::launch(qi8_kernel<F, NT, XG, ARGMAX, ONE, SPLIT>, p, a, grid, smem, device, ready,
                    st);
}

template <class F>
int launch_k1(const I8Params& p, const int* plan, int device, cudaStream_t st) {
  I8Args a;
  const int rc = plan_args<F>(plan, p.M, p.K, a);
  if (rc != 0) return rc;
  const int grid = plan[0], smem = plan[13];
  const bool xg = plan[6] != 0;
  if (a.kc > 1) {                           // the K-split form (xg: plan_args), M = 1 on
    switch (plan[7]) {                      // the n8 code
      case 1: return launch_nt<F, 1, true, false, false, true>(p, a, grid, smem, device, st);
      case 2: return launch_nt<F, 2, true, false, false, true>(p, a, grid, smem, device, st);
      case 4: return launch_nt<F, 4, true, false, false, true>(p, a, grid, smem, device, st);
      default: return ZGML_ERR_SHAPE;
    }
  }
  if (p.M == 1)                             // K5's instantiations: the same code
    return xg ? launch_nt<F, 1, true, false, true>(p, a, grid, smem, device, st)
              : launch_nt<F, 1, false, false, true>(p, a, grid, smem, device, st);
  switch (plan[7] * 2 + (xg ? 1 : 0)) {
    case 2: return launch_nt<F, 1, false, false>(p, a, grid, smem, device, st);
    case 3: return launch_nt<F, 1, true, false>(p, a, grid, smem, device, st);
    case 4: return launch_nt<F, 2, false, false>(p, a, grid, smem, device, st);
    case 5: return launch_nt<F, 2, true, false>(p, a, grid, smem, device, st);
    case 8: return launch_nt<F, 4, false, false>(p, a, grid, smem, device, st);
    case 9: return launch_nt<F, 4, true, false>(p, a, grid, smem, device, st);
    default: return ZGML_ERR_SHAPE;
  }
}

template <class F>
int launch_k5(const I8Params& p, const int* plan, int device, cudaStream_t st) {
  I8Args a;
  const int rc = plan_args<F>(plan, 1, p.K, a);
  if (rc != 0) return rc;
  if (plan[7] != 1) return ZGML_ERR_SHAPE;
  const int grid = plan[0], smem = plan[13];
  if (a.kc > 1) {                           // the K-split form: K1's split code, then the argmax
    if (p.ypart == nullptr) return ZGML_ERR_SHAPE;
    return launch_nt<F, 1, true, true, false, true>(p, a, grid, smem, device, st);
  }
  return plan[6] ? launch_nt<F, 1, true, true, true>(p, a, grid, smem, device, st)
                 : launch_nt<F, 1, false, true, true>(p, a, grid, smem, device, st);
}

bool aligned_args(const float* x, const uint8_t* qs, const void* d) {
  return ws::aligned16(x) && ws::aligned16(qs) && ws::aligned16(d);
}

}  // namespace

// The pre-pass alone: x f32 [M, K] -> xq int8 [M, K], xs f32 [M, K/32]
// (K1 and K5 run the same device function, quantize_lane, in their launch).
ZGML_EXPORT int zgml_i8_quantize(const float* x, int8_t* xq, float* xs, int M, int K,
                                 void* stream) {
  if (M <= 0 || K <= 0 || K % 32 != 0) return ZGML_ERR_SHAPE;
  const int n_blocks = M * (K / 32);
  quantize_act_kernel<<<(n_blocks + 7) / 8, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      x, xq, xs, n_blocks);
  return (int)cudaGetLastError();
}

// K1, kind 0 (q4_0) or 1 (q8_0): x f32 [M, K] (M <= 32) -> y f32 [M, N]; qs
// [N, K/32 * BYTES], d fp16 [N, K/32]; scratch: the global mode's xq (M K
// bytes) then its staged scales (K/32 * 8 nt floats, 16-byte aligned);
// xq_out / xs_out: null, or int8 [M, K] and f32 [M, K/32] for the kernel's
// own activations; bar: coop.barrier_words; plan: ops/qmatmul.py i8_ints;
// the K-split form (plan kc > 1) adds its [kc, M, N] f32 piece sums after
// them, and needs the scratch with self quantization too; device: the
// card's index. All contiguous, 16-byte aligned, on `stream`.
ZGML_EXPORT int zgml_qmatmul_i8(int kind, const float* x, const uint8_t* qs, const void* d,
                                float* y, int8_t* xq_out, float* xs_out, uint8_t* scratch,
                                unsigned int* bar, int M, int N, int K, const int* plan,
                                int device, void* stream) {
  if (M <= 0 || M > 32 || N <= 0 || K <= 0 || K % 32 != 0 || plan == nullptr ||
      !aligned_args(x, qs, d) || (xq_out == nullptr) != (xs_out == nullptr))
    return ZGML_ERR_SHAPE;
  if (kind != 0 && kind != 1) return ZGML_ERR_KIND;
  if ((!plan[5] || plan[16] > 1) && (scratch == nullptr || !ws::aligned16(scratch)))
    return ZGML_ERR_SHAPE;
  const size_t xq_bytes = ((size_t)M * K + 15) / 16 * 16;
  const size_t xs_bytes = (size_t)K / 32 * 8 * plan[7] * 4;
  const I8Params p{x, qs, static_cast<const __half*>(d), y,
                   scratch ? reinterpret_cast<float*>(scratch + xq_bytes + xs_bytes) : nullptr,
                   scratch,
                   scratch ? reinterpret_cast<float*>(scratch + xq_bytes) : nullptr,
                   xq_out, xs_out, bar, nullptr, nullptr, nullptr, nullptr, M, N, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ZGML_DISPATCH_KIND(kind, return launch_k1<F>(p, plan, device, st))
}

// K5, kind 0 (q4_0) or 1 (q8_0): one row x f32 [K] -> out_id int64 [1] =
// argmax_n of K1's y (first index on ties), on K1's M = 1 plan; scratch as
// K1's xq and scales, then grid floats and grid ints for the blocks' best,
// then on the K-split plan (kc > 1) the [kc, 1, N] f32 piece sums (ops/
// qmatmul.py i8_scratch_bytes with greedy); ticket: a zeroed counter word
// (coop.counter_words), left zeroed.
ZGML_EXPORT int zgml_greedy(int kind, const float* x, const uint8_t* qs, const void* d,
                            long long* out_id, uint8_t* scratch, unsigned int* bar,
                            unsigned int* ticket, int N, int K, const int* plan, int device,
                            void* stream) {
  if (N <= 0 || K <= 0 || K % 32 != 0 || plan == nullptr || scratch == nullptr ||
      ticket == nullptr || !aligned_args(x, qs, d) || !ws::aligned16(scratch))
    return ZGML_ERR_SHAPE;
  if (kind != 0 && kind != 1) return ZGML_ERR_KIND;
  const size_t xq_bytes = ((size_t)K + 15) / 16 * 16, xs_bytes = (size_t)K / 32 * 8 * 4;
  float* best_v = reinterpret_cast<float*>(scratch + xq_bytes + xs_bytes);
  float* ypart = plan[16] > 1 ? best_v + 2 * (size_t)plan[0] : nullptr;
  const I8Params p{x, qs, static_cast<const __half*>(d), nullptr, ypart, scratch,
                   reinterpret_cast<float*>(scratch + xq_bytes), nullptr, nullptr, bar, ticket,
                   best_v, reinterpret_cast<int*>(best_v + plan[0]), out_id, 1, N, K};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ZGML_DISPATCH_KIND(kind, return launch_k5<F>(p, plan, device, st))
}
